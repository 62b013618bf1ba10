"""Standalone model wrappers: port of fast_monte_carlo_tpu/models/wrappers.py
(PlayPolicy, PassOutcomeModel, QuantileYards, PassOutcomeTwoStage), numpy
over compiled FlatForests, loaded by the port's sklearn-free readers
(`compat.py`, `models.xgb_json`); the stage-2 class list is read with `csv`.
"""
from __future__ import annotations

import csv
import json
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..compat import load_sklearn_artifact
from .forest import FlatForest
from .sklearn_gbr import forest_from_gbr_pipeline, layout_from_column_transformer
from .xgb_json import forest_from_xgb_json, load_xgb_json


def _softmax_t(z: np.ndarray, t: float) -> np.ndarray:
    z = z / max(1e-6, t)
    z = z - z.max(axis=1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=1, keepdims=True)


class PlayPolicy:
    """Temperature-softmax play sampler (reference sim_predict.py:9-32)."""

    def __init__(self, forest: FlatForest, temperature: float = 1.0,
                 classes: Sequence[str] = ()):
        self.forest = forest
        self.temperature = temperature
        self.classes = tuple(classes)

    def predict_proba(self, x_num: np.ndarray,
                      cat_ids: Optional[Dict[str, np.ndarray]] = None) -> np.ndarray:
        m = self.forest.eval_margin_np(x_num, cat_ids or {})
        return _softmax_t(m, self.temperature)

    def sample_action(self, x_num, cat_ids=None,
                      rng: Optional[np.random.Generator] = None) -> int:
        p = self.predict_proba(np.atleast_2d(x_num), cat_ids)[0]
        p = np.maximum(p, 1e-6)
        p = p / p.sum()
        rng = rng or np.random.default_rng()
        return int(rng.choice(len(p), p=p))


class PassOutcomeModel:
    """Single-stage 4-class pass outcome with temperature calibration
    (reference sim_helpers.py:9-24); expects a `pass_outcome.json` booster +
    optional calibration meta."""

    def __init__(self, forest: FlatForest, temperature: float = 1.0,
                 classes: Sequence[str] = ("complete", "incomplete",
                                           "intercepted", "sack")):
        self.forest = forest
        self.temperature = temperature
        self.classes = tuple(classes)

    @classmethod
    def load(cls, model_path: str | Path, pre_path: str | Path,
             calib_path: Optional[str | Path] = None) -> "PassOutcomeModel":
        layout = layout_from_column_transformer(load_sklearn_artifact(pre_path))
        t = 1.0
        num_trees = None
        if calib_path and Path(calib_path).exists():
            meta = json.loads(Path(calib_path).read_text())
            t = float(meta.get("temperature", 1.0))
            if meta.get("best_iteration") is not None:
                num_trees = int(meta["best_iteration"]) + 1
        forest = forest_from_xgb_json(load_xgb_json(model_path), layout,
                                      num_trees=num_trees)
        return cls(forest, t)

    def predict_proba(self, x_num: np.ndarray,
                      cat_ids: Optional[Dict[str, np.ndarray]] = None) -> np.ndarray:
        return _softmax_t(self.forest.eval_margin_np(x_num, cat_ids or {}),
                          self.temperature)


class QuantileYards:
    """Piecewise-linear inverse-CDF sampler between q10/q50/q90 + noise
    (reference sim_helpers.py:26-38) — the alternative to the engine's
    normal approximation."""

    def __init__(self, q10: FlatForest, q50: FlatForest, q90: FlatForest):
        self.q10, self.q50, self.q90 = q10, q50, q90

    @classmethod
    def load(cls, prefix: str | Path) -> "QuantileYards":
        return cls(*(forest_from_gbr_pipeline(
            load_sklearn_artifact(f"{prefix}_q{q}.joblib")) for q in (10, 50, 90)))

    def quantiles(self, x_num, cat_ids=None) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        c = cat_ids or {}
        return (self.q10.predict_np(x_num, dict(c)),
                self.q50.predict_np(x_num, dict(c)),
                self.q90.predict_np(x_num, dict(c)))

    def sample(self, x_num, lo: float, hi: float, *, cat_ids=None, noise: float = 0.5,
               rng: Optional[np.random.Generator] = None) -> np.ndarray:
        rng = rng or np.random.default_rng()
        q10, q50, q90 = self.quantiles(np.atleast_2d(x_num), cat_ids)
        u = rng.random(q10.shape)
        y = np.where(u < 0.5,
                     q10 + (q50 - q10) * (u / 0.5),
                     q50 + (q90 - q50) * ((u - 0.5) / 0.5))
        y = y + rng.normal(0.0, noise, y.shape)
        return np.clip(y, lo, hi)

    def sample_inverse_cdf_torch(self, q10, q50, q90, u, noise_n, noise: float = 0.5):
        """The JAX package's `sample_inverse_cdf_jnp` on torch tensors, for
        use inside the engine (u uniform, noise_n standard normal)."""
        import torch
        y = torch.where(u < 0.5,
                        q10 + (q50 - q10) * (u / 0.5),
                        q50 + (q90 - q50) * ((u - 0.5) / 0.5))
        return y + noise * noise_n


class PassOutcomeTwoStage:
    """Composed joint 4-class distribution [complete, incomplete,
    intercepted, sack] from the two stage heads, with best-iteration slicing
    and epsilon smoothing (reference pass_outcome_infer.py:22-76)."""

    CLASSES = ("complete", "incomplete", "intercepted", "sack")

    def __init__(self, stage1: FlatForest, stage2: FlatForest,
                 stage2_classes: Sequence[str]):
        self.stage1 = stage1
        self.stage2 = stage2
        self.stage2_classes = tuple(stage2_classes)

    @classmethod
    def load(cls, artifact_dir: str | Path) -> "PassOutcomeTwoStage":
        d = Path(artifact_dir)
        lay1 = layout_from_column_transformer(
            load_sklearn_artifact(d / "pass_stage1_preprocessor.joblib"))
        it1 = json.loads((d / "pass_stage1_meta.json").read_text())["best_iteration"]
        s1 = forest_from_xgb_json(
            load_xgb_json(d / "pass_stage1_complete_vs_not.json"), lay1,
            num_trees=it1 + 1)
        lay2 = layout_from_column_transformer(
            load_sklearn_artifact(d / "pass_stage2_preprocessor.joblib"))
        it2 = json.loads((d / "pass_stage2_meta.json").read_text())["best_iteration"]
        s2 = forest_from_xgb_json(
            load_xgb_json(d / "pass_stage2_notcomplete.json"), lay2,
            num_trees=it2 + 1)
        with open(d / "pass_stage2_classes.csv", newline="") as f:
            classes = [str(r[0]) for r in csv.reader(f) if r]
        return cls(s1, s2, classes)

    def predict_proba(self, x_num: np.ndarray,
                      passer_ids: np.ndarray,
                      target_ids: Optional[np.ndarray] = None) -> np.ndarray:
        n = x_num.shape[0]
        if target_ids is None:
            target_ids = np.full(n, -1, dtype=np.int64)
        p_c = self.stage1.predict_np(x_num, {"passer_name": passer_ids})
        cat2 = {"passer_name": passer_ids}
        if "target_name" in self.stage2.layout.cat_group_names:
            cat2["target_name"] = target_ids
        p_nc = self.stage2.predict_np(x_num, cat2)
        out = np.zeros((n, 4))
        out[:, 0] = p_c
        col = {"incomplete": 1, "intercepted": 2, "sack": 3}
        for j, cls_name in enumerate(self.stage2_classes):
            out[:, col[cls_name]] = (1.0 - p_c) * p_nc[:, j]
        out = out + 1e-9
        return out / out.sum(axis=1, keepdims=True)

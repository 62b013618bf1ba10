"""ModelHeads: port of fast_monte_carlo_tpu/models/heads.py.

The bundle of outcome-model heads the simulator consumes, each a compiled
`FlatForest`, with their numpy prediction paths (the oracle and the table
build's post-transforms) and the player-name -> category-id map.  State
feature order everywhere is ST1_FEATURES (the 17 numerics).

`load_heads` reads an artifact directory as the JAX package's does (XGBoost
JSON, joblib files of sklearn pipelines, plain pickles), through
`compat.py`'s reader, which needs neither sklearn nor joblib, and the `csv`
module for the stage-2 class order; absent heads stay None.
`load_reconstructed_heads` adds the JAX package's committed overlay
(`fast_monte_carlo_tpu/artifacts/reconstructed/`, read in place as data).
Heads also come in as arrays (`model_heads_from_numpy`, for example a JAX
ModelHeads carried across) or from `fixtures.heads`.
"""
from __future__ import annotations

import csv
import dataclasses
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..compat import extract_xgb_pickle_raw, load_plain_pickle, load_sklearn_artifact
from ..config import SimConfig
from . import analytic
from .forest import FeatureLayout, FlatForest, flat_forest_from_numpy
from .sklearn_gbr import (forest_from_gbc_pipeline, forest_from_gbr_pipeline,
                          layout_from_column_transformer)
from .xgb_json import forest_from_xgb_json, load_xgb_json, loads_auto

ST1_FEATURES = (
    "down", "distance", "yardsToGoal", "is_red_zone", "score_diff",
    "seconds_remaining", "offenseTimeouts", "defenseTimeouts",
    "sp_rating_off", "sp_offense_rating_off", "sp_defense_rating_def",
    "sp_rating_def", "goal_to_go", "fourth_and_short", "fg_range",
    "half", "two_minute",
)

STAGE2_CLASSES = ("incomplete", "intercepted", "sack")  # LabelEncoder alphabetical


@dataclass
class ModelHeads:
    stage1: Optional[FlatForest] = None
    stage2: Optional[FlatForest] = None
    stage2_class_order: Tuple[str, ...] = STAGE2_CLASSES
    pass_quants: Optional[Tuple[FlatForest, FlatForest, FlatForest]] = None
    rush_quants: Optional[Tuple[FlatForest, FlatForest, FlatForest]] = None
    sack_quants: Optional[Tuple[FlatForest, FlatForest, FlatForest]] = None
    fumble: Optional[FlatForest] = None
    play: Optional[FlatForest] = None
    play_temperature: float = 1.0
    play_classes: Tuple[str, ...] = ("pass", "run")

    # ------------------------------------------------------------------
    # numpy prediction paths (oracle + table building)
    # ------------------------------------------------------------------
    def stage1_prob(self, x: np.ndarray, passer_ids: np.ndarray) -> np.ndarray:
        if self.stage1 is None:
            raise RuntimeError("stage1 forest missing; no analytic fallback defined")
        return self.stage1.predict_np(x, {"passer_name": passer_ids})

    def stage2_probs(
        self, x: np.ndarray, passer_ids: np.ndarray, target_ids: np.ndarray,
        cfg: SimConfig,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(p_incomplete, p_intercepted, p_sack), pre-nudge, given not-complete."""
        if self.stage2 is None:
            down = x[:, ST1_FEATURES.index("down")]
            dist = x[:, ST1_FEATURES.index("distance")]
            return analytic.stage2_fallback_probs_np(down, dist, cfg)
        cat = {"passer_name": passer_ids}
        if "target_name" in self.stage2.layout.cat_group_names:
            cat["target_name"] = target_ids
        probs = self.stage2.predict_np(x, cat)
        order = {c: i for i, c in enumerate(self.stage2_class_order)}
        return (probs[:, order["incomplete"]],
                probs[:, order["intercepted"]],
                probs[:, order["sack"]])

    def _quants(self, trio, x, cat_ids) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        return tuple(f.predict_np(x, dict(cat_ids)) for f in trio)  # type: ignore

    def pass_yard_quants(self, x, passer_ids, target_ids):
        return self._quants(self.pass_quants, x,
                            {"passer_name": passer_ids, "target_name": target_ids})

    def rush_yard_quants(self, x, rusher_ids):
        return self._quants(self.rush_quants, x, {"rusher_name": rusher_ids})

    def sack_loss_quants(self, x, passer_ids):
        return self._quants(self.sack_quants, x, {"passer_name": passer_ids})

    def fumble_prob(self, x, rusher_ids) -> np.ndarray:
        if self.fumble is None:
            return np.zeros(x.shape[0])
        return self.fumble.predict_np(x, {"rusher_name": rusher_ids})

    def play_pass_prob(self, x: np.ndarray, coach_id: np.ndarray, cfg: SimConfig) -> np.ndarray:
        """P(pass) from the ML play policy; the caller handles the heuristic
        fallback when self.play is None.  A binary pass/run booster maps
        directly; a 5-class play model is reduced to P(pass)/(P(pass)+P(run))."""
        if self.play is None:
            raise RuntimeError("play model not loaded")
        margins = self.play.eval_margin_np(x, {"head_coach": coach_id})
        z = margins / max(1e-6, self.play_temperature)
        z = z - z.max(axis=1, keepdims=True)
        ez = np.exp(z)
        probs = ez / ez.sum(axis=1, keepdims=True)
        i_pass = self.play_classes.index("pass") if "pass" in self.play_classes else 0
        p_pass = probs[:, i_pass]
        if "run" in self.play_classes and len(self.play_classes) > 2:
            p_run = probs[:, self.play_classes.index("run")]
            p_pass = p_pass / np.maximum(1e-9, p_pass + p_run)
        return np.clip(p_pass, cfg.model.play_clip_lo, cfg.model.play_clip_hi)

    def cat_ids_for(self, head: str, group: str, names) -> np.ndarray:
        """Map player names -> category ids for a given head's layout."""
        forest = {
            "stage1": self.stage1, "stage2": self.stage2,
            "pass": self.pass_quants[0] if self.pass_quants else None,
            "rush": self.rush_quants[0] if self.rush_quants else None,
            "sack": self.sack_quants[0] if self.sack_quants else None,
            "fumble": self.fumble, "play": self.play,
        }[head]
        if forest is None:
            return np.full(len(names), -1, dtype=np.int64)
        return np.asarray([forest.layout.cat_id(group, n) for n in names], dtype=np.int64)


# the forest fields of ModelHeads: one forest, or a trio of quantile forests
SINGLE_HEADS = ("stage1", "stage2", "fumble", "play")
TRIO_HEADS = ("pass_quants", "rush_quants", "sack_quants")


def model_heads_from_numpy(d: dict) -> ModelHeads:
    """ModelHeads from a dict: each of SINGLE_HEADS a forest dict (as
    `forest.flat_forest_from_numpy` takes it) or None, each of TRIO_HEADS a
    sequence of three or None, and optionally stage2_class_order,
    play_temperature and play_classes — for example a JAX ModelHeads
    carried across field by field."""
    def one(f):
        return None if f is None else flat_forest_from_numpy(f)

    kw = {h: one(d.get(h)) for h in SINGLE_HEADS}
    for h in TRIO_HEADS:
        trio = d.get(h)
        if trio is not None:
            if len(trio) != 3:
                raise ValueError(f"{h} takes three forests (q10, q50, q90), got {len(trio)}")
            trio = tuple(flat_forest_from_numpy(f) for f in trio)
        kw[h] = trio
    for k in ("stage2_class_order", "play_classes"):
        if k in d:
            kw[k] = tuple(str(c) for c in d[k])
    if "play_temperature" in d:
        kw["play_temperature"] = float(d["play_temperature"])
    return ModelHeads(**kw)


def _maybe(path: Path) -> Optional[Path]:
    return path if path.exists() else None


# every artifact filename load_heads probes, in one place so the memo's
# staleness fingerprint can't silently drift from the loader below
_ARTIFACT_NAMES = (
    "pass_stage1_complete_vs_not.json", "pass_stage1_preprocessor.joblib",
    "pass_stage2_notcomplete.json", "pass_stage2_preprocessor.joblib",
    "pass_stage2_sklearn.joblib", "pass_stage2_classes.csv",
    "pass_yards_q10.joblib", "pass_yards_q50.joblib", "pass_yards_q90.joblib",
    "run_yards_q10.joblib", "run_yards_q50.joblib", "run_yards_q90.joblib",
    "sack_yards_q10.joblib", "sack_yards_q50.joblib", "sack_yards_q90.joblib",
    "run_fumble.json", "run_fumble_preprocessor.joblib",
    "play_model.json", "play_model.xgb", "features.pkl", "scaler.pkl",
    "label_encoder.pkl", "coach_label_encoder.pkl", "calibration.json",
)

# In-process memo, as in the JAX package: the entry points call load_heads
# per call, and a full parse is host time wasted on warm calls.  Keyed on
# the resolved directory plus a stat fingerprint (mtime_ns, size) of every
# artifact the loader probes, so retrained or edited artifacts miss.  The
# returned ModelHeads is SHARED across hits and must be treated as
# immutable (the packs and table builds memoize on the instance); pass
# memoize=False for a private copy.  FIFO-capped: each entry pins a full
# forest set (and, once packed, its device buffers).
_HEADS_MEMO: dict = {}
_HEADS_MEMO_MAX = 16


def _artifacts_fp(d: Path) -> tuple:
    def one(p: Path):
        try:
            st = p.stat()
            return (st.st_mtime_ns, st.st_size)
        except OSError:
            return None
    return tuple(one(d / name) for name in _ARTIFACT_NAMES)


def _memo_put(key, heads: "ModelHeads") -> "ModelHeads":
    while len(_HEADS_MEMO) >= _HEADS_MEMO_MAX:
        _HEADS_MEMO.pop(next(iter(_HEADS_MEMO)))
    _HEADS_MEMO[key] = heads
    return heads


def _read_classes(path: Path) -> Tuple[str, ...]:
    """The first column of a header-less CSV, as pandas.read_csv(header=None)
    [0].astype(str) reads it (blank lines skipped)."""
    with open(path, newline="") as f:
        return tuple(str(r[0]) for r in csv.reader(f) if r)


def load_heads(artifact_dir: str | Path, *, use_play_pickle: bool = True,
               memoize: bool = True,
               overlay_dir: Optional[str | Path] = None) -> ModelHeads:
    """Load + compile every artifact present in `artifact_dir`.

    Artifact names follow the reference repo exactly (`_ARTIFACT_NAMES`); a
    head whose files are missing stays None, and a missing directory gives
    an empty ModelHeads.  `use_play_pickle` additionally accepts the
    pickled estimator ``play_model.xgb`` when ``play_model.json`` is
    absent.  Repeat calls with unchanged artifact files return one shared
    (immutable-by-convention) instance; ``memoize=False`` opts out.

    `overlay_dir` fills the artifacts a directory is MISSING from a second
    directory (the reconstructed-mode overlay, `load_reconstructed_heads`):
    its stage-2 head (+ class order) and `calibration.json` temperature
    replace the base values when present.  Only those fields merge."""
    d = Path(artifact_dir)
    if overlay_dir is not None:
        od = Path(overlay_dir)
        if memoize:
            key = ("overlay", str(d.resolve()), str(od.resolve()),
                   use_play_pickle, _artifacts_fp(d), _artifacts_fp(od))
            hit = _HEADS_MEMO.get(key)
            if hit is not None:
                return hit
        base = load_heads(d, use_play_pickle=use_play_pickle, memoize=memoize)
        over = load_heads(od, use_play_pickle=use_play_pickle, memoize=memoize)
        fields = {}
        if over.stage2 is not None:
            fields["stage2"] = over.stage2
            fields["stage2_class_order"] = over.stage2_class_order
        calib = _maybe(od / "calibration.json")
        if calib:
            fields["play_temperature"] = float(
                json.loads(calib.read_text()).get("temperature", 1.0))
        merged = dataclasses.replace(base, **fields)
        return _memo_put(key, merged) if memoize else merged
    if memoize:
        key = (str(d.resolve()), use_play_pickle, _artifacts_fp(d))
        hit = _HEADS_MEMO.get(key)
        if hit is not None:
            return hit
        return _memo_put(key, load_heads(artifact_dir, use_play_pickle=use_play_pickle,
                                         memoize=False))
    heads = ModelHeads()

    s1_model = _maybe(d / "pass_stage1_complete_vs_not.json")
    s1_pre = _maybe(d / "pass_stage1_preprocessor.joblib")
    if s1_model and s1_pre:
        layout = layout_from_column_transformer(load_sklearn_artifact(s1_pre))
        heads.stage1 = forest_from_xgb_json(load_xgb_json(s1_model), layout, name="stage1")

    s2_model = _maybe(d / "pass_stage2_notcomplete.json")
    s2_pre = _maybe(d / "pass_stage2_preprocessor.joblib")
    s2_sklearn = _maybe(d / "pass_stage2_sklearn.joblib")
    if s2_model and s2_pre:
        layout = layout_from_column_transformer(load_sklearn_artifact(s2_pre))
        heads.stage2 = forest_from_xgb_json(load_xgb_json(s2_model), layout, name="stage2")
    elif s2_sklearn:
        heads.stage2 = forest_from_gbc_pipeline(
            load_sklearn_artifact(s2_sklearn), name="stage2")
    if heads.stage2 is not None:
        classes_csv = _maybe(d / "pass_stage2_classes.csv")
        if classes_csv:
            heads.stage2_class_order = _read_classes(classes_csv)

    for kind, attr in (("pass", "pass_quants"), ("run", "rush_quants"), ("sack", "sack_quants")):
        paths = [d / f"{kind}_yards_q{q}.joblib" for q in (10, 50, 90)]
        if all(p.exists() for p in paths):
            trio = tuple(
                forest_from_gbr_pipeline(load_sklearn_artifact(p), name=p.stem)
                for p in paths
            )
            setattr(heads, attr, trio)

    fu_model = _maybe(d / "run_fumble.json")
    fu_pre = _maybe(d / "run_fumble_preprocessor.joblib")
    if fu_model and fu_pre:
        layout = layout_from_column_transformer(load_sklearn_artifact(fu_pre))
        heads.fumble = forest_from_xgb_json(load_xgb_json(fu_model), layout, name="fumble")

    play_json = _maybe(d / "play_model.json")
    play_pickle = _maybe(d / "play_model.xgb") if use_play_pickle else None
    feats_pkl = _maybe(d / "features.pkl")
    le_pkl = _maybe(d / "label_encoder.pkl")
    if (play_json or play_pickle) and feats_pkl and le_pkl:
        try:
            heads.play = _load_play_forest(d, play_json, play_pickle, feats_pkl, le_pkl)
            le = load_plain_pickle(le_pkl)
            heads.play_classes = tuple(str(c) for c in np.asarray(le).tolist())
            if heads.play.n_classes != len(heads.play_classes):
                if heads.play.n_classes == 5:
                    # a 5-class play_category model beside a binary recipe's
                    # label encoder: LabelEncoder order is alphabetical
                    heads.play_classes = (
                        "field_goal", "pass", "punt", "run", "timeout"
                    )
                else:
                    heads.play = None
            calib = _maybe(d / "calibration.json")
            if calib:
                heads.play_temperature = float(
                    json.loads(calib.read_text()).get("temperature", 1.0)
                )
        except NotImplementedError:
            heads.play = None  # e.g. native categorical splits; heuristic fallback
    return heads


_PLAY_LEGACY_NUMERICS = (
    "down", "distance", "yardsToGoal", "is_red_zone", "score_diff",
    "seconds_remaining", "offenseTimeouts", "defenseTimeouts",
    "sp_rating_off", "sp_offense_rating_off", "sp_defense_rating_def",
    "sp_rating_def",
)


def _load_play_forest(d, play_json, play_pickle, feats_pkl, le_pkl) -> FlatForest:
    features = [str(f) for f in load_plain_pickle(feats_pkl)]
    numeric = tuple(f for f in features if f != "head_coach")
    coaches: Tuple[str, ...] = ()
    coach_le = _maybe(d / "coach_label_encoder.pkl")
    if coach_le:
        coaches = tuple(str(c) for c in np.asarray(load_plain_pickle(coach_le)).tolist())

    if play_json:
        model = load_xgb_json(play_json)
    else:
        model = loads_auto(extract_xgb_pickle_raw(play_pickle))
        if "learner" not in model and "Model" in model:
            model = model["Model"]

    num_feature = int(model["learner"]["learner_model_param"]["num_feature"])
    n_legacy = len(_PLAY_LEGACY_NUMERICS)
    if num_feature == len(features):
        # features.pkl order, head_coach inline — remap to cats-first layout
        layout = FeatureLayout(
            cat_group_names=("head_coach",) if "head_coach" in features else (),
            cat_group_sizes=(len(coaches),) if "head_coach" in features else (),
            numeric_names=numeric,
            categories={"head_coach": coaches} if "head_coach" in features else {},
        )
        mapping = {}
        num_pos = 0
        for i, f in enumerate(features):
            if f == "head_coach":
                mapping[i] = layout.cat_group_offsets[0]
            else:
                mapping[i] = layout.n_cat + num_pos
                num_pos += 1
        _remap_split_indices(model, mapping, layout.n_features)
    elif num_feature > n_legacy:
        # legacy pd.get_dummies layout: 12 numerics then one coach dummy per
        # alphabetical coach (the reference's pickled play model, num_feature
        # 180).  Coach names from coach_label_encoder.pkl; the dummy count
        # may differ slightly, so pad unknowns.
        n_coach = num_feature - n_legacy
        if len(coaches) < n_coach:
            coaches = coaches + tuple(
                f"__coach_{i}" for i in range(len(coaches), n_coach)
            )
        coaches = coaches[:n_coach]
        layout = FeatureLayout(
            cat_group_names=("head_coach",),
            cat_group_sizes=(n_coach,),
            numeric_names=_PLAY_LEGACY_NUMERICS,
            categories={"head_coach": coaches},
        )
        # the pickle era standardized 11 of the 12 numerics (scaler.pkl);
        # bake the inverse transform into the thresholds so the compiled
        # forest consumes raw state features.
        scaler_pkl = _maybe(d / "scaler.pkl")
        if scaler_pkl:
            scaler = load_sklearn_artifact(scaler_pkl)
            by_name = {
                str(n): (float(m), float(s))
                for n, m, s in zip(scaler.feature_names_in_, scaler.mean_, scaler.scale_)
            }
            unscale = {
                i: by_name[f]
                for i, f in enumerate(_PLAY_LEGACY_NUMERICS)
                if f in by_name
            }
            for t in model["learner"]["gradient_booster"]["model"]["trees"]:
                left = t["left_children"]
                si = t["split_indices"]
                sc = t["split_conditions"]
                for i in range(len(left)):
                    if left[i] != -1 and int(si[i]) in unscale:
                        m, s = unscale[int(si[i])]
                        sc[i] = sc[i] * s + m
        mapping = {i: n_coach + i for i in range(n_legacy)}
        mapping.update({n_legacy + j: j for j in range(n_coach)})
        _remap_split_indices(model, mapping, layout.n_features)
    else:
        raise NotImplementedError(f"unrecognized play model feature count {num_feature}")

    # dense DataFrame input at train time: zeros are real values, not missing
    return forest_from_xgb_json(model, layout, name="play", zero_as_missing=False)


def _remap_split_indices(model: dict, mapping: dict, n_features: int) -> None:
    model["learner"]["learner_model_param"]["num_feature"] = str(n_features)
    for t in model["learner"]["gradient_booster"]["model"]["trees"]:
        left = t["left_children"]
        t["split_indices"] = [
            mapping.get(int(s), int(s)) if left[i] != -1 else 0
            for i, s in enumerate(t["split_indices"])
        ]


# the JAX package's default artifact directory (its entry points' artifact_dir)
DEFAULT_ARTIFACT_DIR = "/root/reference"
# the JAX package's committed overlay, read in place as data (not imported)
RECONSTRUCTED_DIR = (Path(__file__).resolve().parents[2] / "fast_monte_carlo_tpu"
                     / "artifacts" / "reconstructed")


def load_reconstructed_heads(artifact_dir: str | Path = DEFAULT_ARTIFACT_DIR,
                             **kw) -> ModelHeads:
    """Heads for the reconstructed mode (config.reconstructed_config): the
    artifact directory's heads plus the committed overlay
    (`fast_monte_carlo_tpu/artifacts/reconstructed/`) filling the two a
    directory may be missing — the stage-2 not-complete head and the play
    model's softmax temperature (calibration.json)."""
    return load_heads(artifact_dir, overlay_dir=RECONSTRUCTED_DIR, **kw)

"""XGBoost model parsing — no xgboost dependency: a copy of
fast_monte_carlo_tpu/models/xgb_json.py (stdlib and numpy), held to its
original by tests/test_torch_loaders.py.

Parses the XGBoost JSON (and UBJSON) model schema directly into a
:class:`FlatForest`.  Covers what the reference artifacts use:

  * ``binary:logistic`` (pass stage 1 ``pass_stage1_complete_vs_not.json``,
    the run-fumble head ``run_fumble.json``)
  * ``multi:softprob``  (pass stage 2 and the play-call model)

Schema notes (xgboost model JSON, stable since 1.x):
  * trees carry parallel arrays left_children/right_children/split_indices/
    split_conditions/default_left; a node is a leaf iff left_children == -1,
    and then split_conditions holds the leaf value.
  * ``tree_info[t]`` is the output class of tree t (all zero for binary).
  * ``learner_model_param.base_score`` is stored in *probability* space for
    logistic objectives; the margin-space intercept is logit(base_score).
    For softprob/identity objectives base_score passes through unchanged.
"""
from __future__ import annotations

import json
import math
import struct
from pathlib import Path
from typing import Optional

import numpy as np

from .forest import FeatureLayout, FlatForest, stack_nodes


def load_xgb_json(path: str | Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _base_margin(objective: str, base_score: float, n_classes: int) -> np.ndarray:
    if objective.startswith("binary:logistic"):
        p = min(max(base_score, 1e-12), 1 - 1e-12)
        return np.asarray([math.log(p / (1 - p))], dtype=np.float32)
    return np.full((n_classes,), base_score, dtype=np.float32)


def forest_from_xgb_json(
    model: dict,
    layout: FeatureLayout,
    *,
    name: str = "",
    num_trees: Optional[int] = None,
    zero_as_missing: bool = True,
) -> FlatForest:
    """Compile a parsed XGBoost JSON model dict into a FlatForest.

    num_trees optionally truncates boosting rounds (iteration_range-style
    slicing, as `models.wrappers.PassOutcomeTwoStage` uses it); the
    simulator itself uses ALL trees.
    """
    learner = model["learner"]
    objective = learner["objective"]
    obj_name = objective["name"] if isinstance(objective, dict) else str(objective)
    lmp = learner["learner_model_param"]
    num_class = int(lmp.get("num_class", "0") or 0)
    n_classes = max(1, num_class)
    base_score = float(lmp["base_score"])
    n_features = int(lmp["num_feature"])
    if n_features != layout.n_features:
        raise ValueError(
            f"{name}: layout has {layout.n_features} features but model expects {n_features}"
        )

    gbm = learner["gradient_booster"]
    if gbm.get("name", "gbtree") not in ("gbtree", "dart"):
        raise ValueError(f"unsupported booster {gbm.get('name')}")
    raw_trees = gbm["model"]["trees"]
    tree_info = gbm["model"].get("tree_info") or [0] * len(raw_trees)

    if num_trees is not None:
        keep = num_trees * n_classes
        raw_trees = raw_trees[:keep]
        tree_info = tree_info[:keep]

    trees = []
    for t in raw_trees:
        if any(int(s) != 0 for s in t.get("split_type", [])):
            raise NotImplementedError(
                "native categorical splits not supported yet; "
                "reference artifacts one-hot encode categoricals"
            )
        left = np.asarray(t["left_children"], dtype=np.int32)
        cond = np.asarray(t["split_conditions"], dtype=np.float32)
        sidx = np.asarray(t["split_indices"], dtype=np.int64)
        is_leaf = left == -1
        trees.append({
            "feat": np.where(is_leaf, -1, sidx).astype(np.int32),
            "thresh": np.where(is_leaf, 0.0, cond).astype(np.float32),
            "left": left,
            "right": np.asarray(t["right_children"], dtype=np.int32),
            "default_left": np.asarray(t["default_left"], dtype=bool),
            "leaf": np.where(is_leaf, cond, 0.0).astype(np.float32),
        })

    if obj_name.startswith("binary:logistic"):
        link = "sigmoid"
    elif obj_name.startswith("multi:softprob"):
        link = "softmax"
    else:
        link = "identity"

    return stack_nodes(
        trees,
        layout,
        tree_class=[int(c) for c in tree_info],
        n_classes=n_classes,
        base_margin=_base_margin(obj_name, base_score, n_classes),
        link=link,
        cmp="lt",
        name=name or obj_name,
        zero_as_missing=zero_as_missing,
    )


# ---------------------------------------------------------------------------
# UBJSON (what newer xgboost embeds in pickles / .ubj files)
# ---------------------------------------------------------------------------

class _UbjReader:
    __slots__ = ("b", "i")

    def __init__(self, b: bytes):
        self.b = b
        self.i = 0

    def _take(self, n: int) -> bytes:
        v = self.b[self.i:self.i + n]
        self.i += n
        return v

    def _marker(self) -> int:
        while True:
            m = self.b[self.i]
            self.i += 1
            if m != 0x4E:  # 'N' no-op
                return m

    def _int(self, m: int) -> int:
        if m == ord("i"):
            return struct.unpack(">b", self._take(1))[0]
        if m == ord("U"):
            return self._take(1)[0]
        if m == ord("I"):
            return struct.unpack(">h", self._take(2))[0]
        if m == ord("l"):
            return struct.unpack(">i", self._take(4))[0]
        if m == ord("L"):
            return struct.unpack(">q", self._take(8))[0]
        raise ValueError(f"bad ubjson int marker {chr(m)}")

    def _length(self) -> int:
        return self._int(self._marker())

    def _string(self) -> str:
        return self._take(self._length()).decode("utf-8")

    def value(self, m: Optional[int] = None):
        if m is None:
            m = self._marker()
        c = chr(m)
        if c == "{":
            return self._object()
        if c == "[":
            return self._array()
        if c == "S":
            return self._string()
        if c in "iUIlL":
            return self._int(m)
        if c == "d":
            return struct.unpack(">f", self._take(4))[0]
        if c == "D":
            return struct.unpack(">d", self._take(8))[0]
        if c == "T":
            return True
        if c == "F":
            return False
        if c == "Z":
            return None
        if c == "C":
            return chr(self._take(1)[0])
        raise ValueError(f"bad ubjson marker {c!r} at {self.i}")

    def _container_header(self):
        ty = None
        count = None
        m = self._marker()
        if m == ord("$"):
            ty = self._marker()
            m = self._marker()
        if m == ord("#"):
            count = self._length()
            return ty, count, None
        return ty, None, m

    def _array(self):
        ty, count, first = self._container_header()
        out = []
        if count is not None:
            if ty is not None and chr(ty) in "dDiUIlL":
                dt = {"d": ">f4", "D": ">f8", "i": ">i1", "U": ">u1",
                      "I": ">i2", "l": ">i4", "L": ">i8"}[chr(ty)]
                raw = self._take(np.dtype(dt).itemsize * count)
                return np.frombuffer(raw, dtype=dt).tolist()
            for _ in range(count):
                out.append(self.value(ty))
            return out
        m = first
        while m != ord("]"):
            out.append(self.value(m))
            m = self._marker()
        return out

    def _object(self):
        ty, count, first = self._container_header()
        out = {}
        if count is not None:
            for _ in range(count):
                k = self._string()
                out[k] = self.value(ty)
            return out
        m = first
        while m != ord("}"):
            # object keys are length-prefixed strings without the 'S' marker
            self.i -= 1
            k = self._string()
            out[k] = self.value()
            m = self._marker()
        return out


def loads_auto(raw: bytes) -> dict:
    """Parse serialized booster bytes: JSON or UBJSON (both start with '{')."""
    try:
        return json.loads(raw.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError):
        return _UbjReader(raw).value()


def forest_from_xgb_raw(raw: bytes, layout: FeatureLayout, *, name: str = "",
                        num_trees: Optional[int] = None) -> FlatForest:
    model = loads_auto(raw)
    # pickled sklearn-estimator raws nest the booster under 'learner' directly
    if "learner" not in model and "Model" in model:
        model = model["Model"]
    return forest_from_xgb_json(model, layout, name=name, num_trees=num_trees)

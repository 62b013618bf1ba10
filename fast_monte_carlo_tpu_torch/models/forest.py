"""Flattened tree ensembles: port of fast_monte_carlo_tpu/models/forest.py.

Every trained head (XGBoost boosters, sklearn GradientBoosting quantile
pipelines) compiles to a struct-of-arrays node soup plus per-tree roots,
evaluated by a depth-bounded vectorized "gather walk".  This module is the
framework-free host side: the layout, the node arrays, the numpy oracle
(`eval_margin_np`, `predict_np`) and the feature-usage introspection that
drives table builds.  `ops/forest_eval.py` packs a forest for the device.

One-hot player columns are never materialized: a split on categorical
column c of group g evaluates ``1.0 if cat_ids[g] == local(c) else 0.0``,
so a forest takes its numerics plus one integer id per player group
(-1 = unseen).

Comparison semantics are recorded per forest:
  xgboost:  go left iff x <  threshold (missing -> default_left child)
  sklearn:  go left iff x <= threshold
and `zero_as_missing` (XGBoost over sparse CSR input treats 0.0 as missing)
routes a value of exactly 0.0 through the node's default_left child.

Forests are compiled from trained artifacts (`models/xgb_json.py`,
`models/sklearn_gbr.py`, read by `models.heads.load_heads`), come in as
arrays (`flat_forest_from_numpy`) or from `fixtures.heads`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

LEAF = -1


@dataclass(frozen=True)
class FeatureLayout:
    """Global feature-index layout: concatenated one-hot groups, then numerics."""

    cat_group_names: Tuple[str, ...]          # e.g. ('passer_name', 'target_name')
    cat_group_sizes: Tuple[int, ...]
    numeric_names: Tuple[str, ...]            # the 17 state features, in order
    categories: Dict[str, Tuple[str, ...]]    # group -> category strings

    @property
    def n_cat(self) -> int:
        return int(sum(self.cat_group_sizes))

    @property
    def n_features(self) -> int:
        return self.n_cat + len(self.numeric_names)

    @property
    def cat_group_offsets(self) -> Tuple[int, ...]:
        offs, acc = [], 0
        for s in self.cat_group_sizes:
            offs.append(acc)
            acc += s
        return tuple(offs)

    def cat_id(self, group: str, name: str) -> int:
        """Category id of `name` within `group`; -1 if unseen (one-hot row of
        zeros, as OneHotEncoder(handle_unknown='ignore') gives)."""
        cats = self.categories.get(group, ())
        try:
            return cats.index(name)
        except ValueError:
            return -1


@dataclass
class FlatForest:
    """Struct-of-arrays tree ensemble.

    Arrays are concatenated over all trees; `roots[t]` indexes the root node
    of tree t.  Leaves have feat == -1 and their value in `leaf`.
    """

    feat: np.ndarray          # (N,) int32   global feature idx, -1 at leaves
    thresh: np.ndarray        # (N,) float32 split threshold (0 at leaves)
    left: np.ndarray          # (N,) int32   absolute child index (-1 at leaves)
    right: np.ndarray         # (N,) int32
    default_left: np.ndarray  # (N,) bool    missing-value routing (xgboost)
    leaf: np.ndarray          # (N,) float32 leaf value (0 at internal nodes)
    roots: np.ndarray         # (T,) int32
    tree_class: np.ndarray    # (T,) int32   output class per tree
    n_classes: int
    base_margin: np.ndarray   # (n_classes,) float32, in margin space
    link: str                 # 'identity' | 'sigmoid' | 'softmax'
    cmp: str                  # 'lt' (xgboost) | 'le' (sklearn)
    max_depth: int
    layout: FeatureLayout
    name: str = ""
    zero_as_missing: bool = False

    @property
    def n_trees(self) -> int:
        return int(self.roots.shape[0])

    @property
    def n_nodes(self) -> int:
        return int(self.feat.shape[0])

    def validate(self) -> None:
        """Raises ValueError unless the node arrays form valid trees."""
        n = self.n_nodes
        internal = self.feat >= 0
        checks = (
            ((self.left[internal] >= 0).all() and (self.left[internal] < n).all(),
             "left child out of range"),
            ((self.right[internal] >= 0).all() and (self.right[internal] < n).all(),
             "right child out of range"),
            ((self.left[~internal] == LEAF).all(), "a leaf has a child"),
            (self.feat[internal].max(initial=0) < self.layout.n_features,
             "split feature outside the layout"),
            (self.tree_class.max(initial=0) < self.n_classes, "tree class out of range"),
            (self.link in ("identity", "sigmoid", "softmax"), f"link {self.link!r}"),
            (self.cmp in ("lt", "le"), f"cmp {self.cmp!r}"),
        )
        for ok, what in checks:
            if not ok:
                raise ValueError(f"forest {self.name!r}: {what}")

    # ------------------------------------------------------------------
    # numpy batched evaluation (host oracle / table building on CPU)
    # ------------------------------------------------------------------
    def _feature_values_np(self, node_feat, x_num, cat_ids):
        """Resolve feature values for a (B, T) array of split feature ids."""
        lay = self.layout
        ncat = lay.n_cat
        f = node_feat
        is_cat = (f >= 0) & (f < ncat)
        num_idx = np.clip(f - ncat, 0, len(lay.numeric_names) - 1)
        val = np.take_along_axis(x_num, num_idx, axis=1).astype(np.float32)
        if ncat:
            catval = np.zeros_like(val)
            for g, (off, size) in enumerate(zip(lay.cat_group_offsets, lay.cat_group_sizes)):
                in_g = is_cat & (f >= off) & (f < off + size)
                if not in_g.any():
                    continue
                ids = cat_ids[lay.cat_group_names[g]]
                match = (f - off) == ids[:, None]
                catval = np.where(in_g & match, 1.0, catval)
            val = np.where(is_cat, catval, val)
        return val

    def eval_margin_np(self, x_num: np.ndarray,
                       cat_ids: Dict[str, np.ndarray] | None = None) -> np.ndarray:
        """Raw margins, shape (B, n_classes), summed in float64.

        x_num: (B, n_numeric) float; cat_ids: group -> (B,) int (-1 = unseen).
        """
        x_num = np.asarray(x_num, dtype=np.float32)
        B = x_num.shape[0]
        cat_ids = cat_ids or {}
        for gname in self.layout.cat_group_names:
            if gname not in cat_ids:
                cat_ids[gname] = np.full((B,), -1, dtype=np.int64)

        node = np.broadcast_to(self.roots[None, :], (B, self.n_trees)).copy()
        for _ in range(self.max_depth):
            f = self.feat[node]
            is_leaf = f < 0
            if is_leaf.all():
                break
            val = self._feature_values_np(np.maximum(f, 0), x_num, cat_ids)
            th = self.thresh[node]
            go_left = (val < th) if self.cmp == "lt" else (val <= th)
            if self.zero_as_missing:
                go_left = np.where(val == 0.0, self.default_left[node], go_left)
            nxt = np.where(go_left, self.left[node], self.right[node])
            node = np.where(is_leaf, node, nxt)

        leaf_vals = self.leaf[node]  # (B, T)
        margins = np.zeros((B, self.n_classes), dtype=np.float64)
        for c in range(self.n_classes):
            mask = self.tree_class == c
            margins[:, c] = leaf_vals[:, mask].sum(axis=1)
        return margins + self.base_margin[None, :]

    def predict_np(self, x_num: np.ndarray,
                   cat_ids: Dict[str, np.ndarray] | None = None) -> np.ndarray:
        m = self.eval_margin_np(x_num, cat_ids)
        if self.link == "identity":
            return m[:, 0] if self.n_classes == 1 else m
        if self.link == "sigmoid":
            return 1.0 / (1.0 + np.exp(-m[:, 0]))
        z = m - m.max(axis=1, keepdims=True)
        ez = np.exp(z)
        return ez / ez.sum(axis=1, keepdims=True)

    # ------------------------------------------------------------------
    # feature usage introspection (drives table-axis selection)
    # ------------------------------------------------------------------
    def numeric_thresholds(self) -> Dict[str, np.ndarray]:
        """Distinct split thresholds per numeric feature name."""
        lay = self.layout
        out: Dict[str, List[float]] = {}
        internal = self.feat >= 0
        f = self.feat[internal]
        th = self.thresh[internal]
        isnum = f >= lay.n_cat
        for fi, t in zip(f[isnum] - lay.n_cat, th[isnum]):
            out.setdefault(lay.numeric_names[fi], []).append(float(t))
        return {k: np.unique(np.asarray(v, dtype=np.float64)) for k, v in out.items()}

    def used_cat_locals(self, group: str) -> np.ndarray:
        """Which local category ids of `group` appear in any split.  Players
        not in this set are interchangeable with 'unseen' for this forest."""
        lay = self.layout
        g = lay.cat_group_names.index(group)
        off = lay.cat_group_offsets[g]
        size = lay.cat_group_sizes[g]
        internal = self.feat >= 0
        f = self.feat[internal]
        sel = (f >= off) & (f < off + size)
        return np.unique(f[sel] - off)


def stack_nodes(
    trees: Sequence[dict],
    layout: FeatureLayout,
    *,
    tree_class: Sequence[int],
    n_classes: int,
    base_margin: np.ndarray,
    link: str,
    cmp: str,
    name: str = "",
    zero_as_missing: bool = False,
) -> FlatForest:
    """Build a FlatForest from per-tree dicts with local-index arrays:
    feat/thresh/left/right/default_left/leaf (leaves: feat == -1)."""
    feats, threshs, lefts, rights, dls, leaves, roots = [], [], [], [], [], [], []
    offset = 0
    maxd = 1
    for t in trees:
        n = len(t["feat"])
        feat = np.asarray(t["feat"], dtype=np.int32)
        left = np.asarray(t["left"], dtype=np.int32)
        right = np.asarray(t["right"], dtype=np.int32)
        internal = feat >= 0
        left = np.where(internal, left + offset, LEAF)
        right = np.where(internal, right + offset, LEAF)
        feats.append(feat)
        threshs.append(np.asarray(t["thresh"], dtype=np.float32))
        lefts.append(left)
        rights.append(right)
        dls.append(np.asarray(t["default_left"], dtype=bool))
        leaves.append(np.asarray(t["leaf"], dtype=np.float32))
        roots.append(offset)
        maxd = max(maxd, _depth_of(feat, np.asarray(t["left"]), np.asarray(t["right"])))
        offset += n

    forest = FlatForest(
        feat=np.concatenate(feats),
        thresh=np.concatenate(threshs),
        left=np.concatenate(lefts),
        right=np.concatenate(rights),
        default_left=np.concatenate(dls),
        leaf=np.concatenate(leaves),
        roots=np.asarray(roots, dtype=np.int32),
        tree_class=np.asarray(tree_class, dtype=np.int32),
        n_classes=n_classes,
        base_margin=np.asarray(base_margin, dtype=np.float32),
        link=link,
        cmp=cmp,
        max_depth=maxd,
        layout=layout,
        name=name,
        zero_as_missing=zero_as_missing,
    )
    forest.validate()
    return forest


def _depth_of(feat: np.ndarray, left: np.ndarray, right: np.ndarray) -> int:
    """Levels of a tree from its root (node 0, depth 1) to its deepest leaf,
    by a walk that does not rely on parent-before-child order."""
    maxd = 1
    stack = [(0, 1)]
    while stack:
        i, d = stack.pop()
        maxd = max(maxd, d)
        if feat[i] >= 0:
            stack.append((int(left[i]), d + 1))
            stack.append((int(right[i]), d + 1))
    return maxd


# the node arrays of a FlatForest and their dtypes
FOREST_ARRAYS = {"feat": np.int32, "thresh": np.float32, "left": np.int32,
                 "right": np.int32, "default_left": bool, "leaf": np.float32,
                 "roots": np.int32, "tree_class": np.int32, "base_margin": np.float32}


def flat_forest_from_numpy(d: dict) -> FlatForest:
    """A FlatForest from a dict: the node arrays (`FOREST_ARRAYS`' keys), the
    scalars n_classes, link, cmp, max_depth, name and zero_as_missing, and
    the layout as cat_group_names, cat_group_sizes, numeric_names and
    categories (group -> names) — for example every field of a JAX
    package's FlatForest, so that both packages evaluate the same trees."""
    layout = FeatureLayout(
        cat_group_names=tuple(str(g) for g in d["cat_group_names"]),
        cat_group_sizes=tuple(int(s) for s in d["cat_group_sizes"]),
        numeric_names=tuple(str(n) for n in d["numeric_names"]),
        categories={str(g): tuple(str(c) for c in cats)
                    for g, cats in d["categories"].items()})
    forest = FlatForest(
        **{k: np.asarray(d[k], dtype=t) for k, t in FOREST_ARRAYS.items()},
        n_classes=int(d["n_classes"]), link=str(d["link"]), cmp=str(d["cmp"]),
        max_depth=int(d["max_depth"]), layout=layout, name=str(d.get("name", "")),
        zero_as_missing=bool(d.get("zero_as_missing", False)))
    forest.validate()
    return forest

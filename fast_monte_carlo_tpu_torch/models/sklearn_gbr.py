"""Compile sklearn GradientBoosting pipelines into FlatForests: port of
fast_monte_carlo_tpu/models/sklearn_gbr.py over the stand-ins that
`compat.load_sklearn_artifact` reads without sklearn (the same attributes).

The nine yardage heads are sklearn Pipelines of
``ColumnTransformer[OneHotEncoder(players) + passthrough(17 numerics)]``
followed by ``GradientBoostingRegressor(loss='quantile', alpha in {.1,.5,.9},
n_estimators=400, max_depth=3)`` (artifacts {pass,run,sack}_yards_q{10,50,90}.joblib).

Prediction semantics reproduced exactly:
    raw(x) = init_.constant_ + learning_rate * sum_t tree_t(x)
with sklearn's ``x <= threshold -> left`` split rule; the learning rate is
folded into the leaf values at compile time.
"""
from __future__ import annotations

from pathlib import Path
import numpy as np

from ..compat import load_sklearn_artifact
from .forest import FeatureLayout, FlatForest, stack_nodes


def layout_from_column_transformer(pre) -> FeatureLayout:
    """FeatureLayout from a fitted ColumnTransformer of the reference shape:
    transformer 'cat' = OneHotEncoder(cat columns), 'num' = passthrough."""
    cat_names: list[str] = []
    cat_sizes: list[int] = []
    categories: dict[str, tuple[str, ...]] = {}
    numeric: tuple[str, ...] = ()
    for tname, trans, cols in pre.transformers_:
        if tname == "remainder" and (trans == "drop" or trans is None):
            continue
        if hasattr(trans, "categories_"):
            for col, cats in zip(cols, trans.categories_):
                cat_names.append(str(col))
                cat_sizes.append(len(cats))
                categories[str(col)] = tuple(str(c) for c in cats)
            if getattr(trans, "drop_idx_", None) is not None:
                raise NotImplementedError("OneHotEncoder(drop=...) not supported")
        else:
            numeric = tuple(str(c) for c in cols)
    return FeatureLayout(
        cat_group_names=tuple(cat_names),
        cat_group_sizes=tuple(cat_sizes),
        numeric_names=numeric,
        categories=categories,
    )


def forest_from_gbr_pipeline(pipe, *, name: str = "") -> FlatForest:
    pre = pipe.steps[0][1]
    gbr = pipe.steps[-1][1]
    layout = layout_from_column_transformer(pre)

    lr = float(gbr.learning_rate)
    init = gbr.init_
    const = float(np.asarray(init.constant_).ravel()[0])

    trees = []
    for est in gbr.estimators_[:, 0]:
        t = est.tree_
        feat = t.feature.astype(np.int32)          # -2 at leaves (TREE_UNDEFINED)
        is_leaf = t.children_left == -1
        trees.append({
            "feat": np.where(is_leaf, -1, feat).astype(np.int32),
            "thresh": np.where(is_leaf, 0.0, t.threshold).astype(np.float32),
            "left": t.children_left.astype(np.int32),
            "right": t.children_right.astype(np.int32),
            "default_left": np.ones(t.node_count, dtype=bool),
            "leaf": np.where(is_leaf, lr * t.value[:, 0, 0], 0.0).astype(np.float32),
        })

    return stack_nodes(
        trees,
        layout,
        tree_class=[0] * len(trees),
        n_classes=1,
        base_margin=np.asarray([const], dtype=np.float32),
        link="identity",
        cmp="le",
        name=name,
    )


def load_gbr_forest(path: str | Path, *, name: str = "") -> FlatForest:
    pipe = load_sklearn_artifact(path)
    return forest_from_gbr_pipeline(pipe, name=name or Path(path).stem)


def forest_from_gbc_pipeline(pipe, *, name: str = "") -> FlatForest:
    """Compile a GradientBoostingClassifier pipeline (the train/pipeline.py
    sklearn fallback for the xgboost heads) into a FlatForest.

    sklearn raw predictions: init log-odds (binary) / log-priors (multi)
    plus learning_rate * per-class tree sums; link sigmoid / softmax.
    """
    pre = pipe.steps[0][1]
    gbc = pipe.steps[-1][1]
    layout = layout_from_column_transformer(pre)
    lr = float(gbc.learning_rate)
    n_classes_model = gbc.estimators_.shape[1]  # 1 for binary

    priors = np.asarray(gbc.init_.class_prior_, dtype=np.float64) \
        if hasattr(gbc.init_, "class_prior_") else None
    if n_classes_model == 1:
        p = float(priors[1]) if priors is not None else 0.5
        p = min(max(p, 1e-12), 1 - 1e-12)
        base = np.asarray([np.log(p / (1 - p))], dtype=np.float32)
        link = "sigmoid"
        n_classes = 1
    else:
        pr = np.clip(priors if priors is not None
                     else np.full(n_classes_model, 1.0 / n_classes_model), 1e-12, None)
        base = np.log(pr).astype(np.float32)
        link = "softmax"
        n_classes = n_classes_model

    trees = []
    tree_class = []
    for m in range(gbc.estimators_.shape[0]):
        for k in range(n_classes_model):
            t = gbc.estimators_[m, k].tree_
            is_leaf = t.children_left == -1
            trees.append({
                "feat": np.where(is_leaf, -1, t.feature).astype(np.int32),
                "thresh": np.where(is_leaf, 0.0, t.threshold).astype(np.float32),
                "left": t.children_left.astype(np.int32),
                "right": t.children_right.astype(np.int32),
                "default_left": np.ones(t.node_count, dtype=bool),
                "leaf": np.where(is_leaf, lr * t.value[:, 0, 0], 0.0).astype(np.float32),
            })
            tree_class.append(k)

    return stack_nodes(trees, layout, tree_class=tree_class, n_classes=n_classes,
                       base_margin=base, link=link, cmp="le", name=name)

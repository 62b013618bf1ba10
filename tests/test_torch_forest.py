"""The port's tree ensembles (models/forest.py, ops/forest_eval.py) against
the JAX package's, on the CPU, where `eval_margin` runs its plain version
(the K5 kernel's twin).

Inputs are `fixtures.heads(seed, "small")` carried into the JAX package
forest for forest, and feature rows drawn with numpy.  Leaf indices are
compared exactly (the walk is f32 comparisons of equal inputs); margins
within rtol=1e-5, atol=1e-4: the JAX package sums leaves through an f32
dot, its numpy oracle in float64 and the port in tree order in float32."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_monte_carlo_tpu.models import forest as jforest
from fast_monte_carlo_tpu.ops import forest_eval as jfe
from fast_monte_carlo_tpu_torch import fixtures
from fast_monte_carlo_tpu_torch.models import forest as tforest
from fast_monte_carlo_tpu_torch.models.heads import (ST1_FEATURES, STAGE2_CLASSES,
                                                     load_heads, model_heads_from_numpy)
from fast_monte_carlo_tpu_torch.ops import forest_eval as tfe

from conftest import make_state_batch
from test_torch_support import (HEAD_FIELDS, TRIO_FIELDS, forest_arrays, heads_arrays,
                                jax_forest, jax_heads, port_heads)

torch.set_num_threads(1)

HEADS_SEED = 5
RTOL, ATOL = 1e-5, 1e-4


def _forests(h):
    return {"stage1": h.stage1, "stage2": h.stage2, "pq": h.pass_quants[1],
            "rq": h.rush_quants[2], "sq": h.sack_quants[0], "fumble": h.fumble,
            "play": h.play}


def _inputs(f, rng, n=600, zeros=0.15):
    """Rows for forest f: its numerics drawn plausibly (state rows in ST1
    order, else uniform), a share set to exactly 0.0; per group ids from
    -1 (unseen) over the first few categories, where the splits sit."""
    cols = make_state_batch(rng, n)
    x = np.stack([cols[c] if c in cols else rng.uniform(-10, 40, n)
                  for c in f.layout.numeric_names], axis=1).astype(np.float32)
    x[rng.random(x.shape) < zeros] = 0.0
    cats = {g: rng.integers(-1, 8, n).astype(np.int32) for g in f.layout.cat_group_names}
    return x, cats


def jax_walk(jf, x, cat_ids):
    """The leaf each row reaches in each tree: the body of the JAX
    package's `eval_margin` (ops/forest_eval.py) up to its leaf take."""
    B, T = x.shape[0], jf.roots.shape[0]
    cid = (jnp.stack([cat_ids.get(g, jnp.full((B,), -1, jnp.int32)).astype(jnp.int32)
                      for g in jf.group_names], axis=1)
           if jf.group_names else jnp.zeros((B, 1), jnp.int32))
    node = jnp.broadcast_to(jf.roots[None, :], (B, T)).astype(jnp.int32)

    def body(_, node):
        nd = jnp.take(jf.nodes, node.reshape(-1), axis=0, mode="clip").reshape(B, T, 8)
        numv = jnp.take_along_axis(x, nd[..., 0].astype(jnp.int32), axis=1)
        trial = jnp.take_along_axis(cid, nd[..., 2].astype(jnp.int32), axis=1)
        catv = (trial == nd[..., 3].astype(jnp.int32)).astype(x.dtype)
        val = jnp.where(nd[..., 1] != 0.0, catv, numv)
        th = nd[..., 4]
        go_left = (val < th) if jf.cmp_lt else (val <= th)
        if jf.zero_as_missing:
            go_left = jnp.where(val == 0.0, nd[..., 7] != 0.0, go_left)
        return jnp.where(go_left, nd[..., 5].astype(jnp.int32), nd[..., 6].astype(jnp.int32))

    return np.asarray(jax.lax.fori_loop(0, jf.max_depth, body, node))


def _assert_forest_equal(p, j):
    for k, dtype in tforest.FOREST_ARRAYS.items():
        a, b = getattr(p, k), getattr(j, k)
        assert a.dtype == b.dtype == np.dtype(dtype), k
        np.testing.assert_array_equal(a, b, err_msg=k)
    for k in ("n_classes", "link", "cmp", "max_depth", "name", "zero_as_missing",
              "n_trees", "n_nodes"):
        assert getattr(p, k) == getattr(j, k), k
    pl, jl = p.layout, j.layout
    for k in ("cat_group_names", "cat_group_sizes", "numeric_names", "n_cat", "n_features",
              "cat_group_offsets"):
        assert getattr(pl, k) == getattr(jl, k), k
    assert dict(pl.categories) == dict(jl.categories)
    for g in pl.cat_group_names:
        for name in (*pl.categories[g][:3], "Nobody At All"):
            assert pl.cat_id(g, name) == jl.cat_id(g, name)
        np.testing.assert_array_equal(p.used_cat_locals(g), j.used_cat_locals(g))
    pt, jt = p.numeric_thresholds(), j.numeric_thresholds()
    assert pt.keys() == jt.keys()
    for k in pt:
        np.testing.assert_array_equal(pt[k], jt[k])


def test_heads_carried_across_equal_jax_field_for_field():
    """The fixture heads carried into the JAX package and back: every
    forest and layout field equal, the heads' scalars too."""
    h = fixtures.heads(HEADS_SEED, "small")
    jh = jax_heads(h)
    back = port_heads(jh)
    for k in HEAD_FIELDS:
        _assert_forest_equal(getattr(h, k), getattr(jh, k))
        _assert_forest_equal(getattr(back, k), getattr(jh, k))
    for k in TRIO_FIELDS:
        for p, j in zip(getattr(back, k), getattr(jh, k)):
            _assert_forest_equal(p, j)
    for k in ("stage2_class_order", "play_temperature", "play_classes"):
        assert getattr(back, k) == getattr(jh, k) == getattr(h, k)
    assert h.stage2_class_order == STAGE2_CLASSES
    with pytest.raises(ValueError, match="three forests"):
        model_heads_from_numpy({**heads_arrays(h), "pass_quants": heads_arrays(h)["pass_quants"][:2]})
    # a directory without artifacts loads as the JAX package's does: no head
    from fast_monte_carlo_tpu.models.heads import load_heads as jax_load_heads

    empty, jempty = load_heads("no-such-artifacts"), jax_load_heads("no-such-artifacts")
    for k in (*HEAD_FIELDS, *TRIO_FIELDS):
        assert getattr(empty, k) is None and getattr(jempty, k) is None, k
    for k in ("stage2_class_order", "play_temperature", "play_classes"):
        assert getattr(empty, k) == getattr(jempty, k), k


def test_stack_nodes_equals_jax():
    """The same per-tree dicts through both packages' stack_nodes (and
    _depth_of): equal forests."""
    rng = np.random.default_rng(2)
    lay = fixtures._layout(("passer_name", "target_name"), ST1_FEATURES, "small")
    jlay = jforest.FeatureLayout(lay.cat_group_names, lay.cat_group_sizes,
                                 lay.numeric_names, dict(lay.categories))
    trees = [fixtures._tree(rng, lay, d, 0.7, 0.1, i == 0) for i, d in enumerate((2, 4, 6, 3))]
    kw = dict(tree_class=[0, 1, 2, 0], n_classes=3, base_margin=[0.1, -0.2, 0.3],
              link="softmax", cmp="le", name="t", zero_as_missing=False)
    _assert_forest_equal(tforest.stack_nodes(trees, lay, **kw),
                         jforest.stack_nodes(trees, jlay, **kw))
    bad = forest_arrays(tforest.stack_nodes(trees, lay, **kw))
    bad["tree_class"] = np.asarray([0, 1, 2, 3])
    with pytest.raises(ValueError, match="class"):
        tforest.flat_forest_from_numpy(bad)


@pytest.mark.parametrize("head", ["stage1", "stage2", "pq", "fumble", "play"])
def test_numpy_oracle_equals_jax(head):
    """eval_margin_np and predict_np: the same numpy, bit for bit."""
    h = fixtures.heads(HEADS_SEED, "small")
    f = _forests(h)[head]
    jf = jax_forest(f)
    x, cats = _inputs(f, np.random.default_rng(3))
    ids = {g: v.astype(np.int64) for g, v in cats.items()}
    np.testing.assert_array_equal(f.eval_margin_np(x, dict(ids)), jf.eval_margin_np(x, dict(ids)))
    np.testing.assert_array_equal(f.predict_np(x, dict(ids)), jf.predict_np(x, dict(ids)))


@pytest.mark.parametrize("head", ["stage1", "stage2", "pq", "rq", "sq", "fumble", "play"])
@pytest.mark.parametrize("cmp", ["lt", "le"])
@pytest.mark.parametrize("zero_as_missing", [False, True])
def test_walk_margins_and_predict_match_jax(head, cmp, zero_as_missing):
    """Every link (identity, sigmoid, softmax) under both comparisons, with
    and without zeros as missing: the plain walk's leaves equal the JAX
    walk's exactly; margins and predictions within tolerance of the JAX
    package's eval_margin / predict and of the float64 numpy oracle; unseen
    ids (-1) among the rows, and once a group left out (unseen for all)."""
    h = fixtures.heads(HEADS_SEED, "small")
    f = dataclasses.replace(_forests(h)[head], cmp=cmp,
                            zero_as_missing=zero_as_missing)
    jf = jax_forest(f)
    jp, tp = jfe.pack_forest(jf), tfe.pack_forest(f, "cpu")
    x, cats = _inputs(f, np.random.default_rng(4))
    variants = [cats]
    if cats:
        variants.append({g: v for g, v in list(cats.items())[1:]})   # first group missing
    for c in variants:
        tc = {g: torch.from_numpy(v) for g, v in c.items()}
        jc = {g: jnp.asarray(v) for g, v in c.items()}
        xt = torch.from_numpy(x)
        np.testing.assert_array_equal(tfe.walk_leaves(tp, xt, tc).numpy(),
                                      jax_walk(jp, jnp.asarray(x), jc))
        got = tfe.eval_margin(tp, xt, tc).numpy()
        np.testing.assert_allclose(got, np.asarray(jfe.eval_margin(jp, jnp.asarray(x), jc)),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(
            got, f.eval_margin_np(x, {g: v.astype(np.int64) for g, v in c.items()}),
            rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(tfe.predict(tp, xt, tc).numpy(),
                                   np.asarray(jfe.predict(jp, jnp.asarray(x), jc)),
                                   rtol=RTOL, atol=ATOL)


def test_pack_forest_equals_jax():
    """The (N, 8) node table, leaves, roots, class matrix and base margin
    equal the JAX package's pack, with its static fields."""
    h = fixtures.heads(HEADS_SEED, "small")
    for f in _forests(h).values():
        jp, tp = jfe.pack_forest(jax_forest(f)), tfe.pack_forest(f, "cpu")
        for k in ("nodes", "leaf", "roots", "class_matrix", "base_margin"):
            np.testing.assert_array_equal(getattr(tp, k).numpy(), np.asarray(getattr(jp, k)))
        for k in ("max_depth", "n_classes", "link", "cmp_lt", "zero_as_missing",
                  "group_names", "numeric_names"):
            assert getattr(tp, k) == getattr(jp, k), k
        np.testing.assert_array_equal(tp.tree_class.numpy(), f.tree_class)


def test_plain_version_chunks_rows(monkeypatch):
    """The plain walk takes rows a chunk at a time at full width; the
    chunked result equals one pass."""
    h = fixtures.heads(HEADS_SEED, "small")
    tp = tfe.pack_forest(h.stage2, "cpu")
    x, cats = _inputs(h.stage2, np.random.default_rng(6), n=257)
    xt, tc = torch.from_numpy(x), {g: torch.from_numpy(v) for g, v in cats.items()}
    whole = tfe.eval_margin(tp, xt, tc)
    leaves = tfe.walk_leaves(tp, xt, tc)
    monkeypatch.setattr(tfe, "_PLAIN_PAIRS", 5 * tp.n_trees)   # 5 rows a pass
    assert torch.equal(tfe.eval_margin(tp, xt, tc), whole)
    assert torch.equal(tfe.walk_leaves(tp, xt, tc), leaves)


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    """On the CPU eval_margin runs the plain version; the kernel's wrapper
    raises for tensors off the card, for shapes the kernel does not take
    and for a forest whose packed records would overflow a field (here the
    row slot: 65 numerics), without launching."""
    h = fixtures.heads(HEADS_SEED, "small")
    tp = tfe.pack_forest(h.stage1, "cpu")
    x = torch.zeros((4, 17))
    before = tfe.eval_margin_cuda.launches
    with pytest.raises(ValueError, match="card"):
        tfe.eval_margin_cuda(tp, x, torch.zeros((4, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="feature columns"):
        tfe.eval_margin(tp, torch.zeros((4, 16)))
    with pytest.raises(ValueError, match="float32"):
        tfe.eval_margin(tp, torch.zeros((4, 17), dtype=torch.float64))
    lay = h.stage1.layout
    wide = dataclasses.replace(h.stage1, layout=dataclasses.replace(
        lay, numeric_names=lay.numeric_names + tuple(f"extra{i}" for i in range(48))))
    tw = tfe.pack_forest(wide, "cpu")
    assert tw.kernel is None
    with pytest.raises(ValueError, match="65 numeric features"):
        tfe.eval_margin_cuda(tw, torch.zeros((4, 65)), torch.zeros((4, 1), dtype=torch.int32))
    assert tfe.eval_margin_cuda.launches == before


def test_reconstructed_stage2_carried_across_matches_sklearn():
    """The in-repo reconstructed stage-2 head (an sklearn pipeline), compiled
    by the JAX package and carried across: the port's predict equals
    pipe.predict_proba within 1e-5."""
    pytest.importorskip("sklearn")
    import pandas as pd

    from fast_monte_carlo_tpu.compat import load_sklearn_artifact
    from fast_monte_carlo_tpu.models.heads import RECONSTRUCTED_DIR
    from fast_monte_carlo_tpu.models.sklearn_gbr import forest_from_gbc_pipeline

    pipe = load_sklearn_artifact(RECONSTRUCTED_DIR / "pass_stage2_sklearn.joblib")
    f = tforest.flat_forest_from_numpy(forest_arrays(forest_from_gbc_pipeline(pipe,
                                                                              name="stage2")))
    assert (f.n_trees, f.n_nodes, f.n_classes, f.max_depth, f.link) == (3, 135, 3, 6, "softmax")
    rng = np.random.default_rng(7)
    n = 512
    cols = make_state_batch(rng, n)
    df = pd.DataFrame(cols)
    x = np.column_stack([cols[c] for c in f.layout.numeric_names]).astype(np.float32)
    cats = {}
    for g in f.layout.cat_group_names:
        known = list(f.layout.categories[g])
        picks = rng.integers(-1, len(known), n)
        df[g] = [known[p] if p >= 0 else f"__unseen_{i}" for i, p in enumerate(picks)]
        cats[g] = torch.from_numpy(picks.astype(np.int32))
    got = tfe.predict(tfe.pack_forest(f, "cpu"), torch.from_numpy(x), cats).numpy()
    np.testing.assert_allclose(got, pipe.predict_proba(df), rtol=0, atol=1e-5)

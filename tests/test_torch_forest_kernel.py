"""K5's layout (ops/forest_eval.py `pack_kernel_records`) and its plain twin
(`walk_packed`, `eval_margin_packed`: the kernel's walk over the packed
records, decoding each field as csrc/forest_eval.cu does), on the CPU.

The twin is held to the plain walk (`walk_leaves`, itself held to the JAX
package's walk in test_torch_forest.py) leaf for leaf, and to
`eval_margin_reference` bitwise: the kernel sums each class's leaves in
tree order in float32, as both do.  Inputs are `fixtures.heads(seed,
"small")` and feature rows drawn with numpy, as in test_torch_forest.py."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_monte_carlo_tpu.ops import forest_eval as jfe
from fast_monte_carlo_tpu_torch import fixtures
from fast_monte_carlo_tpu_torch.models import forest as tforest
from fast_monte_carlo_tpu_torch.models.heads import ST1_FEATURES
from fast_monte_carlo_tpu_torch.ops import forest_eval as tfe

from test_torch_forest import _forests, _inputs, jax_walk
from test_torch_support import jax_forest

torch.set_num_threads(1)

HEADS_SEED = 5
HEADS = ["stage1", "stage2", "pq", "rq", "sq", "fumble", "play"]


def _variant(head, cmp, zero_as_missing):
    f = _forests(fixtures.heads(HEADS_SEED, "small"))[head]
    return dataclasses.replace(f, cmp=cmp, zero_as_missing=zero_as_missing)


def _cat_variants(cats):
    """The ids as drawn (-1 among them), and with the first group left out."""
    out = [cats]
    if cats:
        out.append({g: v for g, v in list(cats.items())[1:]})
    return [{g: torch.from_numpy(v) for g, v in c.items()} for c in out]


@pytest.mark.parametrize("head", HEADS)
@pytest.mark.parametrize("cmp", ["lt", "le"])
@pytest.mark.parametrize("zero_as_missing", [False, True])
def test_packed_walk_equals_plain_walk_leaf_for_leaf(head, cmp, zero_as_missing):
    """The kernel's walk over its packed records ends on the plain walk's
    leaf in every (row, tree)."""
    f = _variant(head, cmp, zero_as_missing)
    tp = tfe.pack_forest(f, "cpu")
    assert tp.kernel is not None, tp.kernel_refusal
    x, cats = _inputs(f, np.random.default_rng(4))
    xt = torch.from_numpy(x)
    for c in _cat_variants(cats):
        assert torch.equal(tfe.walk_packed(tp, xt, c), tfe.walk_leaves(tp, xt, c))


@pytest.mark.parametrize("head", HEADS)
@pytest.mark.parametrize("cmp", ["lt", "le"])
@pytest.mark.parametrize("zero_as_missing", [False, True])
def test_packed_margins_equal_reference_bitwise(head, cmp, zero_as_missing):
    """Margins from the packed records' leaf words, summed in tree order,
    equal `eval_margin_reference` bit for bit."""
    f = _variant(head, cmp, zero_as_missing)
    tp = tfe.pack_forest(f, "cpu")
    x, cats = _inputs(f, np.random.default_rng(8))
    xt = torch.from_numpy(x)
    for c in _cat_variants(cats):
        assert torch.equal(tfe.eval_margin_packed(tp, xt, c),
                           tfe.eval_margin_reference(tp, xt, c))


def test_packed_walk_equals_jax_walk():
    """Every small head: the packed walk's leaves are the JAX package's."""
    for head in HEADS:
        f = _forests(fixtures.heads(HEADS_SEED, "small"))[head]
        tp, jp = tfe.pack_forest(f, "cpu"), jfe.pack_forest(jax_forest(f))
        x, cats = _inputs(f, np.random.default_rng(9))
        got = tfe.walk_packed(tp, torch.from_numpy(x),
                              {g: torch.from_numpy(v) for g, v in cats.items()})
        np.testing.assert_array_equal(
            got.numpy(), jax_walk(jp, jnp.asarray(x), {g: jnp.asarray(v)
                                                       for g, v in cats.items()}))


@pytest.mark.parametrize("head", HEADS)
def test_renumbering_keeps_each_trees_leaves_and_order(head):
    """Trees keep their order, each a block of records from its root;
    every internal record's children are an adjacent pair (left, then
    right) of the FlatForest's children; leaf records hold their leaf
    values; each record's row slot and flags decode to its node's split."""
    f = _forests(fixtures.heads(HEADS_SEED, "small"))[head]
    kf = tfe.pack_forest(f, "cpu").kernel
    recs = kf.records.numpy().view(np.uint32)
    node_of = kf.node_of.numpy()
    first = kf.tiles[kf.tree_tile, 0].numpy() + kf.trees.numpy()
    assert (np.diff(first) > 0).all()
    np.testing.assert_array_equal(node_of[first], f.roots)
    ncat = f.layout.n_cat
    for t in range(f.n_trees):
        end = first[t + 1] if t + 1 < f.n_trees else len(recs)
        block = np.flatnonzero(node_of[first[t]:end] >= 0) + first[t]
        # the records of tree t: exactly its nodes, breadth first
        reach, frontier = [], [int(f.roots[t])]
        while frontier:
            reach += frontier
            frontier = [int(k) for n in frontier if f.feat[n] >= 0
                        for k in (f.left[n], f.right[n])]
        np.testing.assert_array_equal(node_of[block], reach)
        for r in block:
            n, meta = node_of[r], recs[r, 1]
            if f.feat[n] < 0:
                assert meta & tfe.LEAF_BIT and meta >> tfe.LEFT_SHIFT == (r - first[t]) * 8
                assert recs[r, 0] == np.float32(f.leaf[n]).view(np.uint32)
                continue
            left = first[t] + (meta >> tfe.LEFT_SHIFT) // 8
            assert (node_of[left], node_of[left + 1]) == (f.left[n], f.right[n])
            is_cat = f.feat[n] < ncat
            assert bool(meta & tfe.IS_CAT_BIT) == is_cat
            slot = (meta & tfe.SLOT_MASK) // 4
            if is_cat:
                g = slot
                off = f.layout.cat_group_offsets[g]
                assert off <= f.feat[n] < off + f.layout.cat_group_sizes[g]
                assert recs[r, 0] == f.feat[n] - off
            else:
                assert slot == tfe.MAX_GROUPS + f.feat[n] - ncat
                assert recs[r, 0] == np.float32(f.thresh[n]).view(np.uint32)


@pytest.mark.parametrize("max_depth", [0, 1, 2, 3])
def test_walk_cut_short_by_max_depth_equals_plain(max_depth):
    """A forest whose trees reach below max_depth: the plain walk stops
    after max_depth levels, on an internal node, and takes its `leaf`; the
    packed walk ends there too, with the same margins."""
    f = dataclasses.replace(_variant("stage1", "lt", True), max_depth=max_depth)
    tp = tfe.pack_forest(f, "cpu")
    assert tp.kernel.steps == max_depth
    x, cats = _inputs(f, np.random.default_rng(10))
    xt, c = torch.from_numpy(x), {g: torch.from_numpy(v) for g, v in cats.items()}
    assert torch.equal(tfe.walk_packed(tp, xt, c), tfe.walk_leaves(tp, xt, c))
    assert torch.equal(tfe.eval_margin_packed(tp, xt, c), tfe.eval_margin_reference(tp, xt, c))


def test_small_tiles_keep_tree_order_and_alignment(monkeypatch):
    """With tiles of 64 records the forests split into many: each tile
    starts on an even record, copies whole 16-byte units covering its
    records, holds whole trees in order; the packed walk still equals the
    plain one bitwise."""
    monkeypatch.setattr(tfe, "TILE_RECORDS", 64)   # a depth-6 tree: at most 63
    for head in ("stage1", "play", "pq"):
        f = _forests(fixtures.heads(HEADS_SEED, "small"))[head]
        tp = tfe.pack_forest(f, "cpu")
        tiles = tp.kernel.tiles.numpy()
        assert len(tiles) > 1
        assert (tiles[:, 0] % 2 == 0).all() and (tiles[:, 1] % 16 == 0).all()
        assert (tiles[:, 1] <= 64 * 8).all()
        np.testing.assert_array_equal(tiles[1:, 2], tiles[:-1, 3])
        assert (tiles[0, 2], tiles[-1, 3]) == (0, f.n_trees)
        assert tiles[-1, 0] * 8 + tiles[-1, 1] <= tp.kernel.records.shape[0] * 8
        x, cats = _inputs(f, np.random.default_rng(11))
        xt, c = torch.from_numpy(x), {g: torch.from_numpy(v) for g, v in cats.items()}
        assert torch.equal(tfe.eval_margin_packed(tp, xt, c),
                           tfe.eval_margin_reference(tp, xt, c))


def _one_tree_forest(groups=(), numerics=ST1_FEATURES, depth=2):
    """A forest of one complete tree of `depth` levels, every split on the
    first numeric at 0.5."""
    lay = tforest.FeatureLayout(tuple(groups), tuple(2 for _ in groups), tuple(numerics),
                                {g: ("a", "b") for g in groups})
    n = 2 ** depth - 1
    internal = np.arange(n) < 2 ** (depth - 1) - 1
    idx = np.arange(n)
    tree = {"feat": np.where(internal, lay.n_cat, -1), "thresh": np.where(internal, 0.5, 0.0),
            "left": np.where(internal, 2 * idx + 1, -1),
            "right": np.where(internal, 2 * idx + 2, -1),
            "default_left": np.zeros(n, bool), "leaf": np.where(internal, 0.0, 0.25)}
    return tforest.stack_nodes([tree], lay, tree_class=[0], n_classes=1,
                               base_margin=np.zeros(1, np.float32), link="identity", cmp="le",
                               name="wide")


@pytest.mark.parametrize("field,forest,match", [
    ("groups", lambda: _one_tree_forest(groups=[f"g{i}" for i in range(5)]), "category groups"),
    ("numerics", lambda: _one_tree_forest(numerics=[f"n{i}" for i in range(65)]),
     "numeric features"),
    ("tree", lambda: _one_tree_forest(depth=13), "a tree of 8191 records"),
])
def test_packed_field_overflow_raises(field, forest, match):
    """A forest that overflows a packed field: `pack_kernel_records`
    raises ValueError, `pack_forest` keeps the reason, and the kernel's
    wrapper raises it without launching; the plain walk still takes the
    forest on the CPU."""
    f = forest()
    with pytest.raises(ValueError, match=match):
        tfe.pack_kernel_records(f)
    tp = tfe.pack_forest(f, "cpu")
    assert tp.kernel is None and match in tp.kernel_refusal
    x = torch.zeros((4, len(f.layout.numeric_names)))
    cid = torch.zeros((4, 1), dtype=torch.int32)
    before = tfe.eval_margin_cuda.launches
    with pytest.raises(ValueError, match=match):
        tfe.eval_margin_cuda(tp, x, cid)
    with pytest.raises(ValueError, match=match):
        tfe.eval_margin_packed(tp, x)
    assert tfe.eval_margin_cuda.launches == before
    np.testing.assert_allclose(tfe.eval_margin(tp, x).numpy(), f.eval_margin_np(x.numpy()))


def test_reference_heads_pack_for_the_kernel():
    """The reference-shape heads (the exact-mode play's forests) all pack:
    the quantile forests' complete depth-4 trees walk 3 levels, 15
    records a tree in two tiles; the others 5; every tile within
    TILE_RECORDS; on 64 rows the packed walk equals the plain one
    bitwise."""
    h = fixtures.heads(0, "reference")
    rng = np.random.default_rng(12)
    for name, f in {"stage1": h.stage1, "stage2": h.stage2, "fumble": h.fumble,
                    "play": h.play, **{f"q{i}": q for i, q in enumerate(
                        h.pass_quants + h.rush_quants + h.sack_quants)}}.items():
        tp = tfe.pack_forest(f, "cpu")
        kf = tp.kernel
        assert kf is not None, (name, tp.kernel_refusal)
        assert kf.steps == (3 if name.startswith("q") else 5), name
        assert (kf.tiles[:, 1].numpy() <= tfe.TILE_RECORDS * 8).all()
        if name.startswith("q"):
            assert kf.tiles.shape[0] == 2 and int((kf.node_of >= 0).sum()) == f.n_nodes
        x, cats = _inputs(f, rng, n=64)
        xt, c = torch.from_numpy(x), {g: torch.from_numpy(v) for g, v in cats.items()}
        assert torch.equal(tfe.eval_margin_packed(tp, xt, c),
                           tfe.eval_margin_reference(tp, xt, c)), name

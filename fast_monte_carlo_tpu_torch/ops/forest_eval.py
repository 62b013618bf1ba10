"""Device-side FlatForest evaluation (exact mode): port of
fast_monte_carlo_tpu/ops/forest_eval.py (`pack_forest`, `eval_margin`,
`predict`).

`pack_forest` turns a FlatForest into a `TorchForest` on one device: one
(N, 8) f32 node table [num_idx, is_cat, cat_group, cat_local, thresh,
left, right, default_left] with per-node metadata resolved on the host
(every field round-trips through f32 exactly: indices < 2^24), leaves
self-looping so a finished walk stays put.

Beside it `pack_kernel_records` builds the layout K5 reads, once on the
host: one 8-byte record a node (`KernelForest`), each tree renumbered
breadth first so that a node's children are an adjacent pair, the trees
cut into tiles the kernel stages in shared memory.  A forest that
overflows one of its fields packs with `kernel=None` and the reason in
`kernel_refusal`; the plain walk still takes it, the kernel raises.

`eval_margin` computes margins (B, C) = base_margin + the sum over each
class's trees of the leaf a row reaches.  On CUDA it launches K5, the
hand-written kernel `csrc/forest_eval.cu` (a block's rows and a tile of
records in shared memory, several walks in flight a thread, per-class
sums in tree order); a failed build or launch raises.  On the CPU it runs
the plain version, `eval_margin_reference`: the JAX package's
depth-bounded gather walk (exactly max_depth levels,
clipped takes), then each class's leaves summed in tree order in float32,
the kernel's order.  The JAX package sums through an f32 `jnp.dot` and its
numpy oracle in float64, so margins agree to a few ulps; the leaves a row
reaches agree exactly (`walk_leaves`), being f32 comparisons of equal
inputs.

`predict` applies the forest's link through `forest_link`: the logistic
and the softmax as explicit f32 operations in K1's order (`sigmoid_f32`,
`softmax_f32`), so the eager loop, K1's plain version and K1's exact-mode
instantiation (which walks these records inside its launch,
csrc/nano_game.cu) agree bit for bit on the card.

The JAX package's merged walk (`MergedForest`, `merge_forests`,
`eval_merged`) is a TPU experiment, off by default there
(`EngineConfig.exact_merged`), and is not ported.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..models.forest import FlatForest

_KERNEL = "forest_eval"
# the kernel stages a row's category ids in MAX_GROUPS slots and keeps its
# class sums in registers
MAX_GROUPS = 4
MAX_CLASSES = 8
# it stages its block's rows in shared memory: 256 rows of MAX_GROUPS ids
# and at most this many floats
MAX_FEATURES = 64
# records of one tile: one of the kernel's two shared-memory buffers
# (32 KB; kTileRecords in csrc/forest_eval.cu).  A tree must fit in one.
TILE_RECORDS = 4096

# A kernel record is two 32-bit words.  Word 0: an internal numeric node's
# threshold (f32 bits), a categorical node's category id (int32, any), a
# leaf's value (f32 bits).  Word 1 (`meta`), by bit:
#   0-8   SLOT: the byte offset in the staged row of the word the node
#         reads: 4 g for a categorical node of group g (< MAX_GROUPS),
#         4 (MAX_GROUPS + j) for numeric feature j (< MAX_FEATURES): < 512
#   9     IS_CAT (leaves too: they never go right)
#   10    DEFAULT_RIGHT: a numeric node's child for a value of 0.0 when
#         zeros are missing is the right one
#   11    CAT_MATCH_RIGHT: a categorical node goes right when the id matches
#   12    CAT_MISS_RIGHT: ... when it does not (the value is then 0.0, so
#         with zeros as missing this is DEFAULT_RIGHT)
#   13    LEAF
#   17-31 LEFT: the byte offset of the left child's record from its tree's
#         first (8 x its index); the right child is the next record.  A
#         leaf's own offset.  Below 2^15: a tree of at most TILE_RECORDS
#         = 4,096 records.
SLOT_MASK = (1 << 9) - 1
IS_CAT_BIT = 1 << 9
DEFAULT_RIGHT_BIT = 1 << 10
CAT_MATCH_RIGHT_BIT = 1 << 11
CAT_MISS_RIGHT_BIT = 1 << 12
LEAF_BIT = 1 << 13
LEFT_SHIFT = 17
# the plain version walks at most this many (row, tree) pairs at a time:
# 64 MB of gathered node records a level
_PLAIN_PAIRS = 1 << 21


@dataclass(frozen=True)
class KernelForest:
    """K5's layout of a forest (`pack_kernel_records`)."""

    records: torch.Tensor   # (R, 2) int32: [threshold / category id / leaf value, meta]
    trees: torch.Tensor     # (T,) int32 each tree's first record within its tile
    tiles: torch.Tensor     # (n_tiles, 4) int32: [first record (even), bytes to copy
                            #  (a multiple of 16), first tree, end tree]
    node_of: torch.Tensor   # (R,) int64 the FlatForest node of each record (-1: padding)
    steps: int              # levels every walk takes from its root

    @property
    def tree_tile(self) -> torch.Tensor:
        """(T,) int64 the tile of each tree."""
        t = torch.arange(self.trees.shape[0], device=self.trees.device)
        return torch.searchsorted(self.tiles[:, 3].contiguous().to(torch.int64), t,
                                  right=True)


@dataclass(frozen=True)
class TorchForest:
    """A FlatForest on one device, as the walk reads it."""

    nodes: torch.Tensor         # (N, 8) f32: [num_idx, is_cat, cat_group,
                                #  cat_local, thresh, left, right, default_left]
    leaf: torch.Tensor          # (N,) f32
    roots: torch.Tensor         # (T,) i32
    tree_class: torch.Tensor    # (T,) i32 output class per tree
    class_matrix: torch.Tensor  # (T, C) f32 one-hot tree -> class
    base_margin: torch.Tensor   # (C,) f32
    max_depth: int
    n_classes: int
    link: str
    cmp_lt: bool
    zero_as_missing: bool
    group_names: Tuple[str, ...]
    numeric_names: Tuple[str, ...]
    # each class's tree indices, in tree order (the plain class sum)
    class_trees: Tuple[Tuple[int, ...], ...] = ()
    # K5's layout, or None and why the kernel does not take this forest
    kernel: Optional[KernelForest] = None
    kernel_refusal: str = ""

    @property
    def device(self) -> torch.device:
        return self.nodes.device

    @property
    def n_trees(self) -> int:
        return int(self.roots.shape[0])


def pack_forest(f: FlatForest, device) -> TorchForest:
    dev = resolve_device(device)
    lay = f.layout
    ncat = lay.n_cat
    feat = f.feat
    internal = feat >= 0
    is_cat = internal & (feat < ncat)
    num_idx = np.where(internal & ~is_cat, feat - ncat, 0).astype(np.int32)
    cat_group = np.zeros_like(feat, dtype=np.int32)
    cat_local = np.zeros_like(feat, dtype=np.int32)
    for g, (off, size) in enumerate(zip(lay.cat_group_offsets, lay.cat_group_sizes)):
        in_g = is_cat & (feat >= off) & (feat < off + size)
        cat_group = np.where(in_g, g, cat_group)
        cat_local = np.where(in_g, feat - off, cat_local)
    class_matrix = np.zeros((f.n_trees, f.n_classes), dtype=np.float32)
    class_matrix[np.arange(f.n_trees), f.tree_class] = 1.0
    # leaves: make left/right self-loops so a finished walk stays put
    idx = np.arange(f.n_nodes, dtype=np.int32)
    left = np.where(internal, f.left, idx).astype(np.int32)
    right = np.where(internal, f.right, idx).astype(np.int32)
    if f.n_nodes >= 1 << 24:
        raise ValueError(f"forest {f.name!r}: {f.n_nodes} nodes do not round-trip "
                         "through the f32 node table")
    nodes = np.stack([
        num_idx.astype(np.float32),
        is_cat.astype(np.float32),
        cat_group.astype(np.float32),
        cat_local.astype(np.float32),
        f.thresh.astype(np.float32),
        left.astype(np.float32),
        right.astype(np.float32),
        f.default_left.astype(np.float32),
    ], axis=1)
    tc = np.asarray(f.tree_class, dtype=np.int64)

    def t(a, dtype):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    kernel, refusal = None, ""
    try:
        recs, trees, tiles, node_of, steps = pack_kernel_records(f)
        kernel = KernelForest(records=t(recs, torch.int32), trees=t(trees, torch.int32),
                              tiles=t(tiles, torch.int32), node_of=t(node_of, torch.int64),
                              steps=steps)
    except ValueError as e:
        refusal = str(e)

    return TorchForest(
        nodes=t(nodes, torch.float32),
        leaf=t(f.leaf, torch.float32),
        roots=t(f.roots, torch.int32),
        tree_class=t(f.tree_class, torch.int32),
        class_matrix=t(class_matrix, torch.float32),
        base_margin=t(f.base_margin, torch.float32),
        max_depth=int(f.max_depth),
        n_classes=int(f.n_classes),
        link=f.link,
        cmp_lt=(f.cmp == "lt"),
        zero_as_missing=bool(f.zero_as_missing),
        group_names=tuple(lay.cat_group_names),
        numeric_names=tuple(lay.numeric_names),
        class_trees=tuple(tuple(int(i) for i in np.flatnonzero(tc == c))
                          for c in range(int(f.n_classes))),
        kernel=kernel,
        kernel_refusal=refusal,
    )


def _bfs_levels(f: FlatForest):
    """Each tree's nodes breadth first, every tree at once: per level
    (nodes, trees, local indices, internal), trees in order and a node's
    children adjacent.  At most max_depth + 1 levels, as many as the plain
    walk's max_depth steps reach; a node on the last of them ends its walk
    whatever it is."""
    n_trees = f.n_trees
    node = np.asarray(f.roots, np.int64)
    tree = np.arange(n_trees, dtype=np.int64)
    count = np.zeros(n_trees, np.int64)
    levels = []
    for lev in range(int(f.max_depth) + 1):
        if node.size == 0:
            break
        internal = (f.feat[node] >= 0) & (lev < f.max_depth)
        first = np.searchsorted(tree, tree, side="left")
        local = count[tree] + np.arange(node.size) - first
        count += np.bincount(tree, minlength=n_trees)
        levels.append((node, tree, local, internal))
        parents = node[internal]
        node = np.stack([f.left[parents], f.right[parents]], axis=1).reshape(-1).astype(np.int64)
        tree = np.repeat(tree[internal], 2)
    return levels, count


def pack_kernel_records(f: FlatForest):
    """K5's layout of forest f: (records (R, 2) int32, each tree's first
    record within its tile (T,) int32, tiles (n_tiles, 4) int32, the
    FlatForest node of each record (R,) int64, steps).  Each tree is
    renumbered breadth first from its root, so a node's children are an
    adjacent pair; a node the plain walk's max_depth steps end on is a leaf
    record holding its `leaf` value.  Every walk takes `steps` levels: the
    levels below the root that any tree reaches, at most max_depth.  Trees
    keep their order; a tile holds whole trees, at most TILE_RECORDS
    records, and starts on a 16-byte boundary.  Raises ValueError where a
    field overflows (see the record layout above)."""
    lay = f.layout
    what = f"forest {f.name!r}"
    if len(lay.cat_group_names) > MAX_GROUPS:
        raise ValueError(f"{what}: {len(lay.cat_group_names)} category groups; the kernel's "
                         f"record and row hold at most {MAX_GROUPS}")
    if len(lay.numeric_names) > MAX_FEATURES:
        raise ValueError(f"{what}: {len(lay.numeric_names)} numeric features; the kernel's "
                         f"record and row hold at most {MAX_FEATURES}")
    if max(lay.cat_group_sizes, default=0) >= 1 << 31:
        raise ValueError(f"{what}: a category id does not fit the record's int32")
    levels, count = _bfs_levels(f)
    steps = len(levels) - 1
    big = int(count.max(initial=0))
    if big > TILE_RECORDS:
        raise ValueError(f"{what}: a tree of {big} records; the kernel's tile and its "
                         f"child field hold {TILE_RECORDS}")
    # tiles: whole trees in order, each tile from an even record
    tiles, trees = [], np.zeros(f.n_trees, np.int64)
    start, first_tree, used = 0, 0, 0
    for t in range(f.n_trees):
        if used + count[t] > TILE_RECORDS:
            tiles.append((start, (used * 8 + 15) // 16 * 16, first_tree, t))
            start += used + (used & 1)
            first_tree, used = t, 0
        trees[t] = used
        used += int(count[t])
    tiles.append((start, (used * 8 + 15) // 16 * 16, first_tree, f.n_trees))
    n_rec = start + used + (used & 1)
    if n_rec >= 1 << 31:
        raise ValueError(f"{what}: {n_rec} records overflow the kernel's int32 offsets")
    tile_arr = np.asarray(tiles, np.int64).reshape(-1, 4)
    first_rec = np.repeat(tile_arr[:, 0], tile_arr[:, 3] - tile_arr[:, 2]) + trees

    words = np.zeros((n_rec, 2), np.uint32)
    node_of = np.full(n_rec, -1, np.int64)
    ncat = lay.n_cat
    offs = np.asarray(lay.cat_group_offsets + (ncat,), np.int64)
    lt = f.cmp == "lt"
    for lev, (node, tree, local, internal) in enumerate(levels):
        rec = first_rec[tree] + local
        node_of[rec] = node
        meta = np.zeros(node.size, np.uint32)
        word0 = f.leaf[node].astype(np.float32).view(np.uint32)
        # leaves (and the nodes the walk ends on): their own offset, never right
        meta |= np.where(internal, 0, (local << 3 << LEFT_SHIFT) | LEAF_BIT
                         | IS_CAT_BIT).astype(np.uint32)
        if internal.any():
            kids = levels[lev + 1][2].reshape(-1, 2)[:, 0]       # left child's local index
            i = np.flatnonzero(internal)
            fe, th = f.feat[node[i]].astype(np.int64), f.thresh[node[i]].astype(np.float32)
            right0 = ~f.default_left[node[i]].astype(bool)
            cat = fe < ncat
            g = np.searchsorted(offs, fe, side="right") - 1
            slot = np.where(cat, g, MAX_GROUPS + fe - ncat)
            match_r = ~((np.float32(1.0) < th) if lt else (np.float32(1.0) <= th))
            miss_r = right0 if f.zero_as_missing else ~(
                (np.float32(0.0) < th) if lt else (np.float32(0.0) <= th))
            m = ((kids << 3 << LEFT_SHIFT) | (slot * 4) | np.where(right0, DEFAULT_RIGHT_BIT, 0)
                 | np.where(cat, IS_CAT_BIT, 0)
                 | np.where(cat & match_r, CAT_MATCH_RIGHT_BIT, 0)
                 | np.where(cat & miss_r, CAT_MISS_RIGHT_BIT, 0))
            meta[i] = m.astype(np.uint32)
            word0[i] = np.where(cat, (fe - offs[np.clip(g, 0, None)]).astype(np.uint32),
                                th.view(np.uint32))
        words[rec, 0] = word0
        words[rec, 1] = meta
    return (words.view(np.int32), trees.astype(np.int32), tile_arr.astype(np.int32),
            node_of, steps)


def category_matrix(tf: TorchForest, cat_ids: Optional[Dict[str, torch.Tensor]],
                    b: int, device) -> torch.Tensor:
    """(B, G) int32 of each row's category id per group of the forest, in
    its group order; -1 (unseen) for a group the caller leaves out.  A
    forest without groups gets one column of zeros, which no node reads."""
    cat_ids = cat_ids or {}
    if not tf.group_names:
        return torch.zeros((b, 1), dtype=torch.int32, device=device)
    cols = [cat_ids[g].to(device=device, dtype=torch.int32) if g in cat_ids
            else torch.full((b,), -1, dtype=torch.int32, device=device)
            for g in tf.group_names]
    return torch.stack(cols, dim=1)


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _walk(tf: TorchForest, x: torch.Tensor, cid: torch.Tensor) -> torch.Tensor:
    """(B, T) int64 node each row ends on in each tree: max_depth levels of
    one node-record gather each, as the JAX package's walk."""
    b, n = x.shape[0], tf.nodes.shape[0]
    node = tf.roots.to(torch.int64).expand(b, tf.n_trees)
    cid = cid.to(torch.int64)
    for _ in range(tf.max_depth):
        nd = tf.nodes[node.clamp(0, n - 1)]                    # (B, T, 8)
        f_num = nd[..., 0].to(torch.int64)
        is_cat = nd[..., 1] != 0.0
        grp = nd[..., 2].to(torch.int64)
        cat_local = nd[..., 3].to(torch.int64)
        th = nd[..., 4]
        numv = torch.gather(x, 1, f_num.clamp(0, x.shape[1] - 1))
        trial_cat = torch.gather(cid, 1, grp.clamp(0, cid.shape[1] - 1))
        catv = (trial_cat == cat_local).to(x.dtype)
        val = torch.where(is_cat, catv, numv)
        go_left = (val < th) if tf.cmp_lt else (val <= th)
        if tf.zero_as_missing:
            go_left = torch.where(val == 0.0, nd[..., 7] != 0.0, go_left)
        node = torch.where(go_left, nd[..., 5], nd[..., 6]).to(torch.int64)
    return node


def _check_inputs(tf: TorchForest, x: torch.Tensor) -> None:
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"x must be (B, n_numeric) float32, got {x.dtype} {tuple(x.shape)}")
    if x.shape[1] < len(tf.numeric_names):
        raise ValueError(f"x has {x.shape[1]} feature columns; the forest reads "
                         f"{len(tf.numeric_names)}")
    if x.device != tf.device:
        raise ValueError(f"x on {x.device}, the forest on {tf.device}")


def walk_leaves(tf: TorchForest, x_num: torch.Tensor,
                cat_ids: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """(B, T) int64: the leaf each row reaches in each tree (the plain walk;
    the tests hold it to the JAX package's walk leaf for leaf)."""
    _check_inputs(tf, x_num)
    b = x_num.shape[0]
    cid = category_matrix(tf, cat_ids, b, x_num.device)
    out = torch.empty((b, tf.n_trees), dtype=torch.int64, device=x_num.device)
    step = _rows_per_pass(tf)
    for i in range(0, b, step):
        out[i:i + step] = _walk(tf, x_num[i:i + step], cid[i:i + step])
    return out


def _rows_per_pass(tf: TorchForest) -> int:
    return max(1, _PLAIN_PAIRS // max(1, tf.n_trees))


def eval_margin_reference(tf: TorchForest, x_num: torch.Tensor,
                          cat_ids: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """Plain-torch twin of the kernel, on any device: the walk, then each
    class's leaf values summed in tree order in float32 (no matrix product,
    so no TF32), plus the base margin.  Walks at most 2^21 (row, tree)
    pairs at a time."""
    _check_inputs(tf, x_num)
    b = x_num.shape[0]
    cid = category_matrix(tf, cat_ids, b, x_num.device)
    out = torch.empty((b, tf.n_classes), dtype=torch.float32, device=x_num.device)
    step = _rows_per_pass(tf)
    for i in range(0, b, step):
        node = _walk(tf, x_num[i:i + step], cid[i:i + step])
        lv = tf.leaf[node]                                     # (rows, T)
        for c, trees in enumerate(tf.class_trees):
            acc = torch.zeros_like(lv[:, 0])
            for t in trees:
                acc = acc + lv[:, t]
            out[i:i + step, c] = acc + tf.base_margin[c]
    return out


def _kernel_layout(tf: TorchForest) -> KernelForest:
    if tf.kernel is None:
        raise ValueError(f"K5 does not take this forest: {tf.kernel_refusal}")
    return tf.kernel


def _staged_rows(x: torch.Tensor, cid: torch.Tensor) -> torch.Tensor:
    """(B, MAX_GROUPS + F) int32: a row as the kernel stages it, the
    category ids in the first MAX_GROUPS words, then the features' f32
    bits."""
    ids = torch.zeros((x.shape[0], MAX_GROUPS), dtype=torch.int32, device=x.device)
    ids[:, :cid.shape[1]] = cid
    return torch.cat([ids, x.contiguous().view(torch.int32)], dim=1)


def _walk_records(tf: TorchForest, rows: torch.Tensor) -> torch.Tensor:
    """(B, T) int64 record each staged row ends on in each tree: the
    kernel's walk, decoding each record as the kernel does."""
    kf = _kernel_layout(tf)
    root = (kf.tiles[kf.tree_tile, 0].to(torch.int64)
            + kf.trees.to(torch.int64)).expand(rows.shape[0], -1)
    node = torch.zeros_like(root)
    for _ in range(kf.steps):
        rec = kf.records[root + node]                          # (B, T, 2)
        meta = rec[..., 1]
        w = torch.gather(rows, 1, ((meta & SLOT_MASK) >> 2).to(torch.int64))
        wf, th = w.view(torch.float32), rec[..., 0].view(torch.float32)
        right = ~(wf < th) if tf.cmp_lt else ~(wf <= th)
        if tf.zero_as_missing:
            right = torch.where(wf == 0.0, (meta & DEFAULT_RIGHT_BIT) != 0, right)
        cat_right = torch.where(w == rec[..., 0], (meta & CAT_MATCH_RIGHT_BIT) != 0,
                                (meta & CAT_MISS_RIGHT_BIT) != 0)
        right = torch.where((meta & IS_CAT_BIT) != 0, cat_right, right)
        # meta is int32 here: mask the sign the arithmetic shift spreads
        node = (((meta >> LEFT_SHIFT) & 0x7FFF) >> 3).to(torch.int64) + right.to(torch.int64)
    return root + node


def walk_packed(tf: TorchForest, x_num: torch.Tensor,
                cat_ids: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """(B, T) int64: the FlatForest node each row ends on in each tree, by
    the kernel's walk over its packed records (`pack_kernel_records`); the
    tests hold it to `walk_leaves` leaf for leaf.  Raises ValueError for a
    forest the kernel does not take."""
    _check_inputs(tf, x_num)
    kf = _kernel_layout(tf)
    rows = _staged_rows(x_num, category_matrix(tf, cat_ids, x_num.shape[0], x_num.device))
    out = torch.empty((x_num.shape[0], tf.n_trees), dtype=torch.int64, device=x_num.device)
    step = _rows_per_pass(tf)
    for i in range(0, x_num.shape[0], step):
        out[i:i + step] = kf.node_of[_walk_records(tf, rows[i:i + step])]
    return out


def eval_margin_packed(tf: TorchForest, x_num: torch.Tensor,
                       cat_ids: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """The kernel's plain twin on its own layout: the walk over the packed
    records, then each class's leaf values (the end records' word 0) summed
    in tree order in float32, plus the base margin.  Bitwise equal to
    `eval_margin_reference`."""
    _check_inputs(tf, x_num)
    kf = _kernel_layout(tf)
    b = x_num.shape[0]
    rows = _staged_rows(x_num, category_matrix(tf, cat_ids, b, x_num.device))
    out = torch.empty((b, tf.n_classes), dtype=torch.float32, device=x_num.device)
    step = _rows_per_pass(tf)
    for i in range(0, b, step):
        lv = kf.records[_walk_records(tf, rows[i:i + step]), 0].view(torch.float32)
        for c, trees in enumerate(tf.class_trees):
            acc = torch.zeros_like(lv[:, 0])
            for t in trees:
                acc = acc + lv[:, t]
            out[i:i + step, c] = acc + tf.base_margin[c]
    return out


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

def _launcher():
    from ..utils.cuda_build import load_kernel_library

    fn = load_kernel_library(_KERNEL).forest_eval_packed_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _contiguous(name: str, t: torch.Tensor, dtype, align: int = 4) -> None:
    if t.dtype != dtype or not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"{name} must be contiguous {dtype} aligned to {align} bytes; got "
                         f"{t.dtype}, contiguous={t.is_contiguous()}, "
                         f"address {t.data_ptr():#x}")


def eval_margin_cuda(tf: TorchForest, x_num: torch.Tensor, cid: torch.Tensor) -> torch.Tensor:
    """K5 on the current stream: margins (B, C) of the rows of x_num (B, F)
    f32 with category ids cid (B, G) int32 (`category_matrix`), through the
    forest's packed records (`tf.kernel`).  Raises ValueError, without
    launching, for a forest whose records overflow a field
    (`pack_kernel_records`: at most MAX_GROUPS groups, MAX_FEATURES
    numerics, TILE_RECORDS records a tree), for more than MAX_CLASSES
    classes or MAX_FEATURES feature columns, and for tensors off the card;
    RuntimeError on a failed launch."""
    kf = _kernel_layout(tf)
    b = x_num.shape[0]
    dev = tf.device
    if dev.type != "cuda" or x_num.device != dev or cid.device != dev:
        raise ValueError(f"eval_margin_cuda wants the forest and its inputs on one "
                         f"card; got {dev}, {x_num.device}, {cid.device}")
    g = cid.shape[1]
    if not 1 <= g <= MAX_GROUPS or cid.shape[0] != b:
        raise ValueError(f"category ids must be (B, 1..{MAX_GROUPS}), got {tuple(cid.shape)}")
    if not 1 <= tf.n_classes <= MAX_CLASSES:
        raise ValueError(f"the kernel sums 1..{MAX_CLASSES} classes, not {tf.n_classes}")
    if x_num.shape[1] > MAX_FEATURES:
        raise ValueError(f"the kernel stages at most {MAX_FEATURES} features a row, "
                         f"not {x_num.shape[1]}")
    _contiguous("x", x_num, torch.float32)
    _contiguous("category ids", cid, torch.int32)
    _contiguous("records", kf.records, torch.int32, 16)
    out = torch.empty((b, tf.n_classes), dtype=torch.float32, device=dev)
    launch = _launcher()
    with torch.cuda.device(dev):
        err = launch(kf.records.data_ptr(), kf.tiles.data_ptr(), kf.trees.data_ptr(),
                     tf.tree_class.data_ptr(), tf.base_margin.data_ptr(),
                     x_num.data_ptr(), cid.data_ptr(), out.data_ptr(),
                     b, x_num.shape[1], g, kf.tiles.shape[0], tf.n_classes, kf.steps,
                     int(tf.cmp_lt), int(tf.zero_as_missing), TILE_RECORDS,
                     torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"forest_eval kernel launch failed: CUDA error {err}")
    eval_margin_cuda.launches += 1
    return out


eval_margin_cuda.launches = 0


def eval_margin(tf: TorchForest, x_num: torch.Tensor,
                cat_ids: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """Raw margins (B, C).  x_num: (B, n_numeric) f32; cat_ids: group ->
    (B,) int ids (-1 = unseen; a group left out is unseen).  On CUDA this
    is K5 (`eval_margin_cuda`, counted in `eval_margin_cuda.launches`); on
    the CPU the plain version."""
    _check_inputs(tf, x_num)
    if x_num.device.type == "cpu":
        return eval_margin_reference(tf, x_num, cat_ids)
    if x_num.device.type != "cuda":
        raise ValueError(f"eval_margin: unsupported device {x_num.device}")
    cid = category_matrix(tf, cat_ids, x_num.shape[0], x_num.device)
    return eval_margin_cuda(tf, x_num.contiguous(), cid)


# ---------------------------------------------------------------------------
# links, as explicit f32 operations in K1's order (csrc/nano_game.cu
# head_values): torch.sigmoid and torch.softmax on the card add in orders of
# their own, so the eager loop, the plain version and the kernel all take
# these
# ---------------------------------------------------------------------------

def sigmoid_f32(m: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-m)), elementwise."""
    return torch.reciprocal(torch.exp(-m) + 1.0)


def softmax_f32(m: torch.Tensor) -> torch.Tensor:
    """The softmax of each row of (B, C) margins: the row's max, exp(m -
    max) class by class, their sum in class order, each over the sum."""
    mx = m[:, 0]
    for k in range(1, m.shape[1]):
        mx = torch.maximum(mx, m[:, k])
    e = [torch.exp(m[:, k] - mx) for k in range(m.shape[1])]
    total = e[0]
    for ek in e[1:]:
        total = total + ek
    return torch.stack([ek / total for ek in e], dim=1)


def forest_link(tf: TorchForest, m: torch.Tensor) -> torch.Tensor:
    """The forest's link of its margins (B, C): (B,) for identity with one
    class and for sigmoid, (B, C) otherwise."""
    if tf.link == "identity":
        return m[:, 0] if tf.n_classes == 1 else m
    if tf.link == "sigmoid":
        return sigmoid_f32(m[:, 0])
    return softmax_f32(m)


def predict(tf: TorchForest, x_num: torch.Tensor,
            cat_ids: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """The forest's link of its margins (`forest_link`)."""
    return forest_link(tf, eval_margin(tf, x_num, cat_ids))

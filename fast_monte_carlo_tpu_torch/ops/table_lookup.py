"""Table-mode heads: port of fast_monte_carlo_tpu/ops/table_lookup.py.

Three layouts, each the JAX package's, looked up by torch indexing (the
JAX package's XLA gathers; no Pallas kernel reads a table):

  nano      rows = dist x ytg x sec a direction, channels (down, sd, head):
            (16384, 105) f32 for one matchup at the nano profile.  A play
            bins its state, fetches one row and picks its (down, sd) block
            of head channels.  The JAX package picks the block with masked
            sums (a TPU gather workaround); here the block is gathered by
            index, which reads the same values on finite tables.
  fused     rows = down x dist x ytg x sec [x sd], one row a play holding
            every head (the coarse, slate and turbo grids).
  per-head  one table a head with its slot or passer x target pair row
            map (stage 1 on the fine profile, the others on the coarse
            one): the layout of a focus roster whose players the heads
            split on, where the heads cannot fuse.  Six or seven lookups a
            play.

The ML play-policy table (the coach's P(pass) on the coarse axes x 27
score-diff bins) sits beside any of them under `use_play_model`.  Every
index is clamped into its table, as the JAX package's `mode="clip"` takes
do, so the two agree at the edges too.

`build_table_heads` builds a matchup's tables from trained heads on the
host (`models.tables`), packs them on the device and keeps them in an
in-process memo keyed on content and capped by bytes.  Beneath it, as in
the JAX package, a disk cache (`TABLE_CACHE_DIR`, `.table_cache/` of the
working directory) keeps each build's host tables, so another process
reads them instead of building; the 'cachewarm' sd mode plays its CPU
oracle warm-up (`cachewarm_events`) and keeps its recordings there too.
The port's files are its own: an .npz of the arrays with a JSON header (no
unpickler runs), named with `CACHE_TAG` (a format version and a digest of the build's
source files, so a change of the code is a miss), written under a
temporary name and renamed into place.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import time
import zipfile
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..config import SimConfig
from ..models import analytic
from ..matchup import build_direction
from ..models.tables import (HostTable, TableProfile, TableSet, build_fused_table,
                             build_play_table, build_tables, cachewarm_collapse,
                             coarse_profile, edges_from_reps, fine_profile,
                             fused_head_groups, marginalize_sd, nano_from_fused,
                             nano_profile, sd_reps_default)
from ..oracle import OracleMatchup
from .game import HeadOut, HeadsEvalFn, StepObs
from .pack import MatchupPack

F32 = torch.float32
I32 = torch.int32


def segments_of(reps: np.ndarray) -> Tuple[Tuple[float, float, float, int, int], ...]:
    """Decompose a rep grid into piecewise-uniform segments:
    ((enter_boundary, start_value, step, base_idx, count), ...).
    `enter_boundary` is the midpoint between the previous segment's last rep
    and this segment's first, so nearest-rep semantics are exact."""
    reps = np.asarray(reps, dtype=np.float64)
    segs = []
    i = 0
    n = len(reps)
    while i < n:
        if i + 1 >= n:
            step = 1.0
            j = i + 1
        else:
            step = reps[i + 1] - reps[i]
            j = i + 1
            while j + 1 < n and abs((reps[j + 1] - reps[j]) - step) < 1e-9:
                j += 1
            j += 1
        enter = -np.inf if i == 0 else (reps[i - 1] + reps[i]) / 2.0
        segs.append((float(enter), float(reps[i]), float(step), i, j - i))
        i = j
    return tuple(segs)


def _seg_bin(v: torch.Tensor, segs) -> torch.Tensor:
    """Nearest-rep index of v by segment arithmetic (round half to even,
    like jnp.round; the divide is the f32-reciprocal multiply XLA emits)."""
    idx = torch.zeros(v.shape, dtype=I32, device=v.device)
    for enter, start, step, base, count in segs:
        local = torch.clamp(torch.round((v - start) * analytic.recip(step)),
                            0, count - 1).to(I32) + base
        idx = local if np.isinf(enter) else torch.where(v > enter, local, idx)
    return idx


@dataclass(frozen=True)
class ProfileIdx:
    dist_segs: tuple
    ytg_segs: tuple
    sec_segs: tuple
    sd_segs: tuple
    nd: int
    ny: int
    ns: int
    nsd: int


def profile_idx(prof: TableProfile) -> ProfileIdx:
    return ProfileIdx(
        dist_segs=segments_of(prof.dist), ytg_segs=segments_of(prof.ytg),
        sec_segs=segments_of(prof.sec),
        sd_segs=segments_of(prof.sd) if prof.sd is not None else (),
        nd=len(prof.dist), ny=len(prof.ytg), ns=len(prof.sec),
        nsd=len(prof.sd) if prof.sd is not None else 0)


@dataclass(frozen=True)
class DeviceTable:
    """Every direction's table of one head in one tensor.  `row_map` row d
    maps direction d's slots (or flattened passer x target pairs) to the
    flat row where that slot's block starts; a table without slots has
    one entry a direction."""
    values: torch.Tensor   # (rows, C) f32
    row_map: torch.Tensor  # (D, K), (D, K*K) or (D, 1) i32
    n_slots: int           # the table's slot axis
    profile: str           # 'fine' | 'coarse' | 'play' | 'fused' | 'nano'
    is_pair: bool = False
    channels: int = 1
    has_sd: bool = False

    @property
    def nbytes(self) -> int:
        return (self.values.numel() * self.values.element_size()
                + self.row_map.numel() * self.row_map.element_size())


@dataclass(frozen=True)
class TableHeads:
    """Both directions' tables of every matchup packed, direction d = gid*2
    + off.  The first layout present is the one a play reads: `nano`, then
    `fused`, then the per-head tables.  `play` is the play-policy table
    beside any of them."""
    fine: Optional[ProfileIdx] = None
    coarse: Optional[ProfileIdx] = None
    stage1: Optional[DeviceTable] = None
    stage2: Optional[DeviceTable] = None
    pq: Optional[DeviceTable] = None
    rq: Optional[DeviceTable] = None
    sq: Optional[DeviceTable] = None
    fumble: Optional[DeviceTable] = None
    play: Optional[DeviceTable] = None
    play_sd_edges: Optional[torch.Tensor] = None
    play_nsd: int = 0
    k: int = 8
    fused: Optional[DeviceTable] = None
    fused_prof: Optional[ProfileIdx] = None
    fused_has_s2: bool = False
    fused_has_fumble: bool = False
    nano: Optional[DeviceTable] = None
    nano_prof: Optional[ProfileIdx] = None
    nano_nsd: int = 1
    nano_c: int = 0
    # host seconds each direction's build took (build_table_heads), and the
    # play-policy table's share of them; () where not built: read from disk
    # or not from heads
    build_seconds: Tuple[float, ...] = ()
    play_seconds: Tuple[float, ...] = ()
    # the disk cache: whether the host tables were read from it, the read's
    # seconds on a hit or the write's on a miss, the file's bytes; the
    # 'cachewarm' warm-up's seconds and whether its recordings were read
    cache_hit: bool = False
    cache_seconds: float = 0.0
    cache_bytes: int = 0
    warm_seconds: float = 0.0
    warm_hit: bool = False

    @property
    def nano_values(self) -> torch.Tensor:
        return self.nano.values

    @property
    def per_dir(self) -> int:
        """Rows a direction of the nano table."""
        return self.nano.values.shape[0] // self.nano.row_map.shape[0]

    def tables(self) -> Iterator[Tuple[str, DeviceTable]]:
        """(name, table) of every table present."""
        for name in TABLE_NAMES:
            t = getattr(self, name)
            if t is not None:
                yield name, t

    @property
    def nbytes(self) -> int:
        return sum(t.nbytes for _, t in self.tables())

    def to(self, device) -> "TableHeads":
        """A copy with every tensor on `device`."""
        dev = resolve_device(device)
        moved = {name: dataclasses.replace(t, values=t.values.to(dev), row_map=t.row_map.to(dev))
                 for name, t in self.tables()}
        if self.play_sd_edges is not None:
            moved["play_sd_edges"] = self.play_sd_edges.to(dev)
        return dataclasses.replace(self, **moved)


TABLE_NAMES = ("nano", "fused", "stage1", "stage2", "pq", "rq", "sq", "fumble", "play")


def _merge_tables(tables: Sequence[HostTable], device, is_pair: bool = False) -> DeviceTable:
    """Stack direction tables (2 a matchup, in game order) into one device
    table; direction d's row map is offset past the rows before it."""
    t0 = tables[0]
    per_slot = int(np.prod(t0.shape)) // t0.shape[0]
    vals, rms = [], []
    offset = 0
    for t in tables:
        if tuple(t.shape[1:]) != tuple(t0.shape[1:]) or t.values.shape[1] != t0.values.shape[1]:
            raise ValueError(f"direction tables must share axes and channels: "
                             f"{t.shape} x {t.values.shape[1]} against "
                             f"{t0.shape} x {t0.values.shape[1]}")
        vals.append(t.values)
        rms.append(offset + np.asarray(t.row_map).reshape(1, -1).astype(np.int64) * per_slot)
        offset += int(np.prod(t.shape))
    values = np.ascontiguousarray(np.concatenate(vals, axis=0), dtype=np.float32)
    return DeviceTable(
        values=torch.from_numpy(values).to(device),
        row_map=torch.from_numpy(np.concatenate(rms, axis=0).astype(np.int32)).to(device),
        n_slots=int(t0.shape[0]), profile=t0.profile, is_pair=is_pair,
        channels=int(t0.values.shape[1]), has_sd=bool(t0.has_sd))


def pack_tables(t_a, t_b, device, **kw) -> TableHeads:
    """Single matchup: directions [A-offense, B-offense]."""
    return pack_tables_multi([(t_a, t_b)], device, **kw)


def pack_tables_multi(pairs: Sequence[tuple], device, *, k: int = 8,
                      fused_prof: Optional[TableProfile] = None,
                      nano_prof: Optional[TableProfile] = None) -> TableHeads:
    """Many matchups' tables, rows [g0 A-off, g0 B-off, g1 A-off, ...].
    A pair is two TableSets (packed as the JAX package packs them: the
    nano layout when `nano_prof` is given and every direction has one, the
    fused layout likewise with `fused_prof`, the per-head tables
    otherwise), or two nano HostTables (`models.tables.nano_from_fused`,
    on the nano profile unless `nano_prof` says otherwise), or two fused
    HostTables with their `fused_prof`."""
    dirs = [t for pair in pairs for t in pair]
    if all(isinstance(t, HostTable) for t in dirs):
        kinds = {t.profile for t in dirs}
        if kinds == {"nano"}:
            nano_prof = nano_prof or nano_profile()
            dirs = [_table_set(nano=t) for t in dirs]
        elif kinds == {"fused"} and fused_prof is not None:
            dirs = [_table_set(fused=t) for t in dirs]
        else:
            raise ValueError("pack_tables wants nano-layout tables of one shape "
                             "(models.tables.nano_from_fused), fused tables with their "
                             "fused_prof, or TableSets")
    dev = resolve_device(device)
    ts0 = dirs[0]

    def merge(attr, is_pair=False):
        tables = [getattr(t, attr) for t in dirs]
        if any(t is None for t in tables):
            return None
        return _merge_tables(tables, dev, is_pair)

    nano = np_idx = None
    nano_nsd, nano_c = 1, 0
    if nano_prof is not None and all(t.nano is not None for t in dirs):
        np_idx = profile_idx(nano_prof)
        if tuple(ts0.nano.shape[1:]) != (np_idx.nd, np_idx.ny, np_idx.ns):
            raise ValueError(f"nano table of shape {ts0.nano.shape} is not on the nano "
                             f"profile's {np_idx.nd} x {np_idx.ny} x {np_idx.ns} rows")
        if ts0.nano.values.shape[1] != 5 * ts0.nano.nano_nsd * ts0.nano.nano_c:
            raise ValueError(f"nano table has {ts0.nano.values.shape[1]} channels, expected "
                             f"5 * {ts0.nano.nano_nsd} * {ts0.nano.nano_c}")
        nano = merge("nano")
        nano_nsd, nano_c = ts0.nano.nano_nsd, ts0.nano.nano_c
    fused = fp = None
    if fused_prof is not None and all(t.fused is not None for t in dirs):
        fused, fp = merge("fused"), profile_idx(fused_prof)
    flags = ts0.fused if ts0.fused is not None else ts0.nano
    has_play = ts0.play is not None
    play_edges = edges_from_reps(sd_reps_default())
    return TableHeads(
        fine=profile_idx(ts0.fine) if ts0.fine is not None else None,
        coarse=profile_idx(ts0.coarse) if ts0.coarse is not None else None,
        stage1=merge("stage1"),
        stage2=merge("stage2", is_pair=(ts0.stage2 is not None
                                        and ts0.stage2.row_map.size == k * k)),
        pq=merge("pq", is_pair=True), rq=merge("rq"), sq=merge("sq"),
        fumble=merge("fumble"), play=merge("play"),
        play_sd_edges=(torch.tensor(play_edges, dtype=F32, device=dev) if has_play else None),
        play_nsd=len(sd_reps_default()) if has_play else 0, k=k,
        fused=fused, fused_prof=fp,
        fused_has_s2=bool(flags is not None and flags.fused_has_s2),
        fused_has_fumble=bool(flags is not None and flags.fused_has_fumble),
        nano=nano, nano_prof=np_idx, nano_nsd=nano_nsd, nano_c=nano_c)


def _table_set(**kw) -> TableSet:
    """A TableSet without per-head tables, holding the tables in kw."""
    base = dict(stage1=None, stage2=None, pq=None, rq=None, sq=None, fumble=None,
                play=None, fine=None, coarse=None)
    return TableSet(**{**base, **kw})


def nano_table_from_numpy(values: np.ndarray, row_map: np.ndarray, *,
                          nano_nsd: int, nano_c: int, device,
                          fused_has_s2: bool = False,
                          fused_has_fumble: bool = False) -> TableHeads:
    """TableHeads from host arrays — e.g. `np.asarray` of a JAX
    TableHeads' nano values and row_map (one entry per direction)."""
    prof = profile_idx(nano_profile())
    n_dirs = int(np.asarray(row_map).size)
    per_dir = values.shape[0] // n_dirs
    if per_dir != prof.nd * prof.ny * prof.ns or per_dir * n_dirs != values.shape[0]:
        raise ValueError(f"nano table of {values.shape[0]} rows does not hold "
                         f"{n_dirs} directions of the profile's "
                         f"{prof.nd * prof.ny * prof.ns} rows")
    if values.shape[1] != 5 * nano_nsd * nano_c:
        raise ValueError(f"nano table has {values.shape[1]} channels, "
                         f"expected 5 * {nano_nsd} * {nano_c}")
    dev = resolve_device(device)
    nano = DeviceTable(
        values=torch.tensor(np.asarray(values, dtype=np.float32), device=dev),
        row_map=(torch.arange(n_dirs, dtype=I32, device=dev) * per_dir).view(n_dirs, 1),
        n_slots=1, profile="nano", channels=int(values.shape[1]))
    return TableHeads(nano=nano, nano_prof=prof, nano_nsd=nano_nsd, nano_c=nano_c,
                      fused_has_s2=fused_has_s2, fused_has_fumble=fused_has_fumble)


# ---------------------------------------------------------------------------
# the lookups
# ---------------------------------------------------------------------------

def _take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`jnp.take(t, idx, axis=0, mode="clip")`: rows at idx clamped into t."""
    return t[torch.clamp(idx.long(), 0, t.shape[0] - 1)]


def _bin(v: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """The count of edges below v: v's nearest rep when the edges are the
    reps' midpoints (the play table's score-diff bin)."""
    return (v[:, None] > edges[None, :]).sum(dim=1, dtype=I32)


def _stage2_fallback(obs: StepObs, cfg: SimConfig) -> torch.Tensor:
    """The analytic stage 2's post-nudge (P(inc), P(inc) + P(sack)), for
    tables built without a stage-2 forest."""
    inc, itc, sck = analytic.stage2_fallback_probs(obs.down.to(F32), obs.dist, cfg)
    inc, itc, sck = analytic.stage2_nudge(inc, itc, sck, cfg)
    return torch.stack([inc, inc + sck], dim=1)


def _state_idx(prof: ProfileIdx, obs: StepObs, down_i: torch.Tensor) -> torch.Tensor:
    """The flat (down, dist, ytg, sec) cell of each state on `prof`."""
    di = _seg_bin(obs.dist, prof.dist_segs)
    yi = _seg_bin(obs.ytg, prof.ytg_segs)
    si = _seg_bin(obs.sec.to(F32), prof.sec_segs)
    return ((down_i * prof.nd + di) * prof.ny + yi) * prof.ns + si


def _down_idx(obs: StepObs) -> torch.Tensor:
    return torch.clamp(obs.down - 1, 0, 4)   # down >= 5 is one class


def _unpack_head_row(th: TableHeads, obs: StepObs, row: torch.Tensor,
                     cfg: SimConfig) -> HeadOut:
    """FUSED_CHANNELS unpack of a fused or nano row, and the play-policy
    lookup (the direction's block of the play table, at the state's coarse
    cell and score-diff bin).  Without stage-2 channels the analytic stage
    2 applies, as in the JAX package."""
    p_c = row[:, 0]
    c = 7
    if th.fused_has_s2:
        s2_cum = row[:, c:c + 2]
        c += 2
    else:
        s2_cum = _stage2_fallback(obs, cfg)
    p_f = row[:, c] if th.fused_has_fumble else torch.zeros_like(p_c)
    p_pass_ml = None
    if th.play is not None and cfg.model.use_play_model:
        cstate = _state_idx(th.coarse, obs, _down_idx(obs))
        per_dir = th.play.values.shape[0] // th.play.row_map.numel()
        sdi = _bin(obs.sd, th.play_sd_edges)
        p_pass_ml = _take(th.play.values, obs.dirx.long() * per_dir
                          + cstate * th.play_nsd + sdi)[:, 0]
    return HeadOut(p_complete=p_c, s2_cum=s2_cum, pass_ms=row[:, 1:3],
                   rush_ms=row[:, 3:5], sack_ms=row[:, 5:7], p_fumble=p_f,
                   p_pass_ml=p_pass_ml)


def _nano_eval(th: TableHeads, obs: StepObs, cfg: SimConfig) -> HeadOut:
    """Bin the state, then gather the (down, sd) block of the state's row:
    nano_c values per play from the (rows, 5*nsd*c) table."""
    prof = th.nano_prof
    di = _seg_bin(obs.dist, prof.dist_segs)
    yi = _seg_bin(obs.ytg, prof.ytg_segs)
    si = _seg_bin(obs.sec.to(F32), prof.sec_segs)
    # the row and block are in range by construction (every bin clamped,
    # dirx < D), so the flat index needs no clamp
    row = obs.dirx * th.per_dir + (di * prof.ny + yi) * prof.ns + si
    nsd, c = th.nano_nsd, th.nano_c
    blk = _down_idx(obs) * nsd
    if nsd > 1:
        blk = blk + _seg_bin(obs.sd, prof.sd_segs)
    start = row.long() * th.nano.values.shape[1] + (blk * c).long()
    cols = torch.arange(c, dtype=torch.int64, device=start.device)
    sel = th.nano.values.view(-1)[start[:, None] + cols]
    return _unpack_head_row(th, obs, sel, cfg)


def _fused_eval(th: TableHeads, obs: StepObs, cfg: SimConfig) -> HeadOut:
    """One fused row a play carries every head."""
    prof = th.fused_prof
    state = _state_idx(prof, obs, _down_idx(obs))
    if th.fused.has_sd:
        state = state * prof.nsd + _seg_bin(obs.sd, prof.sd_segs)
    per_dir = th.fused.values.shape[0] // th.fused.row_map.numel()
    row = _take(th.fused.values, obs.dirx.long() * per_dir + state)
    return _unpack_head_row(th, obs, row, cfg)


def _per_head_eval(th: TableHeads, obs: StepObs, cfg: SimConfig) -> HeadOut:
    """A lookup a head: the slot key (off*K + qb or rb, the pair key
    off*K*K + qb*K + wr) through the head's row map to its block, then the
    state's cell on the head's profile, sd folded in where it has one."""
    off, k = obs.dirx, th.k
    down_i = _down_idx(obs)
    idx, sd_idx = {}, {}
    for name, prof in (("fine", th.fine), ("coarse", th.coarse)):
        idx[name] = _state_idx(prof, obs, down_i)
        if prof.sd_segs:
            sd_idx[name] = (_seg_bin(obs.sd, prof.sd_segs), prof.nsd)

    def lookup(t: DeviceTable, slot_key: torch.Tensor) -> torch.Tensor:
        base = _take(t.row_map.view(-1), slot_key)
        pname = t.profile if t.profile in idx else "coarse"
        state = idx[pname]
        if t.has_sd:
            sdi, nsd = sd_idx[pname]
            state = state * nsd + sdi
        return _take(t.values, base.long() + state)

    slot_qb = off * k + obs.qb
    slot_rb = off * k + obs.rb
    pair = off * (k * k) + obs.qb * k + obs.wr
    p_c = lookup(th.stage1, slot_qb)[:, 0]
    if th.stage2 is not None:
        s2_cum = lookup(th.stage2, pair if th.stage2.is_pair else slot_qb)
    else:
        s2_cum = _stage2_fallback(obs, cfg)
    if th.fumble is not None and cfg.model.enable_fumbles:
        p_f = lookup(th.fumble, slot_rb)[:, 0]
    else:
        p_f = torch.zeros_like(p_c)
    p_pass_ml = None
    if th.play is not None and cfg.model.use_play_model:
        base = _take(th.play.row_map.view(-1), off)
        sdi = _bin(obs.sd, th.play_sd_edges)
        p_pass_ml = _take(th.play.values,
                          base.long() + idx["coarse"] * th.play_nsd + sdi)[:, 0]
    return HeadOut(p_complete=p_c, s2_cum=s2_cum, pass_ms=lookup(th.pq, pair),
                   rush_ms=lookup(th.rq, slot_rb), sack_ms=lookup(th.sq, slot_qb),
                   p_fumble=p_f, p_pass_ml=p_pass_ml)


def make_table_heads_eval(cfg: SimConfig) -> HeadsEvalFn:
    """Table-mode heads-eval; heads_state is a TableHeads of any layout."""

    def heads_eval(th: TableHeads, obs: StepObs, pack: MatchupPack) -> HeadOut:
        if th.nano is not None:
            return _nano_eval(th, obs, cfg)
        if th.fused is not None:
            return _fused_eval(th, obs, cfg)
        return _per_head_eval(th, obs, cfg)

    heads_eval.needs_x = False  # tables key on scalar state fields only
    heads_eval.table_heads = True  # K1 plays its nano launches (game.nano_game_covers)
    return heads_eval


# ---------------------------------------------------------------------------
# the disk cache
# ---------------------------------------------------------------------------

# where build_table_heads, the SlateRunner's build and the 'cachewarm'
# warm-up keep their files by default (cache_dir="auto"); None turns the
# disk cache off.  Relative to the working directory, as in the JAX package.
TABLE_CACHE_DIR: Optional[str] = ".table_cache"
# the package's files whose code decides what a build or a warm-up gives:
# their digest is part of CACHE_TAG, so a change to any of them is a miss
_BUILD_SOURCES = ("ops/table_lookup.py", "models/tables.py", "models/analytic.py",
                  "models/heads.py", "models/forest.py", "matchup.py", "oracle.py", "stats.py")


def _sources_digest() -> str:
    h = hashlib.sha256()
    root = Path(__file__).resolve().parents[1]
    for rel in _BUILD_SOURCES:
        h.update(rel.encode())
        h.update((root / rel).read_bytes())
    return h.hexdigest()[:8]


# every file name of the port ends in this tag: the JAX package's pickles of
# its own classes in the same directory are never read; a change of the
# format below changes its version, a change of the build's code its digest
CACHE_TAG = f"torch-v1-{_sources_digest()}"


def _table_cache_key(team_a, team_b, heads, cfg: SimConfig, fine, coarse, fused) -> str:
    """The JAX package's disk key of a matchup's tables (24 hex digits):
    the contexts by names, ratings and shares, the profiles, each forest
    by name, tree and node counts and its leaf and threshold sums, and the
    model constants the tables bake in.  The same string for the same
    contents as `fast_monte_carlo_tpu.ops.table_lookup._table_cache_key`."""
    def prof_sig(p):
        if p is None:
            return None
        return [p.dist.tolist(), p.ytg.tolist(), p.sec.tolist(),
                None if p.sd is None else p.sd.tolist()]

    def ctx_sig(t):
        return [t.name, t.sp_rating, t.sp_offense, t.sp_defense,
                t.qb.names, t.qb.share.tolist(),
                t.rush.names, t.rush.share.tolist(),
                t.target.names, t.target.share.tolist()]

    def forest_sig(f):
        if f is None:
            return None
        return [f.name, f.n_trees, f.n_nodes, float(f.leaf.sum()), float(f.thresh.sum())]

    payload = json.dumps([
        ctx_sig(team_a), ctx_sig(team_b),
        prof_sig(fine), prof_sig(coarse), prof_sig(fused),
        forest_sig(heads.stage1), forest_sig(heads.stage2),
        [forest_sig(f) for f in (heads.pass_quants or ())],
        [forest_sig(f) for f in (heads.rush_quants or ())],
        [forest_sig(f) for f in (heads.sack_quants or ())],
        forest_sig(heads.fumble), forest_sig(heads.play),
        cfg.model.enable_fumbles, cfg.model.use_play_model,
        cfg.model.stage1_clip_lo, cfg.model.stage1_clip_hi,
        cfg.model.stage2_sack_scale, cfg.model.stage2_int_scale,
    ], sort_keys=True)
    return hashlib.sha256(payload.encode()).hexdigest()[:24]


def _build_sig(heads, cfg_text: str, coach_map) -> str:
    """What a build reads beyond `_table_cache_key`: the config's repr, the
    coach map and the heads' class orders and play temperature (12 hex
    digits).  The port's file names carry it, so a change there is a miss
    where the JAX package would read a stale file."""
    payload = json.dumps([cfg_text, sorted((coach_map or {}).items()),
                          float(heads.play_temperature), list(heads.play_classes),
                          list(heads.stage2_class_order)])
    return hashlib.sha256(payload.encode()).hexdigest()[:12]


def _table_cfg_text(cfg: SimConfig) -> str:
    """The config's repr without the sd-mode fields: the files hold the
    tables before the sd mode applies, so every sd mode shares them."""
    return repr(cfg.replace(engine=dataclasses.replace(
        cfg.engine, sd_mode="axis", cachewarm_games=0, cachewarm_seed=0)))


def _cache_path(cache_dir, stem: str, suffix: str) -> Optional[Path]:
    if cache_dir == "auto":
        cache_dir = TABLE_CACHE_DIR
    return Path(cache_dir) / f"{stem}.{CACHE_TAG}.{suffix}" if cache_dir else None


def _publish(path: Path, write) -> float:
    """Write a file through `write(fh)` under a name of this process and
    thread, then rename it into place (atomic on one file system), so that
    concurrent writers of one key never leave a torn file.  Returns the
    seconds taken; a write that fails leaves no file (the cache is an
    optimisation: the caller has its tables either way)."""
    t0 = time.perf_counter()
    tmp = path.with_name(f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(tmp, "wb") as fh:
            write(fh)
        os.replace(tmp, path)
    except OSError:
        tmp.unlink(missing_ok=True)
    return time.perf_counter() - t0


_HOST_META = {"profile": str, "has_sd": bool, "channels": int, "fused_has_s2": bool,
              "fused_has_fumble": bool, "nano_nsd": int, "nano_c": int}
_SET_TABLES = ("stage1", "stage2", "pq", "rq", "sq", "fumble", "play", "fused", "nano")
_PROFILE_AXES = ("dist", "ytg", "sec", "sd")


def _write_sets(path: Path, sets: Sequence[TableSet]) -> float:
    """TableSets as one uncompressed .npz: the arrays by name and a JSON
    header of the rest, so that reading them back runs no unpickler."""
    header, arrays = [], {}
    for i, ts in enumerate(sets):
        entry = {"tables": {}, "profiles": {}}
        for name in _SET_TABLES:
            t = getattr(ts, name)
            if t is not None:
                entry["tables"][name] = {"shape": [int(x) for x in t.shape],
                                         **{f: kind(getattr(t, f))
                                            for f, kind in _HOST_META.items()}}
                arrays[f"{i}.{name}.values"] = t.values
                arrays[f"{i}.{name}.row_map"] = np.asarray(t.row_map)
        for name in ("fine", "coarse"):
            prof = getattr(ts, name)
            if prof is not None:
                entry["profiles"][name] = [a for a in _PROFILE_AXES
                                           if getattr(prof, a) is not None]
                for a in entry["profiles"][name]:
                    arrays[f"{i}.{name}.{a}"] = getattr(prof, a)
        header.append(entry)
    arrays["header"] = np.frombuffer(json.dumps(header).encode(), dtype=np.uint8)
    return _publish(path, lambda fh: np.savez(fh, **arrays))


def _read_sets(path: Optional[Path]) -> Optional[List[TableSet]]:
    """The TableSets of a `_write_sets` file, or None where there is none
    or it does not read (a miss: the caller builds and writes it anew)."""
    if path is None or not path.exists():
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            header = json.loads(z["header"].tobytes().decode())
            sets = []
            for i, entry in enumerate(header):
                kw = {name: HostTable(values=z[f"{i}.{name}.values"],
                                      row_map=z[f"{i}.{name}.row_map"],
                                      shape=tuple(meta.pop("shape")), **meta)
                      for name, meta in entry["tables"].items()}
                for name, axes in entry["profiles"].items():
                    kw[name] = TableProfile(**{a: z[f"{i}.{name}.{a}"] for a in axes})
                sets.append(_table_set(**kw))
            return sets
    except (OSError, EOFError, ValueError, KeyError, TypeError, zipfile.BadZipFile):
        return None     # a torn, foreign or older file is a miss


def _events_to_json(first_sd) -> list:
    return [{cache: [[list(key), visit, sd] for key, (visit, sd) in ev.items()]
             for cache, ev in side.items()} for side in first_sd]


def _events_from_json(data) -> list:
    return [{cache: {tuple(key): (int(visit), float(sd)) for key, visit, sd in ev}
             for cache, ev in side.items()} for side in data]


def _warm_events(team_a, team_b, heads, cfg: SimConfig, coach_map=None,
                 cache_dir: Optional[str] = "auto") -> Tuple[list, bool, float]:
    """`cachewarm_events`' recordings, whether they were read from disk,
    and the seconds the call took."""
    t0 = time.perf_counter()
    e = cfg.engine
    key = _table_cache_key(team_a, team_b, heads, cfg, None, None, None)
    # the warm-up depends on every config field and the coach map (the play
    # head's coach feature), not only on what the table key hashes
    path = _cache_path(cache_dir, f"warm_{key}_{_build_sig(heads, repr(cfg), coach_map)}_"
                                  f"{e.cachewarm_seed}_{e.cachewarm_games}", "json")
    if path is not None and path.exists():
        try:
            return (_events_from_json(json.loads(path.read_text())), True,
                    time.perf_counter() - t0)
        except (OSError, ValueError, TypeError, AttributeError):
            pass        # a torn or foreign file is a miss
    m = OracleMatchup(team_a, team_b, heads, cfg, coach_map, record_first_sd=True)
    rng = np.random.default_rng(e.cachewarm_seed)
    for i in range(e.cachewarm_games):
        m.simulate_game(i % 2, rng)
    if path is not None:
        text = json.dumps(_events_to_json(m.first_sd)).encode()
        _publish(path, lambda fh: fh.write(text))
    return m.first_sd, False, time.perf_counter() - t0


def cachewarm_events(team_a, team_b, heads, cfg: SimConfig, coach_map=None,
                     cache_dir: Optional[str] = "auto") -> list:
    """The 'cachewarm' warm-up: cfg.engine.cachewarm_games CPU-oracle games
    (`oracle.OracleMatchup`, first offense alternating, one numpy stream
    from cachewarm_seed) recording each memo cell's first-visit score
    diff.  Returns [side 0's, side 1's] `first_sd` (side i = team i on
    offense).  Kept on disk as JSON (`cache_dir`, default TABLE_CACHE_DIR),
    keyed on the contexts, the heads, the whole config, the coach map, the
    seed and the game count."""
    return _warm_events(team_a, team_b, heads, cfg, coach_map, cache_dir)[0]


# ---------------------------------------------------------------------------
# the build from heads
# ---------------------------------------------------------------------------

NOT_FUSIBLE = ("SlateRunner needs fusible matchups (player-independent model outputs); "
               "use simulate_slate for focus rosters")


def _collapse(t: HostTable, prof: TableProfile, mode: str, warm, head_groups,
              slots_to_s=None) -> HostTable:
    if mode == "cachewarm":
        return cachewarm_collapse(t, prof, warm, head_groups, slots_to_s=slots_to_s)
    return marginalize_sd(t, prof, mode)


def _apply_sd_mode(ts: TableSet, cfg: SimConfig, fused_prof: Optional[TableProfile],
                   warm=None) -> None:
    """In the collapsed sd modes contract the sd axis of stage 1, the
    pass-quantile table and the fused table: 'frozen' and 'marginal' by
    `models.tables.marginalize_sd`, 'cachewarm' at the first-visit score
    diff of each cell (`warm`: one side's recordings of
    `cachewarm_events`; stage 1 through its slot row map, the pass
    quantiles through the pair row map, the fused table by
    `fused_head_groups`).  'axis' keeps them.  The play table keeps its sd
    axis: the reference's play-call cache keys on score diff."""
    mode = cfg.engine.sd_mode
    if mode == "axis":
        return
    if mode == "cachewarm" and warm is None:
        raise ValueError("sd_mode='cachewarm' needs warm-up recordings "
                         "(ops.table_lookup.cachewarm_events)")
    if ts.stage1 is not None and ts.stage1.has_sd:
        rm = np.asarray(ts.stage1.row_map)
        ts.stage1 = _collapse(ts.stage1, ts.fine, mode, warm,
                              [("s1", tuple(range(ts.stage1.channels)))],
                              lambda s1, s2: int(rm[int(s1 or 0)]))
    if ts.pq is not None and ts.pq.has_sd:
        pair_rm = np.asarray(ts.pq.row_map)
        k = int(round(len(pair_rm) ** 0.5))
        ts.pq = _collapse(ts.pq, ts.coarse, mode, warm, [("pq", tuple(range(ts.pq.channels)))],
                          lambda s1, s2: int(pair_rm[int(s1 or 0) * k + int(s2 or 0)]))
    if ts.fused is not None and ts.fused.has_sd and fused_prof is not None:
        ts.fused = _collapse(ts.fused, fused_prof, mode, warm, fused_head_groups(ts.fused))


def table_sets_from_heads(team_a, team_b, heads, cfg: SimConfig, coach_map=None,
                          fine=None, coarse=None, fused=None
                          ) -> Tuple[List[TableSet], List[float], List[float]]:
    """Both directions' host tables (A on offense, B on offense) before the
    sd mode applies (what the disk cache keeps), each direction's host
    seconds, and the play-policy table's share of them.  With a `fused`
    profile and both directions fusing: one fused table each.  Otherwise
    (no `fused`, or a head that splits on a focus roster's players): the
    per-head tables on `fine` and `coarse` (default `fine_profile()` and
    `coarse_profile()`).  Under `use_play_model` with a play head, the
    play-policy table beside either, on the coarse axes."""
    dirs = [build_direction(team_a, team_b, cfg, heads, coach_map),
            build_direction(team_b, team_a, cfg, heads, coach_map)]
    secs = [0.0, 0.0]
    sets = None
    if fused is not None:
        fts = []
        for i, d in enumerate(dirs):
            t0 = time.perf_counter()
            fts.append(build_fused_table(d, heads, cfg, fused))
            secs[i] += time.perf_counter() - t0
            if fts[-1] is None:
                break
        if len(fts) == 2 and all(f is not None for f in fts):
            sets = [_table_set(fine=fine or fine_profile(), coarse=coarse or coarse_profile(),
                               fused=f) for f in fts]
    if sets is None:
        sets = []
        for i, d in enumerate(dirs):
            t0 = time.perf_counter()
            sets.append(build_tables(d, heads, cfg, fine, coarse, play=False))
            secs[i] += time.perf_counter() - t0
    play_secs = [0.0, 0.0]
    if cfg.model.use_play_model and heads.play is not None:
        for i, (ts, d) in enumerate(zip(sets, dirs)):
            t0 = time.perf_counter()
            ts.play = build_play_table(d, heads, cfg, ts.coarse)
            play_secs[i] = time.perf_counter() - t0
            secs[i] += play_secs[i]
    return sets, secs, play_secs


def fused_tables_from_heads(team_a, team_b, heads, cfg: SimConfig, coach_map=None,
                            prof: Optional[TableProfile] = None,
                            cache_dir: Optional[str] = "auto") -> Tuple[HostTable, HostTable]:
    """One matchup's host fused tables on `prof` (default the nano
    profile) in the config's sd mode: the SlateRunner's build, which takes
    no play-policy table and no per-head fallback.  The pair is kept on
    disk before the sd mode applies (`cache_dir`, default
    TABLE_CACHE_DIR, a `fusedpair_*` file), and 'cachewarm' plays or reads
    its warm-up (`cachewarm_events`), as the JAX SlateRunner does.  Raises
    ValueError, in the JAX SlateRunner's words, for a matchup whose heads
    do not fuse (a focus roster whose players a head splits on)."""
    prof = prof or nano_profile()
    key = _table_cache_key(team_a, team_b, heads, cfg, None, None, prof)
    path = _cache_path(cache_dir, f"fusedpair_{key}_"
                                  f"{_build_sig(heads, _table_cfg_text(cfg), coach_map)}", "npz")
    got = _read_sets(path)
    pair = None if got is None else [ts.fused for ts in got]
    if pair is None or len(pair) != 2 or any(f is None for f in pair):
        pair = []
        for off, deff in ((team_a, team_b), (team_b, team_a)):
            ft = build_fused_table(build_direction(off, deff, cfg, heads, coach_map),
                                   heads, cfg, prof)
            if ft is None:
                raise ValueError(NOT_FUSIBLE)
            pair.append(ft)
        if path is not None:
            _write_sets(path, [_table_set(fused=f) for f in pair])
    mode = cfg.engine.sd_mode
    if mode != "axis":
        warm = (cachewarm_events(team_a, team_b, heads, cfg, coach_map, cache_dir)
                if mode == "cachewarm" else [None, None])
        pair = [_collapse(f, prof, mode, w, fused_head_groups(f)) for f, w in zip(pair, warm)]
    return pair[0], pair[1]


def nano_tables_from_heads(team_a, team_b, heads, cfg: SimConfig, coach_map=None,
                           cache_dir: Optional[str] = "auto") -> Tuple[HostTable, HostTable]:
    """One matchup's host nano tables (A on offense, B on offense): the
    fused tables of `fused_tables_from_heads` on the nano profile, re-laid
    out (`models.tables.nano_from_fused`)."""
    prof = nano_profile()
    a, b = fused_tables_from_heads(team_a, team_b, heads, cfg, coach_map, prof, cache_dir)
    return nano_from_fused(a, prof), nano_from_fused(b, prof)


# TableHeads by content (the disk key and build signature, the layout, the
# whole config, the coach map and the device), FIFO and capped by the bytes
# the entries hold: a nano matchup is 14 MB, a focus roster's per-head
# tables 300 MB or more a direction
_TABLE_MEMO: Dict[tuple, TableHeads] = {}
_TABLE_MEMO_MAX_BYTES = 2 << 30


def _memo_bytes() -> int:
    return sum(th.nbytes for th in _TABLE_MEMO.values())


def _remember(key, th: TableHeads) -> None:
    """Keep th, dropping the oldest entries until the memo fits its cap
    (an entry larger than the cap is kept alone)."""
    while _TABLE_MEMO and _memo_bytes() + th.nbytes > _TABLE_MEMO_MAX_BYTES:
        _TABLE_MEMO.pop(next(iter(_TABLE_MEMO)))
    _TABLE_MEMO[key] = th


def build_table_heads(team_a, team_b, heads, cfg: SimConfig, coach_map=None,
                      fine=None, coarse=None, fused=None,
                      nano: Optional[TableProfile] = None,
                      cache_dir: Optional[str] = "auto", device="cuda") -> TableHeads:
    """Both directions' tables for one matchup, built from `heads` on the
    host (`table_sets_from_heads`, then the sd mode) and packed on
    `device`: the JAX
    package's build_table_heads.  `nano` (a profile) re-lays the fused
    tables out in the nano layout; `fused` keeps them fused (not both);
    neither builds the per-head tables on `fine` and `coarse`, as a
    matchup that does not fuse does.

    The host tables are kept on disk before the sd mode applies
    (`cache_dir`, default TABLE_CACHE_DIR; None turns it off), so another
    process reads them instead of building; 'cachewarm' plays or reads its
    warm-up (`cachewarm_events`) and collapses what it built or read.  The
    packed tables are memoized in-process on content and the cache file's
    path, as the JAX package's device memo is; the memo answers before the
    disk is read, so a memo hit returns the first build's TableHeads.  The
    result says whether the tables came from disk (`cache_hit`: then
    `build_seconds` is empty and `cache_seconds` the read's), else each
    direction's build seconds and the write's."""
    if nano is not None and fused is not None:
        raise ValueError("nano and fused presets are mutually exclusive")
    dev = resolve_device(device)
    prof = fused or nano
    key = _table_cache_key(team_a, team_b, heads, cfg, fine, coarse, prof)
    sig = _build_sig(heads, _table_cfg_text(cfg), coach_map)
    path = _cache_path(cache_dir, f"tables_{key}_{sig}", "npz")
    memo_key = (key, sig, "nano" if nano is not None else "fused", repr(cfg),
                tuple(sorted((coach_map or {}).items())), dev, path)
    hit = _TABLE_MEMO.get(memo_key)
    if hit is not None:
        return hit
    warm, info = None, {}
    if cfg.engine.sd_mode == "cachewarm":
        warm, info["warm_hit"], info["warm_seconds"] = _warm_events(
            team_a, team_b, heads, cfg, coach_map, cache_dir)
    t0 = time.perf_counter()
    sets = _read_sets(path)
    secs = play_secs = ()
    if sets is not None:
        info.update(cache_hit=True, cache_seconds=time.perf_counter() - t0)
    else:
        sets, secs, play_secs = table_sets_from_heads(team_a, team_b, heads, cfg, coach_map,
                                                      fine, coarse, prof)
        if path is not None:
            info["cache_seconds"] = _write_sets(path, sets)
    if path is not None and path.exists():
        info["cache_bytes"] = path.stat().st_size
    for i, ts in enumerate(sets):
        t0 = time.perf_counter()
        _apply_sd_mode(ts, cfg, prof, None if warm is None else warm[i])
        if secs:
            secs[i] += time.perf_counter() - t0
    if nano is not None and all(ts.fused is not None for ts in sets):
        for ts in sets:
            ts.nano, ts.fused = nano_from_fused(ts.fused, nano), None
    th = dataclasses.replace(
        pack_tables(*sets, dev, k=team_a.qb.k, fused_prof=fused, nano_prof=nano),
        build_seconds=tuple(secs),
        play_seconds=tuple(play_secs) if secs and sets[0].play is not None else (), **info)
    _remember(memo_key, th)
    return th

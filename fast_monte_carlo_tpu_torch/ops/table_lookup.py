"""Table-mode heads: port of fast_monte_carlo_tpu/ops/table_lookup.py (nano only).

The nano table has rows = dist x ytg x sec per direction and channels
(down, sd, head) — (16384, 105) f32 for one matchup at the nano profile.
Each play bins its state, fetches one row and picks its (down, sd) block of
head channels.  The JAX package picks the block with masked sums (a TPU
gather workaround); here the block is gathered by index, which reads the
same values on finite tables, so the two agree bitwise.

`build_table_heads` builds a matchup's nano tables from trained heads:
both directions' fused grids (`models.tables.build_fused_table`, host
numpy), re-laid out and packed on the device, kept in an in-process memo.
Other table layouts (per-head fine/coarse tables, the fallback to them
when a focus roster keeps a head's player rows apart, the play-policy
table), the JAX package's disk cache and its 'cachewarm' sd mode are not
ported yet and raise.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..config import SimConfig
from ..models import analytic
from ..matchup import build_direction
from ..models.tables import (HostTable, TableProfile, TableSet, build_fused_table,
                             marginalize_sd, nano_from_fused, nano_profile)
from .game import HeadOut, HeadsEvalFn, StepObs
from .pack import MatchupPack, _heads_sig

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
class TableHeads:
    """Every direction's nano table in one tensor: direction d owns rows
    [d * per_dir, (d+1) * per_dir), addressed by dirx = gid*2 + off."""
    nano_values: torch.Tensor   # (D * per_dir, 5 * nano_nsd * nano_c) f32
    nano_prof: ProfileIdx
    per_dir: int
    nano_nsd: int
    nano_c: int
    fused_has_s2: bool = False
    fused_has_fumble: bool = False


def pack_tables(t_a: HostTable, t_b: HostTable, device) -> TableHeads:
    """Single matchup: directions [A-offense, B-offense]."""
    return pack_tables_multi([(t_a, t_b)], device)


def pack_tables_multi(pairs: Sequence[Tuple[HostTable, HostTable]],
                      device) -> TableHeads:
    """Many matchups' nano tables, rows [g0 A-off, g0 B-off, g1 A-off, ...]."""
    dirs = [t for pair in pairs for t in pair]
    t0 = dirs[0]
    for t in dirs:
        if t.profile != "nano" or t.values.shape != t0.values.shape:
            raise ValueError("pack_tables wants nano-layout tables of one "
                             "shape (models.tables.nano_from_fused)")
    values = np.concatenate([t.values for t in dirs], axis=0)
    return nano_table_from_numpy(
        values, np.zeros(len(dirs)), nano_nsd=t0.nano_nsd, nano_c=t0.nano_c,
        fused_has_s2=t0.fused_has_s2, fused_has_fumble=t0.fused_has_fumble,
        device=device)


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
    return TableHeads(
        nano_values=torch.tensor(np.asarray(values, dtype=np.float32),
                                 device=resolve_device(device)),
        nano_prof=prof, per_dir=per_dir, nano_nsd=nano_nsd, nano_c=nano_c,
        fused_has_s2=fused_has_s2, fused_has_fumble=fused_has_fumble)


def _unpack_head_row(th: TableHeads, obs: StepObs, row: torch.Tensor,
                     cfg: SimConfig) -> HeadOut:
    """FUSED_CHANNELS unpack; without stage-2 channels the analytic
    stage-2 fallback applies, as in the JAX package."""
    p_c = row[:, 0]
    c = 7
    if th.fused_has_s2:
        s2_cum = row[:, c:c + 2]
        c += 2
    else:
        inc, itc, sck = analytic.stage2_fallback_probs(
            obs.down.to(F32), obs.dist, cfg)
        inc, itc, sck = analytic.stage2_nudge(inc, itc, sck, cfg)
        s2_cum = torch.stack([inc, inc + sck], dim=1)
    p_f = row[:, c] if th.fused_has_fumble else torch.zeros_like(p_c)
    return HeadOut(p_complete=p_c, s2_cum=s2_cum, pass_ms=row[:, 1:3],
                   rush_ms=row[:, 3:5], sack_ms=row[:, 5:7], p_fumble=p_f,
                   p_pass_ml=None)


def _nano_eval(th: TableHeads, obs: StepObs, cfg: SimConfig) -> HeadOut:
    """Bin the state, then gather the (down, sd) block of the state's row:
    nano_c values per play from the (rows, 5*nsd*c) table."""
    prof = th.nano_prof
    down_i = torch.clamp(obs.down - 1, 0, 4)   # down >= 5 is one class
    di = _seg_bin(obs.dist, prof.dist_segs)
    yi = _seg_bin(obs.ytg, prof.ytg_segs)
    si = _seg_bin(obs.sec.to(F32), prof.sec_segs)
    row = obs.dirx * th.per_dir + (di * prof.ny + yi) * prof.ns + si
    nsd, c = th.nano_nsd, th.nano_c
    blk = down_i * nsd
    if nsd > 1:
        blk = blk + _seg_bin(obs.sd, prof.sd_segs)
    start = row.long() * th.nano_values.shape[1] + (blk * c).long()
    cols = torch.arange(c, dtype=torch.int64, device=start.device)
    sel = th.nano_values.view(-1)[start[:, None] + cols]
    return _unpack_head_row(th, obs, sel, cfg)


def make_table_heads_eval(cfg: SimConfig) -> HeadsEvalFn:
    """Table-mode heads-eval; heads_state is a nano TableHeads."""
    if cfg.model.use_play_model:
        raise NotImplementedError("the ML play-policy table is not ported "
                                  "yet (ROADMAP.md queue 1)")

    def heads_eval(th: TableHeads, obs: StepObs, pack: MatchupPack) -> HeadOut:
        return _nano_eval(th, obs, cfg)

    heads_eval.needs_x = False  # tables key on scalar state fields only
    return heads_eval


# ---------------------------------------------------------------------------
# the build from heads (nano preset)
# ---------------------------------------------------------------------------

def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md queue 1)")


def _apply_sd_mode(ts: TableSet, cfg: SimConfig, fused_prof: TableProfile) -> None:
    """In the collapsed sd modes ('frozen', 'marginal') contract the fused
    table's sd axis (`models.tables.marginalize_sd`); 'axis' keeps it.
    ('cachewarm' raises in `build_table_heads` before any build.)"""
    mode = cfg.engine.sd_mode
    if mode == "axis":
        return
    if ts.fused is not None and ts.fused.has_sd:
        ts.fused = marginalize_sd(ts.fused, fused_prof, mode)


# TableHeads by (teams, heads, cfg, coach_map, device), FIFO-capped; each
# value pins the keyed objects (ids are unique only among live objects)
_TABLE_MEMO: Dict[tuple, tuple] = {}
_TABLE_MEMO_MAX = 16


def nano_tables_from_heads(team_a, team_b, heads, cfg: SimConfig,
                           coach_map=None) -> Tuple[HostTable, HostTable]:
    """One matchup's host nano tables (A on offense, B on offense) built
    from `heads`: each direction's fused grid (`build_fused_table`, host
    numpy) in the config's sd mode, re-laid out on the nano profile.  Raises
    NotImplementedError (ROADMAP.md queue 1) for sd_mode 'cachewarm', the
    ML play-policy table and a direction whose heads do not fuse."""
    prof = nano_profile()
    if cfg.model.use_play_model and heads.play is not None:
        raise _not_ported("the ML play-policy table")
    if cfg.engine.sd_mode == "cachewarm":
        raise _not_ported("sd_mode='cachewarm' (its oracle warm-up games, cachewarm_events)")
    out = []
    for off, deff in ((team_a, team_b), (team_b, team_a)):
        d = build_direction(off, deff, cfg, heads, coach_map)
        ft = build_fused_table(d, heads, cfg, prof)
        if ft is None:
            raise _not_ported(
                f"the per-head fine/coarse tables ({off.name} on offense: a focus "
                "roster keeps a head's player rows from collapsing to one, so the "
                "heads do not fuse into the nano table)")
        ts = TableSet(stage1=None, stage2=None, pq=None, rq=None, sq=None, fumble=None,
                      play=None, fine=None, coarse=None, fused=ft)
        _apply_sd_mode(ts, cfg, prof)
        out.append(nano_from_fused(ts.fused, prof))
    return out[0], out[1]


def build_table_heads(team_a, team_b, heads, cfg: SimConfig, coach_map=None,
                      fine=None, coarse=None, fused=None,
                      nano: Optional[TableProfile] = None,
                      cache_dir: Optional[str] = None, device="cuda") -> TableHeads:
    """Both directions' nano tables for one matchup, built from `heads` on
    the host (`nano_tables_from_heads`) and packed on `device` (the JAX
    package's build_table_heads with its nano preset).  Memoized in-process
    on the identity of the teams and the heads' forests, the config and the
    coach map.

    Raises NotImplementedError (ROADMAP.md queue 1) for the per-head
    profiles (`fine`, `coarse`, `fused`), a nano profile other than
    `nano_profile()`, the disk cache (`cache_dir`), sd_mode 'cachewarm',
    the ML play-policy table (`use_play_model` with a play head) and a
    matchup whose heads do not fuse (a focus roster whose players a head
    splits on: the JAX package falls back to per-head tables there)."""
    prof = nano_profile()
    if fine is not None or coarse is not None or fused is not None:
        raise _not_ported("the per-head fine/coarse and fused table presets")
    if nano is None or not all(np.array_equal(getattr(nano, a), getattr(prof, a))
                               for a in ("dist", "ytg", "sec", "sd")):
        raise _not_ported("a table profile other than nano_profile()")
    if cache_dir is not None:
        raise _not_ported("the table disk cache (cache_dir, _table_cache_key)")
    dev = resolve_device(device)
    key = (id(team_a), id(team_b), _heads_sig(heads), cfg,
           tuple(sorted((coach_map or {}).items())), dev)
    hit = _TABLE_MEMO.get(key)
    if hit is not None:
        return hit[0]
    th = pack_tables(*nano_tables_from_heads(team_a, team_b, heads, cfg, coach_map),
                     device=dev)
    refs = (team_a, team_b, heads, heads.stage1, heads.stage2, heads.pass_quants,
            heads.rush_quants, heads.sack_quants, heads.fumble, heads.play)
    while len(_TABLE_MEMO) >= _TABLE_MEMO_MAX:
        _TABLE_MEMO.pop(next(iter(_TABLE_MEMO)))
    _TABLE_MEMO[key] = (th, refs)
    return th

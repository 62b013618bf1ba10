"""The game engine: port of fast_monte_carlo_tpu/ops/game.py.

One branchless play step advances a batch of games: every outcome path is
computed for every game and combined with masks; finished games
(sec == 0) no-op.  Update order follows the reference exactly (it matters
around the halftime flip):

  phase a (pre-tick):  advance_down / down+1 / sack spot / INT or
                       turnover-on-downs possession flips
  phase b (tick):      clock decrement; halftime possession flip to the 75
  phase c (post-tick): kickoff/FG/punt possession flips

A play consumes a fixed 13 uniforms + 4 normals regardless of its branch;
`play_step` takes them as `draws`, so the tests feed the JAX engine and this
one the same numbers.  `simulate_games` draws them with the Philox kernel
(`ops/rng.py`), one launch per play chunk (`rng_impl="pallas_chunk"`, and
the JAX generator names "threefry" and "rbg", which the port maps onto the
same stream) or per step (`"pallas"`).

With `engine.antithetic` and a batch of B % 4 == 0 games a play draws
B/2 rows, and games 4k+2, 4k+3 replay games 4k, 4k+1's draws mirrored
(u -> 1-u, n -> -n; `mirror_draws`), as the JAX step does.

Heads: `make_analytic_heads_eval` (closed-form stand-ins),
`make_exact_heads_eval` (exact mode: every compiled forest evaluated on
each play's 17-column feature rows, `_state_features`, through the K5
kernel where the eager loop plays on the card) and the table heads of
`ops/table_lookup.py`.  On the card K1 plays all three in its launch.

`Situation` and `state_from_situation` resume games from a mid-game state
(live win probability, the 4th-down evaluator); `simulate_games` takes one
(`situation=`) or a whole resumed state (`init_state=`).

With `collect_stats` each play adds one row of the 19 team stats
(`stats.TEAM_STAT_FIELDS`) to the offense's side; with `collect_players` it
adds one 6-column row per role to the sampled slot's cell, where the slot
is tracked.  Each is one indexed add on a flat view, in place: the JAX
package's dense one-hot add (its `ops/game.py:649-653`) gives the same bits,
since every other cell adds +-0, but reads and writes the whole
(B, 2, 3, K, 6) carry every play.  A disabled collector carries the JAX
package's 1-element dummy.  On the card K1 (`nano_game`) accrues both in
its launch for table-mode launches, adding in play order onto the
incoming values as the eager step does.

Game state keeps the JAX package's int32/f32/bool dtypes; indices are cast
to int64 only where they index.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import SimConfig
from ..models import analytic
from ..models.heads import ST1_FEATURES
from ..stats import (N_PLAYER_STATS, N_TEAM_STATS, ROLE_PASS, ROLE_REC, ROLE_RUSH,
                     TEAM_STAT_FIELDS, TS)
from .forest_eval import (IS_CAT_BIT, MAX_CLASSES, MAX_GROUPS, SLOT_MASK, TILE_RECORDS,
                          eval_margin, eval_margin_packed, forest_link, predict, softmax_f32)
from .pack import HeadsPack, MatchupPack
from .rng import N_NORMALS, N_UNIFORMS, chunk_draws, step_draws

F32 = torch.float32
I32 = torch.int32

# uniform draw slots (shared across exclusive branches)
U_GO, U_FG, U_TB, U_CALL, U_QB, U_WR, U_RB, U_COMPLETE, U_EXP, U_BOOST, \
    U_RZ, U_S2, U_FUM = range(N_UNIFORMS)
# normal draw slots
N_PUNT_GROSS, N_PUNT_RET, N_YARDS, N_INT_RET = range(N_NORMALS)
# the names engine.rng_impl takes; all draw the one Philox stream
RNG_IMPLS = ("threefry", "rbg", "pallas", "pallas_chunk")


class GameState(NamedTuple):
    gid: torch.Tensor      # (B,) i32 game (matchup) id — constant per trial
    fo: torch.Tensor       # (B,) i32 first offense side — constant per trial
    off: torch.Tensor      # (B,) i32 offense side 0/1
    sec: torch.Tensor      # (B,) i32
    down: torch.Tensor     # (B,) i32
    dist: torch.Tensor     # (B,) f32
    ytg: torch.Tensor      # (B,) f32
    period: torch.Tensor   # (B,) i32
    in_rz: torch.Tensor    # (B,) bool
    going: torch.Tensor    # (B,) bool
    score: torch.Tensor    # (B,2) i32
    stats: torch.Tensor    # (B,2,N_TEAM_STATS) f32; (B,1,1) when not collected
    pstats: torch.Tensor   # (B,2,3,K,6) f32; (B,1,1,1,1) when not collected


class StepObs(NamedTuple):
    """What a heads-eval implementation sees: play-start state + sampled
    slots.  `x`, the 17-column ST1 feature rows, is built only for a heads
    eval that declares `needs_x = True` (exact mode's forests); table and
    analytic heads read the scalar state fields."""
    sd: torch.Tensor       # (B,) f32 score_diff from the offense's view
    dirx: torch.Tensor     # (B,) i32 direction row = gid*2 + off
    off: torch.Tensor      # (B,) i32
    down: torch.Tensor
    dist: torch.Tensor
    ytg: torch.Tensor
    sec: torch.Tensor
    qb: torch.Tensor       # (B,) i32 slot
    wr: torch.Tensor
    rb: torch.Tensor
    x: Optional[torch.Tensor] = None  # (B, 17) ST1 feature rows, or None


class HeadOut(NamedTuple):
    """Final (fully post-processed) model quantities for one play step."""
    p_complete: torch.Tensor       # (B,) biased + clipped completion prob
    s2_cum: torch.Tensor           # (B,2) post-nudge (P(inc), P(inc)+P(sack))
    pass_ms: torch.Tensor          # (B,2) (mu, sigma) pass yards
    rush_ms: torch.Tensor          # (B,2)
    sack_ms: torch.Tensor          # (B,2)
    p_fumble: torch.Tensor         # (B,)
    p_pass_ml: Optional[torch.Tensor]  # (B,) or None if no ML policy


# heads_fn(heads_state, obs, pack) -> HeadOut
HeadsEvalFn = Callable[[object, StepObs, MatchupPack], HeadOut]


def take_dir(t: torch.Tensor, dirx: torch.Tensor) -> torch.Tensor:
    """Per-direction constant fetch: row dirx of a (2G, ...) pack field."""
    return t[dirx.long()]


def _taper(y, t1: float, t2: float, r1: float, r2: float):
    """mc-variant piecewise-linear long-gain taper: unchanged to t1, slope
    r1 to t2, slope r2 beyond."""
    mid = t1 + (y - t1) * r1
    hi = t1 + (t2 - t1) * r1 + (y - t2) * r2
    return torch.where(y <= t1, y, torch.where(y <= t2, mid, hi))


def _sample_slot(cum2k: torch.Tensor, dirx: torch.Tensor, u: torch.Tensor):
    """Inverse-CDF slot sampling against (2,K) cumulative shares."""
    k = cum2k.shape[1]
    if k == 1:  # single slot: no draw needed
        return torch.zeros_like(dirx)
    slot = (u[:, None] >= take_dir(cum2k, dirx)).sum(dim=1)
    return torch.clamp_max(slot, k - 1).to(I32)


def _clip(x, lo: float, hi: torch.Tensor):
    """jnp.clip(x, lo, hi) with a tensor upper bound: minimum(maximum(x,
    lo), hi), so hi wins where lo > hi."""
    return torch.minimum(torch.clamp_min(x, lo), hi)


def add_player_rows(pstats: torch.Tensor, off: torch.Tensor, slot: torch.Tensor,
                    gate: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """pstats[b, off[b], r, slot[b, r], :] += delta[b, r] * gate[b, r] for
    the three roles r, in place, by one index_add_ on a flat view of the
    contiguous (B, 2, 3, K, 6) pstats.  slot, gate: (B, 3); delta (B, 3, 6)."""
    b, k = off.shape[0], pstats.shape[3]
    side_row = torch.arange(b, device=off.device) * 2 + off
    cell = (side_row[:, None] * 3 + torch.arange(3, device=off.device)) * k + slot.long()
    pstats.view(-1, N_PLAYER_STATS).index_add_(
        0, cell.reshape(-1), (delta * gate[:, :, None]).reshape(-1, N_PLAYER_STATS))
    return pstats


def mirror_draws(u: torch.Tensor, n: torch.Tensor):
    """Antithetic draws: (..., B/2, C) rows -> (..., B, C), rows 4k, 4k+1 as
    drawn and rows 4k+2, 4k+3 the same two mirrored (u -> 1-u, n -> -n), by
    the JAX step's reshape (B/4, 2, C) and concatenate."""
    def one(a, flip):
        f = a.reshape(*a.shape[:-2], a.shape[-2] // 2, 2, a.shape[-1])
        return torch.cat([f, flip(f)], dim=-2).reshape(
            *a.shape[:-2], 2 * a.shape[-2], a.shape[-1])

    return one(u, lambda f: 1.0 - f), one(n, torch.neg)


def analytic_channels(bias: torch.Tensor, dist: torch.Tensor, lo: float, hi: float):
    """The closed-form heads of a play at distance `dist` in a direction of
    stage-1 bias `bias`: (p_complete clipped to [lo, hi], pass, rush and
    sack (mu, sigma) (B, 2) each, p_fumble); stage 2 is the analytic
    fallback.  `make_analytic_heads_eval` and K1's plain version both take
    them."""
    p_c = torch.clamp(0.68 - 0.022 * torch.clamp_min(dist - 3.0, 0.0) + bias, lo, hi)

    def ms(mu, sigma):
        return torch.stack([mu if torch.is_tensor(mu) else torch.full_like(dist, mu),
                            torch.full_like(dist, sigma)], dim=1)

    return (p_c, ms(4.5 + 0.45 * dist, 7.0), ms(4.2, 4.0), ms(-6.0, 2.2),
            torch.full_like(dist, 0.012))


def make_analytic_heads_eval(cfg: SimConfig) -> HeadsEvalFn:
    """Artifact-free heads: smooth closed-form stand-ins for every model
    head (clearly NOT the reference models).  heads_state is unused.  On
    the card K1 plays these heads (`analytic_heads`)."""

    def heads_eval(heads_state, obs: StepObs, pack: MatchupPack) -> HeadOut:
        p_c, pass_ms, rush_ms, sack_ms, p_f = analytic_channels(
            take_dir(pack.bias, obs.dirx), obs.dist, cfg.model.stage1_clip_lo,
            cfg.model.stage1_clip_hi)
        inc, itc, sck = analytic.stage2_fallback_probs(
            obs.down.to(F32), obs.dist, cfg)
        inc, itc, sck = analytic.stage2_nudge(inc, itc, sck, cfg)
        s2_cum = torch.stack([inc, inc + sck], dim=1)
        return HeadOut(p_c, s2_cum, pass_ms, rush_ms, sack_ms, p_f, None)

    heads_eval.needs_x = False
    heads_eval.analytic_heads = True
    return heads_eval


def _gather2k(arr2k: torch.Tensor, dirx: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """A (2G, K) per-direction, per-slot field at (dirx, slot) per trial."""
    k = arr2k.shape[1]
    return arr2k.reshape(-1)[(dirx.long() * k + slot.long()).clamp(0, arr2k.numel() - 1)]


def _head_ids(head: str, pack: MatchupPack, dirx: torch.Tensor, slots) -> dict:
    """The ids `head`'s forest reads, by group (`_EXACT_GROUPS`): each
    group's id table on the pack at the slot its role sampled (`slots`, in
    pstats' role order), the coach's by direction alone."""
    out = {}
    for name, (table, role) in _EXACT_GROUPS[head].items():
        arr = getattr(pack, table)
        out[name] = take_dir(arr, dirx) if arr.dim() == 1 else _gather2k(arr, dirx, slots[role])
    return out


def make_exact_heads_eval(cfg: SimConfig) -> HeadsEvalFn:
    """Exact mode: every compiled forest evaluated on each play's feature
    rows (`eval_margin`: the K5 kernel on the card, a launch a forest, where
    the eager loop plays; K1 walks them inside its launch, `exact_heads`).
    heads_state is a HeadsPack; each forest is walked on its own (the JAX
    package's default; its merged walk, `exact_merged`, is not ported)."""

    def heads_eval(hp: HeadsPack, obs: StepObs, pack: MatchupPack) -> HeadOut:
        x, off = obs.x, obs.dirx

        def ids(head):
            return _head_ids(head, pack, off, (obs.qb, obs.rb, obs.wr))

        p_raw = predict(hp.stage1, x, ids("stage1"))
        p_c = torch.clamp(p_raw + take_dir(pack.bias, off),
                          cfg.model.stage1_clip_lo, cfg.model.stage1_clip_hi)
        if hp.stage2 is not None:
            probs = predict(hp.stage2, x, ids("stage2"))
            o = hp.stage2_order
            inc, itc, sck = probs[:, o[0]], probs[:, o[1]], probs[:, o[2]]
        else:
            inc, itc, sck = analytic.stage2_fallback_probs(obs.down.to(F32), obs.dist, cfg)
        inc, itc, sck = analytic.stage2_nudge(inc, itc, sck, cfg)
        s2_cum = torch.stack([inc, inc + sck], dim=1)

        def ms(trio, cat, floor):
            q = torch.stack([predict(f, x, cat) for f in trio], dim=1)
            sigma = torch.clamp_min((q[:, 2] - q[:, 0])
                                    * analytic.recip(cfg.model.sigma_denom), floor)
            return torch.stack([q[:, 1], sigma], dim=1)

        pass_ms = ms(hp.pq, ids("pq"), cfg.model.pass_sigma_floor)
        rush_ms = ms(hp.rq, ids("rq"), cfg.model.rush_sigma_floor)
        sack_ms = ms(hp.sq, ids("sq"), cfg.model.sack_sigma_floor)
        if hp.fumble is not None and cfg.model.enable_fumbles:
            p_f = predict(hp.fumble, x, ids("fumble"))
        else:
            p_f = torch.zeros_like(p_c)
        p_pass_ml = None
        if hp.play is not None and cfg.model.use_play_model:
            p_pass_ml = _play_pass_prob(hp, x, ids("play")["head_coach"], cfg)
        return HeadOut(p_c, s2_cum, pass_ms, rush_ms, sack_ms, p_f, p_pass_ml)

    heads_eval.needs_x = True  # full ST1 feature rows feed the forests
    heads_eval.exact_heads = True
    return heads_eval


def play_link(m: torch.Tensor, scale: float, pass_idx: int, run_idx: int, lo: float,
              hi: float) -> torch.Tensor:
    """The play head's P(pass) of its margins (B, C): the softmax
    (`softmax_f32`) at the play temperature, the margins times its f32
    reciprocal `scale` (as XLA folds the division by it), reduced to P(pass)
    / (P(pass) + P(run)) where the head has a run class, clipped."""
    p = softmax_f32(m * scale)
    p_pass = p[:, pass_idx]
    if run_idx >= 0:
        p_pass = p_pass / torch.clamp_min(p_pass + p[:, run_idx], 1e-9)
    return torch.clamp(p_pass, lo, hi)


def _play_pass_prob(hp: HeadsPack, x: torch.Tensor, coach: torch.Tensor, cfg: SimConfig):
    """P(pass) of the ML play head: its numerics picked from the ST1 rows,
    then `play_link`."""
    tf = hp.play
    cols = [ST1_FEATURES.index(n) for n in tf.numeric_names]
    m = eval_margin(tf, x[:, cols].contiguous(), {"head_coach": coach})
    return play_link(m, analytic.recip(max(1e-6, hp.play_temperature)), hp.play_pass_idx,
                     hp.play_run_idx, cfg.model.play_clip_lo, cfg.model.play_clip_hi)


def _state_features(pack: MatchupPack, cfg: SimConfig, dirx, down, dist, ytg, sec, sd):
    """(B, 17) f32 ST1 feature rows of the play-start state, the JAX
    package's column for column."""
    return st1_rows(take_dir(pack.sp, dirx), cfg.timeouts, cfg.clock.half_seconds, down, dist,
                    ytg, sec, sd)


def st1_rows(sp: torch.Tensor, timeouts: float, half_s: int, down, dist, ytg, sec, sd):
    """`_state_features` of the plays' SP+ rows `sp` (B, 4): what K1's
    plain version stages from its packed inputs too."""
    sec_f = sec.to(F32)
    cols = [
        down.to(F32), dist, ytg,
        (ytg <= 20).to(F32),
        sd.to(F32), sec_f,
        torch.full_like(sec_f, timeouts), torch.full_like(sec_f, timeouts),
        sp[:, 0], sp[:, 1], sp[:, 2], sp[:, 3],
        (dist >= ytg - 0.5).to(F32),
        ((down == 4) & (dist <= 2.0)).to(F32),
        (ytg <= 33).to(F32),
        torch.where(sec > half_s, 1.0, 2.0).to(F32),
        ((sec % half_s) <= 120).to(F32),
    ]
    return torch.stack(cols, dim=1)


def play_step(
    s: GameState,
    draws: Tuple[torch.Tensor, torch.Tensor],
    pack: MatchupPack,
    cfg: SimConfig,
    heads_eval: HeadsEvalFn,
    heads_state,
    collect_players: bool = False,
    collect_stats: bool = False,
) -> GameState:
    """One play for every game; `draws` = (u (B,13), n (B,4)) f32.  With
    cfg.engine.antithetic and B % 4 == 0 the step takes B/2 rows and
    mirrors them (`mirror_draws`), as the JAX step does; other row counts
    raise.  With a collector on, `s.stats` / `s.pstats` are updated in
    place and returned in the new state."""
    u, n = draws
    b = s.off.shape[0]
    if cfg.engine.antithetic and b % 4 == 0:
        if u.shape[0] != b // 2 or n.shape[0] != b // 2:
            raise ValueError(f"antithetic draws for {b} games take {b // 2} rows, "
                             f"got {u.shape[0]} and {n.shape[0]}")
        u, n = mirror_draws(u, n)
    active = s.sec > 0
    off, down0, dist0, ytg0, sec0 = s.off, s.down, s.dist, s.ytg, s.sec
    dirx = s.gid * 2 + off   # row into the (2G, ...) direction-indexed pack
    sd = (s.score[:, 0] - s.score[:, 1]) * (1 - 2 * off)

    off_o = take_dir(pack.off_offense, dirx)
    def_d = take_dir(pack.def_defense, dirx)
    ymult = take_dir(pack.ymult, dirx)
    mz = take_dir(pack.mz, dirx)

    # ---- 4th-down decision --------------------------------------------------
    p_go = torch.clamp_max(analytic.go_for_it_prob(
        ytg0, dist0, sd, sec0, cfg) * cfg.fourth.go_multiplier, 1.0)
    is4 = down0 == 4
    force = cfg.fourth.force
    if force is None:
        go = active & is4 & (u[:, U_GO] < p_go)
        st_play = active & is4 & ~go
        fg_att = st_play & (ytg0 <= cfg.st.fg_attempt_max_ytg)
        punt = st_play & ~fg_att
    else:
        # decision override (FourthDownConfig.force); draw use is unchanged
        no = torch.zeros_like(is4)
        if force == "go":
            go, st_play, fg_att, punt = active & is4, no, no, no
        elif force == "fg":
            go, st_play = no, active & is4
            fg_att, punt = st_play, no
        elif force == "punt":
            go, st_play = no, active & is4
            fg_att, punt = no, st_play
        else:
            raise ValueError(
                f"fourth.force must be None|'go'|'fg'|'punt', got {force!r}")
    scrim = active & ~st_play

    # FG
    p_fg = analytic.field_goal_prob(ytg0 + cfg.st.fg_snap_plus_endzone, cfg)
    fg_good = fg_att & (u[:, U_FG] < p_fg)
    fg_miss = fg_att & ~fg_good

    # punt
    st = cfg.st
    gross = torch.clamp_min(st.punt_gross_mean + st.punt_gross_sd * n[:, N_PUNT_GROSS],
                            st.punt_gross_min)
    pret = torch.clamp_min(st.punt_return_mean + st.punt_return_sd * n[:, N_PUNT_RET], 0.0)
    net = gross - pret
    tb_p = torch.clamp((st.punt_touchback_gate_ytg - ytg0) * analytic.recip(60.0),
                       st.punt_tb_lo, st.punt_tb_hi)
    tb = (ytg0 <= st.punt_touchback_gate_ytg) & (u[:, U_TB] < tb_p)
    net = torch.where(tb, ytg0 - st.punt_tb_own_spot, net)
    net = torch.trunc(_clip(net, st.punt_net_min, ytg0 - 1.0))  # int() per :896
    punt_spot = torch.clamp(100.0 - (ytg0 - net), 1.0, 99.0)

    # ---- scrimmage play -----------------------------------------------------
    trip1 = scrim & ~s.in_rz & (ytg0 <= 20)

    qb = _sample_slot(pack.qb_cum, dirx, u[:, U_QB])
    wr = _sample_slot(pack.wr_cum, dirx, u[:, U_WR])
    rb = _sample_slot(pack.rb_cum, dirx, u[:, U_RB])
    x = (_state_features(pack, cfg, dirx, down0, dist0, ytg0, sec0, sd)
         if getattr(heads_eval, "needs_x", True) else None)
    obs = StepObs(sd=sd.to(F32), dirx=dirx, off=off, down=down0, dist=dist0,
                  ytg=ytg0, sec=sec0, qb=qb, wr=wr, rb=rb, x=x)
    ho = heads_eval(heads_state, obs, pack)

    if cfg.model.use_play_model and ho.p_pass_ml is not None:
        p_pass = ho.p_pass_ml
    else:
        p_pass = analytic.pass_prob_v1(down0, dist0, ytg0, sec0, sd, cfg)
    is_pass = scrim & (u[:, U_CALL] < p_pass)
    is_run = scrim & ~is_pass

    complete = is_pass & (u[:, U_COMPLETE] < ho.p_complete)
    notc = is_pass & ~complete

    u2 = u[:, U_S2]
    o_inc = notc & (u2 < ho.s2_cum[:, 0])
    o_sck = notc & ~o_inc & (u2 < ho.s2_cum[:, 1])
    o_int = notc & ~o_inc & ~o_sck

    mc, md = cfg.matchup, cfg.model
    # pass yards (quirk: clip to ytg BEFORE the SP+ multiplier, :1091)
    pass_mu, pass_sg = ho.pass_ms[:, 0], ho.pass_ms[:, 1]
    if md.rz_pass_damping:
        # mc-variant goal-line damping: scale the quantiles, re-floor sigma
        rz_scale = torch.where(ytg0 < 15.0, 0.8 + 0.2 * (ytg0 * analytic.recip(15.0)), 1.0)
        pass_mu = pass_mu * rz_scale
        pass_sg = torch.clamp_min(pass_sg * rz_scale, md.pass_sigma_floor)
    py_raw = pass_mu + pass_sg * n[:, N_YARDS]
    if md.taper_enabled:
        py_raw = _taper(py_raw, *md.pass_taper)
    py = _clip(py_raw, md.pass_clip_lo, ytg0)
    yards_p = py * ymult
    ep = analytic.explosive_prob(ytg0, off_o, def_d, cfg)
    exp_gate_p = (ytg0 > mc.explosive_gate_ytg) & \
        (u[:, U_EXP] < mc.explosive_pass_scale * ep)
    boost_p = mc.explosive_pass_boost_lo + u[:, U_BOOST] * (
        mc.explosive_pass_boost_hi - mc.explosive_pass_boost_lo)
    yards_p = torch.where(
        exp_gate_p,
        torch.minimum(yards_p * (1.0 + boost_p * (1.0 + mc.explosive_pass_z_k * mz)), ytg0),
        yards_p)
    rz_p = (ytg0 <= mc.rz_pass_gate_ytg) & (down0 <= 3) & (
        u[:, U_RZ] < analytic.rz_finish_prob_pass(ytg0, down0, off_o, def_d, cfg))
    yards_p = torch.where(rz_p, ytg0, yards_p)
    pass_td = complete & (yards_p + 1e-9 >= ytg0)
    pass_gain = complete & ~pass_td

    # sack loss
    sy = torch.clamp(ho.sack_ms[:, 0] + ho.sack_ms[:, 1] * n[:, N_YARDS],
                     md.sack_clip_lo, md.sack_clip_hi)
    loss = torch.minimum(torch.clamp_min(-sy, 0.0), ytg0)  # quirk: cap = ytg (:1178)

    # INT return
    ret = _clip(md.int_return_mean + md.int_return_sd * n[:, N_INT_RET], 0.0, ytg0)
    int_spot = 100.0 - (ytg0 - ret)

    # rush yards (same structure)
    ry_raw = ho.rush_ms[:, 0] + ho.rush_ms[:, 1] * n[:, N_YARDS]
    if md.taper_enabled:
        ry_raw = _taper(ry_raw, *md.rush_taper)
    ry = _clip(ry_raw, md.rush_clip_lo, ytg0)
    yards_r = ry * ymult
    exp_gate_r = (ytg0 > mc.explosive_gate_ytg) & \
        (u[:, U_EXP] < mc.explosive_run_scale * ep)
    boost_r = mc.explosive_run_boost_lo + u[:, U_BOOST] * (
        mc.explosive_run_boost_hi - mc.explosive_run_boost_lo)
    yards_r = torch.where(
        exp_gate_r,
        torch.minimum(yards_r * (1.0 + boost_r * (1.0 + mc.explosive_run_z_k * mz)), ytg0),
        yards_r)
    rz_r = (ytg0 <= mc.rz_run_gate_ytg) & (down0 <= 3) & (
        u[:, U_RZ] < analytic.rz_finish_prob_run(ytg0, down0, off_o, def_d, cfg))
    yards_r = torch.where(rz_r, ytg0, yards_r)

    if md.enable_fumbles:
        fum = is_run & (u[:, U_FUM] < ho.p_fumble)
    else:
        fum = torch.zeros_like(is_run)
    run_active = is_run & ~fum
    run_td = run_active & (yards_r + 1e-9 >= ytg0)
    run_gain = run_active & ~run_td
    fum_spot_ytg = torch.clamp_min(ytg0 - _clip(yards_r, md.rush_clip_lo, ytg0), 0.0)

    # ---- phase a: pre-tick state updates ------------------------------------
    adv = pass_gain | run_gain
    gained = torch.where(pass_gain, yards_p, 0.0) + torch.where(run_gain, yards_r, 0.0)
    ytg_a = torch.where(adv, torch.clamp_min(ytg0 - gained, 0.0), ytg0)
    first = adv & (gained + 1e-6 >= dist0)
    down_a = torch.where(adv, torch.where(first, 1, down0 + 1), down0)
    dist_a = torch.where(adv, torch.where(first, 10.0, dist0 - gained), dist0)
    downs_to = adv & ~first & (down_a > 4)

    ytg_a = torch.where(o_sck, ytg0 + loss, ytg_a)
    dist_a = torch.where(o_sck, dist0 + loss, dist_a)
    down_a = torch.where(o_sck, down0 + 1, down_a)
    down_a = torch.where(o_inc, down0 + 1, down_a)

    flip_a = downs_to | o_int | fum
    spot_a = torch.where(o_int, int_spot,
                         torch.where(fum, 100.0 - fum_spot_ytg, 100.0 - ytg_a))
    off_a = torch.where(flip_a, 1 - off, off)
    ytg_a = torch.where(flip_a, spot_a, ytg_a)
    down_a = torch.where(flip_a, 1, down_a)
    dist_a = torch.where(flip_a, 10.0, dist_a)
    in_rz_a = ~flip_a & (s.in_rz | trip1)

    # ---- phase b: tick (+ halftime flip) ------------------------------------
    c = cfg.clock
    t = (fg_att * c.field_goal + punt * c.punt + pass_td * c.td_pass
         + pass_gain * c.pass_complete + o_inc * c.pass_incomplete
         + o_sck * c.sack + o_int * c.interception
         + (run_td | run_gain | fum) * c.run).to(I32)
    sec_b = torch.clamp_min(sec0 - t, 0)
    period_b = torch.where(
        sec_b > 0,
        4 - torch.div(sec_b - 1, c.quarter_seconds, rounding_mode="floor"),
        4).to(I32)
    halftime = active & (period_b != s.period) & (period_b == 3)
    off_b = torch.where(halftime, 1 - off_a, off_a)
    ytg_b = torch.where(halftime, cfg.kickoff_spot, ytg_a)
    down_b = torch.where(halftime, 1, down_a)
    dist_b = torch.where(halftime, 10.0, dist_a)
    in_rz_b = ~halftime & in_rz_a

    # ---- phase c: post-tick possession flips --------------------------------
    flip_c = fg_good | fg_miss | punt | pass_td | run_td
    spot_c = torch.where(fg_miss, 100.0 - ytg0,
                         torch.where(punt, punt_spot, cfg.kickoff_spot))
    off_c = torch.where(flip_c, 1 - off_b, off_b)
    ytg_c = torch.where(flip_c, spot_c, ytg_b)
    down_c = torch.where(flip_c, 1, down_b)
    dist_c = torch.where(flip_c, 10.0, dist_b)
    in_rz_c = ~flip_c & in_rz_b

    # run-branch red-zone recheck (quirk: old offense credited, :1253-1255)
    trip2 = run_gain & ~in_rz_c & (ytg_c <= 20)
    in_rz_f = in_rz_c | trip2

    going_f = ~active & s.going

    # ---- scores --------------------------------------------------------------
    td = pass_td | run_td
    pts = td * cfg.model.td_points + fg_good * cfg.model.fg_points
    side = torch.stack([off == 0, off == 1], dim=1)
    score_f = s.score + (side * pts[:, None]).to(I32)

    if collect_stats or collect_players:
        pass_yds = torch.where(pass_td, ytg0, torch.where(pass_gain, yards_p, 0.0))
        rush_yds = torch.where(run_td, ytg0, torch.where(run_gain, yards_r, 0.0))
        pass_att = complete | o_inc | o_int
    if collect_stats:
        # going_for_it is only ever true on the go play itself (was_going = go)
        conv = go & (td | (pass_gain & (yards_p + 1e-6 >= dist0))
                     | (run_gain & (yards_r + 1e-6 >= dist0)))
        cols = {
            "plays": scrim, "pass_att": pass_att, "comp": complete,
            "pass_yds": pass_yds, "pass_td": pass_td, "INT": o_int, "sacks": o_sck,
            "rush_att": is_run, "rush_yds": rush_yds, "rush_td": run_td,
            "FG": fg_good, "FGA": fg_att, "punts": punt,
            "rz_trips": trip1.to(F32) + trip2.to(F32),
            "rz_TD": run_td & (ytg0 <= 20),   # quirk: rushing TDs only
            "fourth_go": go, "fourth_conv": conv,
            "points": torch.zeros_like(dist0),  # final score written after the loop
            "fumbles_lost": fum,
        }
        delta = torch.stack([cols[f].to(F32) for f in TEAM_STAT_FIELDS], dim=1)
        side_row = torch.arange(off.shape[0], device=off.device) * 2 + off
        s.stats.view(-1, N_TEAM_STATS).index_add_(0, side_row, delta)
    if collect_players:
        no = torch.zeros_like(dist0)
        by_role = {   # columns: att comp yds td INT sacks (stats.PC_*)
            ROLE_PASS: (qb, pack.qb_tracked,
                        (pass_att, complete, pass_yds, pass_td, o_int, o_sck)),
            ROLE_RUSH: (rb, pack.rb_tracked, (is_run, no, rush_yds, run_td, no, no)),
            ROLE_REC: (wr, pack.wr_tracked, (is_pass, complete, pass_yds, pass_td, no, no)),
        }
        roles = (ROLE_PASS, ROLE_RUSH, ROLE_REC)   # = 0, 1, 2: pstats' role axis
        delta = torch.stack([c.to(F32) for r in roles for c in by_role[r][2]], dim=1)
        slot = torch.stack([by_role[r][0] for r in roles], dim=1)
        gate = torch.stack([by_role[r][1].reshape(-1)[dirx.long() * pack.k + by_role[r][0]]
                            for r in roles], dim=1).to(F32)
        add_player_rows(s.pstats, off, slot, gate, delta.view(-1, 3, N_PLAYER_STATS))

    return GameState(
        gid=s.gid, fo=s.fo,
        off=off_c.to(I32), sec=sec_b.to(I32), down=down_c.to(I32),
        dist=dist_c.to(F32), ytg=ytg_c.to(F32), period=period_b,
        in_rz=in_rz_f, going=going_f, score=score_f, stats=s.stats, pstats=s.pstats,
    )


class Situation(NamedTuple):
    """A mid-game state to resume games from (live win probability).

    Each field is a Python number or a tensor: 0-d, or (n,) with one
    situation per trial (the live curve resumes S situations in one
    batch).  Derived state (`period`, `in_rz`, `going`) is rebuilt by
    `state_from_situation` with the state machine's own formulas."""
    offense: object      # side with the ball: 0 = team A, 1 = team B
    sec: object          # seconds left in the game (1..game_seconds)
    down: object         # 1..4
    dist: object         # yards to the first-down marker
    ytg: object          # yards to the opponent's goal line (1..99)
    score_a: object      # points, team A
    score_b: object      # points, team B


def state_from_situation(n: int, sit: Situation, cfg: SimConfig, device, game_id=0,
                         k: Optional[int] = None, collect_players: bool = True,
                         collect_stats: bool = True) -> GameState:
    """n games resuming from `sit`, as the JAX package builds them:
    period = 4 - (sec-1) // quarter_seconds (4 at sec 0, so the first tick
    fires no spurious halftime flip), in_rz = ytg <= 20 (a drive inside the
    20 has had its trip counted), going = False, and fo = offense.  Stats
    and player stats start at zero in the collectors' shapes, as in
    `initial_state`; the kickoff situation gives `initial_state` field for
    field."""
    dev = torch.device(device)
    k = cfg.engine.player_slots if k is None else k
    stats_shape = (n, 2, N_TEAM_STATS) if collect_stats else (n, 1, 1)
    pstats_shape = (n, 2, 3, k, N_PLAYER_STATS) if collect_players else (n, 1, 1, 1, 1)

    def vec(v, dtype):
        return torch.as_tensor(v, dtype=dtype, device=dev).expand(n).clone()

    fo = vec(sit.offense, I32)
    sec = vec(sit.sec, I32)
    ytg = vec(sit.ytg, F32)
    period = torch.where(
        sec > 0, 4 - torch.div(sec - 1, cfg.clock.quarter_seconds, rounding_mode="floor"),
        4).to(I32)
    return GameState(
        gid=vec(game_id, I32), fo=fo, off=fo.clone(), sec=sec,
        down=vec(sit.down, I32), dist=vec(sit.dist, F32), ytg=ytg, period=period,
        in_rz=ytg <= 20.0,
        going=torch.zeros((n,), dtype=torch.bool, device=dev),
        score=torch.stack([vec(sit.score_a, I32), vec(sit.score_b, I32)], dim=1),
        stats=torch.zeros(stats_shape, dtype=F32, device=dev),
        pstats=torch.zeros(pstats_shape, dtype=F32, device=dev),
    )


def initial_state(n: int, first_offense, cfg: SimConfig, device, game_id=0,
                  k: Optional[int] = None, collect_players: bool = True,
                  collect_stats: bool = True) -> GameState:
    """n games at the opening kickoff: the kickoff situation, with
    `first_offense` (an int or an (n,) tensor) on offense.  `k` player
    slots (default cfg.engine.player_slots); a disabled collector gets a
    1-element dummy per game, as in the JAX package (the full pstats is
    about 1.15 KB a game at K = 8)."""
    kickoff = Situation(first_offense, cfg.clock.game_seconds, 1, cfg.opening_distance,
                        cfg.kickoff_spot, 0, 0)
    return state_from_situation(n, kickoff, cfg, device, game_id, k, collect_players,
                                collect_stats)


def _launch_state(pack: MatchupPack, cfg: SimConfig, n: int, first_offense,
                  collect_players: bool, game_id, collect_stats: bool,
                  situation: Optional[Situation], init_state: Optional[GameState],
                  row0: int, antithetic: Optional[bool], first_play_force: Optional[str] = None,
                  first_play_key: Optional[int] = None) -> Tuple[GameState, SimConfig, bool]:
    """A launch's starting state, its config (engine.antithetic set to the
    launch's choice) and that choice, after `simulate_games`' checks."""
    rng = cfg.engine.rng_impl
    if rng not in RNG_IMPLS:
        raise ValueError(f"rng_impl must be one of {RNG_IMPLS}, got {rng!r}")
    if first_play_force is not None and (first_play_force not in FORCE_CODES
                                         or first_play_key is None):
        raise ValueError("a forced first play takes first_play_force 'go', 'fg' or 'punt' and "
                         f"its stream's first_play_key; got {first_play_force!r}, "
                         f"{first_play_key!r}")
    dev = pack.device
    if init_state is not None:
        if init_state.off.shape[0] != n:
            raise ValueError(f"init_state holds {init_state.off.shape[0]} games, not n={n}")
        s = init_state
    elif situation is not None:
        s = state_from_situation(n, situation, cfg, dev, game_id, pack.k,
                                 collect_players, collect_stats)
    else:
        s = initial_state(n, first_offense, cfg, dev, game_id, pack.k,
                          collect_players, collect_stats)
    local = cfg.engine.antithetic and n % 4 == 0
    anti = local if antithetic is None else bool(antithetic)
    if anti and (n % 4 or row0 % 4):
        raise ValueError(f"antithetic draws for games {row0}..{row0 + n - 1} split a "
                         "mirrored block of four")
    if anti != local:    # play_step mirrors by the block's own count
        cfg = cfg.replace(engine=dataclasses.replace(cfg.engine, antithetic=anti))
    return s, cfg, anti


def _play_loop(s: GameState, pack: MatchupPack, cfg: SimConfig, heads_eval: HeadsEvalFn,
               heads_state, key: int, row0: int, anti: bool, collect_players: bool,
               collect_stats: bool, first_play_force: Optional[str] = None,
               first_play_key: Optional[int] = None) -> GameState:
    """The eager game loop: with `first_play_force`, one eager play step
    under that fourth.force on step 0 of `first_play_key`'s stream; then
    chunks of play_chunk eager play steps."""
    dev = pack.device
    n = s.off.shape[0]
    rows = n // 2 if anti else n
    r0 = row0 // 2 if anti else row0
    if first_play_force is not None:
        cfg_f = cfg.replace(fourth=dataclasses.replace(cfg.fourth, force=first_play_force))
        s = play_step(s, step_draws(first_play_key, 0, rows, dev, row0=r0), pack, cfg_f,
                      heads_eval, heads_state, collect_players, collect_stats)
    ch = cfg.engine.play_chunk
    n_chunks = -(-cfg.engine.max_plays // ch)
    buf = None
    if cfg.engine.rng_impl != "pallas":
        buf = (torch.empty((ch, rows, N_UNIFORMS), dtype=F32, device=dev),
               torch.empty((ch, rows, N_NORMALS), dtype=F32, device=dev))
    for ci in range(n_chunks):
        if cfg.engine.early_exit and not bool((s.sec > 0).any()):
            break
        step0 = ci * ch
        if buf is not None:
            chunk_draws(key, step0, ch, rows, dev, out=buf, row0=r0)
        for j in range(ch):
            draws = ((buf[0][j], buf[1][j]) if buf is not None
                     else step_draws(key, step0 + j, rows, dev, row0=r0))
            s = play_step(s, draws, pack, cfg, heads_eval, heads_state,
                          collect_players, collect_stats)
    if collect_stats:
        s.stats[:, :, TS["points"]] = s.score.to(F32)
    return s


def simulate_games(
    pack: MatchupPack,
    cfg: SimConfig,
    heads_eval: HeadsEvalFn,
    heads_state,
    key: int,
    n: int,
    first_offense,
    collect_players: bool = True,
    game_id=0,
    collect_stats: bool = True,
    situation: Optional[Situation] = None,
    init_state: Optional[GameState] = None,
    row0: int = 0,
    antithetic: Optional[bool] = None,
    first_play_force: Optional[str] = None,
    first_play_key: Optional[int] = None,
) -> GameState:
    """Run n independent games to completion on the pack's device; returns
    the final GameState.  `key` is a 64-bit launch key (ops/rng.fold_in).
    The games are games row0 .. row0 + n - 1 of a launch under `key` and
    draw that launch's rows, so a block of a launch played alone
    (`parallel.mesh`, the slate's game layout) plays what the whole launch
    gives its games.  `antithetic` is that launch's choice of antithetic
    draws (default engine.antithetic and n % 4 == 0); where it is on, the
    block draws from row0 / 2 and must keep the mirrored blocks of four
    whole (n % 4 == 0 and row0 % 4 == 0, else ValueError).

    Games start at the opening kickoff with `first_offense` (an int or an
    (n,) tensor); `situation` resumes them from a mid-game state instead
    (possession comes from it), and `init_state`, a GameState of n games
    with the collectors' shapes, overrides both.  Either way the draws
    start at absolute step 0.  `first_play_force` ('go', 'fg' or 'punt',
    the 4th-down evaluator's choice) plays one play first under that
    fourth.force, on the same rows of step 0 of `first_play_key`'s stream,
    outside the play cap; the games go on from there under `cfg`.

    On the card a launch that `nano_game_covers` (table heads of any
    layout, with or without the play-policy table; exact heads on a
    HeadsPack; the analytic heads; any fourth.force and forced first play;
    either collector, both or none) runs K1, the whole launch in one kernel
    launch (`nano_game`, the layout's and the collectors' instantiation); a
    failure to build or launch it raises.  Every launch on the CPU runs the
    eager loop of `simulate_games_eager`, which
    plays the same games: plays run in chunks of `play_chunk`; before each
    chunk the host asks once whether any game is still running (with
    early_exit), as the JAX package's while_loop cond does, so resumed
    late-game states stop after a chunk or two.  Draws come from the Philox
    kernel, keyed on (key, absolute step, row): with rng_impl
    "pallas_chunk", "threefry" or "rbg" one launch fills the chunk's whole
    draw buffer, allocated once per call; with "pallas" one launch per
    play; K1 draws the same stream in the kernel.  The JAX package's
    threefry and rbg generators are not reproduced: their names map onto
    this one stream, which per-step and chunked launches draw alike, so the
    four names play the same games for one key.  With engine.antithetic
    and n % 4 == 0 a launch draws n/2 rows, which each play mirrors as the
    JAX step does.  The collectors add to the state's stats and pstats in
    place, and with collect_stats the final score is written into the
    `points` column when the games end."""
    s, cfg, anti = _launch_state(pack, cfg, n, first_offense, collect_players, game_id,
                                 collect_stats, situation, init_state, row0, antithetic,
                                 first_play_force, first_play_key)
    if pack.device.type == "cuda" and nano_game_covers(cfg, heads_eval, heads_state):
        return nano_game(pack_nano_game(pack, cfg, heads_state), s, key, row0, anti,
                         collect_players, collect_stats, first_play_force, first_play_key)
    return _play_loop(s, pack, cfg, heads_eval, heads_state, key, row0, anti,
                      collect_players, collect_stats, first_play_force, first_play_key)


def simulate_games_eager(
    pack: MatchupPack,
    cfg: SimConfig,
    heads_eval: HeadsEvalFn,
    heads_state,
    key: int,
    n: int,
    first_offense,
    collect_players: bool = True,
    game_id=0,
    collect_stats: bool = True,
    situation: Optional[Situation] = None,
    init_state: Optional[GameState] = None,
    row0: int = 0,
    antithetic: Optional[bool] = None,
    first_play_force: Optional[str] = None,
    first_play_key: Optional[int] = None,
) -> GameState:
    """`simulate_games` on the eager loop alone, on any device: one eager
    `play_step` a play (some 630-750 device kernels a play on the card, and
    in exact mode a K5 launch a forest).  K1's plain version at the level of
    a launch, and the path of every launch K1 does not cover."""
    s, cfg, anti = _launch_state(pack, cfg, n, first_offense, collect_players, game_id,
                                 collect_stats, situation, init_state, row0, antithetic,
                                 first_play_force, first_play_key)
    return _play_loop(s, pack, cfg, heads_eval, heads_state, key, row0, anti,
                      collect_players, collect_stats, first_play_force, first_play_key)


# ---------------------------------------------------------------------------
# K1: a whole launch of games in one kernel (csrc/nano_game.cu)
# ---------------------------------------------------------------------------

_SLOTS = 8          # go-for-it edges an axis, FG points (padded)
_SEGS = 8           # segments an axis of the nano profile (padded)
_GRID_CELLS = 81
_INF = float("inf")
_KERNEL = "nano_game"


class _Segs(ctypes.Structure):
    """One axis of `table_lookup._seg_bin`, as `Segs` in csrc/nano_game.cu."""
    _fields_ = [("enter", ctypes.c_float * _SEGS), ("start", ctypes.c_float * _SEGS),
                ("inv_step", ctypes.c_float * _SEGS), ("top", ctypes.c_float * _SEGS),
                ("base", ctypes.c_int * _SEGS)]


def _floats(*names):
    return [(name, ctypes.c_float) for name in names]


def _ints(*names):
    return [(name, ctypes.c_int) for name in names]


class NanoConsts(ctypes.Structure):
    """What K1 reads of the config and the table's first profile (nano,
    fused or fine), as `NanoConsts` in csrc/nano_game.cu (field for field;
    the launcher checks the size).  Every float is the f32 the eager step's
    torch kernels compute with."""
    _fields_ = (
        [("go_ytg_edges", ctypes.c_float * _SLOTS), ("go_dist_edges", ctypes.c_float * _SLOTS),
         ("go_grid", ctypes.c_float * _GRID_CELLS)]
        + _ints("go_row", "go_cells", "late_seconds")
        + _floats("late_leading_scale", "late_trailing_long_fg_ytg", "late_trailing_go_long",
                  "late_trailing_go_short", "go_multiplier")
        + [("fg_bounds", ctypes.c_float * _SLOTS), ("fg_probs", ctypes.c_float * _SLOTS)]
        + _floats("fg_long_prob", "fg_snap_plus_endzone", "fg_attempt_max_ytg",
                  "punt_gross_mean", "punt_gross_sd", "punt_gross_min", "punt_return_mean",
                  "punt_return_sd", "punt_tb_gate_ytg", "punt_tb_lo", "punt_tb_hi",
                  "punt_tb_own_spot", "punt_net_min",
                  "s2_inc", "s2_int", "s2_sck", "stage2_int_scale", "stage2_int_add",
                  "stage2_sack_scale", "heuristic_clip_lo", "heuristic_clip_hi")
        + _ints("half_seconds")
        + _floats("pass_clip_lo", "rush_clip_lo", "sack_clip_lo", "sack_clip_hi",
                  "int_return_mean", "int_return_sd", "pass_sigma_floor")
        + _ints("taper_enabled", "rz_pass_damping", "enable_fumbles")
        + [("pass_taper", ctypes.c_float * 5), ("rush_taper", ctypes.c_float * 5)]
        + _floats("explosive_gate_ytg", "explosive_bonus_60", "explosive_bonus_40",
                  "explosive_lo", "explosive_hi")
        + [("explosive_pass", ctypes.c_float * 4), ("explosive_run", ctypes.c_float * 4),
           ("rz_pass", ctypes.c_float * 6), ("rz_run", ctypes.c_float * 6)]
        + _floats("r7", "r10", "r15", "r60",
                  "t_field_goal", "t_punt", "t_td_pass", "t_pass_complete",
                  "t_pass_incomplete", "t_sack", "t_interception", "t_run")
        + _ints("quarter_seconds")
        + _floats("kickoff_spot")
        + _ints("td_points", "fg_points")
        + [("dist", _Segs), ("ytg", _Segs), ("sec", _Segs), ("sd", _Segs)]
        + _ints("ny", "ns", "nsd", "c", "cols", "per_dir", "has_s2", "has_fumble", "cap"))


class _HeadTable(ctypes.Structure):
    """One per-head table, as `HeadTable` in csrc/nano_game.cu: the values'
    and row map's pointers (filled at launch), rows, the row map's length,
    channels, the profile of its cell (0 fine, 1 coarse), whether the cell
    folds the score diff in, and its key (0 QB slot, 1 rusher slot, 2 QB x
    target pair)."""
    _fields_ = ([("values", ctypes.c_void_p), ("row_map", ctypes.c_void_p),
                 ("rows", ctypes.c_int64)]
                + _ints("map_len", "cols", "profile", "has_sd", "key"))


_PLAY_EDGES = 32    # the play table's score-diff edges (26), padded
HEAD_TABLES = ("stage1", "stage2", "pq", "rq", "sq", "fumble")


class LayoutConsts(ctypes.Structure):
    """What K1 reads past the nano layout, as `LayoutConsts` in
    csrc/nano_game.cu (field for field; the launcher checks the size): the
    force codes and the forced play's key, the one-row layout's strides,
    the second (coarse) profile, the play-policy table and the per-head
    tables.  `pack_nano_game` fills all but the pointers and the forced
    play, which `nano_game_cuda` sets on its copy at launch."""
    _fields_ = (
        _ints("force_first", "force_every")
        + [("fk0", ctypes.c_uint32), ("fk1", ctypes.c_uint32), ("rows", ctypes.c_int64)]
        + _ints("s_down", "s_dist", "s_ytg", "s_sec", "s_sd", "b_down", "b_sd", "sd1", "nd1")
        + [("dist2", _Segs), ("ytg2", _Segs), ("sec2", _Segs), ("sd2", _Segs)]
        + _ints("nd2", "ny2", "ns2", "nsd2", "sd2_on", "has_play", "play_nsd", "play_cols")
        + [("play", ctypes.c_void_p), ("play_base", ctypes.c_void_p),
           ("play_rows", ctypes.c_int64), ("play_edges", ctypes.c_float * _PLAY_EDGES),
           ("heads", _HeadTable * len(HEAD_TABLES))]
        + _ints("k_heads", "use_fumble")
        + [("xdirs", ctypes.c_void_p)]
        + _floats("stage1_clip_lo", "stage1_clip_hi")
        + [(name, ctypes.c_void_p) for name in ("recs", "tiles", "forests", "ids")]
        + _ints("n_tiles", "n_forests", "id_k", "v_stage1", "v_stage2", "v_pq", "v_rq", "v_sq",
                "v_fumble", "v_play")
        + [("s2_order", ctypes.c_int * 3)]
        + _floats("sigma_scale", "pass_floor", "rush_floor", "sack_floor", "play_scale")
        + _ints("play_pass", "play_run")
        + _floats("play_clip_lo", "play_clip_hi", "timeouts")
        + [("phase_forest", ctypes.c_int * 4), ("walks", ctypes.c_void_p)])


# K1's instantiations by layout (kLayout in csrc/nano_game.cu): the nano
# table with no play-policy lookup and no forced play; one row a play (the
# fused layout, or the nano one with the play table or a forced play), the
# play table and the forced play read as LayoutConsts says; the per-head
# tables; three score-only one-row layouts with their options fixed at
# compile time, the launches the paths make past the nano layout: neither
# the play table nor a forced first play, the play table, a forced first
# play (`nano_kind` picks); and the heads that read no table: the analytic
# closed forms, and exact mode's forests walked every play
LAYOUT_KINDS = ("nano", "row", "heads", "row bare", "row play", "row forced", "analytic",
                "exact")
_FREE_KINDS = (LAYOUT_KINDS.index("analytic"), LAYOUT_KINDS.index("exact"))
# K1's instantiations, (kind, collect_stats, collect_players): each of the
# first three layouts with each combination of the collectors, the three
# score-only one-row layouts, each of the two without tables with each
# combination of the collectors
NANO_INSTANTIATIONS = tuple(
    [(k, st, pl) for k in range(3) for st in (False, True) for pl in (False, True)]
    + [(k, False, False) for k in range(3, 6)]
    + [(k, st, pl) for k in _FREE_KINDS for st in (False, True) for pl in (False, True)])
# the play table's score-diff bins, as K1 builds them once a block: a table
# of the integer score diffs PLAY_SD_LO .. PLAY_SD_LO + PLAY_SD_BINS - 1
# (kPlaySdLo, kPlaySdBins), each score diff clamped into it
PLAY_SD_LO, PLAY_SD_BINS = -128, 256
# K1 indexes table rows in 32 bits, as JAX's int32 index
_MAX_ROWS = 2 ** 31 - 1
# fourth.force and the forced first play's decision, as K1's codes
FORCE_CODES = {None: 0, "go": 1, "fg": 2, "punt": 3}
# the key of each per-head table (stage 2's where its table keys on slots)
_HEAD_KEYS = {"stage1": 0, "stage2": 0, "pq": 2, "rq": 1, "sq": 0, "fumble": 1}


class NanoGameArgs(NamedTuple):
    """K1's packed inputs, built by `pack_nano_game`: what the launcher
    passes, and all `nano_game_plain` reads."""
    consts: NanoConsts
    dirs: torch.Tensor      # (2G, 5) f32: ymult, mz, the red-zone tilts (pass,
                            # run) and the explosive base of each direction
    table: torch.Tensor     # (rows, cols) f32 nano or fused table; empty: per-head
    early_exit: bool        # the eager loop stops once no game is running
    slot_cum: torch.Tensor      # (3, 2G, K) f32: the pack's qb_cum, rb_cum, wr_cum
                                # (pstats' role order: QB, rusher, target)
    slot_tracked: torch.Tensor  # (3, 2G, K) bool: qb_, rb_, wr_tracked
    k: int                      # player slots (pack.k)
    layout: LayoutConsts        # past the nano layout: strides, profile, tables
    kind: int                   # LAYOUT_KINDS index of the instantiation
    table_layout: str           # "nano", "fused" or "per_head"
    heads: tuple                # per HEAD_TABLES: (values, row_map) or None
    play: Optional[torch.Tensor] = None       # (rows, C) play-policy table, when read
    play_base: Optional[torch.Tensor] = None  # (2G,) int64: each direction's first row
    xdirs: Optional[torch.Tensor] = None      # analytic, exact: (2G, 8) f32 per direction:
                                              # bias, the 4 SP+ columns, the coach's id bits
    exact: Optional["ExactForests"] = None    # exact: the forests as K1 walks them
    ids: Optional[torch.Tensor] = None        # exact: (9, 2G, K) int32 EXACT_ID_TABLES


def _segs(segs) -> _Segs:
    """`segments_of`'s (enter, start, step, base, count) as the kernel's
    f32 arithmetic of `_seg_bin`; past the last, segments no value enters."""
    if len(segs) > _SEGS:
        raise ValueError(f"a profile axis of {len(segs)} segments; K1 takes {_SEGS}")
    enters = [s[0] for s in segs]
    if enters and (enters[0] != -_INF or enters != sorted(enters)):
        raise ValueError("K1 bins a value by the segment boundaries it is past: their entry "
                         f"points must rise from -inf, got {enters}")
    g = _Segs()
    for k in range(_SEGS):
        if k < len(segs):
            enter, start, step, base, count = segs[k]
            g.enter[k], g.start[k], g.inv_step[k] = enter, start, analytic.recip(step)
            g.top[k], g.base[k] = count - 1, base
        else:
            g.enter[k] = _INF
    return g


def _config_consts(cfg: SimConfig) -> NanoConsts:
    """NanoConsts' config fields (all but the table's)."""
    c = NanoConsts()
    ytg_edges, dist_edges, grid = (t.numpy() for t in
                                   analytic.go_lookup(cfg.fourth.table, torch.device("cpu")))
    if ytg_edges.size > _SLOTS or dist_edges.size > _SLOTS:
        raise ValueError(f"the go-for-it table has more than {_SLOTS} edges on an axis")
    c.go_ytg_edges[:] = ytg_edges.tolist() + [_INF] * (_SLOTS - ytg_edges.size)
    c.go_dist_edges[:] = dist_edges.tolist() + [_INF] * (_SLOTS - dist_edges.size)
    c.go_grid[:grid.size] = grid.reshape(-1).tolist()
    c.go_row, c.go_cells = dist_edges.size + 1, grid.size
    f = cfg.fourth
    c.late_seconds = f.late_seconds
    c.late_leading_scale = f.late_leading_scale
    c.late_trailing_long_fg_ytg = f.late_trailing_long_fg_ytg
    c.late_trailing_go_long = f.late_trailing_go_long
    c.late_trailing_go_short = f.late_trailing_go_short
    c.go_multiplier = f.go_multiplier
    st = cfg.st
    if len(st.fg_curve) > _SLOTS:
        raise ValueError(f"the FG curve has more than {_SLOTS} points")
    for k in range(_SLOTS):
        c.fg_bounds[k], c.fg_probs[k] = st.fg_curve[k] if k < len(st.fg_curve) else (-_INF, 0.0)
    c.fg_long_prob, c.fg_snap_plus_endzone = st.fg_long_prob, st.fg_snap_plus_endzone
    c.fg_attempt_max_ytg = st.fg_attempt_max_ytg
    c.punt_gross_mean, c.punt_gross_sd = st.punt_gross_mean, st.punt_gross_sd
    c.punt_gross_min = st.punt_gross_min
    c.punt_return_mean, c.punt_return_sd = st.punt_return_mean, st.punt_return_sd
    c.punt_tb_gate_ytg, c.punt_tb_lo = st.punt_touchback_gate_ytg, st.punt_tb_lo
    c.punt_tb_hi, c.punt_tb_own_spot = st.punt_tb_hi, st.punt_tb_own_spot
    c.punt_net_min = st.punt_net_min
    base = analytic.STAGE2_FALLBACK_BASE
    c.s2_inc, c.s2_int, c.s2_sck = base["incomplete"], base["intercepted"], base["sack"]
    m = cfg.model
    c.stage2_int_scale, c.stage2_int_add = m.stage2_int_scale, m.stage2_int_add
    c.stage2_sack_scale = m.stage2_sack_scale
    c.heuristic_clip_lo, c.heuristic_clip_hi = m.heuristic_clip_lo, m.heuristic_clip_hi
    c.half_seconds = cfg.clock.half_seconds
    c.pass_clip_lo, c.rush_clip_lo = m.pass_clip_lo, m.rush_clip_lo
    c.sack_clip_lo, c.sack_clip_hi = m.sack_clip_lo, m.sack_clip_hi
    c.int_return_mean, c.int_return_sd = m.int_return_mean, m.int_return_sd
    c.pass_sigma_floor = m.pass_sigma_floor
    c.taper_enabled, c.rz_pass_damping = m.taper_enabled, m.rz_pass_damping
    c.enable_fumbles = m.enable_fumbles
    for name in ("pass_taper", "rush_taper"):
        t1, t2, r1, r2 = getattr(m, name)
        # _taper's `t1 + (t2 - t1) * r1` is Python arithmetic, rounded once
        getattr(c, name)[:] = [t1, t2, r1, r2, t1 + (t2 - t1) * r1]
    mc = cfg.matchup
    c.explosive_gate_ytg = mc.explosive_gate_ytg
    c.explosive_bonus_60, c.explosive_bonus_40 = mc.explosive_bonus_60, mc.explosive_bonus_40
    c.explosive_lo, c.explosive_hi = mc.explosive_lo, mc.explosive_hi
    # (scale, boost low end, boost span in double as the step writes it, z factor)
    c.explosive_pass[:] = [mc.explosive_pass_scale, mc.explosive_pass_boost_lo,
                           mc.explosive_pass_boost_hi - mc.explosive_pass_boost_lo,
                           mc.explosive_pass_z_k]
    c.explosive_run[:] = [mc.explosive_run_scale, mc.explosive_run_boost_lo,
                          mc.explosive_run_boost_hi - mc.explosive_run_boost_lo,
                          mc.explosive_run_z_k]
    # (gate, base, slope, down bonus, lo, hi)
    c.rz_pass[:] = [mc.rz_pass_gate_ytg, mc.rz_pass_base, mc.rz_pass_slope,
                    mc.rz_pass_down_bonus, mc.rz_pass_lo, mc.rz_pass_hi]
    c.rz_run[:] = [mc.rz_run_gate_ytg, mc.rz_run_base, mc.rz_run_slope,
                   mc.rz_run_down_bonus, mc.rz_run_lo, mc.rz_run_hi]
    c.r7, c.r10 = analytic.recip(7.0), analytic.recip(10.0)
    c.r15, c.r60 = analytic.recip(15.0), analytic.recip(60.0)
    k = cfg.clock
    c.t_field_goal, c.t_punt, c.t_td_pass = k.field_goal, k.punt, k.td_pass
    c.t_pass_complete, c.t_pass_incomplete = k.pass_complete, k.pass_incomplete
    c.t_sack, c.t_interception, c.t_run = k.sack, k.interception, k.run
    c.quarter_seconds = k.quarter_seconds
    c.kickoff_spot = cfg.kickoff_spot
    c.td_points, c.fg_points = m.td_points, m.fg_points
    ch = cfg.engine.play_chunk
    c.cap = -(-cfg.engine.max_plays // ch) * ch    # whole chunks, as the eager loop
    return c


def _force_code(force) -> int:
    if force not in FORCE_CODES:
        raise ValueError(f"fourth.force must be None|'go'|'fg'|'punt', got {force!r}")
    return FORCE_CODES[force]


def play_sd_bins(edges: torch.Tensor) -> torch.Tensor:
    """(PLAY_SD_BINS,) int32: the play table's score-diff bin (`_bin`: the
    edges below the value, compared in f32) of each integer score diff from
    PLAY_SD_LO on, as K1 builds the table in shared memory once a block.
    A score diff outside the range takes its nearest end's bin
    (`play_sd_bin`), its own bin where every finite edge lies in
    [PLAY_SD_LO, PLAY_SD_LO + PLAY_SD_BINS - 1) (`pack_nano_game` checks)."""
    sd = torch.arange(PLAY_SD_LO, PLAY_SD_LO + PLAY_SD_BINS, device=edges.device).to(F32)
    return (sd[:, None] > edges.to(F32)[None, :]).sum(dim=1, dtype=I32)


def play_sd_bin(sd: torch.Tensor, bins: torch.Tensor) -> torch.Tensor:
    """The bins `play_sd_bins` gives, of integer score diffs `sd`."""
    return bins[(sd.clamp(PLAY_SD_LO, PLAY_SD_LO + PLAY_SD_BINS - 1) - PLAY_SD_LO).long()]


def direction_bases(args: "NanoGameArgs") -> Tuple[torch.Tensor, torch.Tensor]:
    """((2G,) int32, (2G,) int32): each direction's first row in the table
    of the one-row layouts (dirx * per_dir; 0 for per-head tables) and in
    the play table (0 without one), as a lane of K1's score-only one-row
    layouts takes them for both directions of its game."""
    d = args.dirs.shape[0]
    dirx = torch.arange(d, dtype=torch.int64, device=args.dirs.device)
    rows = dirx * (0 if args.table_layout == "per_head" else args.consts.per_dir)
    play = torch.zeros_like(dirx) if args.play_base is None else args.play_base.to(dirx.device)
    return rows.to(I32), play.to(I32)


# exact mode on K1: the forest's link codes (kLink* in csrc/nano_game.cu; the
# play head's P(pass) at its temperature is EXACT_PLAY_LINK), the id tables
# of the pack the forests' groups read (the coach's broadcast over the
# slots), and each head's groups: (id table, role: 0 QB, 1 rusher, 2 target,
# pstats' order), which the eager heads (`_head_ids`), K1's packer and its
# plain version all read; a group a head passes no id for is unseen (-1)
EXACT_LINKS = {"identity": 0, "sigmoid": 1, "softmax": 2}
EXACT_PLAY_LINK = 3
EXACT_ID_TABLES = ("ids_qb_stage1", "ids_qb_stage2", "ids_wr_stage2", "ids_qb_passq",
                   "ids_wr_passq", "ids_rb_rushq", "ids_qb_sackq", "ids_rb_fumble", "coach_id")
_EXACT_GROUPS = {
    "stage1": {"passer_name": ("ids_qb_stage1", ROLE_PASS)},
    "stage2": {"passer_name": ("ids_qb_stage2", ROLE_PASS),
               "target_name": ("ids_wr_stage2", ROLE_REC)},
    "pq": {"passer_name": ("ids_qb_passq", ROLE_PASS), "target_name": ("ids_wr_passq", ROLE_REC)},
    "rq": {"rusher_name": ("ids_rb_rushq", ROLE_RUSH)},
    "sq": {"passer_name": ("ids_qb_sackq", ROLE_PASS)},
    "fumble": {"rusher_name": ("ids_rb_fumble", ROLE_RUSH)},
    "play": {"head_coach": ("coach_id", ROLE_PASS)},
}
EXACT_FEATURES = len(ST1_FEATURES)   # kFeatures: the ST1 row a play stages
EXACT_HEAD_VALS = 20                 # kHeadVals: the head values a thread keeps
EXACT_FOREST_WORDS = 24              # kForestWords
EXACT_XDIR_VALS = 8                  # kXdirVals
# K1 walks a play's forests in three phases (kPhases), each forest on the
# rows of one list: phase p's lists are 2p and 2p + 1 (kLists).  The list
# of each head (`exact_heads_read` names the rows in it): the play head on
# the scrimmage plays (phase A), stage 1 and stage 2 on the passes and the
# rush trio and the fumble head on the runs (B), the pass trio on the
# completions and the sack trio on the sacks (C).
EXACT_LISTS = {"play": 0, "stage1": 2, "stage2": 2, "rq": 3, "fumble": 3, "pq": 4, "sq": 5}
EXACT_PHASES = 3


@dataclasses.dataclass(frozen=True)
class ExactForests:
    """Exact mode's forests as K1 walks them (`exact_forests`), in the order
    a play walks them, phase by phase (EXACT_LISTS): the play head (where
    the config reads it); stage 1, stage 2, the rush trio, the fumble head
    (where read); the pass and sack trios.  Each forest keeps K5's records
    (`pack_kernel_records`), its numeric nodes reading the ST1 column of
    their feature in the staged row (the play head's numerics are a pick of
    ST1's)."""
    heads: tuple          # (head, TorchForest, the ST1 column of each numeric,
                          #  each group's (id table, role) or None) per forest
    vals: dict            # each head read: its first head value
    records: torch.Tensor     # (R, 2) int32, every forest's, 16-byte aligned
    tiles: torch.Tensor       # (n_tiles, 8) int32 (LayoutConsts::tiles)
    tree_off: torch.Tensor    # (T,) int32 each tree's root record in its tile
    tree_class: torch.Tensor  # (T,) int32 (both in each tile's table too)
    forests: torch.Tensor     # (n_forests, EXACT_FOREST_WORDS) int32
    phase_forest: tuple       # each phase's first forest, and n_forests


def _class_bits(hp: HeadsPack, head: str) -> Tuple[int, int]:
    """The play head's pass and run classes as bit masks (no run class: 0);
    (0, 0) for another forest."""
    if head != "play":
        return 0, 0
    return 1 << hp.play_pass_idx, (1 << hp.play_run_idx) if hp.play_run_idx >= 0 else 0


def _tiles_with_trees(head: str, rec: np.ndarray, kf, tree_class: np.ndarray):
    """K5's records of one forest (`rec`, (R, 2) int32, its tiles' layout in
    `kf`) retiled for K1: each tile a table of its trees, a uint32 a tree
    (its root's byte offset in the tile | its class << 16, padded to 8
    bytes), then the trees' records in order, at most TILE_RECORDS records
    in all, from an even record and padded to 16 bytes, so a tile's copy
    brings the walk all it reads.  (records, tiles (n, 4): first record,
    bytes, first tree, end tree; each tree's root record in its tile)."""
    node_of = kf.node_of.cpu().numpy()
    first_rec, count = [], []
    for first, nbytes, t0, t1 in kf.tiles.cpu().numpy().astype(np.int64):
        used = int((node_of[first:first + nbytes // 8] >= 0).sum())
        starts = kf.trees[t0:t1].cpu().numpy().astype(np.int64)
        first_rec += (first + starts).tolist()
        count += np.diff(np.append(starts, used)).tolist()
    out, tiles = [], []
    offs = np.zeros(len(count), np.int64)
    cur, n_out = [], 0

    def flush():
        nonlocal n_out
        table = (len(cur) + 1) // 2           # records of 8 bytes the table takes
        words = np.zeros(2 * table, np.uint32)
        at = table
        for i, t in enumerate(cur):
            offs[t] = at
            words[i] = (at * 8) | (int(tree_class[t]) << 16)
            at += count[t]
        parts = [words.view(np.int32).reshape(-1, 2)] + [
            rec[first_rec[t]:first_rec[t] + count[t]] for t in cur]
        if at % 2:
            parts.append(np.zeros((1, 2), np.int32))
        out.append(np.concatenate(parts))
        tiles.append((n_out, (at * 8 + 15) // 16 * 16, cur[0], cur[-1] + 1))
        n_out += at + at % 2

    held = 0                                  # records of the trees in `cur`
    for t in range(len(count)):
        if cur and (len(cur) + 2) // 2 + held + count[t] > TILE_RECORDS:
            flush()
            cur, held = [], 0
        if 1 + count[t] > TILE_RECORDS:
            raise ValueError(f"the {head} forest has a tree of {count[t]} records; with its "
                             f"table entry K1's tile holds {TILE_RECORDS - 1}")
        cur.append(t)
        held += count[t]
    flush()
    return np.concatenate(out), np.asarray(tiles, np.int64), offs.astype(np.int32)


def exact_forests(hp: HeadsPack, use_fumble: bool, use_play: bool) -> ExactForests:
    """The forests of `hp` that a play of exact mode reads (the fumble head
    where `use_fumble`, the play head where `use_play`) packed for K1, once
    a HeadsPack and choice (memoized on the pack).  Raises ValueError for a
    forest K5's records do not take (more than 4 groups, 64 numerics or
    4,096 records a tree: `pack_kernel_records`), of more than 8 classes,
    numerics past ST1's, or heads past the kernel's head values."""
    memo = hp.__dict__.setdefault("_k1_exact", {})
    key = (bool(use_fumble), bool(use_play))
    if key in memo:
        return memo[key]
    order = ([("play", hp.play)] if use_play else []) + [("stage1", hp.stage1)] + (
        [("stage2", hp.stage2)] if hp.stage2 is not None else []) + [
        ("rq", f) for f in hp.rq] + ([("fumble", hp.fumble)] if use_fumble else []) + [
        (h, f) for h in ("pq", "sq") for f in getattr(hp, h)]
    heads, vals = [], {}
    recs, tiles, tree_off, tree_class, desc = [], [], [], [], []
    n_rec = n_tree = n_vals = 0
    for fi, (head, tf) in enumerate(order):
        kf = tf.kernel
        if kf is None:
            raise ValueError(f"K1 does not take the {head} forest: {tf.kernel_refusal}")
        if not 1 <= tf.n_classes <= MAX_CLASSES:
            raise ValueError(f"the {head} forest has {tf.n_classes} classes; K1 sums "
                             f"1..{MAX_CLASSES}")
        if head == "play":
            cols = tuple(ST1_FEATURES.index(n) for n in tf.numeric_names)
            link, width = EXACT_PLAY_LINK, 1
        else:
            if len(tf.numeric_names) > EXACT_FEATURES:
                raise ValueError(f"the {head} forest reads {len(tf.numeric_names)} numerics; a "
                                 f"play's row holds ST1's {EXACT_FEATURES}")
            cols = tuple(range(len(tf.numeric_names)))
            link = EXACT_LINKS.get(tf.link, EXACT_LINKS["softmax"])
            width = 1 if tf.link == "sigmoid" else tf.n_classes
        vals.setdefault(head, n_vals)
        groups = tuple(_EXACT_GROUPS[head].get(g) for g in tf.group_names)
        heads.append((head, tf, cols, groups))
        rec = kf.records.cpu().numpy().copy()
        meta = rec[:, 1].view(np.uint32)
        numeric = ((meta & IS_CAT_BIT) == 0) & (kf.node_of.cpu().numpy() >= 0)
        j = ((meta[numeric] & SLOT_MASK) >> 2).astype(np.int64) - MAX_GROUPS
        meta[numeric] = ((meta[numeric] & ~np.uint32(SLOT_MASK))
                         | (4 * (MAX_GROUPS + np.asarray(cols, np.int64)[j])).astype(np.uint32))
        variant = (tf.n_classes > 1) * 4 + tf.cmp_lt * 2 + tf.zero_as_missing
        rec, tl, offs = _tiles_with_trees(head, rec, kf, tf.tree_class.cpu().numpy())
        for i, (first, nbytes, t0, t1) in enumerate(tl):
            tiles.append([first + n_rec, nbytes, t0 + n_tree, t1 + n_tree, fi, i == 0,
                          i == len(tl) - 1, variant])
        src = [-1] * MAX_GROUPS
        for g, grp in enumerate(groups):
            if grp is not None:
                src[g] = EXACT_ID_TABLES.index(grp[0]) * 4 + grp[1]
        base = np.zeros(MAX_CLASSES, np.float32)
        base[:tf.n_classes] = tf.base_margin.cpu().numpy()
        desc.append([len(tiles) - len(tl), len(tl), tf.n_classes, link, tf.cmp_lt,
                     tf.zero_as_missing, kf.steps, n_vals, *src, *base.view(np.int32).tolist(),
                     EXACT_LISTS[head], tf.n_trees, *_class_bits(hp, head)])
        recs.append(rec)
        tree_off.append(offs)
        tree_class.append(tf.tree_class.cpu().numpy())
        n_rec, n_tree, n_vals = n_rec + rec.shape[0], n_tree + tf.n_trees, n_vals + width
    if n_vals > EXACT_HEAD_VALS:
        raise ValueError(f"the heads give {n_vals} values a play; K1 keeps {EXACT_HEAD_VALS}")
    dev = hp.stage1.device

    def t(parts):
        return torch.tensor(np.concatenate(parts) if isinstance(parts, list) else parts,
                            dtype=torch.int32, device=dev).contiguous()

    phases = [EXACT_LISTS[head] // 2 for head, *_ in heads]
    phase_forest = tuple(sum(q < p for q in phases) for p in range(EXACT_PHASES + 1))
    out = ExactForests(tuple(heads), vals, t(recs), t(np.asarray(tiles, np.int64)), t(tree_off),
                       t(tree_class), t(np.asarray(desc, np.int64)), phase_forest)
    memo[key] = out
    return out


def _direction_consts(pack: MatchupPack, cfg: SimConfig) -> torch.Tensor:
    """(2G, 5) f32: what the eager step computes from the direction alone
    (ymult, mz, the red-zone tilts of pass and run, the explosive base), by
    its own torch expressions on the pack's device."""
    mc = cfg.matchup
    gap = pack.off_offense - pack.def_defense
    tilt_pass = mc.rz_pass_tilt * torch.tanh(gap * analytic.recip(mc.rz_pass_tilt_denom))
    tilt_run = mc.rz_run_tilt * torch.tanh(gap * analytic.recip(mc.rz_run_tilt_denom))
    exp_base = mc.explosive_base + mc.explosive_z_k * (gap * analytic.recip(mc.mismatch_denom))
    return torch.stack([pack.ymult, pack.mz, tilt_pass, tilt_run, exp_base],
                       dim=1).to(F32).contiguous()


def _slot_tables(pack: MatchupPack) -> Tuple[torch.Tensor, torch.Tensor]:
    """The slots' cumulative shares and tracked flags by role, (3, 2G, K)."""
    return (torch.stack([pack.qb_cum, pack.rb_cum, pack.wr_cum]).to(F32).contiguous(),
            torch.stack([pack.qb_tracked, pack.rb_tracked,
                         pack.wr_tracked]).to(torch.bool).contiguous())


def _pack_free_heads(pack: MatchupPack, cfg: SimConfig, hp: Optional[HeadsPack]) -> NanoGameArgs:
    """K1's inputs for heads that read no table: the analytic closed forms
    (`hp` None) or exact mode's forests (`hp` a HeadsPack; the fumble head
    where the config enables fumbles, the play head under use_play_model):
    the constants, the direction table, per direction the stage-1 bias, the
    ST1 rows' SP+ columns and the coach's id (`xdirs`), and in exact mode
    the forests (`exact_forests`, memoized on `hp`) and the pack's id
    tables."""
    d = pack.bias.shape[0]
    c, lay = _config_consts(cfg), LayoutConsts()
    m = cfg.model
    lay.force_every = _force_code(cfg.fourth.force)
    lay.stage1_clip_lo, lay.stage1_clip_hi = m.stage1_clip_lo, m.stage1_clip_hi
    coach = pack.coach_id.to(I32).view(F32)
    xdirs = torch.cat([pack.bias.to(F32)[:, None], pack.sp.to(F32), coach[:, None],
                       pack.bias.new_zeros((d, 2), dtype=F32)], dim=1).contiguous()
    kind, exact, ids = "analytic", None, None
    if hp is not None:
        kind = "exact"
        exact = exact_forests(hp, hp.fumble is not None and m.enable_fumbles,
                              hp.play is not None and m.use_play_model)
        c.has_s2 = hp.stage2 is not None
        ids = torch.stack([getattr(pack, name) if name != "coach_id"
                           else pack.coach_id[:, None].expand(d, pack.k)
                           for name in EXACT_ID_TABLES]).to(I32).contiguous()
        lay.n_tiles, lay.n_forests, lay.id_k = exact.tiles.shape[0], exact.forests.shape[0], pack.k
        lay.phase_forest[:] = exact.phase_forest
        for head in ("stage1", "stage2", "pq", "rq", "sq", "fumble", "play"):
            setattr(lay, f"v_{head}", exact.vals.get(head, -1))
        lay.s2_order[:] = hp.stage2_order
        lay.sigma_scale = analytic.recip(m.sigma_denom)
        lay.pass_floor, lay.rush_floor = m.pass_sigma_floor, m.rush_sigma_floor
        lay.sack_floor = m.sack_sigma_floor
        lay.play_scale = analytic.recip(max(1e-6, hp.play_temperature))
        lay.play_pass, lay.play_run = hp.play_pass_idx, hp.play_run_idx
        lay.play_clip_lo, lay.play_clip_hi = m.play_clip_lo, m.play_clip_hi
        lay.timeouts = cfg.timeouts
    return NanoGameArgs(c, _direction_consts(pack, cfg), pack.bias.new_empty(0, dtype=F32),
                        cfg.engine.early_exit, *_slot_tables(pack), pack.k, lay,
                        LAYOUT_KINDS.index(kind), kind, (None,) * len(HEAD_TABLES),
                        xdirs=xdirs, exact=exact, ids=ids)


def _check_dirs(t, d: int, what: str) -> None:
    if t.row_map.shape[0] != d:
        raise ValueError(f"the {what} table holds {t.row_map.shape[0]} directions, the pack {d}")


def _first_profile(c: NanoConsts, prof, sd: bool) -> None:
    """NanoConsts' segments and (ny, ns) of the first profile; its score
    diff binned where `sd`."""
    c.dist, c.ytg, c.sec = _segs(prof.dist_segs), _segs(prof.ytg_segs), _segs(prof.sec_segs)
    c.sd = _segs(prof.sd_segs if sd else ())
    c.ny, c.ns = prof.ny, prof.ns


def pack_nano_game(pack: MatchupPack, cfg: SimConfig, th) -> NanoGameArgs:
    """K1's inputs for `pack`'s matchups on the TableHeads `th`, in the
    layout a play reads (`make_table_heads_eval`'s: nano, then fused, then
    per-head): the constants, per direction what the eager step computes
    from the direction alone, by its own torch expressions on the pack's
    device (the same bits as the step's per-game copies), and the player
    slots' cumulative shares and tracked flags by role.  Under
    `use_play_model` with a play table, the play-policy lookup on the
    coarse profile beside any layout.  `th` None packs the analytic heads,
    a HeadsPack exact mode's forests (`_pack_free_heads`)."""
    if th is None or isinstance(th, HeadsPack):
        return _pack_free_heads(pack, cfg, th)
    d = pack.bias.shape[0]
    c, lay = _config_consts(cfg), LayoutConsts()
    lay.force_every = _force_code(cfg.fourth.force)
    heads = (None,) * len(HEAD_TABLES)
    if th.nano is not None:
        _check_dirs(th.nano, d, "nano")
        layout, table, prof, nsd, cc = "nano", th.nano.values, th.nano_prof, th.nano_nsd, th.nano_c
        _first_profile(c, prof, nsd > 1)
        c.nsd, c.c, c.cols, c.per_dir = nsd, cc, table.shape[1], th.per_dir
        # the nano table's row and (down, sd) block by strides
        lay.s_dist, lay.s_ytg, lay.s_sec = prof.ny * prof.ns, prof.ns, 1
        lay.b_down, lay.b_sd, lay.sd1 = nsd * cc, cc if nsd > 1 else 0, nsd > 1
    elif th.fused is not None:
        _check_dirs(th.fused, d, "fused")
        layout, table, prof, has_sd = "fused", th.fused.values, th.fused_prof, th.fused.has_sd
        _first_profile(c, prof, has_sd)
        nsd = prof.nsd if has_sd else 1
        c.nsd, c.cols = nsd, table.shape[1]
        c.per_dir = table.shape[0] // th.fused.row_map.numel()
        lay.s_sec, lay.s_ytg = nsd, prof.ns * nsd
        lay.s_dist, lay.s_down = prof.ny * prof.ns * nsd, prof.nd * prof.ny * prof.ns * nsd
        lay.s_sd, lay.sd1 = int(has_sd), has_sd
    else:
        missing = [n for n in ("stage1", "pq", "rq", "sq", "fine", "coarse")
                   if getattr(th, n) is None]
        if missing:
            raise ValueError(f"per-head tables without {', '.join(missing)}")
        _check_dirs(th.stage1, d, "stage 1")
        layout, table, fine = "per_head", th.stage1.values.new_empty(0), th.fine
        _first_profile(c, fine, bool(fine.sd_segs))
        c.nsd, lay.sd1, lay.nd1 = fine.nsd, bool(fine.sd_segs), fine.nd
        c.has_s2 = th.stage2 is not None
        heads = []
        for i, name in enumerate(HEAD_TABLES):
            t = getattr(th, name)
            heads.append(None if t is None else (t.values, t.row_map))
            if t is None:
                continue
            ht = lay.heads[i]
            ht.rows, ht.map_len, ht.cols = t.values.shape[0], t.row_map.numel(), t.values.shape[1]
            ht.profile, ht.has_sd = int(t.profile != "fine"), t.has_sd
            ht.key = 2 if name == "stage2" and t.is_pair else _HEAD_KEYS[name]
            if t.has_sd and not (th.coarse if ht.profile else fine).sd_segs:
                raise ValueError(f"the {name} table has a score-diff axis its profile lacks")
        heads = tuple(heads)
        lay.k_heads = th.k
        lay.use_fumble = th.fumble is not None and cfg.model.enable_fumbles
    if layout != "per_head":
        lay.rows = table.shape[0]
        c.has_s2, c.has_fumble = th.fused_has_s2, th.fused_has_fumble
    has_play = th.play is not None and cfg.model.use_play_model
    play = play_base = None
    if has_play or layout == "per_head":
        if th.coarse is None:
            raise ValueError("the play-policy table is on the coarse profile, which the "
                             "TableHeads lacks")
        cp = th.coarse
        lay.dist2, lay.ytg2, lay.sec2 = (_segs(cp.dist_segs), _segs(cp.ytg_segs),
                                         _segs(cp.sec_segs))
        lay.sd2, lay.sd2_on = _segs(cp.sd_segs), bool(cp.sd_segs)
        lay.nd2, lay.ny2, lay.ns2, lay.nsd2 = cp.nd, cp.ny, cp.ns, cp.nsd
    if has_play:
        t, edges = th.play, th.play_sd_edges.tolist()
        if len(edges) > _PLAY_EDGES:
            raise ValueError(f"{len(edges)} play-table score-diff edges; K1 takes {_PLAY_EDGES}")
        lo, hi = PLAY_SD_LO, PLAY_SD_LO + PLAY_SD_BINS - 1
        outside = [e for e in edges if math.isfinite(e) and not lo <= e < hi]
        if outside:
            raise ValueError(f"K1 bins the play table's score diff on the integers {lo}..{hi}; "
                             f"edges {outside} lie outside [{lo}, {hi})")
        lay.has_play, lay.play_nsd, lay.play_cols = 1, th.play_nsd, t.values.shape[1]
        lay.play_rows = t.values.shape[0]
        lay.play_edges[:] = edges + [_INF] * (_PLAY_EDGES - len(edges))
        dirx = torch.arange(d, device=t.values.device)
        if layout == "per_head":      # the direction's entry of the row map, clamped
            base = t.row_map.reshape(-1)[dirx.clamp(0, t.row_map.numel() - 1)].long()
        else:                         # direction d's block of equal-sized blocks
            base = dirx * (t.values.shape[0] // t.row_map.numel())
        play, play_base = t.values, base.to(torch.int64).contiguous()
    if lay.rows > _MAX_ROWS or lay.play_rows > _MAX_ROWS:
        raise ValueError(f"K1 indexes table rows in 32 bits: {max(lay.rows, lay.play_rows):,} "
                         "rows")
    if layout == "per_head":
        kind = "heads"
    else:
        kind = "row" if layout == "fused" or has_play or lay.force_every else "nano"
    return NanoGameArgs(c, _direction_consts(pack, cfg), table, cfg.engine.early_exit,
                        *_slot_tables(pack), pack.k, lay, LAYOUT_KINDS.index(kind), layout, heads,
                        play, play_base)


def nano_game_covers(cfg: SimConfig, heads_eval: HeadsEvalFn, heads_state) -> bool:
    """Whether K1 plays a launch of these settings: table heads
    (`heads_eval.table_heads`) on a TableHeads of any layout (nano, fused,
    or per-head tables on the fine and coarse profiles), with the
    play-policy table or not (it needs the coarse profile); exact heads
    (`heads_eval.exact_heads`) on a HeadsPack with stage 1 and the three
    trios; analytic heads (`heads_eval.analytic_heads`) with no heads state;
    any fourth.force and either collector, both or none."""
    if getattr(heads_eval, "analytic_heads", False):
        return heads_state is None and cfg.fourth.force in FORCE_CODES
    if getattr(heads_eval, "exact_heads", False):
        return (isinstance(heads_state, HeadsPack)
                and all(getattr(heads_state, n) is not None for n in ("stage1", "pq", "rq", "sq"))
                and cfg.fourth.force in FORCE_CODES)
    th = heads_state
    if not getattr(heads_eval, "table_heads", False) or th is None:
        return False
    per_head = all(getattr(th, n, None) is not None
                   for n in ("stage1", "pq", "rq", "sq", "fine", "coarse"))
    if th.nano is None and th.fused is None and not per_head:
        return False
    if th.play is not None and cfg.model.use_play_model and th.coarse is None:
        return False
    return cfg.fourth.force in FORCE_CODES


def _seg_bin_packed(v: torch.Tensor, g: _Segs) -> torch.Tensor:
    """`table_lookup._seg_bin` on packed segments."""
    idx = torch.zeros(v.shape, dtype=I32, device=v.device)
    for k in range(_SEGS):
        if g.enter[k] == _INF:
            break
        local = torch.clamp(torch.round((v - g.start[k]) * g.inv_step[k]),
                            0, g.top[k]).to(I32) + g.base[k]
        idx = local if g.enter[k] == -_INF else torch.where(v > g.enter[k], local, idx)
    return idx


def _nudged_cum(c: NanoConsts, p_inc, p_int, p_sck):
    """analytic.stage2_nudge on the packed constants: the nudged and
    renormed (P(inc), P(inc) + P(sack))."""
    p_inc = torch.clamp_min(p_inc, 0.0)
    p_int = torch.clamp_min(p_int, 0.0) * c.stage2_int_scale + c.stage2_int_add
    p_sck = torch.clamp_min(p_sck, 0.0) * c.stage2_sack_scale
    tot = p_inc + p_int + p_sck
    tot = torch.where(tot == 0.0, 1.0, tot)
    s2c0 = p_inc / tot
    return s2c0, s2c0 + p_sck / tot


def _exact_heads(args: NanoGameArgs, dirx, sd, down0, dist0, ytg0, sec0, u):
    """Exact mode's head channels as K1 computes them from its packed
    inputs: the play's ST1 rows (`st1_rows`, the SP+ columns from xdirs),
    the slots sampled, each forest walked on its packed
    records (`eval_margin_packed`) with its groups' ids from the id tables,
    its link (`forest_link`, the play head's `play_link`), then
    `make_exact_heads_eval`'s post-processing."""
    c, lay, ex = args.consts, args.layout, args.exact
    xd = args.xdirs[dirx.long()]
    x = st1_rows(xd[:, 1:5], lay.timeouts, c.half_seconds, down0, dist0, ytg0, sec0, sd)
    slots = [_sample_slot(args.slot_cum[r], dirx, u[:, draw])
             for r, draw in enumerate((U_QB, U_RB, U_WR))]
    vals = {}
    for head, tf, cols, groups in ex.heads:
        cat = {name: _gather2k(args.ids[EXACT_ID_TABLES.index(g[0])], dirx, slots[g[1]])
               for name, g in zip(tf.group_names, groups) if g is not None}
        m = eval_margin_packed(tf, x[:, list(cols)].contiguous(), cat)
        out = (play_link(m, lay.play_scale, lay.play_pass, lay.play_run, lay.play_clip_lo,
                         lay.play_clip_hi) if head == "play" else forest_link(tf, m))
        vals.setdefault(head, []).append(out)
    p_c = torch.clamp(vals["stage1"][0] + xd[:, 0], lay.stage1_clip_lo, lay.stage1_clip_hi)
    s2 = None
    if "stage2" in vals:
        probs, o = vals["stage2"][0], lay.s2_order
        s2 = _nudged_cum(c, probs[:, o[0]], probs[:, o[1]], probs[:, o[2]])

    def ms(head, floor):
        q = vals[head]
        return torch.stack([q[1], torch.clamp_min((q[2] - q[0]) * lay.sigma_scale, floor)],
                           dim=1)

    return (p_c, ms("pq", lay.pass_floor), ms("rq", lay.rush_floor), ms("sq", lay.sack_floor),
            s2, vals["fumble"][0] if "fumble" in vals else None,
            vals["play"][0] if "play" in vals else None)


def _packed_heads(args: NanoGameArgs, dirx, sd, down0, dist0, ytg0, sec0, u):
    """The play's head channels from the packed tables, as K1 reads them:
    (p_c, pass (mu, sigma), rush, sack, stage 2's cumulative pair or None
    where the analytic stage 2 applies, p_fumble or None, the play table's
    P(pass) or None).  One row by strides (nano, fused), or a lookup a head
    through its row map keyed on the play's sampled slots (per-head); the
    closed forms (analytic); the forests (exact, `_exact_heads`)."""
    c, lay = args.consts, args.layout
    if args.table_layout == "analytic":
        p_c, pass_ms, rush_ms, sack_ms, p_f = analytic_channels(
            args.xdirs[dirx.long(), 0], dist0, lay.stage1_clip_lo, lay.stage1_clip_hi)
        return p_c, pass_ms, rush_ms, sack_ms, None, p_f, None
    if args.table_layout == "exact":
        return _exact_heads(args, dirx, sd, down0, dist0, ytg0, sec0, u)
    down_i = torch.clamp(down0 - 1, 0, 4)
    sdf = sd.to(F32)
    di = _seg_bin_packed(dist0, c.dist)
    yi = _seg_bin_packed(ytg0, c.ytg)
    si = _seg_bin_packed(sec0.to(F32), c.sec)
    sdi = _seg_bin_packed(sdf, c.sd) if lay.sd1 else torch.zeros_like(di)
    cell2 = None
    if lay.has_play or args.table_layout == "per_head":
        di2 = _seg_bin_packed(dist0, lay.dist2)
        yi2 = _seg_bin_packed(ytg0, lay.ytg2)
        si2 = _seg_bin_packed(sec0.to(F32), lay.sec2)
        sdi2 = _seg_bin_packed(sdf, lay.sd2) if lay.sd2_on else torch.zeros_like(di)
        cell2 = ((down_i * lay.nd2 + di2) * lay.ny2 + yi2) * lay.ns2 + si2
    p_ml = None
    row_base, play_base = (b[dirx.long()].long() for b in direction_bases(args))
    if lay.has_play:
        bins = play_sd_bins(torch.tensor(list(lay.play_edges), dtype=F32, device=sdf.device))
        idx = play_base + cell2 * lay.play_nsd + play_sd_bin(sd, bins)
        p_ml = args.play[idx.clamp(0, lay.play_rows - 1), 0]
    if args.table_layout != "per_head":
        row = (row_base + down_i * lay.s_down + di * lay.s_dist
               + yi * lay.s_ytg + si * lay.s_sec + sdi * lay.s_sd).clamp(0, lay.rows - 1)
        start = row * c.cols + (down_i * lay.b_down + sdi * lay.b_sd).long()
        nch = 7 + 2 * c.has_s2 + c.has_fumble
        h = args.table.view(-1)[start[:, None] + torch.arange(nch, dtype=torch.int64,
                                                              device=start.device)]
        s2 = (h[:, 7], h[:, 8]) if c.has_s2 else None
        p_f = h[:, 9 if c.has_s2 else 7] if c.has_fumble else None
        return h[:, 0], h[:, 1:3], h[:, 3:5], h[:, 5:7], s2, p_f, p_ml
    qb, rb, wr = (_sample_slot(args.slot_cum[r], dirx, u[:, draw])
                  for r, draw in enumerate((U_QB, U_RB, U_WR)))
    kk = lay.k_heads
    keys = (dirx * kk + qb, dirx * kk + rb, (dirx * kk + qb) * kk + wr)
    cells = (((down_i * lay.nd1 + di) * c.ny + yi) * c.ns + si, cell2)
    sds = ((sdi, c.nsd), (sdi2 if cell2 is not None else None, lay.nsd2))

    def look(i):
        values, row_map = args.heads[i]
        t = lay.heads[i]
        base = row_map.reshape(-1)[keys[t.key].long().clamp(0, t.map_len - 1)]
        st = cells[t.profile]
        if t.has_sd:
            st = st * sds[t.profile][1] + sds[t.profile][0]
        return values[(base.long() + st).clamp(0, t.rows - 1)]

    st1, pq, rq, sq = look(0), look(2), look(3), look(4)
    s2 = look(1) if c.has_s2 else None
    return (st1[:, 0], pq, rq, sq, None if s2 is None else (s2[:, 0], s2[:, 1]),
            look(5)[:, 0] if lay.use_fumble else None, p_ml)


def _go_tables(c: NanoConsts, dev) -> Tuple[torch.Tensor, ...]:
    """The go-for-it table's padded ytg and dist edges and its grid."""
    return (torch.tensor(list(c.go_ytg_edges), dtype=F32, device=dev),
            torch.tensor(list(c.go_dist_edges), dtype=F32, device=dev),
            torch.tensor(list(c.go_grid)[:c.go_cells], dtype=F32, device=dev))


def _fourth_decision(c: NanoConsts, go: Tuple[torch.Tensor, ...], active, down0, dist0, ytg0,
                     sec0, sd, u: torch.Tensor, force: int):
    """(go, st_play, fg_att) of the plays from the packed constants and the
    go tables (`_go_tables`): the go-for-it probability, the decision forced
    where `force` is a FORCE_CODES code."""
    ytg_edges, dist_edges, grid = go
    yi = (ytg0[:, None] > ytg_edges).sum(dim=1)
    di = (dist0[:, None] > dist_edges).sum(dim=1)
    p = grid[yi * c.go_row + di]
    late = sec0 < c.late_seconds
    p = torch.where(late & (sd > 0), p * c.late_leading_scale, p)
    p = torch.where(late & (sd < 0), torch.where(ytg0 > c.late_trailing_long_fg_ytg,
                                                 c.late_trailing_go_long,
                                                 c.late_trailing_go_short), p)
    p_go = torch.clamp_max(torch.clamp(p, 0.0, 1.0) * c.go_multiplier, 1.0)
    is4 = down0 == 4
    if force:
        # the decision overridden (FourthDownConfig.force); the draws as ever
        go = active & is4 & (force == FORCE_CODES["go"])
        st_play = active & is4 & (force != FORCE_CODES["go"])
        fg_att = st_play & (force == FORCE_CODES["fg"])
    else:
        go = active & is4 & (u[:, U_GO] < p_go)
        st_play = active & is4 & ~go
        fg_att = st_play & (ytg0 <= c.fg_attempt_max_ytg)
    return go, st_play, fg_att


def _stage2_pair(c: NanoConsts, s2, down0, dist0):
    """Stage 2's cumulative pair: the heads' (`s2`), else the analytic
    fallback's."""
    if s2 is not None:
        return s2
    long_d = torch.clamp_min(dist0 - 7.0, 0.0) * c.r10
    p_sck = c.s2_sck * (1.0 + 0.25 * torch.where(down0.to(F32) >= 3, 1.0, 0.0)
                        + 0.15 * long_d)
    p_int = c.s2_int * (1.0 + 0.10 * long_d)
    p_inc = torch.full_like(p_sck, c.s2_inc)
    tot = p_inc + p_int + p_sck
    return _nudged_cum(c, p_inc / tot, p_int / tot, p_sck / tot)


def _pass_prob_packed(c: NanoConsts, down0, dist0, ytg0, sec0, sd):
    """analytic.pass_prob_v1 on the packed constants."""
    r10 = c.r10
    base = 0.53 + torch.where(
        down0 == 1, 0.02 + 0.010 * torch.clamp_min(dist0 - 10, 0.0) * r10, 0.0)
    base = base + torch.where(
        down0 == 2, 0.12 + 0.020 * torch.clamp_min(dist0 - 7, 0.0) * r10, 0.0)
    base = base + torch.where(
        down0 == 3, 0.28 + 0.030 * torch.clamp_min(dist0 - 5, 0.0) * r10, 0.0)
    base = base + torch.where(
        down0 == 4, 0.45 + 0.035 * torch.clamp_min(dist0 - 3, 0.0) * r10, 0.0)
    base = base - torch.where(ytg0 <= 10, 0.05, 0.0)
    base = base - torch.where(ytg0 <= 5, 0.03, 0.0)
    two_min = (sec0 % c.half_seconds) <= 120
    base = base + torch.where(two_min & (sd < 0), 0.22, 0.0)
    base = base + torch.where((sec0 < 600) & (sd < 0), 0.06, 0.0)
    return torch.clamp(base, c.heuristic_clip_lo, c.heuristic_clip_hi)


def exact_heads_read(args: NanoGameArgs, down0, dist0, ytg0, sec0, sd, u: torch.Tensor,
                     heads, force: int = 0) -> dict:
    """The rows whose play reads each head of exact mode, by the rule K1's
    exact instantiation walks its phases by (EXACT_LISTS), from the state
    (`down0` .. `sd`, the offense's score diff; a row with sec0 <= 0 plays
    nothing), the play's (mirrored) uniforms `u` and its head values `heads`
    (`_exact_heads`' tuple: p_c, pass, rush and sack (mu, sigma), stage 2's
    pair or None, p_fumble or None, the play head's P(pass) or None), under
    the FORCE_CODES code `force`: {head: (B,) bool} for each head of
    `args.exact`.  The play head on a scrimmage play; stage 1 and stage 2 on
    a pass (stage 2 decides a sack, so it is walked on every pass), the rush
    trio and the fumble head on a run; the pass trio on a completion, the
    sack trio on a sack.  `_nano_play`'s decisions on the same values, so a
    head a row does not read never reaches its play.  Nothing on the main
    path calls it: tests hold it to the games, and `nano_game_plain`
    counts the kernel's walks by it."""
    c = args.consts
    active = sec0 > 0
    _, st_play, _ = _fourth_decision(c, _go_tables(c, sec0.device), active, down0, dist0, ytg0,
                                     sec0, sd, u, force)
    scrim = active & ~st_play
    p_c, _, _, _, s2, _, p_ml = heads
    p_pass = p_ml if p_ml is not None else _pass_prob_packed(c, down0, dist0, ytg0, sec0, sd)
    is_pass = scrim & (u[:, U_CALL] < p_pass)
    complete = is_pass & (u[:, U_COMPLETE] < p_c)
    notc = is_pass & ~complete
    s2c0, s2c1 = _stage2_pair(c, s2, down0, dist0)
    o_inc = notc & (u[:, U_S2] < s2c0)
    rows = {0: scrim, 2: is_pass, 3: scrim & ~is_pass, 4: complete,
            5: notc & ~o_inc & (u[:, U_S2] < s2c1)}
    return {head: rows[EXACT_LISTS[head]] for head in args.exact.vals}


def exact_walk_counts(args: NanoGameArgs, read: dict) -> torch.Tensor:
    """(n_forests,) int64: the (row, tree) walks of the rows `read` marks
    (`exact_heads_read`), forest by forest in K1's order."""
    return torch.stack([read[head].sum() * tf.n_trees
                        for head, tf, *_ in args.exact.heads]).to(torch.int64)


def _nano_play(args: NanoGameArgs, go: Tuple[torch.Tensor, ...], s: GameState,
               u: torch.Tensor, n: torch.Tensor, collect_players: bool,
               collect_stats: bool, force: int = 0,
               walks: Optional[torch.Tensor] = None) -> GameState:
    """One masked play of every game from the packed inputs: `play_step`
    with the table heads, as K1 plays it, the 4th-down decision forced
    where `force` is a FORCE_CODES code.  A collector adds only what K1
    adds: the team stats of the games still running, and per role the row
    of the games whose play involves it (QB and target on a pass play,
    rusher on a run) on a tracked slot; every add it leaves out is one of
    the eager step's +0.0.  In exact mode `walks` has the walks K1 takes
    (`exact_heads_read`) added to it."""
    c, dirs = args.consts, args.dirs
    active = s.sec > 0
    off, down0, dist0, ytg0, sec0 = s.off, s.down, s.dist, s.ytg, s.sec
    dirx = s.gid * 2 + off
    sd = (s.score[:, 0] - s.score[:, 1]) * (1 - 2 * off)
    ymult, mz, tilt_pass, tilt_run, exp_base = dirs[dirx.long()].unbind(1)

    # ---- 4th-down decision
    go, st_play, fg_att = _fourth_decision(c, go, active, down0, dist0, ytg0, sec0, sd, u, force)
    punt = st_play & ~fg_att
    scrim = active & ~st_play

    # FG
    att = ytg0 + c.fg_snap_plus_endzone
    p_fg = torch.full_like(att, c.fg_long_prob)
    for k in reversed(range(_SLOTS)):
        if c.fg_bounds[k] != -_INF:
            p_fg = torch.where(att < c.fg_bounds[k], c.fg_probs[k], p_fg)
    fg_good = fg_att & (u[:, U_FG] < p_fg)
    fg_miss = fg_att & ~fg_good

    # punt
    gross = torch.clamp_min(c.punt_gross_mean + c.punt_gross_sd * n[:, N_PUNT_GROSS],
                            c.punt_gross_min)
    pret = torch.clamp_min(c.punt_return_mean + c.punt_return_sd * n[:, N_PUNT_RET], 0.0)
    net = gross - pret
    tb_p = torch.clamp((c.punt_tb_gate_ytg - ytg0) * c.r60, c.punt_tb_lo, c.punt_tb_hi)
    tb = (ytg0 <= c.punt_tb_gate_ytg) & (u[:, U_TB] < tb_p)
    net = torch.where(tb, ytg0 - c.punt_tb_own_spot, net)
    net = torch.trunc(_clip(net, c.punt_net_min, ytg0 - 1.0))
    punt_spot = torch.clamp(100.0 - (ytg0 - net), 1.0, 99.0)

    # ---- scrimmage play
    trip1 = scrim & ~s.in_rz & (ytg0 <= 20)
    heads = _packed_heads(args, dirx, sd, down0, dist0, ytg0, sec0, u)
    p_c, pass_ms, rush_ms, sack_ms, s2, p_f, p_ml = heads
    if walks is not None:
        read = exact_heads_read(args, down0, dist0, ytg0, sec0, sd, u, heads, force)
        walks += exact_walk_counts(args, read)
    s2c0, s2c1 = _stage2_pair(c, s2, down0, dist0)
    if p_f is None:
        p_f = torch.zeros_like(p_c)

    p_pass = _pass_prob_packed(c, down0, dist0, ytg0, sec0, sd)
    if p_ml is not None:
        p_pass = p_ml
    is_pass = scrim & (u[:, U_CALL] < p_pass)
    is_run = scrim & ~is_pass
    complete = is_pass & (u[:, U_COMPLETE] < p_c)
    notc = is_pass & ~complete
    u2 = u[:, U_S2]
    o_inc = notc & (u2 < s2c0)
    o_sck = notc & ~o_inc & (u2 < s2c1)
    o_int = notc & ~o_inc & ~o_sck

    pass_mu, pass_sg = pass_ms[:, 0], pass_ms[:, 1]
    if c.rz_pass_damping:
        rz_scale = torch.where(ytg0 < 15.0, 0.8 + 0.2 * (ytg0 * c.r15), 1.0)
        pass_mu = pass_mu * rz_scale
        pass_sg = torch.clamp_min(pass_sg * rz_scale, c.pass_sigma_floor)
    py_raw = pass_mu + pass_sg * n[:, N_YARDS]
    if c.taper_enabled:
        py_raw = _taper_packed(py_raw, c.pass_taper)
    yards_p = _clip(py_raw, c.pass_clip_lo, ytg0) * ymult
    ep = exp_base + torch.where(ytg0 > 60, c.explosive_bonus_60, 0.0)
    ep = torch.clamp(ep + torch.where(ytg0 > 40, c.explosive_bonus_40, 0.0),
                     c.explosive_lo, c.explosive_hi)

    def gain(yards, e, rz, tilt):
        """The explosive boost and the red-zone finish of one branch."""
        gate = (ytg0 > c.explosive_gate_ytg) & (u[:, U_EXP] < e[0] * ep)
        boost = e[1] + u[:, U_BOOST] * e[2]
        yards = torch.where(gate, torch.minimum(yards * (1.0 + boost * (1.0 + e[3] * mz)),
                                                ytg0), yards)
        prob = rz[1] + rz[2] * torch.clamp_min(7.0 - ytg0, 0.0) * c.r7
        prob = torch.clamp(prob + rz[3] * torch.clamp_min(4 - down0, 0) + tilt, rz[4], rz[5])
        finish = (ytg0 <= rz[0]) & (down0 <= 3) & (u[:, U_RZ] < prob)
        return torch.where(finish, ytg0, yards)

    yards_p = gain(yards_p, c.explosive_pass, c.rz_pass, tilt_pass)
    pass_td = complete & (yards_p + 1e-9 >= ytg0)
    pass_gain = complete & ~pass_td
    sy = torch.clamp(sack_ms[:, 0] + sack_ms[:, 1] * n[:, N_YARDS], c.sack_clip_lo,
                     c.sack_clip_hi)
    loss = torch.minimum(torch.clamp_min(-sy, 0.0), ytg0)
    ret = _clip(c.int_return_mean + c.int_return_sd * n[:, N_INT_RET], 0.0, ytg0)
    int_spot = 100.0 - (ytg0 - ret)
    ry_raw = rush_ms[:, 0] + rush_ms[:, 1] * n[:, N_YARDS]
    if c.taper_enabled:
        ry_raw = _taper_packed(ry_raw, c.rush_taper)
    yards_r = gain(_clip(ry_raw, c.rush_clip_lo, ytg0) * ymult, c.explosive_run, c.rz_run,
                   tilt_run)
    fum = is_run & (u[:, U_FUM] < p_f) if c.enable_fumbles else torch.zeros_like(is_run)
    run_active = is_run & ~fum
    run_td = run_active & (yards_r + 1e-9 >= ytg0)
    run_gain = run_active & ~run_td
    fum_spot_ytg = torch.clamp_min(ytg0 - _clip(yards_r, c.rush_clip_lo, ytg0), 0.0)

    # ---- phase a: pre-tick state updates
    adv = pass_gain | run_gain
    gained = torch.where(pass_gain, yards_p, 0.0) + torch.where(run_gain, yards_r, 0.0)
    ytg_a = torch.where(adv, torch.clamp_min(ytg0 - gained, 0.0), ytg0)
    first = adv & (gained + 1e-6 >= dist0)
    down_a = torch.where(adv, torch.where(first, 1, down0 + 1), down0)
    dist_a = torch.where(adv, torch.where(first, 10.0, dist0 - gained), dist0)
    downs_to = adv & ~first & (down_a > 4)
    ytg_a = torch.where(o_sck, ytg0 + loss, ytg_a)
    dist_a = torch.where(o_sck, dist0 + loss, dist_a)
    down_a = torch.where(o_sck | o_inc, down0 + 1, down_a)
    flip_a = downs_to | o_int | fum
    spot_a = torch.where(o_int, int_spot,
                         torch.where(fum, 100.0 - fum_spot_ytg, 100.0 - ytg_a))
    off_a = torch.where(flip_a, 1 - off, off)
    ytg_a = torch.where(flip_a, spot_a, ytg_a)
    down_a = torch.where(flip_a, 1, down_a)
    dist_a = torch.where(flip_a, 10.0, dist_a)
    in_rz_a = ~flip_a & (s.in_rz | trip1)

    # ---- phase b: tick (+ halftime flip)
    t = (fg_att * c.t_field_goal + punt * c.t_punt + pass_td * c.t_td_pass
         + pass_gain * c.t_pass_complete + o_inc * c.t_pass_incomplete
         + o_sck * c.t_sack + o_int * c.t_interception
         + (run_td | run_gain | fum) * c.t_run).to(I32)
    sec_b = torch.clamp_min(sec0 - t, 0)
    period_b = torch.where(
        sec_b > 0, 4 - torch.div(sec_b - 1, c.quarter_seconds, rounding_mode="floor"),
        4).to(I32)
    halftime = active & (period_b != s.period) & (period_b == 3)
    off_b = torch.where(halftime, 1 - off_a, off_a)
    ytg_b = torch.where(halftime, c.kickoff_spot, ytg_a)
    down_b = torch.where(halftime, 1, down_a)
    dist_b = torch.where(halftime, 10.0, dist_a)
    in_rz_b = ~halftime & in_rz_a

    # ---- phase c: post-tick possession flips
    flip_c = fg_good | fg_miss | punt | pass_td | run_td
    spot_c = torch.where(fg_miss, 100.0 - ytg0, torch.where(punt, punt_spot, c.kickoff_spot))
    ytg_c = torch.where(flip_c, spot_c, ytg_b)
    in_rz_c = ~flip_c & in_rz_b
    trip2 = run_gain & ~in_rz_c & (ytg_c <= 20)
    if collect_stats or collect_players:
        pass_yds = torch.where(pass_td, ytg0, torch.where(pass_gain, yards_p, 0.0))
        rush_yds = torch.where(run_td, ytg0, torch.where(run_gain, yards_r, 0.0))
        pass_att = complete | o_inc | o_int
        side_row = torch.arange(off.shape[0], device=off.device) * 2 + off
    if collect_stats:
        conv = go & (pass_td | run_td | (pass_gain & (yards_p + 1e-6 >= dist0))
                     | (run_gain & (yards_r + 1e-6 >= dist0)))
        cols = (scrim, pass_att, complete, pass_yds, pass_td, o_int, o_sck, is_run, rush_yds,
                run_td, fg_good, fg_att, punt, trip1.to(F32) + trip2.to(F32),
                run_td & (ytg0 <= 20), go, conv,
                torch.zeros_like(dist0),   # points: the final score, written after the loop
                fum)
        delta = torch.stack([v.to(F32) for v in cols], dim=1)
        s.stats.view(-1, N_TEAM_STATS).index_add_(0, side_row[active], delta[active])
    if collect_players:
        no = torch.zeros_like(dist0)
        roles = ((U_QB, is_pass, (pass_att, complete, pass_yds, pass_td, o_int, o_sck)),
                 (U_RB, is_run, (is_run, no, rush_yds, run_td, no, no)),
                 (U_WR, is_pass, (is_pass, complete, pass_yds, pass_td, no, no)))
        for r, (draw, involved, row) in enumerate(roles):
            slot = _sample_slot(args.slot_cum[r], dirx, u[:, draw])
            add = involved & args.slot_tracked[r].reshape(-1)[dirx.long() * args.k + slot]
            cell = (side_row * 3 + r) * args.k + slot
            delta = torch.stack([v.to(F32) for v in row], dim=1)
            s.pstats.view(-1, N_PLAYER_STATS).index_add_(0, cell[add], delta[add])

    pts = (pass_td | run_td) * c.td_points + fg_good * c.fg_points
    side = torch.stack([off == 0, off == 1], dim=1)
    return GameState(
        gid=s.gid, fo=s.fo, off=torch.where(flip_c, 1 - off_b, off_b).to(I32),
        sec=sec_b.to(I32), down=torch.where(flip_c, 1, down_b).to(I32),
        dist=torch.where(flip_c, 10.0, dist_b).to(F32), ytg=ytg_c.to(F32), period=period_b,
        in_rz=in_rz_c | trip2, going=~active & s.going,
        score=s.score + (side * pts[:, None]).to(I32), stats=s.stats, pstats=s.pstats)


def _taper_packed(y: torch.Tensor, t) -> torch.Tensor:
    """`_taper` on packed (t1, t2, r1, r2, t1 + (t2 - t1) * r1)."""
    mid = t[0] + (y - t[0]) * t[2]
    hi = t[4] + (y - t[1]) * t[3]
    return torch.where(y <= t[0], y, torch.where(y <= t[1], mid, hi))


def nano_game_plain(args: NanoGameArgs, s: GameState, key: int, row0: int = 0,
                    anti: bool = False,
                    draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    collect_players: bool = False, collect_stats: bool = False,
                    force: Optional[str] = None, force_key: Optional[int] = None,
                    force_draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    walks: Optional[torch.Tensor] = None) -> GameState:
    """K1's specification in plain torch, on the device of `s`: the packed
    inputs of `args`, one masked play of every game (`sec > 0`) at a time
    until no game is running or the cap.  Game b draws row row0 + b of
    (key, absolute step) (`step_draws`), or with `anti` row row0 / 2 + 2 (b
    // 4) + b % 2, mirrored where b % 4 >= 2; `draws`, a (steps, rows, 13)
    and a (steps, rows, 4) table, stands in for the stream (row r of step
    j for the launch's draw row r).  With `force` ('go', 'fg' or 'punt')
    every game first plays one masked play under that 4th-down decision on
    the same row of step 0 of `force_key` (or of `force_draws`, a (rows,
    13) and a (rows, 4) pair), whatever the cap and the run flag, as the
    4th-down evaluator's eager composition plays it; the plays after it
    draw from step 0 of `key`.  As the eager loop, it plays at all only
    where some game is running or early_exit is off.  The collectors add
    to `s.stats` and `s.pstats` in place, as the eager loop does, and
    `points` takes the final score.  In exact mode `walks`, an
    (n_forests,) int64 tensor, has the (row, tree) walks of K1's phases
    added to it (`exact_heads_read`), as `nano_game_cuda`'s `walks`; the
    plain version itself walks every forest."""
    c = args.consts
    dev = s.sec.device
    n = s.off.shape[0]
    rows = n // 2 if anti else n
    r0 = row0 // 2 if anti else row0
    go = _go_tables(c, dev)
    coll = (collect_players, collect_stats)
    if force is not None:
        u, z = (step_draws(force_key, 0, rows, dev, row0=r0) if force_draws is None
                else force_draws)
        if anti:
            u, z = mirror_draws(u, z)
        s = _nano_play(args, go, s, u, z, *coll, force=_force_code(force), walks=walks)
    cap = c.cap if draws is None else min(c.cap, draws[0].shape[0])
    if not args.early_exit or bool((s.sec > 0).any()):
        for j in range(cap):
            if j and not bool((s.sec > 0).any()):
                break      # every game ended: the rest of the loop is a fixed point
            u, z = (step_draws(key, j, rows, dev, row0=r0) if draws is None
                    else (draws[0][j], draws[1][j]))
            if anti:
                u, z = mirror_draws(u, z)
            s = _nano_play(args, go, s, u, z, *coll, force=args.layout.force_every, walks=walks)
    if collect_stats:
        s.stats[:, :, TS["points"]] = s.score.to(F32)
    return s


# nano_game_launch's parameters in csrc/nano_game.cu, in order
_NANO_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,    # consts, table, dirs, G
     ctypes.c_void_p, ctypes.c_void_p,                                   # in, out
     ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int,    # k0, k1, r0, anti
     ctypes.c_void_p, ctypes.c_void_p,                                   # run_flag, work
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,                  # plays, iters, game_plays
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # stats, pstats, cum,
     ctypes.c_int,                                                       # tracked, k
     ctypes.c_int, ctypes.c_void_p,                                      # layout, lay
     ctypes.c_int, ctypes.c_int, ctypes.c_void_p])                       # n, blocks, stream


@functools.lru_cache(maxsize=None)
def _nano_lib():
    from ..utils.cuda_build import load_kernel_library

    lib = load_kernel_library(_KERNEL)
    for name, cls in (("nano_game_consts_size", NanoConsts),
                      ("nano_game_layout_size", LayoutConsts)):
        size = getattr(lib, name)
        size.argtypes, size.restype = [], ctypes.c_int
        if size() != ctypes.sizeof(cls):
            raise RuntimeError(f"{cls.__name__} is {size()} bytes in nano_game.cu, "
                               f"{ctypes.sizeof(cls)} in ops/game.py")
    lib.nano_game_launch.argtypes = _NANO_ARGTYPES
    lib.nano_game_launch.restype = ctypes.c_int
    lib.nano_game_threads.argtypes, lib.nano_game_threads.restype = [], ctypes.c_int
    lib.nano_game_blocks_per_sm.argtypes = [ctypes.c_int] * 4
    lib.nano_game_blocks_per_sm.restype = ctypes.c_int
    lib.nano_game_attributes.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    lib.nano_game_attributes.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def nano_geometry(index: int, collect_stats: bool = False, collect_players: bool = False,
                  kind: int = 0, slot_entries: int = 0) -> Tuple[int, int]:
    """(blocks of K1's instantiation for the layout `kind` (a LAYOUT_KINDS
    index) and these collectors that card `index` holds at once, threads a
    block): the occupancy API's blocks an SM times the SMs, asked once a
    card, instantiation and size of the slot tables (`slot_entries`, the
    shares a launch with the player stats copies into shared memory)."""
    lib = _nano_lib()
    with torch.cuda.device(index):
        per_sm = lib.nano_game_blocks_per_sm(kind, int(collect_stats), int(collect_players),
                                             slot_entries)
    if per_sm <= 0:
        raise RuntimeError(f"nano_game occupancy query failed: CUDA error {-per_sm}")
    return (per_sm * torch.cuda.get_device_properties(index).multi_processor_count,
            lib.nano_game_threads())


def nano_game_usage(kind: int, collect_stats: bool = False,
                    collect_players: bool = False) -> Tuple[int, int]:
    """(registers a thread, local-memory bytes a thread: spills and local
    arrays) of K1's instantiation for the layout `kind` and the
    collectors, as the runtime reports them for the current card."""
    lib = _nano_lib()
    regs, local = ctypes.c_int(), ctypes.c_int()
    err = lib.nano_game_attributes(kind, int(collect_stats), int(collect_players),
                                   ctypes.byref(regs), ctypes.byref(local))
    if err != 0:
        raise RuntimeError(f"nano_game attribute query failed: CUDA error {err}")
    return regs.value, local.value


def nano_grid(n: int, resident_blocks: int, threads: int) -> int:
    """K1's blocks for n games: the persistent grid, as many blocks of
    `threads` as the card holds at once (`resident_blocks`), and no more
    than n games fill."""
    return max(1, min(resident_blocks, -(-n // threads)))


# each stream's work counter (2 uint32: games handed out, blocks done),
# which K1 leaves at 0 after every launch
_NANO_WORK: dict = {}


def _nano_work(dev: torch.device, stream: int) -> torch.Tensor:
    key = (dev.index, stream)
    if key not in _NANO_WORK:
        _NANO_WORK[key] = torch.zeros(2, dtype=torch.int32, device=dev)
    return _NANO_WORK[key]


# the state fields K1 reads, in the launcher's order, and their dtypes
_NANO_IN = (("gid", I32), ("off", I32), ("sec", I32), ("down", I32), ("dist", F32),
            ("ytg", F32), ("period", I32), ("in_rz", torch.bool), ("going", torch.bool),
            ("score", I32))


def _launch_layout(args: NanoGameArgs, dev: torch.device, force: Optional[str],
                   force_key: Optional[int]) -> LayoutConsts:
    """A copy of `args.layout` with the tables' pointers and the forced
    play set, after checking the tables K1 reads past the nano layout."""
    lay = LayoutConsts.from_buffer_copy(args.layout)
    lay.force_first = _force_code(force)
    if force is not None:
        if force_key is None:
            raise ValueError("a forced first play needs its stream's key (force_key)")
        lay.fk0, lay.fk1 = force_key & 0xFFFFFFFF, (force_key >> 32) & 0xFFFFFFFF
    tables = [(f"{name} values", t[0], F32) for name, t in zip(HEAD_TABLES, args.heads)
              if t is not None] + [(f"{name} row map", t[1], I32)
                                   for name, t in zip(HEAD_TABLES, args.heads) if t is not None]
    if args.play is not None:
        tables += [("play values", args.play, F32), ("play rows", args.play_base, torch.int64)]
    if args.xdirs is not None:
        tables.append(("direction floats", args.xdirs, F32))
    if args.exact is not None:
        ex = args.exact
        tables += [("forest records", ex.records, I32), ("forest tiles", ex.tiles, I32),
                   ("forests", ex.forests, I32), ("id tables", args.ids, I32)]
        if ex.records.data_ptr() % 16:
            raise ValueError("the forest records must be 16-byte aligned (K1 copies tiles of "
                             "them by cp.async.bulk)")
    for what, t, dtype in tables:
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"the {what} must be a contiguous {dtype} tensor on {dev}, got "
                             f"{t.dtype} on {t.device}")
    for i, t in enumerate(args.heads):
        if t is not None:
            lay.heads[i].values, lay.heads[i].row_map = t[0].data_ptr(), t[1].data_ptr()
    if args.play is not None:
        lay.play, lay.play_base = args.play.data_ptr(), args.play_base.data_ptr()
    if args.xdirs is not None:
        lay.xdirs = args.xdirs.data_ptr()
    if args.exact is not None:
        ex = args.exact
        lay.recs, lay.tiles = ex.records.data_ptr(), ex.tiles.data_ptr()
        lay.forests, lay.ids = ex.forests.data_ptr(), args.ids.data_ptr()
    return lay


def nano_kind(args: NanoGameArgs, force: Optional[str] = None, collect_players: bool = False,
              collect_stats: bool = False) -> int:
    """The LAYOUT_KINDS index of K1's instantiation for a launch: the
    layout's (`args.kind`; a forced first play on the nano layout takes the
    one-row one); a score-only one-row launch with at most one of the play
    table and a forced first play takes the one-row layout of its own,
    those options fixed at compile time."""
    kind = LAYOUT_KINDS[args.kind]
    if force is not None and kind == "nano":
        kind = "row"
    play = args.play is not None
    if kind == "row" and not (collect_players or collect_stats) and not (play and force):
        kind = "row play" if play else "row forced" if force else "row bare"
    return LAYOUT_KINDS.index(kind)


def nano_game_cuda(args: NanoGameArgs, s: GameState, key: int, row0: int = 0,
                   anti: bool = False, plays: Optional[torch.Tensor] = None,
                   iters: Optional[torch.Tensor] = None,
                   game_plays: Optional[torch.Tensor] = None, collect_players: bool = False,
                   collect_stats: bool = False, force: Optional[str] = None,
                   force_key: Optional[int] = None,
                   walks: Optional[torch.Tensor] = None) -> GameState:
    """K1 on the card: the games of `s` to their end in one launch of
    csrc/nano_game.cu on the current stream, drawing as `nano_game_plain`
    draws (the forced first play with `force` on `force_key`'s stream
    too), with the collectors asked for added in place to `s.stats` and
    `s.pstats` (contiguous f32 of the collectors' shapes, K = args.k
    slots).  The instantiation is `nano_kind`'s.  Raises ValueError for
    tensors off the card (the CPU runs `nano_game_plain`) or of another
    dtype or shape, and RuntimeError where the kernel does not build or
    launch.  `plays` and `iters`, (1,) int64 tensors on the card, have the
    games' plays (the forced one included) and the warps' loop trips added
    to them (plays / (32 x iters) is the share of lanes that played);
    `game_plays`, an (n,) int32 tensor, is given each game's plays; in
    exact mode `walks`, an (n_forests,) int64 tensor, has each forest's
    (row, tree) walks added to it (K1's phases: `exact_heads_read`).
    `nano_game_cuda.launches` counts kernel launches and nothing else;
    `launches_collecting` those with a collector on, `launches_fused` and
    `launches_per_head` those on those table layouts, `launches_play` those
    reading the play-policy table, `launches_forced` those with a forced
    first play, `launches_compiled` those of the score-only one-row
    layouts whose options are fixed at compile time, `launches_exact` and
    `launches_analytic` those of exact mode's forests and of the analytic
    heads."""
    n = s.off.shape[0]
    dev = s.sec.device
    collected = ([("stats", s.stats, (n, 2, N_TEAM_STATS))] if collect_stats else []) + (
        [("pstats", s.pstats, (n, 2, 3, args.k, N_PLAYER_STATS))] if collect_players else [])
    per_head = args.table_layout == "per_head"
    exact = args.table_layout == "exact"
    with_cum = collect_players or per_head or exact
    tensors = ([getattr(s, f) for f, _ in _NANO_IN] + [args.table, args.dirs]
               + [t for _, t, _ in collected]
               + ([args.slot_cum] if with_cum else [])
               + ([args.slot_tracked] if collect_players else []))
    if any(t.device != dev for t in tensors) or dev.type != "cuda":
        raise ValueError("nano_game_cuda takes a state and packed inputs on one CUDA "
                         f"device; got {sorted({str(t.device) for t in tensors})} "
                         "(the CPU runs nano_game_plain)")
    ins = []
    for f, dtype in _NANO_IN:
        t = getattr(s, f)
        want = (n, 2) if f == "score" else (n,)
        if t.dtype != dtype or tuple(t.shape) != want:
            raise ValueError(f"state field {f} must be {dtype} of shape {want}; "
                             f"got {t.dtype} {tuple(t.shape)}")
        ins.append(t.contiguous())
    if args.table.dtype != F32 or args.dirs.dtype != F32 or not args.table.is_contiguous():
        raise ValueError("the table and the direction constants must be contiguous f32")
    if walks is not None and not exact:
        raise ValueError("walks are counted in exact mode only")
    n_forests = args.exact.forests.shape[0] if exact else 0
    for name, t, dtype, shape in (("plays", plays, torch.int64, (1,)),
                                  ("iters", iters, torch.int64, (1,)),
                                  ("game_plays", game_plays, I32, (n,)),
                                  ("walks", walks, torch.int64, (n_forests,)),
                                  *[(name, t, F32, shape) for name, t, shape in collected]):
        if t is not None and (t.dtype != dtype or t.device != dev or tuple(t.shape) != shape
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {dtype} tensor of shape {shape} "
                             f"on {dev}")
    if collect_players and s.pstats.data_ptr() % 8:
        raise ValueError("pstats must be 8-byte aligned (K1 adds a player row as 8-byte words)")
    if with_cum and (args.slot_cum.dtype != F32 or args.slot_tracked.dtype != torch.bool
                     or tuple(args.slot_cum.shape) != (3, args.dirs.shape[0], args.k)
                     or args.slot_tracked.shape != args.slot_cum.shape
                     or not (args.slot_cum.is_contiguous()
                             and args.slot_tracked.is_contiguous())):
        raise ValueError("the slot tables must be contiguous (3, 2G, K) f32 shares and bool "
                         "tracked flags")
    if anti and (n % 4 or row0 % 4):
        raise ValueError(f"antithetic draws for games {row0}..{row0 + n - 1} split a "
                         "mirrored block of four")
    rows, r0 = (n // 2, row0 // 2) if anti else (n, row0)
    if r0 < 0 or r0 + rows > 2 ** 32:
        raise ValueError(f"draw rows {r0}..{r0 + rows - 1} outside the 32-bit row counter")
    lay = _launch_layout(args, dev, force, force_key)
    if walks is not None:
        lay.walks = walks.data_ptr()
    kind = nano_kind(args, force, collect_players, collect_stats)
    if n == 0:
        return s
    outs = [torch.empty_like(t) for t in ins[1:]]
    # after a forced play every further masked step of an ended game is a
    # fixed point, so whether the loop runs at all matters only unforced
    run_flag = (ins[2] > 0).any() if args.early_exit and force is None else None
    lib = _nano_lib()
    entries = args.slot_cum.numel() if collect_players else 0
    blocks = nano_grid(n, *nano_geometry(dev.index, collect_stats, collect_players, kind, entries))

    def ptrs(ts):
        return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nano_game_launch(
            ctypes.addressof(args.consts), args.table.data_ptr(), args.dirs.data_ptr(),
            args.dirs.shape[0] // 2, ptrs(ins), ptrs(outs), key & 0xFFFFFFFF,
            (key >> 32) & 0xFFFFFFFF, r0, int(anti), ptr(run_flag),
            _nano_work(dev, stream).data_ptr(), ptr(plays), ptr(iters), ptr(game_plays),
            ptr(s.stats if collect_stats else None), ptr(s.pstats if collect_players else None),
            ptr(args.slot_cum if with_cum else None),
            ptr(args.slot_tracked if collect_players else None), args.k, kind,
            ctypes.addressof(lay), n, blocks, stream)
    if err != 0:
        raise RuntimeError(f"nano_game kernel launch failed: CUDA error {err}")
    f = nano_game_cuda
    f.launches += 1
    f.launches_collecting += collect_players or collect_stats
    f.launches_fused += args.table_layout == "fused"
    f.launches_per_head += per_head
    f.launches_play += args.play is not None
    f.launches_forced += force is not None
    f.launches_compiled += kind in range(LAYOUT_KINDS.index("row bare"), _FREE_KINDS[0])
    f.launches_exact += exact
    f.launches_analytic += args.table_layout == "analytic"
    off, sec, down, dist, ytg, period, in_rz, going, score = outs
    return GameState(gid=s.gid, fo=s.fo, off=off, sec=sec, down=down, dist=dist, ytg=ytg,
                     period=period, in_rz=in_rz, going=going, score=score, stats=s.stats,
                     pstats=s.pstats)


# the launch counts (`nano_game_cuda`'s docstring), set to 0 by the smoke
NANO_COUNTERS = ("launches", "launches_collecting", "launches_fused", "launches_per_head",
                 "launches_play", "launches_forced", "launches_compiled", "launches_exact",
                 "launches_analytic")
for _name in NANO_COUNTERS:
    setattr(nano_game_cuda, _name, 0)


def nano_game(args: NanoGameArgs, s: GameState, key: int, row0: int = 0,
              anti: bool = False, collect_players: bool = False,
              collect_stats: bool = False, force: Optional[str] = None,
              force_key: Optional[int] = None) -> GameState:
    """K1: the games of `s` played to their end from the packed inputs
    (`pack_nano_game`), game b drawing row row0 + b of (key, absolute step)
    (antithetic: `nano_game_plain`), after a first play under `force` on
    `force_key`'s stream where `force` is given, the collectors asked for
    added in place to `s.stats` and `s.pstats`.  A state on the card
    launches the kernel (`nano_game_cuda`), one on the CPU runs
    `nano_game_plain`."""
    dev = s.sec.device
    kw = dict(collect_players=collect_players, collect_stats=collect_stats, force=force,
              force_key=force_key)
    if dev.type == "cuda":
        return nano_game_cuda(args, s, key, row0, anti, **kw)
    if dev.type == "cpu":
        return nano_game_plain(args, s, key, row0, anti, **kw)
    raise ValueError(f"nano_game: unsupported device {dev}")

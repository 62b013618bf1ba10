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
kernel on the card) and the table heads of `ops/table_lookup.py`.

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
package's 1-element dummy.

Game state keeps the JAX package's int32/f32/bool dtypes; indices are cast
to int64 only where they index.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..config import SimConfig
from ..models import analytic
from ..models.heads import ST1_FEATURES
from ..stats import (N_PLAYER_STATS, N_TEAM_STATS, ROLE_PASS, ROLE_REC, ROLE_RUSH,
                     TEAM_STAT_FIELDS, TS)
from .forest_eval import eval_margin, predict
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


def make_analytic_heads_eval(cfg: SimConfig) -> HeadsEvalFn:
    """Artifact-free heads: smooth closed-form stand-ins for every model
    head (clearly NOT the reference models).  heads_state is unused."""

    def heads_eval(heads_state, obs: StepObs, pack: MatchupPack) -> HeadOut:
        bias = take_dir(pack.bias, obs.dirx)
        p_c = torch.clamp(
            0.68 - 0.022 * torch.clamp_min(obs.dist - 3.0, 0.0) + bias,
            cfg.model.stage1_clip_lo, cfg.model.stage1_clip_hi)
        inc, itc, sck = analytic.stage2_fallback_probs(
            obs.down.to(F32), obs.dist, cfg)
        inc, itc, sck = analytic.stage2_nudge(inc, itc, sck, cfg)
        s2_cum = torch.stack([inc, inc + sck], dim=1)

        def ms(mu, sigma):
            return torch.stack([mu if torch.is_tensor(mu)
                                else torch.full_like(obs.dist, mu),
                                torch.full_like(obs.dist, sigma)], dim=1)

        return HeadOut(p_c, s2_cum, ms(4.5 + 0.45 * obs.dist, 7.0),
                       ms(4.2, 4.0), ms(-6.0, 2.2),
                       torch.full_like(obs.dist, 0.012), None)

    heads_eval.needs_x = False
    return heads_eval


def _gather2k(arr2k: torch.Tensor, dirx: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """A (2G, K) per-direction, per-slot field at (dirx, slot) per trial."""
    k = arr2k.shape[1]
    return arr2k.reshape(-1)[(dirx.long() * k + slot.long()).clamp(0, arr2k.numel() - 1)]


def make_exact_heads_eval(cfg: SimConfig) -> HeadsEvalFn:
    """Exact mode: every compiled forest evaluated on each play's feature
    rows (`eval_margin`: the K5 kernel on the card).  heads_state is a
    HeadsPack; each forest is walked on its own (the JAX package's
    default; its merged walk, `exact_merged`, is not ported)."""

    def heads_eval(hp: HeadsPack, obs: StepObs, pack: MatchupPack) -> HeadOut:
        x, off, qb, wr, rb = obs.x, obs.dirx, obs.qb, obs.wr, obs.rb
        p_raw = predict(hp.stage1, x, {"passer_name": _gather2k(pack.ids_qb_stage1, off, qb)})
        p_c = torch.clamp(p_raw + take_dir(pack.bias, off),
                          cfg.model.stage1_clip_lo, cfg.model.stage1_clip_hi)
        if hp.stage2 is not None:
            probs = predict(hp.stage2, x, {
                "passer_name": _gather2k(pack.ids_qb_stage2, off, qb),
                "target_name": _gather2k(pack.ids_wr_stage2, off, wr),
            })
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

        pass_ms = ms(hp.pq, {"passer_name": _gather2k(pack.ids_qb_passq, off, qb),
                             "target_name": _gather2k(pack.ids_wr_passq, off, wr)},
                     cfg.model.pass_sigma_floor)
        rush_ms = ms(hp.rq, {"rusher_name": _gather2k(pack.ids_rb_rushq, off, rb)},
                     cfg.model.rush_sigma_floor)
        sack_ms = ms(hp.sq, {"passer_name": _gather2k(pack.ids_qb_sackq, off, qb)},
                     cfg.model.sack_sigma_floor)
        if hp.fumble is not None and cfg.model.enable_fumbles:
            p_f = predict(hp.fumble, x, {"rusher_name": _gather2k(pack.ids_rb_fumble, off, rb)})
        else:
            p_f = torch.zeros_like(p_c)
        p_pass_ml = None
        if hp.play is not None and cfg.model.use_play_model:
            p_pass_ml = _play_pass_prob(hp, x, take_dir(pack.coach_id, off), cfg)
        return HeadOut(p_c, s2_cum, pass_ms, rush_ms, sack_ms, p_f, p_pass_ml)

    heads_eval.needs_x = True  # full ST1 feature rows feed the forests
    return heads_eval


def _play_pass_prob(hp: HeadsPack, x: torch.Tensor, coach: torch.Tensor, cfg: SimConfig):
    """P(pass) of the ML play head: its numerics picked from the ST1 rows,
    softmax at the play temperature, a 5-class head reduced to
    P(pass) / (P(pass) + P(run)), clipped."""
    tf = hp.play
    cols = [ST1_FEATURES.index(n) for n in tf.numeric_names]
    m = eval_margin(tf, x[:, cols].contiguous(), {"head_coach": coach})
    p = torch.softmax(m / max(1e-6, hp.play_temperature), dim=1)
    p_pass = p[:, hp.play_pass_idx]
    if hp.play_run_idx >= 0:
        p_pass = p_pass / torch.clamp_min(p_pass + p[:, hp.play_run_idx], 1e-9)
    return torch.clamp(p_pass, cfg.model.play_clip_lo, cfg.model.play_clip_hi)


def _state_features(pack: MatchupPack, cfg: SimConfig, dirx, down, dist, ytg, sec, sd):
    """(B, 17) f32 ST1 feature rows of the play-start state, the JAX
    package's column for column."""
    half_s = cfg.clock.half_seconds
    sec_f = sec.to(F32)
    sp = take_dir(pack.sp, dirx)   # (B, 4)
    cols = [
        down.to(F32), dist, ytg,
        (ytg <= 20).to(F32),
        sd.to(F32), sec_f,
        torch.full_like(sec_f, cfg.timeouts), torch.full_like(sec_f, cfg.timeouts),
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
    with the collectors' shapes, overrides both (the 4th-down evaluator
    plays one forced play, then continues here).  Either way the draws
    start at absolute step 0.

    Plays run in chunks of `play_chunk`; before each chunk the host asks
    once whether any game is still running (with early_exit), as the JAX
    package's while_loop cond does, so resumed late-game states stop after
    a chunk or two.  Draws come from the Philox kernel, keyed on (key,
    absolute step, row): with rng_impl "pallas_chunk", "threefry" or "rbg"
    one launch fills the chunk's whole draw buffer, allocated once per
    call; with "pallas" one launch per play.  The JAX package's threefry
    and rbg generators are not reproduced: their names map onto this one
    stream, which per-step and chunked launches draw alike, so the four
    names play the same games for one key.  With engine.antithetic and
    n % 4 == 0 a launch draws n/2 rows, which each play mirrors as the
    JAX step does.  With collect_stats the final score is written into the
    `points` column after the loop."""
    rng = cfg.engine.rng_impl
    if rng not in RNG_IMPLS:
        raise ValueError(f"rng_impl must be one of {RNG_IMPLS}, got {rng!r}")
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
    rows = n // 2 if anti else n
    r0 = row0 // 2 if anti else row0
    ch = cfg.engine.play_chunk
    n_chunks = -(-cfg.engine.max_plays // ch)
    buf = None
    if rng != "pallas":
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

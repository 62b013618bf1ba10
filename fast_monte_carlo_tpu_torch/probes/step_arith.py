"""Fused play-step probe: port of benchmarks/pallas_step_arith.py.

One play step's arithmetic, score-only: analytic (or table-fed) heads plus
the state machine, over nine flat `(B,)` state tensors (`STATE_FIELDS`).
`step_arith` is the port of `rep_arith`; it is plain torch on any device and
the specification of the two kernels of `csrc/fused_step.cu`:

  fused_step      B1: `ch` steps per launch, one thread per game, state in
                  registers, 13 u + 4 n drawn in the kernel from Philox keyed
                  on (key, absolute step, row) as `ops/rng` draws them
                  (`ch=1` is `_kernel_step`, `ch=24` is `_kernel_chunk`)
  fused_step_tab  B2: one step with the 7 head vectors given as inputs
                  (`_kernel_step_tab`); the row gather and channel select
                  (`table_select`) stay in torch, as they stay in XLA there

The TPU kernels draw from the chip's hardware PRNG, so the port matches the
JAX probe in distribution only; the kernels match `step_arith` fed the same
Philox draws exactly on integer state.  The `(B/128, 128)` state tiling of
the Pallas kernels is a Mosaic constraint and is not ported.

Five structures, each returning final (score_a, score_b):

  eager          per step, the Philox kernel then plain `step_arith` (the
                 counterpart of `xla-rbg`)
  fused-step     B1, one launch per step
  fused-chunk24  B1, one launch per 24 steps
  eager-tab      `table_select` + plain `step_arith` with heads
  hybrid-tab     `table_select` in torch, then B2 per step

    python -m fast_monte_carlo_tpu_torch.probes.step_arith [B] [STEPS] [--device cuda|cpu]

prints, per structure (best of 3 timed runs), ms/step, eq-games/s, mean
scores, side-A win rate and the speed-up over `eager`.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import math
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..config import SimConfig
from ..models import analytic
from ..ops import rng

B_DEFAULT = 131072
STEPS_DEFAULT = 360
CH = 24                       # production play_chunk
STATE_FIELDS = ("off", "sec", "down", "dist", "ytg", "period", "in_rz",
                "score_a", "score_b")
_I32, _F32 = torch.int32, torch.float32
STATE_DTYPES = (_I32, _I32, _I32, _F32, _F32, _I32, _I32, _I32, _I32)
R_DIR = 8192                  # nano rows per direction (16 dist x 32 ytg x 16 sec)
N_SD = 3
N_HC = 7                      # p_c, pass (mu, sg), rush (mu, sg), sack (mu, sg)
N_CH = 5 * N_SD * N_HC
STRUCTURES = ("eager", "fused-step", "fused-chunk24", "eager-tab", "hybrid-tab")
CFG = SimConfig()

State = Tuple[torch.Tensor, ...]


# ---------------------------------------------------------------------------
# state and table
# ---------------------------------------------------------------------------

def init_state(b: int, device) -> State:
    """Kick-off state of b games, alternating the first offense."""
    dev = resolve_device(device)
    return (torch.arange(b, dtype=_I32, device=dev) % 2,
            torch.full((b,), 3600, dtype=_I32, device=dev),
            torch.ones(b, dtype=_I32, device=dev),
            torch.full((b,), 10.0, dtype=_F32, device=dev),
            torch.full((b,), 75.0, dtype=_F32, device=dev),
            torch.ones(b, dtype=_I32, device=dev),
            torch.zeros(b, dtype=_I32, device=dev),
            torch.zeros(b, dtype=_I32, device=dev),
            torch.zeros(b, dtype=_I32, device=dev))


def state_from_numpy(arrays: Sequence[np.ndarray], device) -> State:
    """Nine host arrays in `STATE_FIELDS` order (the JAX probe's state
    tuple) as the port's state on `device`."""
    if len(arrays) != len(STATE_FIELDS):
        raise ValueError(f"state has {len(STATE_FIELDS)} fields, got {len(arrays)}")
    dev = resolve_device(device)
    out = tuple(torch.from_numpy(np.array(a).reshape(-1)).to(dev, dt)
                for a, dt in zip(arrays, STATE_DTYPES))
    if len({t.shape for t in out}) != 1:
        raise ValueError(f"state fields differ in length: {[t.shape for t in out]}")
    return out


def table_from_numpy(values: np.ndarray, device) -> torch.Tensor:
    """A `(2 * R_DIR, N_CH)` host table (the JAX probe's `make_table`) as an
    f32 tensor on `device`."""
    v = np.array(values, np.float32)
    if v.shape != (2 * R_DIR, N_CH):
        raise ValueError(f"table must be {(2 * R_DIR, N_CH)}, got {v.shape}")
    return torch.from_numpy(v).to(resolve_device(device))


def make_table(device) -> torch.Tensor:
    """The probe's seeded table, by the recipe of pallas_step_arith.py:333."""
    rng_np = np.random.default_rng(7)
    base = np.tile(np.array([0.62, 7.0, 7.0, 4.2, 4.0, -6.0, 2.2], np.float32),
                   5 * N_SD)
    t = base[None, :] + rng_np.normal(0, 0.05, (2 * R_DIR, N_CH)).astype(np.float32)
    return table_from_numpy(t, device)


def table_select(values: torch.Tensor, off, sec, down, dist, ytg, sd) -> List[torch.Tensor]:
    """The 7 head vectors of each game: bins, one row of `values`, then the
    down and score-diff channel select (pallas_step_arith.py:341).  Rounding
    is half to even, as `jnp.round`; row indices clip to the table."""
    di = torch.clamp(torch.round(dist * 0.5), 0, 15).to(_I32)
    yi = torch.clamp(torch.round(ytg * 0.32), 0, 31).to(_I32)
    si = torch.clamp(sec // 240, 0, 15).to(_I32)
    row = torch.clamp(off * R_DIR + (di * 32 + yi) * 16 + si, 0, values.shape[0] - 1)
    down_i = torch.clamp(down - 1, 0, 4)
    sdi = torch.clamp(torch.div(sd + 21.0, 14.0, rounding_mode="floor"), 0, 2).to(_I32)
    sel = values.view(-1, 5, N_SD, N_HC)[row.long(), down_i.long(), sdi.long()]
    return [sel[:, i] for i in range(N_HC)]


def heads_of(state: State, values: torch.Tensor) -> List[torch.Tensor]:
    off, sec, down, dist, ytg = state[:5]
    sd = (state[7] - state[8]).to(_F32) * torch.where(off == 0, 1.0, -1.0)
    return table_select(values, off, sec, down, dist, ytg, sd)


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _i(x: torch.Tensor) -> torch.Tensor:
    return x.to(_I32)


def step_arith(state: State, u: torch.Tensor, z: torch.Tensor,
               heads: Optional[Sequence[torch.Tensor]] = None) -> State:
    """One play step (port of `rep_arith`, pallas_step_arith.py:72).
    `u` is (B, 13) uniforms, `z` (B, 4) normals; `heads` the 7 head vectors
    of `table_select`, or None for the analytic stand-ins."""
    cfg = CFG
    off, sec, down, dist, ytg, period, in_rz_i, sa, sb = state
    active = sec > 0
    in_rz = in_rz_i != 0
    is_a = off == 0
    sd = (sa - sb).to(_F32) * torch.where(is_a, 1.0, -1.0)

    # per-direction constants
    off_o = torch.where(is_a, 35.7, 31.5)
    def_d = torch.where(is_a, 20.6, 20.0)
    ymult = torch.where(is_a, 1.01, 0.99)
    mz = torch.where(is_a, 0.11, -0.11)
    bias = torch.where(is_a, 0.013, -0.013)

    if heads is None:
        p_c = torch.clamp(0.68 - 0.022 * torch.clamp_min(dist - 3.0, 0.0) + bias,
                          0.02, 0.98)
        pass_mu = 4.5 + 0.45 * dist
        pass_sg, rush_mu, rush_sg, sack_mu, sack_sg = 7.0, 4.2, 4.0, -6.0, 2.2
    else:
        p_c, pass_mu, pass_sg, rush_mu, rush_sg, sack_mu, sack_sg = heads
    inc, itc, sck = analytic.stage2_fallback_probs(down.to(_F32), dist, cfg)
    inc, itc, sck = analytic.stage2_nudge(inc, itc, sck, cfg)
    s2c1, s2c2 = inc, inc + sck
    p_pass = analytic.pass_prob_v1(down, dist, ytg, sec, sd, cfg)
    p_go = torch.clamp_max(analytic.go_for_it_prob(ytg, dist, sd, sec, cfg)
                           * cfg.fourth.go_multiplier, 1.0)
    p_fg = analytic.field_goal_prob(ytg + 17.0, cfg)
    ep = analytic.explosive_prob(ytg, off_o, def_d, cfg)
    rzp = analytic.rz_finish_prob_pass(ytg, down, off_o, def_d, cfg)
    rzr = analytic.rz_finish_prob_run(ytg, down, off_o, def_d, cfg)

    # state machine, score-only
    is4 = down == 4
    go = active & is4 & (u[:, 0] < p_go)
    st_play = active & is4 & ~go
    fg_att = st_play & (ytg <= 38.0)
    punt = st_play & ~fg_att
    scrim = active & ~st_play
    fg_good = fg_att & (u[:, 1] < p_fg)
    fg_miss = fg_att & ~fg_good
    gross = torch.clamp_min(43.0 + 6.0 * z[:, 0], 30.0)
    pret = torch.clamp_min(6.0 + 3.0 * z[:, 1], 0.0)
    net = gross - pret
    tb_p = torch.clamp((60.0 - ytg) * analytic.recip(60.0), 0.10, 0.55)
    tb = (ytg <= 60.0) & (u[:, 2] < tb_p)
    net = torch.where(tb, ytg - 25.0, net)
    # clip(net, 15, ytg - 1) gives ytg - 1 where that is below 15
    net = torch.floor(torch.minimum(torch.clamp_min(net, 15.0), ytg - 1.0))
    punt_spot = torch.clamp(100.0 - (ytg - net), 1.0, 99.0)
    trip1 = scrim & ~in_rz & (ytg <= 20)
    is_pass = scrim & (u[:, 3] < p_pass)
    is_run = scrim & ~is_pass
    complete = is_pass & (u[:, 7] < p_c)
    notc = is_pass & ~complete
    o_inc = notc & (u[:, 11] < s2c1)
    o_sck = notc & ~o_inc & (u[:, 11] < s2c2)
    o_int = notc & ~o_inc & ~o_sck
    py = torch.minimum(torch.clamp_min(pass_mu + pass_sg * z[:, 2], 0.0), ytg) * ymult
    expg = (ytg > 25.0) & (u[:, 8] < 0.6 * ep)
    boost = 0.35 + u[:, 9] * 0.6
    py = torch.where(expg, torch.minimum(py * (1 + boost * (1 + 0.5 * mz)), ytg), py)
    rz_p = (ytg <= 12.0) & (down <= 3) & (u[:, 10] < rzp)
    py = torch.where(rz_p, ytg, py)
    pass_td = complete & (py + 1e-9 >= ytg)
    pass_gain = complete & ~pass_td
    sy = torch.clamp(sack_mu + sack_sg * z[:, 2], -20.0, 0.0)
    loss = torch.minimum(torch.clamp_min(-sy, 0.0), ytg)
    ret = torch.minimum(torch.clamp_min(6.0 + 5.0 * z[:, 3], 0.0), ytg)
    int_spot = 100.0 - (ytg - ret)
    ry = torch.minimum(torch.clamp_min(rush_mu + rush_sg * z[:, 2], -4.0), ytg) * ymult
    expr = (ytg > 25.0) & (u[:, 8] < 0.5 * ep)
    ry = torch.where(expr, torch.minimum(ry * (1 + boost), ytg), ry)
    rz_r = (ytg <= 9.0) & (down <= 3) & (u[:, 10] < rzr)
    ry = torch.where(rz_r, ytg, ry)
    run_td = is_run & (ry + 1e-9 >= ytg)
    run_gain = is_run & ~run_td
    adv = pass_gain | run_gain
    gained = torch.where(pass_gain, py, 0.0) + torch.where(run_gain, ry, 0.0)
    ytg_a = torch.where(adv, torch.clamp_min(ytg - gained, 0.0), ytg)
    first = adv & (gained + 1e-6 >= dist)
    down_a = torch.where(adv, torch.where(first, 1, down + 1), down)
    dist_a = torch.where(adv, torch.where(first, 10.0, dist - gained), dist)
    downs_to = adv & ~first & (down_a > 4)
    ytg_a = torch.where(o_sck, ytg + loss, ytg_a)
    dist_a = torch.where(o_sck, dist + loss, dist_a)
    down_a = torch.where(o_sck | o_inc, down + 1, down_a)
    flip_a = downs_to | o_int
    spot_a = torch.where(o_int, int_spot, 100.0 - ytg_a)
    off_a = torch.where(flip_a, 1 - off, off)
    ytg_a = torch.where(flip_a, spot_a, ytg_a)
    down_a = torch.where(flip_a, 1, down_a)
    dist_a = torch.where(flip_a, 10.0, dist_a)
    in_rz_a = ~flip_a & (in_rz | trip1)
    t = (_i(fg_att) * 6 + _i(punt) * 6 + _i(pass_td) * 20 + _i(pass_gain) * 26
         + _i(o_inc) * 10 + _i(o_sck) * 24 + _i(o_int) * 12
         + _i(run_td | run_gain) * 28)
    sec_b = torch.clamp_min(sec - t, 0)
    period_b = torch.where(sec_b > 0, 4 - (sec_b - 1) // 900, 4)
    halftime = active & (period_b != period) & (period_b == 3)
    off_b = torch.where(halftime, 1 - off_a, off_a)
    ytg_b = torch.where(halftime, 75.0, ytg_a)
    down_b = torch.where(halftime, 1, down_a)
    dist_b = torch.where(halftime, 10.0, dist_a)
    in_rz_b = ~halftime & in_rz_a
    flip_c = fg_good | fg_miss | punt | pass_td | run_td
    spot_c = torch.where(fg_miss, 100.0 - ytg, torch.where(punt, punt_spot, 75.0))
    off_c = torch.where(flip_c, 1 - off_b, off_b)
    ytg_c = torch.where(flip_c, spot_c, ytg_b)
    down_c = torch.where(flip_c, 1, down_b)
    dist_c = torch.where(flip_c, 10.0, dist_b)
    in_rz_c = ~flip_c & in_rz_b
    pts = _i(pass_td | run_td) * 7 + _i(fg_good) * 3
    sa_f = sa + torch.where(is_a, pts, 0)
    sb_f = sb + torch.where(is_a, 0, pts)
    return (_i(off_c), _i(sec_b), _i(down_c), dist_c.to(_F32), ytg_c.to(_F32),
            _i(period_b), _i(in_rz_c), _i(sa_f), _i(sb_f))


def fused_step_reference(state: State, key: int, step_base: int, ch: int = 1,
                         heads: Optional[Sequence[torch.Tensor]] = None) -> State:
    """Plain twin of both kernels: `ch` steps of `step_arith` on the Philox
    draws of (key, step_base + j, row), the stream `ops/rng` draws."""
    n = state[1].shape[0]
    for j in range(ch):
        u, z = rng.philox_draws_reference(key, step_base + j, 1, n, state[1].device)
        state = step_arith(state, u[0], z[0], heads)
    return state


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

class _StepConsts(ctypes.Structure):
    """The SimConfig constants the step reads, as `StepConsts` in
    csrc/fused_step.cu (field for field; the launcher checks the size)."""
    _fields_ = [
        ("go_ytg_edges", ctypes.c_float * 8), ("go_dist_edges", ctypes.c_float * 8),
        ("go_grid", ctypes.c_float * 81), ("n_go_ytg", ctypes.c_int),
        ("n_go_dist", ctypes.c_int), ("late_seconds", ctypes.c_int),
        ("late_leading_scale", ctypes.c_float), ("late_trailing_long_fg_ytg", ctypes.c_float),
        ("late_trailing_go_long", ctypes.c_float), ("late_trailing_go_short", ctypes.c_float),
        ("go_multiplier", ctypes.c_float),
        ("fg_bounds", ctypes.c_float * 8), ("fg_probs", ctypes.c_float * 8),
        ("n_fg", ctypes.c_int), ("fg_long_prob", ctypes.c_float),
        ("s2_inc", ctypes.c_float), ("s2_int", ctypes.c_float), ("s2_sck", ctypes.c_float),
        ("stage2_int_scale", ctypes.c_float), ("stage2_int_add", ctypes.c_float),
        ("stage2_sack_scale", ctypes.c_float),
        ("heuristic_clip_lo", ctypes.c_float), ("heuristic_clip_hi", ctypes.c_float),
        ("half_seconds", ctypes.c_int),
        ("rz_pass", ctypes.c_float * 7), ("rz_run", ctypes.c_float * 7),
        ("explosive", ctypes.c_float * 6),
        ("r_mismatch", ctypes.c_float), ("r7", ctypes.c_float), ("r10", ctypes.c_float),
        ("r60", ctypes.c_float),
    ]


def _step_consts(cfg: SimConfig) -> _StepConsts:
    c = _StepConsts()
    ytg_edges, dist_edges, grid = (t.numpy() for t in
                                   analytic.go_lookup(cfg.fourth.table, torch.device("cpu")))
    if ytg_edges.size > 8 or dist_edges.size > 8:
        raise ValueError("the go-for-it table has more than 8 edges on an axis")
    c.n_go_ytg, c.n_go_dist = ytg_edges.size, dist_edges.size
    c.go_ytg_edges[:ytg_edges.size] = ytg_edges.tolist()
    c.go_dist_edges[:dist_edges.size] = dist_edges.tolist()
    c.go_grid[:grid.size] = grid.reshape(-1).tolist()
    f = cfg.fourth
    c.late_seconds = f.late_seconds
    c.late_leading_scale = f.late_leading_scale
    c.late_trailing_long_fg_ytg = f.late_trailing_long_fg_ytg
    c.late_trailing_go_long = f.late_trailing_go_long
    c.late_trailing_go_short = f.late_trailing_go_short
    c.go_multiplier = f.go_multiplier
    if len(cfg.st.fg_curve) > 8:
        raise ValueError("the FG curve has more than 8 points")
    c.n_fg = len(cfg.st.fg_curve)
    for k, (bound, prob) in enumerate(cfg.st.fg_curve):
        c.fg_bounds[k], c.fg_probs[k] = bound, prob
    c.fg_long_prob = cfg.st.fg_long_prob
    base = analytic.STAGE2_FALLBACK_BASE
    c.s2_inc, c.s2_int, c.s2_sck = base["incomplete"], base["intercepted"], base["sack"]
    m = cfg.model
    c.stage2_int_scale, c.stage2_int_add = m.stage2_int_scale, m.stage2_int_add
    c.stage2_sack_scale = m.stage2_sack_scale
    c.heuristic_clip_lo, c.heuristic_clip_hi = m.heuristic_clip_lo, m.heuristic_clip_hi
    c.half_seconds = cfg.clock.half_seconds
    mu = cfg.matchup
    # (base, slope, down bonus, tilt, 1 / tilt denominator, lo, hi)
    c.rz_pass[:] = [mu.rz_pass_base, mu.rz_pass_slope, mu.rz_pass_down_bonus,
                    mu.rz_pass_tilt, analytic.recip(mu.rz_pass_tilt_denom),
                    mu.rz_pass_lo, mu.rz_pass_hi]
    c.rz_run[:] = [mu.rz_run_base, mu.rz_run_slope, mu.rz_run_down_bonus,
                   mu.rz_run_tilt, analytic.recip(mu.rz_run_tilt_denom),
                   mu.rz_run_lo, mu.rz_run_hi]
    # (base, z_k, bonus over 60, bonus over 40, lo, hi)
    c.explosive[:] = [mu.explosive_base, mu.explosive_z_k, mu.explosive_bonus_60,
                      mu.explosive_bonus_40, mu.explosive_lo, mu.explosive_hi]
    c.r_mismatch = analytic.recip(mu.mismatch_denom)
    c.r7, c.r10, c.r60 = analytic.recip(7.0), analytic.recip(10.0), analytic.recip(60.0)
    return c


@functools.lru_cache(maxsize=None)
def _launchers():
    """(fused_step_launch, fused_step_tab_launch, the StepConsts of CFG and
    its address), loaded and built once."""
    from ..utils.cuda_build import load_kernel_library

    lib = load_kernel_library("fused_step")
    size = lib.fused_step_consts_size
    size.argtypes, size.restype = [], ctypes.c_int
    if size() != ctypes.sizeof(_StepConsts):
        raise RuntimeError(f"StepConsts is {size()} bytes in fused_step.cu, "
                           f"{ctypes.sizeof(_StepConsts)} in step_arith.py")
    step, tab = lib.fused_step_launch, lib.fused_step_tab_launch
    step.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
                     ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    tab.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
                    ctypes.c_int, ctypes.c_void_p]
    step.restype = tab.restype = ctypes.c_int
    consts = _step_consts(CFG)
    return step, tab, consts, ctypes.addressof(consts)


def _check(tensors: Sequence[torch.Tensor], dtypes, what: str) -> torch.device:
    """The one device of `tensors`; raises unless each is a contiguous 1-D
    tensor of its dtype and all have one length."""
    n, dev = tensors[0].shape, tensors[0].device
    for k, (t, dt) in enumerate(zip(tensors, dtypes)):
        if (t.dtype != dt or t.shape != n or t.device != dev or t.dim() != 1
                or not t.is_contiguous()):
            raise ValueError(f"{what}[{k}] must be a contiguous {dt} vector of "
                             f"shape {tuple(n)} on {dev}; got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    return dev


def _ptrs(tensors: Sequence[torch.Tensor]):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _launch(dev: torch.device, fn, *args) -> None:
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {err}")


def fused_step(state: State, key: int, step_base: int, ch: int = 1) -> State:
    """B1: `ch` play steps of every game, draws in the kernel, analytic
    heads.  On CUDA it launches the kernel on the current stream; on the CPU
    it runs `fused_step_reference`.  `fused_step.launches` counts kernel
    launches and nothing else."""
    dev = _check(state, STATE_DTYPES, "state")
    if ch < 1:
        raise ValueError(f"ch must be positive, got {ch}")
    if dev.type == "cpu":
        return fused_step_reference(state, key, step_base, ch)
    out = tuple(torch.empty_like(t) for t in state)
    step, _, _, consts = _launchers()
    _launch(dev, step, consts, _ptrs(state), _ptrs(out),
            key & 0xFFFFFFFF, (key >> 32) & 0xFFFFFFFF, step_base & 0xFFFFFFFF,
            ch, state[1].shape[0])
    fused_step.launches += 1
    return out


fused_step.launches = 0


def head_slab(heads: Sequence[torch.Tensor]) -> Sequence[torch.Tensor]:
    """The 7 head vectors as the columns of one 16-byte-aligned (B, 7)
    tensor, the only layout the kernel reads: `heads` itself where they are
    that already (as `table_select` gives them), else a stacked copy."""
    h0 = heads[0]
    if all(h.stride() == (N_HC,) and h.data_ptr() == h0.data_ptr() + 4 * k
           for k, h in enumerate(heads)) and h0.data_ptr() % 16 == 0:
        return heads
    return torch.stack(tuple(heads), 1).unbind(1)


def fused_step_tab(state: State, heads: Sequence[torch.Tensor], key: int,
                   step: int) -> State:
    """B2: one play step with the 7 head vectors given (`table_select`),
    draws in the kernel, which reads the heads as one (B, 7) tensor
    (`head_slab`).  CPU tensors run `fused_step_reference`.
    `fused_step_tab.launches` counts kernel launches."""
    dev = _check(state, STATE_DTYPES, "state")
    if len(heads) != N_HC:
        raise ValueError(f"{N_HC} head vectors expected, got {len(heads)}")
    for h in heads:
        if h.dtype != _F32 or h.shape != state[1].shape or h.device != dev:
            raise ValueError(f"heads must be float32 vectors of shape "
                             f"{tuple(state[1].shape)} on {dev}; got {h.dtype} "
                             f"{tuple(h.shape)} on {h.device}")
    if dev.type == "cpu":
        return fused_step_reference(state, key, step, 1, heads)
    heads = head_slab(heads)
    out = tuple(torch.empty_like(t) for t in state)
    _, tab, _, consts = _launchers()
    _launch(dev, tab, consts, _ptrs(state), _ptrs(heads), N_HC, _ptrs(out),
            key & 0xFFFFFFFF, (key >> 32) & 0xFFFFFFFF, step & 0xFFFFFFFF,
            state[1].shape[0])
    fused_step_tab.launches += 1
    return out


fused_step_tab.launches = 0


# ---------------------------------------------------------------------------
# the five structures
# ---------------------------------------------------------------------------

def run_structure(name: str, b: int, steps: int, key: int, device,
                  values: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """`steps` play steps of b games from kick-off through one structure;
    final (score_a, score_b).  Every structure draws the same Philox stream
    (key, absolute step, row).  The table structures read `values`
    (`make_table` when None)."""
    dev = resolve_device(device)
    if name not in STRUCTURES:
        raise ValueError(f"unknown structure {name!r}; one of {STRUCTURES}")
    if name == "fused-chunk24" and steps % CH:
        raise ValueError(f"fused-chunk24 runs whole chunks of {CH} steps; got {steps}")
    if name.endswith("-tab") and values is None:
        values = make_table(dev)
    s = init_state(b, dev)
    if name == "fused-chunk24":
        for ci in range(steps // CH):
            s = fused_step(s, key, ci * CH, CH)
        return s[7], s[8]
    for j in range(steps):
        if name == "eager":
            u, z = rng.step_draws(key, j, b, dev)
            s = step_arith(s, u, z)
        elif name == "fused-step":
            s = fused_step(s, key, j, 1)
        elif name == "eager-tab":
            u, z = rng.step_draws(key, j, b, dev)
            s = step_arith(s, u, z, heads_of(s, values))
        else:
            s = fused_step_tab(s, heads_of(s, values), key, j)
    return s[7], s[8]


def time_structures(b: int = B_DEFAULT, steps: int = STEPS_DEFAULT, device="cuda",
                    reps: int = 1) -> Dict[str, dict]:
    """Each structure once unmeasured over one chunk, then `reps` timed runs
    of `steps` steps from seed 0 (host clock, ending in the scores' copy to
    the host); the best run's seconds, ms/step, eq-games/s, mean scores,
    side-A win rate."""
    dev = resolve_device(device)
    key = rng.root_key(0)
    values = make_table(dev)
    results = {}
    for name in STRUCTURES:
        run_structure(name, b, CH, key, dev, values)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        best, sa, sb = math.inf, None, None
        for _ in range(reps):
            t0 = time.perf_counter()
            a, bb = run_structure(name, b, steps, key, dev, values)
            sa, sb = a.cpu().numpy(), bb.cpu().numpy()
            best = min(best, time.perf_counter() - t0)
        results[name] = dict(seconds=best, ms_per_step=best / steps * 1e3,
                             games_per_s=b / best, mean_a=float(sa.mean()),
                             mean_b=float(sb.mean()), win_a=float((sa > sb).mean()))
    return results


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="Fused play-step probe (B1, B2) on the card")
    ap.add_argument("b", nargs="?", type=int, default=B_DEFAULT, help="games")
    ap.add_argument("steps", nargs="?", type=int, default=STEPS_DEFAULT,
                    help=f"play steps, a multiple of {CH}")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.steps % CH or args.steps <= 0 or args.b <= 0:
        ap.error(f"B must be positive and STEPS a positive multiple of {CH}")
    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {dev.type} {name} B={args.b} steps={args.steps}", flush=True)
    res = time_structures(args.b, args.steps, dev, reps=3)
    for k, r in res.items():
        print(f"{k:16s} {r['seconds']:7.3f}s  {r['ms_per_step']:7.4f} ms/step  "
              f"{r['games_per_s']:12,.0f} eq-games/s  mean {r['mean_a']:.2f}/"
              f"{r['mean_b']:.2f} winA {r['win_a']:.4f}", flush=True)
    base = res["eager"]["seconds"]
    for k, r in res.items():
        print(f"  {k:16s} {base / r['seconds']:6.2f}x vs eager")
    print(f"  hybrid-tab vs eager-tab: "
          f"{res['eager-tab']['seconds'] / res['hybrid-tab']['seconds']:6.2f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main())

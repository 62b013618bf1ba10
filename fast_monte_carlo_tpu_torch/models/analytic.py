"""Closed-form model components: port of fast_monte_carlo_tpu/models/analytic.py.

The SP+ matchup scalars (`matchup_bias`, `yardage_multiplier`,
`mismatch_z`) are host float64 numpy, as in the JAX package, and are cast to
f32 when packed.  Everything the play step calls takes float32 tensors.

Division by a constant is written as multiplication by its f32 reciprocal:
XLA rewrites `x / c` that way, and torch divides by a Python scalar that way
on CUDA but not on the CPU, so writing it out keeps the CPU path, the CUDA
path and the JAX reference on the same arithmetic.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import SimConfig


def recip(c: float) -> float:
    """The f32 reciprocal of a constant, as XLA folds `x / c`."""
    return float(np.float32(1.0) / np.float32(c))


def softclip(x, lo, hi):
    return torch.clamp(x, lo, hi)


# ---------------------------------------------------------------------------
# SP+ matchup adjustments (fast_monte_carlo_cfb.py:431-484), host scalars
# ---------------------------------------------------------------------------

def matchup_bias(off_offense: float, def_defense: float, cfg: SimConfig):
    m = cfg.matchup
    return m.bias_k * (off_offense - def_defense) / m.bias_denom


def yardage_multiplier(off_offense: float, def_defense: float, cfg: SimConfig):
    m = cfg.matchup
    return 1.0 + m.ymult_k * np.tanh((off_offense - def_defense) / m.ymult_denom)


def mismatch_z(off_offense: float, def_defense: float, cfg: SimConfig):
    return (off_offense - def_defense) / cfg.matchup.mismatch_denom


# ---------------------------------------------------------------------------
# per-play tensors
# ---------------------------------------------------------------------------

def rz_finish_prob_pass(ytg, down, off_offense, def_defense, cfg: SimConfig):
    m = cfg.matchup
    base = m.rz_pass_base + m.rz_pass_slope * torch.clamp_min(7.0 - ytg, 0.0) * recip(7.0)
    base = base + m.rz_pass_down_bonus * torch.clamp_min(4 - down, 0)
    tilt = m.rz_pass_tilt * torch.tanh((off_offense - def_defense)
                                       * recip(m.rz_pass_tilt_denom))
    return softclip(base + tilt, m.rz_pass_lo, m.rz_pass_hi)


def rz_finish_prob_run(ytg, down, off_offense, def_defense, cfg: SimConfig):
    m = cfg.matchup
    base = m.rz_run_base + m.rz_run_slope * torch.clamp_min(7.0 - ytg, 0.0) * recip(7.0)
    base = base + m.rz_run_down_bonus * torch.clamp_min(4 - down, 0)
    tilt = m.rz_run_tilt * torch.tanh((off_offense - def_defense)
                                      * recip(m.rz_run_tilt_denom))
    return softclip(base + tilt, m.rz_run_lo, m.rz_run_hi)


def explosive_prob(ytg, off_offense, def_defense, cfg: SimConfig):
    m = cfg.matchup
    z = (off_offense - def_defense) * recip(m.mismatch_denom)
    base = m.explosive_base + m.explosive_z_k * z
    base = base + torch.where(ytg > 60, m.explosive_bonus_60, 0.0)
    base = base + torch.where(ytg > 40, m.explosive_bonus_40, 0.0)
    return softclip(base, m.explosive_lo, m.explosive_hi)


def pass_prob_v1(down, distance, ytg, seconds_remaining, score_diff, cfg: SimConfig):
    """Heuristic play-call policy (fast_monte_carlo_cfb.py:719-735)."""
    m = cfg.model
    r10 = recip(10)
    base = 0.53 + torch.where(
        down == 1, 0.02 + 0.010 * torch.clamp_min(distance - 10, 0.0) * r10, 0.0)
    base = base + torch.where(
        down == 2, 0.12 + 0.020 * torch.clamp_min(distance - 7, 0.0) * r10, 0.0)
    base = base + torch.where(
        down == 3, 0.28 + 0.030 * torch.clamp_min(distance - 5, 0.0) * r10, 0.0)
    base = base + torch.where(
        down == 4, 0.45 + 0.035 * torch.clamp_min(distance - 3, 0.0) * r10, 0.0)
    base = base - torch.where(ytg <= 10, 0.05, 0.0)
    base = base - torch.where(ytg <= 5, 0.03, 0.0)
    two_min = (seconds_remaining % cfg.clock.half_seconds) <= 120
    base = base + torch.where(two_min & (score_diff < 0), 0.22, 0.0)
    base = base + torch.where((seconds_remaining < 600) & (score_diff < 0), 0.06, 0.0)
    return softclip(base, m.heuristic_clip_lo, m.heuristic_clip_hi)


def _policy_at(table, ytg: float, dist: float) -> float:
    """The go-for-it table's probability at one point, by the JAX
    package's where-chain: ytg buckets (bound, prev_bound], highest bound
    first; within one, dist rows (prev_dmax, dmax]."""
    p, prev_bound = 0.0, np.inf
    for bound, rows in table:
        if bound < ytg <= prev_bound:
            p, prev = 0.0, -np.inf
            for dmax, prob in rows:
                if prev < dist <= dmax:
                    p = prob
                prev = dmax
        prev_bound = bound
    return p


@functools.lru_cache(maxsize=8)
def go_lookup(table, device: torch.device):
    """The go-for-it table as bin edges and a dense (ytg bin, dist bin)
    grid on `device`.  The table's bounds cut each axis into bins
    (edge[i-1], edge[i]], which torch.bucketize(right=False) finds; each
    bin holds the policy's value at a point inside it (its upper edge, or
    one past the last edge), so the lookup returns the same constants as
    the where-chain."""
    ytg_edges = np.unique([b for b, _ in table])
    dist_edges = np.unique([d for _, rows in table for d, _ in rows])

    def points(edges):
        return np.concatenate([edges, [edges[-1] + 1.0]])

    grid = np.asarray([[_policy_at(table, y, d) for d in points(dist_edges)]
                       for y in points(ytg_edges)], dtype=np.float32)
    return (torch.tensor(ytg_edges, dtype=torch.float32, device=device),
            torch.tensor(dist_edges, dtype=torch.float32, device=device),
            torch.tensor(grid, device=device))


def go_for_it_prob(ytg, dist, score_diff, seconds_remaining, cfg: SimConfig):
    """4th-down go-for-it policy (fast_monte_carlo_cfb.py:1336-1378): the
    table's probability for the (ytg, dist) bucket, then the late-game
    adjustments.  The bucket is found by lookup (`go_lookup`), which gives
    the same constants as the JAX package's nested where-chain."""
    f = cfg.fourth
    ytg_edges, dist_edges, grid = go_lookup(f.table, ytg.device)
    p = grid[torch.bucketize(ytg, ytg_edges), torch.bucketize(dist, dist_edges)]

    late = seconds_remaining < f.late_seconds
    p = torch.where(late & (score_diff > 0), p * f.late_leading_scale, p)
    p = torch.where(late & (score_diff < 0),
                    torch.where(ytg > f.late_trailing_long_fg_ytg,
                                f.late_trailing_go_long, f.late_trailing_go_short),
                    p)
    return softclip(p, 0.0, 1.0)


def field_goal_prob(attempt_dist, cfg: SimConfig):
    """FG make curve (fast_monte_carlo_cfb.py:858-874)."""
    st = cfg.st
    p = torch.full_like(attempt_dist, st.fg_long_prob)
    for bound, prob in reversed(st.fg_curve):
        p = torch.where(attempt_dist < bound, prob, p)
    return p


# ---------------------------------------------------------------------------
# analytic stage-2 fallback (the stage-2 artifact is missing upstream)
# ---------------------------------------------------------------------------

STAGE2_FALLBACK_BASE = dict(incomplete=0.780, intercepted=0.075, sack=0.145)


def stage2_fallback_probs(down, distance, cfg: SimConfig):
    """(p_incomplete, p_intercepted, p_sack | not complete); `down` float."""
    b_inc = STAGE2_FALLBACK_BASE["incomplete"]
    b_int = STAGE2_FALLBACK_BASE["intercepted"]
    b_sck = STAGE2_FALLBACK_BASE["sack"]
    long_d = torch.clamp_min(distance - 7.0, 0.0) * recip(10.0)
    p_sck = b_sck * (1.0 + 0.25 * torch.where(down >= 3, 1.0, 0.0) + 0.15 * long_d)
    p_int = b_int * (1.0 + 0.10 * long_d)
    p_inc = torch.full_like(p_sck, b_inc)
    s = p_inc + p_int + p_sck
    return p_inc / s, p_int / s, p_sck / s


def stage2_nudge(p_inc, p_int, p_sck, cfg: SimConfig):
    """The reference's hand nudge + renorm (fast_monte_carlo_cfb.py:762-770)."""
    m = cfg.model
    p_inc = torch.clamp_min(p_inc, 0.0)
    p_int = torch.clamp_min(p_int, 0.0) * m.stage2_int_scale + m.stage2_int_add
    p_sck = torch.clamp_min(p_sck, 0.0) * m.stage2_sack_scale
    s = p_inc + p_int + p_sck
    s = torch.where(s == 0.0, 1.0, s)
    return p_inc / s, p_int / s, p_sck / s

"""On-device aggregation of trial results: port of
fast_monte_carlo_tpu/parallel/aggregate.py (score summaries).

Each launch's (B, 2) scores reduce on the device to additive counts, sums
and histograms (`ScoreMoments`); launches accumulate there and
`summary_from_moments` finishes once.  Counts are f32 as in the JAX
package: exact integers up to 2^24 per launch.  Histograms are int32.
The counts and sums are taken exactly in int64 (`exact_moments`) and
rounded once to f32, where the JAX package sums in f32 in XLA's order; so
moments of the parts of a batch, added as integers, give the whole batch's
bit for bit (the trial-sharded reduction, `parallel.mesh`).  On the card
int32 scores reduce in one launch of K2 (`exact_moments_cuda`,
csrc/score_moments.cu: shared-memory histograms, integer atomics), the
counterpart of the JAX package's XLA `score_moments`; elsewhere the torch
body `exact_moments_plain` runs, which K2 equals bit for bit.

Scores with leading axes, (S, B, 2), reduce to moments with those axes in
front, one set of histograms per group from one `bincount` (group g's
values offset by g * size), where the JAX package vmaps `score_moments`;
`summary_from_moments` finishes them alike.  `cover_probs` and
`total_probs` price one spread or total line over a score batch, and
`player_stat_probs` one player prop over a batch's player stats, in torch
on the device of their input.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, NamedTuple

import torch

MAX_PTS = 128          # per-team score histogram support [0, 128)
MARGIN_OFF = 128       # margin histogram support [-128, 128)

F32 = torch.float32


class ScoreSummary(NamedTuple):
    n: torch.Tensor
    mean_pts: torch.Tensor      # (2,)
    sd_pts: torch.Tensor        # (2,)
    win_rate: torch.Tensor      # (2,) P(team i wins), ties excluded
    tie_rate: torch.Tensor
    pts_hist: torch.Tensor      # (2, MAX_PTS)
    margin_hist: torch.Tensor   # (2*MARGIN_OFF,) margin = pts0 - pts1
    total_hist: torch.Tensor    # (2*MAX_PTS,)


class ScoreMoments(NamedTuple):
    """Additive reductions of one launch's scores."""
    n: torch.Tensor             # game count
    wins: torch.Tensor          # (2,) win counts
    ties: torch.Tensor
    s_sum: torch.Tensor         # (2,) point sums
    s_sumsq: torch.Tensor       # (2,)
    pts_hist: torch.Tensor      # (2, MAX_PTS)
    margin_hist: torch.Tensor
    total_hist: torch.Tensor

    def __add__(self, o: "ScoreMoments") -> "ScoreMoments":
        return ScoreMoments(*(a + b for a, b in zip(self, o)))


def _hist(v: torch.Tensor, size: int) -> torch.Tensor:
    """bincount of v (..., B) clipped into [0, size), as int32 (..., size):
    one bincount, each leading index's values offset by its index * size."""
    lead = v.shape[:-1]
    idx = torch.clamp(v, 0, size - 1).long()
    groups = math.prod(lead)
    if lead:
        idx = idx + torch.arange(groups, device=v.device).view(*lead, 1) * size
    return torch.bincount(idx.reshape(-1), minlength=groups * size).view(
        *lead, size).to(torch.int32)


def _histograms(score: torch.Tensor):
    s0, s1 = score[..., 0], score[..., 1]
    return (torch.stack([_hist(s0, MAX_PTS), _hist(s1, MAX_PTS)], dim=-2),
            _hist(s0 - s1 + MARGIN_OFF, 2 * MARGIN_OFF),
            _hist(s0 + s1, 2 * MAX_PTS))


def exact_moments(score: torch.Tensor) -> ScoreMoments:
    """`score_moments` before the rounding: the counts and sums as int64,
    exact, the histograms int32.  int32 scores on the card go through K2
    (`exact_moments_cuda`), any other through the torch body
    (`exact_moments_plain`); the two agree bit for bit."""
    if score.device.type == "cuda" and score.dtype == torch.int32:
        return exact_moments_cuda(score)
    return exact_moments_plain(score)


def exact_moments_plain(score: torch.Tensor) -> ScoreMoments:
    """`exact_moments` in torch on any device: K2's plain version."""
    s = score.to(torch.int64)
    s0, s1 = score[..., 0], score[..., 1]
    pts_hist, margin_hist, total_hist = _histograms(score)
    return ScoreMoments(
        n=torch.full(score.shape[:-2], score.shape[-2], dtype=torch.int64,
                     device=score.device),
        wins=torch.stack([(s0 > s1).sum(-1), (s1 > s0).sum(-1)], dim=-1),
        ties=(s0 == s1).sum(-1),
        s_sum=s.sum(dim=-2), s_sumsq=(s * s).sum(dim=-2),
        pts_hist=pts_hist, margin_hist=margin_hist, total_hist=total_hist,
    )


_KERNEL = "score_moments"
_THREADS = 256                  # score_moments.cu's block
_FILL_BLOCKS = 4 * 132          # blocks a launch aims for: 4 an H100 SM
_N_COUNTS = 8                   # n, wins 2, ties, sums 2, squares 2 a matchup
_N_BINS = 2 * MAX_PTS + 2 * MARGIN_OFF + 2 * MAX_PTS


@functools.lru_cache(maxsize=None)
def _moments_launcher():
    from ..utils.cuda_build import load_kernel_library

    fn = load_kernel_library(_KERNEL).score_moments_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def exact_moments_cuda(score: torch.Tensor) -> ScoreMoments:
    """K2 (csrc/score_moments.cu): `exact_moments` of (..., n, 2) int32
    scores on the card in one launch on the current stream, the moments of
    each leading index.  Raises ValueError for scores off the card or of
    another dtype (`exact_moments_plain` takes those) and RuntimeError
    where the kernel does not build or launch.  `exact_moments_cuda.
    launches` counts kernel launches and nothing else."""
    if score.device.type != "cuda":
        raise ValueError(f"exact_moments_cuda takes scores on the card, got {score.device} "
                         "(exact_moments_plain takes the others)")
    if score.dtype != torch.int32 or score.dim() < 2 or score.shape[-1] != 2:
        raise ValueError(f"exact_moments_cuda takes (..., n, 2) int32 scores, got "
                         f"{score.dtype} {tuple(score.shape)}")
    lead, n = score.shape[:-2], score.shape[-2]
    groups = math.prod(lead)
    s = score.reshape(groups, n, 2).contiguous()
    if s.data_ptr() % 8:
        s = s.clone()        # the kernel reads a game's two scores as one int2
    counts = torch.zeros(groups * _N_COUNTS, dtype=torch.int64, device=score.device)
    hist = torch.zeros(groups * _N_BINS, dtype=torch.int32, device=score.device)
    if n > 0 and groups > 0:
        blocks = max(1, min(-(-n // (8 * _THREADS)), -(-_FILL_BLOCKS // groups)))
        with torch.cuda.device(score.device):
            err = _moments_launcher()(s.data_ptr(), n, groups, blocks, counts.data_ptr(),
                                      hist.data_ptr(),
                                      torch.cuda.current_stream(score.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"score_moments kernel launch failed: CUDA error {err}")
        exact_moments_cuda.launches += 1
    g = groups
    pts = 2 * MAX_PTS * g
    return ScoreMoments(
        n=counts[:g].view(lead), wins=counts[g:3 * g].view(*lead, 2),
        ties=counts[3 * g:4 * g].view(lead), s_sum=counts[4 * g:6 * g].view(*lead, 2),
        s_sumsq=counts[6 * g:8 * g].view(*lead, 2),
        pts_hist=hist[:pts].view(*lead, 2, MAX_PTS),
        margin_hist=hist[pts:pts + 2 * MARGIN_OFF * g].view(*lead, 2 * MARGIN_OFF),
        total_hist=hist[pts + 2 * MARGIN_OFF * g:].view(*lead, 2 * MAX_PTS))


exact_moments_cuda.launches = 0


def rounded_moments(m: ScoreMoments) -> ScoreMoments:
    """Exact moments as `score_moments` gives them: counts and sums rounded
    once to f32, histograms int32."""
    return ScoreMoments(*(f.to(torch.int32) if "hist" in name else f.to(F32)
                          for name, f in zip(ScoreMoments._fields, m)))


def score_moments(score: torch.Tensor) -> ScoreMoments:
    """Counts/sums/histograms of one (..., B, 2) int score batch; leading
    axes stay in front of every field."""
    return rounded_moments(exact_moments(score))


def summary_from_moments(m: ScoreMoments) -> ScoreSummary:
    """Finalize accumulated moments (sd with ddof=1; NaN at n < 2), with
    any leading axes of the moments."""
    n = m.n
    n2 = n[..., None]
    mean = m.s_sum / n2
    var = torch.clamp_min((m.s_sumsq - n2 * mean * mean) / torch.clamp_min(n2 - 1, 1.0),
                          0.0)
    var = torch.where(n2 > 1, var, torch.nan)
    return ScoreSummary(
        n=n, mean_pts=mean, sd_pts=torch.sqrt(var),
        win_rate=m.wins / n2, tie_rate=m.ties / n,
        pts_hist=m.pts_hist, margin_hist=m.margin_hist, total_hist=m.total_hist,
    )


def summarize_scores(score: torch.Tensor) -> ScoreSummary:
    """ScoreSummary of one (B, 2) score batch."""
    s = score.to(F32)
    pts_hist, margin_hist, total_hist = _histograms(score)
    return ScoreSummary(
        n=torch.tensor(float(score.shape[0]), dtype=F32, device=score.device),
        mean_pts=s.mean(dim=0), sd_pts=s.std(dim=0, correction=1),
        win_rate=torch.stack([(score[:, 0] > score[:, 1]).to(F32).mean(),
                              (score[:, 1] > score[:, 0]).to(F32).mean()]),
        tie_rate=(score[:, 0] == score[:, 1]).to(F32).mean(),
        pts_hist=pts_hist, margin_hist=margin_hist, total_hist=total_hist,
    )


def _mean(x: torch.Tensor) -> torch.Tensor:
    """f32 mean as XLA lowers jnp.mean: the sum times the f32 reciprocal
    of the count (a division rounds differently in the last bit)."""
    x = x.to(F32)
    return x.sum() * torch.reciprocal(torch.tensor(float(x.numel()), dtype=F32,
                                                   device=x.device))


def cover_probs(score: torch.Tensor, spread: float) -> Dict[str, torch.Tensor]:
    """Spread from team 0's view: cover iff margin > -spread, push at
    equality."""
    margin = (score[:, 0] - score[:, 1]).to(F32)
    tgt = -float(spread)
    return {
        "p_cover": _mean(margin > tgt),
        "p_notcover": _mean(margin < tgt),
        "push": _mean(margin == tgt),
        "mean_margin": _mean(margin),
    }


def total_probs(score: torch.Tensor, total: float) -> Dict[str, torch.Tensor]:
    """Over iff the combined points pass `total`, push at equality."""
    tot = (score[:, 0] + score[:, 1]).to(F32)
    t = float(total)
    return {
        "p_over": _mean(tot > t),
        "p_under": _mean(tot < t),
        "push": _mean(tot == t),
        "mean_total": _mean(tot),
    }


def player_stat_probs(pstats: torch.Tensor, team: int, role: int, slot: int, col: int,
                      line: float) -> Dict[str, torch.Tensor]:
    """P(over), P(under) and P(push) of one player stat against a prop line
    over every game of a (B, 2, 3, K, 6) `pstats`, and its mean, as f32
    tensors on the device of `pstats`.  A push is |v - line| <= 1e-9 in
    f32, as `edge._settle_legs` settles one.  The probabilities are the
    JAX package's f32 means of the indicators; the mean sums in f64 and
    rounds once to f32 (the JAX package sums in f32, in XLA's order)."""
    vals = pstats[:, team, role, slot, col].to(F32)
    n = vals.shape[0]
    return {
        "p_over": _mean(vals > line),
        "p_under": _mean(vals < line),
        "push": _mean((vals - line).abs() <= 1e-9),
        "mean": (vals.to(torch.float64).sum() / n).to(F32),
    }

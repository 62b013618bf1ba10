"""Trial sharding over ranks: port of fast_monte_carlo_tpu/parallel/mesh.py.

The JAX package shards the trial axis over a 1-D `('trial',)` device mesh
from one process (`shard_map`), with no collective inside the game loop
and one `psum` of the score moments after it.  Here each card is driven by
a process of its own (a rank of `torch.distributed`): every path is bound
by the host's launch rate (about 667 eager kernels a play), so one Python
thread enqueuing for N cards would gain nothing, while N processes each
enqueue their own card's work.  Start N ranks with

    python -m torch.distributed.run --standalone --nproc_per_node=N -m \\
        fast_monte_carlo_tpu_torch.cli sim ... --shard

(`trial_group` forms the group from the variables `torchrun` sets), or form
the group yourself (`torch.distributed.init_process_group`) and pass each
rank's device.  A process outside any group is a world of one, as a JAX
mesh of one device is.

Rank r of W plays the global games r*n/W .. (r+1)*n/W - 1 of a launch, and
draws exactly those games' Philox rows (`simulate_games(row0=)`), so a
sharded run equals the unsharded run of the same key bit for bit, for any
W.  The JAX package folds a key per device instead (`mesh.py:95`), so its
stream depends on the device count; this port's does not.  Each rank's
early-exit check (one host sync a play chunk) stays its own: no collective
runs inside the game loop.  After it, `simulate_games_sharded` gathers the
whole GameState on every rank (what reading JAX's global array gives), and
`simulate_moments_sharded` sums the ranks' exact integer moments with one
`all_reduce`, then rounds them once, so every rank holds the unsharded
launch's `ScoreMoments`.

Under antithetic draws (mirrored blocks of four games) that equality
needs n / W % 4 == 0; otherwise every rank plays plain draws from its own
rows, as every JAX device decides on its own shard's count.

A rank's failure is every rank's: each sharded launch runs its local games
under `agree`, one small all_reduce of a failure flag before the data's
collective, so a rank that fails (an out-of-memory, a kernel that does not
build) raises on every rank instead of leaving the others waiting in a
collective it never joins.  The host set-up before a sharded entry point's
first launch agrees the same way: a sharded runner's construction (its
table build), a route's reads of its sheet and heads, a command's reads of
its input files.  An `agree` inside another on the same group runs its
function alone, so one `agree` can hold a whole set-up.

Under the gloo backend a collective's CUDA tensors go through the host:
copied there for it and back.  That is chosen by the group's backend, not
taken after a failure (gloo's collectives take host tensors; NCCL's take
the card's).
"""
from __future__ import annotations

import numbers
import os
import threading
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from .. import resolve_device
from ..ops.game import GameState, simulate_games
from .aggregate import ScoreMoments, exact_moments, rounded_moments


@dataclass(frozen=True)
class TrialGroup:
    """One rank's view of the trial axis: its rank, the world size, the
    process group (None in a world of one outside any group) and the card
    (or, in the tests, the CPU) it plays on."""
    rank: int
    world: int
    group: Optional[object]
    device: torch.device

    @property
    def backend(self) -> Optional[str]:
        return None if self.group is None else dist.get_backend(self.group)


def world_size() -> int:
    """The number of ranks this process belongs to (or would form from the
    variables `torchrun` sets), without forming a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def process_rank() -> int:
    """This process's rank (0 outside any group): only rank 0 prints and
    writes files in the command line and serves HTTP."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", "0"))


def _rank_device(device, local_rank: int) -> torch.device:
    """The rank's device: an explicit device with an index (or the CPU)
    wins; `None` or a bare 'cuda' is card `local_rank`, which must exist:
    no wrapping around the cards and no CPU instead."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank)
        resolve_device(dev)
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(f"rank's card cuda:{local_rank} is absent: this host has "
                               f"{torch.cuda.device_count()} card(s)")
        return dev
    return resolve_device(dev)


def trial_group(device=None) -> TrialGroup:
    """The counterpart of `trial_mesh()`: the default process group where
    one is initialized; one formed from `torchrun`'s WORLD_SIZE, RANK and
    LOCAL_RANK (backend nccl for a card, gloo for the CPU) where those are
    set; else a world of one.  A rank's device defaults to
    cuda:{LOCAL_RANK} (its rank outside torchrun); an explicit `device=`
    wins, which is how a test puts ranks on the CPU and how two ranks share
    one card.  A group that fails to form raises: nothing falls back to a
    single rank."""
    env = os.environ
    if dist.is_available() and dist.is_initialized():
        rank = dist.get_rank()
        dev = _rank_device(device, int(env.get("LOCAL_RANK", rank)))
        return TrialGroup(rank, dist.get_world_size(), dist.group.WORLD, dev)
    if all(k in env for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK")):
        dev = _rank_device(device, int(env["LOCAL_RANK"]))
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method="env://")
        return TrialGroup(dist.get_rank(), dist.get_world_size(), dist.group.WORLD, dev)
    dev = resolve_device("cuda" if device is None else device)
    return TrialGroup(0, 1, None, dev)


def local_group(device=None) -> TrialGroup:
    """A world of one on `device` (the card by default) even inside a
    process group: what an unsharded runner plays on."""
    return TrialGroup(0, 1, None, resolve_device("cuda" if device is None else device))


# the game layout's group: the same ranks, each holding a block of matchups
game_group = trial_group


def _via_host(tg: TrialGroup, t: torch.Tensor) -> bool:
    return tg.backend == "gloo" and t.device.type == "cuda"


def all_reduce_sum(tg: TrialGroup, t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the ranks, on every rank (`t` itself in a world
    of one)."""
    if tg.world == 1:
        return t
    x = t.cpu() if _via_host(tg, t) else t.contiguous()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=tg.group)
    return x.to(t.device)


def all_gather_rows(tg: TrialGroup, t: torch.Tensor) -> torch.Tensor:
    """The ranks' equal-shaped `t` concatenated along axis 0 in rank order,
    on every rank."""
    if tg.world == 1:
        return t
    if t.dtype == torch.bool:    # neither backend gathers bool
        return all_gather_rows(tg, t.to(torch.uint8)).bool()
    x = t.cpu() if _via_host(tg, t) else t.contiguous()
    parts = [torch.empty_like(x) for _ in range(tg.world)]
    dist.all_gather(parts, x, group=tg.group)
    return torch.cat(parts).to(t.device)


# the process groups this thread is inside an `agree` of
_AGREEING = threading.local()


def agree(tg: TrialGroup, fn):
    """fn() on this rank, then one all_reduce of a failure flag: where fn
    raised on any rank, every rank raises (the failing rank its own error,
    the others a RuntimeError naming how many failed); else fn's result.
    Call it where every rank of the group calls it, with no collective of
    the group inside fn.  Inside another `agree` of the same group fn runs
    alone, and the outer call shares its failure."""
    if tg.world == 1:
        return fn()
    inside = _AGREEING.__dict__.setdefault("groups", set())
    if id(tg.group) in inside:
        return fn()
    inside.add(id(tg.group))
    err = None
    try:
        out = fn()
    except Exception as e:  # noqa: BLE001 — raised again below, on every rank
        err = e
    finally:
        inside.discard(id(tg.group))
    flag = torch.tensor([err is not None], dtype=torch.int32,
                        device=tg.device if tg.backend == "nccl" else "cpu")
    failed = int(all_reduce_sum(tg, flag).item())
    if err is not None:
        raise err
    if failed:
        raise RuntimeError(f"{failed} of {tg.world} ranks failed this call")
    return out


def shard_span(n: int, tg: TrialGroup) -> tuple:
    """(first, end) global game of this rank's shard of n games; n must be
    a multiple of the world size (ValueError otherwise, as JAX raises)."""
    if n % tg.world:
        raise ValueError(f"n={n} not divisible by {tg.world} ranks")
    per = n // tg.world
    return tg.rank * per, (tg.rank + 1) * per


def _local(v, lo: int, hi: int, device):
    """A per-game int (as is) or (n,) vector (its rows lo..hi-1)."""
    if isinstance(v, numbers.Integral):
        return int(v)
    return torch.as_tensor(v, dtype=torch.int32, device=device)[lo:hi]


def simulate_games_sharded(pack, cfg, heads_eval, heads_state, key: int, n: int,
                           first_offense, group: Optional[TrialGroup] = None,
                           collect_players: bool = False, game_id=0,
                           collect_stats: bool = True) -> GameState:
    """n games sharded over the ranks of `group` (default `trial_group` on
    the pack's device): this rank plays its n / world of them, and every
    rank returns the whole GameState of n games in global order.
    `first_offense` and `game_id` are an int or an (n,) vector of the global
    games.  Equal to `simulate_games` of the same key on integer state."""
    tg = group or trial_group(pack.device)
    lo, hi = shard_span(n, tg)
    out = agree(tg, lambda: simulate_games(
        pack, cfg, heads_eval, heads_state, key, hi - lo,
        _local(first_offense, lo, hi, pack.device), collect_players=collect_players,
        game_id=_local(game_id, lo, hi, pack.device), collect_stats=collect_stats, row0=lo))
    return GameState(*(all_gather_rows(tg, f) for f in out))


def simulate_moments_sharded(pack, cfg, heads_eval, heads_state, key: int, n: int,
                             first_offense, group: Optional[TrialGroup] = None,
                             game_id=0, collect_stats: bool = False,
                             situation=None) -> ScoreMoments:
    """The multi-card summary launch: each rank plays its shard of n
    score-only games and reduces it to exact moments; one `all_reduce` sums
    them and every rank holds the `ScoreMoments` of all n games, bit for
    bit those of the unsharded launch.  `situation` (replicated on every
    rank) resumes every game from a live state; `first_offense` is then
    not built."""
    tg = group or trial_group(pack.device)
    lo, hi = shard_span(n, tg)
    fo = 0 if situation is not None else _local(first_offense, lo, hi, pack.device)
    m = agree(tg, lambda: exact_moments(simulate_games(
        pack, cfg, heads_eval, heads_state, key, hi - lo, fo, collect_players=False,
        game_id=_local(game_id, lo, hi, pack.device), collect_stats=collect_stats,
        situation=situation, row0=lo).score))
    if tg.world > 1:
        flat = all_reduce_sum(tg, torch.cat([f.reshape(-1).to(torch.int64) for f in m]))
        parts, i = [], 0
        for f in m:
            parts.append(flat[i:i + f.numel()].view(f.shape))
            i += f.numel()
        m = ScoreMoments(*parts)
    return rounded_moments(m)

"""Simulation entry point: port of fast_monte_carlo_tpu/api.py (`MatchupRunner`).

A "pair" follows the reference convention: one game with team A receiving
the opening kickoff and one with team B; `n_pairs` counts pairs, so
2 * n_pairs games run with an alternating first-offense vector.

Compute modes:
  'table'    - nano table heads (the main path), tables given as host arrays
  'analytic' - artifact-free closed-form heads
The JAX package's 'exact' mode and its table builds from trained heads are
not ported yet (ROADMAP.md queue 1).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch

from . import resolve_device
from .config import SimConfig
from .data.context import TeamContext
from .matchup import build_direction
from .models.tables import HostTable
from .ops.game import GameState, make_analytic_heads_eval, simulate_games
from .ops.pack import pack_matchup
from .ops.rng import fold_in, root_key
from .ops.table_lookup import make_table_heads_eval, pack_tables
from .parallel.aggregate import ScoreSummary, score_moments, summary_from_moments


@dataclass
class MatchupRunner:
    """Simulator for one matchup (both orderings) on one device.

    `device` defaults to the card ('cuda'), which raises where CUDA is
    absent; the CPU runs only when asked for ('cpu')."""

    team_a: TeamContext
    team_b: TeamContext
    heads: Optional[object] = None
    cfg: SimConfig = field(default_factory=SimConfig)
    mode: str = "table"
    table_quality: str = "nano"
    # table mode: nano-layout host tables for (A on offense, B on offense),
    # e.g. fixtures.nano_tables(seed)
    nano_tables: Optional[Tuple[HostTable, HostTable]] = None
    device: Optional[object] = None   # 'cuda' (None), 'cuda:0' or 'cpu'

    def __post_init__(self):
        self.device = resolve_device("cuda" if self.device is None else self.device)
        if self.heads is not None:
            raise NotImplementedError(
                "trained heads are not ported yet (ROADMAP.md queue 1); "
                "table mode takes nano_tables")
        self.pack = pack_matchup(build_direction(self.team_a, self.team_b, self.cfg),
                                 build_direction(self.team_b, self.team_a, self.cfg),
                                 self.device)
        if self.mode == "table":
            if self.table_quality != "nano":
                raise NotImplementedError(
                    f"table_quality={self.table_quality!r}: only 'nano' is ported")
            if self.nano_tables is None:
                raise ValueError("table mode needs nano_tables "
                                 "(e.g. fixtures.nano_tables(seed))")
            self.heads_state = pack_tables(*self.nano_tables, device=self.device)
            self.heads_fn = make_table_heads_eval(self.cfg)
        elif self.mode == "analytic":
            self.heads_state = None
            self.heads_fn = make_analytic_heads_eval(self.cfg)
        else:
            raise NotImplementedError(f"mode {self.mode!r} is not ported")

    def run_pairs(self, n_pairs: int, seed: int = 0,
                  collect_players: bool = False, collect_stats: bool = False,
                  key: Optional[int] = None) -> GameState:
        """2*n_pairs games; even trials have team A on offense first.
        `key` overrides the root_key(seed) derivation (64-bit int)."""
        n_games = 2 * n_pairs
        k = key if key is not None else root_key(seed)
        return simulate_games(self.pack, self.cfg, self.heads_fn,
                              self.heads_state, k, n_games,
                              _fo_alternating(n_games, self.device),
                              collect_players=collect_players,
                              collect_stats=collect_stats)

    def run_pairs_summary(self, n_pairs: int, seed: int = 0,
                          chunk_pairs: int = 32768,
                          collect_stats: bool = False,
                          key: Optional[int] = None) -> ScoreSummary:
        """Market summary for large n: score-only launches of `chunk_pairs`
        pairs whose moments accumulate on the device, finished once.
        `n_pairs` rounds UP to whole launches; the summary's `n` records the
        games simulated.  Launch ci draws from fold_in(root, ci), as the JAX
        package's fold_in(PRNGKey(seed), ci) does."""
        if n_pairs <= 0:
            raise ValueError(f"n_pairs must be positive, got {n_pairs}")
        chunk_pairs = min(chunk_pairs, n_pairs)
        n_chunks = -(-n_pairs // chunk_pairs)
        root = key if key is not None else root_key(seed)
        acc = None
        for ci in range(n_chunks):
            out = self.run_pairs(chunk_pairs, key=fold_in(root, ci),
                                 collect_stats=collect_stats)
            m = score_moments(out.score)
            acc = m if acc is None else acc + m
        return summary_from_moments(acc)


def _fo_alternating(n_games: int, device: torch.device) -> torch.Tensor:
    """First-offense vector of a pairs batch: 0, 1, 0, 1, ..."""
    return torch.arange(n_games, dtype=torch.int32, device=device) % 2

"""Simulation entry point: port of fast_monte_carlo_tpu/api.py (`MatchupRunner`).

A "pair" follows the reference convention: one game with team A receiving
the opening kickoff and one with team B; `n_pairs` counts pairs, so
2 * n_pairs games run with an alternating first-offense vector.

Compute modes:
  'table'    - nano table heads (the main path), tables given as host arrays
  'analytic' - artifact-free closed-form heads
The JAX package's 'exact' mode and its table builds from trained heads are
not ported yet (ROADMAP.md queue 1).

Outputs: `scores_columns`, `players_columns` and `summary_columns` return
the columns of the JAX package's `scores_frame`, `players_frame` and
`summary_frame` (same names, order and values) as a dict of numpy arrays;
the functions of those names wrap them into DataFrames, importing pandas
only there.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
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
from .stats import (PC_ATT, PC_COMP, PC_INT, PC_SACKS, PC_TD, PC_YDS, PLAYER_COLS,
                    ROLE_LABEL, ROLE_PASS, ROLE_REC, ROLE_RUSH)

Columns = Dict[str, np.ndarray]


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
                  collect_players: bool = True, collect_stats: bool = True,
                  key: Optional[int] = None) -> GameState:
        """2*n_pairs games; even trials have team A on offense first.
        collect_stats=False skips the box score, collect_players=False the
        player stats (score-only sweeps).  `key` overrides the
        root_key(seed) derivation (64-bit int)."""
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
                                 collect_players=False, collect_stats=collect_stats)
            m = score_moments(out.score)
            acc = m if acc is None else acc + m
        return summary_from_moments(acc)


def _fo_alternating(n_games: int, device: torch.device) -> torch.Tensor:
    """First-offense vector of a pairs batch: 0, 1, 0, 1, ..."""
    return torch.arange(n_games, dtype=torch.int32, device=device) % 2


def _np(x) -> np.ndarray:
    """A GameState field as numpy, from the card, the CPU or numpy."""
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def scores_columns(out: GameState, team_a: str, team_b: str) -> Columns:
    """Per-game rows (team, opp, pts, opp_pts): 'team' is the side that
    had the ball first in that game."""
    score, fo = _np(out.score), _np(out.fo)
    return {"team": np.where(fo == 0, team_a, team_b),
            "opp": np.where(fo == 0, team_b, team_a),
            "pts": np.where(fo == 0, score[:, 0], score[:, 1]),
            "opp_pts": np.where(fo == 0, score[:, 1], score[:, 0])}


def players_columns(out: GameState, team_a: TeamContext, team_b: TeamContext) -> Columns:
    """Long-format player rows in PLAYER_COLS order: one per tracked slot
    and game where the slot recorded any stat; counts as int, yards rounded
    to 0.1, other roles' columns 0."""
    ps = _np(out.pstats)   # (B, 2, 3, K, 6)
    start = np.where(_np(out.fo) == 0, "A", "B")
    sims = np.arange(ps.shape[0])
    role_cols = {ROLE_PASS: (("pass_att", PC_ATT), ("pass_comp", PC_COMP),
                             ("pass_yds", PC_YDS), ("pass_td", PC_TD), ("INT", PC_INT),
                             ("sacks", PC_SACKS)),
                 ROLE_RUSH: (("rush_att", PC_ATT), ("rush_yds", PC_YDS), ("rush_td", PC_TD)),
                 ROLE_REC: (("tgt", PC_ATT), ("rec", PC_COMP), ("rec_yds", PC_YDS),
                            ("rec_td", PC_TD))}
    teams = (team_a, team_b)
    blocks = []
    for side in (0, 1):
        tc = teams[side]
        for role, table in ((ROLE_PASS, tc.qb), (ROLE_RUSH, tc.rush), (ROLE_REC, tc.target)):
            for k in range(table.k):
                if not table.tracked[k]:
                    continue
                v = ps[:, side, role, k, :]
                used = v.any(axis=1)
                n = int(used.sum())
                if not n:
                    continue
                vv = v[used]
                blk = {c: np.zeros(n, dtype=np.int64) for c in PLAYER_COLS}
                blk.update(sim=sims[used], start=start[used],
                           team=np.full(n, tc.name, dtype=object),
                           opp=np.full(n, teams[1 - side].name, dtype=object),
                           player=np.full(n, table.names[k], dtype=object),
                           role=np.full(n, ROLE_LABEL[role], dtype=object))
                for c, j in role_cols[role]:
                    blk[c] = vv[:, j].round(1) if j == PC_YDS else vv[:, j].astype(int)
                blocks.append(blk)
    if not blocks:
        return {c: np.empty(0, dtype=object) for c in PLAYER_COLS}
    return {c: np.concatenate([b[c] for b in blocks]) for c in PLAYER_COLS}


def summary_columns(scores: Columns) -> Columns:
    """Per team (sorted): mean and sample sd (ddof 1) of its points and its
    opponent's, and its win rate, over `scores_columns` rows."""
    team = np.asarray(scores["team"])
    names = sorted(set(team.tolist()))
    out = {c: [] for c in ("mean_pts", "sd_pts", "mean_opp", "sd_opp", "win_rate")}

    def sd(x):
        return float(np.sqrt(((x - x.mean()) ** 2).sum() / (x.size - 1))) \
            if x.size > 1 else np.nan

    for t in names:
        pts = np.asarray(scores["pts"])[team == t].astype(np.float64)
        opp = np.asarray(scores["opp_pts"])[team == t].astype(np.float64)
        out["mean_pts"].append(pts.mean())
        out["sd_pts"].append(sd(pts))
        out["mean_opp"].append(opp.mean())
        out["sd_opp"].append(sd(opp))
        out["win_rate"].append((pts > opp).mean())
    return {"team": np.asarray(names, dtype=object),
            **{c: np.asarray(v, dtype=np.float64) for c, v in out.items()}}


def scores_frame(out: GameState, team_a: str, team_b: str):
    import pandas as pd

    return pd.DataFrame(scores_columns(out, team_a, team_b))


def _players_df(cols: Columns):
    import pandas as pd

    if not len(cols["sim"]):
        return pd.DataFrame(columns=list(PLAYER_COLS))
    return pd.DataFrame(cols)


def players_frame(out: GameState, team_a: TeamContext, team_b: TeamContext):
    return _players_df(players_columns(out, team_a, team_b))


def summary_frame(sims_df):
    """`summary_columns` of a `scores_frame`, indexed by team."""
    import pandas as pd

    return pd.DataFrame(summary_columns(
        {c: sims_df[c].to_numpy() for c in ("team", "pts", "opp_pts")})).set_index("team")


def simulate_matchup_columns(
    team_a: TeamContext,
    team_b: TeamContext,
    heads=None,
    n: int = 100,
    *,
    cfg: Optional[SimConfig] = None,
    seed: int = 0,
    collect_players: bool = False,
    mode: str = "table",
    shard: bool = False,
    runner: Optional[MatchupRunner] = None,
    key: Optional[int] = None,
) -> Tuple[Columns, Optional[Columns], MatchupRunner]:
    """n pairs of games: (scores columns, player columns or None, runner).
    Table mode needs a runner built with nano_tables (or passes its
    ValueError on); shard=True (trial sharding) is not ported (ROADMAP P9)."""
    if shard:
        raise NotImplementedError("shard=True is not ported yet (ROADMAP.md P9: trial "
                                  "sharding over torch.distributed)")
    runner = runner or MatchupRunner(team_a, team_b, heads, cfg or SimConfig(), mode)
    out = runner.run_pairs(n, seed=seed, collect_players=collect_players, key=key)
    return (scores_columns(out, team_a.name, team_b.name),
            players_columns(out, team_a, team_b) if collect_players else None, runner)


def simulate_matchup(team_a: TeamContext, team_b: TeamContext, heads=None, n: int = 100,
                     **kw):
    """`simulate_matchup_columns` with DataFrames: (sims_df, players_df or
    None, runner)."""
    import pandas as pd

    scores, players, runner = simulate_matchup_columns(team_a, team_b, heads, n, **kw)
    return (pd.DataFrame(scores), None if players is None else _players_df(players),
            runner)

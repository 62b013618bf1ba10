"""Simulation entry point: port of fast_monte_carlo_tpu/api.py (`MatchupRunner`).

A "pair" follows the reference convention: one game with team A receiving
the opening kickoff and one with team B; `n_pairs` counts pairs, so
2 * n_pairs games run with an alternating first-offense vector.

Compute modes:
  'table'    - table heads: nano tables given as host arrays (`nano_tables=`,
               the main path), or built from trained `heads` on the host
               (`ops.table_lookup.build_table_heads`) in the layout that
               `table_quality` names (`table_profiles`), falling back to
               per-head tables where a focus roster keeps the heads apart
  'exact'    - every compiled forest of `heads` evaluated on every play
               (the K5 kernel on the card): the fidelity oracle that table
               mode is held to
  'analytic' - artifact-free closed-form heads
Trained heads come from an artifact directory (`models.heads.load_heads`,
read without sklearn), as arrays (`models.heads.model_heads_from_numpy`) or
from `fixtures.heads`.

A user's run starts from an SP+ sheet and an artifact directory:
`simulate_upcoming_matchup` (with its pandas-free core
`simulate_upcoming_matchup_columns`) builds both teams' contexts
(`data.context.build_team_context_from_sp_flex`) and loads the heads, and
every entry point below takes the same `sp_path=`/`artifact_dir=`/
`focus_csv=` route (memoized contexts, heads and runners), beside the built
inputs the tests and the smoke pass (`runner=`, `contexts=`,
`nano_tables=`).

Outputs: `scores_columns`, `players_columns` and `summary_columns` return
the columns of the JAX package's `scores_frame`, `players_frame` and
`summary_frame` (same names, order and values) as a dict of numpy arrays;
the functions of those names wrap them into DataFrames, importing pandas
only there.  `simulate_live_curve_columns` and `simulate_live_curve` follow
the same pattern.

Live queries resume games from a mid-game `Situation` (`run_live`,
`run_live_batch`, `run_fourth_decision`; `simulate_live_game`,
`simulate_live_curve`, `evaluate_fourth_down`), each from an SP+ sheet
and trained heads or from a built `runner=`.

Weekly slates: `SlateRunner` plays every matchup of a slate in one
`simulate_games` call (direction row gid*2 + off into one pack and one
nano table); `simulate_slate_summaries` runs a slate as a loop of
per-matchup runners or through a `SlateRunner`, and `simulate_slate` as a
loop of per-matchup score frames.  Besides the SP+ sheet and artifacts
they take built inputs, `contexts=` (a pair of `TeamContext`s per game)
and `nano_tables=` (a pair of nano tables per game).  Their DataFrames
wrap pandas-free row cores (`SlateRunner.summary_rows`,
`run_summary_rows`, `simulate_slate_summary_rows`, `simulate_slate_rows`).

Markets that only a joint per-game simulation can price:
`simulate_parlay` (a same-game parlay, its leg correlations and round
robin from one run; takes `runner=` as the live entry points do),
`project_season` (a season win total over a schedule run as a slate) and
`simulate_slate_props` (a prop sheet scanned over a slate), with the
pandas-free cores `simulate_parlay_core`, `project_season_rows` and
`simulate_slate_prop_rows`.

Long sweeps: `simulate_matchup_batched` checkpoints chunks of pairs to
parquet files and resumes past those on disk; its core
`simulate_matchup_batched_chunks` yields each chunk's columns without
pandas.

Several cards: `shard=True` (runners and routes, as in the JAX package)
splits each launch's games over the ranks of `parallel.mesh.trial_group`,
one process a card; a sharded run equals the unsharded one of the same key
bit for bit.  A slate's game layout splits its matchups over the ranks
instead (`SlateRunner.run_summary_rows(mesh=)`; `layout="auto"` picks it
where there is more than one rank).  In a process outside any group both
run in a world of one.
"""
from __future__ import annotations

import copy
import csv
import os
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import edge
from .config import SimConfig
from .data.context import TeamContext, build_team_context_from_sp_flex
from .data.sp import load_sp_flex, norm_team
from .matchup import build_direction
from .models import analytic
from .models.heads import DEFAULT_ARTIFACT_DIR, ModelHeads, load_heads
from .models.tables import (HostTable, coarse_profile, nano_profile, slate_profile,
                            turbo_profile)
from .ops.game import (GameState, Situation, make_analytic_heads_eval,
                       make_exact_heads_eval, simulate_games)
from .ops.pack import pack_heads, pack_matchup, pack_matchups
from .ops.rng import fold_in, root_key
from .ops import table_lookup
from .ops.table_lookup import (TableHeads, build_table_heads, fused_tables_from_heads,
                               make_table_heads_eval, nano_tables_from_heads, pack_tables,
                               pack_tables_multi)
from .parallel.aggregate import (ScoreMoments, ScoreSummary, score_moments,
                                 summary_from_moments)
from .parallel.mesh import (TrialGroup, agree, all_gather_rows, game_group, local_group,
                            simulate_games_sharded, simulate_moments_sharded,
                            trial_group, world_size)
from .stats import (PC_ATT, PC_COMP, PC_INT, PC_SACKS, PC_TD, PC_YDS, PLAYER_COLS,
                    ROLE_LABEL, ROLE_PASS, ROLE_REC, ROLE_RUSH)

Columns = Dict[str, np.ndarray]
FOURTH_CHOICES = ("policy", "go", "fg", "punt")
# the forced first play's draw stream: fold_in(chunk key, 1 << 20), apart
# from any launch index of a run (the counterpart of the JAX package's
# _FORCED_PLAY_STREAM)
FORCED_PLAY_STREAM = 1 << 20
# a Situation's fields as tensors: i32 discrete fields, f32 yardages
_SITUATION_DTYPES = (torch.int32, torch.int32, torch.int32, torch.float32,
                     torch.float32, torch.int32, torch.int32)


def table_profiles(quality: str) -> dict:
    """`build_table_heads`' profiles for a `table_quality` preset, as the
    JAX MatchupRunner maps them:

      nano     the nano layout (down and sd in channels)
      default  per-head tables on the fine and coarse profiles
      coarse   per-head tables on the coarse profile for both
      slate    a fused table on the slate profile (no sd axis), per-head
               tables on that profile where a matchup does not fuse
      fused    a fused table on the coarse profile
      turbo    a fused table on the turbo profile (sized in the JAX
               package for the TPU's vector memory; on the card only a
               smaller preset)

    A fused or nano preset falls back to per-head tables for a focus
    roster whose players the heads split on (on the default profiles,
    'slate' on its own).  Any other name gets the per-head tables on the
    default profiles, as in the JAX package."""
    if quality == "nano":
        return dict(nano=nano_profile())
    if quality == "coarse":
        return dict(fine=coarse_profile(), coarse=coarse_profile())
    if quality == "slate":
        return dict(fine=slate_profile(), coarse=slate_profile(), fused=slate_profile())
    if quality == "turbo":
        return dict(fused=turbo_profile())
    if quality == "fused":
        return dict(fused=coarse_profile())
    return {}


@dataclass
class MatchupRunner:
    """Simulator for one matchup (both orderings) on one device.

    Table mode takes `nano_tables` (host tables for A and B on offense,
    e.g. fixtures.nano_tables(seed)) or builds its tables from trained
    `heads` in the `table_quality` preset (`table_profiles`); exact mode
    takes `heads`.  `coach_map` names each team's head coach
    for the play head (default matchup.DEFAULT_HEAD_COACH_MAP).  `device`
    defaults to the card ('cuda'), which raises where CUDA is absent; the
    CPU runs only when asked for ('cpu').  The runner plays on its
    `TrialGroup` (`group`): a world of one on `device`, or with `shard=True`
    the ranks of `parallel.mesh.trial_group` and this rank's device.
    `run_pairs`, `run_pairs_summary` and `run_live` split each launch's
    games over the group, while `run_live_batch` and `run_fourth_decision`
    run whole on each rank, as in the JAX package."""

    team_a: TeamContext
    team_b: TeamContext
    heads: Optional[ModelHeads] = None
    cfg: SimConfig = field(default_factory=SimConfig)
    mode: str = "table"
    table_quality: str = "nano"
    nano_tables: Optional[Tuple[HostTable, HostTable]] = None
    device: Optional[object] = None   # 'cuda' (None), 'cuda:0' or 'cpu'
    shard: bool = False   # trial sharding over the ranks of parallel.mesh.trial_group
    coach_map: Optional[Dict[str, str]] = None

    def __post_init__(self):
        self.group = (trial_group if self.shard else local_group)(self.device)
        self.device = self.group.device
        # where the build fails on one rank (its tables, its card's memory),
        # every rank raises here
        agree(self.group, self._build)

    def _build(self) -> None:
        """The matchup's pack and heads (tables, forests or none) on the
        device."""
        self.pack = pack_matchup(
            build_direction(self.team_a, self.team_b, self.cfg, self.heads, self.coach_map),
            build_direction(self.team_b, self.team_a, self.cfg, self.heads, self.coach_map),
            self.device)
        if self.mode == "table":
            if self.nano_tables is not None and self.heads is not None:
                raise ValueError("table mode takes nano_tables or heads, not both")
            if self.nano_tables is not None:
                if self.table_quality != "nano":
                    raise ValueError(f"nano_tables are nano-layout tables; table_quality="
                                     f"{self.table_quality!r} builds its tables from heads")
                self.heads_state = pack_tables(*self.nano_tables, device=self.device)
            elif self.heads is not None:
                _need_table_heads(self.heads)
                self.heads_state = build_table_heads(
                    self.team_a, self.team_b, self.heads, self.cfg, self.coach_map,
                    device=self.device, **table_profiles(self.table_quality))
            else:
                raise ValueError("table mode needs nano_tables (e.g. "
                                 "fixtures.nano_tables(seed)) or trained heads")
            self.heads_fn = make_table_heads_eval(self.cfg)
        elif self.mode == "exact":
            if self.heads is None or self.heads.stage1 is None or not all(
                    (self.heads.pass_quants, self.heads.rush_quants, self.heads.sack_quants)):
                raise ValueError("exact mode needs trained heads with stage 1 and the "
                                 "pass, rush and sack quantile forests")
            self.heads_state = pack_heads(self.heads, self.device)
            self.heads_fn = make_exact_heads_eval(self.cfg)
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
        root_key(seed) derivation (64-bit int).  Sharded, 2*n_pairs must be
        a multiple of the world size (ValueError: the games are returned,
        so nothing rounds up) and every rank returns all of them."""
        n_games = 2 * n_pairs
        return simulate_games_sharded(self.pack, self.cfg, self.heads_fn, self.heads_state,
                                      key if key is not None else root_key(seed), n_games,
                                      _fo_alternating(n_games, self.device), self.group,
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
        package's fold_in(PRNGKey(seed), ci) does.  Sharded, the chunk rounds
        up to a multiple of the world size and each launch's moments are
        summed over the ranks (`simulate_moments_sharded`)."""
        if n_pairs <= 0:
            raise ValueError(f"n_pairs must be positive, got {n_pairs}")
        world = self.group.world
        chunk_pairs = -(-min(chunk_pairs, n_pairs) // world) * world
        n_chunks = -(-n_pairs // chunk_pairs)
        root = key if key is not None else root_key(seed)
        fo = _fo_alternating(2 * chunk_pairs, self.device)
        acc = None
        for ci in range(n_chunks):
            m = simulate_moments_sharded(self.pack, self.cfg, self.heads_fn, self.heads_state,
                                         fold_in(root, ci), 2 * chunk_pairs, fo, self.group,
                                         collect_stats=collect_stats)
            acc = m if acc is None else acc + m
        return summary_from_moments(acc)


    def run_live(self, situation: Situation, n_games: int = 65536, seed: int = 0,
                 chunk_games: int = 65536, key: Optional[int] = None) -> ScoreSummary:
        """Live win probability: the ScoreSummary of n_games score-only
        games resumed from one mid-game `situation`, for the markets of
        `edge.market_odds_from_summary` and `edge.summary_moneyline`.
        Launches of `chunk_games` games draw from fold_in(root, ci) and
        accumulate moments on the device, finished once; n_games rounds UP
        to whole launches and the summary's `n` records the games run.
        Late-game states finish in a chunk or two of plays.  Sharded, the
        chunk rounds up to a multiple of the world size and every rank
        holds the situation."""
        if n_games <= 0:
            raise ValueError(f"n_games must be positive, got {n_games}")
        sit = _device_situation(_validated_situation(situation, self.cfg), self.device)
        return self._live_summary(sit, n_games, chunk_games,
                                  key if key is not None else root_key(seed))

    def run_live_batch(self, situations: Sequence[Situation], n_games_per: int = 8192,
                       seed: int = 0, key: Optional[int] = None) -> ScoreSummary:
        """The win-probability curve: S situations x n_games_per games in
        one `simulate_games` call, trial i resuming from situation
        i // n_games_per, reduced per situation on the device.  Returns a
        ScoreSummary whose fields carry a leading S axis in input order."""
        if not situations:
            raise ValueError("run_live_batch needs at least one situation")
        if n_games_per <= 0:
            raise ValueError(f"n_games_per must be positive, got {n_games_per}")
        sits = [_validated_situation(s, self.cfg) for s in situations]
        batch = _device_situation(
            Situation(*([getattr(s, f) for s in sits] for f in Situation._fields)),
            self.device)
        per = Situation(*(torch.repeat_interleave(v, n_games_per) for v in batch))
        n = len(sits) * n_games_per
        out = simulate_games(self.pack, self.cfg, self.heads_fn, self.heads_state,
                             key if key is not None else root_key(seed), n, 0,
                             collect_players=False, collect_stats=False, situation=per)
        return summary_from_moments(score_moments(out.score.view(len(sits), n_games_per, 2)))

    def run_fourth_decision(self, situation: Situation, n_games: int = 65536,
                            seed: int = 0, chunk_games: int = 65536,
                            choices=FOURTH_CHOICES,
                            key: Optional[int] = None) -> Dict[str, ScoreSummary]:
        """Win probability of each 4th-down choice from one down-4
        situation: {choice: ScoreSummary}.  'go', 'fg' and 'punt' force the
        first play that way (one play under fourth.force, drawing from its
        own stream), after which the game goes on under the runner's
        config; 'policy' is the unforced live run.  Every choice's
        continuation draws the same chunk keys from absolute step 0 (common
        random numbers), so the differences between choices carry far less
        Monte-Carlo noise than independent runs."""
        if n_games <= 0:
            raise ValueError(f"n_games must be positive, got {n_games}")
        if not choices:
            raise ValueError("choices must name at least one of policy | go | fg | punt")
        sit = _validated_situation(situation, self.cfg)
        if not isinstance(sit.down, (int, np.integer)) or int(sit.down) != 4:
            raise ValueError("run_fourth_decision needs a concrete down=4 situation "
                             f"(got down={sit.down!r})")
        for choice in choices:
            if choice not in FOURTH_CHOICES:
                raise ValueError(f"unknown 4th-down choice {choice!r} "
                                 "(want policy | go | fg | punt)")
        dsit = _device_situation(sit, self.device)
        root = key if key is not None else root_key(seed)
        whole = self.sharded(False)     # every choice on this rank's card alone
        return {c: whole._live_summary(dsit, n_games, chunk_games, root,
                                       None if c == "policy" else c)
                for c in choices}

    def _live_summary(self, sit: Situation, n_games: int, chunk_games: int, root: int,
                      force: Optional[str] = None) -> ScoreSummary:
        """Launches of min(chunk_games, n_games) games (rounded up to a
        multiple of the world size) resumed from `sit`, launch ci under
        fold_in(root, ci) and split over the group, their moments
        accumulated and finished once.  `force` (a 4th-down choice) runs
        on a world of one."""
        world = self.group.world
        chunk = -(-min(chunk_games, n_games) // world) * world
        acc = None
        for ci in range(-(-n_games // chunk)):
            m = (self._forced_moments(fold_in(root, ci), sit, chunk, force) if force else
                 simulate_moments_sharded(self.pack, self.cfg, self.heads_fn,
                                          self.heads_state, fold_in(root, ci), chunk, 0,
                                          self.group, situation=sit))
            acc = m if acc is None else acc + m
        return summary_from_moments(acc)

    def sharded(self, shard: bool = True) -> "MatchupRunner":
        """This runner on the trial group (`shard`) or on a world of one,
        sharing its pack and tables (no rebuild): how a route honours
        shard= on a given `runner=`."""
        if shard == self.shard:
            return self
        r = copy.copy(self)
        r.shard = shard
        r.group = (trial_group if shard else local_group)(self.device)
        return r

    def _forced_moments(self, key: int, sit: Situation, n: int, force: str) -> ScoreMoments:
        """ScoreMoments of n score-only games resumed from `sit` under
        launch key `key`, the first play under fourth.force = force on
        draws of its own, step 0 of fold_in(key, FORCED_PLAY_STREAM); the
        game continues from there on the same draws as the unforced run.
        One launch of the engine (K1 on the card for table heads)."""
        out = simulate_games(self.pack, self.cfg, self.heads_fn, self.heads_state, key, n, 0,
                             collect_players=False, collect_stats=False, situation=sit,
                             first_play_force=force,
                             first_play_key=fold_in(key, FORCED_PLAY_STREAM))
        return score_moments(out.score)


def _need_table_heads(heads: ModelHeads) -> None:
    """Every table build reads stage 1 and the three quantile trios."""
    if heads.stage1 is None or not all(
            (heads.pass_quants, heads.rush_quants, heads.sack_quants)):
        raise ValueError("table mode from heads needs trained heads with stage 1 and the "
                         "pass, rush and sack quantile forests (an artifact directory "
                         "without them loads as empty heads)")


def situation_from_fields(*, ytg, offense=0, sec=None, quarter=None, clock=None,
                          down=1, dist=10.0, score_a=0, score_b=0,
                          cfg: Optional[SimConfig] = None) -> Situation:
    """The one parser for human-facing situation input: `offense` is 'A'/'B'
    or 0/1; time is `sec` (seconds left in the game) or `quarter` (1-4) with
    `clock` 'MM:SS' left in that quarter (default 15:00)."""
    cfg = cfg or SimConfig()
    if sec is None:
        if quarter is None:
            raise ValueError("a situation needs sec= or quarter= "
                             "(+ optional clock='MM:SS')")
        q = int(quarter)
        if not 1 <= q <= 4:
            raise ValueError(f"quarter must be 1..4, got {q}")
        mm, ss = str(clock if clock is not None else "15:00").split(":")
        sec = (4 - q) * cfg.clock.quarter_seconds + int(mm) * 60 + int(ss)
    if isinstance(offense, str):
        o = {"a": 0, "b": 1}.get(offense.strip().lower())
        if o is None:
            raise ValueError("offense must be 'A', 'B', 0, or 1")
        offense = o
    return Situation(offense=int(offense), sec=int(sec), down=int(down),
                     dist=float(dist), ytg=float(ytg),
                     score_a=int(score_a), score_b=int(score_b))


def _validated_situation(sit: Situation, cfg: SimConfig) -> Situation:
    """Host-side bounds on the fields that are numbers (tensors pass
    through).  Scores stay under 128, the histograms' support."""
    def _num(v):
        return isinstance(v, (int, float, np.integer, np.floating))

    if _num(sit.offense) and int(sit.offense) not in (0, 1):
        raise ValueError(f"offense must be 0 (team A) or 1, got {sit.offense}")
    if _num(sit.sec) and not 1 <= int(sit.sec) <= cfg.clock.game_seconds:
        raise ValueError(
            f"sec must be in [1, {cfg.clock.game_seconds}], got {sit.sec}")
    if _num(sit.down) and not 1 <= int(sit.down) <= 4:
        raise ValueError(f"down must be 1..4, got {sit.down}")
    if _num(sit.ytg) and not 1.0 <= float(sit.ytg) <= 99.0:
        raise ValueError(f"ytg must be in [1, 99], got {sit.ytg}")
    if _num(sit.dist) and not 0.0 < float(sit.dist) <= 99.0:
        raise ValueError(f"dist must be in (0, 99], got {sit.dist}")
    for nm in ("score_a", "score_b"):
        v = getattr(sit, nm)
        if _num(v) and not 0 <= int(v) < 128:
            raise ValueError(f"{nm} must be in [0, 128), got {v}")
    return sit


def _device_situation(sit: Situation, device: torch.device) -> Situation:
    """`sit` as tensors of fixed dtypes on `device` (0-d, or (S,) from lists)."""
    return Situation(*(torch.as_tensor(v, dtype=dt, device=device)
                       for v, dt in zip(sit, _SITUATION_DTYPES)))


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
    device=None,
) -> Tuple[Columns, Optional[Columns], MatchupRunner]:
    """n pairs of games: (scores columns, player columns or None, runner).
    Without `runner`, a MatchupRunner of `heads` in `mode` on `device` (the
    card by default); shard=True splits the games over the ranks
    (`MatchupRunner.run_pairs`), a given runner's tables shared."""
    runner = (runner.sharded(shard) if runner is not None else
              MatchupRunner(team_a, team_b, heads, cfg or SimConfig(), mode, device=device,
                            shard=shard))
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


# ---- checkpointed sweeps ------------------------------------------------------------

# The chunk-key convention of a run directory: chunk ci plays under
# fold_in(root_key(seed), ci) on the port's Philox stream.  The JAX package
# writes "fold_in-v2" for its threefry games; the tags differ so that
# neither package resumes the other's directory into one dataset.
_CHUNK_KEY_SCHEME = "torch-philox-fold_in-v1"


def simulate_matchup_batched_chunks(
    team_a: TeamContext,
    team_b: TeamContext,
    heads,
    n_pairs_total: int,
    batch_pairs: int,
    *,
    cfg: Optional[SimConfig] = None,
    seed: int = 0,
    mode: str = "table",
    collect_players: bool = False,
    done=(),
    runner: Optional[MatchupRunner] = None,
    device=None,
):
    """The pandas-free core of `simulate_matchup_batched`: yields (ci,
    scores columns, player columns or None) for each chunk ci of
    ceil(n_pairs_total / batch_pairs) not in `done`, chunk ci being
    min(batch_pairs, what is left) pairs under fold_in(root_key(seed), ci)
    (`simulate_matchup_columns(key=...)`).  One runner plays every chunk:
    `runner`, or one built at the first chunk played."""
    if batch_pairs <= 0 or n_pairs_total <= 0:
        raise ValueError(f"n_pairs_total and batch_pairs must be positive, got "
                         f"{n_pairs_total} and {batch_pairs}")
    cfg = cfg or SimConfig()
    root = root_key(seed)
    for ci in range(-(-n_pairs_total // batch_pairs)):
        if ci in done:
            continue
        pairs = min(batch_pairs, n_pairs_total - ci * batch_pairs)
        scores, players, runner = simulate_matchup_columns(
            team_a, team_b, heads, pairs, cfg=cfg, key=fold_in(root, ci),
            collect_players=collect_players, mode=mode, runner=runner, device=device)
        yield ci, scores, players


def simulate_matchup_batched(
    team_a: TeamContext,
    team_b: TeamContext,
    heads,
    n_pairs_total: int,
    batch_pairs: int,
    run_dir: str,
    *,
    cfg: Optional[SimConfig] = None,
    seed: int = 0,
    mode: str = "table",
    collect_players: bool = False,
    runner: Optional[MatchupRunner] = None,
    device=None,
):
    """A checkpointed long sweep: chunks of `batch_pairs` pairs written to
    `run_dir` as scores_chunk_NNNNN.parquet (players_chunk_NNNNN.parquet
    with collect_players), each to a .tmp file renamed when whole.  A
    second call skips the chunks on disk, so a killed sweep goes on where it
    stopped.  Returns the scores of every chunk as one DataFrame (pandas
    imported here).

    run_dir/KEY_SCHEME records the chunk-key convention
    (`_CHUNK_KEY_SCHEME`); a directory with another tag, or with chunks and
    no tag, is refused rather than resumed."""
    import pandas as pd

    d = Path(run_dir)
    d.mkdir(parents=True, exist_ok=True)
    scheme = d / "KEY_SCHEME"
    if scheme.exists():
        tag = scheme.read_text().strip()
        if tag != _CHUNK_KEY_SCHEME:
            raise ValueError(
                f"{run_dir} was written under chunk-key scheme {tag!r}; "
                f"this build uses {_CHUNK_KEY_SCHEME!r}. Resuming would mix "
                "two RNG conventions in one dataset — use a fresh run_dir "
                "(or delete the old chunks to restart).")
    elif any(d.glob("scores_chunk_*.parquet")):
        raise ValueError(
            f"{run_dir} holds chunks with no KEY_SCHEME marker (written "
            "before the fold_in chunk-key change). Resuming would splice "
            "two RNG conventions — use a fresh run_dir or delete the old "
            "chunks.")
    else:
        scheme.write_text(_CHUNK_KEY_SCHEME + "\n")

    def chunk_path(ci: int) -> Path:
        return d / f"scores_chunk_{ci:05d}.parquet"

    n_chunks = -(-n_pairs_total // max(batch_pairs, 1))
    done = {ci for ci in range(n_chunks) if chunk_path(ci).exists()}
    frames = {ci: pd.read_parquet(chunk_path(ci)) for ci in sorted(done)}
    for ci, scores, players in simulate_matchup_batched_chunks(
            team_a, team_b, heads, n_pairs_total, batch_pairs, cfg=cfg, seed=seed,
            mode=mode, collect_players=collect_players, done=done, runner=runner,
            device=device):
        sims_df = pd.DataFrame(scores)
        tmp = chunk_path(ci).with_suffix(".tmp")
        sims_df.to_parquet(tmp, index=False)
        tmp.rename(chunk_path(ci))
        if players is not None:
            _players_df(players).to_parquet(d / f"players_chunk_{ci:05d}.parquet",
                                            index=False)
        frames[ci] = sims_df
    return pd.concat([frames[ci] for ci in sorted(frames)], ignore_index=True)


# ---- a user's run: an SP+ sheet and an artifact directory ---------------------

def csv_base_from(team_a: str, team_b: str, week: int, ext: str = ".csv") -> str:
    return f"{norm_team(team_a)}_{norm_team(team_b)}_wk{int(week)}_sims{ext}"


def _sheet_contexts(teams, sp_df, year: int, week: int, focus_csv, cfg: SimConfig):
    """The memoized TeamContext of each of `teams` from an SP+ table."""
    return tuple(build_team_context_from_sp_flex(t, year, week, sp_df, focus_csv=focus_csv,
                                                 player_slots=cfg.engine.player_slots)
                 for t in teams)


def _one_of(what: str, built: str, given: bool, sp_path, focus_csv) -> None:
    """A route takes the built input `built`= (`given`) or the SP+ sheet at
    `sp_path`: exactly one of the two, else ValueError."""
    if given and (sp_path is not None or focus_csv is not None):
        raise ValueError(f"{what}: pass {built}= or sp_path= (with artifact_dir= and "
                         "focus_csv=), not both")
    if not given and sp_path is None:
        raise ValueError(f"{what} needs sp_path= (an SP+ sheet; the heads come from "
                         f"artifact_dir=) or {built}=")


def _agreed(sharded: bool, device, fn):
    """fn(), a sharded route's host set-up before its first launch (its
    sheet, heads and runner), under one `agree` over the ranks of
    `trial_group(device)`, so that a rank whose set-up fails fails every
    rank there; unsharded, fn() alone."""
    return agree(trial_group(device), fn) if sharded else fn()


def simulate_upcoming_matchup_columns(
    team_a: str,
    team_b: str,
    *,
    year: int = 2025,
    week: int = 1,
    sp_path: str,
    artifact_dir: str = DEFAULT_ARTIFACT_DIR,
    focus_csv: Optional[str] = None,
    n: int = 1000,
    seed: int = 0,
    collect_players: bool = True,
    save_csv: Optional[str] = None,
    mode: str = "table",
    shard: bool = False,
    cfg: Optional[SimConfig] = None,
    heads: Optional[ModelHeads] = None,
    device=None,
):
    """The JAX package's `simulate_upcoming_matchup` without pandas: both
    teams' contexts from the SP+ sheet at `sp_path` (rosters from
    `focus_csv`), the heads of `artifact_dir` (or `heads`), n pairs of games
    on a new MatchupRunner (`simulate_matchup_columns`), and with `save_csv`
    the frames written (`_save_frames`).  Returns (scores columns, player
    columns or None, summary columns, ctx_a, ctx_b, meta), meta with the
    simulation's and the write's host seconds."""
    cfg = cfg or SimConfig()

    def setup():
        ab = _sheet_contexts((team_a, team_b), load_sp_flex(sp_path), year, week, focus_csv,
                             cfg)
        return ab, heads if heads is not None else load_heads(artifact_dir)

    (a, b), heads = _agreed(shard, device, setup)
    t0 = time.perf_counter()
    scores, players, _ = simulate_matchup_columns(
        a, b, heads, n, cfg=cfg, seed=seed, collect_players=collect_players, mode=mode,
        shard=shard, device=device)
    sim_time = time.perf_counter() - t0

    summary = summary_columns(scores)
    write_time = 0.0
    if save_csv:
        t_w = time.perf_counter()
        _save_frames(save_csv, scores, players)
        write_time = time.perf_counter() - t_w
    meta = {"sim_time_sec": sim_time, "io_time_sec": write_time,
            "total_time_sec": sim_time + write_time, "sims": n, "mode": mode}
    return scores, players, summary, a, b, meta


def simulate_upcoming_matchup(team_a: str, team_b: str, **kw):
    """`simulate_upcoming_matchup_columns` with DataFrames, as the JAX
    package returns them: (sims_df, players_df or None, summary indexed by
    team, ctx_a, ctx_b, meta)."""
    import pandas as pd

    scores, players, summary, a, b, meta = simulate_upcoming_matchup_columns(
        team_a, team_b, **kw)
    return (pd.DataFrame(scores), None if players is None else _players_df(players),
            pd.DataFrame(summary).set_index("team"), a, b, meta)


def _csv_cells(col) -> list:
    """A column's cells as pandas' to_csv writes them, converted at once:
    missing values empty, numpy scalars by their shortest repr (float32 as
    float32; a float column's distinct values once)."""
    col = np.asarray(col)
    if col.dtype.kind in "iub":
        return col.astype(str).tolist()
    if col.dtype.kind == "f":     # distinct by bits: -0.0 writes as "-0.0"
        bits, where = np.unique(col.view(f"i{col.itemsize}"), return_inverse=True)
        return np.where(np.isnan(col), "", bits.view(col.dtype).astype(str)[where]).tolist()
    missing = (col != col) | (col == None)  # noqa: E711 (elementwise: NaN or None)
    return np.where(missing, "", col.astype(str)).tolist()


def _write_columns_csv(path: str, cols: Columns) -> None:
    """Columns written as pandas' `DataFrame(cols).to_csv(path, index=False)`
    writes them, by `csv`'s writer, which quotes as pandas does."""
    names = list(cols)
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(names)
        w.writerows(zip(*(_csv_cells(cols[c]) for c in names)))


def _save_frames(save_csv: str, scores: Columns, players: Optional[Columns]) -> None:
    """`scores_<save_csv>` and `players_<save_csv>` in the working
    directory: CSV through `csv`, or parquet (a `.parquet` name) through
    pandas imported here; on any failure, CSV at `<name>.csv`, as the JAX
    package falls back."""
    try:
        if save_csv.lower().endswith(".parquet"):
            import pandas as pd

            pd.DataFrame(scores).to_parquet(f"scores_{save_csv}", index=False)
            if players is not None:
                _players_df(players).to_parquet(f"players_{save_csv}", index=False)
        else:
            _write_columns_csv(f"scores_{save_csv}", scores)
            if players is not None:
                _write_columns_csv(f"players_{save_csv}", players)
    except Exception:
        _write_columns_csv(f"scores_{save_csv}.csv", scores)
        if players is not None:
            _write_columns_csv(f"players_{save_csv}.csv", players)


def _prepared_contexts(team_a, team_b, *, sp_path, year, week, artifact_dir,
                       focus_csv, cfg):
    """The memoized cold-path loads the single-matchup entry points share:
    (heads, ctx_a, ctx_b, cfg) — everything needed to validate a request,
    before the runner's table build."""
    cfg = cfg or SimConfig()
    heads = load_heads(artifact_dir)
    a, b = _sheet_contexts((team_a, team_b), load_sp_flex(sp_path), year, week, focus_csv, cfg)
    return heads, a, b, cfg


def _prepared_runner(team_a, team_b, *, sp_path, year, week, artifact_dir,
                     focus_csv, mode, table_quality, cfg, shard, device):
    """`_prepared_contexts` plus the runner memo (which builds the matchup's
    tables), agreed over the ranks where sharded.  Returns (runner, ctx_a,
    ctx_b, cfg)."""
    def setup():
        heads, a, b, c = _prepared_contexts(
            team_a, team_b, sp_path=sp_path, year=year, week=week,
            artifact_dir=artifact_dir, focus_csv=focus_csv, cfg=cfg)
        return _runner_for(a, b, None, c, mode, table_quality, shard, device, heads), a, b, c

    return _agreed(shard, device, setup)


def _route_runner(what: str, runner, team_a: str, team_b: str, **kw) -> "MatchupRunner":
    """The given `runner` (sharded as `shard` says), or the memoized runner
    of the SP+ sheet route (`_prepared_runner(team_a, team_b, **kw)`); one
    of the two, not both."""
    _one_of(what, "runner", runner is not None, kw["sp_path"], kw["focus_csv"])
    if runner is not None:
        return runner.sharded(kw["shard"])
    return _prepared_runner(team_a, team_b, **kw)[0]


# ---- live entry points --------------------------------------------------------

_NP_DTYPES = {torch.float32: np.float32, torch.int32: np.int32}


def host_summaries(*summaries: ScoreSummary) -> List[ScoreSummary]:
    """ScoreSummaries as numpy, by one device-to-host copy of all their
    fields (each float64 on the way, exact for f32 and int32)."""
    fields = [f for s in summaries for f in s]
    flat = torch.cat([f.reshape(-1).to(torch.float64) for f in fields]).cpu().numpy()
    out, i = [], 0
    for f in fields:
        out.append(flat[i:i + f.numel()].reshape(tuple(f.shape)).astype(_NP_DTYPES[f.dtype]))
        i += f.numel()
    k = len(ScoreSummary._fields)
    return [ScoreSummary(*out[j:j + k]) for j in range(0, len(out), k)]


def _situation_fields(sit: Situation) -> dict:
    return {"offense": int(sit.offense), "sec": int(sit.sec), "down": int(sit.down),
            "dist": float(sit.dist), "ytg": float(sit.ytg),
            "score_a": int(sit.score_a), "score_b": int(sit.score_b)}


def simulate_live_game(team_a: str, team_b: str, situation: Situation, *,
                       sp_path: Optional[str] = None, year: int = 2025, week: int = 1,
                       n_games: int = 65536, artifact_dir: str = DEFAULT_ARTIFACT_DIR,
                       focus_csv: Optional[str] = None, mode: str = "table",
                       table_quality: str = "nano", cfg: Optional[SimConfig] = None,
                       seed: int = 0, shard: bool = False, chunk_games: int = 65536,
                       runner: Optional[MatchupRunner] = None, device=None):
    """Live win probability and market distribution for one matchup:
    (row, ScoreSummary in numpy).  `row` is the headline dict of the JAX
    package's `simulate_live_game` (win and tie rates, means, sds); the
    summary's histograms price live markets through
    `edge.market_odds_from_summary` and `edge.summary_moneyline`.  The
    runner is the memoized one of the SP+ sheet at `sp_path` and the heads
    of `artifact_dir` on `device`, or a built `runner=`; shard=True splits
    each launch over the ranks (`MatchupRunner.run_live`)."""
    runner = _route_runner("simulate_live_game", runner, team_a, team_b, sp_path=sp_path,
                           year=year, week=week, artifact_dir=artifact_dir,
                           focus_csv=focus_csv, mode=mode, table_quality=table_quality,
                           cfg=cfg, shard=shard, device=device)
    s, = host_summaries(runner.run_live(situation, n_games=n_games, seed=seed,
                                        chunk_games=chunk_games))
    row = {
        "team_a": team_a, "team_b": team_b, **_situation_fields(situation),
        "win_a": float(s.win_rate[0]), "win_b": float(s.win_rate[1]),
        "tie": float(s.tie_rate),
        "mean_a": float(s.mean_pts[0]), "mean_b": float(s.mean_pts[1]),
        "sd_a": float(s.sd_pts[0]), "sd_b": float(s.sd_pts[1]),
        "mean_margin_a": float(s.mean_pts[0] - s.mean_pts[1]),
        "mean_total": float(s.mean_pts[0] + s.mean_pts[1]),
        "n_games": int(s.n),
    }
    return row, s


def simulate_live_curve_columns(team_a: str, team_b: str, situations, *,
                                sp_path: Optional[str] = None, year: int = 2025,
                                week: int = 1, n_games_per: int = 8192,
                                artifact_dir: str = DEFAULT_ARTIFACT_DIR,
                                focus_csv: Optional[str] = None, mode: str = "table",
                                table_quality: str = "nano",
                                cfg: Optional[SimConfig] = None, seed: int = 0,
                                runner: Optional[MatchupRunner] = None,
                                device=None) -> Tuple[Columns, ScoreSummary]:
    """The win-probability curve (`MatchupRunner.run_live_batch`): the
    columns of the JAX package's `simulate_live_curve` frame, one row per
    situation in input order, and the summary (numpy, a leading S axis).
    The runner comes as in `simulate_live_game`."""
    runner = _route_runner("simulate_live_curve", runner, team_a, team_b, sp_path=sp_path,
                           year=year, week=week, artifact_dir=artifact_dir,
                           focus_csv=focus_csv, mode=mode, table_quality=table_quality,
                           cfg=cfg, shard=False, device=device)
    s, = host_summaries(runner.run_live_batch(situations, n_games_per=n_games_per,
                                              seed=seed))
    rows = []
    for i, sit in enumerate(situations):
        rows.append({
            "team_a": team_a, "team_b": team_b, **_situation_fields(sit),
            "win_a": float(s.win_rate[i, 0]), "win_b": float(s.win_rate[i, 1]),
            "tie": float(s.tie_rate[i]),
            "mean_a": float(s.mean_pts[i, 0]), "mean_b": float(s.mean_pts[i, 1]),
            "mean_margin_a": float(s.mean_pts[i, 0] - s.mean_pts[i, 1]),
            "mean_total": float(s.mean_pts[i, 0] + s.mean_pts[i, 1]),
            "n_games": int(s.n[i]),
        })
    cols = {c: np.asarray([r[c] for r in rows],
                          dtype=object if isinstance(rows[0][c], str) else None)
            for c in rows[0]}
    return cols, s


def simulate_live_curve(team_a: str, team_b: str, situations, **kw):
    """`simulate_live_curve_columns` as (DataFrame, summary)."""
    import pandas as pd

    cols, s = simulate_live_curve_columns(team_a, team_b, situations, **kw)
    return pd.DataFrame(cols), s


def evaluate_fourth_down(team_a: str, team_b: str, situation: Situation, *,
                         sp_path: Optional[str] = None, year: int = 2025, week: int = 1,
                         n_games: int = 65536, artifact_dir: str = DEFAULT_ARTIFACT_DIR,
                         focus_csv: Optional[str] = None, mode: str = "table",
                         table_quality: str = "nano", cfg: Optional[SimConfig] = None,
                         seed: int = 0, chunk_games: int = 65536, choices=FOURTH_CHOICES,
                         runner: Optional[MatchupRunner] = None, device=None) -> dict:
    """The 4th-down chart (`MatchupRunner.run_fourth_decision`): the
    offense's win probability under each forced choice beside the
    engine's own policy, as the JAX package's dict: {"team_a", "team_b",
    "situation", "choices": {choice: row} in sorted order, "best",
    "se_pp"} and, with "policy" priced, "best_vs_policy_pp".  'fg' rows
    carry the kick's make probability.  The runner comes as in
    `simulate_live_game`."""
    runner = _route_runner("evaluate_fourth_down", runner, team_a, team_b, sp_path=sp_path,
                           year=year, week=week, artifact_dir=artifact_dir,
                           focus_csv=focus_csv, mode=mode, table_quality=table_quality,
                           cfg=cfg, shard=False, device=device)
    cfg = runner.cfg
    summaries = runner.run_fourth_decision(situation, n_games=n_games, seed=seed,
                                           chunk_games=chunk_games, choices=choices)
    # choices in sorted order, as the JAX package's fetch_tree flattens
    # the dict (it decides `best` among equal rates)
    names = sorted(summaries)
    fetched = dict(zip(names, host_summaries(*(summaries[c] for c in names))))
    off = int(situation.offense)
    out = {}
    for choice, s in fetched.items():
        row = {
            "win_off": round(float(s.win_rate[off]), 6),
            "win_a": round(float(s.win_rate[0]), 6),
            "win_b": round(float(s.win_rate[1]), 6),
            "tie": round(float(s.tie_rate), 6),
            "mean_margin_off": round(
                float(s.mean_pts[0] - s.mean_pts[1]) * (1 - 2 * off), 3),
            "n_games": int(s.n),
        }
        if choice == "fg":
            row["fg_make_prob"] = round(float(analytic.field_goal_prob(
                torch.tensor(float(situation.ytg) + cfg.st.fg_snap_plus_endzone), cfg)), 4)
        out[choice] = row
    forced = [c for c in out if c != "policy"]
    best = max(forced, key=lambda c: out[c]["win_off"]) if forced else None
    p = out[best]["win_off"] if best else next(iter(out.values()))["win_off"]
    res = {
        "team_a": team_a, "team_b": team_b,
        "situation": _situation_fields(situation),
        "choices": out, "best": best,
        "se_pp": round(100 * float(np.sqrt(max(p * (1 - p), 1e-12) / max(n_games, 1))), 3),
    }
    if best is not None and "policy" in out:
        res["best_vs_policy_pp"] = round((out[best]["win_off"] - out["policy"]["win_off"]) * 100,
                                         2)
    return res


# ---- weekly slates ------------------------------------------------------------

# SlateRunner's fused profile by quality (the JAX SlateRunner's mapping);
# any other quality but 'nano' gets the coarse profile
SLATE_PROFILES = {"turbo": turbo_profile, "nano": nano_profile}


def _block_width(g: int, world: int, cfg: SimConfig) -> int:
    """Matchups a rank holds in the game layout: ceil(g / world), even
    under antithetic draws so that no block splits a mirrored block of
    four games (its first game g0*2*chunk_pairs is a multiple of 4 for any
    chunk)."""
    blk = -(-g // world)
    return blk + blk % 2 if cfg.engine.antithetic else blk


def _game_block(g: int, group: TrialGroup, cfg: SimConfig) -> Tuple[int, int]:
    """(g0, g1): rank group.rank's contiguous block of a slate of g
    matchups in the game layout (the last blocks shorter or empty)."""
    blk = _block_width(g, group.world, cfg)
    g0 = min(g, group.rank * blk)
    return g0, min(g, g0 + blk)


@dataclass
class SlateRunner:
    """Every matchup of a slate in one `simulate_games` call on one device.

    `__post_init__` packs both directions of each matchup into one
    `MatchupPack` and their tables into one table, rows [g0 A-off,
    g0 B-off, g1 A-off, ...]; a game reads direction row gid*2 + off.  In a
    run of n_pairs_per_game pairs, game t belongs to matchup
    t // (2*n_pairs_per_game) and has team (t % 2) on offense first.

    `run` is one launch that returns the final state (`summary_rows` or
    `summaries` read it; with `shard=True` its games split over the ranks
    of `parallel.mesh.trial_group`, their game ids with them); with
    game_shard=True, `run_summaries` plays launches of chunk_pairs pairs per
    matchup and reduces each matchup on the device.  On one card both
    methods run the shared table (60 matchups of nano tables are 413 MB).
    A game_shard runner plays on `parallel.mesh.game_group`: over several
    ranks each rank builds, holds and plays only its contiguous block of
    the matchups (`block`), the port's counterpart of the JAX package's
    ('game',) mesh; its stacked per-game scan is not ported.

    The table holds one (A on offense, B on offense) table pair per
    matchup: nano tables given (`nano_tables`, e.g. `fixtures.slate`), or
    built from trained `heads` as the JAX SlateRunner builds them: fused
    tables on the `quality` preset's profile (`SLATE_PROFILES`: 'turbo'
    the turbo profile, 'nano' the nano profile re-laid out as
    `MatchupRunner(mode="table", heads=)` packs it, anything else the
    coarse profile), packed the same way, so a slate from heads launches
    exactly what the same tables given by hand launch.  A matchup whose
    heads do not fuse (a focus roster) raises ValueError, and the slate
    builds no play-policy table, as in the JAX package.  Each matchup's
    fused pair is read from or written to the table disk cache, and the sd
    modes apply after it ('cachewarm' plays or reads the matchup's oracle
    warm-up; `ops.table_lookup.fused_tables_from_heads`).  `coach_map`
    names the teams' head coaches for the directions
    (`matchup.build_direction`).  The runner's matchups (the rank's block
    in the game layout, else the whole slate) are packed on the device at
    construction, so a slate that does not pack fails there, on every rank
    where one rank's block fails."""

    matchups: List[Tuple[TeamContext, TeamContext]]
    heads: Optional[ModelHeads] = None
    cfg: SimConfig = field(default_factory=SimConfig)
    coach_map: Optional[Dict[str, str]] = None
    quality: str = "nano"
    shard: bool = False
    game_shard: bool = False
    nano_tables: Optional[Sequence[Tuple[HostTable, HostTable]]] = None
    device: Optional[object] = None   # 'cuda' (None), 'cuda:0' or 'cpu'

    def __post_init__(self):
        if not self.matchups:
            raise ValueError("SlateRunner needs at least one matchup")
        if self.heads is not None and self.nano_tables is not None:
            raise ValueError("SlateRunner takes nano_tables or heads, not both")
        if self.heads is None and (self.nano_tables is None
                                   or len(self.nano_tables) != len(self.matchups)):
            raise ValueError("SlateRunner needs one nano table pair per matchup "
                             "(e.g. fixtures.slate(g, seed)) or trained heads")
        if self.nano_tables is not None and self.quality != "nano":
            raise ValueError(f"nano_tables are nano-layout tables; quality={self.quality!r} "
                             "builds fused tables from heads")
        self.group = (trial_group if self.shard or self.game_shard else
                      local_group)(self.device)
        self.device = self.group.device
        g = len(self.matchups)
        self.block = _game_block(g, self.group, self.cfg) if self.game_shard else (0, g)
        self.heads_fn = make_table_heads_eval(self.cfg)
        self.pack = self.heads_state = None     # a rank past the slate's last block
        agree(self.group, lambda: self._pack(*self.block))

    def _pack(self, g0: int, g1: int) -> None:
        """Build matchups g0..g1-1's tables and put them and the
        directions on the device."""
        if g1 == g0:
            return
        ms = self.matchups[g0:g1]
        fused_prof = None
        if self.heads is None:
            tables = self.nano_tables[g0:g1]
        else:
            _need_table_heads(self.heads)
            if self.quality == "nano":
                tables = [nano_tables_from_heads(a, b, self.heads, self.cfg, self.coach_map)
                          for a, b in ms]
            else:
                fused_prof = SLATE_PROFILES.get(self.quality, coarse_profile)()
                tables = [fused_tables_from_heads(a, b, self.heads, self.cfg,
                                                  self.coach_map, fused_prof)
                          for a, b in ms]
        dirs = []
        for a, b in ms:
            dirs += [build_direction(a, b, self.cfg, self.heads, self.coach_map),
                     build_direction(b, a, self.cfg, self.heads, self.coach_map)]
        self.pack = pack_matchups(dirs, self.device)
        self.heads_state = pack_tables_multi(tables, self.device, fused_prof=fused_prof)

    def _launch(self, n_pairs: int, key: int) -> GameState:
        """One score-only `simulate_games` call: 2*n_pairs games of each of
        the runner's matchups (its block), in matchup order, first offense
        alternating; they draw the rows and make the antithetic choice of
        the whole slate's launch."""
        g0, g1 = self.block
        per = 2 * n_pairs
        t = torch.arange((g1 - g0) * per, dtype=torch.int32, device=self.device)
        return simulate_games(self.pack, self.cfg, self.heads_fn, self.heads_state, key,
                              t.numel(), t % 2, collect_players=False, game_id=t // per,
                              collect_stats=False, row0=g0 * per, antithetic=(
                                  self.cfg.engine.antithetic
                                  and len(self.matchups) * per % 4 == 0))

    def run(self, n_pairs_per_game: int, seed: int = 0) -> GameState:
        """The final GameState of G * 2*n_pairs_per_game score-only games
        under root_key(seed), split over the runner's group (with
        shard=True the ranks, whose number must divide the games), every
        rank returning all of them."""
        if self.game_shard:
            raise ValueError("run() is the shared-table path; game_shard "
                             "slates use run_summaries()")
        per = 2 * n_pairs_per_game
        t = torch.arange(len(self.matchups) * per, dtype=torch.int32, device=self.device)
        return simulate_games_sharded(self.pack, self.cfg, self.heads_fn, self.heads_state,
                                      root_key(seed), t.numel(), t % 2, self.group,
                                      collect_players=False, game_id=t // per,
                                      collect_stats=False)

    def summary_rows(self, out: GameState) -> List[dict]:
        """One row per matchup of a `run`'s games: the JAX package's
        `summaries` columns (means, win rates, mean margin and total from
        team A's side, n_games)."""
        g = len(self.matchups)
        sc = _np(out.score).astype(float)
        per = sc.shape[0] // g
        rows = []
        for gi, (a, b) in enumerate(self.matchups):
            s = sc[gi * per:(gi + 1) * per]
            rows.append({
                "team_a": a.name, "team_b": b.name,
                "mean_a": s[:, 0].mean(), "mean_b": s[:, 1].mean(),
                "win_a": (s[:, 0] > s[:, 1]).mean(),
                "win_b": (s[:, 1] > s[:, 0]).mean(),
                "mean_margin_a": (s[:, 0] - s[:, 1]).mean(),
                "mean_total": s.sum(axis=1).mean(),
                "n_games": per,
            })
        return rows

    def summaries(self, out: GameState):
        """`summary_rows` as a DataFrame."""
        import pandas as pd

        return pd.DataFrame(self.summary_rows(out))

    def run_summary_rows(self, n_pairs_per_game: int, seed: int = 0,
                         chunk_pairs: int = 32768,
                         mesh=None) -> Tuple[List[dict], List[ScoreSummary]]:
        """The slate's summaries (game_shard=True): launches of chunk_pairs
        pairs per matchup, launch ci under fold_in(root_key(seed), ci);
        each launch's scores reduce per matchup on the device (one offset
        `bincount` over the (G, 2*chunk_pairs, 2) view) and accumulate
        there; the summaries are finished once and copied to the host
        once.  n_pairs_per_game rounds UP to whole launches.  Returns (one
        row per matchup, with `simulate_slate_summary_rows`' columns; the
        per-matchup ScoreSummary in numpy, for `edge.slate_market_table`).

        The JAX package folds a key per matchup; here a launch has one key
        and its matchups draw from disjoint Philox rows (row g*2*chunk_pairs
        + i), so no two matchups share draws and the two packages agree in
        distribution.

        The runner's group (`parallel.mesh.game_group`, W ranks; `mesh`, if
        given, must be that group) splits the slate into contiguous blocks
        (`game_block`): rank r built and holds only its block's tables and
        plays them under the same launch keys, rows and antithetic choice,
        and the blocks' moments, padded to one length, are gathered on
        every rank and cut back to G.  The summaries equal the one-card
        run's bit for bit."""
        if not self.game_shard:
            raise ValueError("run_summaries needs SlateRunner(game_shard=True)")
        if mesh is not None and not isinstance(mesh, TrialGroup):
            raise TypeError(f"mesh must be a parallel.mesh.TrialGroup, got {type(mesh).__name__}")
        if mesh is not None and mesh != self.group:
            raise ValueError("mesh must be the runner's own group (SlateRunner.group, "
                             "parallel.mesh.game_group): a rank holds the block it was built for")
        if n_pairs_per_game <= 0:
            raise ValueError(f"n_pairs_per_game must be positive, got {n_pairs_per_game}")
        g = len(self.matchups)
        g0, g1 = self.block
        chunk_pairs = min(chunk_pairs, n_pairs_per_game)
        root = root_key(seed)

        def play():
            acc = None
            for ci in range(-(-n_pairs_per_game // chunk_pairs) if g1 > g0 else 0):
                # the launch's state is dropped here, before the next launch
                m = score_moments(self._launch(chunk_pairs, fold_in(root, ci)).score.view(
                    g1 - g0, 2 * chunk_pairs, 2))
                acc = m if acc is None else acc + m
            return acc

        acc = agree(self.group, play)
        if self.group.world > 1:
            # the moments of no games pad every block to the widest
            blk = _block_width(g, self.group.world, self.cfg)
            pad = score_moments(torch.zeros((blk - (g1 - g0), 0, 2), dtype=torch.int32,
                                            device=self.device))
            acc = pad if acc is None else ScoreMoments(*map(torch.cat, zip(acc, pad)))
            acc = ScoreMoments(*(all_gather_rows(self.group, f)[:g] for f in acc))
        host, = host_summaries(summary_from_moments(acc))
        per_game = [ScoreSummary(*(f[gi] for f in host)) for gi in range(g)]
        return ([_summary_row(a.name, b.name, s) for (a, b), s in zip(self.matchups, per_game)],
                per_game)

    def run_summaries(self, n_pairs_per_game: int, seed: int = 0, chunk_pairs: int = 32768,
                      mesh=None, return_summaries: bool = False):
        """`run_summary_rows` as a DataFrame, and with return_summaries=True
        (DataFrame, per-matchup summaries)."""
        import pandas as pd

        rows, per_game = self.run_summary_rows(n_pairs_per_game, seed, chunk_pairs, mesh)
        return (pd.DataFrame(rows), per_game) if return_summaries else pd.DataFrame(rows)


def _summary_row(team_a: str, team_b: str, s: ScoreSummary) -> dict:
    """One slate row from a matchup's host summary."""
    mean, win = s.mean_pts, s.win_rate
    return {"team_a": team_a, "team_b": team_b,
            "mean_a": float(mean[0]), "mean_b": float(mean[1]),
            "win_a": float(win[0]), "win_b": float(win[1]),
            "mean_margin_a": float(mean[0] - mean[1]),
            "mean_total": float(mean[0] + mean[1]),
            "n_games": int(s.n)}


# Runner memos for the slate entry points.  A runner is read-only after
# __post_init__, so reusing one is the supported pattern (`runner=`).  The
# keys are the identities of the given contexts and tables; the cached
# runner holds those objects, so no id is reused while its entry lives.
def _fifo_memo(memo: Dict, cap: int, key, build, max_bytes: Optional[int] = None,
               nbytes=None):
    """The value of `key` in `memo`, built and stored if absent, the oldest
    entries evicted past `cap` entries and, with `max_bytes`, until the
    entries' `nbytes(value)` fit under it (an entry larger than that is
    kept alone).  id()-based keys are safe only while the value pins the
    keyed objects alive: keep that if eviction changes."""
    v = memo.get(key)
    if v is None:
        v = build()
        need = nbytes(v) if max_bytes is not None else 0
        while memo and (len(memo) >= cap or (
                max_bytes is not None
                and sum(map(nbytes, memo.values())) + need > max_bytes)):
            memo.pop(next(iter(memo)))
        memo[key] = v
    return v


def _runner_bytes(runner: MatchupRunner) -> int:
    """The bytes of the tables a runner holds on its device."""
    th = runner.heads_state
    return th.nbytes if isinstance(th, TableHeads) else 0


# at most 128 runners, whose tables take at most the table memo's byte cap
# (2 GiB): a focus roster's runner holds 0.5 GB or more of tables on the
# card, so a count alone would let the memo pin the card's memory.  (The
# JAX package caps this memo by count alone.)
_RUNNER_MEMO: Dict[tuple, MatchupRunner] = {}
_RUNNER_MEMO_MAX = 128


def _runner_for(a: TeamContext, b: TeamContext, tables, cfg: SimConfig, mode: str,
                table_quality: str, shard: bool, device, heads=None) -> MatchupRunner:
    """The memoized MatchupRunner of one matchup: table mode on the given
    nano `tables`, else on tables built from `heads`; exact mode on
    `heads`."""
    if mode == "table" and tables is not None:
        heads = None
    return _fifo_memo(
        _RUNNER_MEMO, _RUNNER_MEMO_MAX,
        (id(a), id(b), id(heads), tuple(id(t) for t in tables or ()), cfg, mode,
         table_quality, shard, device),
        lambda: MatchupRunner(a, b, heads, cfg, mode=mode, table_quality=table_quality,
                              nano_tables=tables if mode == "table" else None,
                              device=device, shard=shard),
        table_lookup._TABLE_MEMO_MAX_BYTES, _runner_bytes)


_GAME_SHARD_MEMO: Dict = {}
_GAME_SHARD_MEMO_MAX = 4
# key -> (the build's error, the keyed contexts and tables, held so that
# their ids are not reused while the entry lives); FIFO-bounded, so a
# transient failure does not mark a slate failed for good
_GAME_SHARD_FAILED: Dict = {}
_GAME_SHARD_FAILED_MAX = 16
# the qualities layout='game_shard' takes, as in the JAX package: SlateRunner
# builds any other preset as a coarse fused table, not the loop's per-head
# tables, so routing must not send one there silently
GAME_SHARD_QUALITIES = ("nano", "turbo", "fused")


def _game_shard_runner(contexts, nano_tables, cfg: SimConfig, quality: str, device,
                       heads=None) -> SlateRunner:
    """The memoized game_shard SlateRunner of a slate on `device`'s
    `game_group` (this rank's block), on the given nano tables or on tables
    built from `heads`.  A slate whose build failed raises that failure again without
    another build."""
    if nano_tables is not None:
        heads = None
    group = game_group(device)
    key = (tuple((id(a), id(b)) for a, b in contexts),
           tuple(id(t) for pair in nano_tables or () for t in pair), id(heads), cfg,
           quality, group)
    if key in _GAME_SHARD_FAILED:
        raise ValueError("layout='game_shard': this slate previously failed to build: "
                         f"{_GAME_SHARD_FAILED[key][0]}")
    try:
        return _fifo_memo(
            _GAME_SHARD_MEMO, _GAME_SHARD_MEMO_MAX, key,
            lambda: SlateRunner(list(contexts), heads, cfg, quality=quality, game_shard=True,
                                nano_tables=nano_tables, device=group.device))
    except Exception as e:   # recorded and raised again
        while len(_GAME_SHARD_FAILED) >= _GAME_SHARD_FAILED_MAX:
            _GAME_SHARD_FAILED.pop(next(iter(_GAME_SHARD_FAILED)))
        _GAME_SHARD_FAILED[key] = (f"{type(e).__name__}: {e}", contexts, nano_tables, heads)
        raise


def _slate_inputs(games, contexts, nano_tables, sp_path, year, week, artifact_dir,
                  focus_csv, cfg: SimConfig, mode: str, what: str):
    """A slate's (one context pair a game, the heads its runners build from
    or None): the given `contexts`, or both teams of each game from the SP+
    sheet at `sp_path` (rosters from `focus_csv`); the heads of
    `artifact_dir` only where a runner needs them: exact mode, or table
    mode without `nano_tables`."""
    _one_of(what, "contexts", contexts is not None, sp_path, focus_csv)
    if contexts is None:
        sp_df = load_sp_flex(sp_path)
        contexts = [_sheet_contexts(game, sp_df, year, week, focus_csv, cfg) for game in games]
    if len(contexts) != len(games) or (nano_tables is not None
                                       and len(nano_tables) != len(games)):
        raise ValueError(f"{what}: {len(games)} games need as many context pairs "
                         f"(got {len(contexts)}) and nano table pairs")
    needs_heads = mode == "exact" or (mode == "table" and nano_tables is None)
    return contexts, load_heads(artifact_dir) if needs_heads else None


def simulate_slate_summary_rows(
    games: Sequence[Tuple[str, str]],
    *,
    sp_path: Optional[str] = None,
    year: int = 2025,
    week: int = 1,
    contexts: Optional[Sequence[Tuple[TeamContext, TeamContext]]] = None,
    nano_tables: Optional[Sequence[Tuple[HostTable, HostTable]]] = None,
    artifact_dir: str = DEFAULT_ARTIFACT_DIR,
    focus_csv: Optional[str] = None,
    n_pairs: int = 50000,
    mode: str = "table",
    table_quality: str = "nano",
    cfg: Optional[SimConfig] = None,
    seed: int = 0,
    shard: bool = False,
    chunk_pairs: int = 32768,
    layout: str = "auto",
    device=None,
) -> Tuple[List[dict], List[ScoreSummary]]:
    """A weekly slate's summaries: (one row per game: team_a, team_b,
    mean_a, mean_b, win_a, win_b, mean_margin_a, mean_total, n_games;
    the per-game ScoreSummary in numpy, whose histograms price the game's
    markets through `edge.slate_market_table`).

    layout 'loop' runs each game on its own memoized MatchupRunner,
    `run_pairs_summary(n_pairs, key=fold_in(root_key(seed), gi),
    chunk_pairs=...)`, its summary left on the device; every summary comes
    to the host in one copy at the end; shard=True splits each launch over
    the ranks (chunk_pairs times the world size, as in the JAX package).
    'game_shard' runs the slate through one memoized
    `SlateRunner(game_shard=True).run_summary_rows` (table mode; its rows
    name the contexts' teams), over the ranks of `parallel.mesh.game_group`
    where there are several.  'auto' is that game layout where there is
    more than one rank, shard=False, more than one game, no focus roster,
    table mode and a quality in GAME_SHARD_QUALITIES, as in the JAX
    package, falling back to the loop if the slate's runner fails to build;
    else the loop.  An empty slate returns ([], []) before anything else is
    read.

    The games' contexts come from the SP+ sheet at `sp_path` (`year`,
    `week`, rosters from `focus_csv`) or as `contexts=`; the runners' tables
    are `nano_tables=` (one pair a game) or are built from the heads of
    `artifact_dir` (`_slate_inputs`)."""
    cfg = cfg or SimConfig()
    if layout not in ("auto", "loop", "game_shard"):
        raise ValueError(f"layout must be auto|loop|game_shard, got {layout!r}")
    if not games:
        return [], []
    if layout == "game_shard":
        # as in the JAX package: an explicit request must not drop a knob
        if focus_csv is not None:
            raise ValueError("layout='game_shard' cannot honor focus_csv "
                             "(focus rosters are player-dependent and "
                             "don't fuse); use layout='loop'")
        if mode != "table":
            raise ValueError(f"layout='game_shard' is table-mode only "
                             f"(got mode={mode!r}); use layout='loop'")
        if shard:
            raise ValueError("layout='game_shard' and shard=True (trial "
                             "sharding) are different layouts — pick one")
        if table_quality not in GAME_SHARD_QUALITIES:
            raise ValueError(
                f"layout='game_shard' supports table_quality in "
                f"{GAME_SHARD_QUALITIES} (got {table_quality!r}); other "
                f"presets would silently degrade to a coarse fused table")
    want_game_shard = layout == "game_shard" or (
        layout == "auto" and world_size() > 1 and not shard and len(games) > 1
        and focus_csv is None and mode == "table" and table_quality in GAME_SHARD_QUALITIES)
    contexts, heads = _agreed(shard or want_game_shard, device, lambda: _slate_inputs(
        games, contexts, nano_tables, sp_path, year, week, artifact_dir, focus_csv, cfg, mode,
        "simulate_slate_summaries"))
    if want_game_shard:
        sr = None
        try:
            sr = _game_shard_runner(contexts, nano_tables, cfg, table_quality, device, heads)
        except Exception:
            # as in the JAX package: 'auto' falls back to the loop on any
            # build failure; an explicit 'game_shard' says why.  The build
            # agrees over the ranks (SlateRunner), so where one rank's
            # block fails every rank takes the loop.
            if layout == "game_shard":
                raise
        if sr is not None:
            return sr.run_summary_rows(n_pairs, seed, chunk_pairs)
    if shard:
        chunk_pairs *= world_size()
    root = root_key(seed)
    summs = [_runner_for(a, b, nano_tables[gi] if nano_tables is not None else None, cfg,
                         mode, table_quality, shard, device, heads).run_pairs_summary(
                             n_pairs, key=fold_in(root, gi), chunk_pairs=chunk_pairs)
             for gi, (a, b) in enumerate(contexts)]
    host = host_summaries(*summs)
    return [_summary_row(ta, tb, s) for (ta, tb), s in zip(games, host)], host


def simulate_slate_summaries(games, *, return_summaries: bool = False, **kw):
    """`simulate_slate_summary_rows` as a DataFrame, and with
    return_summaries=True (DataFrame, per-game summaries)."""
    import pandas as pd

    rows, summs = simulate_slate_summary_rows(games, **kw)
    return (pd.DataFrame(rows), summs) if return_summaries else pd.DataFrame(rows)


def simulate_slate_rows(
    games: Sequence[Tuple[str, str]],
    *,
    sp_path: Optional[str] = None,
    year: int = 2025,
    week: int = 1,
    n: int = 1000,
    contexts: Optional[Sequence[Tuple[TeamContext, TeamContext]]] = None,
    nano_tables: Optional[Sequence[Tuple[HostTable, HostTable]]] = None,
    artifact_dir: str = DEFAULT_ARTIFACT_DIR,
    focus_csv: Optional[str] = None,
    mode: str = "table",
    table_quality: str = "nano",
    cfg: Optional[SimConfig] = None,
    seed: int = 0,
    device=None,
) -> List[dict]:
    """One summary row per game from its score frame: n pairs of games on
    the game's memoized MatchupRunner under seed + gi
    (`simulate_matchup_columns`).  As in the JAX package, mean_margin_a and
    win_a read the games team A started with the ball, win_b those team B
    started, mean_a and mean_b all of them.  Inputs as
    `simulate_slate_summary_rows` takes them."""
    cfg = cfg or SimConfig()
    contexts, heads = _slate_inputs(games, contexts, nano_tables, sp_path, year, week,
                                    artifact_dir, focus_csv, cfg, mode, "simulate_slate")
    rows = []
    for gi, ((ta, tb), (a, b)) in enumerate(zip(games, contexts)):
        runner = _runner_for(a, b, nano_tables[gi] if nano_tables is not None else None,
                             cfg, mode, table_quality, False, device, heads)
        sc, _, _ = simulate_matchup_columns(a, b, None, n, cfg=cfg, seed=seed + gi,
                                            mode=mode, runner=runner)
        team, pts, opp = sc["team"], sc["pts"], sc["opp_pts"]
        summ = summary_columns(sc)
        means = dict(zip(summ["team"], summ["mean_pts"]))
        first_a, first_b = team == a.name, team == b.name
        rows.append({
            "team_a": ta, "team_b": tb,
            "mean_a": float(means[a.name]), "mean_b": float(means[b.name]),
            "win_a": float((pts[first_a] > opp[first_a]).mean()),
            "win_b": float((pts[first_b] > opp[first_b]).mean()),
            "mean_margin_a": float((pts[first_a] - opp[first_a]).mean()),
            "mean_total": float((pts + opp).mean()),
            "n_games": len(team),
        })
    return rows


def simulate_slate(games, **kw):
    """`simulate_slate_rows` as a DataFrame."""
    import pandas as pd

    return pd.DataFrame(simulate_slate_rows(games, **kw))


# ---- multi-leg markets, season win totals, slate prop scans --------------------

def simulate_parlay_core(team_a: str, team_b: str, legs, *,
                         sp_path: Optional[str] = None, year: int = 2025, week: int = 1,
                         n_pairs: int = 32768, artifact_dir: str = DEFAULT_ARTIFACT_DIR,
                         focus_csv: Optional[str] = None, mode: str = "table",
                         table_quality: str = "nano", cfg: Optional[SimConfig] = None,
                         seed: int = 0, shard: bool = False, price: Optional[int] = None,
                         correlations: bool = False, round_robin=None,
                         runner: Optional[MatchupRunner] = None, device=None) -> dict:
    """A same-game parlay for one matchup (`edge.parlay_odds` over
    2*n_pairs games run once), with `leg_corr` = (leg labels, (L, L) numpy
    correlations) when `correlations` and the `edge.round_robin` card of
    the `round_robin` size spec under `round_robin`, all from the same
    games.  The legs and the size spec are checked before the runner is
    built or anything runs; player stats are collected only for a prop
    leg, the box score never.

    The matchup's contexts and heads come from the SP+ sheet at `sp_path`
    and `artifact_dir` (the runner memoized, as in the live entry points),
    or the matchup is a built `runner=` whose teams are team_a and team_b.
    shard=True splits the games over the ranks (`MatchupRunner.run_pairs`:
    2*n_pairs a multiple of the world size)."""
    _one_of("simulate_parlay", "runner", runner is not None, sp_path, focus_csv)

    def setup(runner=runner, cfg=cfg):
        if runner is None:
            heads, a, b, cfg = _prepared_contexts(
                team_a, team_b, sp_path=sp_path, year=year, week=week,
                artifact_dir=artifact_dir, focus_csv=focus_csv, cfg=cfg)
        else:
            a, b = runner.team_a, runner.team_b
            if [edge._norm_team(t) for t in (team_a, team_b)] != \
                    [edge._norm_team(t.name) for t in (a, b)]:
                raise ValueError(f"the runner plays {a.name} vs {b.name}, not "
                                 f"{team_a} vs {team_b}")
        # a bad leg or size spec fails before the runner's build or any launch
        resolved = edge.resolve_parlay_legs(a, b, legs)
        if round_robin is not None:
            edge._rr_sizes(round_robin, len(legs))
        runner = (_runner_for(a, b, None, cfg, mode, table_quality, shard, device, heads)
                  if runner is None else runner.sharded(shard))
        return runner, a, b, resolved

    runner, a, b, resolved = _agreed(shard, device if runner is None else runner.device,
                                     setup)
    want_players = any(m["kind"] == "prop" for m in resolved[1])
    out = runner.run_pairs(n_pairs, seed=seed, collect_players=want_players,
                           collect_stats=False)
    res = edge.parlay_odds(out, a, b, legs, price=price, resolved=resolved)
    if correlations:
        res["leg_corr"] = edge.parlay_correlation_matrix(out, a, b, legs, resolved=resolved)
    if round_robin is not None:
        res["round_robin"] = edge.round_robin(out, a, b, legs, by=round_robin, price=price,
                                              resolved=resolved)
    return res


def simulate_parlay(team_a: str, team_b: str, legs, **kw) -> dict:
    """`simulate_parlay_core` with `leg_corr` as a DataFrame indexed by leg
    label, as the JAX package returns it."""
    res = simulate_parlay_core(team_a, team_b, legs, **kw)
    if "leg_corr" in res:
        import pandas as pd

        labels, corr = res["leg_corr"]
        res["leg_corr"] = pd.DataFrame(corr, index=labels, columns=labels)
    return res


def project_season_rows(
    team: str,
    opponents: Optional[List[str]] = None,
    games: Optional[List[Tuple[str, str]]] = None,
    *,
    line: Optional[float] = None,
    sp_path: Optional[str] = None,
    year: int = 2025,
    week: int = 1,
    n_pairs: int = 50000,
    contexts: Optional[Sequence[Tuple[TeamContext, TeamContext]]] = None,
    nano_tables: Optional[Sequence[Tuple[HostTable, HostTable]]] = None,
    artifact_dir: str = DEFAULT_ARTIFACT_DIR,
    focus_csv: Optional[str] = None,
    mode: str = "table",
    table_quality: str = "nano",
    cfg: Optional[SimConfig] = None,
    seed: int = 0,
    shard: bool = False,
    chunk_pairs: int = 32768,
    price: int = -110,
    device=None,
) -> dict:
    """A team's season win total from per-game simulations: the schedule as
    `opponents` (the team is side A of each game) or as `games` rows with
    the team on either side; contexts and tables as
    `simulate_slate_summary_rows` takes them.  The games run through
    `simulate_slate_summary_rows` (the loop layout); the team's
    strict win probability is read off each row by its side and composed
    exactly by `edge.season_win_market` (with `line`, the over/under at
    that win total).  Returns the market dict with `schedule`: the summary
    rows, each with team_side, p_win_team (rounded to 6 places) and
    opponent."""
    if (opponents is None) == (games is None):
        raise ValueError("pass exactly one of opponents= or games=")
    if opponents is not None:
        games = [(team, o) for o in opponents]
    tn = edge._norm_team(team)
    sides = []
    for ta, tb in games:
        if edge._norm_team(ta) == tn:
            sides.append("a")
        elif edge._norm_team(tb) == tn:
            sides.append("b")
        else:
            raise ValueError(
                f"{team!r} plays in every scheduled game, but ({ta!r}, "
                f"{tb!r}) doesn't include it")
    rows, _ = simulate_slate_summary_rows(
        list(games), contexts=contexts, nano_tables=nano_tables, sp_path=sp_path,
        year=year, week=week, artifact_dir=artifact_dir, focus_csv=focus_csv,
        n_pairs=n_pairs, mode=mode,
        table_quality=table_quality, cfg=cfg, seed=seed, shard=shard,
        chunk_pairs=chunk_pairs, device=device)
    p_wins = [float(r[f"win_{s}"]) for s, r in zip(sides, rows)]
    res = edge.season_win_market(p_wins, line=line, team=team, price=price)
    res["schedule"] = [
        {**r, "team_side": s, "p_win_team": float(p), "opponent": ta if s == "b" else tb}
        for r, s, p, (ta, tb) in zip(rows, sides, np.round(p_wins, 6), games)]
    return res


def project_season(team: str, opponents=None, games=None, **kw) -> dict:
    """`project_season_rows` with the schedule as a DataFrame."""
    import pandas as pd

    res = project_season_rows(team, opponents, games, **kw)
    res["schedule"] = pd.DataFrame(res["schedule"])
    return res


def _prop_sheet(props) -> List[dict]:
    """A prop sheet given as a CSV path, a DataFrame or row dicts, as row
    dicts."""
    if isinstance(props, (str, os.PathLike)):
        return edge.read_prop_sheet(os.fspath(props))
    return props.to_dict("records") if hasattr(props, "to_dict") else list(props)


def simulate_slate_prop_rows(
    games: Sequence[Tuple[str, str]],
    *,
    sp_path: Optional[str] = None,
    props_csv,
    year: int = 2025,
    week: int = 1,
    n_pairs: int = 8192,
    contexts: Optional[Sequence[Tuple[TeamContext, TeamContext]]] = None,
    nano_tables: Optional[Sequence[Tuple[HostTable, HostTable]]] = None,
    artifact_dir: str = DEFAULT_ARTIFACT_DIR,
    focus_csv: Optional[str] = None,
    mode: str = "table",
    table_quality: str = "nano",
    cfg: Optional[SimConfig] = None,
    seed: int = 0,
    min_abs_edge_pct: float = 2.0,
    shard: bool = False,
    device=None,
) -> List[dict]:
    """A slate-wide player-prop scan: the prop table of every matchup
    (PROP_TABLE_COLS after a leading `matchup`), best |edge_pct| first
    across the slate, ties in the order pandas' sort gives them.

    `props_csv` is a prop sheet: a CSV path, a DataFrame or row dicts.
    Each matchup's rows are resolved before it runs, and a matchup with no
    resolvable row runs nothing.  Game gi (its index in `games`, skipped
    games counted) runs `run_pairs(n_pairs, key=fold_in(root_key(seed),
    gi), collect_players=True)` on its memoized runner and reduces its rows
    on the device; the reductions stay there until one host copy per
    padded width at the end.  Contexts and tables as
    `simulate_slate_summary_rows` takes them.  shard=True splits each
    matchup's games over the ranks, n_pairs rounded up to a multiple of the
    world size as in the JAX package."""
    cfg = cfg or SimConfig()
    contexts, heads, props = _agreed(shard, device, lambda: (*_slate_inputs(
        games, contexts, nano_tables, sp_path, year, week, artifact_dir, focus_csv, cfg, mode,
        "simulate_slate_props"), _prop_sheet(props_csv)))
    if shard:
        n_pairs = -(-n_pairs // world_size()) * world_size()
    root = root_key(seed)
    pending = []
    for gi, ((ta, tb), (a, b)) in enumerate(zip(games, contexts)):
        indices, meta = edge.resolve_prop_rows(a, b, props)
        if not meta:
            continue
        runner = _runner_for(a, b, nano_tables[gi] if nano_tables is not None else None,
                             cfg, mode, table_quality, shard, device, heads)
        out = runner.run_pairs(n_pairs, key=fold_in(root, gi), collect_players=True)
        pending.append((f"{ta} vs {tb}", meta, edge.reduce_props_device(out.pstats, indices)))
    if not pending:
        return []
    fields = sorted(pending[0][2])
    by_width: Dict[int, List[int]] = {}
    for i, (_, _, red) in enumerate(pending):
        by_width.setdefault(red[fields[0]].shape[0], []).append(i)
    host: Dict[int, dict] = {}
    for idxs in by_width.values():
        arr = torch.stack([torch.stack([pending[i][2][k] for k in fields])
                           for i in idxs]).cpu().numpy()
        for j, i in enumerate(idxs):
            host[i] = dict(zip(fields, arr[j]))
    rows = [{"matchup": matchup, **r}
            for i, (matchup, meta, _) in enumerate(pending)
            for r in edge.prop_rows_from_reductions(meta, host[i], min_abs_edge_pct)]
    order = edge._desc_order(np.abs(np.array([r["edge_pct"] for r in rows], dtype=float)))
    return [rows[i] for i in order]


def simulate_slate_props(games, **kw):
    """`simulate_slate_prop_rows` as a DataFrame (empty: no columns)."""
    import pandas as pd

    return pd.DataFrame(simulate_slate_prop_rows(games, **kw))

"""Inputs made from a seed.

The port's tests and `chip_smoke.py` run on these and on the trained-head
artifact directory `tests/data/torch_artifacts/` (`ARTIFACT_DIR`, written by
`tests/data/make_torch_artifacts.py`):

* two synthetic teams with the SP+ numbers the JAX package's own tests use
  (tests/test_mechanics.py), one Unknown player per role, 8 slots;
* the same two teams with rosters (`focus_teams`): a seeded focus-players
  sheet (`focus_rows`) of 2 QBs, 3 rushers and 5 targets per team, usages
  in percent that leave a shortfall, read back by `data/usage.py`; and a
  prop sheet over those players (`prop_rows`);
* a weekly slate (`slate`): g matchups of distinct synthetic teams
  ("Team 000" on), SP+ numbers drawn from the FBS range the two teams
  above sit in, each matchup with its own seeded nano table pair; and
  quoted spreads and totals for it (`slate_lines`); the same slate with
  rosters (`focus_slate`) and a prop sheet over some of its matchups
  (`slate_prop_rows`); a team's season against g others (`season`);
* an SP+ sheet in the 2025 sheet's schema (`sp_sheet_rows`,
  `write_sp_sheet`): the two teams above and FBS-sized filler teams with
  `slate_teams`' numbers;
* one fused head grid per direction, shape (1, 5, 16, 32, 16, 3, 7) =
  (slot, down, dist, ytg, sec, sd, channel) on the nano profile, channels in
  FUSED_CHANNELS[:7] order, each cell drawn uniformly from a plausible
  range.  Random per cell, so it carries no football structure: it drives
  the table path at its real shape and value profile, not the trained
  heads' numbers.

The fused grids are handed to `models.tables.nano_from_fused`, so the nano
re-layout runs on them as it does on a built table.

`play_states` and `play_draws` make play-start states and draws for
checking one play step against a reference on the same inputs.

`heads(seed, shape)` makes trained-head stand-ins: seeded FlatForests in
numpy with the reference heads' shapes ("reference") or a few trees a head
("small"), thresholds drawn inside each feature's range, category names
that include the fixture rosters' players and "Unknown" (so the fixture
teams' ids are not all -1), `COACH_MAP` naming the teams' coaches.  Random
trees: they drive exact mode and the table build at the heads' real shapes,
not the trained models' numbers.
"""
from __future__ import annotations

import csv
import os
import tempfile
from typing import List, Optional, Tuple

import numpy as np

from .data.context import TeamContext, team_context
from .data.usage import focus_usage_columns
from .models.forest import FeatureLayout, FlatForest, stack_nodes
from .models.heads import ST1_FEATURES, STAGE2_CLASSES, ModelHeads
from .models.tables import FUSED_CHANNELS, HostTable, nano_from_fused, nano_profile
from .stats import N_PLAYER_STATS, N_TEAM_STATS, PC_YDS, TS

# the trained-head fixture directory, in the reference's file layout
ARTIFACT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "tests", "data", "torch_artifacts")

TEAM_A = ("Team A", 2025, 1, 15.6, 35.7, 20.0)
TEAM_B = ("Team B", 2025, 1, 11.0, 31.5, 20.6)

FUSED_GRID_SHAPE = (1, 5, 16, 32, 16, 3, 7)
CHANNEL_RANGES = {
    "p_complete": (0.45, 0.75),
    "pq_mu": (4.0, 12.0),
    "pq_sigma": (6.0, 9.0),
    "rq_mu": (3.0, 5.5),
    "rq_sigma": (3.5, 5.0),
    "sq_mu": (-8.0, -4.0),
    "sq_sigma": (1.8, 2.6),
}


def teams(player_slots: int = 8) -> Tuple[TeamContext, TeamContext]:
    return (team_context(*TEAM_A, player_slots=player_slots),
            team_context(*TEAM_B, player_slots=player_slots))


FOCUS_COLS = ("team", "player", "pos", "usage", "stat", "yards")
PROP_COLS = ("team", "player", "stat", "yards")
# per role: (stat, positions, mean line of the first player)
_ROSTER = {"pass": ("pass_yards", ("QB", "QB"), 245.0),
           "rush": ("rush_yards", ("RB", "RB", "QB"), 70.0),
           "rec": ("rec_yards", ("WR", "WR", "TE", "WR", "RB"), 65.0)}
# prop stats by role, each with a typical line for the role's first player
_PROP_LINES = {"pass": {"pass_yds": 245.5, "pass_td": 1.5, "pass_att": 33.5,
                        "pass_comp": 21.5, "INT": 0.5, "sacks": 2.0},
               "rush": {"rush_yds": 70.5, "rush_td": 0.5, "rush_att": 15.0},
               "rec": {"rec_yds": 60.5, "rec_td": 0.5, "rec": 5.0, "tgt": 7.5}}


_LABEL = {"pass": "Passer", "rush": "Rusher", "rec": "Receiver"}


def roster_name(team: str, role: str, i: int) -> str:
    """The i-th player of a fixture team's role; a QB who rushes (the
    third rusher) is the team's first passer."""
    if role == "rush" and i == 2:
        role, i = "pass", 0
    return f"{team} {_LABEL[role]} {i + 1}"


def focus_rows(seed: int) -> List[dict]:
    """A focus-players sheet for TEAM_A and TEAM_B: per team 2 QBs
    (pass_yards), 3 rushers (rush_yards; the third is QB 1) and 5 targets
    (rec_yards), usages in percent summing to 80-95 per role, so each role
    gets an `__Other__` slot; `yards` the player's line of the stat."""
    return _focus_rows((TEAM_A[0], TEAM_B[0]), np.random.default_rng(seed))


def _focus_rows(team_names, rng: np.random.Generator) -> List[dict]:
    """`focus_rows`' layout over `team_names`, in order, drawn from `rng`."""
    rows = []
    for team in team_names:
        for role, (stat, pos, line) in _ROSTER.items():
            n = len(pos)
            usage = rng.dirichlet(np.linspace(4.0, 1.0, n)) * rng.uniform(80.0, 95.0)
            for i in range(n):
                rows.append({"team": team, "player": roster_name(team, role, i),
                             "pos": pos[i], "usage": round(float(usage[i]), 1),
                             "stat": stat,
                             "yards": float(np.round(line * usage[i] / usage.max() * 2) / 2)})
    return rows


def write_csv(path, rows: List[dict], cols) -> None:
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(cols))
        w.writeheader()
        w.writerows(rows)


def focus_teams(seed: int, path: Optional[str] = None,
                player_slots: int = 8) -> Tuple[TeamContext, TeamContext]:
    """TEAM_A and TEAM_B with the rosters of `focus_rows(seed)`, written to
    `path` (a temporary file, removed after, if None) and read back."""
    if path is None:
        with tempfile.TemporaryDirectory() as d:
            return focus_teams(seed, os.path.join(d, "focus.csv"), player_slots)
    write_csv(path, focus_rows(seed), FOCUS_COLS)
    focus = focus_usage_columns(path)
    return (team_context(*TEAM_A, player_slots=player_slots, focus_usage=focus),
            team_context(*TEAM_B, player_slots=player_slots, focus_usage=focus))


def _team_prop_rows(team: str, rng: np.random.Generator) -> List[dict]:
    """One team's block of a prop sheet: every stat of the three roles for
    the role's first player, lines drawn near each stat's typical value
    (whole numbers for the counts that take them), then the aliases
    pass_yards, rush_yards and rec_yards for each role's second player."""
    rows = []
    for role, lines in _PROP_LINES.items():
        for stat, line in lines.items():
            step = 1.0 if line == int(line) else 0.5
            jitter = np.round(rng.uniform(-0.15, 0.15) * line / step) * step
            rows.append({"team": team, "player": roster_name(team, role, 0),
                         "stat": stat, "yards": float(max(line + jitter, 0.5))})
    for role, alias, line in (("pass", "pass_yards", 20.5), ("rush", "rush_yards", 30.5),
                              ("rec", "rec_yards", 40.5)):
        rows.append({"team": team, "player": roster_name(team, role, 1),
                     "stat": alias, "yards": line})
    return rows


def prop_rows(seed: int) -> List[dict]:
    """A prop sheet (team, player, stat, yards) over `focus_rows`' players:
    per team every stat of the three roles for the role's first player,
    the aliases pass_yards, rush_yards and rec_yards for others, and one
    more receiver (33 rows, so a scan pads them to 40), lines drawn
    near each stat's typical value (whole numbers for the counts that take
    them, so pushes happen); then one row each for an untracked player, an
    unknown stat and a team outside the matchup, which a scan skips."""
    rng = np.random.default_rng(seed)
    rows = [r for team in (TEAM_A[0], TEAM_B[0]) for r in _team_prop_rows(team, rng)]
    a = TEAM_A[0]
    rows.append({"team": TEAM_B[0], "player": roster_name(TEAM_B[0], "rec", 2),
                 "stat": "rec_yds", "yards": 25.5})
    rows += [{"team": a, "player": "Not On The Sheet", "stat": "rush_yds", "yards": 40.5},
             {"team": a, "player": roster_name(a, "pass", 0), "stat": "fantasy_pts",
              "yards": 18.5},
             {"team": "Team C", "player": roster_name(a, "rec", 0), "stat": "rec_yds",
              "yards": 55.5}]
    return rows


def fused_grid(rng: np.random.Generator) -> np.ndarray:
    """One direction's (1, 5, 16, 32, 16, 3, 7) f32 grid."""
    cells = FUSED_GRID_SHAPE[:-1]
    chans = [rng.uniform(*CHANNEL_RANGES[name], size=cells)
             for name in FUSED_CHANNELS[:7]]
    return np.stack(chans, axis=-1).astype(np.float32)


def fused_tables(seed: int, s2_fumble: bool = False) -> Tuple[HostTable, HostTable]:
    """Fused HostTables for (team A on offense, team B on offense).  With
    `s2_fumble` each cell also holds the stage-2 and fumble channels
    (FUSED_CHANNELS[7:]: P(inc) in [0.55, 0.8), P(inc) + P(sack) 0.05-0.15
    above it, P(fumble) in [0.005, 0.03)), drawn after the seven, so the
    seven are the same as without."""
    rng = np.random.default_rng(seed)
    grids = [fused_grid(rng) for _ in range(2)]
    if s2_fumble:
        extra = []
        for g in grids:
            inc = rng.uniform(0.55, 0.8, g.shape[:-1])
            extra.append(np.stack([inc, inc + rng.uniform(0.05, 0.15, inc.shape),
                                   rng.uniform(0.005, 0.03, inc.shape)], axis=-1))
        grids = [np.concatenate([g, e.astype(np.float32)], axis=-1)
                 for g, e in zip(grids, extra)]
    return tuple(HostTable(values=g.reshape(-1, g.shape[-1]), shape=g.shape[:-1],
                           row_map=np.zeros(1, np.int64), profile="fused",
                           channels=g.shape[-1], has_sd=True, fused_has_s2=s2_fumble,
                           fused_has_fumble=s2_fumble) for g in grids)


def nano_tables(seed: int, s2_fumble: bool = False) -> Tuple[HostTable, HostTable]:
    """The fused fixture re-laid out for the nano path (with `s2_fumble`,
    the stage-2 and fumble channels too: `fused_tables`)."""
    prof = nano_profile()
    a, b = fused_tables(seed, s2_fumble)
    return nano_from_fused(a, prof), nano_from_fused(b, prof)


# SP+ offense and defense of the slate's teams: the FBS range the two
# fixture teams sit in (offense 31.5-35.7, defense 20.0-20.6)
SLATE_OFFENSE = (18.0, 42.0)
SLATE_DEFENSE = (12.0, 36.0)


def slate_teams(g: int, seed: int) -> List[tuple]:
    """2g team rows (name, year, week, rating, offense, defense) named
    "Team 000" on: offense and defense uniform over the FBS range, the
    rating their difference (as SP+ sums its two sides) within a point."""
    rng = np.random.default_rng(seed)
    off = rng.uniform(*SLATE_OFFENSE, 2 * g)
    deff = rng.uniform(*SLATE_DEFENSE, 2 * g)
    rating = off - deff + rng.uniform(-1.0, 1.0, 2 * g)
    return [(f"Team {i:03d}", 2025, 1, round(float(rating[i]), 1),
             round(float(off[i]), 1), round(float(deff[i]), 1)) for i in range(2 * g)]


# the columns of the 2025 SP+ sheet (schema B of data/sp.py), rank first
SP_SHEET_COLS = ("Rk", "Current SP+", "Rating", "Offense Rating", "Defense Rating",
                 "Past SP+")


def sp_sheet_rows(n_teams: int, seed: int) -> List[dict]:
    """A schema-B SP+ sheet of `n_teams` rows, best rating first: TEAM_A,
    TEAM_B and the first n_teams - 2 of `slate_teams` with their numbers.
    The 'Past SP+' column (last year's order, whose names the loader reads
    only where this year's lack them) holds the same names shuffled, two
    teams of its own ("Past Team 000", "Past Team 001") and two blanks."""
    rows = [TEAM_A, TEAM_B] + slate_teams((n_teams - 1) // 2, seed)[:n_teams - 2]
    rows = sorted(rows, key=lambda r: -r[3])
    rng = np.random.default_rng(seed + 1)
    past = [r[0] for r in rows[:n_teams - 4]] + ["Past Team 000", "Past Team 001"]
    past = [past[i] for i in rng.permutation(len(past))] + ["", ""]
    return [{"Rk": i + 1, "Current SP+": r[0], "Rating": r[3], "Offense Rating": r[4],
             "Defense Rating": r[5], "Past SP+": past[i]} for i, r in enumerate(rows)]


def write_sp_sheet(path, n_teams: int = 136, seed: int = 0) -> str:
    """`sp_sheet_rows(n_teams, seed)` written as a CSV at `path`."""
    write_csv(path, sp_sheet_rows(n_teams, seed), SP_SHEET_COLS)
    return str(path)


def slate(g: int, seed: int, player_slots: int = 8):
    """A weekly slate of g matchups: ([(team A, team B) contexts],
    [nano table pair]), matchup i between teams 2i and 2i+1 of
    `slate_teams(g, seed)` on `nano_tables(seed + i)`."""
    rows = slate_teams(g, seed)
    ctx = [team_context(*r, player_slots=player_slots) for r in rows]
    return ([(ctx[2 * i], ctx[2 * i + 1]) for i in range(g)],
            [nano_tables(seed + i) for i in range(g)])


def focus_slate(g: int, seed: int, path: Optional[str] = None, player_slots: int = 8):
    """`slate(g, seed)` with rosters: every team of `slate_teams(g, seed)`
    with the roster of a focus sheet over all 2g teams in `focus_rows`'
    layout (drawn from `seed`), written to `path` (a temporary file,
    removed after, if None) and read back; matchup i on
    `nano_tables(seed + i)`."""
    if path is None:
        with tempfile.TemporaryDirectory() as d:
            return focus_slate(g, seed, os.path.join(d, "focus.csv"), player_slots)
    rows = slate_teams(g, seed)
    write_csv(path, _focus_rows([r[0] for r in rows], np.random.default_rng(seed)),
              FOCUS_COLS)
    focus = focus_usage_columns(path)
    ctx = [team_context(*r, player_slots=player_slots, focus_usage=focus) for r in rows]
    return ([(ctx[2 * i], ctx[2 * i + 1]) for i in range(g)],
            [nano_tables(seed + i) for i in range(g)])


def slate_prop_rows(g: int, seed: int) -> List[dict]:
    """A prop sheet over `focus_slate(g, seed)`'s rosters, for matchups 0,
    1 and 3 only (of those below g): both teams' blocks of matchups 0 and 3
    (32 rows each), team A's of matchup 1 (16 rows, so its reduction has a
    padded width of its own); then one row of a team outside the slate,
    which a scan skips.  Matchups 2 and 4 on have no row."""
    rng = np.random.default_rng(seed)
    names = [r[0] for r in slate_teams(g, seed)]
    teams = {0: names[0:2], 1: names[2:3], 3: names[6:8]}
    rows = [r for i, ts in teams.items() if i < g for t in ts for r in _team_prop_rows(t, rng)]
    outside = f"Team {2 * g:03d}"
    rows.append({"team": outside, "player": roster_name(outside, "rec", 0),
                 "stat": "rec_yds", "yards": 55.5})
    return rows


def season(g: int, seed: int, player_slots: int = 8):
    """A season of g games for team 0 of `slate_teams(g, seed)` against
    teams 1..g, the team side A of even games and side B of odd ones:
    (games as (team A, team B) names, their context pairs, one nano table
    pair a game, `nano_tables(seed + i)`)."""
    ctx = [team_context(*r, player_slots=player_slots) for r in slate_teams(g, seed)[:g + 1]]
    pairs = [(ctx[0], ctx[i + 1]) if i % 2 == 0 else (ctx[i + 1], ctx[0]) for i in range(g)]
    return ([(a.name, b.name) for a, b in pairs], pairs,
            [nano_tables(seed + i) for i in range(g)])


def slate_lines(summary_rows, seed: int) -> List[dict]:
    """Quoted lines for a slate, one {"team_a", "spread", "total"} row per
    matchup in slate order, from its summary rows (`team_a`,
    `mean_margin_a`, `mean_total`, as `SlateRunner.run_summaries` gives
    them): a spread within a field goal of minus the game's mean margin
    and a total within a touchdown of its mean total, on the half point.
    Matchup 1's total is left out (None), so that game prices its spread
    alone, and matchup 0's name is written in capitals, so a lookup by
    name normalizes it.  A market table matches these rows by `team_a`;
    the same rows without it match by position."""
    rng = np.random.default_rng(seed)
    rows = []
    for i, r in enumerate(summary_rows):
        spread = np.round((-r["mean_margin_a"] + rng.uniform(-3.0, 3.0)) * 2) / 2
        total = np.round((r["mean_total"] + rng.uniform(-7.0, 7.0)) * 2) / 2
        rows.append({"team_a": r["team_a"].upper() if i == 0 else r["team_a"],
                     "spread": float(spread), "total": None if i == 1 else float(total)})
    return rows


def play_states(rng: np.random.Generator, n: int, k: Optional[int] = None) -> dict:
    """n play-start states (numpy arrays keyed by GameState field) that
    reach every branch of the play step: 4th downs, red zone, long fields,
    clocks just past halftime, late-game clocks, finished games.  With `k`
    the box score and player stats start nonzero (counts whole, yards in
    tenths, (n, 2, 19) and (n, 2, 3, k, 6)); without it they are the
    1-element dummies of disabled collectors, and the draws from `rng` are
    those of the states alone."""
    off = rng.integers(0, 2, n).astype(np.int32)
    sec = rng.integers(1, 3601, n).astype(np.int32)
    sec[: n // 10] = rng.integers(1801, 1830, n // 10)   # ticks across halftime
    sec[n // 10: n // 10 + n // 50] = 0                   # finished games
    down = rng.integers(1, 5, n).astype(np.int32)
    down[rng.random(n) < 0.3] = 4
    dist = (np.round(rng.uniform(0.5, 25, n) * 2) / 2).astype(np.float32)
    ytg = rng.integers(1, 100, n).astype(np.float32)
    period = np.where(sec > 0, 4 - (sec - 1) // 900, 4).astype(np.int32)
    d = dict(
        gid=np.zeros(n, np.int32), fo=off.copy(), off=off, sec=sec, down=down,
        dist=dist, ytg=ytg, period=period, in_rz=rng.random(n) < 0.3,
        going=np.zeros(n, bool),
        score=rng.integers(0, 50, (n, 2)).astype(np.int32))
    if k is None:
        d["stats"] = np.zeros((n, 1, 1), np.float32)
        d["pstats"] = np.zeros((n, 1, 1, 1, 1), np.float32)
        return d

    def counts_and_yards(shape, yards_cols):
        x = rng.integers(0, 30, shape).astype(np.float32)
        y = np.round(rng.uniform(-20.0, 400.0, shape[:-1] + (len(yards_cols),)), 1)
        x[..., yards_cols] = y
        return x

    d["stats"] = counts_and_yards((n, 2, N_TEAM_STATS), [TS["pass_yds"], TS["rush_yds"]])
    d["pstats"] = counts_and_yards((n, 2, 3, k, N_PLAYER_STATS), [PC_YDS])
    return d


def play_draws(rng: np.random.Generator, shape) -> Tuple[np.ndarray, np.ndarray]:
    """(u (*shape, 13), z (*shape, 4)) f32: uniforms on the Philox
    kernel's 2^-24 grid and standard normals."""
    u = (rng.integers(0, 2 ** 24, (*shape, 13)) * 2.0 ** -24).astype(np.float32)
    z = rng.standard_normal((*shape, 4)).astype(np.float32)
    return u, z


# ---------------------------------------------------------------------------
# trained-head stand-ins
# ---------------------------------------------------------------------------

# the fixture teams' head coaches, for build_direction's coach_map
COACH_MAP = {TEAM_A[0]: "Coach A", TEAM_B[0]: "Coach B"}
# the play head's numerics: the 12 of the reference's pickled play model
PLAY_NUMERICS = ST1_FEATURES[:12]
PLAY_CLASSES = ("field_goal", "pass", "punt", "run", "timeout")
# per numeric feature: (lo, hi, grid) of its thresholds; on a grid of half
# its step, a threshold can equal a state's value, where "lt" and "le" part
FEATURE_RANGES = {
    "down": (1.0, 4.5, 0.5), "distance": (0.5, 25.0, 0.5),
    "yardsToGoal": (1.0, 99.0, 0.5), "is_red_zone": (0.5, 0.5, None),
    "score_diff": (-28.0, 28.0, 1.0), "seconds_remaining": (0.0, 3600.0, 1.0),
    "offenseTimeouts": (0.5, 2.5, 1.0), "defenseTimeouts": (0.5, 2.5, 1.0),
    "sp_rating_off": (-10.0, 30.0, None), "sp_offense_rating_off": (15.0, 45.0, None),
    "sp_defense_rating_def": (10.0, 35.0, None), "sp_rating_def": (-10.0, 30.0, None),
    "goal_to_go": (0.5, 0.5, None), "fourth_and_short": (0.5, 0.5, None),
    "fg_range": (0.5, 0.5, None), "half": (1.5, 1.5, None), "two_minute": (0.5, 0.5, None),
}
# how often a split takes each numeric (the game-state ones most)
FEATURE_WEIGHTS = {"down": 3, "distance": 4, "yardsToGoal": 4, "score_diff": 2,
                   "seconds_remaining": 3}
# (trees, FlatForest max_depth) by head and shape; a quantile forest of
# sklearn max_depth 3 has 4 levels, 15 nodes a tree; stage 2 and the play
# head count trees over all their classes
HEAD_SHAPES = {
    "reference": {"stage1": (188, 6), "stage2": (3, 6), "quant": (400, 4),
                  "fumble": (104, 6), "play": (200, 6)},
    "small": {"stage1": (6, 6), "stage2": (6, 6), "quant": (5, 4),
              "fumble": (4, 6), "play": (10, 6)},
}
# category names a group holds beyond the rosters ("Unknown" and the
# fixture players come first), by shape
GROUP_SIZES = {"reference": {"passer_name": 563, "target_name": 900, "rusher_name": 700,
                             "head_coach": 170},
               "small": {"passer_name": 12, "target_name": 16, "rusher_name": 10,
                         "head_coach": 8}}
# (link, cmp, zero_as_missing, base margins, leaf sd) by head; quantile
# base margins are the (q10, q50, q90) yards
_HEAD_KIND = {
    "stage1": ("sigmoid", "lt", True, (0.5,), 0.03),
    "stage2": ("softmax", "le", False, (-0.26, -2.58, -1.86), 0.1),
    "pass": ("identity", "le", False, ((-3.0,), (6.0,), (22.0,)), 0.05),
    "rush": ("identity", "le", False, ((-2.0,), (3.5,), (12.0,)), 0.04),
    "sack": ("identity", "le", False, ((-10.0,), (-6.0,), (-2.0,)), 0.02),
    "fumble": ("sigmoid", "lt", True, (-4.4,), 0.02),
    "play": ("softmax", "lt", False, (-3.0, 0.2, -3.0, 0.0, -4.0), 0.05),
}


def _roster_names(group: str) -> List[str]:
    """"Unknown" and the fixture teams' players of a group's role(s)."""
    role = {"passer_name": ("pass", 2), "target_name": ("rec", 5),
            "rusher_name": ("rush", 3)}
    if group == "head_coach":
        return list(COACH_MAP.values())
    r, n = role[group]
    names = ["Unknown"] + [roster_name(t, r, i) for t in (TEAM_A[0], TEAM_B[0])
                           for i in range(n)]
    return list(dict.fromkeys(names))


def _layout(groups, numerics, shape: str) -> FeatureLayout:
    cats = {}
    for g in groups:
        hot = _roster_names(g)
        fill = [f"{g.split('_')[0].title()} {i:03d}"
                for i in range(max(0, GROUP_SIZES[shape][g] - len(hot)))]
        cats[g] = tuple(hot + fill)
    return FeatureLayout(cat_group_names=tuple(groups),
                         cat_group_sizes=tuple(len(cats[g]) for g in groups),
                         numeric_names=tuple(numerics), categories=cats)


def _threshold(rng: np.random.Generator, name: str) -> float:
    lo, hi, grid = FEATURE_RANGES[name]
    t = rng.uniform(lo, hi)
    if grid is not None and rng.random() < 0.5:
        t = float(np.clip(np.round(t / (grid / 2)) * (grid / 2), lo, hi))
    return t


def _tree(rng: np.random.Generator, lay: FeatureLayout, levels: int, p_split: float,
          leaf_sd: float, first: bool) -> dict:
    """One tree's local arrays: splits down to `levels` levels (the root
    always splits, others with p_split), a split categorical one time in
    six (on a roster name four times in five), else numeric.  In a forest's
    first tree the root splits on the first group's first player."""
    num_w = np.asarray([FEATURE_WEIGHTS.get(n, 1) for n in lay.numeric_names], float)
    num_w /= num_w.sum()
    t = {k: [] for k in ("feat", "thresh", "left", "right", "default_left", "leaf")}

    def node(level: int) -> int:
        i = len(t["feat"])
        for k, v in (("feat", -1), ("thresh", 0.0), ("left", -1), ("right", -1),
                     ("default_left", False), ("leaf", 0.0)):
            t[k].append(v)
        if level == levels - 1 or (level > 0 and rng.random() >= p_split):
            t["leaf"][i] = float(rng.normal(0.0, leaf_sd))
            return i
        groups = lay.cat_group_names
        if groups and ((first and level == 0) or rng.random() < 1 / 6):
            g = 0 if first and level == 0 else int(rng.integers(len(groups)))
            hot = len(_roster_names(groups[g]))
            local = (min(1, hot - 1) if first and level == 0 else
                     int(rng.integers(hot)) if rng.random() < 0.8 else
                     int(rng.integers(lay.cat_group_sizes[g])))
            t["feat"][i] = lay.cat_group_offsets[g] + local
            t["thresh"][i] = 0.5
        else:
            j = int(rng.choice(len(num_w), p=num_w))
            t["feat"][i] = lay.n_cat + j
            t["thresh"][i] = _threshold(rng, lay.numeric_names[j])
        t["default_left"][i] = bool(rng.random() < 0.5)
        left = node(level + 1)
        right = node(level + 1)
        t["left"][i], t["right"][i] = left, right
        return i

    node(0)
    return t


def _forest(rng: np.random.Generator, kind: str, base, groups, numerics, shape: str,
            n_trees: int, max_depth: int, name: str) -> FlatForest:
    link, cmp, zam, _, leaf_sd = _HEAD_KIND[kind]
    lay = _layout(groups, numerics, shape)
    c = len(base)
    p_split = 1.0 if kind in ("pass", "rush", "sack") else 0.8
    trees = [_tree(rng, lay, max_depth, p_split, leaf_sd, i == 0) for i in range(n_trees)]
    return stack_nodes(trees, lay, tree_class=[i % c for i in range(n_trees)], n_classes=c,
                       base_margin=np.asarray(base, np.float32), link=link, cmp=cmp,
                       name=name, zero_as_missing=zam)


def heads(seed: int, shape: str = "small") -> ModelHeads:
    """Seeded ModelHeads of every head: stage 1 (XGBoost-like: "lt", zeros
    missing, sigmoid, passer_name), stage 2 (the reconstructed sklearn
    head's shape: 3 classes, softmax, "le", passer_name/target_name), nine
    quantile forests (sklearn GBR: identity, "le"; pass by passer and
    target, rush by rusher, sack by passer), fumble (XGBoost-like, sigmoid,
    rusher_name) and the play head (5-class softmax over head_coach and 12
    numerics).  Trees and depths by `HEAD_SHAPES[shape]`."""
    if shape not in HEAD_SHAPES:
        raise ValueError(f"shape must be one of {tuple(HEAD_SHAPES)}, got {shape!r}")
    rng = np.random.default_rng(seed)
    sz = HEAD_SHAPES[shape]

    def one(kind, base, groups, numerics=ST1_FEATURES, key=None, name=None):
        n, depth = sz[key or kind]
        return _forest(rng, kind, base, groups, numerics, shape, n, depth, name or kind)

    def trio(kind, groups):
        bases = _HEAD_KIND[kind][3]
        return tuple(one(kind, b, groups, key="quant", name=f"{kind}_yards_q{q}")
                     for b, q in zip(bases, (10, 50, 90)))

    return ModelHeads(
        stage1=one("stage1", _HEAD_KIND["stage1"][3], ("passer_name",)),
        stage2=one("stage2", _HEAD_KIND["stage2"][3], ("passer_name", "target_name")),
        stage2_class_order=STAGE2_CLASSES,
        pass_quants=trio("pass", ("passer_name", "target_name")),
        rush_quants=trio("rush", ("rusher_name",)),
        sack_quants=trio("sack", ("passer_name",)),
        fumble=one("fumble", _HEAD_KIND["fumble"][3], ("rusher_name",)),
        play=one("play", _HEAD_KIND["play"][3], ("head_coach",), PLAY_NUMERICS),
        play_temperature=1.25,
        play_classes=PLAY_CLASSES,
    )

"""Player-usage share tables (QB / rusher / target sampling weights): port of
fast_monte_carlo_tpu/data/usage.py, read with the `csv` module.

Two sources, as in the JAX package:

* a "focus players" sheet (columns team, player, pos, usage, stat, yards).
  Usage may be a fraction or a percent; the shortfall against 1.0 goes to a
  synthetic ``__Other__`` row;
* per-team fallback usage CSVs (``usage_qb_share.csv`` etc., columns
  offense, year, <name_col>, share), renormalized.

The readers return columns, ``{name_col: names (object), "share": float64}``
with shares summing to 1, where the JAX package returns a DataFrame with the
same columns in the same order.  The JAX package's own names
(`_share_frame`, `build_focus_usage_tables`, `load_usage_table`,
`usage_for_team`) wrap them into DataFrames, importing pandas only there.
"""
from __future__ import annotations

import csv
import math
import os
from typing import Dict, Optional, Sequence, Set, Tuple

import numpy as np

OTHER_SENTINEL = "__Other__"
UNKNOWN = "Unknown"

ROLE_NAME_COLS = {
    "pass": "passer_name",
    "rush": "rusher_name",
    "rec": "receiver_name",
}
_STAT_FOR_ROLE = {"pass": "pass_yards", "rush": "rush_yards", "rec": "rec_yards"}
_FALLBACK_FILES = {
    "pass": "usage_qb_share.csv",
    "rush": "usage_rush_share.csv",
    "rec": "usage_target_share.csv",
}

Columns = Dict[str, np.ndarray]


def _columns(names: Sequence[str], shares: Sequence[float], name_col: str) -> Columns:
    return {name_col: np.asarray(list(names), dtype=object),
            "share": np.asarray(shares, dtype=np.float64)}


def _unknown(name_col: str) -> Columns:
    return _columns([UNKNOWN], [1.0], name_col)


def _to_float(x) -> float:
    """pd.to_numeric(x, errors="coerce") for one cell: NaN where unparsable."""
    try:
        return float(x)
    except (TypeError, ValueError):
        return math.nan


def share_columns(players: Sequence[str], usages: Sequence, name_col: str) -> Columns:
    """(player, usage) rows -> normalized (name_col, share) columns.

    Blank usages count 0 and negatives are clipped to 0.  Percent inputs
    (max > 1.5 over the raw rows) are divided by 100; then a player's rows
    are summed, players sorted by name.  A total of at least 1 - 1e-9 is
    renormalized; below it the shortfall is appended as ``__Other__``."""
    if len(players) == 0:
        return _unknown(name_col)
    use = np.asarray([_to_float(u) for u in usages], dtype=np.float64)
    use = np.clip(np.where(np.isnan(use), 0.0, use), 0.0, None)
    if use.max() > 1.5:
        use = use / 100.0
    summed: Dict[str, float] = {}
    for p, u in zip(players, use):
        summed[p] = summed[p] + u if p in summed else u
    names = sorted(summed)
    usage = np.asarray([summed[p] for p in names], dtype=np.float64)

    total = float(usage.sum())
    if not np.isfinite(total) or total <= 0.0:
        return _unknown(name_col)
    if total >= 1.0 - 1e-9:
        share = usage / total
    else:
        share = usage
        remainder = 1.0 - total
        if remainder > 1e-12:
            names = names + [OTHER_SENTINEL]
            share = np.append(share, remainder)
    s = float(share.sum())
    if not np.isfinite(s) or s <= 0.0:
        return _unknown(name_col)
    return _columns(names, np.clip(share / s, 0.0, None), name_col)


def _read_rows(path: str):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def focus_usage_columns(path: Optional[str]) -> Dict[str, dict]:
    """A focus-players sheet -> per-team {"<role>_share": columns,
    "track_<role>": set of names} for the roles pass, rush and rec.  Team and
    player are stripped, stat stripped and lower-cased; every player named
    for a role's stat is tracked, with a usage or without."""
    if not path or not os.path.exists(path):
        return {}
    rows = [{"team": str(r["team"]).strip(), "player": str(r["player"]).strip(),
             "stat": str(r["stat"]).strip().lower(), "usage": _to_float(r["usage"])}
            for r in _read_rows(path)]
    by_team: Dict[str, dict] = {}
    for team in sorted({r["team"] for r in rows}):
        entry: dict = {}
        for role, name_col in ROLE_NAME_COLS.items():
            bucket = [r for r in rows
                      if r["team"] == team and r["stat"] == _STAT_FOR_ROLE[role]]
            entry[f"{role}_share"] = share_columns(
                [r["player"] for r in bucket], [r["usage"] for r in bucket], name_col)
            entry[f"track_{role}"] = {r["player"] for r in bucket}
        by_team[team] = entry
    return by_team


def load_usage_columns(path: str, team: str, year: int, name_col: str) -> Optional[Columns]:
    """Fallback per-team usage CSV: the rows of (offense == team, year ==
    year) with a name and a share, shares clipped at 0 and renormalized; None
    where the file, the team or the column is missing or a share is not a
    number."""
    try:
        rows = _read_rows(path)
    except OSError:
        return None
    if not rows or name_col not in rows[0]:
        return None
    names, shares = [], []
    for r in rows:
        if r.get("offense") != team or _to_float(r.get("year")) != year:
            continue
        name, share = r[name_col], r["share"]
        if name in ("", None) or share in ("", None):
            continue   # dropna
        try:
            shares.append(float(share))
        except ValueError:
            return None
        names.append(name)
    if not names:
        return None
    s = np.clip(np.asarray(shares, dtype=np.float64), 0.0, None)
    total = float(s.sum())
    return _columns(names, s / total if total > 0 else np.ones_like(s), name_col)


def usage_columns_for_team(
    team: str,
    year: int,
    focus_usage: Dict[str, dict],
    usage_dir: Optional[str] = ".",
) -> Tuple[Columns, Columns, Columns, Set[str], Set[str], Set[str]]:
    """Focus-sheet usage if the team is in it, else the fallback files in
    `usage_dir` (None: none), else one Unknown player per role.  Returns
    (pass, rush, rec columns, pass, rush, rec track sets)."""
    if team in focus_usage:
        info = focus_usage[team]
        return (
            {c: v.copy() for c, v in info["pass_share"].items()},
            {c: v.copy() for c, v in info["rush_share"].items()},
            {c: v.copy() for c, v in info["rec_share"].items()},
            set(info["track_pass"]), set(info["track_rush"]), set(info["track_rec"]),
        )
    cols = {}
    for role, fname in _FALLBACK_FILES.items():
        name_col = ROLE_NAME_COLS[role]
        got = (None if usage_dir is None else
               load_usage_columns(os.path.join(usage_dir, fname), team, year, name_col))
        cols[role] = _unknown(name_col) if got is None else got
    return cols["pass"], cols["rush"], cols["rec"], set(), set(), set()


# ---- the JAX package's DataFrame surface (pandas imported on call) ----------

def _frame(cols: Columns):
    import pandas as pd

    return pd.DataFrame(cols)


def _share_frame(players, name_col: str):
    """DataFrame of `share_columns` over a (player, usage) frame."""
    if players is None or players.empty:
        return _frame(_unknown(name_col))
    return _frame(share_columns(list(players["player"]), list(players["usage"]), name_col))


def build_focus_usage_tables(path: Optional[str]) -> Dict[str, dict]:
    """`focus_usage_columns` with each share table as a DataFrame."""
    return {team: {key: _frame(v) if key.endswith("_share") else v
                   for key, v in entry.items()}
            for team, entry in focus_usage_columns(path).items()}


def load_usage_table(path: str, team: str, year: int, name_col: str):
    cols = load_usage_columns(path, team, year, name_col)
    return None if cols is None else _frame(cols)


def usage_for_team(team: str, year: int, focus_usage: Dict[str, dict],
                   usage_dir: Optional[str] = "."):
    """`usage_columns_for_team` with DataFrames; `focus_usage` as
    `focus_usage_columns` gives it."""
    *cols, tp, tr, trec = usage_columns_for_team(team, year, focus_usage, usage_dir)
    return (*(_frame(c) for c in cols), tp, tr, trec)

"""SP+ rating sheets: port of fast_monte_carlo_tpu/data/sp.py, read with `csv`.

* ``load_sp_flex`` / ``lookup_sp_flex``: schema-flexible single-week sheets.
  Schema A is ``team,RATING,OFFENSE,DEFENSE[,year,week,...]``; schema B is
  the 2025 sheet with ``'Current SP+'/'Past SP+'`` name columns and
  ``Rating/Offense Rating/Defense Rating`` value columns.
* ``load_sp_historical`` / ``lookup_sp_historical``: a multi-year weekly
  table with latest-at-or-before-week selection.

The JAX package reads the sheets with pandas; here they become an
`SpTable`, a column table of numpy arrays with the same columns, rows and
values: cells pandas reads as missing (its default NA strings) are NaN
(a missing team name too, as pandas' string columns keep it), a
schema-B sheet is Current rows then Past rows with missing teams dropped
and duplicate teams kept first (before the team names are stripped, as
pandas compares them), and numbers parse as Python floats.  So the same
sheet resolves the same teams to the same three floats.
"""
from __future__ import annotations

import csv
import re
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_SCHEMA_A = {"team", "RATING", "OFFENSE", "DEFENSE"}
_SCHEMA_B = {"Current SP+", "Past SP+", "Rating", "Offense Rating", "Defense Rating"}
# the strings pandas.read_csv reads as missing by default
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"})


def norm_team(name: str) -> str:
    """Lowercase and strip non-alphanumerics."""
    return re.sub(r"[^a-z0-9]+", "", str(name).lower())


class SpTable:
    """Columns of equal length, in order: name -> numpy array (float64 for
    numbers, object for names).  `attrs` holds what is computed from the
    content once (the tables are never mutated), as a DataFrame's attrs."""

    def __init__(self, cols: Dict[str, np.ndarray]):
        self.cols = cols
        self.attrs: dict = {}

    @property
    def columns(self) -> List[str]:
        return list(self.cols)

    def __getitem__(self, name: str) -> np.ndarray:
        return self.cols[name]

    def __len__(self) -> int:
        return len(next(iter(self.cols.values()))) if self.cols else 0


def _cell(row: Sequence[str], i: int) -> Optional[str]:
    """Cell i of a row, None where pandas reads a missing value."""
    v = row[i] if i < len(row) else ""
    return None if v in NA_STRINGS else v


def _read(path: str) -> Tuple[List[str], List[List[str]]]:
    """(header, rows) of a CSV, blank lines skipped as pandas skips them."""
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f) if r]
    if not rows:
        raise ValueError(f"{path}: no columns to parse")
    return rows[0], rows[1:]


def _floats(cells: Sequence[Optional[str]], col: str) -> np.ndarray:
    try:
        return np.asarray([np.nan if c is None else float(c) for c in cells], np.float64)
    except ValueError as e:
        raise ValueError(f"column {col!r}: {e}") from None


def _ints(cells: Sequence[Optional[str]], col: str) -> np.ndarray:
    x = _floats(cells, col)
    if not np.isfinite(x).all():
        raise ValueError(f"column {col!r}: cannot convert non-finite values (NA or inf) "
                         "to integer")
    return x.astype(np.int64)


def _names(cells: Sequence[Optional[str]]) -> np.ndarray:
    """Names as pandas' astype(str) leaves them: a missing one stays NaN."""
    return np.asarray([np.nan if c is None else c for c in cells], dtype=object)


def _lower(name) -> Optional[str]:
    """pandas' str.lower(): NaN for a missing name."""
    return name.lower() if isinstance(name, str) else None


@lru_cache(maxsize=32)
def load_sp_flex(sp_path: str) -> SpTable:
    """Load an SP+ sheet into the columns team/RATING/OFFENSE/DEFENSE/norm_team."""
    header, rows = _read(sp_path)
    at = {c: i for i, c in reversed(list(enumerate(header)))}   # first column of a name
    cols = set(header)
    if _SCHEMA_A.issubset(cols):
        team = [_cell(r, at["team"]) for r in rows]
        vals = {c: [_cell(r, at[c]) for r in rows] for c in ("RATING", "OFFENSE", "DEFENSE")}
    elif _SCHEMA_B.issubset(cols):
        team, vals = [], {"RATING": [], "OFFENSE": [], "DEFENSE": []}
        seen = set()
        for name_col in ("Current SP+", "Past SP+"):
            for r in rows:
                t = _cell(r, at[name_col])
                if t is None or t in seen:     # dropna, then drop_duplicates(keep="first")
                    continue
                seen.add(t)
                team.append(t)
                for c, src in (("RATING", "Rating"), ("OFFENSE", "Offense Rating"),
                               ("DEFENSE", "Defense Rating")):
                    vals[c].append(_cell(r, at[src]))
    else:
        raise ValueError(
            f"{sp_path} matches neither SP+ schema: need either "
            f"{sorted(_SCHEMA_A)} (schema A) or {sorted(_SCHEMA_B)} "
            f"(schema B); the sheet has {sorted(cols)}"
        )
    names = np.asarray([t.strip() if isinstance(t, str) else t for t in _names(team)],
                       dtype=object)
    return SpTable({"team": names,
                    **{c: _floats(v, c) for c, v in vals.items()},
                    "norm_team": np.asarray([norm_team(t) for t in names], dtype=object)})


def lookup_sp_flex(team: str, sp_df: SpTable) -> Tuple[float, float, float]:
    """Return (RATING, OFFENSE, DEFENSE), fuzzy-matching the team name.

    Match strategies run in order of strictness — normalized equality,
    case-insensitive equality, then case-insensitive substring — and the
    first hit (in row order) wins."""
    low = team.lower()
    names = [_lower(t) for t in sp_df["team"]]
    strategies = (
        lambda: [n == norm_team(team) for n in sp_df["norm_team"]],
        lambda: [t == low for t in names],
        lambda: [t is not None and low in t for t in names],
    )
    for match in strategies:
        hit = np.flatnonzero(match())
        if hit.size:
            i = int(hit[0])
            return (float(sp_df["RATING"][i]), float(sp_df["OFFENSE"][i]),
                    float(sp_df["DEFENSE"][i]))
    raise ValueError(
        f"no SP+ row matches team {team!r} (tried normalized, exact, and "
        "substring matches)")


@lru_cache(maxsize=8)
def load_sp_historical(path: str) -> SpTable:
    """Multi-year weekly SP+ table: team,RATING,OFFENSE,DEFENSE,year,week
    (and conference, where the sheet has it)."""
    header, rows = _read(path)
    at = {c: i for i, c in reversed(list(enumerate(header)))}
    out: Dict[str, np.ndarray] = {}
    for c in ("team", "RATING", "OFFENSE", "DEFENSE", "year", "week", "conference"):
        if c not in at:
            continue
        cells = [_cell(r, at[c]) for r in rows]
        if c == "team":
            out[c] = _names(cells)
        elif c in ("year", "week"):
            out[c] = _ints(cells, c)
        elif c == "conference":
            out[c] = np.asarray([np.nan if v is None else v for v in cells], dtype=object)
        else:
            out[c] = _floats(cells, c)
    for c in ("team", "year", "week"):
        if c not in out:
            raise KeyError(c)
    return SpTable(out)


def lookup_sp_historical(team: str, year: int, week: int, path: str) -> Tuple[float, float, float]:
    """Latest entry at-or-before `week` in `year`; else the latest week of
    that year."""
    sp = load_sp_historical(path)
    mask = (sp["year"] == year) & np.asarray([_lower(t) == team.lower() for t in sp["team"]],
                                            dtype=bool)
    rows = np.flatnonzero(mask & (sp["week"] <= week))
    if rows.size == 0:
        rows = np.flatnonzero(mask)
        if rows.size == 0:
            raise ValueError(f"SP+ not found for team={team}, year={year}.")
    i = int(rows[np.argsort(sp["week"][rows], kind="stable")[-1]])
    return float(sp["RATING"][i]), float(sp["OFFENSE"][i]), float(sp["DEFENSE"][i])

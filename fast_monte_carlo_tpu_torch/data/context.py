"""Team context: SP+ ratings + per-role player tables in dense padded form.

Port of `fast_monte_carlo_tpu/data/context.py` without pandas: `RoleTable`,
`TeamContext`, `_build`, and the builders from an SP+ sheet
(`build_team_context_from_sp_flex`, `build_team_context`, read by
`data/sp.py`) with their memos.  Player shares come from `data/usage.py`: a
focus-players sheet, the per-team fallback files, or, where neither names
the team, one `Unknown` slot with share 1.0 per role.

Slot layout per role (K = player_slots):
  names[k]    player name ('' for padding)
  share[k]    sampling share (padding gets 0)
  tracked[k]  whether per-player stats accrue for this slot
  is_other[k] synthetic ``__Other__`` remainder slot: sampled like any
              other player, fed to models as Unknown, never tracked
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set

import numpy as np

from .sp import SpTable, load_sp_flex, lookup_sp_flex, lookup_sp_historical
from .usage import (_FALLBACK_FILES, OTHER_SENTINEL, UNKNOWN, focus_usage_columns,
                    usage_columns_for_team)


@dataclass
class RoleTable:
    names: List[str]
    share: np.ndarray       # (K,) float64, sums to 1 over real slots
    tracked: np.ndarray     # (K,) bool
    is_other: np.ndarray    # (K,) bool

    @property
    def k(self) -> int:
        return len(self.names)

    @property
    def cum_share(self) -> np.ndarray:
        return np.cumsum(self.share)

    @staticmethod
    def from_shares(names: Sequence[str], shares: Sequence[float], track: Set[str],
                    k: int) -> "RoleTable":
        """The JAX package's `from_share_frame` on (names, shares): a stable
        sort by share, descending, the first k kept and renormalized, then
        padding to k slots."""
        order = sorted(range(len(names)), key=lambda i: shares[i], reverse=True)
        names = [str(names[i]) for i in order][:k]
        shares = [float(shares[i]) for i in order][:k]
        total = sum(shares)
        if total > 0:
            shares = [s / total for s in shares]
        pad = k - len(names)
        names += [""] * pad
        shares += [0.0] * pad
        return RoleTable(
            names=names,
            share=np.asarray(shares, dtype=np.float64),
            tracked=np.array([(n in track) and n not in ("", OTHER_SENTINEL) for n in names]),
            is_other=np.array([n == OTHER_SENTINEL for n in names]),
        )

    def sample_name(self, u: float) -> str:
        idx = int(np.searchsorted(self.cum_share, u, side="right"))
        return self.names[min(idx, self.k - 1)]

    def model_name(self, slot: int) -> str:
        """Name as fed to the models: __Other__ and padding map to Unknown."""
        n = self.names[slot]
        return UNKNOWN if n in (OTHER_SENTINEL, "") else n


@dataclass
class TeamContext:
    name: str
    year: int
    week: int
    sp_rating: float
    sp_offense: float
    sp_defense: float
    qb: RoleTable
    rush: RoleTable
    target: RoleTable

    @property
    def any_tracking(self) -> bool:
        return bool(self.qb.tracked.any() or self.rush.tracked.any()
                    or self.target.tracked.any())


def _role(cols: Dict[str, np.ndarray], track: Set[str], k: int) -> RoleTable:
    name_col = next(c for c in cols if c != "share")
    return RoleTable.from_shares(list(cols[name_col]), list(cols["share"]), track, k)


def _build(team: str, year: int, week: int, rating: float, off: float, deff: float,
           focus_usage: dict, usage_dir: Optional[str], player_slots: int) -> TeamContext:
    """`focus_usage` as `usage.focus_usage_columns` gives it."""
    qb, rush, rec, tp, tr, trec = usage_columns_for_team(team, year, focus_usage, usage_dir)
    return TeamContext(
        name=team, year=year, week=week,
        sp_rating=rating, sp_offense=off, sp_defense=deff,
        qb=_role(qb, tp, player_slots),
        rush=_role(rush, tr, player_slots),
        target=_role(rec, trec, player_slots),
    )


def team_context(name: str, year: int, week: int, rating: float, off: float,
                 deff: float, player_slots: int = 8, focus_usage: Optional[dict] = None,
                 usage_dir: Optional[str] = None) -> TeamContext:
    """A team from its SP+ numbers.  Players come from `focus_usage`
    (`usage.focus_usage_columns` of a focus sheet), else from the fallback
    files in `usage_dir`; with neither, one Unknown player per role."""
    return _build(name, year, week, rating, off, deff, focus_usage or {}, usage_dir,
                  player_slots)


# In-process memos for the warm slate path, as in the JAX package: a slate
# builds two contexts a matchup per call, and each would re-read the focus
# sheet.  Keys are content (team, the sheet's fingerprint, file stats),
# never identity, so a rebuilt table or an edited file misses.  Returned
# TeamContexts are shared and treated as immutable (the engine packs them
# into arrays).
_CONTEXT_MEMO: dict = {}
_FOCUS_MEMO: dict = {}


def _file_fp(path) -> tuple:
    """(path, mtime_ns, size) — stat-based staleness fingerprint."""
    try:
        st = os.stat(path)
        return (str(path), st.st_mtime_ns, st.st_size)
    except OSError:
        return (str(path), None, None)


def _focus_tables_cached(focus_csv: str) -> dict:
    fp = _file_fp(focus_csv)
    hit = _FOCUS_MEMO.get(fp)
    if hit is None:
        hit = _FOCUS_MEMO[fp] = focus_usage_columns(focus_csv)
    return hit


def _sp_fp(sp_df: SpTable) -> int:
    """Content fingerprint of an SP+ table, computed once and stashed in its
    attrs so memo hits skip the fuzzy lookup; no code path mutates a loaded
    table."""
    fp = sp_df.attrs.get("_fmc_content_fp")
    if fp is None:
        fp = sp_df.attrs["_fmc_content_fp"] = hash(
            tuple((k, tuple(v.tolist())) for k, v in sp_df.cols.items()))
    return fp


def build_team_context_from_sp_flex(
    team: str,
    year: int,
    week: int,
    sp_df: Optional[SpTable] = None,
    *,
    sp_path: Optional[str] = None,
    focus_csv: Optional[str] = None,
    usage_dir: str = ".",
    player_slots: int = 8,
) -> TeamContext:
    """Context from a flex-schema SP+ sheet (`data.sp.load_sp_flex`)."""
    if sp_df is None:
        if sp_path is None:
            raise ValueError("provide sp_df or sp_path")
        sp_df = load_sp_flex(sp_path)
    key = (team, year, week, _sp_fp(sp_df),
           _file_fp(focus_csv) if focus_csv else None,
           tuple(_file_fp(os.path.join(usage_dir, f))
                 for f in _FALLBACK_FILES.values()),
           player_slots)
    hit = _CONTEXT_MEMO.get(key)
    if hit is not None:
        return hit
    rating, off, deff = lookup_sp_flex(team, sp_df)
    focus = _focus_tables_cached(focus_csv) if focus_csv else {}
    ctx = _build(team, year, week, rating, off, deff, focus, usage_dir, player_slots)
    _CONTEXT_MEMO[key] = ctx
    return ctx


def build_team_context(
    team: str,
    year: int,
    week: int,
    *,
    sp_hist_path: str,
    focus_csv: Optional[str] = None,
    usage_dir: str = ".",
    player_slots: int = 8,
) -> TeamContext:
    """Context from the historical weekly SP+ table."""
    rating, off, deff = lookup_sp_historical(team, year, week, sp_hist_path)
    focus = focus_usage_columns(focus_csv) if focus_csv else {}
    return _build(team, year, week, rating, off, deff, focus, usage_dir, player_slots)

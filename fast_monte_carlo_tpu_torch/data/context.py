"""Team context: SP+ ratings + per-role player tables in dense padded form.

Port of `fast_monte_carlo_tpu/data/context.py` (`RoleTable`, `TeamContext`,
`_build`) without pandas.  Player shares come from `data/usage.py`: a
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

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set

import numpy as np

from .usage import OTHER_SENTINEL, UNKNOWN, usage_columns_for_team


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

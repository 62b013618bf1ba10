"""Market pricing: port of fast_monte_carlo_tpu/edge.py.

The odds math (American odds, EV at a price, Kelly stakes, the better side
of a prop), the mapping of a prop sheet's rows onto a matchup's player-stat
cells (`resolve_prop_rows`), the per-prop reduction over a batch of games
on the device of its player stats (`reduce_props_device`) and the prop
table with edges and EV.  The game markets priced from a `ScoreSummary`'s
histograms (`market_odds_from_summary`, `summary_moneyline`), their
alternate-line ladders (`alt_lines_from_summary`), middles
(`middles_from_summary`) and a whole slate's markets
(`slate_market_table`) go through the `Dist` core in numpy on the host.
Multi-leg tickets settle every leg on the same simulated game: same-game
parlays (`parlay_odds`), leg correlations, round robins and teasers reduce
over the games on the device of the scores (`reduce_parlay_device`,
`leg_corr_device`, `reduce_round_robin_device`), with one host copy of
their counts; cross-game tickets (`cross_game_parlay`,
`round_robin_blocks`) and season win totals (`season_win_pmf`,
`season_win_market`) compose independent games on the host.

The markets over saved sim files (`sim --save`'s scores_* and players_*,
CSV or parquet) read them as columns (`data.columns`: a CSV typed and
valued as pandas reads it, parquet through pandas imported on use) and price
them through the same `Dist` core: `player_prop_odds` and its ladder,
`game_market_odds`, `moneyline_from_sims`, `alt_line_rows_from_sims`,
`middles_from_sims`, the prop-sheet scan (`scan_props_for_matchup_rows`)
and the one-call report `find_edges`, with the printers of its parts.

Two divergences from the JAX package, on purpose: `Dist.affine` raises for
scale <= 0, which the JAX package accepts (its edge.py:262; a negative
scale mirrors the distribution and swaps over and under); and the saved-file
prop scan skips a row only for the errors a row can raise (ValueError,
KeyError, FileNotFoundError, a team or player cell that is not text),
where the JAX package skips on any exception (its edge.py:486).

The JAX package returns the prop table, the ladders and the slate table as
DataFrames; here the pandas-free cores return lists of row dicts in the
same column order (`prop_rows_from_reductions`, `scan_props_rows`,
`alt_spread_rows`, `alt_total_rows`, `alt_line_rows_from_summary`,
`slate_market_rows`, `parlay_correlation_matrix`, `alt_prop_rows`,
`player_prop_ladder_rows`, `alt_line_rows_from_sims`,
`scan_props_for_matchup_rows`, `read_table_columns`,
`load_players_columns`), and the JAX package's names wrap them into
DataFrames, importing pandas only there.  The printers take either.
"""
from __future__ import annotations

import ast
import csv
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .data.columns import (Columns, columns_from_records, columns_of, frame, is_na, lowered,
                           read_csv_columns, records_of, take, to_numeric)
from .stats import ROLE_PASS, ROLE_REC, ROLE_RUSH

STAT_ALIASES = {
    "pass_yards": "pass_yds",
    "rush_yards": "rush_yds",
    "rec_yards": "rec_yds",
}

_STAT_TO_ROLE_COL = {
    # stat column -> (role name, pstats column index)
    "pass_yds": ("pass", 2), "pass_td": ("pass", 3), "pass_att": ("pass", 0),
    "pass_comp": ("pass", 1), "INT": ("pass", 4), "sacks": ("pass", 5),
    "rush_yds": ("rush", 2), "rush_td": ("rush", 3), "rush_att": ("rush", 0),
    "rec_yds": ("rec", 2), "rec_td": ("rec", 3), "rec": ("rec", 1),
    "tgt": ("rec", 0),
}

PROP_TABLE_COLS = ("team", "player", "stat", "line", "best_side", "p_over", "p_under",
                   "edge_pct", "ev_$100", "mean", "median", "p75", "p90", "samples")
_QUANTILES = (0.5, 0.75, 0.9)
# at most this many elements per quantile call (columns are split to fit)
_QUANTILE_CHUNK = 1 << 24


def _norm_team(s: str) -> str:
    return re.sub(r"[^a-z0-9]+", "", str(s).lower())


# ---- odds math ---------------------------------------------------------------

def prob_to_american(p: float) -> int:
    """Fair (no-vig) American odds for probability p."""
    p = float(np.clip(p, 1e-6, 1 - 1e-6))
    if p >= 0.5:
        return int(round(-100 * p / (1 - p)))
    return int(round(100 * (1 - p) / p))


def breakeven_minus110() -> float:
    return 110.0 / 210.0


def ev_per_100_at_minus110(p_win: float, p_push: float = 0.0) -> float:
    """EV per $100 risked at -110; a push returns the stake."""
    win_profit = 100.0 * (100.0 / 110.0)
    return p_win * win_profit - (1.0 - p_win - p_push) * 100.0


def american_implied_prob(price: int) -> float:
    return (-price) / ((-price) + 100) if price < 0 else 100 / (price + 100)


def ev_per_100(p_win: float, price: int) -> float:
    profit = 100 * (100 / (-price)) if price < 0 else 100 * (price / 100)
    return p_win * profit - (1 - p_win) * 100


def kelly_fraction(p_win: float, price: int = -110, p_push: float = 0.0) -> float:
    """Full-Kelly stake fraction of a two-outcome bet at American odds, a
    push returning the stake: f* = (p_win*b - p_lose) / (b * (p_win +
    p_lose)), b the profit per unit staked; floored at 0."""
    p_win, p_push = float(p_win), float(p_push)
    p_lose = max(0.0, 1.0 - p_win - p_push)
    b = (100.0 / -price) if price < 0 else (price / 100.0)
    denom = b * (p_win + p_lose)
    if denom <= 0:
        return 0.0
    return max(0.0, (p_win * b - p_lose) / denom)


def best_side_ev(p_over: float, price: int = -110) -> dict:
    """The better of Over and Under at the same price."""
    ev_over = ev_per_100(p_over, price)
    ev_under = ev_per_100(1 - p_over, price)
    ip = american_implied_prob(price)
    if ev_over >= ev_under:
        return {"side": "Over", "ev": ev_over, "edge": p_over - ip}
    return {"side": "Under", "ev": ev_under, "edge": (1 - p_over) - ip}


# ---- prop sheet -> pstats cells -----------------------------------------------

def _resolve_stat_target(tc, player, stat, *, strict: bool):
    """One (player, stat) on a team context -> (role, slot, col, canonical
    stat name).  strict=False returns None on anything unresolvable (a scan
    skips the row); strict=True raises."""
    role_idx = {"pass": ROLE_PASS, "rush": ROLE_RUSH, "rec": ROLE_REC}
    stat_col = STAT_ALIASES.get(str(stat), str(stat))
    rc = _STAT_TO_ROLE_COL.get(stat_col)
    if rc is None:
        if strict:
            raise ValueError(f"unknown prop stat {stat!r}")
        return None
    role_name, col = rc
    table = {"pass": tc.qb, "rush": tc.rush, "rec": tc.target}[role_name]
    want = str(player).lower()
    slot = next((k for k, nm in enumerate(table.names)
                 if str(nm).lower() == want and table.tracked[k]), None)
    if slot is None:
        if strict:
            raise ValueError(
                f"player {player!r} is not tracked for {tc.name}; "
                "parlay legs need a tracked player")
        return None
    return role_idx[role_name], slot, col, stat_col


def read_prop_sheet(path: str) -> List[dict]:
    """A prop sheet CSV (columns team, player, stat, yards) as row dicts."""
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def resolve_prop_rows(team_a_ctx, team_b_ctx, props):
    """Map a prop sheet's rows (an iterable of dicts with team, player, stat
    and yards, or a DataFrame) onto one matchup's pstats cells.

    Returns (indices, meta): indices = (side, role, slot, col) int32 and
    line f32 numpy arrays, padded to a multiple of 8 rows by repeating the
    first row; meta the unpadded row list.  Rows naming an untracked player,
    a team not in this matchup or an unknown stat are skipped.  (None, [])
    if no row resolves."""
    if hasattr(props, "to_dict"):
        props = props.to_dict("records")
    sides = {_norm_team(team_a_ctx.name): (0, team_a_ctx),
             _norm_team(team_b_ctx.name): (1, team_b_ctx)}
    rows, meta = [], []
    for r in props:
        key = _norm_team(r["team"])
        if key not in sides:
            continue
        side, tc = sides[key]
        hit = _resolve_stat_target(tc, r["player"], r["stat"], strict=False)
        if hit is None:
            continue
        role, slot, col, stat_col = hit
        rows.append((side, role, slot, col, float(r["yards"])))
        meta.append({"team": r["team"], "player": r["player"],
                     "stat": stat_col, "line": float(r["yards"])})
    if not rows:
        return None, []
    rows = rows + [rows[0]] * ((-len(rows)) % 8)
    idx = np.asarray(rows, dtype=np.float32)
    side_i, role_i, slot_i, col_i = (idx[:, j].astype(np.int32) for j in range(4))
    return (side_i, role_i, slot_i, col_i, idx[:, 4]), meta


# ---- the reduction -------------------------------------------------------------

def reduce_props_device(pstats: torch.Tensor, indices) -> Dict[str, torch.Tensor]:
    """Per-prop scalars over a batch of games, on the device of `pstats`
    ((B, 2, 3, K, 6)): P(over), P(under), P(push) (|value - line| <= 1e-9),
    mean, median, p75 and p90, all over the games where the player recorded
    any stat (a player has a row only there), and that count (at least 1)
    as n_active.  Quantiles interpolate linearly, as numpy's do."""
    dev = pstats.device
    side, role, slot, col = (torch.as_tensor(np.asarray(a), device=dev).long()
                             for a in indices[:4])
    lines = torch.as_tensor(np.asarray(indices[4]), dtype=torch.float32, device=dev)
    vals = pstats[:, side, role, slot, col]                        # (B, P)
    act = (pstats[:, side, role, slot, :] != 0).any(dim=-1)
    cnt = act.sum(dim=0).to(torch.float32).clamp_min(1.0)
    masked = torch.where(act, vals, torch.nan)
    q = torch.tensor(_QUANTILES, dtype=vals.dtype, device=dev)
    step = max(1, _QUANTILE_CHUNK // max(1, vals.shape[0]))
    quant = torch.cat([torch.nanquantile(masked[:, j:j + step], q, dim=0)
                       for j in range(0, vals.shape[1], step)], dim=1)
    return {
        "p_over": ((vals > lines) & act).sum(dim=0) / cnt,
        "p_under": ((vals < lines) & act).sum(dim=0) / cnt,
        "push": (((vals - lines).abs() <= 1e-9) & act).sum(dim=0) / cnt,
        "mean": torch.where(act, vals, 0.0).sum(dim=0) / cnt,
        "median": quant[0], "p75": quant[1], "p90": quant[2],
        "n_active": cnt,
    }


# ---- the prop table --------------------------------------------------------------

def _prop_table(meta, red, min_abs_edge_pct: float) -> Tuple[List[int], List[dict]]:
    """(original row positions, rows) sorted by |edge| then EV, both
    descending (ties keep sheet order), then rows under the edge floor
    dropped."""
    rows = []
    for i, m in enumerate(meta):
        p_over = float(red["p_over"][i])
        rec = best_side_ev(p_over, price=-110)
        rows.append({
            **m, "best_side": rec["side"],
            "p_over": round(p_over, 4),
            "p_under": round(float(red["p_under"][i]), 4),
            "edge_pct": round(rec["edge"] * 100, 2),
            "ev_$100": round(rec["ev"], 2),
            "mean": float(red["mean"][i]), "median": float(red["median"][i]),
            "p75": float(red["p75"][i]), "p90": float(red["p90"][i]),
            "samples": int(red["n_active"][i]),
        })
    order = sorted(range(len(rows)),
                   key=lambda i: (-abs(rows[i]["edge_pct"]), -rows[i]["ev_$100"]))
    keep = [i for i in order if abs(rows[i]["edge_pct"]) >= min_abs_edge_pct]
    return keep, [rows[i] for i in keep]


def prop_rows_from_reductions(meta, red, min_abs_edge_pct: float = 2.0) -> List[dict]:
    """The prop table as row dicts (PROP_TABLE_COLS order) from reductions
    (arrays or tensors, padded length >= len(meta))."""
    return _prop_table(meta, red, min_abs_edge_pct)[1]


def prop_table_from_reductions(meta, red, min_abs_edge_pct: float = 2.0):
    """`prop_rows_from_reductions` as a DataFrame indexed by sheet row."""
    import pandas as pd

    index, rows = _prop_table(meta, red, min_abs_edge_pct)
    return pd.DataFrame(rows, index=index, columns=list(PROP_TABLE_COLS))


def _scan(out, team_a_ctx, team_b_ctx, prop_sheet_path: str):
    """(meta, host reductions) of a prop sheet against `out.pstats`."""
    indices, meta = resolve_prop_rows(team_a_ctx, team_b_ctx,
                                      read_prop_sheet(prop_sheet_path))
    if not meta:
        return meta, None
    red = reduce_props_device(out.pstats, indices)
    return meta, {k: v.cpu().numpy() for k, v in red.items()}


def scan_props_rows(out, team_a_ctx, team_b_ctx, prop_sheet_path: str,
                    min_abs_edge_pct: float = 2.0) -> List[dict]:
    """Prop scan of a GameState run with collect_players=True against the
    sheet at `prop_sheet_path`: the reduction runs on the device of
    `out.pstats`, the table on the host.  [] if no row resolves."""
    meta, red = _scan(out, team_a_ctx, team_b_ctx, prop_sheet_path)
    return prop_rows_from_reductions(meta, red, min_abs_edge_pct) if meta else []


def scan_props_device(out, team_a_ctx, team_b_ctx, prop_sheet_path: str,
                      min_abs_edge_pct: float = 2.0):
    """`scan_props_rows` as a DataFrame (the JAX package's index: sheet row)."""
    meta, red = _scan(out, team_a_ctx, team_b_ctx, prop_sheet_path)
    if not meta:
        import pandas as pd

        return pd.DataFrame()
    return prop_table_from_reductions(meta, red, min_abs_edge_pct)


# ---- the distribution core and the summary markets ----------------------------------

class Dist:
    """Empirical distribution of one scalar market quantity, from per-trial
    samples or from an integer-support histogram (a ScoreSummary's); every
    market is a formatting of its queries.  Samples: the median is
    np.median, a push is |x - line| <= 1e-9.  Histogram: the median is the
    support point where the CDF crosses n/2, a push is np.isclose on the
    support, the mean is count-weighted."""

    def __init__(self, values: Optional[np.ndarray] = None,
                 counts: Optional[np.ndarray] = None,
                 support: Optional[np.ndarray] = None):
        if (values is None) == (counts is None):
            raise ValueError("Dist takes either values or counts+support")
        if counts is not None and support is None:
            raise ValueError("Dist(counts=...) requires support")
        self.values = None if values is None else np.asarray(values, float)
        self.counts = None if counts is None else np.asarray(counts, float)
        self.support = None if support is None else np.asarray(support, float)

    @classmethod
    def from_values(cls, values) -> "Dist":
        return cls(values=np.asarray(values, float))

    @classmethod
    def from_hist(cls, counts, support) -> "Dist":
        return cls(counts=counts, support=np.asarray(support, float))

    @property
    def n(self) -> float:
        return float(self.values.size if self.values is not None
                     else self.counts.sum())

    def over(self, line: float) -> float:
        if self.values is not None:
            return float(np.mean(self.values > line))
        return float(self.counts[self.support > line].sum() / self.n)

    def under(self, line: float) -> float:
        if self.values is not None:
            return float(np.mean(self.values < line))
        return float(self.counts[self.support < line].sum() / self.n)

    def push(self, line: float) -> float:
        if self.values is not None:
            return float(np.mean(np.isclose(self.values, line, atol=1e-9)))
        return float(self.counts[np.isclose(self.support, line)].sum() / self.n)

    def mean(self) -> float:
        if self.values is not None:
            return float(np.mean(self.values))
        return float((self.counts * self.support).sum() / self.n)

    def median(self) -> float:
        if self.values is not None:
            return float(np.median(self.values))
        return float(self.support[np.searchsorted(np.cumsum(self.counts),
                                                  self.n / 2.0)])

    def pct(self, q: float) -> float:
        if self.values is not None:
            return float(np.percentile(self.values, q))
        cum = np.cumsum(self.counts)
        return float(self.support[np.searchsorted(cum, self.n * q / 100.0)])

    def affine(self, shift: float = 0.0, scale: float = 1.0) -> "Dist":
        """Calibration-corrected copy: x -> mean + scale*(x - mean) + shift.
        A histogram's support moves; its counts (and n) stay.  The identity
        returns self.  scale <= 0 raises: it would mirror the distribution
        (or collapse it) and swap the sides of every market."""
        if not scale > 0:
            raise ValueError(f"Dist.affine needs scale > 0, got {scale}")
        if shift == 0.0 and scale == 1.0:
            return self
        m = self.mean()
        if self.values is not None:
            return Dist(values=m + scale * (self.values - m) + shift)
        return Dist(counts=self.counts,
                    support=m + scale * (self.support - m) + shift)


@dataclass(frozen=True)
class MarketCalibration:
    """Opt-in affine backtest correction of the two game markets, applied
    to the margin and total Dists before any query, so main lines and the
    moneyline stay consistent; off by default."""
    margin_shift: float = 0.0
    margin_scale: float = 1.0
    total_shift: float = 0.0
    total_scale: float = 1.0

    def margin(self, d: Dist) -> Dist:
        return d.affine(self.margin_shift, self.margin_scale)

    def total(self, d: Dist) -> Dist:
        return d.affine(self.total_shift, self.total_scale)


def _ou_market(dist: Dist, line: float, *, head: Dict, over_key: str,
               under_key: str, digits: int, loc_prefix: str) -> Dict:
    """One two-sided market dict off a Dist: probabilities, fair prices and
    location under the caller's key names."""
    p_over, p_under, p_push = dist.over(line), dist.under(line), dist.push(line)
    return {
        **head, "samples": int(dist.n),
        f"p_{over_key}": round(p_over, digits),
        f"p_{under_key}": round(p_under, digits),
        "push_rate": round(p_push, digits),
        f"american_{over_key}": prob_to_american(p_over),
        f"american_{under_key}": prob_to_american(p_under),
        f"mean{loc_prefix}": dist.mean(),
        f"median{loc_prefix}": dist.median(),
    }


def _spread_market(margins: Dist, team: str, opp: str, spread: float) -> Dict:
    """Cover iff margin > -spread, push at equality."""
    return _ou_market(
        margins, -float(spread), digits=6, over_key="cover",
        under_key="notcover", loc_prefix="_margin",
        head={"team": team, "opp": opp, "spread": float(spread)})


def _total_market(totals: Dist, team: str, opp: str, total: float) -> Dict:
    return _ou_market(
        totals, float(total), digits=6, over_key="over", under_key="under",
        loc_prefix="_total",
        head={"team": team, "opp": opp, "total": float(total)})


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def summary_margin_dist(summary) -> Dist:
    """The margin Dist (team == side 0) of a ScoreSummary's histogram, the
    summary's fields tensors on any device or numpy."""
    from .parallel.aggregate import MARGIN_OFF

    mh = _host(summary.margin_hist).astype(float)
    return Dist.from_hist(mh, np.arange(len(mh)) - MARGIN_OFF)


def summary_total_dist(summary) -> Dist:
    """The combined-points Dist of a ScoreSummary's total histogram."""
    th = _host(summary.total_hist).astype(float)
    return Dist.from_hist(th, np.arange(len(th)))


def market_odds_from_summary(summary, team: str, opp: str, *,
                             spread: Optional[float] = None,
                             total: Optional[float] = None,
                             calibration: Optional[MarketCalibration] = None) -> Dict:
    """Spread and total markets from a ScoreSummary (team == side 0):
    {"spread": ..., "total": ...} for the lines given, after the opt-in
    `calibration`."""
    c = calibration or MarketCalibration()
    out: Dict = {}
    if spread is not None:
        out["spread"] = _spread_market(c.margin(summary_margin_dist(summary)),
                                       team, opp, spread)
    if total is not None:
        out["total"] = _total_market(c.total(summary_total_dist(summary)),
                                     team, opp, total)
    return out


def summary_moneyline(summary, team: str, opp: str,
                      calibration: Optional[MarketCalibration] = None) -> Dict:
    """Fair moneylines off a ScoreSummary's margin histogram: each side
    priced from P(its margin > 0), a tie counting for neither."""
    margins = summary_margin_dist(summary)
    if calibration is not None:
        margins = calibration.margin(margins)
    p_team, p_opp = margins.over(0.0), margins.under(0.0)
    return {
        "team": {"name": team, "p_win": round(p_team, 6),
                 "ml_fair": prob_to_american(p_team)},
        "opp": {"name": opp, "p_win": round(p_opp, 6),
                "ml_fair": prob_to_american(p_opp)},
    }


# ---- alternate lines, middles and the slate table ------------------------------------

def ladder_lines(center: float, width: float = 12.0, step: float = 1.0) -> np.ndarray:
    """The alternate-line grid around a quoted line, both ends and the
    quoted line itself included."""
    if step <= 0:
        raise ValueError(f"ladder step must be positive, got {step}")
    k = int(round(float(width) / float(step)))
    return float(center) + float(step) * np.arange(-k, k + 1)


def alt_spread_rows(margins: Dist, team: str, opp: str, spreads,
                    price: int = -110) -> List[dict]:
    """One row per alternate spread quoted from `team`'s side (cover iff
    margin > -spread): cover, not-cover and push probabilities, fair
    prices of both sides, and the better side's edge and EV were every
    row offered at `price`."""
    rows = []
    for s in np.asarray(spreads, dtype=float):
        p_c, p_n, p_p = margins.over(-s), margins.under(-s), margins.push(-s)
        rec = best_side_ev(p_c, price=price)
        bet = f"{team} {s:+g}" if rec["side"] == "Over" else f"{opp} {-s:+g}"
        rows.append({
            "spread": float(s),
            "p_cover": round(p_c, 6), "p_notcover": round(p_n, 6),
            "push_rate": round(p_p, 6),
            "fair_cover": prob_to_american(p_c),
            "fair_notcover": prob_to_american(p_n),
            "bet": bet, "edge_pct": round(rec["edge"] * 100, 2),
            "ev_$100": round(rec["ev"], 2),
        })
    return rows


def alt_total_rows(totals: Dist, lines, price: int = -110) -> List[dict]:
    """One row per alternate total: over, under and push probabilities,
    fair prices, and the better side at `price`."""
    rows = []
    for t in np.asarray(lines, dtype=float):
        p_o, p_u, p_p = totals.over(t), totals.under(t), totals.push(t)
        rec = best_side_ev(p_o, price=price)
        rows.append({
            "total": float(t),
            "p_over": round(p_o, 6), "p_under": round(p_u, 6),
            "push_rate": round(p_p, 6),
            "fair_over": prob_to_american(p_o),
            "fair_under": prob_to_american(p_u),
            "bet": f"{rec['side']} {t:g}",
            "edge_pct": round(rec["edge"] * 100, 2),
            "ev_$100": round(rec["ev"], 2),
        })
    return rows


def alt_spread_table(margins: Dist, team: str, opp: str, spreads, price: int = -110):
    """`alt_spread_rows` as a DataFrame."""
    import pandas as pd

    return pd.DataFrame(alt_spread_rows(margins, team, opp, spreads, price))


def alt_total_table(totals: Dist, lines, price: int = -110):
    """`alt_total_rows` as a DataFrame."""
    import pandas as pd

    return pd.DataFrame(alt_total_rows(totals, lines, price))


def alt_line_rows_from_summary(summary, team: str, opp: str, *,
                               spread: Optional[float] = None,
                               total: Optional[float] = None,
                               width: float = 12.0, step: float = 1.0, price: int = -110,
                               calibration: Optional[MarketCalibration] = None
                               ) -> Dict[str, List[dict]]:
    """Alternate spread and total ladders centred on the quoted lines, off a
    ScoreSummary's histograms (team == side 0), after the same opt-in
    `calibration` as `market_odds_from_summary`: {"spread": rows,
    "total": rows} for the lines given."""
    c = calibration or MarketCalibration()
    out: Dict[str, List[dict]] = {}
    if spread is not None:
        out["spread"] = alt_spread_rows(c.margin(summary_margin_dist(summary)), team, opp,
                                        ladder_lines(spread, width, step), price=price)
    if total is not None:
        out["total"] = alt_total_rows(c.total(summary_total_dist(summary)),
                                      ladder_lines(total, width, step), price=price)
    return out


def alt_lines_from_summary(summary, team: str, opp: str, **kw):
    """`alt_line_rows_from_summary` with each ladder a DataFrame."""
    import pandas as pd

    return {k: pd.DataFrame(v)
            for k, v in alt_line_rows_from_summary(summary, team, opp, **kw).items()}


def middle_odds(dist: Dist, low: float, high: float, *,
                price_low: int = -110, price_high: int = -110) -> Dict:
    """A middle: "over `low`" and "under `high`" tickets on one quantity
    (low < high).  Inside the window both win; outside it one does; a push
    at either line refunds that leg while the other wins.  EV stakes $100
    on each side."""
    low, high = float(low), float(high)
    if not low < high:
        raise ValueError(
            f"middle window is empty: need low < high, got [{low}, {high}]")
    p_push_low, p_push_high = dist.push(low), dist.push(high)
    p_mid = dist.over(low) - dist.over(high) - p_push_high
    p_over_only = dist.over(high)    # over the window: the low leg wins
    p_under_only = dist.under(low)   # under the window: the high leg wins

    def _profit(price: int) -> float:
        price = int(price)
        return 100 * (100 / (-price)) if price < 0 else float(price)

    w_lo, w_hi = _profit(price_low), _profit(price_high)
    ev = (p_mid * (w_lo + w_hi)
          + p_push_low * w_hi + p_push_high * w_lo
          + p_under_only * (w_hi - 100.0) + p_over_only * (w_lo - 100.0))
    return {
        "low": low, "high": high,
        "p_middle": round(p_mid, 6),
        "p_low_leg_only": round(p_over_only, 6),
        "p_high_leg_only": round(p_under_only, 6),
        "p_push_low": round(p_push_low, 6),
        "p_push_high": round(p_push_high, 6),
        "price_low": int(price_low), "price_high": int(price_high),
        "ev_$100_each": round(ev, 2),
    }


def spread_middle(margins: Dist, team: str, opp: str, line_team: float,
                  line_opp: float, *, price_team: int = -110,
                  price_opp: int = -110) -> Dict:
    """`team` at `line_team` (wins iff margin > -line_team) against `opp`
    at `line_opp` (wins iff margin < line_opp), on team's margin Dist."""
    res = middle_odds(margins, -float(line_team), float(line_opp),
                      price_low=price_team, price_high=price_opp)
    res["legs"] = [f"{team} {float(line_team):+g}", f"{opp} {float(line_opp):+g}"]
    return res


def total_middle(totals: Dist, over_line: float, under_line: float, *,
                 price_over: int = -110, price_under: int = -110) -> Dict:
    """An Over at `over_line` against an Under at `under_line`."""
    res = middle_odds(totals, float(over_line), float(under_line),
                      price_low=price_over, price_high=price_under)
    res["legs"] = [f"Over {float(over_line):g}", f"Under {float(under_line):g}"]
    return res


def middles_from_summary(summary, team: str, opp: str, *, mid_spread=None,
                         mid_total=None, price: int = -110) -> Dict[str, Dict]:
    """Middles off a ScoreSummary's histograms (team == side 0):
    `mid_spread` = (team's line, opp's line), `mid_total` = (over line,
    under line)."""
    out: Dict[str, Dict] = {}
    if mid_spread is not None:
        lt, lo = mid_spread
        out["spread"] = spread_middle(summary_margin_dist(summary), team, opp, lt, lo,
                                      price_team=price, price_opp=price)
    if mid_total is not None:
        ov, un = mid_total
        out["total"] = total_middle(summary_total_dist(summary), ov, un,
                                    price_over=price, price_under=price)
    return out


def _records(table) -> List[dict]:
    """Row dicts of a DataFrame (NaN where a row lacks a column) or of a
    list of dicts."""
    if table is None:
        return []
    return table.to_dict("records") if hasattr(table, "to_dict") else list(table)


def _given(v) -> bool:
    """Neither None nor NaN (pandas' notna on one value)."""
    return v is not None and not (isinstance(v, (float, np.floating)) and np.isnan(v))


def _line_rows(lines) -> Optional[List[dict]]:
    """`lines` (a list of row dicts, a dict of columns or a DataFrame) as
    row dicts."""
    if lines is None or hasattr(lines, "to_dict"):
        return None if lines is None else lines.to_dict("records")
    if isinstance(lines, dict):
        n = len(next(iter(lines.values()), ()))
        return [{k: v[i] for k, v in lines.items()} for i in range(n)]
    return [dict(r) for r in lines]


def slate_market_rows(games, summaries, lines=None, price: int = -110) -> List[dict]:
    """A slate's game markets in one pass, one row per game: fair
    moneylines and, where `lines` quotes them, spread and total
    probabilities, fair prices and the better side's edge and EV at
    `price`, all off the per-game ScoreSummary histograms
    (`SlateRunner.run_summary_rows`, `api.simulate_slate_summary_rows`).

    `lines` holds `spread` (team A's side) and `total` quotes, as a list of
    row dicts, a dict of columns or a DataFrame.  Where any row has a
    `team_a`, a game takes the first row whose normalized `team_a` is its
    team A's (none: unpriced); otherwise row gi prices game gi."""
    rows_in = _line_rows(lines)
    by_name = rows_in is not None and any("team_a" in r for r in rows_in)

    def _line_for(gi: int, ta: str):
        if rows_in is None:
            return None, None
        if by_name:
            r = next((r for r in rows_in if _given(r.get("team_a"))
                      and _norm_team(str(r["team_a"])) == _norm_team(ta)), None)
        else:
            r = rows_in[gi] if gi < len(rows_in) else None
        if r is None:
            return None, None
        sp, tt = r.get("spread"), r.get("total")
        return (float(sp) if _given(sp) else None, float(tt) if _given(tt) else None)

    rows = []
    for gi, ((a, b), s) in enumerate(zip(games, summaries)):
        ta, tb = getattr(a, "name", a), getattr(b, "name", b)
        sp, tt = _line_for(gi, ta)
        ml = summary_moneyline(s, ta, tb)
        row = {"team_a": ta, "team_b": tb, "n": int(np.asarray(_host(s.n))),
               "p_win_a": ml["team"]["p_win"], "p_win_b": ml["opp"]["p_win"],
               "ml_fair_a": ml["team"]["ml_fair"], "ml_fair_b": ml["opp"]["ml_fair"]}
        mk = market_odds_from_summary(s, ta, tb, spread=sp, total=tt)
        if sp is not None:
            m = mk["spread"]
            rec = best_side_ev(m["p_cover"], price=price)
            row.update({
                "spread": sp, "p_cover_a": m["p_cover"],
                "fair_cover_a": m["american_cover"], "mean_margin_a": m["mean_margin"],
                "spread_bet": (f"{ta} {sp:+g}" if rec["side"] == "Over"
                               else f"{tb} {-sp:+g}"),
                "spread_edge_pct": round(rec["edge"] * 100, 2),
                "spread_ev_$100": round(rec["ev"], 2),
            })
        if tt is not None:
            t = mk["total"]
            rec = best_side_ev(t["p_over"], price=price)
            row.update({
                "total": tt, "p_over": t["p_over"], "fair_over": t["american_over"],
                "mean_total": t["mean_total"], "total_bet": f"{rec['side']} {tt:g}",
                "total_edge_pct": round(rec["edge"] * 100, 2),
                "total_ev_$100": round(rec["ev"], 2),
            })
        rows.append(row)
    return rows


def slate_market_table(games, summaries, lines=None, price: int = -110):
    """`slate_market_rows` as a DataFrame."""
    import pandas as pd

    return pd.DataFrame(slate_market_rows(games, summaries, lines, price))


# ---- the markets over saved sim files -------------------------------------------------
#
# `sim --save` writes scores_<base> (team, opp, pts, opp_pts) and players_<base>
# (PLAYER_COLS) as CSV or parquet.  The cores read them as columns
# (`data.columns`: CSV with `csv`, parquet through pandas imported there) and
# price them through the same Dist core; `sims=`/`players_df=` take a
# DataFrame or a dict of columns.

# the players table's columns that `load_players_table` coerces to numbers
_PLAYER_NUMERIC = ("pass_yds", "rush_yds", "rec_yds", "pass_td", "rush_td", "rec_td",
                   "tgt", "rec", "pass_att", "pass_comp", "sacks")
# the saved-file prop scan's columns (`scan_props_for_matchup`)
SAVED_SCAN_COLS = ("team", "player", "stat", "line", "best_side", "p_over", "p_under",
                   "edge_pct", "ev_$100", "mean", "median", "samples")


def infer_role_from_stat(stat: str) -> str:
    stat = stat.lower()
    if stat.startswith("pass_"):
        return "QB"
    if stat.startswith("rush_"):
        return "Rusher"
    return "Receiver"


def find_saved_files(csv_base: Optional[str] = None, team_a: Optional[str] = None,
                     team_b: Optional[str] = None, directory: str = "."
                     ) -> Tuple[Path, Optional[Path]]:
    """(scores path, players path or None) of a saved run: `csv_base`'s
    files (`.parquet` before `.csv`), or the first of the sorted
    `scores_*.csv`, then the sorted `scores_*.parquet`, whose name holds
    both normalized team names."""
    d = Path(directory)

    def _maybe(stem: str) -> Optional[Path]:
        for ext in (".parquet", ".csv"):
            p = d / f"{stem}{ext}"
            if p.exists():
                return p
        return None

    if csv_base:
        stem = csv_base
        for suffix in (".csv", ".parquet"):
            if stem.endswith(suffix):
                stem = stem[: -len(suffix)]
        scores = _maybe(f"scores_{csv_base}") or _maybe(f"scores_{stem}")
        if scores is None:
            raise FileNotFoundError(f"Could not find scores_{csv_base} (.csv/.parquet)")
        players = _maybe(f"players_{csv_base}") or _maybe(f"players_{stem}")
        return scores, players

    if team_a is None:
        raise ValueError("Provide csv_base or team names for fuzzy search.")
    na = _norm_team(team_a)
    nb = _norm_team(team_b) if team_b else ""
    for p in sorted(d.glob("scores_*.csv")) + sorted(d.glob("scores_*.parquet")):
        low = p.name.lower()
        if na in low and nb in low:
            stem = p.name.rsplit(".", 1)[0]
            return p, _maybe(stem.replace("scores_", "players_"))
    raise FileNotFoundError("No matching scores_* file for those teams.")


def read_table_columns(path) -> Columns:
    """A saved table as columns: parquet through pandas (imported here; a
    host without pandas raises ModuleNotFoundError), else the CSV typed as
    pandas' reader types it."""
    if str(path).lower().endswith(".parquet"):
        import pandas as pd

        return columns_of(pd.read_parquet(path))
    return read_csv_columns(path)


def load_table(path):
    """`read_table_columns` as a DataFrame."""
    return frame(read_table_columns(path))


def load_players_columns(players_path) -> Columns:
    """A players table as columns, the reference's packed layout (columns
    named 0, 1, ..., each cell a dict's text) unpacked into one row per
    dict, the stat columns coerced to numbers (junk NaN), and team_low and
    player_low added."""
    cols = read_table_columns(players_path)
    if cols and all(str(c).isdigit() for c in cols):
        rows = []
        for col in cols.values():
            for v in col:
                if is_na(v):
                    continue
                try:
                    d = ast.literal_eval(v)
                except (ValueError, TypeError, SyntaxError, MemoryError, RecursionError):
                    continue
                if isinstance(d, dict):
                    rows.append(d)
        if rows:
            cols = columns_from_records(rows)
    cols = {str(c): v for c, v in cols.items()}
    for c in _PLAYER_NUMERIC:
        if c in cols:
            cols[c] = to_numeric(cols[c])
    cols["team_low"] = lowered(cols["team"])
    cols["player_low"] = lowered(cols["player"])
    return cols


def load_players_table(players_path):
    """`load_players_columns` as a DataFrame."""
    return frame(load_players_columns(players_path))


def _players_for(csv_base: Optional[str], team: str, directory: str) -> Columns:
    _, players_path = find_saved_files(csv_base, team_a=team, directory=directory)
    if players_path is None or not players_path.exists():
        raise FileNotFoundError(
            "no players_* file to scan props from — rerun the sim with "
            "collect_players=True")
    return load_players_columns(players_path)


def _player_stat_dist(csv_base: Optional[str], team: str, player: str, stat: str, *,
                      role: Optional[str] = None, directory: str = ".", players_df=None):
    """(Dist, stat column, role) of one player's simulated stat in a players
    table (`players_df`, a DataFrame or columns, or the saved file)."""
    cols = (_players_for(csv_base, team, directory) if players_df is None
            else columns_of(players_df))
    stat_col = STAT_ALIASES.get(stat, stat)
    if stat_col not in cols:
        raise ValueError(
            f"players table has no '{stat_col}' column (requested stat {stat!r})")
    role = role or infer_role_from_stat(stat_col)
    if "team_low" not in cols:
        cols = {**cols, "team_low": lowered(cols["team"]),
                "player_low": lowered(cols["player"])}
    mask = ((np.asarray(cols["team_low"], dtype=object) == team.lower())
            & (np.asarray(cols["player_low"], dtype=object) == player.lower())
            & (np.asarray(cols["role"], dtype=object) == role))
    if not mask.any():
        raise ValueError(f"{player} ({role}) never appears for {team} in the players table")
    samples = to_numeric(cols[stat_col][mask]).astype(float)
    samples = samples[~np.isnan(samples)]
    if samples.size == 0:
        raise ValueError(f"{player}'s {stat_col} column holds no numeric samples")
    return Dist.from_values(samples), stat_col, role


def player_prop_odds(csv_base: Optional[str], team: str, player: str, stat: str,
                     line: float, *, role: Optional[str] = None, directory: str = ".",
                     players_df=None) -> Dict:
    """One player prop priced off the saved (or given) player samples."""
    d, stat_col, role = _player_stat_dist(
        csv_base, team, player, stat, role=role, directory=directory,
        players_df=players_df)
    market = _ou_market(
        d, float(line), digits=4, over_key="over", under_key="under", loc_prefix="",
        head={"team": team, "player": player, "role": role, "stat": stat_col,
              "line": float(line)})
    pick = best_side_ev(d.over(line), price=-110)
    market.update({
        "p75": d.pct(75), "p90": d.pct(90),
        "best_side": pick["side"], "edge": round(pick["edge"] * 100, 2),
        "ev_per_$100": round(pick["ev"], 2),
    })
    order = ["team", "player", "role", "stat", "line", "samples",
             "p_over", "p_under", "push_rate", "american_over",
             "american_under", "mean", "median", "p75", "p90",
             "best_side", "edge", "ev_per_$100"]
    return {k: market[k] for k in order}


def _team_rows(sims, team: str, opp: str) -> Columns:
    """The rows of a scores table from `team`'s side against `opp`."""
    cols = columns_of(sims)
    return take(cols, (lowered(cols["team"]) == team.lower())
                & (lowered(cols["opp"]) == opp.lower()))


def _margin_dist(sims, team: str, opp: str) -> Optional[Dist]:
    rows = _team_rows(sims, team, opp)
    if not len(rows["pts"]):
        return None
    return Dist.from_values(rows["pts"] - rows["opp_pts"])


def _saved_scores(csv_base: Optional[str], team: str, opp: str, directory: str) -> Columns:
    scores_path, _ = find_saved_files(csv_base, team_a=team, team_b=opp, directory=directory)
    return read_table_columns(scores_path)


def moneyline_from_sims(csv_base: Optional[str], team: str, opp: str,
                        directory: str = ".", sims=None) -> Dict:
    """Fair moneylines from saved (or given) scores: each side's P(margin >
    0) from its own rows, or one minus the other's where a side has none."""
    if sims is None:
        sims = _saved_scores(csv_base, team, opp, directory)
    dists = (_margin_dist(sims, team, opp), _margin_dist(sims, opp, team))
    p_team, p_opp = (float("nan") if d is None else d.over(0.0) for d in dists)
    if not np.isfinite(p_team) and np.isfinite(p_opp):
        p_team = min(max(1.0 - p_opp, 0.0), 1.0)
    if not np.isfinite(p_opp) and np.isfinite(p_team):
        p_opp = min(max(1.0 - p_team, 0.0), 1.0)
    return {
        "team": {"name": team, "p_win": round(p_team, 6),
                 "ml_fair": prob_to_american(p_team)},
        "opp": {"name": opp, "p_win": round(p_opp, 6),
                "ml_fair": prob_to_american(p_opp)},
    }


def _sims_dists(sims, team: str, opp: str) -> Tuple[Dist, Dist]:
    """(margin Dist, total Dist) of `team`'s rows against `opp`."""
    rows = _team_rows(sims, team, opp)
    if not len(rows["pts"]):
        raise ValueError(f"scores data holds no rows from {team}'s perspective vs {opp}")
    return (Dist.from_values(rows["pts"] - rows["opp_pts"]),
            Dist.from_values(rows["pts"] + rows["opp_pts"]))


def game_market_odds(csv_base: Optional[str], team: str, opp: str, *,
                     spread: Optional[float] = None, total: Optional[float] = None,
                     directory: str = ".", sims=None) -> Dict:
    """Spread cover and total over/under from saved (or given) scores, from
    `team`'s rows against `opp`."""
    if sims is None:
        sims = _saved_scores(csv_base, team, opp, directory)
    margins, totals = _sims_dists(sims, team, opp)
    out: Dict = {}
    if spread is not None:
        out["spread"] = _spread_market(margins, team, opp, spread)
    if total is not None:
        out["total"] = _total_market(totals, team, opp, total)
    if not out:
        raise ValueError("nothing to price: pass spread= and/or total=")
    return out


def _saved_scan(csv_base: Optional[str], team_a: str, team_b: str, prop_sheet_path: str,
                directory: str, min_abs_edge_pct: float,
                players_df) -> Tuple[List[int], List[dict], bool]:
    """(positions among the priced rows, rows kept, whether any priced) of
    a prop-sheet scan over saved player samples, sorted by |edge| then EV,
    both descending, ties in sheet order.

    A row that cannot be priced is skipped: a player, stat column or line
    that does not resolve (ValueError, KeyError), no players file
    (FileNotFoundError), a team or player cell that is not text.  The JAX
    package skips a row on any exception (its edge.py:486); anything else
    raises here."""
    sheet = read_csv_columns(prop_sheet_path)
    teams = {team_a.lower(), team_b.lower()}
    keep = [r for r, low in zip(records_of(sheet), lowered(sheet["team"])) if low in teams]
    if players_df is not None:
        players_df = columns_of(players_df)
    cache: Dict[Path, Columns] = {}
    results = []
    for r in keep:
        stat_col = STAT_ALIASES.get(str(r["stat"]), str(r["stat"]))
        try:
            if not isinstance(r["team"], str) or not isinstance(r["player"], str):
                continue
            players = players_df
            if players is None:
                _, path = find_saved_files(csv_base, team_a=r["team"], directory=directory)
                if path is None or not path.exists():
                    continue
                if path not in cache:
                    cache[path] = load_players_columns(path)
                players = cache[path]
            line = float(r["yards"])
            out = player_prop_odds(csv_base, r["team"], r["player"], stat_col, line,
                                   directory=directory, players_df=players)
        except (ValueError, KeyError, FileNotFoundError):
            continue
        results.append({
            "team": r["team"], "player": r["player"], "stat": stat_col,
            "line": line, "best_side": out["best_side"],
            "p_over": out["p_over"], "p_under": out["p_under"],
            "edge_pct": out["edge"], "ev_$100": out["ev_per_$100"],
            "mean": out["mean"], "median": out["median"],
            "samples": out["samples"],
        })
    order = sorted(range(len(results)),
                   key=lambda i: (-abs(results[i]["edge_pct"]), -results[i]["ev_$100"]))
    kept = [i for i in order if abs(results[i]["edge_pct"]) >= min_abs_edge_pct]
    return kept, [results[i] for i in kept], bool(results)


def scan_props_for_matchup_rows(csv_base: Optional[str], team_a: str, team_b: str,
                                prop_sheet_path: str, directory: str = ".",
                                min_abs_edge_pct: float = 2.0,
                                players_df=None) -> List[dict]:
    """A prop sheet's rows for either team priced off saved player samples,
    as row dicts (SAVED_SCAN_COLS), best |edge| first, those under
    `min_abs_edge_pct` dropped."""
    return _saved_scan(csv_base, team_a, team_b, prop_sheet_path, directory,
                       min_abs_edge_pct, players_df)[1]


def scan_props_for_matchup(csv_base: Optional[str], team_a: str, team_b: str,
                           prop_sheet_path: str, directory: str = ".",
                           min_abs_edge_pct: float = 2.0, players_df=None):
    """`scan_props_for_matchup_rows` as a DataFrame indexed by the rows'
    positions among those priced (empty, with no columns, if none was)."""
    import pandas as pd

    index, rows, any_priced = _saved_scan(csv_base, team_a, team_b, prop_sheet_path,
                                          directory, min_abs_edge_pct, players_df)
    if not any_priced:
        return pd.DataFrame()
    return pd.DataFrame(rows, index=index, columns=list(SAVED_SCAN_COLS))


def alt_prop_rows(dist: Dist, lines, price: int = -110) -> List[dict]:
    """One row per alternate prop line off a player's stat Dist: over,
    under and push probabilities, fair prices, and the better side at
    `price`."""
    rows = []
    for ln in np.asarray(lines, dtype=float):
        p_o, p_u, p_p = dist.over(ln), dist.under(ln), dist.push(ln)
        rec = best_side_ev(p_o, price=price)
        rows.append({
            "line": float(ln),
            "p_over": round(p_o, 6), "p_under": round(p_u, 6),
            "push_rate": round(p_p, 6),
            "fair_over": prob_to_american(p_o),
            "fair_under": prob_to_american(p_u),
            "bet": f"{rec['side']} {ln:g}",
            "edge_pct": round(rec["edge"] * 100, 2),
            "ev_$100": round(rec["ev"], 2),
        })
    return rows


def alt_prop_table(dist: Dist, lines, price: int = -110):
    """`alt_prop_rows` as a DataFrame."""
    return frame(columns_from_records(alt_prop_rows(dist, lines, price)))


def _prop_ladder_grid(stat_col: str):
    """Default (width, step) of a prop ladder: yardage in 5s over +-30,
    count stats in halves over +-2.5."""
    if "yds" in stat_col or "yards" in stat_col:
        return 30.0, 5.0
    return 2.5, 0.5


def player_prop_ladder_rows(csv_base: Optional[str], team: str, player: str, stat: str,
                            line: float, *, role: Optional[str] = None,
                            directory: str = ".", players_df=None,
                            width: Optional[float] = None, step: Optional[float] = None,
                            price: int = -110) -> List[dict]:
    """The alternate-line ladder of one player prop around its quoted line,
    off the samples `player_prop_odds` prices: rows of team, player, stat
    and `alt_prop_rows`' columns."""
    d, stat_col, role = _player_stat_dist(
        csv_base, team, player, stat, role=role, directory=directory,
        players_df=players_df)
    dflt_w, dflt_s = _prop_ladder_grid(stat_col)
    rows = alt_prop_rows(d, ladder_lines(line, dflt_w if width is None else width,
                                         dflt_s if step is None else step), price=price)
    return [{"team": team, "player": player, "stat": stat_col, **r} for r in rows]


def player_prop_ladder(csv_base: Optional[str], team: str, player: str, stat: str,
                       line: float, **kw):
    """`player_prop_ladder_rows` as a DataFrame."""
    return frame(columns_from_records(
        player_prop_ladder_rows(csv_base, team, player, stat, line, **kw)))


def alt_line_rows_from_sims(sims, team: str, opp: str, *, spread: Optional[float] = None,
                            total: Optional[float] = None, width: float = 12.0,
                            step: float = 1.0, price: int = -110) -> Dict[str, List[dict]]:
    """Alternate spread and total ladders from a scores table (the file
    path's twin of `alt_line_rows_from_summary`)."""
    margins, totals = _sims_dists(sims, team, opp)
    out: Dict[str, List[dict]] = {}
    if spread is not None:
        out["spread"] = alt_spread_rows(margins, team, opp,
                                        ladder_lines(spread, width, step), price=price)
    if total is not None:
        out["total"] = alt_total_rows(totals, ladder_lines(total, width, step), price=price)
    return out


def alt_lines_from_sims(sims, team: str, opp: str, **kw):
    """`alt_line_rows_from_sims` with each ladder a DataFrame."""
    return {k: frame(columns_from_records(v))
            for k, v in alt_line_rows_from_sims(sims, team, opp, **kw).items()}


def middles_from_sims(sims, team: str, opp: str, *, mid_spread=None, mid_total=None,
                      price: int = -110) -> Dict[str, Dict]:
    """Middles from a scores table (the file path's twin of
    `middles_from_summary`)."""
    margins, totals = _sims_dists(sims, team, opp)
    out: Dict[str, Dict] = {}
    if mid_spread is not None:
        lt, lo = mid_spread
        out["spread"] = spread_middle(margins, team, opp, lt, lo,
                                      price_team=price, price_opp=price)
    if mid_total is not None:
        ov, un = mid_total
        out["total"] = total_middle(totals, ov, un, price_over=price, price_under=price)
    return out


# ---- same-game parlays, round robins, season win totals ---------------------------
#
# Every leg settles on the same simulated game, so a multi-leg ticket is
# priced from the joint per-game sample: one reduction over the game axis on
# the device of the scores, its integer counts copied to the host in one
# transfer, every probability derived from them on the host in the JAX
# package's order (so the result dicts are equal, not merely close).

_SRC_MARGIN, _SRC_TOTAL, _SRC_PSTAT = 0, 1, 2


def resolve_parlay_legs(team_a_ctx, team_b_ctx, legs):
    """Validate and encode same-game-parlay legs for one matchup.

    Each leg is a dict: {"kind": "spread", "team", "line"} (wins iff the
    team's margin > -line, push at equality); {"kind": "moneyline", "team"}
    (margin > 0, a tie pushes); {"kind": "total", "side": "over"|"under",
    "line"}; {"kind": "prop", "team", "player", "stat", "side", "line"}
    (stat names take the prop sheet's aliases).

    Returns (arrays, meta): arrays = (src, side, role, slot, col) int32 and
    (sgn, drn, thr) f32 numpy arrays, one entry per leg; meta the legs'
    kinds and labels.  An unresolvable leg raises ValueError: a parlay with
    a leg dropped would price another ticket.  Legs that are not props
    carry 0 in side/role/slot/col, so they read pstats cell 0 of any
    layout (the 1-element dummy of a run without player stats too)."""
    sides = {_norm_team(team_a_ctx.name): (0, team_a_ctx, 1.0),
             _norm_team(team_b_ctx.name): (1, team_b_ctx, -1.0)}

    def _side(leg):
        key = _norm_team(str(leg["team"]))
        if key not in sides:
            raise ValueError(
                f"parlay leg team {leg['team']!r} is not in this matchup "
                f"({team_a_ctx.name} vs {team_b_ctx.name})")
        return sides[key]

    def _drn(leg):
        side = str(leg.get("side", "")).strip().lower()
        if side not in ("over", "under"):
            raise ValueError(
                f"parlay {leg.get('kind')} leg needs side 'over' or "
                f"'under', got {leg.get('side')!r}")
        return 1.0 if side == "over" else -1.0

    rows, meta = [], []
    for leg in legs:
        if not isinstance(leg, dict):
            raise ValueError(
                f"each parlay leg must be an object/dict, got "
                f"{type(leg).__name__}: {leg!r}")
        kind = str(leg.get("kind", "")).strip().lower()
        if kind == "spread":
            _, tc, sgn = _side(leg)
            line = float(leg["line"])
            rows.append((_SRC_MARGIN, 0, 0, 0, 0, sgn, 1.0, -line))
            meta.append({"kind": kind, "label": f"{tc.name} {line:+g}"})
        elif kind == "moneyline":
            _, tc, sgn = _side(leg)
            rows.append((_SRC_MARGIN, 0, 0, 0, 0, sgn, 1.0, 0.0))
            meta.append({"kind": kind, "label": f"{tc.name} ML"})
        elif kind == "total":
            drn = _drn(leg)
            line = float(leg["line"])
            rows.append((_SRC_TOTAL, 0, 0, 0, 0, 1.0, drn, line))
            meta.append({"kind": kind, "label": f"{leg['side'].title()} {line:g}"})
        elif kind == "prop":
            side_i, tc, _ = _side(leg)
            role, slot, col, stat_col = _resolve_stat_target(
                tc, leg["player"], leg["stat"], strict=True)
            drn = _drn(leg)
            line = float(leg["line"])
            rows.append((_SRC_PSTAT, side_i, role, slot, col, 1.0, drn, line))
            meta.append({"kind": kind,
                         "label": (f"{leg['player']} {leg['side'].title()} "
                                   f"{line:g} {stat_col}")})
        else:
            raise ValueError(
                f"unknown parlay leg kind {leg.get('kind')!r} (want "
                "spread | moneyline | total | prop)")
    if not rows:
        raise ValueError("parlay needs at least one leg")
    arr = np.asarray(rows, dtype=np.float32)
    ints = tuple(arr[:, j].astype(np.int32) for j in range(5))
    return ints + (arr[:, 5], arr[:, 6], arr[:, 7]), meta


def _settle_legs(score: torch.Tensor, pstats: torch.Tensor, arrays):
    """Per-game (B, L) win and push masks of resolved legs, on the device of
    `score`: the settlement rule that the parlay, correlation and round-robin
    reductions share.  As in the JAX package, in float32: the margin (team
    A's view) times the leg's sign, the total, or the player's stat, against
    the line, `v > thr` (over) or `v < thr`, a push at |v - thr| <= 1e-9."""
    dev = score.device
    src = torch.as_tensor(np.asarray(arrays[0]), device=dev)
    side, role, slot, col = (torch.as_tensor(np.asarray(a), device=dev).long()
                             for a in arrays[1:5])
    sgn, drn, thr = (torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)
                     for a in arrays[5:8])
    margin = (score[:, 0] - score[:, 1]).to(torch.float32)
    total = score.sum(dim=1).to(torch.float32)
    pv = pstats[:, side, role, slot, col]                          # (B, L)
    game = torch.where(src == _SRC_MARGIN, margin[:, None] * sgn, total[:, None])
    v = torch.where(src == _SRC_PSTAT, pv, game)
    win = torch.where(drn > 0, v > thr, v < thr)
    push = (v - thr).abs() <= 1e-9
    return win, push


def _host_counts(red: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Integer reductions as numpy, by one device-to-host copy of all of
    them packed into one int64 tensor."""
    flat = torch.cat([v.reshape(-1).to(torch.int64) for v in red.values()]).cpu().numpy()
    out, i = {}, 0
    for k, v in red.items():
        out[k] = flat[i:i + v.numel()].reshape(tuple(v.shape))
        i += v.numel()
    return out


def reduce_parlay_device(score: torch.Tensor, pstats: torch.Tensor, arrays) -> Dict:
    """A parlay's counts over the games, on the device of `score`: per leg
    its wins and pushes (leg_win, leg_push, (L,)), and the games where every
    leg won (all_win), none lost (no_lose) and every leg pushed (all_push)."""
    win, push = _settle_legs(score, pstats, arrays)
    lose = ~(win | push)
    return {"leg_win": win.sum(dim=0), "leg_push": push.sum(dim=0),
            "all_win": win.all(dim=1).sum(), "no_lose": (~lose.any(dim=1)).sum(),
            "all_push": push.all(dim=1).sum()}


def _need_player_stats(meta, pstats) -> None:
    if any(m["kind"] == "prop" for m in meta) and (
            pstats.ndim != 5 or pstats.shape[1] != 2):
        raise ValueError(
            "prop parlay legs need per-player stats: run with "
            "collect_players=True")


def parlay_odds(out, team_a_ctx, team_b_ctx, legs,
                price: Optional[int] = None, *, resolved=None) -> Dict:
    """Price a same-game parlay off the joint per-game sample of `out` (a
    GameState from `MatchupRunner.run_pairs`).

    Book rules per simulated game: the ticket loses iff a leg loses, pushed
    legs are voided (the parlay reduces), every leg pushed refunds.  Both a
    full void and a reduced win count as stake back: the fair probability
    `p_parlay` is P(all win) / (P(all win) + P(lose)), and the quoted-price
    edge, EV and Kelly use the same convention.  `correlation_mult` is
    P(all win) over the product of the legs' own win rates.  Prop legs
    settle unconditionally (a game where the player recorded nothing counts
    at 0).  `resolved` takes a `resolve_parlay_legs` result, so callers that
    validate legs before simulating do not resolve twice."""
    arrays, meta = resolved if resolved is not None else \
        resolve_parlay_legs(team_a_ctx, team_b_ctx, legs)
    _need_player_stats(meta, out.pstats)
    red = _host_counts(reduce_parlay_device(out.score, out.pstats, arrays))
    n = float(out.score.shape[0])

    p_all_win = float(red["all_win"]) / n
    p_no_lose = float(red["no_lose"]) / n
    p_void = float(red["all_push"]) / n
    p_win_reduced = p_no_lose - p_all_win - p_void
    p_parlay = p_all_win / max(p_all_win + (1.0 - p_no_lose), 1e-12)
    leg_p = [float(w) / n for w in red["leg_win"]]
    p_independent = float(np.prod(leg_p))
    res: Dict = {
        "team": team_a_ctx.name, "opp": team_b_ctx.name, "n": int(n),
        "legs": [{**m, "p_win": round(p, 6), "p_push": round(float(q) / n, 6)}
                 for m, p, q in zip(meta, leg_p, red["leg_push"])],
        "p_all_win": round(p_all_win, 6),
        "p_lose": round(1.0 - p_no_lose, 6),
        "p_void": round(p_void, 6),
        "p_win_reduced": round(p_win_reduced, 6),
        "p_parlay": round(p_parlay, 6),
        "fair_american": prob_to_american(p_parlay),
        "p_independent": round(p_independent, 6),
        "fair_american_independent": prob_to_american(p_independent),
        "correlation_mult": (round(p_all_win / p_independent, 4)
                             if p_independent > 0 else float("nan")),
    }
    if price is not None:
        res.update(_priced_block(p_all_win, p_no_lose, p_parlay, price))
    return res


def _priced_block(p_all_win: float, p_no_lose: float, p_parlay: float,
                  price: int) -> Dict:
    """Quoted-price metrics of a ticket (refund semantics: full voids and
    reduced wins return the stake)."""
    price = int(price)
    profit = 100 * (100 / (-price)) if price < 0 else price
    ev = p_all_win * profit - (1.0 - p_no_lose) * 100.0
    return {
        "price": price,
        "edge_pct": round((p_parlay - american_implied_prob(price)) * 100, 2),
        "ev_$100": round(ev, 2),
        "kelly": round(kelly_fraction(
            p_all_win, price, p_push=max(0.0, p_no_lose - p_all_win)), 4),
    }


def leg_corr_device(score: torch.Tensor, pstats: torch.Tensor, arrays) -> torch.Tensor:
    """(L, L) Pearson correlations of the legs' win indicators (a push is
    not a win) over the games, float32 on the device of `score`; NaN where
    a leg's variance is 0 (it always or never wins).  w.T @ w sums 0/1
    values: exact in float32 (and in TF32, whose inputs hold 0 and 1
    exactly) below 2^24 games."""
    win, _ = _settle_legs(score, pstats, arrays)
    w = win.to(torch.float32)
    b = w.shape[0]
    mu = w.mean(dim=0)
    cov = w.T @ w / b - mu[:, None] * mu[None, :]
    sd = torch.sqrt(torch.clamp_min(torch.diagonal(cov), 0.0))
    denom = sd[:, None] * sd[None, :]
    return torch.where(denom > 0, cov / torch.clamp_min(denom, 1e-30), torch.nan)


def parlay_correlation_matrix(out, team_a_ctx, team_b_ctx, legs, *,
                              resolved=None) -> Tuple[List[str], np.ndarray]:
    """(leg labels, (L, L) float64 numpy) pairwise correlations of the legs'
    win indicators over the same games as `parlay_odds`: positive pairs
    price above their independence product, negative ones below."""
    arrays, meta = resolved if resolved is not None else \
        resolve_parlay_legs(team_a_ctx, team_b_ctx, legs)
    _need_player_stats(meta, out.pstats)
    corr = leg_corr_device(out.score, out.pstats, arrays).cpu().numpy()
    return [m["label"] for m in meta], np.asarray(corr, dtype=float)


def parlay_correlations(out, team_a_ctx, team_b_ctx, legs, *, resolved=None):
    """`parlay_correlation_matrix` as a DataFrame indexed by leg label."""
    import pandas as pd

    labels, corr = parlay_correlation_matrix(out, team_a_ctx, team_b_ctx, legs,
                                             resolved=resolved)
    return pd.DataFrame(corr, index=labels, columns=labels)


def tease_legs(legs, points: float):
    """Teaser legs: each spread and total leg moved `points` in the
    bettor's favor (spreads gain points, Over totals drop, Under totals
    rise), as new leg dicts for `parlay_odds` or per-game blocks and
    `cross_game_parlay`.  Moneyline and prop legs are refused."""
    points = float(points)
    if points < 0:
        raise ValueError(f"teaser points must be >= 0, got {points}")
    out = []
    for leg in legs:
        if not isinstance(leg, dict):
            raise ValueError(
                f"each teaser leg must be an object/dict, got "
                f"{type(leg).__name__}: {leg!r}")
        kind = str(leg.get("kind", "")).strip().lower()
        if kind == "spread":
            out.append({**leg, "line": float(leg["line"]) + points})
        elif kind == "total":
            side = str(leg.get("side", "")).strip().lower()
            if side not in ("over", "under"):
                raise ValueError(
                    f"teaser total leg needs side 'over' or 'under', got "
                    f"{leg.get('side')!r}")
            shift = -points if side == "over" else points
            out.append({**leg, "line": float(leg["line"]) + shift})
        else:
            raise ValueError(
                f"teasers take spread/total legs only, got kind "
                f"{leg.get('kind')!r}")
    return out


def cross_game_parlay(blocks, price: Optional[int] = None) -> Dict:
    """One ticket over per-game parlay blocks (`parlay_odds` results of
    distinct matchups).  Distinct games are independent simulations, so the
    settlement probabilities multiply exactly; `correlation_mult` is the
    product of the blocks' own."""
    if not blocks:
        raise ValueError("cross-game parlay needs at least one block")
    seen = set()
    for blk in blocks:
        g = (_norm_team(blk["team"]), _norm_team(blk["opp"]))
        if g in seen or g[::-1] in seen:
            raise ValueError(
                f"two blocks price the same game {blk['team']} vs "
                f"{blk['opp']}: merge their legs into ONE same-game block "
                "(blocks multiply as independent, same-game legs are not)")
        seen.add(g)
    p_all_win = float(np.prod([b["p_all_win"] for b in blocks]))
    p_no_lose = float(np.prod([1.0 - b["p_lose"] for b in blocks]))
    p_void = float(np.prod([b["p_void"] for b in blocks]))
    p_independent = float(np.prod([b["p_independent"] for b in blocks]))
    p_parlay = p_all_win / max(p_all_win + (1.0 - p_no_lose), 1e-12)
    res: Dict = {
        "games": [f"{b['team']} vs {b['opp']}" for b in blocks],
        "legs": [{**leg, "game": f"{b['team']} vs {b['opp']}"}
                 for b in blocks for leg in b["legs"]],
        "p_all_win": round(p_all_win, 6),
        "p_lose": round(1.0 - p_no_lose, 6),
        "p_void": round(p_void, 6),
        "p_win_reduced": round(max(0.0, p_no_lose - p_all_win - p_void), 6),
        "p_parlay": round(p_parlay, 6),
        "fair_american": prob_to_american(p_parlay),
        "p_independent": round(p_independent, 6),
        "fair_american_independent": prob_to_american(p_independent),
        "correlation_mult": (round(p_all_win / p_independent, 4)
                             if p_independent > 0 else float("nan")),
    }
    if price is not None:
        res.update(_priced_block(p_all_win, p_no_lose, p_parlay, price))
    return res


def reduce_round_robin_device(score: torch.Tensor, pstats: torch.Tensor, mask: np.ndarray,
                              kvec: np.ndarray, arrays) -> Dict:
    """A round robin's counts over the games, on the device of `score`:
    per ticket (rows of the (S, L) bool `mask`, `kvec` legs each) the games
    it won whole (all_win), lost none of (no_lose) and pushed whole
    (all_push), and the games where some ticket / every ticket won whole.
    A ticket's member counts are one (B, L) @ (L, S) float32 product per
    outcome, thresholded at k - 0.5 as in the JAX package: sums of at most
    L zeros and ones, exact in float32 and in TF32."""
    dev = score.device
    win, push = _settle_legs(score, pstats, arrays)
    lose = ~(win | push)
    m = torch.as_tensor(np.asarray(mask), device=dev).to(torch.float32).T   # (L, S)
    full = torch.as_tensor(np.asarray(kvec), dtype=torch.float32, device=dev) - 0.5
    cw = win.to(torch.float32) @ m
    cl = lose.to(torch.float32) @ m
    cp = push.to(torch.float32) @ m
    tick_win = cw > full
    return {"all_win": tick_win.sum(dim=0), "no_lose": (cl < 0.5).sum(dim=0),
            "all_push": (cp > full).sum(dim=0), "any_win": tick_win.any(dim=1).sum(),
            "every_win": tick_win.all(dim=1).sum()}


def _rr_sizes(by, n_legs: int) -> List[int]:
    """A round-robin size spec (an int or an iterable of ints) as sorted
    sizes, each checked against the leg count.  bool and np.bool_, str and
    bytes, and fractional sizes are refused."""
    def _as_size(k):
        if isinstance(k, (bool, np.bool_)) or float(k) != int(k):
            raise ValueError(
                f"round-robin ticket size must be an integer, got {k!r}")
        return int(k)

    if isinstance(by, (str, bytes, np.bool_)):
        raise ValueError(
            f"round-robin size spec must be an int or an iterable of "
            f"ints, got {by!r}")
    scalar = isinstance(by, (int, float, np.integer, np.floating))
    ks = sorted({_as_size(k) for k in ((by,) if scalar else by)})
    if not ks:
        raise ValueError("round robin needs at least one ticket size")
    for k in ks:
        if not 1 <= k <= n_legs:
            raise ValueError(
                f"round-robin ticket size {k} is invalid for {n_legs} legs")
    return ks


def round_robin(out, team_a_ctx, team_b_ctx, legs, by=2,
                price: Optional[int] = None, *, resolved=None,
                max_tickets: int = 512) -> Dict:
    """A same-game round robin: every `by`-leg combination of the legs (one
    size or several, e.g. (2, 3)) priced as its own `parlay_odds` ticket,
    all of them from one reduction over the games and one host copy.
    Card-level fields: `p_any_ticket_wins`, `p_all_tickets_win` and, with
    `price` (applied per ticket), `ev_total_$100` at $100 a ticket.  More
    than `max_tickets` tickets raise."""
    import itertools

    arrays, meta = resolved if resolved is not None else \
        resolve_parlay_legs(team_a_ctx, team_b_ctx, legs)
    _need_player_stats(meta, out.pstats)
    n_legs = len(meta)
    ks = _rr_sizes(by, n_legs)
    combos = [c for k in ks for c in itertools.combinations(range(n_legs), k)]
    if len(combos) > max_tickets:
        raise ValueError(
            f"round robin of sizes {ks} over {n_legs} legs writes "
            f"{len(combos)} tickets (> max_tickets={max_tickets})")
    mask = np.zeros((len(combos), n_legs), dtype=bool)
    for i, c in enumerate(combos):
        mask[i, list(c)] = True
    kvec = mask.sum(axis=1).astype(np.float32)
    red = _host_counts(reduce_round_robin_device(out.score, out.pstats, mask, kvec, arrays))
    n = float(out.score.shape[0])
    labels = [m["label"] for m in meta]

    tickets = []
    for i, c in enumerate(combos):
        p_all_win = float(red["all_win"][i]) / n
        p_no_lose = float(red["no_lose"][i]) / n
        p_void = float(red["all_push"][i]) / n
        p_parlay = p_all_win / max(p_all_win + (1.0 - p_no_lose), 1e-12)
        t: Dict = {
            "legs": [labels[j] for j in c], "k": int(len(c)),
            "p_all_win": round(p_all_win, 6),
            "p_lose": round(1.0 - p_no_lose, 6),
            "p_void": round(p_void, 6),
            "p_win_reduced": round(max(0.0, p_no_lose - p_all_win - p_void), 6),
            "p_parlay": round(p_parlay, 6),
            "fair_american": prob_to_american(p_parlay),
        }
        if price is not None:
            t.update(_priced_block(p_all_win, p_no_lose, p_parlay, price))
        tickets.append(t)

    res: Dict = {
        "team": team_a_ctx.name, "opp": team_b_ctx.name, "n": int(n),
        "by": ks, "n_tickets": len(tickets), "leg_labels": labels,
        "p_any_ticket_wins": round(float(red["any_win"]) / n, 6),
        "p_all_tickets_win": round(float(red["every_win"]) / n, 6),
        "tickets": tickets,
    }
    if price is not None:
        res["price"] = int(price)
        res["stake_$"] = 100 * len(tickets)
        res["ev_total_$100"] = round(sum(t["ev_$100"] for t in tickets), 2)
    return res


def round_robin_blocks(blocks, by=2, price: Optional[int] = None) -> Dict:
    """A round robin over per-game parlay blocks: every `by`-block
    combination priced as a `cross_game_parlay` ticket.  The number of
    blocks that win whole is Poisson-binomial over their `p_all_win`
    (`season_win_pmf`), which gives `p_any_ticket_wins` (at least min(by)
    blocks win) and `p_all_tickets_win` (all do)."""
    import itertools

    ks = _rr_sizes(by, len(blocks))
    combos = [c for k in ks for c in itertools.combinations(range(len(blocks)), k)]
    tickets = [cross_game_parlay([blocks[j] for j in c], price=price) for c in combos]
    pmf = season_win_pmf([b["p_all_win"] for b in blocks])
    res: Dict = {
        "games": [f"{b['team']} vs {b['opp']}" for b in blocks],
        "by": ks, "n_tickets": len(tickets),
        "p_any_ticket_wins": round(float(pmf[min(ks):].sum()), 6),
        "p_all_tickets_win": round(float(pmf[-1]), 6),
        "tickets": tickets,
    }
    if price is not None:
        res["price"] = int(price)
        res["stake_$"] = 100 * len(tickets)
        res["ev_total_$100"] = round(sum(t["ev_$100"] for t in tickets), 2)
    return res


def season_win_pmf(p_wins) -> np.ndarray:
    """The exact distribution of a season's win count from per-game strict
    win probabilities (independent games): the Poisson-binomial pmf,
    pmf[k] = P(exactly k wins), length len(p_wins) + 1."""
    pmf = np.array([1.0])
    for i, p in enumerate(np.asarray(list(p_wins), float)):
        if not 0.0 <= p <= 1.0 or not np.isfinite(p):
            raise ValueError(f"p_wins[{i}]={p!r} is not a probability")
        pmf = np.convolve(pmf, [1.0 - p, p])
    return pmf


def season_win_market(p_wins, line: Optional[float] = None,
                      team: str = "", price: int = -110) -> Dict:
    """A season win-total market from per-game win probabilities: the win
    distribution (pmf, mean and median wins, P(wins >= k) for every k) and,
    with a quoted `line`, over/under/push probabilities, fair prices and
    the better side at `price` (push-aware: an integer line pushes on
    exactly `line` wins and refunds the stake)."""
    p_wins = list(np.asarray(list(p_wins), float))
    pmf = season_win_pmf(p_wins)
    dist = Dist.from_hist(pmf, np.arange(len(pmf)))
    at_least = np.concatenate([[1.0], np.cumsum(pmf[::-1])[::-1][1:]])
    res: Dict = {
        "team": team,
        "games": len(p_wins),
        "p_wins": [round(float(p), 6) for p in p_wins],
        "mean_wins": round(dist.mean(), 4),
        "median_wins": dist.median(),
        "pmf": [round(float(p), 6) for p in pmf],
        "p_at_least": [round(float(p), 6) for p in at_least],
    }
    if line is not None:
        p_over, p_under = dist.over(line), dist.under(line)
        p_push = dist.push(line)
        res.update({
            "line": float(line),
            "p_over": round(p_over, 6),
            "p_under": round(p_under, 6),
            "push_rate": round(p_push, 6),
            "american_over": prob_to_american(p_over),
            "american_under": prob_to_american(p_under),
        })
        profit = (100.0 * 100.0 / -price) if price < 0 else float(price)
        ev_over = p_over * profit - p_under * 100.0
        ev_under = p_under * profit - p_over * 100.0
        side, p_side, ev = (("Over", p_over, ev_over) if ev_over >= ev_under
                            else ("Under", p_under, ev_under))
        live = p_over + p_under
        res["best"] = {
            "side": side,
            "ev": round(ev, 2),
            # the edge of the push-excluded conditional over the price's
            # break-even
            "edge": (round(p_side / live - american_implied_prob(price), 6)
                     if live > 0 else 0.0),
            "kelly": round(kelly_fraction(p_side, price, p_push=p_push), 4),
        }
    return res


# ---- printers ----------------------------------------------------------------------

def _odds_str(o: int) -> str:
    return f"{o:+d}"


def _desc_order(values: np.ndarray) -> np.ndarray:
    """The row order of pandas' sort_values(ascending=False) on one float
    column, NaN last, by pandas' own steps (reverse, quicksort, reverse),
    so that ties fall as they do there."""
    nan = np.isnan(values)
    idx = np.flatnonzero(~nan)[::-1]
    order = idx[values[idx].argsort(kind="quicksort")][::-1]
    return np.concatenate([order, np.flatnonzero(nan)])


def print_slate_edges(table) -> None:
    """A compact view of a slate market table (rows or DataFrame), the
    largest edge first."""
    rows = _records(table)
    if not rows:
        print("\n— Slate Market Edges —\n  (no matchups priced)")
        return
    cols = {c for r in rows for c in r}
    edge_cols = [c for c in ("spread_edge_pct", "total_edge_pct") if c in cols]
    if edge_cols:
        best = np.array([max((abs(r[c]) for c in edge_cols if _given(r.get(c))),
                             default=np.nan) for r in rows], dtype=float)
        rows = [rows[i] for i in _desc_order(best)]
    print("\n— Slate Market Edges (fair vs -110) —")
    for r in rows:
        print(f"\n{r['team_a']} vs {r['team_b']}  (n={int(r['n'])})")
        print(f"  ML fair: {r['team_a']} {_odds_str(int(r['ml_fair_a']))} "
              f"({100*r['p_win_a']:.1f}%)  |  {r['team_b']} "
              f"{_odds_str(int(r['ml_fair_b']))} ({100*r['p_win_b']:.1f}%)")
        if _given(r.get("spread")):
            print(f"  Spread {r['team_a']} {r['spread']:+.1f}: cover "
                  f"{100*r['p_cover_a']:.1f}% fair "
                  f"{_odds_str(int(r['fair_cover_a']))}  ->  "
                  f"{r['spread_bet']}  edge {r['spread_edge_pct']:+.2f}%  "
                  f"EV ${r['spread_ev_$100']:+.2f}/$100")
        if _given(r.get("total")):
            print(f"  Total {r['total']:.1f}: over {100*r['p_over']:.1f}% "
                  f"fair {_odds_str(int(r['fair_over']))}  ->  "
                  f"{r['total_bet']}  edge {r['total_edge_pct']:+.2f}%  "
                  f"EV ${r['total_ev_$100']:+.2f}/$100")


def print_alt_lines(res: Dict) -> None:
    """Readable alternate-line ladders (`alt_line_rows_from_summary`, or
    `alt_lines_from_summary`'s DataFrames)."""
    sp = _records(res.get("spread"))
    if sp:
        print("\n— Alternate Spreads —")
        print(f"  {'line':>7}  {'cover%':>7}  {'push%':>6}  "
              f"{'fair':>6}/{'fair-':<6}  best @ -110")
        for r in sp:
            print(f"  {r['spread']:>+7.1f}  {100*r['p_cover']:>6.1f}%  "
                  f"{100*r['push_rate']:>5.1f}%  "
                  f"{_odds_str(int(r['fair_cover'])):>6}/"
                  f"{_odds_str(int(r['fair_notcover'])):<6}  "
                  f"{r['bet']}  {r['edge_pct']:+.2f}%  "
                  f"${r['ev_$100']:+.2f}/$100")
    tt = _records(res.get("total"))
    if tt:
        print("\n— Alternate Totals —")
        print(f"  {'line':>7}  {'over%':>7}  {'push%':>6}  "
              f"{'fair':>6}/{'fair-':<6}  best @ -110")
        for r in tt:
            print(f"  {r['total']:>7.1f}  {100*r['p_over']:>6.1f}%  "
                  f"{100*r['push_rate']:>5.1f}%  "
                  f"{_odds_str(int(r['fair_over'])):>6}/"
                  f"{_odds_str(int(r['fair_under'])):<6}  "
                  f"{r['bet']}  {r['edge_pct']:+.2f}%  "
                  f"${r['ev_$100']:+.2f}/$100")


def print_round_robin_readable(res: Dict) -> None:
    where = (f"{res['team']} vs {res['opp']} (n={res['n']})"
             if "team" in res else " + ".join(res["games"]))
    sizes = "/".join(str(k) for k in res["by"])
    print(f"\n=== Round robin by {sizes}: {where} — "
          f"{res['n_tickets']} tickets ===")
    rows = sorted(res["tickets"], key=lambda t: t.get("ev_$100", t["p_parlay"]),
                  reverse=True)
    for t in rows:
        legs = " + ".join(leg["label"] if isinstance(leg, dict) else leg
                          for leg in t["legs"])
        line = (f"  {legs:<52s} p {t['p_parlay']:.4f}  "
                f"fair {_odds_str(t['fair_american'])}")
        if "ev_$100" in t:
            line += f"  EV ${t['ev_$100']:+.2f}"
        print(line)
    print(f"  P(any ticket wins): {res['p_any_ticket_wins']:.4f}   "
          f"P(all tickets win): {res['p_all_tickets_win']:.4f}")
    if "ev_total_$100" in res:
        print(f"  Card at {_odds_str(res['price'])} per ticket: stake "
              f"${res['stake_$']}  total EV ${res['ev_total_$100']:+.2f}")


def print_parlay_readable(res: Dict) -> None:
    if "team" in res:
        print(f"\n=== Same-game parlay: {res['team']} vs {res['opp']} "
              f"(n={res['n']}) ===")
    else:
        print(f"\n=== Cross-game parlay: {' + '.join(res['games'])} ===")
    for leg in res["legs"]:
        tag = f" [{leg['game']}]" if "game" in leg else ""
        print(f"  {leg['label'] + tag:<40s} p_win {leg['p_win']:.4f}"
              + (f"  push {leg['p_push']:.4f}" if leg["p_push"] else ""))
    print(f"  P(all legs win):        {res['p_all_win']:.4f}")
    if res["p_win_reduced"] or res["p_void"]:
        print(f"  P(win reduced):         {res['p_win_reduced']:.4f}   "
              f"P(full void): {res['p_void']:.4f}")
    print(f"  Fair odds (joint):      {_odds_str(res['fair_american'])}"
          f"   (p={res['p_parlay']:.4f})")
    print(f"  If legs were indep.:    "
          f"{_odds_str(res['fair_american_independent'])}"
          f"   (p={res['p_independent']:.4f})")
    print(f"  Correlation multiplier: {res['correlation_mult']:.3f}x")
    if "price" in res:
        print(f"  At quoted {_odds_str(res['price'])}: edge "
              f"{res['edge_pct']:+.2f}%  EV ${res['ev_$100']:+.2f}/$100"
              f"  kelly {res['kelly']:.3f}")


def print_season_readable(res: Dict) -> None:
    hdr = res["team"] or "team"
    print(f"\n=== Season win total: {hdr} ({res['games']} games) ===")
    print(f"  mean wins {res['mean_wins']:.2f}   "
          f"median {res['median_wins']:.0f}")
    lad = "  ".join(f"{k}+:{p:.3f}" for k, p in enumerate(res["p_at_least"]) if k)
    print(f"  P(at least k wins): {lad}")
    if "line" in res:
        b = res["best"]
        print(f"  line {res['line']}: over {res['p_over']:.4f} "
              f"({_odds_str(res['american_over'])})  "
              f"under {res['p_under']:.4f} "
              f"({_odds_str(res['american_under'])})"
              + (f"  push {res['push_rate']:.4f}" if res["push_rate"] else ""))
        print(f"  best side: {b['side']}  edge {b['edge'] * 100:+.2f}%  "
              f"EV ${b['ev']:+.2f}/$100  kelly {b['kelly']:.3f}")


def print_middle_readable(res: Dict) -> None:
    legs = " / ".join(res.get("legs", [f"over {res['low']:g}",
                                       f"under {res['high']:g}"]))
    print(f"\n=== Middle: {legs} ===")
    print(f"  P(both win):  {res['p_middle']:.4f}   "
          f"window ({res['low']:g}, {res['high']:g})")
    print(f"  P(low leg only): {res['p_low_leg_only']:.4f}   "
          f"P(high leg only): {res['p_high_leg_only']:.4f}")
    if res["p_push_low"] or res["p_push_high"]:
        print(f"  push low/high: {res['p_push_low']:.4f} / "
              f"{res['p_push_high']:.4f}")
    print(f"  At {_odds_str(res['price_low'])} / "
          f"{_odds_str(res['price_high'])}, $100 each side: "
          f"EV ${res['ev_$100_each']:+.2f}")


def print_game_market_readable(res: dict) -> None:
    print("\n— Game Market —")
    be = breakeven_minus110()
    if "spread" in res:
        s = res["spread"]
        ev_cover = ev_per_100_at_minus110(s["p_cover"], s["push_rate"])
        ev_not = ev_per_100_at_minus110(s["p_notcover"], s["push_rate"])
        print(f"Spread: {s['team']} vs {s['opp']}  |  {s['team']} {s['spread']:+.1f}"
              f"  (samples {s['samples']})")
        print(f"  Cover:     {100*s['p_cover']:.1f}%  fair {_odds_str(s['american_cover'])}  "
              f"edge {(100*(s['p_cover']-be)):.2f}%  EV ${ev_cover:.2f}/$100")
        print(f"  Not cover: {100*s['p_notcover']:.1f}%  fair "
              f"{_odds_str(s['american_notcover'])}  "
              f"edge {(100*(s['p_notcover']-be)):.2f}%  EV ${ev_not:.2f}/$100")
        print(f"  Push:      {100*s['push_rate']:.1f}%   | mean/median margin "
              f"{s['mean_margin']:.1f} / {s['median_margin']:.1f}")
    if "total" in res:
        t = res["total"]
        ev_over = ev_per_100_at_minus110(t["p_over"], t["push_rate"])
        ev_under = ev_per_100_at_minus110(t["p_under"], t["push_rate"])
        print(f"\nTotal: {t['team']} vs {t['opp']}  |  {t['total']:.1f}  "
              f"(samples {t['samples']})")
        print(f"  Over:   {100*t['p_over']:.1f}%  fair {_odds_str(t['american_over'])}   "
              f"edge {(100*(t['p_over']-be)):.2f}%  EV ${ev_over:.2f}/$100")
        print(f"  Under:  {100*t['p_under']:.1f}% fair {_odds_str(t['american_under'])}  "
              f"edge {(100*(t['p_under']-be)):.2f}%  EV ${ev_under:.2f}/$100")
        print(f"  Push:   {100*t['push_rate']:.1f}%   | mean/median total "
              f"{t['mean_total']:.1f} / {t['median_total']:.1f}")
    if "spread" in res and "total" in res:
        _print_projected_scores(res)


def _print_projected_scores(res: dict) -> None:
    """Mean and median projected score from the margin and the total."""
    t = res["total"]
    s = res["spread"]
    for label, tv, sv in (("Mean", t["mean_total"], s["mean_margin"]),
                          ("Median", t["median_total"], s["median_margin"])):
        team_score = (tv + sv) / 2.0
        opp_score = (tv - sv) / 2.0
        print(f"\n{label} Score: {t['team']} - {team_score:.0f} vs "
              f"{t['opp']} - {opp_score:.0f}  |  (samples {t['samples']})")


def print_moneyline_readable(ml: dict) -> None:
    print("\n— Fair Moneyline (no vig) —")
    for k in ("team", "opp"):
        e = ml[k]
        print(f"  {e['name']}: {100*e['p_win']:.2f}%   fair {_odds_str(e['ml_fair'])}")


def _stat_group(stat) -> str:
    s = str(stat).lower()
    if s.startswith("pass"):
        return "Passing"
    if s.startswith("rush"):
        return "Rushing"
    if s.startswith("rec") or s in {"tgt", "receptions", "targets"}:
        return "Receiving"
    return "Other"


def print_prop_table(table) -> None:
    """A prop table (rows or a DataFrame: `scan_props_rows`,
    `scan_props_for_matchup`, `simulate_slate_prop_rows`) by stat group,
    the largest |edge| first within a group, ties in the table's order."""
    rows = _records(table)
    if not rows:
        print("\n— Player Props value (@ -110 both sides) —\n"
              "  (no props matched or no value found)")
        return
    groups = [_stat_group(r["stat"]) for r in rows]
    order = sorted(range(len(rows)), key=lambda i: (groups[i], -abs(rows[i]["edge_pct"])))
    print("\n— Player Props value (@ -110 both sides) —")
    for gname in ("Passing", "Rushing", "Receiving", "Other"):
        g = [rows[i] for i in order if groups[i] == gname]
        if not g:
            continue
        print(f"\n[{gname}]")
        for r in g:
            print(f"{r['team']}: {r['player']}  |  {r['stat']} {r['best_side']} "
                  f"{r['line']:.1f}  (edge {r['edge_pct']:+.2f}%, "
                  f"EV ${r['ev_$100']:+.2f}/$100, mean {r['mean']:.1f}, "
                  f"med {r['median']:.1f}, n={int(r['samples'])})")


def find_edges(*, csv_base: Optional[str], team_a: str, team_b: str,
               spread: Optional[float], total: Optional[float],
               props_csv: Optional[str] = None, directory: str = ".",
               min_abs_edge_pct: float = 2.0) -> None:
    """One report over saved sims: the spread and total (where quoted), the
    fair moneylines, and the prop scan (with a prop sheet)."""
    if spread is not None or total is not None:
        print_game_market_readable(game_market_odds(
            csv_base, team_a, team_b, spread=spread, total=total, directory=directory))
    # the moneyline and props need no quoted line
    print_moneyline_readable(moneyline_from_sims(csv_base, team_a, team_b,
                                                 directory=directory))
    if props_csv and Path(props_csv).exists():
        print_prop_table(scan_props_for_matchup_rows(
            csv_base, team_a, team_b, props_csv, directory=directory,
            min_abs_edge_pct=min_abs_edge_pct))

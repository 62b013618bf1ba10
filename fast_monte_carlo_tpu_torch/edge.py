"""Market pricing: the props and summary-market parts of
fast_monte_carlo_tpu/edge.py.

The odds math (American odds, EV at a price, Kelly stakes, the better side
of a prop), the mapping of a prop sheet's rows onto a matchup's player-stat
cells (`resolve_prop_rows`), the per-prop reduction over a batch of games
on the device of its player stats (`reduce_props_device`) and the prop
table with edges and EV.  The game markets priced from a `ScoreSummary`'s
histograms (`market_odds_from_summary`, `summary_moneyline`), their
alternate-line ladders (`alt_lines_from_summary`), middles
(`middles_from_summary`) and a whole slate's markets
(`slate_market_table`) go through the `Dist` core in numpy on the host.
The rest of the JAX package's `edge.py` (markets over saved files,
parlays, round robins) is not ported yet (ROADMAP P10).

One divergence from the JAX package, on purpose: `Dist.affine` raises for
scale <= 0, which the JAX package accepts (its edge.py:262; a negative
scale mirrors the distribution and swaps over and under).

The JAX package returns the prop table, the ladders and the slate table as
DataFrames; here the pandas-free cores return lists of row dicts in the
same column order (`prop_rows_from_reductions`, `scan_props_rows`,
`alt_spread_rows`, `alt_total_rows`, `alt_line_rows_from_summary`,
`slate_market_rows`), and the JAX package's names wrap them into
DataFrames, importing pandas only there.  The printers take either.
"""
from __future__ import annotations

import csv
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

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

"""Player-prop pricing: the props part of fast_monte_carlo_tpu/edge.py.

The odds math (American odds, EV at a price, the better side of a prop),
the mapping of a prop sheet's rows onto a matchup's player-stat cells
(`resolve_prop_rows`), the per-prop reduction over a batch of games on the
device of its player stats (`reduce_props_device`) and the prop table with
edges and EV.  The rest of the JAX package's `edge.py` (spread, total and
moneyline markets, parlays, round robins) is not ported yet (ROADMAP P10).

The JAX package returns the prop table as a DataFrame; here the pandas-free
cores return it as a list of row dicts in the same column order
(`prop_rows_from_reductions`, `scan_props_rows`), and the JAX package's
names wrap them into DataFrames, importing pandas only there.
"""
from __future__ import annotations

import csv
import re
from typing import Dict, List, Tuple

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


def american_implied_prob(price: int) -> float:
    return (-price) / ((-price) + 100) if price < 0 else 100 / (price + 100)


def ev_per_100(p_win: float, price: int) -> float:
    profit = 100 * (100 / (-price)) if price < 0 else 100 * (price / 100)
    return p_win * profit - (1 - p_win) * 100


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

"""Backtest: the simulator scored against real finals, a port of
fast_monte_carlo_tpu/backtest.py.

* win-probability calibration: Brier score, log loss, expected
  calibration error and a reliability table over probability bins;
* margin and total accuracy: bias, MAE, RMSE, correlation;
* whole-distribution calibration: the mid-p PIT of each actual margin and
  total under its simulated histogram, and the KS distance of the PITs from
  uniform.

The core is numpy over row dicts: predictions are slate summary rows
(`api.simulate_slate_summary_rows`), results are finals (team_a, team_b,
score_a, score_b) in either orientation, each given as row dicts or a
DataFrame.  `join_result_rows`, `calibration_report_rows` and
`backtest_slate_report` return rows; the JAX package's names
(`join_results`, `calibration_report`, `backtest_slate`) return the joined
rows as a DataFrame, importing pandas only there.  `fit_calibration` turns
a report into the `edge.MarketCalibration` the server accepts.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .data.columns import columns_from_records, columns_of, frame, records_of
from .edge import MarketCalibration, _norm_team
from .models.heads import DEFAULT_ARTIFACT_DIR


def _rows(table) -> List[dict]:
    """Row dicts of a DataFrame or of a list of dicts."""
    if hasattr(table, "columns"):
        return records_of(columns_of(table))
    return [dict(r) for r in table]


def join_result_rows(predictions, results) -> List[dict]:
    """Each prediction row matched to its final on normalized team names,
    either orientation: the prediction's columns, `_pred_index` (its
    position among the predictions), actual_a, actual_b, actual_margin_a,
    actual_total and won_a (a tie counts for neither side).  A pair met
    more than once is matched in order: the k-th prediction of a pair
    scores against its k-th final.  Unmatched predictions are dropped."""
    res_ix: Dict[Tuple[str, str], List[Tuple[float, float]]] = {}
    for r in _rows(results):
        a, b = _norm_team(r["team_a"]), _norm_team(r["team_b"])
        # kept under the sorted pair; the orientation is restored on a match
        key = (a, b) if a <= b else (b, a)
        sa, sb = float(r["score_a"]), float(r["score_b"])
        res_ix.setdefault(key, []).append((sa, sb) if key == (a, b) else (sb, sa))
    rows = []
    for i, p in enumerate(_rows(predictions)):
        a, b = _norm_team(p["team_a"]), _norm_team(p["team_b"])
        key = (a, b) if a <= b else (b, a)
        queue = res_ix.get(key)
        if not queue:
            continue
        sa, sb = queue.pop(0)            # first in, first out per pair
        if key != (a, b):
            sa, sb = sb, sa              # back to the prediction's order
        rows.append({**p, "_pred_index": i,
                     "actual_a": sa, "actual_b": sb,
                     "actual_margin_a": sa - sb, "actual_total": sa + sb,
                     "won_a": float(sa > sb)})
    return rows


def join_results(predictions, results):
    """`join_result_rows` as a DataFrame."""
    return frame(columns_from_records(join_result_rows(predictions, results)))


def win_calibration(p_win: Sequence[float], won: Sequence[float], bins: int = 10) -> Dict:
    """Brier score, log loss, expected calibration error and a reliability
    table (each bin's mean prediction against its observed frequency) of
    binary outcomes."""
    p = np.clip(np.asarray(p_win, float), 1e-12, 1 - 1e-12)
    y = np.asarray(won, float)
    if p.shape != y.shape or p.ndim != 1:
        raise ValueError(f"p_win and won must be equal-length 1-d, got "
                         f"{p.shape} vs {y.shape}")
    brier = float(np.mean((p - y) ** 2))
    logloss = float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p)))
    edges = np.linspace(0.0, 1.0, bins + 1)
    which = np.clip(np.digitize(p, edges[1:-1]), 0, bins - 1)
    table = []
    ece = 0.0
    for b in range(bins):
        m = which == b
        if not m.any():
            continue
        mp, fw = float(p[m].mean()), float(y[m].mean())
        table.append({"bin_lo": float(edges[b]), "bin_hi": float(edges[b + 1]),
                      "n": int(m.sum()), "mean_pred": round(mp, 4),
                      "frac_won": round(fw, 4), "gap": round(fw - mp, 4)})
        ece += m.mean() * abs(fw - mp)
    return {"n": int(p.size), "brier": round(brier, 5),
            "brier_skill": round(1.0 - brier / 0.25, 4),
            "logloss": round(logloss, 5), "ece": round(float(ece), 5),
            "reliability": table}


def point_metrics(pred: Sequence[float], actual: Sequence[float]) -> Dict:
    """Bias, MAE, RMSE and (with spread on both sides) the correlation of a
    point forecast against the actual numbers."""
    p, a = np.asarray(pred, float), np.asarray(actual, float)
    err = p - a
    out = {"n": int(p.size), "bias": round(float(err.mean()), 3),
           "mae": round(float(np.abs(err).mean()), 3),
           "rmse": round(float(np.sqrt((err ** 2).mean())), 3)}
    if p.size >= 2 and p.std() > 0 and a.std() > 0:
        out["corr"] = round(float(np.corrcoef(p, a)[0, 1]), 4)
    return out


def pit_values(hists: Sequence[np.ndarray], support0: float,
               actuals: Sequence[float]) -> np.ndarray:
    """Mid-p PIT of each actual value under its histogram, P(X < actual) +
    P(X == actual) / 2, every histogram's integer support starting at
    `support0`.  Uniform on (0, 1) where the simulated distributions are
    the truth."""
    out = np.empty(len(actuals))
    for i, (h, a) in enumerate(zip(hists, actuals)):
        h = np.asarray(h, float)
        n = h.sum()
        k = int(round(float(a) - support0))
        below = h[:max(k, 0)].sum()
        at = h[k] if 0 <= k < len(h) else 0.0
        out[i] = (below + 0.5 * at) / n
    return out


def ks_uniform(pit: np.ndarray) -> float:
    """One-sample KS distance of PIT values from Uniform(0, 1)."""
    x = np.sort(np.asarray(pit, float))
    n = x.size
    grid = np.arange(1, n + 1) / n
    return float(np.maximum(grid - x, x - (grid - 1 / n)).max())


def _col(rows: List[dict], k: str) -> np.ndarray:
    return np.asarray([r[k] for r in rows], dtype=float)


def calibration_report_rows(predictions, results, summaries: Optional[List] = None,
                            bins: int = 10) -> Dict:
    """The backtest report of slate predictions against finals: games,
    win calibration (ties left out), margin and total accuracy, and the
    joined rows (`rows`, row dicts).  With `summaries` (one ScoreSummary a
    prediction row, in its order) each joined row gains pit_margin and
    pit_total, and the report a `pit` block (KS distances, PIT means and
    the KS critical distance at 95%)."""
    from .parallel.aggregate import MARGIN_OFF

    joined = join_result_rows(predictions, results)
    if not joined:
        raise ValueError("no prediction rows matched the results frame "
                         "(team names are matched normalized, either "
                         "orientation)")
    # a tie has no strict winner: out of the binary block, as win_rate
    # leaves ties out of the probability
    dec = [r for r in joined if r["actual_margin_a"] != 0]
    rep: Dict = {
        "games": len(joined),
        "win": win_calibration(_col(dec, "win_a"), _col(dec, "won_a"), bins=bins),
        "margin": point_metrics(_col(joined, "mean_margin_a"),
                                _col(joined, "actual_margin_a")),
        "total": point_metrics(_col(joined, "mean_total"), _col(joined, "actual_total")),
        "rows": joined,
    }
    if summaries is not None:
        if len(summaries) != len(_rows(predictions)):
            raise ValueError("summaries must align 1:1 with predictions")
        # by prediction row, so that a rematch keeps its own distribution
        sums = [summaries[r["_pred_index"]] for r in joined]
        pit_m = pit_values([np.asarray(s.margin_hist, float) for s in sums], -MARGIN_OFF,
                           _col(joined, "actual_margin_a"))
        pit_t = pit_values([np.asarray(s.total_hist, float) for s in sums], 0.0,
                           _col(joined, "actual_total"))
        for r, pm, pt in zip(joined, pit_m, pit_t):
            r["pit_margin"], r["pit_total"] = float(pm), float(pt)
        rep["pit"] = {
            "margin_ks": round(ks_uniform(pit_m), 4),
            "total_ks": round(ks_uniform(pit_t), 4),
            "margin_mean": round(float(pit_m.mean()), 4),
            "total_mean": round(float(pit_t.mean()), 4),
            # the asymptotic KS critical distance at 95% for n samples
            "ks_crit_95": round(1.36 / np.sqrt(len(joined)), 4),
        }
    return rep


def calibration_report(predictions, results, summaries: Optional[List] = None,
                       bins: int = 10) -> Dict:
    """`calibration_report_rows` with `rows` a DataFrame."""
    rep = calibration_report_rows(predictions, results, summaries, bins)
    rep["rows"] = frame(columns_from_records(rep["rows"]))
    return rep


def fit_calibration(rep: Dict):
    """The shift-only market calibration of a backtest report (its rows
    as row dicts or a DataFrame): margin and total shifts the negated mean
    errors, scales 1.  Returns (MarketCalibration, their standard errors,
    ddof 1)."""
    joined = _rows(rep["rows"])
    m_err = _col(joined, "mean_margin_a") - _col(joined, "actual_margin_a")
    t_err = _col(joined, "mean_total") - _col(joined, "actual_total")
    c = MarketCalibration(margin_shift=round(-float(m_err.mean()), 3),
                          total_shift=round(-float(t_err.mean()), 3))
    ses = {"margin_shift_se": round(float(m_err.std(ddof=1) / np.sqrt(len(m_err))), 3),
           "total_shift_se": round(float(t_err.std(ddof=1) / np.sqrt(len(t_err))), 3)}
    return c, ses


def backtest_slate_report(
    games: List[Tuple[str, str]],
    results,
    *,
    sp_path: str,
    year: int = 2025,
    week: int = 1,
    n_pairs: int = 32768,
    artifact_dir: str = DEFAULT_ARTIFACT_DIR,
    focus_csv: Optional[str] = None,
    mode: str = "table",
    table_quality: str = "nano",
    cfg=None,
    seed: int = 0,
    shard: bool = False,
    bins: int = 10,
    device=None,
) -> Dict:
    """`games` simulated through `api.simulate_slate_summary_rows` (the loop
    layout, on the card unless `device` says otherwise) and scored against
    `results`: `calibration_report_rows` with the slate's summaries.  The
    SP+ sheet must be the one of the games' week: ratings from after the
    games would leak the outcomes being scored."""
    from .api import simulate_slate_summary_rows

    rows, summaries = simulate_slate_summary_rows(
        games, sp_path=sp_path, year=year, week=week, n_pairs=n_pairs,
        artifact_dir=artifact_dir, focus_csv=focus_csv, mode=mode,
        table_quality=table_quality, cfg=cfg, seed=seed, shard=shard, device=device)
    return calibration_report_rows(rows, results, summaries=summaries, bins=bins)


def backtest_slate(games: List[Tuple[str, str]], results, **kw) -> Dict:
    """`backtest_slate_report` with `rows` a DataFrame."""
    rep = backtest_slate_report(games, results, **kw)
    rep["rows"] = frame(columns_from_records(rep["rows"]))
    return rep


def print_backtest_readable(rep: Dict) -> None:
    w = rep["win"]
    print(f"\n=== Backtest: {rep['games']} games "
          f"({w['n']} with a winner) ===")
    print(f"  win prob : brier {w['brier']:.4f}  "
          f"(skill vs coin {w['brier_skill']:+.3f})  "
          f"logloss {w['logloss']:.4f}  ECE {w['ece']:.4f}")
    for row in w["reliability"]:
        print(f"    [{row['bin_lo']:.1f},{row['bin_hi']:.1f})  n={row['n']:<4d}"
              f" pred {row['mean_pred']:.3f}  won {row['frac_won']:.3f}"
              f"  gap {row['gap']:+.3f}")
    m, t = rep["margin"], rep["total"]
    print(f"  margin   : bias {m['bias']:+.2f}  mae {m['mae']:.2f}  "
          f"rmse {m['rmse']:.2f}" + (f"  corr {m['corr']:.3f}"
                                     if "corr" in m else ""))
    print(f"  total    : bias {t['bias']:+.2f}  mae {t['mae']:.2f}  "
          f"rmse {t['rmse']:.2f}" + (f"  corr {t['corr']:.3f}"
                                     if "corr" in t else ""))
    if "pit" in rep:
        p = rep["pit"]
        print(f"  PIT (KS vs uniform, crit@95% {p['ks_crit_95']:.3f}): "
              f"margin {p['margin_ks']:.3f} (mean {p['margin_mean']:.3f})  "
              f"total {p['total_ks']:.3f} (mean {p['total_mean']:.3f})")

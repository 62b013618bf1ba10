"""The backtest (`backtest.py`) on the CPU, held to the JAX package.

The numpy core over row dicts gives the JAX package's report within 1e-12
(in practice the same floats) on the repo's two files of real finals
(`benchmarks/finals_2025_wk01.csv`, `_wk03.csv`), with seeded prediction
rows and margin/total histograms built for their teams, and on hand cases:
reversed orientations, rematches met in order, ties left out of the win
block, unmatched rows.  `fit_calibration` is equal; `backtest_slate` on the
fixture sheet agrees with the JAX package's within Monte-Carlo error (the
two draw different streams)."""
import contextlib
import dataclasses
import io
from pathlib import Path
from typing import NamedTuple

import numpy as np
import pandas as pd
import pytest
import torch

from fast_monte_carlo_tpu import api as japi
from fast_monte_carlo_tpu import backtest as jbt
from fast_monte_carlo_tpu.config import SimConfig as JaxSimConfig
from fast_monte_carlo_tpu_torch import backtest, fixtures
from fast_monte_carlo_tpu_torch.edge import MarketCalibration

from test_torch_support import jax_readable_copy, within

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
FINALS = ["finals_2025_wk01.csv", "finals_2025_wk03.csv"]
TOL = 1e-12


class Hists(NamedTuple):
    margin_hist: np.ndarray
    total_hist: np.ndarray


def _predictions(results: pd.DataFrame, seed: int, flip_every: int = 3):
    """Seeded slate rows for the finals' games (every `flip_every`-th in the
    other orientation), and a margin and total histogram for each."""
    rng = np.random.default_rng(seed)
    rows, hists = [], []
    for i, r in enumerate(results.itertuples(index=False)):
        a, b = (r.team_b, r.team_a) if i % flip_every == 1 else (r.team_a, r.team_b)
        m, t = rng.normal(0, 10), rng.normal(52, 8)
        win_a = float(np.clip(0.5 + m / 30 + rng.normal(0, 0.05), 0.01, 0.99))
        rows.append({"team_a": a, "team_b": b, "mean_a": (t + m) / 2, "mean_b": (t - m) / 2,
                     "win_a": win_a, "win_b": 1 - win_a - 0.01, "mean_margin_a": m,
                     "mean_total": t, "n_games": 4096})
        margins = np.clip(np.round(rng.normal(m, 14, 4096)).astype(int) + 128, 0, 255)
        totals = np.clip(np.round(rng.normal(t, 13, 4096)).astype(int), 0, 255)
        hists.append(Hists(np.bincount(margins, minlength=256).astype(np.int32),
                           np.bincount(totals, minlength=256).astype(np.int32)))
    return rows, hists


def _close(got, want, path="rep"):
    """Equal structure; floats within TOL; DataFrames compared as records."""
    if isinstance(want, pd.DataFrame):
        want = want.to_dict("records")
        got = got.to_dict("records") if isinstance(got, pd.DataFrame) else got
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]")
    elif isinstance(want, (float, np.floating)):
        assert abs(float(got) - float(want)) <= TOL or (np.isnan(got) and np.isnan(want)), \
            (path, got, want)
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize("name", FINALS)
@pytest.mark.parametrize("seed", [0, 1])
def test_report_equals_jax_on_real_finals(name, seed):
    results = pd.read_csv(REPO / "benchmarks" / name)
    rows, hists = _predictions(results, seed)
    for summaries in (hists, None):
        want = jbt.calibration_report(pd.DataFrame(rows), results, summaries=summaries, bins=8)
        got = backtest.calibration_report_rows(rows, results.to_dict("records"),
                                               summaries=summaries, bins=8)
        assert got["games"] == len(results) and ("pit" in got) == (summaries is not None)
        _close(got, want)
        framed = backtest.calibration_report(pd.DataFrame(rows), results, summaries, bins=8)
        pd.testing.assert_frame_equal(framed["rows"], want["rows"])
    cal, ses = backtest.fit_calibration(got)
    jcal, jses = jbt.fit_calibration(want)
    assert isinstance(cal, MarketCalibration)
    assert dataclasses.asdict(cal) == dataclasses.asdict(jcal) and ses == jses
    assert backtest.fit_calibration(framed) == (cal, ses)


def test_join_orientation_rematches_ties_and_misses():
    """Reversed finals flip back to the prediction's order; the k-th
    prediction of a pair meets its k-th final; one final serves one
    prediction; unmatched rows drop; a tie is won by neither side and
    leaves the win block."""
    preds = [
        {"team_a": "Kansas State", "team_b": "Iowa State", "win_a": 0.6,
         "mean_margin_a": 3.0, "mean_total": 50.0},
        {"team_a": "Iowa State", "team_b": "Kansas State", "win_a": 0.4,
         "mean_margin_a": -3.0, "mean_total": 50.0},
        {"team_a": "Texas", "team_b": "Ohio State", "win_a": 0.5, "mean_margin_a": 0.0,
         "mean_total": 55.0},
        {"team_a": "Baylor", "team_b": "Kansas", "win_a": 0.5, "mean_margin_a": 1.0,
         "mean_total": 48.0},
        {"team_a": "Kansas State", "team_b": "Iowa State", "win_a": 0.7,
         "mean_margin_a": 5.0, "mean_total": 51.0}]
    results = pd.DataFrame({"team_a": ["Kansas State", "iowa state", "Ohio State"],
                            "team_b": ["Iowa State", "KANSAS STATE", "texas"],
                            "score_a": [24, 31, 21], "score_b": [20, 10, 21]})
    got = backtest.join_result_rows(preds, results)
    want = jbt.join_results(pd.DataFrame(preds), results)
    _close(got, want)
    assert [r["_pred_index"] for r in got] == [0, 1, 2]
    assert (got[1]["actual_a"], got[1]["actual_b"]) == (31.0, 10.0)
    assert got[2]["won_a"] == 0.0 and got[2]["actual_margin_a"] == 0
    pd.testing.assert_frame_equal(backtest.join_results(pd.DataFrame(preds), results), want)
    rep = backtest.calibration_report_rows(preds, results)
    assert rep["win"]["n"] == 2 and rep["games"] == 3
    _close(rep, jbt.calibration_report(pd.DataFrame(preds), results))
    with pytest.raises(ValueError, match="no prediction rows matched"):
        backtest.calibration_report_rows(preds[3:4], results)
    with pytest.raises(ValueError, match="align 1:1"):
        backtest.calibration_report_rows(preds, results, summaries=[None])


@pytest.mark.parametrize("seed", range(3))
def test_metric_blocks_equal_jax(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5, 60))
    p = rng.random(n)
    y = (rng.random(n) < p).astype(float)
    for bins in (1, 5, 10):
        _close(backtest.win_calibration(p, y, bins), jbt.win_calibration(p, y, bins))
    pred, actual = rng.normal(0, 10, n), rng.normal(0, 12, n)
    _close(backtest.point_metrics(pred, actual), jbt.point_metrics(pred, actual))
    _close(backtest.point_metrics([3.0], [1.0]), jbt.point_metrics([3.0], [1.0]))
    hists = [rng.integers(0, 50, 40) for _ in range(n)]
    actuals = rng.integers(-5, 45, n)
    np.testing.assert_allclose(backtest.pit_values(hists, -3, actuals),
                               jbt.pit_values(hists, -3, actuals), rtol=0, atol=TOL)
    pit = rng.random(n)
    assert abs(backtest.ks_uniform(pit) - jbt.ks_uniform(pit)) <= TOL
    with pytest.raises(ValueError):
        backtest.win_calibration([0.5, 0.5], [1.0])


def test_print_backtest_readable_equals_jax():
    results = pd.read_csv(REPO / "benchmarks" / FINALS[1])
    rows, hists = _predictions(results, 5)
    for summaries in (hists, None):
        rep = jbt.calibration_report(pd.DataFrame(rows), results, summaries=summaries)
        outs = []
        for fn in (backtest.print_backtest_readable, jbt.print_backtest_readable):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                fn(rep)
            outs.append(buf.getvalue())
        assert outs[0] == outs[1] and "=== Backtest:" in outs[0]


def test_backtest_slate_agrees_with_jax_within_mc_error(tmp_path, monkeypatch):
    """`backtest_slate` on the 136-team fixture sheet and the fixture heads,
    analytic mode on the CPU, against the JAX package's on the same sheet
    and finals: the same games joined, each win_a within 4 standard errors,
    the report's blocks and PITs present and in range."""
    sp = fixtures.write_sp_sheet(tmp_path / "sp.csv", 136, 0)
    games = [("Team A", "Team B"), ("Team 000", "Team 001"), ("Team 002", "Team 003")]
    results = pd.DataFrame({"team_a": ["Team B", "Team 000", "Team 002"],
                            "team_b": ["Team A", "Team 001", "Team 003"],
                            "score_a": [17, 30, 24], "score_b": [24, 27, 24]})
    n = 1024
    got = backtest.backtest_slate(games, results, sp_path=sp, artifact_dir=fixtures.ARTIFACT_DIR,
                                  n_pairs=n, mode="analytic", seed=3, device="cpu")
    c = JaxSimConfig()
    cfg1 = c.replace(engine=dataclasses.replace(c.engine, scan_unroll=1))
    monkeypatch.setattr(japi, "SimConfig", lambda: cfg1)
    want = jbt.backtest_slate(games, results, sp_path=sp,
                              artifact_dir=jax_readable_copy(fixtures.ARTIFACT_DIR,
                                                             tmp_path / "jart"),
                              n_pairs=n, mode="analytic", seed=3)
    assert got["games"] == want["games"] == 3 and got["win"]["n"] == want["win"]["n"] == 2
    g, w = got["rows"], want["rows"]
    assert list(g.columns) == list(w.columns)
    assert g[["team_a", "actual_a", "actual_b"]].equals(w[["team_a", "actual_a", "actual_b"]])
    for x, y in zip(g["win_a"], w["win_a"]):
        assert within(x, y, y, 2 * n), (x, y)
    assert 0 <= got["win"]["brier"] <= 1 and 0 <= got["pit"]["margin_ks"] <= 1
    assert ((0 < g["pit_margin"]) & (g["pit_margin"] < 1)).all()
    rep = backtest.backtest_slate_report(games, results.to_dict("records"), sp_path=sp,
                                         artifact_dir=fixtures.ARTIFACT_DIR, n_pairs=n,
                                         mode="analytic", seed=3, device="cpu")
    assert rep["rows"] == g.to_dict("records")

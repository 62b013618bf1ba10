"""A slate's markets in the PyTorch port against the JAX package, on
ScoreSummaries carried across from the same numpy histograms:
`slate_market_table` with lines matched by `team_a`, by position and
missing, the alternate-line ladders and the middles off a summary (with
and without a calibration), and the printers, compared on their text.
Rounded fields, counts and prices are exact; probabilities are computed
by the same numpy queries on the same histograms and held with
allclose(rtol=1e-6)."""
import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from fast_monte_carlo_tpu import edge as je
from fast_monte_carlo_tpu.parallel import aggregate as ja
from fast_monte_carlo_tpu_torch import edge as te
from fast_monte_carlo_tpu_torch import fixtures
from fast_monte_carlo_tpu_torch.parallel import aggregate as ta

torch.set_num_threads(1)

G = 5
GAMES = [(f"Team {2 * i:03d}", f"Team {2 * i + 1:03d}") for i in range(G)]


def _summaries(seed: int = 17, n: int = 4000):
    """(port ScoreSummaries as numpy, JAX ScoreSummaries of the same
    numbers) of G games' seeded scores, their means apart, with ties and
    margins on the key numbers."""
    rng = np.random.default_rng(seed)
    port, jax_ = [], []
    for g in range(G):
        s = np.stack([rng.poisson(20 + 3 * g, n), rng.poisson(27 - 2 * g, n)],
                     axis=1).astype(np.int32)
        s[: n // 25, 1] = s[: n // 25, 0]                       # ties
        s[n // 25: n // 10, 1] = s[n // 25: n // 10, 0] + 3 + g % 2 * 4   # 3s and 7s
        t = ta.summarize_scores(torch.from_numpy(s))
        host = ta.ScoreSummary(*(x.numpy() for x in t))
        port.append(host)
        jax_.append(ja.ScoreSummary(*(jnp.asarray(x) for x in host)))
    return port, jax_


def _summary_rows(summs):
    return [{"team_a": ta_, "mean_margin_a": float(s.mean_pts[0] - s.mean_pts[1]),
             "mean_total": float(s.mean_pts.sum())} for (ta_, _), s in zip(GAMES, summs)]


PROB_COLS = ("p_win_a", "p_win_b", "p_cover_a", "p_over", "mean_margin_a", "mean_total")


def assert_table_equal(got: pd.DataFrame, want: pd.DataFrame):
    """Same columns in the same order, every value exact but the
    probabilities and means, which agree to rtol 1e-6."""
    assert list(got.columns) == list(want.columns) and len(got) == len(want)
    for c in want.columns:
        if c in PROB_COLS:
            np.testing.assert_allclose(got[c].to_numpy(float), want[c].to_numpy(float),
                                       rtol=1e-6, err_msg=c)
        else:
            pd.testing.assert_series_equal(got[c], want[c], check_exact=True)


def _printed(fn, *args) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue()


@pytest.mark.parametrize("how", ["team_a", "position", "missing", "columns", "frame"])
def test_slate_market_table_matches_jax(how):
    """(h) Lines by normalized team_a (the fixture's: one name in
    capitals, one total left out), by position (the same rows without
    team_a), none at all, as a dict of columns and as a DataFrame: the
    table, and the printed view, equal the JAX package's."""
    port, jax_ = _summaries()
    lines = fixtures.slate_lines(_summary_rows(port), 3)
    if how == "position":
        lines = [{k: v for k, v in r.items() if k != "team_a"} for r in lines]
    elif how == "missing":
        lines = None
    got_lines = lines
    if how == "columns":
        got_lines = {k: [r[k] for r in lines] for k in lines[0]}
    elif how == "frame":
        got_lines = pd.DataFrame(lines)
    want = je.slate_market_table(GAMES, jax_, None if lines is None else pd.DataFrame(lines))
    rows = te.slate_market_rows(GAMES, port, got_lines)
    assert all(isinstance(r, dict) for r in rows)
    assert_table_equal(pd.DataFrame(rows), want)
    assert_table_equal(te.slate_market_table(GAMES, port, got_lines), want)
    if lines is not None:
        assert want["spread"].notna().all() and want["total"].isna().sum() == 1
    text = _printed(je.print_slate_edges, want)
    assert _printed(te.print_slate_edges, rows) == text
    assert _printed(te.print_slate_edges, te.slate_market_table(GAMES, port, got_lines)) == text


def test_slate_market_table_unmatched_and_short_lines_match_jax():
    """(h) A team_a naming no game leaves it unpriced; positional lines
    shorter than the slate price the first games only."""
    port, jax_ = _summaries(5)
    lines = [{"team_a": "Nowhere U", "spread": -3.5, "total": 44.5},
             {"team_a": "team-002", "spread": 2.5, "total": 51.0}]
    want = je.slate_market_table(GAMES, jax_, pd.DataFrame(lines))
    assert_table_equal(te.slate_market_table(GAMES, port, lines), want)
    assert want["spread"].notna().sum() == 1
    short = [{"spread": -1.5}, {"total": 40.0}]
    want = je.slate_market_table(GAMES, jax_, pd.DataFrame(short))
    assert_table_equal(te.slate_market_table(GAMES, port, short), want)
    assert _printed(te.print_slate_edges, te.slate_market_rows(GAMES, port, short)) == \
        _printed(je.print_slate_edges, want)


def _hand_summary(module, margin_counts: dict, total_counts: dict, n: int):
    """tests/test_slate_edges.py's hand-built summary, for either package."""
    mh = np.zeros(2 * ja.MARGIN_OFF)
    for m, c in margin_counts.items():
        mh[m + ja.MARGIN_OFF] = c
    th = np.zeros(2 * ja.MAX_PTS)
    for t, c in total_counts.items():
        th[t] = c
    return module.ScoreSummary(
        n=np.float32(n), mean_pts=np.zeros(2), sd_pts=np.zeros(2), win_rate=np.zeros(2),
        tie_rate=np.float32(0.0), pts_hist=np.zeros((2, ja.MAX_PTS)), margin_hist=mh,
        total_hist=th)


def test_slate_market_table_hand_counts_match_jax():
    """(h) tests/test_slate_edges.py's hand counts: cover 60/100 at -2.5,
    over 75/100 at 45.5, a game with no line, and the underdog sides by
    position; the port's rows, table and printed view equal the JAX
    package's."""
    args = (({3: 60, -7: 30, 0: 10}, {40: 25, 50: 75}, 100), ({10: 80, -3: 20}, {55: 100}, 100))
    games = [("Alpha St.", "Beta"), ("Gamma", "Delta")]
    lines = [{"team_a": "Alpha St.", "spread": -2.5, "total": 45.5}]
    port = [_hand_summary(ta, *a) for a in args]
    want = je.slate_market_table(games, [_hand_summary(ja, *a) for a in args],
                                 pd.DataFrame(lines))
    got = te.slate_market_table(games, port, lines)
    assert_table_equal(got, want)
    r = got.iloc[0]
    be = te.breakeven_minus110()
    assert r.p_cover_a == pytest.approx(0.6) and r.fair_cover_a == te.prob_to_american(0.6)
    assert r.p_over == pytest.approx(0.75)
    assert (r.spread_bet, r.total_bet) == ("Alpha St. -2.5", "Over 45.5")
    assert r.spread_edge_pct == pytest.approx(100 * (0.6 - be), abs=0.01)
    assert r.total_edge_pct == pytest.approx(100 * (0.75 - be), abs=0.01)
    assert got.iloc[1].p_win_a == pytest.approx(0.8)
    assert pd.isna(got.iloc[1].spread) and pd.isna(got.iloc[1].total)
    text = _printed(te.print_slate_edges, got)
    assert text == _printed(je.print_slate_edges, want)
    assert "Slate Market Edges" in text and "Alpha St." in text
    # the underdog sides, lines matched by position
    dog = [_hand_summary(m, {3: 30, -7: 70}, {40: 80, 50: 20}, 100) for m in (ta, ja)]
    pos = [{"spread": -2.5, "total": 45.5}]
    got = te.slate_market_table([("A", "B")], dog[:1], pos)
    assert_table_equal(got, je.slate_market_table([("A", "B")], dog[1:], pd.DataFrame(pos)))
    assert (got.iloc[0].spread_bet, got.iloc[0].total_bet) == ("B +2.5", "Under 45.5")
    empty = te.slate_market_rows([], [], None)
    assert empty == [] and _printed(te.print_slate_edges, empty) == \
        _printed(je.print_slate_edges, pd.DataFrame())


@pytest.mark.parametrize("center,width,step", [(-3.5, 12.0, 1.0), (44.5, 6.0, 0.5),
                                               (0.0, 2.0, 1.0), (7.0, 0.0, 1.0)])
def test_ladder_lines_match_jax(center, width, step):
    np.testing.assert_array_equal(te.ladder_lines(center, width, step),
                                  je.ladder_lines(center, width, step))


def test_ladder_and_middle_errors_match_jax():
    for mod in (te, je):
        with pytest.raises(ValueError, match="ladder step must be positive"):
            mod.ladder_lines(3.0, 6.0, 0.0)
    d = te.summary_margin_dist(_summaries()[0][0])
    jd = je.summary_margin_dist(_summaries()[1][0])
    for dist, mod in ((d, te), (jd, je)):
        with pytest.raises(ValueError, match="middle window is empty"):
            mod.middle_odds(dist, 7.0, 3.0)


CALS = [None, (dict(margin_shift=-1.5, margin_scale=1.1, total_shift=2.0, total_scale=0.9))]


@pytest.mark.parametrize("cal", CALS)
@pytest.mark.parametrize("spread,total", [(-3.5, 44.5), (3.0, None), (None, 52.0)])
def test_alt_lines_from_summary_match_jax(cal, spread, total):
    """(h) The spread and total ladders off one summary, with and without
    a calibration: rows, DataFrames and printed ladders equal."""
    port, jax_ = _summaries(9)
    kw = dict(spread=spread, total=total, width=6.0, step=0.5)
    got = te.alt_line_rows_from_summary(
        port[1], "Team 002", "Team 003", **kw,
        calibration=te.MarketCalibration(**cal) if cal else None)
    want = je.alt_lines_from_summary(
        jax_[1], "Team 002", "Team 003", **kw,
        calibration=je.MarketCalibration(**cal) if cal else None)
    assert list(got) == list(want)
    frames = te.alt_lines_from_summary(
        port[1], "Team 002", "Team 003", **kw,
        calibration=te.MarketCalibration(**cal) if cal else None)
    for k in want:
        assert len(got[k]) == 25
        pd.testing.assert_frame_equal(pd.DataFrame(got[k]), want[k], check_exact=True)
        pd.testing.assert_frame_equal(frames[k], want[k], check_exact=True)
    assert _printed(te.print_alt_lines, got) == _printed(je.print_alt_lines, want)
    assert _printed(te.print_alt_lines, frames) == _printed(je.print_alt_lines, want)


def test_alt_tables_match_jax():
    """(h) alt_spread_table and alt_total_table on the same Dist, at -110
    and at another price."""
    port, jax_ = _summaries(11)
    md, jmd = te.summary_margin_dist(port[2]), je.summary_margin_dist(jax_[2])
    td, jtd = te.summary_total_dist(port[2]), je.summary_total_dist(jax_[2])
    for price in (-110, +105):
        spreads, totals = te.ladder_lines(-2.5, 8.0), te.ladder_lines(47.0, 8.0, 0.5)
        pd.testing.assert_frame_equal(te.alt_spread_table(md, "A", "B", spreads, price),
                                      je.alt_spread_table(jmd, "A", "B", spreads, price),
                                      check_exact=True)
        assert te.alt_total_rows(td, totals, price) == \
            je.alt_total_table(jtd, totals, price).to_dict("records")
        pd.testing.assert_frame_equal(te.alt_total_table(td, totals, price),
                                      je.alt_total_table(jtd, totals, price),
                                      check_exact=True)
    assert te.alt_spread_rows(md, "A", "B", []) == []
    assert _printed(te.print_alt_lines, {"spread": [], "total": []}) == \
        _printed(je.print_alt_lines, {"spread": pd.DataFrame(), "total": pd.DataFrame()}) == ""


@pytest.mark.parametrize("mid_spread,mid_total,price", [
    ((-3.5, 7.5), (41.5, 47.5), -110), ((-3.0, 7.0), (44.0, 48.0), -105),
    ((2.5, -0.5), None, +100), (None, (40.0, 41.0), -120)])
def test_middles_match_jax(mid_spread, mid_total, price):
    """(h) middles_from_summary, spread_middle, total_middle and
    middle_odds on the same summary (pushes on whole-number lines), and
    the printed middle, equal the JAX package's."""
    port, jax_ = _summaries(13)
    got = te.middles_from_summary(port[3], "Team 006", "Team 007", mid_spread=mid_spread,
                                  mid_total=mid_total, price=price)
    want = je.middles_from_summary(jax_[3], "Team 006", "Team 007", mid_spread=mid_spread,
                                   mid_total=mid_total, price=price)
    assert got == want and list(got) == list(want)
    for res in got.values():
        assert _printed(te.print_middle_readable, res) == \
            _printed(je.print_middle_readable, res)
    md, jmd = te.summary_margin_dist(port[3]), je.summary_margin_dist(jax_[3])
    assert te.middle_odds(md, 3.0, 7.0, price_low=-110, price_high=+120) == \
        je.middle_odds(jmd, 3.0, 7.0, price_low=-110, price_high=+120)
    bare = te.middle_odds(md, -1.0, 10.0)
    assert _printed(te.print_middle_readable, bare) == _printed(je.print_middle_readable, bare)
    td, jtd = te.summary_total_dist(port[3]), je.summary_total_dist(jax_[3])
    assert te.total_middle(td, 44.0, 50.0, price_over=-115) == \
        je.total_middle(jtd, 44.0, 50.0, price_over=-115)
    assert te.spread_middle(md, "A", "B", -7.0, 10.0, price_opp=+110) == \
        je.spread_middle(jmd, "A", "B", -7.0, 10.0, price_opp=+110)

"""The port's multi-leg markets against the JAX package: leg resolution,
same-game parlays, leg correlations, round robins (same-game and over
blocks), teasers, cross-game tickets, their printers and
`simulate_parlay`.

Both packages settle the same score and player-stat arrays: the JAX side
through `jnp` stand-ins for a GameState (`tests/test_parlay.py:_Out`), the
port's through tensors on the CPU.  The cases: the hand-countable 6-game
case of `tests/test_parlay.py`, a seeded 4,096-game case with whole lines
(pushes), and a port `run_pairs(2,048, collect_players=True)` run on the
CPU with the focus-roster fixture teams.  Counts are integers and every
probability is derived on the host in the same order, so the result dicts
are equal; correlations agree within 1e-6 with NaN in the same cells."""
import contextlib
import io
import itertools
import math
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest
import torch

from fast_monte_carlo_tpu import api as japi
from fast_monte_carlo_tpu import edge as jedge
from fast_monte_carlo_tpu_torch import api, edge, fixtures
from fast_monte_carlo_tpu_torch.config import SimConfig
from tests.test_parlay import LEG_SETS, _Ctx, _Out

from test_torch_support import FOCUS_SEED, TABLE_SEED, jax_teams, write_focus
from test_torch_support import table_cache_off  # noqa: F401 (autouse)

torch.set_num_threads(1)

RUN_PAIRS = 2048

HAND_SCORE = np.array([[28, 24], [24, 28], [30, 30], [28, 24], [45, 10], [20, 21]])


def _hand_pstats():
    """`tests/test_parlay.py`'s 6-game player stats."""
    ps = np.zeros((6, 2, 3, 1, 6), dtype=np.float32)
    ps[:, 0, 0, 0, 2] = [260, 240, 250, 300, 0, 250.5]
    ps[:, 1, 1, 0, 2] = [80, 120, 60, 99.5, 140, 30]
    return ps


def _ctxs():
    return (_Ctx("Alpha", qb=["QB A"], rush=["RB A"], target=["WR A"]),
            _Ctx("Beta", qb=["QB B"], rush=["RB B"], target=["WR B"]))


def _seeded():
    """4,096 games with whole scores and whole passing yards: whole lines
    push."""
    rng = np.random.default_rng(7)
    n = 4096
    score = rng.integers(0, 60, size=(n, 2))
    ps = np.zeros((n, 2, 3, 1, 6), dtype=np.float32)
    ps[:, 0, 0, 0, 2] = rng.integers(0, 400, size=n)
    ps[:, 1, 2, 0, 2] = rng.integers(0, 150, size=n)
    return score, ps


SEEDED_LEGS = [
    {"kind": "spread", "team": "Alpha", "line": -3.0},
    {"kind": "total", "side": "over", "line": 52.0},
    {"kind": "moneyline", "team": "Beta"},
    {"kind": "prop", "team": "Alpha", "player": "QB A", "stat": "pass_yds",
     "side": "over", "line": 250.0},
    {"kind": "prop", "team": "Beta", "player": "WR B", "stat": "rec_yards",
     "side": "under", "line": 70.0},
]


def focus_legs():
    """Six legs on the focus-roster fixture teams: a spread, a moneyline,
    a whole and a half-point total and two prop legs (one by alias)."""
    return [
        {"kind": "spread", "team": "Team A", "line": 6.5},
        {"kind": "moneyline", "team": "Team A"},
        {"kind": "total", "side": "over", "line": 40},
        {"kind": "total", "side": "under", "line": 70.5},
        {"kind": "prop", "team": "Team A", "player": "Team A Passer 1", "stat": "pass_yds",
         "side": "over", "line": 150.5},
        {"kind": "prop", "team": "team b", "player": "Team B Receiver 1", "stat": "rec_yards",
         "side": "under", "line": 60.5},
    ]


@pytest.fixture(scope="module")
def focus_run(tmp_path_factory):
    """The port's props run on the CPU (focus teams, seed-7 nano table)
    and the JAX package's contexts of the same focus sheet."""
    d = tmp_path_factory.mktemp("parlay")
    a, b = fixtures.focus_teams(FOCUS_SEED)
    runner = api.MatchupRunner(a, b, None, SimConfig(), nano_tables=fixtures.nano_tables(
        TABLE_SEED), device="cpu")
    out = runner.run_pairs(RUN_PAIRS, seed=9, collect_players=True, collect_stats=False)
    return dict(runner=runner, a=a, b=b, ja_jb=jax_teams(8, write_focus(d / "focus.csv")),
                score=out.score.numpy(), pstats=out.pstats.numpy())


def _case(name, focus_run):
    """(port contexts, JAX contexts, score, pstats, leg sets) of a case."""
    if name == "hand":
        a, b = _ctxs()
        return (a, b), (a, b), HAND_SCORE, _hand_pstats(), LEG_SETS
    if name == "seeded":
        a, b = _ctxs()
        score, ps = _seeded()
        return (a, b), (a, b), score, ps, [SEEDED_LEGS, SEEDED_LEGS[:2]]
    legs = focus_legs()
    return ((focus_run["a"], focus_run["b"]), focus_run["ja_jb"], focus_run["score"],
            focus_run["pstats"], [legs, legs[:3], legs[4:]])


def _outs(score, pstats):
    """(port stand-in, JAX stand-in) GameStates over the same arrays."""
    return (SimpleNamespace(score=torch.as_tensor(score, dtype=torch.int32),
                            pstats=torch.as_tensor(pstats, dtype=torch.float32)),
            _Out(score, pstats))


def same(got, want) -> bool:
    """Equal, NaN equal to NaN, dicts and lists element by element."""
    if isinstance(want, dict):
        return isinstance(got, dict) and list(got) == list(want) and all(
            same(got[k], want[k]) for k in want)
    if isinstance(want, (list, tuple)):
        return len(got) == len(want) and all(same(x, y) for x, y in zip(got, want))
    if isinstance(want, float) and math.isnan(want):
        return isinstance(got, float) and math.isnan(got)
    return got == want and type(got) is type(want)


def printed(fn, *args) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue()


CASES = ["hand", "seeded", "run"]


@pytest.mark.parametrize("case", CASES)
def test_resolve_parlay_legs_equal_jax(case, focus_run):
    (a, b), (ja, jb), _, _, leg_sets = _case(case, focus_run)
    for legs in leg_sets:
        (got, gmeta), (want, wmeta) = (edge.resolve_parlay_legs(a, b, legs),
                                       jedge.resolve_parlay_legs(ja, jb, legs))
        assert gmeta == wmeta
        assert len(got) == len(want) == 8
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


BAD_LEGS = [
    [{"kind": "moneyline", "team": "Gamma"}],
    [{"kind": "prop", "team": "Alpha", "player": "QB A", "stat": "yeets", "side": "over",
      "line": 1}],
    [{"kind": "prop", "team": "Alpha", "player": "Nobody", "stat": "pass_yds",
      "side": "over", "line": 1}],
    [{"kind": "total", "side": "above", "line": 55}],
    [{"kind": "prop", "team": "Alpha", "player": "QB A", "stat": "pass_yds", "line": 1}],
    [{"kind": "teaser", "team": "Alpha"}],
    [],
    ["moneyline"],
    [{"kind": "spread", "team": "Alpha", "line": -3.5}, 7],
]


@pytest.mark.parametrize("legs", BAD_LEGS)
def test_resolve_parlay_legs_errors_equal_jax(legs):
    a, b = _ctxs()
    with pytest.raises(ValueError) as want:
        jedge.resolve_parlay_legs(a, b, legs)
    with pytest.raises(ValueError) as got:
        edge.resolve_parlay_legs(a, b, legs)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("price", [None, -110, 450])
@pytest.mark.parametrize("case", CASES)
def test_parlay_odds_equal_jax(case, price, focus_run):
    (a, b), (ja, jb), score, ps, leg_sets = _case(case, focus_run)
    out, jout = _outs(score, ps)
    for legs in leg_sets:
        got = edge.parlay_odds(out, a, b, legs, price=price)
        want = jedge.parlay_odds(jout, ja, jb, legs, price=price)
        assert same(got, want), (got, want)
        assert got["n"] == len(score)
        resolved = edge.resolve_parlay_legs(a, b, legs)
        assert same(edge.parlay_odds(out, a, b, None, price=price, resolved=resolved), want)
    if case == "hand":
        # a leg that never wins: p_independent 0, so correlation_mult is NaN
        legs = [{"kind": "total", "side": "over", "line": 500}]
        got, want = (edge.parlay_odds(out, a, b, legs), jedge.parlay_odds(jout, a, b, legs))
        assert math.isnan(got["correlation_mult"]) and same(got, want)


def test_reduce_parlay_counts_on_the_device_of_the_scores():
    """The counts are integers over the games, in one packed host copy."""
    a, b = _ctxs()
    arrays, _ = edge.resolve_parlay_legs(a, b, LEG_SETS[3])
    score = torch.as_tensor(HAND_SCORE, dtype=torch.int32)
    red = edge.reduce_parlay_device(score, torch.as_tensor(_hand_pstats()), arrays)
    assert all(v.dtype == torch.int64 and v.device == score.device for v in red.values())
    host = edge._host_counts(red)
    assert list(host) == ["leg_win", "leg_push", "all_win", "no_lose", "all_push"]
    assert host["leg_win"].shape == (4,) and host["all_win"].shape == ()
    for k, v in red.items():
        np.testing.assert_array_equal(host[k], v.numpy())


def test_prop_legs_need_player_stats_as_in_jax():
    a, b = _ctxs()
    dummy = np.zeros((6, 1, 1, 1, 1), np.float32)
    out, jout = _outs(HAND_SCORE, dummy)
    prop = [{"kind": "prop", "team": "Alpha", "player": "QB A", "stat": "pass_yds",
             "side": "over", "line": 1}]
    for fn, jfn in ((edge.parlay_odds, jedge.parlay_odds),
                    (edge.parlay_correlations, jedge.parlay_correlations),
                    (edge.round_robin, jedge.round_robin)):
        with pytest.raises(ValueError) as want:
            jfn(jout, a, b, prop)
        with pytest.raises(ValueError, match="collect_players=True") as got:
            fn(out, a, b, prop)
        assert str(got.value) == str(want.value)
    # game legs read pstats cell 0 of the 1-element dummy
    legs = LEG_SETS[0] + LEG_SETS[1]
    assert same(edge.parlay_odds(out, a, b, legs), jedge.parlay_odds(jout, a, b, legs))


NEVER = {"kind": "total", "side": "over", "line": 500}
ALWAYS = {"kind": "total", "side": "under", "line": 500}


@pytest.mark.parametrize("case", CASES)
def test_parlay_correlations_within_1e6(case, focus_run):
    """A leg that never wins, and one that always does, have NaN rows and
    columns.  The always-winning leg is held to the JAX package only where
    the game count is a power of two (4,096 here): at 6 games the JAX
    package's compiled float32 leaves it a variance of a few ulps (XLA
    multiplies by 1/B), and so finite correlations, where the port's is 0."""
    (a, b), (ja, jb), score, ps, leg_sets = _case(case, focus_run)
    out, jout = _outs(score, ps)
    extra = [NEVER] if case == "hand" else [NEVER, ALWAYS]
    legs = leg_sets[0] + extra
    got = edge.parlay_correlations(out, a, b, legs)
    want = jedge.parlay_correlations(jout, ja, jb, legs)
    assert list(got.index) == list(want.index) and list(got.columns) == list(want.columns)
    g, w = got.to_numpy(), want.to_numpy()
    assert g.dtype == w.dtype == np.float64
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    k = len(extra)
    assert np.isnan(g[-k:]).all() and np.isnan(g[:, -k:]).all()
    assert not np.isnan(g[:-k, :-k]).any()
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    labels, mat = edge.parlay_correlation_matrix(out, a, b, legs)
    assert labels == list(want.index)
    np.testing.assert_array_equal(mat, g)
    if case == "hand":
        _, mat = edge.parlay_correlation_matrix(out, a, b, legs + [ALWAYS])
        assert np.isnan(mat[-1]).all() and np.isnan(mat[:, -1]).all()


@pytest.mark.parametrize("by", [1, 2, (2, 3)])
@pytest.mark.parametrize("case", CASES)
def test_round_robin_equal_jax(case, by, focus_run):
    (a, b), (ja, jb), score, ps, leg_sets = _case(case, focus_run)
    out, jout = _outs(score, ps)
    legs = leg_sets[-1] if case == "hand" else leg_sets[0]
    for price in (None, 260):
        got = edge.round_robin(out, a, b, legs, by=by, price=price)
        want = jedge.round_robin(jout, ja, jb, legs, by=by, price=price)
        assert same(got, want)
    # every ticket is the parlay of its legs alone
    combos = [c for k in got["by"] for c in itertools.combinations(range(len(legs)), k)]
    for t, c in zip(got["tickets"], combos):
        p = edge.parlay_odds(out, a, b, [legs[j] for j in c], price=260)
        assert all(t[k] == p[k] for k in ("p_all_win", "p_lose", "p_void", "p_win_reduced",
                                          "p_parlay", "fair_american", "edge_pct", "ev_$100",
                                          "kelly"))


@pytest.mark.parametrize("by", [5, 0, [], True, [2.5], [2, True], "23", b"2", np.bool_(True),
                                [2, np.bool_(True)], 2.5])
def test_round_robin_size_refusals_equal_jax(by):
    a, b = _ctxs()
    score, ps = _seeded()
    out, jout = _outs(score, ps)
    legs = SEEDED_LEGS[:4]
    with pytest.raises(ValueError) as want:
        jedge.round_robin(jout, a, b, legs, by=by)
    with pytest.raises(ValueError) as got:
        edge.round_robin(out, a, b, legs, by=by)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        jedge._rr_sizes(by, 4)
    with pytest.raises(ValueError) as got:
        edge._rr_sizes(by, 4)
    assert str(got.value) == str(want.value)


def test_round_robin_max_tickets_equal_jax():
    a, b = _ctxs()
    score, ps = _seeded()
    out, jout = _outs(score, ps)
    with pytest.raises(ValueError, match="max_tickets") as got:
        edge.round_robin(out, a, b, SEEDED_LEGS, by=(2, 3), max_tickets=19)
    with pytest.raises(ValueError) as want:
        jedge.round_robin(jout, a, b, SEEDED_LEGS, by=(2, 3), max_tickets=19)
    assert str(got.value) == str(want.value)
    got = edge.round_robin(out, a, b, SEEDED_LEGS, by=(2, 3), max_tickets=20)
    assert got["n_tickets"] == 20
    assert edge._rr_sizes(np.int64(2), 3) == jedge._rr_sizes(np.int64(2), 3) == [2]
    assert edge._rr_sizes((3, 1, 3.0), 3) == jedge._rr_sizes((3, 1, 3.0), 3) == [1, 3]


def _blocks(mod, outs, legs_by_game):
    """One parlay block per game (hand, seeded, and a third small game)."""
    names = [("Alpha", "Beta"), ("Gamma", "Delta"), ("Eps", "Zeta")]
    blocks = []
    for (ta, tb), out, legs in zip(names, outs, legs_by_game):
        a, b = _Ctx(ta, qb=[f"QB {ta}"]), _Ctx(tb, qb=[f"QB {tb}"])
        blocks.append(mod.parlay_odds(out, a, b, legs))
    return blocks


def _three_games(port: bool):
    small = np.array([[10, 13], [20, 3], [31, 28], [7, 24], [17, 17]])
    score, _ = _seeded()
    arrays = [(HAND_SCORE, np.zeros((6, 1, 1, 1, 1), np.float32)),
              (score, np.zeros((len(score), 1, 1, 1, 1), np.float32)),
              (small, np.zeros((5, 1, 1, 1, 1), np.float32))]
    return [_outs(s, p)[0 if port else 1] for s, p in arrays]


BLOCK_LEGS = [[{"kind": "spread", "team": "Alpha", "line": -3.5},
               {"kind": "total", "side": "over", "line": 52}],
              [{"kind": "moneyline", "team": "Gamma"}],
              [{"kind": "spread", "team": "Zeta", "line": 3}]]


@pytest.mark.parametrize("price", [None, 700])
def test_cross_game_parlay_and_blocks_equal_jax(price):
    got_blocks = _blocks(edge, _three_games(True), BLOCK_LEGS)
    want_blocks = _blocks(jedge, _three_games(False), BLOCK_LEGS)
    assert same(got_blocks, want_blocks)
    for sub in ([0, 1], [0, 1, 2], [2]):
        got = edge.cross_game_parlay([got_blocks[i] for i in sub], price=price)
        want = jedge.cross_game_parlay([want_blocks[i] for i in sub], price=price)
        assert same(got, want)
        assert got["p_all_win"] == round(float(np.prod(
            [got_blocks[i]["p_all_win"] for i in sub])), 6)
    for by in (1, 2, (2, 3)):
        assert same(edge.round_robin_blocks(got_blocks, by=by, price=price),
                    jedge.round_robin_blocks(want_blocks, by=by, price=price))


def test_cross_game_refusals_equal_jax():
    blocks = _blocks(edge, _three_games(True), BLOCK_LEGS)
    again = dict(blocks[0], team="BETA", opp="alpha")
    for bad in ([], [blocks[0], again], [blocks[0], blocks[0]]):
        with pytest.raises(ValueError) as want:
            jedge.cross_game_parlay(bad)
        with pytest.raises(ValueError) as got:
            edge.cross_game_parlay(bad)
        assert str(got.value) == str(want.value)
    for by in (4, [], "12"):
        with pytest.raises(ValueError) as want:
            jedge.round_robin_blocks(blocks, by=by)
        with pytest.raises(ValueError) as got:
            edge.round_robin_blocks(blocks, by=by)
        assert str(got.value) == str(want.value)


TEASE = [{"kind": "spread", "team": "Alpha", "line": -7.5},
         {"kind": "total", "side": "Over", "line": 52.5},
         {"kind": "total", "side": "under", "line": 41, "note": "kept"}]


@pytest.mark.parametrize("points", [0, 6, 6.5, 10])
def test_tease_legs_equal_jax(points):
    got, want = edge.tease_legs(TEASE, points), jedge.tease_legs(TEASE, points)
    assert same(got, want)
    assert got[0]["line"] == -7.5 + points and TEASE[0]["line"] == -7.5


@pytest.mark.parametrize("legs,points", [
    (TEASE, -1), ([{"kind": "moneyline", "team": "Alpha"}], 6),
    ([{"kind": "prop", "team": "Alpha"}], 6), ([{"kind": "total", "side": "x", "line": 4}], 6),
    (["spread"], 6)])
def test_tease_legs_refusals_equal_jax(legs, points):
    with pytest.raises(ValueError) as want:
        jedge.tease_legs(legs, points)
    with pytest.raises(ValueError) as got:
        edge.tease_legs(legs, points)
    assert str(got.value) == str(want.value)


def test_teaser_prices_as_a_parlay_at_moved_lines():
    """A teased ticket on the same games: every leg at least as likely."""
    a, b = _ctxs()
    score, ps = _seeded()
    out, jout = _outs(score, ps)
    legs = TEASE[:2]
    base, teased = (edge.parlay_odds(out, a, b, x) for x in (legs, edge.tease_legs(legs, 6)))
    assert same(teased, jedge.parlay_odds(jout, a, b, jedge.tease_legs(legs, 6)))
    assert teased["p_all_win"] >= base["p_all_win"]
    assert all(t["p_win"] >= p["p_win"] for t, p in zip(teased["legs"], base["legs"]))


def test_printers_equal_jax(focus_run):
    (a, b), (ja, jb), score, ps, leg_sets = _case("run", focus_run)
    out, jout = _outs(score, ps)
    legs = leg_sets[0]
    for price in (None, 600):
        got = edge.parlay_odds(out, a, b, legs, price=price)
        want = jedge.parlay_odds(jout, ja, jb, legs, price=price)
        assert printed(edge.print_parlay_readable, got) == \
            printed(jedge.print_parlay_readable, want)
        rr = edge.round_robin(out, a, b, legs, by=(2, 3), price=price)
        jrr = jedge.round_robin(jout, ja, jb, legs, by=(2, 3), price=price)
        text = printed(edge.print_round_robin_readable, rr)
        assert text == printed(jedge.print_round_robin_readable, jrr) and "35 tickets" in text
    blocks = _blocks(edge, _three_games(True), BLOCK_LEGS)
    jblocks = _blocks(jedge, _three_games(False), BLOCK_LEGS)
    for price in (None, 700):
        cross = edge.cross_game_parlay(blocks, price=price)
        assert printed(edge.print_parlay_readable, cross) == printed(
            jedge.print_parlay_readable, jedge.cross_game_parlay(jblocks, price=price))
        rb = edge.round_robin_blocks(blocks, by=2, price=price)
        assert printed(edge.print_round_robin_readable, rb) == printed(
            jedge.print_round_robin_readable, jedge.round_robin_blocks(jblocks, by=2,
                                                                       price=price))


def _parlay_kw():
    return dict(n_pairs=512, seed=5, price=450, correlations=True, round_robin=(2, 3))


def test_simulate_parlay_equals_its_parts(focus_run):
    """simulate_parlay: one run_pairs of the seed (players collected for
    the prop legs, no box score), priced by parlay_odds, the correlation
    matrix and the round robin of that one run."""
    runner = focus_run["runner"]
    a, b = runner.team_a, runner.team_b
    legs = focus_legs()
    res = api.simulate_parlay("Team A", "Team B", legs, runner=runner, **_parlay_kw())
    out = runner.run_pairs(512, seed=5, collect_players=True, collect_stats=False)
    want = edge.parlay_odds(out, a, b, legs, price=450)
    assert same({k: v for k, v in res.items() if k not in ("leg_corr", "round_robin")}, want)
    pd.testing.assert_frame_equal(res["leg_corr"], edge.parlay_correlations(out, a, b, legs))
    assert same(res["round_robin"], edge.round_robin(out, a, b, legs, by=(2, 3), price=450))
    core = api.simulate_parlay_core("Team A", "Team B", legs, runner=runner, **_parlay_kw())
    labels, mat = core["leg_corr"]
    assert labels == list(res["leg_corr"].index)
    np.testing.assert_array_equal(mat, res["leg_corr"].to_numpy())
    # without a prop leg the run collects no player stats
    calls = []
    real = runner.run_pairs

    def spy(*args, **kw):
        calls.append(kw)
        return real(*args, **kw)

    runner.run_pairs = spy
    try:
        api.simulate_parlay_core("team a", "TEAM B", legs[:4], runner=runner, n_pairs=64)
        api.simulate_parlay_core("Team A", "Team B", legs, runner=runner, n_pairs=64)
    finally:
        del runner.run_pairs
    assert [(c["collect_players"], c["collect_stats"]) for c in calls] == [
        (False, False), (True, False)]


def test_simulate_parlay_matches_jax_on_the_same_games(focus_run, monkeypatch):
    """The JAX package's simulate_parlay, its SP+ reads and runner stubbed
    to hand it the port's run of the same seed, returns the same dict (the
    correlations within 1e-6)."""
    runner = focus_run["runner"]
    ja, jb = focus_run["ja_jb"]
    legs = focus_legs()
    got = api.simulate_parlay("Team A", "Team B", legs, runner=runner, **_parlay_kw())
    out = runner.run_pairs(512, seed=5, collect_players=True, collect_stats=False)
    monkeypatch.setattr(japi, "_prepared_contexts", lambda *a, **k: (None, ja, jb, None))
    monkeypatch.setattr(japi, "_runner_for", lambda *a, **k: SimpleNamespace(
        run_pairs=lambda *a, **k: _Out(out.score.numpy(), out.pstats.numpy())))
    want = japi.simulate_parlay("Team A", "Team B", legs, sp_path="unread.csv",
                                **_parlay_kw())
    assert list(got) == list(want)
    assert same({k: v for k, v in got.items() if k != "leg_corr"},
                {k: v for k, v in want.items() if k != "leg_corr"})
    assert list(got["leg_corr"].index) == list(want["leg_corr"].index)
    np.testing.assert_allclose(got["leg_corr"].to_numpy(), want["leg_corr"].to_numpy(),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("legs,rr", [
    ([{"kind": "moneyline", "team": "Team C"}], None),
    ([{"kind": "prop", "team": "Team A", "player": "Nobody", "stat": "pass_yds",
       "side": "over", "line": 1}], None),
    ([], None),
    (None, 5),
    (None, "23"),
    (None, [2.5]),
])
def test_simulate_parlay_refuses_before_any_launch(focus_run, legs, rr):
    """A bad leg or size spec raises before run_pairs is called."""
    runner = focus_run["runner"]

    def fail(*a, **k):
        raise AssertionError("run_pairs launched")

    runner.run_pairs = fail
    try:
        with pytest.raises(ValueError):
            api.simulate_parlay_core("Team A", "Team B",
                                     focus_legs()[:3] if legs is None else legs,
                                     runner=runner, round_robin=rr)
        # and a good request does reach run_pairs
        with pytest.raises(AssertionError, match="launched"):
            api.simulate_parlay_core("Team A", "Team B", focus_legs()[:3], runner=runner,
                                     round_robin=2)
    finally:
        del runner.run_pairs


def test_simulate_parlay_needs_a_runner(focus_run):
    """A parlay needs a runner or an SP+ sheet, not both (the sheet route:
    tests/test_torch_routes.py)."""
    legs = focus_legs()[:2]
    for kw in (dict(sp_path="sp.csv"), dict(focus_csv="f.csv")):
        with pytest.raises(ValueError, match="not both"):
            api.simulate_parlay("Team A", "Team B", legs, runner=focus_run["runner"], **kw)
    with pytest.raises(ValueError, match="runner="):
        api.simulate_parlay("Team A", "Team B", legs)
    # trial sharding in a world of one prices the same games
    got = api.simulate_parlay_core("Team A", "Team B", legs, runner=focus_run["runner"],
                                   shard=True, n_pairs=256, seed=2, correlations=True)
    want = api.simulate_parlay_core("Team A", "Team B", legs, runner=focus_run["runner"],
                                    n_pairs=256, seed=2, correlations=True)
    from fast_monte_carlo_tpu_torch.serve import jsonable

    assert got.keys() == want.keys()
    assert repr(jsonable(got)) == repr(jsonable(want))
    with pytest.raises(ValueError, match="the runner plays Team A vs Team B"):
        api.simulate_parlay("Team B", "Team A", legs, runner=focus_run["runner"])


@pytest.mark.parametrize("case", CASES)
def test_smoke_host_settlement_equals_the_port(case, focus_run):
    """chip_smoke.np_settle, the numpy settlement the smoke holds the
    card's counts to, gives the port's win and push masks."""
    import chip_smoke

    (a, b), _, score, ps, leg_sets = _case(case, focus_run)
    out, _ = _outs(score, ps)
    for legs in leg_sets:
        arrays, _ = edge.resolve_parlay_legs(a, b, legs)
        win, push = chip_smoke.np_settle(np.asarray(score), ps, arrays)
        w, p = edge._settle_legs(out.score, out.pstats, arrays)
        np.testing.assert_array_equal(win, w.numpy())
        np.testing.assert_array_equal(push, p.numpy())

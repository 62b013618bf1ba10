"""The port's season win totals against the JAX package: `season_win_pmf`,
`season_win_market` and `print_season_readable` on the same per-game win
probabilities, and `project_season` over a fixture schedule on the CPU
(`fixtures.season`), whose per-game rows are the port's own slate summary
rows; the JAX `project_season`, its slate run stubbed to return those rows,
builds the same market and schedule."""
import contextlib
import io

import numpy as np
import pandas as pd
import pytest
import torch

from fast_monte_carlo_tpu import api as japi
from fast_monte_carlo_tpu import edge as jedge
from fast_monte_carlo_tpu_torch import api, edge, fixtures
from test_torch_support import table_cache_off  # noqa: F401 (autouse)

torch.set_num_threads(1)

SEASON_SEED = 13
SEASON_GAMES = 3
PAIRS, CHUNK = 96, 64                 # 2 launches of 64 pairs a game

P_WINS = [
    [],
    [0.5],
    [1.0, 0.5],
    [0.0, 1.0],
    [0.5, 0.5],
    [0.9, 0.42, 0.65, 0.5, 0.08, 0.77],
    [0.61] * 12,
    list(np.random.default_rng(3).uniform(0, 1, 9)),
]


@pytest.mark.parametrize("ps", P_WINS)
def test_season_win_pmf_equal_jax(ps):
    got, want = edge.season_win_pmf(ps), jedge.season_win_pmf(ps)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ps", [[0.5, 1.2], [float("nan")], [-0.1], [0.3, float("inf")]])
def test_season_win_pmf_errors_equal_jax(ps):
    with pytest.raises(ValueError) as want:
        jedge.season_win_pmf(ps)
    with pytest.raises(ValueError, match="not a probability") as got:
        edge.season_win_pmf(ps)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as got:
        edge.season_win_market(ps, line=1.5)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("line", [None, 0, 1, 1.5, 2, 6.5, 7])
@pytest.mark.parametrize("price", [-110, 120])
@pytest.mark.parametrize("ps", P_WINS[2:])
def test_season_win_market_equal_jax(ps, line, price):
    got = edge.season_win_market(ps, line=line, team="X", price=price)
    want = jedge.season_win_market(ps, line=line, team="X", price=price)
    assert got == want
    assert list(got) == list(want)


def _printed(fn, res) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(res)
    return buf.getvalue()


@pytest.mark.parametrize("line", [None, 1, 2.5])
def test_print_season_readable_equal_jax(line):
    for team in ("", "Team 000"):
        res = edge.season_win_market(P_WINS[5], line=line, team=team)
        text = _printed(edge.print_season_readable, res)
        assert text == _printed(jedge.print_season_readable,
                                jedge.season_win_market(P_WINS[5], line=line, team=team))
        assert "P(at least k wins)" in text


def _season_kw(**kw):
    games, contexts, tables = fixtures.season(SEASON_GAMES, SEASON_SEED)
    return games, dict(contexts=contexts, nano_tables=tables, n_pairs=PAIRS, chunk_pairs=CHUNK,
                       seed=4, device="cpu", **kw)


@pytest.fixture(scope="module")
def season_run():
    """The port's project_season over the fixture schedule, and the slate
    summary rows of the same games and seed."""
    games, kw = _season_kw()
    rows, _ = api.simulate_slate_summary_rows(games, **kw)
    res = api.project_season("Team 000", games=games, line=1.5, price=-120, **kw)
    return games, rows, res


def test_season_fixture_puts_the_team_on_both_sides():
    games, contexts, tables = fixtures.season(SEASON_GAMES, SEASON_SEED)
    assert games == [("Team 000", "Team 001"), ("Team 002", "Team 000"),
                     ("Team 000", "Team 003")]
    assert [(a.name, b.name) for a, b in contexts] == games
    assert contexts[0][0] is contexts[1][1] and len(tables) == SEASON_GAMES


def test_project_season_reads_the_slate_rows(season_run):
    """p_wins are the slate rows' strict win rates of the team's side; the
    market is season_win_market of them; the schedule is those rows with
    the team's side, its rounded p_win and the opponent."""
    games, rows, res = season_run
    sides = ["a", "b", "a"]
    p = [r[f"win_{s}"] for r, s in zip(rows, sides)]
    assert res["p_wins"] == [round(x, 6) for x in p]
    want = edge.season_win_market(p, line=1.5, team="Team 000", price=-120)
    assert {k: v for k, v in res.items() if k != "schedule"} == want
    assert abs(sum(res["pmf"]) - 1.0) < 1e-5
    sched = res["schedule"]
    assert list(sched.columns) == list(rows[0]) + ["team_side", "p_win_team", "opponent"]
    assert list(sched["team_side"]) == sides
    assert list(sched["opponent"]) == ["Team 001", "Team 002", "Team 003"]
    np.testing.assert_array_equal(sched["p_win_team"].to_numpy(), np.round(p, 6))
    pd.testing.assert_frame_equal(sched[list(rows[0])], pd.DataFrame(rows))
    assert (sched["n_games"] == 2 * 2 * CHUNK).all()
    core = api.project_season_rows("Team 000", games=games, line=1.5, price=-120,
                                   **_season_kw()[1])
    assert core["schedule"] == sched.to_dict("records")


def test_project_season_matches_jax_on_the_same_rows(season_run, monkeypatch):
    """The JAX project_season, its slate run stubbed to return the port's
    rows, gives the same market dict and schedule frame."""
    games, rows, res = season_run
    seen = {}

    def fake_slate(g, **kw):
        seen.update(kw, games=g)
        return pd.DataFrame(rows)

    monkeypatch.setattr(japi, "simulate_slate_summaries", fake_slate)
    want = japi.project_season("Team 000", games=games, line=1.5, price=-120,
                               sp_path="unread.csv", n_pairs=PAIRS, chunk_pairs=CHUNK, seed=4)
    assert seen["games"] == games and seen["n_pairs"] == PAIRS
    assert {k: v for k, v in res.items() if k != "schedule"} == \
        {k: v for k, v in want.items() if k != "schedule"}
    pd.testing.assert_frame_equal(res["schedule"], want["schedule"], check_exact=True)
    # opponents=: the team is side A of every game
    opp = ["Team 001", "Team 003"]
    _, kw = _season_kw()
    ctx = [kw["contexts"][0], kw["contexts"][2]]
    tabs = [kw["nano_tables"][0], kw["nano_tables"][2]]
    sub_kw = dict(kw, contexts=ctx, nano_tables=tabs)
    got = api.project_season("Team 000", opponents=opp, **sub_kw)
    sub, _ = api.simulate_slate_summary_rows([("Team 000", o) for o in opp], **sub_kw)
    assert sub[0] == rows[0]                 # game 0 keeps its key
    monkeypatch.setattr(japi, "simulate_slate_summaries", lambda g, **k: pd.DataFrame(sub))
    want = japi.project_season("Team 000", opponents=opp, sp_path="unread.csv")
    assert {k: v for k, v in got.items() if k != "schedule"} == \
        {k: v for k, v in want.items() if k != "schedule"}
    pd.testing.assert_frame_equal(got["schedule"], want["schedule"], check_exact=True)


@pytest.mark.parametrize("args", [
    dict(),
    dict(opponents=["Team 001"], games=[("Team 000", "Team 001")]),
    dict(games=[("Team 001", "Team 002")]),
    dict(games=[("Team 000", "Team 001"), ("Team 002", "Team 003")]),
])
def test_project_season_argument_errors_equal_jax(args, monkeypatch):
    monkeypatch.setattr(japi, "simulate_slate_summaries", lambda *a, **k: pytest.fail("ran"))
    with pytest.raises(ValueError) as want:
        japi.project_season("Team 000", sp_path="unread.csv", **args)
    with pytest.raises(ValueError) as got:
        api.project_season("Team 000", **args)
    assert str(got.value) == str(want.value)


def test_project_season_needs_built_inputs(season_run):
    """A season needs contexts or an SP+ sheet, not both (the sheet route:
    tests/test_torch_routes.py); trial sharding in a world of one projects
    the unsharded season."""
    games, kw = _season_kw()
    for extra in (dict(sp_path="sp.csv"), dict(focus_csv="f.csv")):
        with pytest.raises(ValueError, match="not both"):
            api.project_season("Team 000", games=games, **dict(kw, **extra))
    with pytest.raises(ValueError, match="contexts="):
        api.project_season("Team 000", games=games)
    with pytest.raises(ValueError, match="3 games need as many context pairs"):
        api.project_season("Team 000", games=games, **dict(kw, contexts=kw["contexts"][:2]))
    got = api.project_season("Team 000", games=games, line=1.5, price=-120, shard=True, **kw)
    want = season_run[2]
    pd.testing.assert_frame_equal(got.pop("schedule"), want["schedule"])
    assert repr(got) == repr({k: v for k, v in want.items() if k != "schedule"})

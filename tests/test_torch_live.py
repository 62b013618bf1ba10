"""Live win probability in the PyTorch port against the JAX package.

Exact where both sides compute the same thing: `state_from_situation` field
for field on 1,000 seeded situations, the situation parser and its bounds
(results and error messages), and the entry points' rows on one shared
summary.  Within 4 Monte-Carlo standard errors where the two draw different
streams (Philox here, threefry in the JAX package off the TPU): `run_live`
and `run_live_batch` against the JAX runner at the same n, in analytic
mode."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import fast_monte_carlo_tpu.api as japi
from fast_monte_carlo_tpu.config import SimConfig as JaxSimConfig
from fast_monte_carlo_tpu.ops import game as jg
from fast_monte_carlo_tpu.parallel import aggregate as ja
from fast_monte_carlo_tpu_torch import api
from fast_monte_carlo_tpu_torch.config import SimConfig
from fast_monte_carlo_tpu_torch.ops import game as tg
from fast_monte_carlo_tpu_torch.ops.rng import root_key
from fast_monte_carlo_tpu_torch.parallel import aggregate as ta

from test_torch_support import (jax_analytic_runner, jax_pack, port_analytic_runner,
                                port_pack, random_situations, situation_from_numpy,
                                within)
from test_torch_support import table_cache_off  # noqa: F401 (autouse)

torch.set_num_threads(1)

N_SIT = 1000
N_GAMES = 4096
# Q4 05:00, 2nd-and-7 at the opponent's 40, 21-17; and a Q2 drive, 10-14
Q4 = tg.Situation(offense=0, sec=300, down=2, dist=7.0, ytg=40.0, score_a=21, score_b=17)
Q2 = tg.Situation(offense=1, sec=2400, down=1, dist=10.0, ytg=68.0, score_a=10, score_b=14)


def _same_state(got, want, what=""):
    for f in tg.GameState._fields:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype and g.shape == w.shape, (what, f, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {f}")


@pytest.mark.parametrize("collect", [False, True])
def test_state_from_situation_matches_jax_per_trial(collect):
    """1,000 seeded situations as (n,) fields, one per trial, with the
    collectors off (1-element dummies) and on: every field exact."""
    d = random_situations(np.random.default_rng(21), N_SIT)
    jcfg, cfg = JaxSimConfig(), SimConfig()
    want = jg.state_from_situation(N_SIT, situation_from_numpy(d, module=jg), jcfg, 8,
                                   collect_players=collect, collect_stats=collect)
    got = tg.state_from_situation(N_SIT, situation_from_numpy(d), cfg, "cpu", k=8,
                                  collect_players=collect, collect_stats=collect)
    _same_state(got, want)
    # the clocks at the ends of quarters take the tick formula's period
    assert set(np.unique(got.period.numpy())) == {1, 2, 3, 4}


def test_state_from_situation_matches_jax_scalar():
    """The same 1,000 situations one at a time, as Python numbers for a
    batch of 3 games each: every field exact."""
    d = random_situations(np.random.default_rng(21), N_SIT)
    jcfg, cfg = JaxSimConfig(), SimConfig()
    for i in range(N_SIT):
        want = jg.state_from_situation(3, situation_from_numpy(d, i, jg), jcfg, 8,
                                       game_id=1, collect_players=False, collect_stats=False)
        got = tg.state_from_situation(3, situation_from_numpy(d, i), cfg, "cpu", game_id=1,
                                      k=8, collect_players=False, collect_stats=False)
        _same_state(got, want, f"situation {i}")


@pytest.mark.parametrize("offense", [0, 1])
def test_kickoff_situation_equals_initial_state(offense):
    """The kickoff situation rebuilds the JAX package's initial_state field
    for field (dtypes and shapes too), with both collectors on and off; the
    port's initial_state is that situation."""
    cfg, jcfg = SimConfig(), JaxSimConfig()
    kick = tg.Situation(offense, cfg.clock.game_seconds, 1, cfg.opening_distance,
                        cfg.kickoff_spot, 0, 0)
    for collect in (True, False):
        live = tg.state_from_situation(32, kick, cfg, "cpu", k=8, collect_players=collect,
                                       collect_stats=collect)
        want = jg.initial_state(32, offense, jcfg, 8, collect_players=collect,
                                collect_stats=collect)
        _same_state(live, want)
        _same_state(tg.initial_state(32, offense, cfg, "cpu", k=8, collect_players=collect,
                                     collect_stats=collect), want)
    _same_state(live, jg.state_from_situation(32, jg.Situation(*kick), jcfg, 8,
                                              collect_players=False, collect_stats=False))


def test_simulate_games_resumes_from_a_situation():
    """situation= and init_state=state_from_situation(...) play the same
    games; the kickoff situation plays the games of a kickoff start; and
    init_state must hold n games."""
    cfg = SimConfig()
    pack = port_pack(jax_pack())
    he = tg.make_analytic_heads_eval(cfg)
    key = root_key(9)
    kw = dict(collect_players=False, collect_stats=False)
    a = tg.simulate_games(pack, cfg, he, None, key, 512, 0, situation=Q2, **kw)
    init = tg.state_from_situation(512, Q2, cfg, "cpu", k=pack.k, **kw)
    b = tg.simulate_games(pack, cfg, he, None, key, 512, 1, init_state=init, **kw)
    assert torch.equal(a.score, b.score) and (a.sec == 0).all()
    kick = tg.Situation(1, 3600, 1, 10.0, 75.0, 0, 0)
    c = tg.simulate_games(pack, cfg, he, None, key, 256, 0, situation=kick, **kw)
    d = tg.simulate_games(pack, cfg, he, None, key, 256, 1, **kw)
    assert torch.equal(c.score, d.score)
    with pytest.raises(ValueError, match="init_state holds 512"):
        tg.simulate_games(pack, cfg, he, None, key, 256, 0, init_state=init, **kw)


PARSE_CASES = [
    dict(ytg=30, offense="B", quarter=4, clock="05:12", down=2, dist=7, score_a=21,
         score_b=17),
    dict(ytg=30, sec=100),
    dict(ytg=30, quarter=1),
    dict(ytg=12.5, offense=" a ", quarter=2, clock="00:01", down=4, dist=1.5),
    dict(ytg=30),
    dict(ytg=30, quarter=5),
    dict(ytg=30, quarter=0, clock="01:00"),
    dict(ytg=30, sec=10, offense="C"),
]


@pytest.mark.parametrize("kw", PARSE_CASES)
def test_situation_from_fields_matches_jax(kw):
    """The same Situation (values and Python types) or the same error."""
    try:
        want = japi.situation_from_fields(**kw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            api.situation_from_fields(**kw)
        assert str(got.value) == str(e)
        return
    got = api.situation_from_fields(**kw)
    assert tuple(got) == tuple(want)
    assert [type(v) for v in got] == [type(v) for v in want]


BAD = [dict(offense=2), dict(sec=0), dict(sec=3601), dict(down=0), dict(down=5),
       dict(ytg=0.5), dict(ytg=99.5), dict(dist=0.0), dict(dist=99.5),
       dict(score_a=128), dict(score_b=-1), dict(score_a=np.int64(200)),
       dict(sec=np.float32(4000.0))]


@pytest.mark.parametrize("bad", BAD)
def test_validated_situation_matches_jax(bad):
    """The same bounds and messages (scores under 128, the histograms'
    support); tensors pass through, as traced values do in JAX."""
    sit = Q4._replace(**bad)
    with pytest.raises(ValueError) as want:
        japi._validated_situation(jg.Situation(*sit), JaxSimConfig())
    with pytest.raises(ValueError) as got:
        api._validated_situation(sit, SimConfig())
    assert str(got.value) == str(want.value)
    t = Q4._replace(**{k: torch.tensor(v) for k, v in bad.items()})
    assert api._validated_situation(t, SimConfig()) is t


def test_device_situation_has_fixed_dtypes():
    s = api._device_situation(Q4, torch.device("cpu"))
    assert [v.dtype for v in s] == [torch.int32] * 3 + [torch.float32] * 2 + [torch.int32] * 2
    assert all(v.dim() == 0 for v in s) and float(s.ytg) == 40.0
    b = api._device_situation(tg.Situation(*([v, v] for v in Q4)), torch.device("cpu"))
    assert all(v.shape == (2,) for v in b)


def _close(got, want, n: int, i=None):
    """win rates and mean points of two summaries (an S row with i) within
    4 standard errors of their difference."""
    pick = (lambda x: np.asarray(x)) if i is None else (lambda x: np.asarray(x)[i])
    gw, ww = pick(got.win_rate), pick(want.win_rate)
    gm, wm = pick(got.mean_pts), pick(want.mean_pts)
    gs, ws = pick(got.sd_pts), pick(want.sd_pts)
    for side in (0, 1):
        p = (gw[side] + ww[side]) / 2
        assert within(float(gw[side]), float(ww[side]), p, n), (side, gw, ww)
        se = np.sqrt((gs[side] ** 2 + ws[side] ** 2) / n)
        assert abs(gm[side] - wm[side]) <= 4 * se + 1e-6, (side, gm, wm, se)


@pytest.mark.parametrize("sit", [Q4, Q2], ids=["q4", "q2"])
def test_run_live_matches_jax(sit):
    """run_live at 4,096 games against the JAX runner's, in 2 launches."""
    got = port_analytic_runner().run_live(sit, n_games=N_GAMES, seed=1, chunk_games=2048)
    want = jax_analytic_runner().run_live(jg.Situation(*sit), n_games=N_GAMES, seed=1,
                                          chunk_games=2048)
    assert float(got.n) == float(want.n) == N_GAMES
    _close(got, want, N_GAMES)
    assert int(got.margin_hist.sum()) == N_GAMES
    assert float(got.mean_pts[0]) >= sit.score_a and float(got.mean_pts[1]) >= sit.score_b


def test_run_live_rounds_up_and_is_seeded():
    r = port_analytic_runner()
    s1 = r.run_live(Q4, n_games=300, seed=4, chunk_games=200)
    s2 = r.run_live(Q4, n_games=300, seed=4, chunk_games=200)
    s3 = r.run_live(Q4, n_games=300, seed=5, chunk_games=200)
    assert float(s1.n) == 400
    assert torch.equal(s1.margin_hist, s2.margin_hist)
    assert not torch.equal(s1.margin_hist, s3.margin_hist)
    # a blowout with seconds left is decided
    s = r.run_live(Q4._replace(sec=20, score_a=35, score_b=7), n_games=256)
    assert float(s.win_rate[0]) == 1.0
    with pytest.raises(ValueError, match="n_games"):
        r.run_live(Q4, n_games=0)
    with pytest.raises(ValueError, match="score_a"):
        r.run_live(Q4._replace(score_a=128), n_games=8)


BATCH = [Q4, Q2, Q4._replace(score_a=17, score_b=21),
         tg.Situation(0, 3600, 1, 10.0, 75.0, 0, 0)]


def test_run_live_batch_matches_jax():
    """4 situations x 2,048 games in one call against the JAX runner's:
    each row within 4 standard errors, n exact, rows in input order."""
    n = 2048
    got = port_analytic_runner().run_live_batch(BATCH, n_games_per=n, seed=2)
    want = jax_analytic_runner().run_live_batch([jg.Situation(*s) for s in BATCH],
                                                n_games_per=n, seed=2)
    assert got.win_rate.shape == (4, 2) and got.margin_hist.shape == (4, 256)
    assert got.n.tolist() == [n] * 4 == np.asarray(want.n).tolist()
    for i in range(len(BATCH)):
        _close(got, want, n, i)
    assert (got.margin_hist.sum(1) == n).all()
    # the trailing team leads its own row
    assert float(got.win_rate[0, 0]) > float(got.win_rate[2, 0])


def test_run_live_batch_rows_equal_run_live():
    """Each row of the curve against run_live of its situation alone."""
    n = 2048
    r = port_analytic_runner()
    batch = r.run_live_batch(BATCH[:3], n_games_per=n, seed=3)
    for i, sit in enumerate(BATCH[:3]):
        alone = r.run_live(sit, n_games=n, seed=30 + i)
        assert float(alone.n) == float(batch.n[i]) == n
        _close(ta.ScoreSummary(*(x[i] for x in batch)), alone, n)


def test_batched_moments_match_jax_vmap():
    """Per-situation moments from one bincount against jax.vmap of the
    JAX package's score_moments: counts and histograms exact, the finished
    summaries close."""
    import jax

    rng = np.random.default_rng(5)
    s = rng.poisson(24, (5, 999, 2)).astype(np.int32)
    s[:, :20] = rng.integers(0, 200, (5, 20, 2))      # past the histograms
    got = ta.score_moments(torch.from_numpy(s))
    want = jax.vmap(ja.score_moments)(jnp.asarray(s))
    for f in ("n", "wins", "ties", "s_sum", "pts_hist", "margin_hist", "total_hist"):
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    gs, ws = ta.summary_from_moments(got), jax.vmap(ja.summary_from_moments)(want)
    for f in ws._fields:
        np.testing.assert_allclose(getattr(gs, f).numpy(), np.asarray(getattr(ws, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)
    for i in range(5):     # row i is the moments of group i alone
        one = ta.score_moments(torch.from_numpy(s[i]))
        assert all(torch.equal(getattr(got, f)[i], getattr(one, f)) for f in one._fields)


def test_run_live_batch_validation_and_shard():
    r = port_analytic_runner()
    with pytest.raises(ValueError, match="at least one"):
        r.run_live_batch([])
    with pytest.raises(ValueError, match="n_games_per"):
        r.run_live_batch([Q4], n_games_per=0)
    with pytest.raises(ValueError, match="down"):
        r.run_live_batch([Q4, Q4._replace(down=5)])
    # trial sharding in a world of one: the same games, bit for bit
    rs = dataclasses.replace(r, shard=True)
    assert rs.group.world == 1 and rs.device == r.device
    want = r.run_live(Q4, n_games=512, seed=3, chunk_games=256)
    got = rs.run_live(Q4, n_games=512, seed=3, chunk_games=256)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    row, s = api.simulate_live_game("A", "B", Q4, runner=r, shard=True, n_games=512, seed=3)
    row0, s0 = api.simulate_live_game("A", "B", Q4, runner=r, n_games=512, seed=3)
    assert row == row0 and all(np.array_equal(g, w, equal_nan=True) for g, w in zip(s, s0))


def _shared_summary(stacked: bool):
    """One ScoreSummary as numpy, from seeded scores (a leading S = 3 axis
    when stacked); the JAX twin holds the same numbers."""
    rng = np.random.default_rng(8)
    s = rng.poisson(24, (3, 500, 2) if stacked else (500, 2)).astype(np.int32)
    t = ta.summary_from_moments(ta.score_moments(torch.from_numpy(s)))
    host = ta.ScoreSummary(*(x.numpy() for x in t))
    return t, ja.ScoreSummary(*(jnp.asarray(x) for x in host))


def test_simulate_live_game_row_matches_jax(monkeypatch):
    """On one shared summary the row is the JAX package's, key for key and
    value for value; the summary comes back as numpy."""
    t, j = _shared_summary(False)
    r, jr = port_analytic_runner(), jax_analytic_runner()
    monkeypatch.setattr(r, "run_live", lambda *a, **k: t)
    monkeypatch.setattr(jr, "run_live", lambda *a, **k: j)
    monkeypatch.setattr(japi, "_prepared_runner", lambda *a, **k: (jr, None, None, jr.cfg))
    row, s = api.simulate_live_game("Team A", "Team B", Q4, runner=r)
    want, ws = japi.simulate_live_game("Team A", "Team B", jg.Situation(*Q4), sp_path="")
    assert list(row) == list(want) and row == want
    assert [type(v) for v in row.values()] == [type(v) for v in want.values()]
    for f in ws._fields:
        g, w = getattr(s, f), np.asarray(getattr(ws, f))
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


def test_simulate_live_curve_matches_jax(monkeypatch):
    """The curve's columns and frame on one shared stacked summary equal
    the JAX package's frame (pandas' assert_frame_equal)."""
    t, j = _shared_summary(True)
    sits = BATCH[:3]
    r, jr = port_analytic_runner(), jax_analytic_runner()
    monkeypatch.setattr(r, "run_live_batch", lambda *a, **k: t)
    monkeypatch.setattr(jr, "run_live_batch", lambda *a, **k: j)
    monkeypatch.setattr(japi, "_prepared_runner", lambda *a, **k: (jr, None, None, jr.cfg))
    want, _ = japi.simulate_live_curve("Team A", "Team B", [jg.Situation(*s) for s in sits],
                                       sp_path="")
    cols, s = api.simulate_live_curve_columns("Team A", "Team B", sits, runner=r)
    assert all(isinstance(v, np.ndarray) for v in cols.values())
    pd.testing.assert_frame_equal(pd.DataFrame(cols), want)
    df, _ = api.simulate_live_curve("Team A", "Team B", sits, runner=r)
    pd.testing.assert_frame_equal(df, want)
    assert s.win_rate.shape == (3, 2)


def test_live_entry_points_end_to_end():
    """simulate_live_game and the curve on a real runner: rows well formed,
    n exact; with neither a runner nor an SP+ sheet each raises ValueError,
    and so does a runner with a sheet (tests/test_torch_routes.py drives
    the sheet route)."""
    r = port_analytic_runner()
    row, s = api.simulate_live_game("Team A", "Team B", Q4, runner=r, n_games=512)
    assert row["n_games"] == 512 and abs(row["win_a"] + row["win_b"] + row["tie"] - 1) < 1e-6
    assert row["mean_a"] >= 21 and int(s.margin_hist.sum()) == 512
    df, _ = api.simulate_live_curve("Team A", "Team B", BATCH[:2], runner=r, n_games_per=256)
    assert len(df) == 2 and (df["n_games"] == 256).all() and list(df["sec"]) == [300, 2400]
    for fn, args in ((api.simulate_live_game, (Q4,)), (api.simulate_live_curve, ([Q4],)),
                     (api.evaluate_fourth_down, (Q4._replace(down=4),))):
        with pytest.raises(ValueError, match="needs sp_path= .* or runner="):
            fn("Team A", "Team B", *args)
        with pytest.raises(ValueError, match="not both"):
            fn("Team A", "Team B", *args, runner=r, sp_path="sp.csv")

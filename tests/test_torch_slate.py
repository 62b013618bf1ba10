"""The PyTorch port's weekly slate against the JAX package: one play step
and whole games of a multi-matchup slate on injected draws (direction row
gid*2 + off into one pack and one nano table), the slate against each
matchup's own runner, `SlateRunner.summaries` and `run_summaries`, and
`simulate_slate_summaries` / `simulate_slate` with their layouts, memos
and errors.

The JAX side is built from the same fixtures by its own code
(`build_direction`, `pack_matchups`, `nano_from_fused`,
`pack_tables_multi`), not through `SlateRunner.__post_init__`, which reads
trained heads.  Where the JAX entry points read an SP+ sheet, the tests
stub the reads and hand both packages the same summaries or scores."""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from fast_monte_carlo_tpu import api as japi
from fast_monte_carlo_tpu.config import SimConfig as JaxSimConfig
from fast_monte_carlo_tpu.config import resolve_nano_select
from fast_monte_carlo_tpu.data.context import _build
from fast_monte_carlo_tpu.matchup import build_direction as jax_direction
from fast_monte_carlo_tpu.models import tables as jt
from fast_monte_carlo_tpu.models.heads import ModelHeads
from fast_monte_carlo_tpu.ops import game as jg
from fast_monte_carlo_tpu.ops import table_lookup as jtl
from fast_monte_carlo_tpu.ops.pack import pack_matchups as jax_pack_matchups
from fast_monte_carlo_tpu.parallel import aggregate as ja
from fast_monte_carlo_tpu_torch import api, fixtures
from fast_monte_carlo_tpu_torch.config import SimConfig
from fast_monte_carlo_tpu_torch.ops import game as tg
from fast_monte_carlo_tpu_torch.ops.rng import fold_in, root_key
from fast_monte_carlo_tpu_torch.parallel import aggregate as ta

from test_torch_support import (FLOAT_FIELDS, INT_FIELDS, flips_back, jax_host, jax_state,
                                port_state, row_mismatch)
from test_torch_support import table_cache_off  # noqa: F401 (autouse)

torch.set_num_threads(1)

G, SLATE_SEED = 3, 21


def _slate():
    return fixtures.slate(G, SLATE_SEED)


def _runner(game_shard: bool = False, g: int = G, seed: int = SLATE_SEED, cfg=None):
    matchups, tables = fixtures.slate(g, seed)
    return api.SlateRunner(matchups, None, cfg or SimConfig(), game_shard=game_shard,
                           nano_tables=tables, device="cpu")


def _jax_cfg(**engine):
    c = JaxSimConfig()
    return c.replace(engine=dataclasses.replace(c.engine, **engine)) if engine else c


def jax_slate(jcfg, g: int = G, seed: int = SLATE_SEED):
    """(JAX contexts, JAX MatchupPack, JAX nano TableHeads) of
    `fixtures.slate(g, seed)`, each built by the JAX package's own code."""
    rows = fixtures.slate_teams(g, seed)
    ctx = [_build(*r, {}, ".", 8) for r in rows]
    matchups = [(ctx[2 * i], ctx[2 * i + 1]) for i in range(g)]
    dirs = []
    for a, b in matchups:
        dirs += [jax_direction(a, b, ModelHeads(), jcfg),
                 jax_direction(b, a, ModelHeads(), jcfg)]
    prof = jt.nano_profile()
    pairs = []
    for i in range(g):
        pairs.append(tuple(
            jt.TableSet(stage1=None, stage2=None, pq=None, rq=None, sq=None, fumble=None,
                        play=None, fine=jt.fine_profile(), coarse=jt.coarse_profile(),
                        nano=jt.nano_from_fused(jax_host(t), prof))
            for t in fixtures.fused_tables(seed + i)))
    return matchups, jax_pack_matchups(dirs), jtl.pack_tables_multi(pairs, k=8, nano_prof=prof)


def _heads(mode: str, sr, jhs):
    """(jax heads_eval, jax state, port heads_eval, port state)."""
    if mode == "analytic":
        return (jg.make_analytic_heads_eval(JaxSimConfig()), None,
                tg.make_analytic_heads_eval(SimConfig()), None)
    jcfg = resolve_nano_select(JaxSimConfig(), collect_stats=False)
    return jtl.make_table_heads_eval(jcfg), jhs, sr.heads_fn, sr.heads_state


def test_slate_fixture_teams_and_tables():
    """Distinct team names from "Team 000", SP+ numbers inside the FBS
    range, one seeded nano table pair per matchup; the slate's lines sit
    near each game's means, one total left out, one name in capitals."""
    matchups, tables = fixtures.slate(4, 9)
    names = [t.name for m in matchups for t in m]
    assert names == [f"Team {i:03d}" for i in range(8)]
    for t in (t for m in matchups for t in m):
        assert fixtures.SLATE_OFFENSE[0] <= t.sp_offense <= fixtures.SLATE_OFFENSE[1]
        assert fixtures.SLATE_DEFENSE[0] <= t.sp_defense <= fixtures.SLATE_DEFENSE[1]
        assert abs(t.sp_rating - (t.sp_offense - t.sp_defense)) <= 1.1
    for i, (ta_, tb_) in enumerate(tables):
        want = fixtures.nano_tables(9 + i)
        np.testing.assert_array_equal(ta_.values, want[0].values)
        np.testing.assert_array_equal(tb_.values, want[1].values)
    assert not np.array_equal(tables[0][0].values, tables[1][0].values)
    rows = [{"team_a": a.name, "mean_margin_a": 3.0 * i, "mean_total": 40.0 + i}
            for i, (a, _) in enumerate(matchups)]
    lines = fixtures.slate_lines(rows, 5)
    assert lines[0]["team_a"] == "TEAM 000" and lines[1]["total"] is None
    for r, q in zip(rows, lines):
        assert abs(q["spread"] + r["mean_margin_a"]) <= 3.25 and q["spread"] * 2 % 1 == 0
        assert q["total"] is None or abs(q["total"] - r["mean_total"]) <= 7.25


@pytest.mark.parametrize("mode", ["analytic", "table"])
def test_slate_play_step_matches_jax_on_injected_draws(mode):
    """(a) One play step of a G = 3 slate, each state on a random matchup:
    every integer field equals the JAX step's in every row."""
    n = 12000
    rng = np.random.default_rng(31)
    d = fixtures.play_states(rng, n)
    d["gid"] = rng.integers(0, G, n).astype(np.int32)
    u, z = fixtures.play_draws(rng, (n,))
    sr = _runner()
    _, jpack, jhs = jax_slate(JaxSimConfig())
    jhe, jhs, he, hs = _heads(mode, sr, jhs)
    jcfg = JaxSimConfig()
    want = jax.jit(lambda s, uu, zz, h: jg.play_step(
        s, jax.random.PRNGKey(0), jpack, jcfg, jhe, h, False, False, draws=(uu, zz)))(
        jax_state(d), jnp.asarray(u), jnp.asarray(z), jhs)
    got = tg.play_step(port_state(d), (torch.from_numpy(u), torch.from_numpy(z)),
                       sr.pack, SimConfig(), he, hs)
    bad = row_mismatch(want, got)
    assert not bad.any(), f"{bad.sum()} of {n} rows differ"
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    # the matchups play differently: the same states on matchup 0 alone differ
    d0 = dict(d, gid=np.zeros(n, np.int32))
    other = tg.play_step(port_state(d0), (torch.from_numpy(u), torch.from_numpy(z)),
                         sr.pack, SimConfig(), he, hs)
    assert (other.score != got.score).any(dim=1).sum() > 10


@pytest.mark.parametrize("mode", ["analytic", "table"])
def test_slate_whole_games_match_jax_on_one_draw_table(mode):
    """(b) 3 matchups x 256 games fed one (max_plays, B, 17) draw table on
    both sides: at least 98% of games end equal on every integer field,
    and each game that differs first does so at a step where the port,
    given the JAX state, reaches the JAX outcome under a 1e-4 nudge of
    one draw (a threshold flip)."""
    b = G * 256
    cfg, jcfg = SimConfig(), JaxSimConfig()
    steps = cfg.engine.max_plays
    rng = np.random.default_rng(32)
    u, z = fixtures.play_draws(rng, (steps, b))
    sr = _runner()
    _, jpack, jhs = jax_slate(jcfg)
    jhe, jhs, he, hs = _heads(mode, sr, jhs)
    gid = np.arange(b) // 256
    fo = np.arange(b) % 2

    def run_jax(h, uu, zz):
        s0 = jg.initial_state(b, jnp.asarray(fo, jnp.int32), jcfg, 8,
                              jnp.asarray(gid, jnp.int32), collect_players=False,
                              collect_stats=False)

        def body(s, xs):
            s1 = jg.play_step(s, jax.random.PRNGKey(0), jpack, jcfg, jhe, h, False, False,
                              draws=xs)
            return s1, s1

        return s0, jax.lax.scan(body, s0, (uu, zz))[1]

    s0, traj = jax.jit(run_jax)(jhs, jnp.asarray(u), jnp.asarray(z))
    traj = {f: np.asarray(getattr(traj, f)) for f in jg.GameState._fields}
    init = {f: np.asarray(getattr(s0, f)) for f in jg.GameState._fields}
    s = tg.initial_state(b, torch.from_numpy(fo), cfg, "cpu", torch.from_numpy(gid),
                         collect_players=False, collect_stats=False)
    ut, zt = torch.from_numpy(u), torch.from_numpy(z)
    first_diff = np.full(b, -1)
    for j in range(steps):
        s = tg.play_step(s, (ut[j], zt[j]), sr.pack, cfg, he, hs)
        diff = np.zeros(b, bool)
        for f in INT_FIELDS:
            m = getattr(s, f).numpy() != traj[f][j]
            diff |= m.any(axis=1) if m.ndim > 1 else m
        first_diff[(first_diff < 0) & diff] = j
    assert (s.sec == 0).all()
    differ = np.flatnonzero(first_diff >= 0)
    assert differ.size <= 0.02 * b, f"{differ.size} of {b} games differ"
    for i in differ:
        j = first_diff[i]
        before = init if j == 0 else {f: v[j - 1] for f, v in traj.items()}
        want = {f: traj[f][j][i] for f in INT_FIELDS}
        assert flips_back(before, i, u[j], z[j], want, sr.pack, he, hs), \
            f"game {i} differs at step {j} off any threshold"
    final = traj["score"][-1]
    for g in range(G):
        assert 10 < final[g * 256:(g + 1) * 256].mean() < 50


@pytest.mark.parametrize("mode", ["analytic", "table"])
def test_slate_equals_each_matchups_own_runner_on_its_rows(mode):
    """(c) A slate played on one injected draw table equals each matchup's
    MatchupRunner played on that matchup's rows of the same table, bitwise
    on every field: the gid offsets reach the matchup's pack and table
    rows."""
    per, steps = 128, 200
    cfg = SimConfig()
    rng = np.random.default_rng(33)
    u, z = (torch.from_numpy(x) for x in fixtures.play_draws(rng, (steps, G * per)))
    sr = _runner()
    matchups, tables = _slate()
    he = sr.heads_fn if mode == "table" else tg.make_analytic_heads_eval(cfg)
    hs = sr.heads_state if mode == "table" else None
    t = torch.arange(G * per, dtype=torch.int32)
    s = tg.initial_state(G * per, t % 2, cfg, "cpu", t // per, collect_players=False,
                         collect_stats=False)
    for j in range(steps):
        s = tg.play_step(s, (u[j], z[j]), sr.pack, cfg, he, hs)
    for g, ((a, b), tab) in enumerate(zip(matchups, tables)):
        r = api.MatchupRunner(a, b, None, cfg, mode=mode, nano_tables=tab, device="cpu")
        rows = slice(g * per, (g + 1) * per)
        sg = tg.initial_state(per, t[:per] % 2, cfg, "cpu", collect_players=False,
                              collect_stats=False)
        for j in range(steps):
            sg = tg.play_step(sg, (u[j][rows], z[j][rows]), r.pack, cfg, r.heads_fn,
                              r.heads_state)
        for f in INT_FIELDS + FLOAT_FIELDS:
            assert torch.equal(getattr(s, f)[rows], getattr(sg, f)), (g, f)
        assert torch.equal(s.gid[rows], torch.full((per,), g, dtype=torch.int32))


def test_slate_summaries_match_jax_on_the_same_scores():
    """(d) `SlateRunner.summaries` of a run equals the JAX method, called
    unbound on a stand-in with the JAX contexts, on the same scores."""
    sr = _runner()
    out = sr.run(48, seed=2)
    assert out.score.shape == (G * 96, 2) and (out.sec == 0).all()
    assert torch.equal(out.gid, torch.arange(G * 96, dtype=torch.int32) // 96)
    assert torch.equal(out.fo, torch.arange(G * 96, dtype=torch.int32) % 2)
    jm, _, _ = jax_slate(JaxSimConfig())
    want = japi.SlateRunner.summaries(SimpleNamespace(matchups=jm),
                                      SimpleNamespace(score=jnp.asarray(out.score.numpy())))
    got = sr.summaries(out)
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    assert pd.DataFrame(sr.summary_rows(out)).equals(got)
    assert list(got["n_games"]) == [96] * G


def test_run_summaries_equals_per_game_moments_of_its_launches():
    """(e) Each game's summary equals summary_from_moments of that game's
    rows of the same launches (launch ci under fold_in(root, ci),
    3 * 2*chunk_pairs games a launch), accumulated over the chunks: 200
    pairs round up to 2 launches of 128.  The rows are the summaries'."""
    sr = _runner(game_shard=True)
    rows, per_game = sr.run_summary_rows(200, seed=4, chunk_pairs=128)
    root, c = root_key(4), 256
    t = torch.arange(G * c, dtype=torch.int32)
    acc = [None] * G
    for ci in range(2):
        out = tg.simulate_games(sr.pack, sr.cfg, sr.heads_fn, sr.heads_state,
                                fold_in(root, ci), G * c, t % 2, False, t // c, False)
        for g in range(G):
            m = ta.score_moments(out.score[g * c:(g + 1) * c])
            acc[g] = m if acc[g] is None else acc[g] + m
    for g in range(G):
        want = ta.summary_from_moments(acc[g])
        for f in ta.ScoreSummary._fields:
            got, w = getattr(per_game[g], f), getattr(want, f).numpy()
            assert isinstance(got, (np.ndarray, np.generic)) and got.dtype == w.dtype, f
            np.testing.assert_array_equal(got, w, err_msg=f"game {g} {f}")
        a, b = sr.matchups[g]
        assert rows[g] == api._summary_row(a.name, b.name, per_game[g])
        assert rows[g]["n_games"] == 2 * c and int(per_game[g].margin_hist.sum()) == 2 * c
    df, summs = sr.run_summaries(200, seed=4, chunk_pairs=128, return_summaries=True)
    assert df.equals(pd.DataFrame(rows)) and len(summs) == G
    assert list(df.columns) == ["team_a", "team_b", "mean_a", "mean_b", "win_a", "win_b",
                                "mean_margin_a", "mean_total", "n_games"]


def test_slate_layout_errors_match_jax():
    """(e) run_summaries without game_shard and run with it raise the JAX
    package's errors; a mesh, a non-positive count, trained heads beside
    nano tables, nano tables under another quality, trial sharding and
    missing tables raise."""
    for port, stub, call in ((_runner(), SimpleNamespace(game_shard=False),
                              lambda r: r.run_summaries(8)),
                             (_runner(game_shard=True), SimpleNamespace(game_shard=True),
                              lambda r: r.run(8))):
        with pytest.raises(ValueError) as want:
            call(_unbound(stub))
        with pytest.raises(ValueError) as got:
            call(port)
        assert str(got.value) == str(want.value)
    sr = _runner(game_shard=True)
    with pytest.raises(TypeError, match="mesh"):
        sr.run_summaries(8, mesh=object())
    # a world of one: the one-card summaries, bit for bit
    from fast_monte_carlo_tpu_torch.parallel.mesh import trial_group
    pd.testing.assert_frame_equal(sr.run_summaries(8, mesh=trial_group("cpu")),
                                  sr.run_summaries(8))
    with pytest.raises(ValueError, match="positive"):
        sr.run_summaries(0)
    matchups, tables = _slate()
    with pytest.raises(ValueError, match="nano_tables are nano-layout tables"):
        api.SlateRunner(matchups, nano_tables=tables, quality="turbo", device="cpu")
    # trial sharding in a world of one plays the one-launch games
    shard_run = api.SlateRunner(matchups, nano_tables=tables, device="cpu", shard=True).run(8)
    one_run = api.SlateRunner(matchups, nano_tables=tables, device="cpu").run(8)
    assert all(torch.equal(x, y) for x, y in zip(shard_run, one_run))
    with pytest.raises(ValueError, match="nano_tables or heads, not both"):
        api.SlateRunner(matchups, heads=fixtures.heads(0), nano_tables=tables, device="cpu")
    with pytest.raises(ValueError, match="one nano table pair per matchup"):
        api.SlateRunner(matchups, nano_tables=tables[:2], device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        api.SlateRunner([], nano_tables=[], device="cpu")


def _unbound(stub):
    """A stand-in whose run / run_summaries are the JAX methods, unbound."""
    return SimpleNamespace(
        run_summaries=lambda *a, **k: japi.SlateRunner.run_summaries(stub, *a, **k),
        run=lambda *a, **k: japi.SlateRunner.run(stub, *a, **k))


def test_run_summaries_match_jax_shared_slate_within_mc_error():
    """(f) Per matchup, win rate and mean points of `run_summaries` lie
    within 4 standard errors of the JAX package's shared-slate
    `simulate_games` (game_id = gid) on the same tables."""
    pairs = 1024
    n = 2 * pairs
    sr = _runner(game_shard=True)
    _, per_game = sr.run_summary_rows(pairs, seed=7, chunk_pairs=pairs)
    jcfg = resolve_nano_select(_jax_cfg(scan_unroll=1), collect_stats=False)
    _, jpack, jhs = jax_slate(jcfg)
    he = jtl.make_table_heads_eval(jcfg)
    b = G * n
    out = jax.jit(lambda hs, fo, gid: jg.simulate_games(
        jpack, jcfg, he, hs, jax.random.PRNGKey(7), b, fo, collect_players=False,
        game_id=gid, collect_stats=False))(
        jhs, jnp.asarray(np.arange(b) % 2, jnp.int32), jnp.asarray(np.arange(b) // n,
                                                                  jnp.int32))
    want = jax.vmap(ja.summary_from_moments)(
        jax.vmap(ja.score_moments)(out.score.reshape(G, n, 2)))
    for g in range(G):
        got = per_game[g]
        assert float(got.n) == float(want.n[g]) == n
        for side in range(2):
            p, q = float(got.win_rate[side]), float(want.win_rate[g, side])
            se = np.sqrt((p * (1 - p) + q * (1 - q)) / n)
            assert abs(p - q) <= 4 * se, (g, side, p, q)
            mg, mw = float(got.mean_pts[side]), float(want.mean_pts[g, side])
            sd = float(want.sd_pts[g, side])
            assert abs(mg - mw) <= 4 * sd * np.sqrt(2 / n), (g, side, mg, mw)
        assert 10 < float(got.mean_pts.min()) and float(got.mean_pts.max()) < 50


def _stub_jax_reads(monkeypatch):
    """The JAX entry points read trained heads and an SP+ sheet first:
    stub both reads so their own checks and row building run."""
    monkeypatch.setattr(japi, "load_heads", lambda *a, **k: None)
    monkeypatch.setattr(japi, "load_sp_flex", lambda *a, **k: None)
    monkeypatch.setattr(japi, "build_team_context_from_sp_flex", lambda t, *a, **k: t)


GAMES = [(f"Team {2 * i:03d}", f"Team {2 * i + 1:03d}") for i in range(G)]


def test_simulate_slate_summaries_empty_slate_matches_jax():
    """(g) An empty slate returns an empty frame (and no summaries) before
    anything is read, in both packages."""
    want = japi.simulate_slate_summaries([], sp_path="unread.csv", n_pairs=8)
    pd.testing.assert_frame_equal(api.simulate_slate_summaries([], n_pairs=8), want)
    df, summs = api.simulate_slate_summaries([], return_summaries=True, sp_path="x")
    wdf, wsumms = japi.simulate_slate_summaries([], sp_path="x", return_summaries=True)
    pd.testing.assert_frame_equal(df, wdf)
    assert summs == wsumms == []
    assert api.simulate_slate_summary_rows([]) == ([], [])


def test_simulate_slate_summaries_loop_rows(monkeypatch):
    """(g) The loop: game gi is its runner's run_pairs_summary(key =
    fold_in(root, gi)); 'auto' is the loop on one card; the rows equal the
    JAX package's on the same summaries, and the summaries come back as
    numpy."""
    matchups, tables = _slate()
    kw = dict(contexts=matchups, nano_tables=tables, n_pairs=100, chunk_pairs=100, seed=6,
              device="cpu")
    df, summs = api.simulate_slate_summaries(GAMES, layout="loop", return_summaries=True,
                                             **kw)
    auto_rows, auto_summs = api.simulate_slate_summary_rows(GAMES, **kw)
    assert pd.DataFrame(auto_rows).equals(df)
    root = root_key(6)
    for gi, ((a, b), tab) in enumerate(zip(matchups, tables)):
        r = api.MatchupRunner(a, b, None, SimConfig(), nano_tables=tab, device="cpu")
        want = r.run_pairs_summary(100, key=fold_in(root, gi), chunk_pairs=100)
        for f in ta.ScoreSummary._fields:
            np.testing.assert_array_equal(getattr(summs[gi], f), getattr(want, f).numpy(),
                                          err_msg=f)
            np.testing.assert_array_equal(getattr(auto_summs[gi], f), getattr(summs[gi], f))
    assert list(df["n_games"]) == [200] * G
    # the JAX package's loop builds the same rows from the same summaries
    jsumms = iter([ja.ScoreSummary(*(jnp.asarray(x) for x in s)) for s in summs])
    _stub_jax_reads(monkeypatch)
    monkeypatch.setattr(japi, "_runner_for", lambda *a, **k: SimpleNamespace(
        run_pairs_summary=lambda *a, **k: next(jsumms)))
    want, wsumms = japi.simulate_slate_summaries(GAMES, sp_path="", n_pairs=100,
                                                 chunk_pairs=100, seed=6, layout="loop",
                                                 return_summaries=True)
    pd.testing.assert_frame_equal(df, want, check_exact=True)
    for g, w in zip(summs, wsumms):
        for f in ta.ScoreSummary._fields:
            np.testing.assert_array_equal(getattr(g, f), np.asarray(getattr(w, f)))


def test_simulate_slate_summaries_game_shard_and_memos():
    """(g) layout='game_shard' is the memoized SlateRunner's
    run_summary_rows; the loop's runners are memoized on the identity of
    the given contexts and tables; a slate whose build failed raises again
    without another build."""
    matchups, tables = _slate()
    kw = dict(contexts=matchups, nano_tables=tables, n_pairs=64, seed=3, device="cpu")
    rows, summs = api.simulate_slate_summary_rows(GAMES, layout="game_shard", **kw)
    sr = api._game_shard_runner(matchups, tables, SimConfig(), "nano", "cpu")
    assert api._game_shard_runner(matchups, tables, SimConfig(), "nano", "cpu") is sr
    want_rows, want_summs = sr.run_summary_rows(64, seed=3)
    assert rows == want_rows and len(summs) == G
    r1 = api._runner_for(*matchups[0], tables[0], SimConfig(), "table", "nano", False, "cpu")
    r2 = api._runner_for(*matchups[0], tuple(tables[0]), SimConfig(), "table", "nano", False,
                         "cpu")
    assert r1 is r2 and r1.nano_tables is tables[0]
    assert api._runner_for(*matchups[1], tables[1], SimConfig(), "table", "nano", False,
                           "cpu") is not r1
    # a table of another shape fails to pack, and the failure is remembered
    bad = [tables[0], (tables[1][0], fixtures.fused_tables(1)[1]), tables[2]]
    with pytest.raises(ValueError, match="nano-layout tables"):
        api.simulate_slate_summary_rows(GAMES, layout="game_shard", **dict(kw, nano_tables=bad))
    with pytest.raises(ValueError, match="previously failed to build: ValueError"):
        api.simulate_slate_summary_rows(GAMES, layout="game_shard", **dict(kw, nano_tables=bad))


@pytest.mark.parametrize("kw", [
    dict(layout="stacked"),
    dict(layout="game_shard", focus_csv="players.csv"),
    dict(layout="game_shard", mode="analytic"),
    dict(layout="game_shard", shard=True),
    dict(layout="game_shard", table_quality="coarse"),
])
def test_simulate_slate_summaries_validation_matches_jax(monkeypatch, kw):
    """(g) The JAX package's validation errors, message for message."""
    _stub_jax_reads(monkeypatch)
    with pytest.raises(ValueError) as want:
        japi.simulate_slate_summaries(GAMES, sp_path="", n_pairs=8, **kw)
    matchups, tables = _slate()
    with pytest.raises(ValueError) as got:
        api.simulate_slate_summaries(GAMES, contexts=matchups, nano_tables=tables,
                                     n_pairs=8, device="cpu", **kw)
    assert str(got.value) == str(want.value)


def test_slate_entry_points_need_built_inputs():
    """(g) contexts with sp_path= or focus_csv= (which build contexts from
    an SP+ sheet), or neither contexts nor a sheet, raise ValueError, and a
    context list of the wrong length; trial sharding in a world of one
    gives the unsharded summaries.  (The sheet route:
    tests/test_torch_routes.py.)"""
    matchups, tables = _slate()
    for fn in (api.simulate_slate_summaries, api.simulate_slate):
        for kw in (dict(sp_path="sp.csv"), dict(focus_csv="f.csv")):
            with pytest.raises(ValueError, match="not both"):
                fn(GAMES, contexts=matchups, nano_tables=tables, device="cpu", **kw)
        with pytest.raises(ValueError, match="needs sp_path="):
            fn(GAMES)
        with pytest.raises(ValueError, match="3 games need as many context pairs"):
            fn(GAMES, contexts=matchups[:2], nano_tables=tables, device="cpu")
    pd.testing.assert_frame_equal(
        api.simulate_slate_summaries(GAMES, contexts=matchups, nano_tables=tables,
                                     n_pairs=8, device="cpu", shard=True),
        api.simulate_slate_summaries(GAMES, contexts=matchups, nano_tables=tables,
                                     n_pairs=8, device="cpu"))


def test_simulate_slate_rows_match_jax_on_the_same_scores(monkeypatch):
    """(g) `simulate_slate`: each game's n pairs on its runner under
    seed + gi, and the row the JAX package builds from the same score
    frame (means over all games; win_a and the margin over the games team
    A started, win_b over team B's)."""
    matchups, tables = _slate()
    rows = api.simulate_slate_rows(GAMES, contexts=matchups, nano_tables=tables, n=96,
                                   seed=5, device="cpu")
    frames = {}
    for gi, ((a, b), tab) in enumerate(zip(matchups, tables)):
        r = api._runner_for(a, b, tab, SimConfig(), "table", "nano", False, "cpu")
        sc, _, _ = api.simulate_matchup_columns(a, b, None, 96, seed=5 + gi, runner=r)
        frames[5 + gi] = pd.DataFrame(sc)
    _stub_jax_reads(monkeypatch)
    monkeypatch.setattr(japi, "_runner_for", lambda *a, **k: None)
    monkeypatch.setattr(japi, "simulate_matchup",
                        lambda a, b, heads, n, seed, **k: (frames[seed], None, None))
    want = japi.simulate_slate(GAMES, sp_path="", n=96, seed=5)
    pd.testing.assert_frame_equal(pd.DataFrame(rows), want, check_exact=True)
    pd.testing.assert_frame_equal(
        api.simulate_slate(GAMES, contexts=matchups, nano_tables=tables, n=96, seed=5,
                           device="cpu"), want, check_exact=True)
    assert list(want["n_games"]) == [192] * G


def test_draw_reference_takes_a_slice_of_rows():
    """The plain draws of rows row0 .. row0 + n - 1 equal those rows of a
    wider draw (how the slate's widest launch is checked on the card, a
    slice at a time); row0 = 0 is the plain version as before."""
    from fast_monte_carlo_tpu_torch.ops import rng

    key = fold_in(root_key(6), 2)
    u, z = rng.philox_draws_reference(key, 48, 3, 1000, "cpu")
    for r0, w in ((0, 1000), (1, 64), (517, 300), (999, 1)):
        us, zs = rng.philox_draws_reference(key, 48, 3, w, "cpu", row0=r0)
        assert torch.equal(us, u[:, r0:r0 + w]) and torch.equal(zs, z[:, r0:r0 + w]), r0
    uc, zc = rng.chunk_draws(key, 48, 3, 1000, "cpu")
    assert torch.equal(uc, u) and torch.equal(zc, z)

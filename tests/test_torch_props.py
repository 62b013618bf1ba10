"""The port's outputs and prop path against the JAX package's, on one
GameState carried across as numpy: scores_frame, players_frame,
summary_frame, resolve_prop_rows, reduce_props_device,
prop_table_from_reductions and scan_props_device; the odds math, the box
score and the stat layouts; and the port's own props path end to end on
the CPU (`MatchupRunner.run_pairs` with both collectors, `simulate_matchup`)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from fast_monte_carlo_tpu import api as japi
from fast_monte_carlo_tpu import boxscore as jbox
from fast_monte_carlo_tpu import edge as jedge
from fast_monte_carlo_tpu import stats as jstats
from fast_monte_carlo_tpu.ops import game as jg
from fast_monte_carlo_tpu_torch import api, boxscore, edge, fixtures, stats
from fast_monte_carlo_tpu_torch.config import SimConfig

from test_torch_support import FOCUS_SEED, TABLE_SEED, jax_teams, write_focus
from test_torch_support import table_cache_off  # noqa: F401 (autouse)

torch.set_num_threads(1)

PROP_SEED = 4


@pytest.fixture(scope="module")
def props_run(tmp_path_factory):
    """The port's props path on the CPU: focus teams, nano table,
    pallas_chunk draws, 384 pairs with both collectors; and the JAX
    package's contexts of the same sheet and its GameState of the run."""
    d = tmp_path_factory.mktemp("props")
    a, b = fixtures.focus_teams(FOCUS_SEED)
    cfg = SimConfig()
    cfg = cfg.replace(engine=dataclasses.replace(cfg.engine, rng_impl="pallas_chunk"))
    runner = api.MatchupRunner(a, b, None, cfg, mode="table",
                               nano_tables=fixtures.nano_tables(TABLE_SEED), device="cpu")
    out = runner.run_pairs(384, seed=2)
    state = {f: getattr(out, f).numpy() for f in out._fields}
    sheet = d / "props.csv"
    fixtures.write_csv(sheet, fixtures.prop_rows(PROP_SEED), fixtures.PROP_COLS)
    return dict(a=a, b=b, runner=runner, out=out,
                jout=jg.GameState(**{f: jnp.asarray(v) for f, v in state.items()}),
                ja_jb=jax_teams(8, write_focus(d / "focus.csv")), sheet=str(sheet))


def test_stat_layouts_and_boxscore_equal_jax(props_run):
    for name in ("TEAM_STAT_FIELDS", "TS", "N_TEAM_STATS", "ROLE_PASS", "ROLE_RUSH",
                 "ROLE_REC", "ROLES", "PC_ATT", "PC_COMP", "PC_YDS", "PC_TD", "PC_INT",
                 "PC_SACKS", "N_PLAYER_STATS", "PLAYER_COLS", "ROLE_LABEL"):
        assert getattr(stats, name) == getattr(jstats, name), name
    st = props_run["out"].stats.numpy()
    names = ("Team A", "Team B")
    for i in (0, 1, 7):
        assert boxscore.format_boxscore(names, st[i]) == jbox.format_boxscore(names, st[i])
    assert boxscore.mean_boxscore(names, st) == jbox.mean_boxscore(names, st)


def test_output_frames_equal_jax(props_run):
    out, jout = props_run["out"], props_run["jout"]
    (a, b), (ja, jb) = (props_run["a"], props_run["b"]), props_run["ja_jb"]
    got = api.scores_frame(out, a.name, b.name)
    want = japi.scores_frame(jout, ja.name, jb.name)
    pd.testing.assert_frame_equal(got, want)
    pd.testing.assert_frame_equal(api.summary_frame(got), japi.summary_frame(want))
    gp, wp = api.players_frame(out, a, b), japi.players_frame(jout, ja, jb)
    assert len(wp) > 0 and set(wp["role"]) == {"QB", "Rusher", "Receiver"}
    pd.testing.assert_frame_equal(gp, wp)
    # the columns the frames wrap, and the empty case (no tracked slot)
    cols = api.players_columns(out, a, b)
    assert list(cols) == list(stats.PLAYER_COLS)
    ua, ub = fixtures.teams()
    pd.testing.assert_frame_equal(api.players_frame(out, ua, ub),
                                  japi.players_frame(jout, *jax_teams()))


def test_resolve_and_reduce_props_equal_jax(props_run):
    (a, b), (ja, jb) = (props_run["a"], props_run["b"]), props_run["ja_jb"]
    rows = fixtures.prop_rows(PROP_SEED)
    got_idx, got_meta = edge.resolve_prop_rows(a, b, rows)
    want_idx, want_meta = jedge.resolve_prop_rows(ja, jb, pd.DataFrame(rows))
    assert got_meta == want_meta
    assert len(got_meta) == len(rows) - 3                  # the three skip rows
    assert {m["stat"] for m in got_meta} == set(edge._STAT_TO_ROLE_COL)
    assert len(got_idx[0]) % 8 == 0 and len(got_idx[0]) > len(got_meta)
    for g, w in zip(got_idx, want_idx):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert edge.resolve_prop_rows(a, b, pd.DataFrame(rows))[1] == got_meta
    assert edge.resolve_prop_rows(a, b, rows[-3:]) == (None, [])

    got = edge.reduce_props_device(props_run["out"].pstats, got_idx)
    want = jedge.reduce_props_device(props_run["jout"].pstats, want_idx)
    assert set(got) == set(want)
    for k in ("p_over", "p_under", "push", "n_active"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    for k in ("mean", "median", "p75", "p90"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    assert (got["push"] > 0).any() and (got["n_active"] < 768).any()
    # quantile columns split to fit a size cap give the same numbers
    edge_cap = edge._QUANTILE_CHUNK
    try:
        edge._QUANTILE_CHUNK = 3 * 768
        split = edge.reduce_props_device(props_run["out"].pstats, got_idx)
    finally:
        edge._QUANTILE_CHUNK = edge_cap
    for k in got:
        assert torch.equal(split[k].nan_to_num(-1.0), got[k].nan_to_num(-1.0)), k


@pytest.mark.parametrize("min_edge", [0.0, 2.0, 30.0])
def test_prop_table_equals_jax(props_run, min_edge):
    (a, b), (ja, jb) = (props_run["a"], props_run["b"]), props_run["ja_jb"]
    idx, meta = jedge.resolve_prop_rows(ja, jb, pd.DataFrame(fixtures.prop_rows(PROP_SEED)))
    red = {k: np.asarray(v)
           for k, v in jedge.reduce_props_device(props_run["jout"].pstats, idx).items()}
    want = jedge.prop_table_from_reductions(meta, red, min_edge)
    got = edge.prop_table_from_reductions(meta, red, min_edge)
    assert 0 < len(want) <= len(meta)
    pd.testing.assert_frame_equal(got, want)
    assert edge.prop_rows_from_reductions(meta, red, min_edge) == want.to_dict("records")
    # scanning the sheet: the port reduces with torch, the JAX package with XLA
    pd.testing.assert_frame_equal(
        edge.scan_props_device(props_run["out"], a, b, props_run["sheet"], min_edge),
        jedge.scan_props_device(props_run["jout"], ja, jb, props_run["sheet"], min_edge))


def test_odds_math_equals_jax(tmp_path):
    for p in (0.0, 1e-7, 0.1, 0.4999, 0.5, 0.52381, 0.75, 0.999, 1.0):
        assert edge.prob_to_american(p) == jedge.prob_to_american(p)
        for price in (-250, -110, 100, 135):
            assert edge.ev_per_100(p, price) == jedge.ev_per_100(p, price)
            assert edge.best_side_ev(p, price) == jedge.best_side_ev(p, price)
    for price in (-250, -110, 100, 135):
        assert edge.american_implied_prob(price) == jedge.american_implied_prob(price)
    for s in ("Team A", " team-a ", "TEAM_A!", "Texas A&M"):
        assert edge._norm_team(s) == jedge._norm_team(s)
    assert edge.STAT_ALIASES == jedge.STAT_ALIASES
    assert edge._STAT_TO_ROLE_COL == jedge._STAT_TO_ROLE_COL
    a, ja = fixtures.focus_teams(FOCUS_SEED)[0], jax_teams(8, write_focus(tmp_path / "f.csv"))[0]
    for player, stat in (("Team A Passer 1", "pass_yards"), ("team a rusher 1", "rush_att"),
                         ("Team A Receiver 3", "tgt"), ("Nobody", "rec"),
                         ("Team A Passer 1", "fantasy_pts")):
        assert edge._resolve_stat_target(a, player, stat, strict=False) == \
            jedge._resolve_stat_target(ja, player, stat, strict=False)
        try:
            want = jedge._resolve_stat_target(ja, player, stat, strict=True)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e).split()[0]):
                edge._resolve_stat_target(a, player, stat, strict=True)
        else:
            assert want is not None
            assert edge._resolve_stat_target(a, player, stat, strict=True) == want


def test_props_path_on_the_cpu(props_run):
    """The port's own run: points = score, box-score and player identities,
    every resolvable prop row priced with probabilities in range."""
    out = props_run["out"]
    st, ps = out.stats, out.pstats
    assert torch.equal(st[:, :, stats.TS["points"]], out.score.float())
    assert not torch.isnan(st).any() and not torch.isnan(ps).any()
    pass_att = st[..., stats.TS["pass_att"]]
    assert (st[..., stats.TS["comp"]] <= pass_att).all()
    assert (ps[:, :, stats.ROLE_PASS, :, stats.PC_ATT].sum(-1) <= pass_att).all()
    assert (ps[:, :, stats.ROLE_REC, :, stats.PC_ATT] >= ps[:, :, stats.ROLE_REC, :,
                                                               stats.PC_COMP]).all()
    rows = edge.scan_props_rows(out, props_run["a"], props_run["b"], props_run["sheet"], 0.0)
    assert len(rows) == len(fixtures.prop_rows(PROP_SEED)) - 3
    assert list(rows[0]) == list(edge.PROP_TABLE_COLS)
    assert all(0 <= r["p_over"] and r["p_over"] + r["p_under"] <= 1 for r in rows)
    edges = [abs(r["edge_pct"]) for r in rows]
    assert edges == sorted(edges, reverse=True)


def test_simulate_matchup_equals_its_parts(props_run):
    a, b, runner = props_run["a"], props_run["b"], props_run["runner"]
    sims, players, r = api.simulate_matchup(a, b, n=64, seed=5, collect_players=True,
                                            runner=runner)
    out = runner.run_pairs(64, seed=5, collect_players=True)
    assert r is runner
    pd.testing.assert_frame_equal(sims, api.scores_frame(out, a.name, b.name))
    pd.testing.assert_frame_equal(players, api.players_frame(out, a, b))
    cols, none, _ = api.simulate_matchup_columns(a, b, n=64, seed=5, runner=runner)
    assert none is None and len(cols["pts"]) == 128
    # trial sharding in a world of one: the same frames, the runner's tables shared
    sharded, _, rs = api.simulate_matchup(a, b, n=64, seed=5, shard=True, runner=runner)
    assert rs.shard and rs.heads_state is runner.heads_state
    pd.testing.assert_frame_equal(sharded, sims)
    # no runner: the default device (the card, raising where there is none),
    # then table mode without nano_tables
    with pytest.raises(ValueError if torch.cuda.is_available() else RuntimeError):
        api.simulate_matchup(a, b, n=8, cfg=SimConfig(), mode="table")

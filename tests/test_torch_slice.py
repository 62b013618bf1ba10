"""The port's main path end to end, on the CPU: `MatchupRunner` in nano
table mode with rng_impl="pallas_chunk" and `run_pairs_summary`, against
the JAX package's `simulate_games` + `score_moments` on the same fixture.
The two draw different random streams (Philox here, threefry in the JAX
package off the TPU), so they agree within Monte-Carlo error."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from fast_monte_carlo_tpu.config import SimConfig as JaxSimConfig
from fast_monte_carlo_tpu.config import resolve_nano_select
from fast_monte_carlo_tpu.ops.game import simulate_games
from fast_monte_carlo_tpu.ops.table_lookup import make_table_heads_eval
from fast_monte_carlo_tpu.parallel.aggregate import score_moments, summary_from_moments
from fast_monte_carlo_tpu_torch import fixtures
from fast_monte_carlo_tpu_torch.api import MatchupRunner
from fast_monte_carlo_tpu_torch.config import SimConfig

from test_torch_support import TABLE_SEED, jax_pack, jax_table_heads

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
N_PAIRS = 4096


def _cfg(cls):
    c = cls()
    return c.replace(engine=dataclasses.replace(c.engine, rng_impl="pallas_chunk"))


def _margins(hist: np.ndarray) -> np.ndarray:
    return np.repeat(np.arange(hist.size) - 128, hist.astype(np.int64))


def test_run_pairs_summary_matches_jax_within_mc_error():
    a, b = fixtures.teams()
    runner = MatchupRunner(a, b, None, _cfg(SimConfig), mode="table",
                           nano_tables=fixtures.nano_tables(TABLE_SEED),
                           device="cpu")
    got = runner.run_pairs_summary(N_PAIRS, seed=3, chunk_pairs=512)

    jcfg = resolve_nano_select(_cfg(JaxSimConfig), collect_stats=False)
    # scan_unroll only shapes XLA's loop (draws key on the absolute step):
    # unrolled once it compiles in half the time to the same games
    jcfg = jcfg.replace(engine=dataclasses.replace(jcfg.engine, scan_unroll=1))
    n = 2 * N_PAIRS
    he = make_table_heads_eval(jcfg)
    jpack = jax_pack(jcfg)
    out = jax.jit(lambda hs, fo: simulate_games(
        jpack, jcfg, he, hs, jax.random.PRNGKey(3), n, fo,
        collect_players=False, collect_stats=False))(
        jax_table_heads(), jnp.asarray(np.arange(n) % 2, jnp.int32))
    want = summary_from_moments(score_moments(out.score))

    assert float(got.n) == float(want.n) == n
    for i in range(2):
        assert abs(float(got.win_rate[i]) - float(want.win_rate[i])) <= 0.035
        assert abs(float(got.mean_pts[i]) - float(want.mean_pts[i])) <= 1.0
    p = stats.ks_2samp(_margins(got.margin_hist.numpy()),
                       _margins(np.asarray(want.margin_hist))).pvalue
    assert p > 1e-3, p
    # the summary itself is well formed
    assert abs(float(got.win_rate.sum() + got.tie_rate) - 1.0) < 1e-6
    assert int(got.margin_hist.sum()) == int(got.total_hist.sum()) == n
    assert (got.pts_hist.sum(dim=1) == n).all()
    assert 10 < float(got.mean_pts.min()) and float(got.mean_pts.max()) < 50
    assert torch.isfinite(got.sd_pts).all()


def test_run_pairs_summary_rounds_up_and_is_seeded():
    a, b = fixtures.teams()
    r = MatchupRunner(a, b, None, _cfg(SimConfig), mode="analytic", device="cpu")
    s1 = r.run_pairs_summary(150, seed=1, chunk_pairs=100)
    s2 = r.run_pairs_summary(150, seed=1, chunk_pairs=100)
    s3 = r.run_pairs_summary(150, seed=2, chunk_pairs=100)
    assert float(s1.n) == 2 * 200                  # 2 launches of 100 pairs
    assert torch.equal(s1.margin_hist, s2.margin_hist)
    assert not torch.equal(s1.margin_hist, s3.margin_hist)
    with pytest.raises(ValueError):
        r.run_pairs_summary(0)


def test_import_leaves_jax_pandas_sklearn_out():
    """Every module of the port, and chip_smoke.py with every module it
    imports, leaves the JAX package and its dependencies out; importing a
    probe runs nothing (no output)."""
    code = (
        "import ast, sys, importlib, pkgutil\n"
        "import fast_monte_carlo_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "tree = ast.parse(open(chip_smoke.__file__).read())\n"
        "for node in ast.walk(tree):\n"
        "    if isinstance(node, ast.Import):\n"
        "        names = [a.name for a in node.names]\n"
        "    elif isinstance(node, ast.ImportFrom):\n"
        "        names = [node.module or '']\n"
        "    else:\n"
        "        continue\n"
        "    for n in names:\n"
        "        if n.startswith('fast_monte_carlo_tpu_torch'):\n"
        "            importlib.import_module(n)\n"
        "        else:\n"
        "            assert n.split('.')[0] not in ('jax', 'fast_monte_carlo_tpu', 'pandas',"
        " 'sklearn', 'joblib'), n\n"
        "need = ['fast_monte_carlo_tpu_torch.probes.step_arith',"
        " 'fast_monte_carlo_tpu_torch.probes.gather', 'fast_monte_carlo_tpu_torch.probes.csv_read',"
        " 'fast_monte_carlo_tpu_torch.utils.cuda_build',"
        " 'fast_monte_carlo_tpu_torch.stats', 'fast_monte_carlo_tpu_torch.boxscore',"
        " 'fast_monte_carlo_tpu_torch.edge', 'fast_monte_carlo_tpu_torch.data.usage',"
        " 'fast_monte_carlo_tpu_torch.api', 'fast_monte_carlo_tpu_torch.ops.game',"
        " 'fast_monte_carlo_tpu_torch.parallel.aggregate',"
        " 'fast_monte_carlo_tpu_torch.models.forest', 'fast_monte_carlo_tpu_torch.models.heads',"
        " 'fast_monte_carlo_tpu_torch.ops.forest_eval', 'fast_monte_carlo_tpu_torch.models.tables',"
        " 'fast_monte_carlo_tpu_torch.ops.table_lookup', 'fast_monte_carlo_tpu_torch.ops.pack',"
        " 'fast_monte_carlo_tpu_torch.compat', 'fast_monte_carlo_tpu_torch.data.sp',"
        " 'fast_monte_carlo_tpu_torch.data.context', 'fast_monte_carlo_tpu_torch.models.xgb_json',"
        " 'fast_monte_carlo_tpu_torch.models.sklearn_gbr',"
        " 'fast_monte_carlo_tpu_torch.models.wrappers', 'fast_monte_carlo_tpu_torch.serve',"
        " 'fast_monte_carlo_tpu_torch.cli', 'fast_monte_carlo_tpu_torch.store',"
        " 'fast_monte_carlo_tpu_torch.backtest', 'fast_monte_carlo_tpu_torch.utils.profiling',"
        " 'fast_monte_carlo_tpu_torch.data.columns', 'fast_monte_carlo_tpu_torch.parallel']\n"
        "from fast_monte_carlo_tpu_torch import api, edge, fixtures\n"
        "from fast_monte_carlo_tpu_torch.ops import game\n"
        "from fast_monte_carlo_tpu_torch.parallel import aggregate\n"
        "assert all(callable(f) for f in (api.MatchupRunner.run_live,"
        " api.MatchupRunner.run_live_batch, api.MatchupRunner.run_fourth_decision,"
        " api.simulate_live_game, api.simulate_live_curve, api.simulate_live_curve_columns,"
        " api.evaluate_fourth_down, api.situation_from_fields, game.state_from_situation,"
        " aggregate.cover_probs, aggregate.total_probs, edge.market_odds_from_summary,"
        " edge.summary_moneyline, edge.Dist, api.SlateRunner, api.simulate_slate_summaries,"
        " api.simulate_slate_summary_rows, api.simulate_slate, api.simulate_slate_rows,"
        " edge.slate_market_table, edge.slate_market_rows, edge.alt_lines_from_summary,"
        " edge.middles_from_summary, edge.print_slate_edges, fixtures.slate,"
        " fixtures.slate_lines, edge.resolve_parlay_legs, edge.reduce_parlay_device,"
        " edge.parlay_odds, edge.leg_corr_device, edge.parlay_correlation_matrix,"
        " edge.parlay_correlations, edge.tease_legs, edge.cross_game_parlay,"
        " edge.reduce_round_robin_device, edge.round_robin, edge.round_robin_blocks,"
        " edge.season_win_pmf, edge.season_win_market, edge.print_parlay_readable,"
        " edge.print_round_robin_readable, edge.print_season_readable,"
        " api.simulate_parlay, api.simulate_parlay_core, api.project_season,"
        " api.project_season_rows, api.simulate_slate_props, api.simulate_slate_prop_rows,"
        " fixtures.focus_slate, fixtures.slate_prop_rows, fixtures.season,"
        " fixtures.heads, game.make_exact_heads_eval, game._state_features))\n"
        "from fast_monte_carlo_tpu_torch.models import forest, heads, tables\n"
        "from fast_monte_carlo_tpu_torch.ops import forest_eval, pack, table_lookup\n"
        "assert all(callable(f) for f in (forest.flat_forest_from_numpy,"
        " heads.model_heads_from_numpy, forest_eval.pack_forest, forest_eval.eval_margin,"
        " forest_eval.predict, forest_eval.eval_margin_cuda, pack.pack_heads,"
        " pack.build_packs, tables.eval_forest_on_grid, tables.build_fused_table,"
        " table_lookup.build_table_heads, table_lookup.nano_tables_from_heads,"
        " table_lookup.table_sets_from_heads, table_lookup.fused_tables_from_heads,"
        " tables.build_tables, tables.build_play_table, tables.fine_profile,"
        " tables.coarse_profile, tables.turbo_profile, tables.slate_profile,"
        " tables.sd_reps_default, api.table_profiles,"
        " heads.load_heads, heads.load_reconstructed_heads, api.simulate_upcoming_matchup,"
        " api.simulate_upcoming_matchup_columns, api.csv_base_from, api._save_frames,"
        " api.simulate_matchup_batched, api.simulate_matchup_batched_chunks,"
        " edge.find_saved_files, edge.load_table, edge.load_players_table,"
        " edge.player_prop_odds, edge.moneyline_from_sims, edge.game_market_odds,"
        " edge.scan_props_for_matchup, edge.alt_prop_table, edge.player_prop_ladder,"
        " edge.alt_lines_from_sims, edge.middles_from_sims, edge.print_game_market_readable,"
        " edge.print_moneyline_readable, edge.print_prop_table, edge.find_edges,"
        " edge.infer_role_from_stat))\n"
        "from fast_monte_carlo_tpu_torch import backtest, store\n"
        "from fast_monte_carlo_tpu_torch.parallel import player_stat_probs\n"
        "from fast_monte_carlo_tpu_torch.parallel import mesh\n"
        "assert all(callable(f) for f in (mesh.trial_group, mesh.game_group,"
        " mesh.simulate_games_sharded, mesh.simulate_moments_sharded, mesh.all_gather_rows,"
        " mesh.all_reduce_sum, mesh.world_size, mesh.process_rank))\n"
        "from fast_monte_carlo_tpu_torch.utils import profiling\n"
        "assert all(callable(f) for f in (store.make_signature, store.save_sim_bundle,"
        " store.load_sim_bundle, backtest.join_results, backtest.calibration_report,"
        " backtest.fit_calibration, backtest.backtest_slate, backtest.win_calibration,"
        " backtest.point_metrics, backtest.pit_values, backtest.ks_uniform,"
        " backtest.print_backtest_readable, player_stat_probs, profiling.SimMeter,"
        " profiling.trace_context, profiling.device_memory_stats))\n"
        "assert all(m in sys.modules for m in need), need\n"
        "bad = [m for m in ('jax', 'pandas', 'pyarrow', 'sklearn', 'joblib', 'xgboost',"
        " 'fast_monte_carlo_tpu')"
        " if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout == "ok\n", (out.stdout, out.stderr)


def test_csv_routes_leave_pandas_and_pyarrow_out(tmp_path):
    """`sim --save` to CSV, then `edges` and `prop --ladder` over the files
    and `backtest`, in one process on the CPU: neither pandas nor pyarrow
    is ever imported (the card's host has neither)."""
    code = (
        "import contextlib, io, os, sys\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "from fast_monte_carlo_tpu_torch import cli, fixtures\n"
        f"os.chdir({str(tmp_path)!r})\n"
        "sp = fixtures.write_sp_sheet('sp.csv', 136, 0)\n"
        "fixtures.write_csv('focus.csv', fixtures.focus_rows(3), fixtures.FOCUS_COLS)\n"
        "fixtures.write_csv('props.csv', fixtures.prop_rows(4), fixtures.PROP_COLS)\n"
        "open('finals.csv', 'w').write('team_a,team_b,score_a,score_b\\n"
        "Team A,Team B,21,17\\nTeam 001,Team 000,10,13\\n')\n"
        "art = ['--artifacts', fixtures.ARTIFACT_DIR, '--device', 'cpu', '--mode', 'analytic']\n"
        "runs = [['sim', 'Team A', 'Team B', '--sp', sp, '-n', '64', '--players', '--save',"
        " '--focus', 'focus.csv'] + art,"
        " ['edges', '--base', 'teama_teamb_wk1_sims.csv', '--team-a', 'Team A', '--team-b',"
        " 'Team B', '--spread', '-3.5', '--total', '44.5', '--props', 'props.csv', '--alt',"
        " '--mid-total', '40.5,47.5'],"
        " ['prop', 'Team A', 'Team A Passer 1', 'pass_yds', '230.5', '--ladder'],"
        " ['backtest', '--results', 'finals.csv', '--sp', sp, '-n', '64'] + art]\n"
        "for argv in runs:\n"
        "    with contextlib.redirect_stdout(io.StringIO()):\n"
        "        assert cli.main(argv) == 0, argv\n"
        "print(sorted(m for m in ('pandas', 'pyarrow') if m in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=240)
    assert out.returncode == 0 and out.stdout == "[]\n", (out.stdout, out.stderr[-2000:])


@pytest.mark.parametrize("antithetic", [False, True])
def test_default_config_plays_games(antithetic):
    """SimConfig() keeps the JAX default rng_impl="threefry", which the port
    draws from its Philox stream: a runner built with it plays games, with
    antithetic draws too."""
    cfg = SimConfig()
    if antithetic:
        cfg = cfg.replace(engine=dataclasses.replace(cfg.engine, antithetic=True))
    assert cfg.engine.rng_impl == "threefry"
    a, b = fixtures.teams()
    out = MatchupRunner(a, b, cfg=cfg, mode="analytic", device="cpu").run_pairs(64)
    assert out.score.shape == (128, 2) and (out.sec == 0).all()
    assert 10 < float(out.score.float().mean()) < 50


def test_summary_path_runs_score_only(monkeypatch):
    """run_pairs_summary asks simulate_games for score-only games (both
    collectors off), as the JAX package does; run_pairs takes its defaults,
    both collectors on."""
    from fast_monte_carlo_tpu_torch import api
    from fast_monte_carlo_tpu_torch.parallel import mesh

    calls = []
    real = mesh.simulate_games

    def spy(*args, **kw):
        calls.append(kw)
        return real(*args, **kw)

    # a runner's launches go through parallel.mesh (on its group)
    monkeypatch.setattr(mesh, "simulate_games", spy)
    a, b = fixtures.teams()
    r = MatchupRunner(a, b, None, _cfg(SimConfig), mode="analytic", device="cpu")
    r.run_pairs_summary(64, seed=1, chunk_pairs=32)
    assert len(calls) == 2
    assert all(c["collect_players"] is False and c["collect_stats"] is False for c in calls)
    out = r.run_pairs(8, seed=1)
    assert calls[-1]["collect_players"] is True and calls[-1]["collect_stats"] is True
    assert out.stats.shape == (16, 2, 19) and out.pstats.shape == (16, 2, 3, 8, 6)


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    a, b = fixtures.teams()
    with pytest.raises(RuntimeError):
        MatchupRunner(a, b, None, _cfg(SimConfig), mode="table",
                      nano_tables=fixtures.nano_tables(TABLE_SEED), device="cuda")
    with pytest.raises(RuntimeError):
        MatchupRunner(a, b, None, _cfg(SimConfig), mode="analytic")


def test_matchup_runner_defaults_to_the_card():
    """With no device the runner takes the card: resolve_device's error
    where there is none, never a quiet run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    a, b = fixtures.teams()
    with pytest.raises(RuntimeError, match="never falls back to the CPU"):
        MatchupRunner(a, b, None, _cfg(SimConfig), mode="analytic")
    r = MatchupRunner(a, b, None, _cfg(SimConfig), mode="analytic", device="cpu")
    assert r.device == torch.device("cpu")
    s = r.run_pairs_summary(64, seed=4)
    assert float(s.n) == 128 and int(s.margin_hist.sum()) == 128


def test_smoke_bound_names_the_binding_class():
    """chip_smoke.bound: the largest of bytes and each instruction class over
    its H100 rate binds and is named.  IMAD has a pipe of its own beside the
    ALU.  The draw kernel stays bound by its stores at the main path's
    (24, 65,536); the fused 24-step chunk by dispatch, one step by its bytes.
    No class holds more instructions than dispatch."""
    import chip_smoke

    clock = 132 * 1.98e9
    counts = {"alu": 1e12, "imad": 1e12, "mufu_cvt": 1e9, "dispatch": 1.5e12}
    b = chip_smoke.bound(1e6, counts)
    assert (b["bound_class"], b["bound_by"]) == ("alu", "operations")
    assert b["bound_ms"] == pytest.approx(1e12 / (64 * clock) * 1e3)
    for cls, lanes, more in (("imad", 64, {"imad": 2e12, "dispatch": 2.5e12}),
                             ("dispatch", 128, {"dispatch": 4e12}),
                             ("mufu_cvt", 16, {"mufu_cvt": 1e12})):
        b = chip_smoke.bound(1e6, {**counts, **more})
        assert (b["bound_class"], b["bound_ms"]) == (
            cls, pytest.approx(more[cls] / (lanes * clock) * 1e3))
    b = chip_smoke.bound(1e12, {"dispatch": 1e6})
    assert (b["bound_class"], b["bound_by"]) == ("bytes", "bytes")
    d = chip_smoke.draw_bound(24, 65536)
    assert (d["bound_class"], d["bound_by"]) == ("bytes", "bytes")
    assert d["bound_ms"] == pytest.approx(24 * 65536 * 68 / 3.35e12 * 1e3)
    assert round(d["bound_ms"], 4) == 0.0319
    chunk, one = chip_smoke.step_bound(131072, 24), chip_smoke.step_bound(131072, 1)
    assert chunk["bound_class"] == "dispatch"
    assert chunk["bound_ms"] == pytest.approx(
        24 * 131072 * chip_smoke.STEP_COUNTS["dispatch"] / (128 * clock) * 1e3)
    assert (one["bound_class"], one["bound_ms"]) == (
        "bytes", pytest.approx(131072 * 72 / 3.35e12 * 1e3))
    for c in (chip_smoke.DRAW_COUNTS, chip_smoke.STEP_COUNTS):
        assert set(c) == set(chip_smoke.RATES) - {"bytes"}
        assert c["alu"] + c["imad"] + c["mufu_cvt"] <= c["dispatch"]

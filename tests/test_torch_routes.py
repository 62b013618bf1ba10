"""The routes that start from a user's files, on the CPU: an SP+ sheet
(`fixtures.write_sp_sheet`, the 2025 schema, 136 teams) and the trained-head
fixture directory (`tests/data/torch_artifacts/`).

Each route equals, bitwise, the same call on inputs built by hand (contexts,
heads, runners, nano tables from `ops.table_lookup.nano_tables_from_heads`);
`simulate_upcoming_matchup` agrees with the JAX package's on the same sheet
and artifacts within Monte-Carlo error (the two packages draw different
streams); `_save_frames` writes the JAX package's files."""
import dataclasses
import os

import numpy as np
import pandas as pd
import pytest
import torch

from fast_monte_carlo_tpu import api as japi
from fast_monte_carlo_tpu_torch import api, fixtures
from fast_monte_carlo_tpu_torch.config import SimConfig
from fast_monte_carlo_tpu_torch.data.context import build_team_context_from_sp_flex
from fast_monte_carlo_tpu_torch.data.sp import load_sp_flex
from fast_monte_carlo_tpu_torch.models.heads import load_heads
from fast_monte_carlo_tpu_torch.ops.game import Situation
from fast_monte_carlo_tpu_torch.ops.table_lookup import nano_tables_from_heads

from test_torch_support import jax_readable_copy, write_focus
from test_torch_support import table_cache_off  # noqa: F401 (autouse)

torch.set_num_threads(1)

ART = fixtures.ARTIFACT_DIR
CPU = dict(device="cpu")
Q4 = Situation(offense=0, sec=300, down=2, dist=7.0, ytg=40.0, score_a=21, score_b=17)
FOURTH = Situation(offense=1, sec=420, down=4, dist=2.0, ytg=33.0, score_a=14, score_b=10)
LEGS = [{"kind": "spread", "team": "Team A", "line": 3.5},
        {"kind": "moneyline", "team": "Team B"},
        {"kind": "total", "side": "over", "line": 38.5}]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("routes")
    return {"sp": fixtures.write_sp_sheet(d / "sp.csv", 136, 0),
            "focus": str(write_focus(d / "focus.csv")),
            "dir": d}


def _ctx(files, team, focus=None):
    return build_team_context_from_sp_flex(team, 2025, 1, load_sp_flex(files["sp"]),
                                           focus_csv=files[focus] if focus else None)


@pytest.fixture(scope="module")
def hand(files):
    """Inputs built by hand: the heads, the sheet's contexts of Team A and
    Team B, their nano tables, and the table runner on those tables."""
    heads = load_heads(ART)
    a, b = _ctx(files, "Team A"), _ctx(files, "Team B")
    tables = nano_tables_from_heads(a, b, heads, SimConfig())
    runner = api.MatchupRunner(a, b, None, SimConfig(), "table", nano_tables=tables, **CPU)
    return {"heads": heads, "a": a, "b": b, "tables": tables, "runner": runner}


def _same_columns(got, want):
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


def _same_summary(got, want):
    for f in want._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(want, f)),
                                      err_msg=f)


def test_upcoming_matchup_table_equals_hand_built(files, hand, tmp_path, monkeypatch):
    """mode='table' without a focus sheet: the nano tables built from the
    loaded heads; the same games as the hand-built runner on the hand-built
    tables; the frames written with save_csv; the DataFrame wrapper."""
    monkeypatch.chdir(tmp_path)
    scores, players, summary, a, b, meta = api.simulate_upcoming_matchup_columns(
        "Team A", "Team B", sp_path=files["sp"], artifact_dir=ART, n=256, seed=3,
        save_csv="ab.csv", **CPU)
    assert (a, b) == (hand["a"], hand["b"])
    out = hand["runner"].run_pairs(256, seed=3, collect_players=True)
    _same_columns(scores, api.scores_columns(out, "Team A", "Team B"))
    _same_columns(players, api.players_columns(out, a, b))
    _same_columns(summary, api.summary_columns(scores))
    assert meta["sims"] == 256 and meta["mode"] == "table" and meta["io_time_sec"] > 0
    assert open("scores_ab.csv").read().splitlines()[0] == "team,opp,pts,opp_pts"
    assert len(open("scores_ab.csv").read().splitlines()) == 513
    sims_df, players_df, summ_df, *_ = api.simulate_upcoming_matchup(
        "Team A", "Team B", sp_path=files["sp"], artifact_dir=ART, n=256, seed=3, **CPU)
    pd.testing.assert_frame_equal(sims_df, pd.DataFrame(scores))
    assert list(summ_df.index) == ["Team A", "Team B"]
    np.testing.assert_array_equal(summ_df["win_rate"].to_numpy(), summary["win_rate"])
    assert api.csv_base_from("Team A", "Team B", 1) == "teama_teamb_wk1_sims.csv" == \
        japi.csv_base_from("Team A", "Team B", 1)


def test_upcoming_matchup_table_with_rosters_equals_hand_built(files):
    """mode='table' with a focus sheet whose players the heads split on
    (`fixtures.heads(0, "small")`): the heads do not fuse, so the runner
    builds the per-head tables; the same games and player rows as a
    hand-built table runner on the same contexts and heads."""
    cfg = SimConfig()
    cfg = cfg.replace(clock=dataclasses.replace(cfg.clock, game_seconds=900,
                                                half_seconds=450, quarter_seconds=225))
    heads = fixtures.heads(0, "small")
    scores, players, _, ca, cb, _ = api.simulate_upcoming_matchup_columns(
        "Team A", "Team B", sp_path=files["sp"], focus_csv=files["focus"], n=64, seed=5,
        mode="table", cfg=cfg, heads=heads, **CPU)
    a, b = _ctx(files, "Team A", "focus"), _ctx(files, "Team B", "focus")
    assert (a, b) == (ca, cb) and a.any_tracking
    runner = api.MatchupRunner(a, b, heads, cfg, "table", **CPU)
    th = runner.heads_state
    assert th.nano is None and th.fused is None and th.stage1.n_slots > 1
    out = runner.run_pairs(64, seed=5, collect_players=True)
    _same_columns(scores, api.scores_columns(out, "Team A", "Team B"))
    _same_columns(players, api.players_columns(out, a, b))
    assert len(players["sim"]) > 0


def test_focus_roster_routes_run_on_per_head_tables(files, monkeypatch):
    """A focus sheet whose players the heads split on, in table mode (the
    small fixture heads standing in for the artifact directory's): the
    live, 4th-down and parlay routes and the server's /sim run on the
    per-head tables, each equal to the same call on the hand-built runner,
    which the routes' runner memo shares (one build)."""
    from fast_monte_carlo_tpu_torch.serve import ServeConfig, SimService

    heads = fixtures.heads(0, "small")
    monkeypatch.setattr(api, "load_heads", lambda *a, **k: heads)
    kw = dict(sp_path=files["sp"], artifact_dir=ART, focus_csv=files["focus"], **CPU)
    row, s = api.simulate_live_game("Team A", "Team B", Q4, n_games=512, seed=4, **kw)
    runner = api.MatchupRunner(_ctx(files, "Team A", "focus"), _ctx(files, "Team B", "focus"),
                               heads, SimConfig(), "table", **CPU)
    th = runner.heads_state
    assert th.nano is None and th.fused is None and th.stage1.n_slots > 1
    row_h, s_h = api.simulate_live_game("Team A", "Team B", Q4, n_games=512, seed=4,
                                        runner=runner)
    assert row == row_h
    _same_summary(s, s_h)
    got = api.evaluate_fourth_down("Team A", "Team B", FOURTH, n_games=256, seed=2, **kw)
    assert got == api.evaluate_fourth_down("Team A", "Team B", FOURTH, n_games=256, seed=2,
                                           runner=runner)
    got = api.simulate_parlay_core("Team A", "Team B", LEGS, n_pairs=128, seed=6, **kw)
    assert got == api.simulate_parlay_core("Team A", "Team B", LEGS, n_pairs=128, seed=6,
                                           runner=runner)
    svc = SimService(ServeConfig(sp_path=files["sp"], artifact_dir=ART, mode="table",
                                 focus_csv=files["focus"], device="cpu"))
    out = svc.sim({"team_a": "Team A", "team_b": "Team B", "n_pairs": 128, "seed": 3})
    rows, _ = api.simulate_slate_summary_rows([("Team A", "Team B")], n_pairs=128, seed=3,
                                              **kw)
    assert out["summary"]["n_games"] == 256
    assert out["summary"]["mean_a"] == rows[0]["mean_a"]
    assert out["summary"]["win_a"] == rows[0]["win_a"]


def test_upcoming_matchup_exact_with_rosters_equals_hand_built(files, hand):
    """mode='exact' with a focus sheet (the heads split on these rosters'
    players): the same games and player rows as a hand-built exact runner.
    Games of 900 s keep the CPU's plain forest walk short."""
    cfg = SimConfig()
    cfg = cfg.replace(clock=dataclasses.replace(cfg.clock, game_seconds=900,
                                                half_seconds=450, quarter_seconds=225))
    scores, players, *_ = api.simulate_upcoming_matchup_columns(
        "Team A", "Team B", sp_path=files["sp"], artifact_dir=ART, focus_csv=files["focus"],
        n=16, seed=5, mode="exact", cfg=cfg, **CPU)
    a, b = _ctx(files, "Team A", "focus"), _ctx(files, "Team B", "focus")
    assert a.any_tracking
    out = api.MatchupRunner(a, b, hand["heads"], cfg, "exact", **CPU).run_pairs(
        16, seed=5, collect_players=True)
    _same_columns(scores, api.scores_columns(out, "Team A", "Team B"))
    _same_columns(players, api.players_columns(out, a, b))
    assert len(players["sim"]) > 0


@pytest.fixture(scope="module")
def jax_upcoming(files, tmp_path_factory):
    """The JAX package's simulate_upcoming_matchup on the same sheet and
    artifacts (table mode, 4,096 games)."""
    jdir = jax_readable_copy(ART, tmp_path_factory.mktemp("jaxart") / "art")
    return japi.simulate_upcoming_matchup("Team A", "Team B", sp_path=files["sp"],
                                          artifact_dir=jdir, n=2048, seed=0,
                                          collect_players=False)


def test_upcoming_matchup_agrees_with_jax(files, jax_upcoming):
    """Each team's mean points and its win rate in the games it started on
    offense within 4 standard errors of the JAX package's, and the
    contexts equal."""
    _, _, want, ja, jb, _ = jax_upcoming
    _, _, got, a, b, _ = api.simulate_upcoming_matchup_columns(
        "Team A", "Team B", sp_path=files["sp"], artifact_dir=ART, n=2048, seed=0,
        collect_players=False, **CPU)
    assert (a.sp_rating, a.sp_offense, b.sp_defense) == (ja.sp_rating, ja.sp_offense,
                                                         jb.sp_defense)
    n = 2048
    for i, team in enumerate(got["team"]):
        w = want.loc[team]
        se = np.hypot(got["sd_pts"][i], w["sd_pts"]) / np.sqrt(n)
        assert abs(got["mean_pts"][i] - w["mean_pts"]) <= 4 * se, team
        p = (got["win_rate"][i] + w["win_rate"]) / 2
        assert abs(got["win_rate"][i] - w["win_rate"]) <= 4 * np.sqrt(2 * p * (1 - p) / n), team
        assert 10 < got["mean_pts"][i] < 40


def _frames():
    """Scores and player columns of a focus-roster run on the fixture
    tables (player rows present)."""
    a, b = fixtures.focus_teams(3)
    r = api.MatchupRunner(a, b, None, SimConfig(), "table",
                          nano_tables=fixtures.nano_tables(7), **CPU)
    out = r.run_pairs(48, seed=2, collect_players=True)
    return api.scores_columns(out, a.name, b.name), api.players_columns(out, a, b)


@pytest.mark.parametrize("name", ["x.csv", "x.parquet", "x.parquet-fails"])
def test_save_frames_equal_jax(tmp_path, monkeypatch, name):
    """CSV through `csv`, byte for byte the JAX package's pandas files;
    parquet through pandas; a failing parquet write falls back to CSV at
    `<name>.csv` in both."""
    monkeypatch.chdir(tmp_path)
    scores, players = _frames()
    assert len(players["sim"]) > 0
    save = name.replace("-fails", "")
    if name.endswith("-fails"):
        def broken(*a, **k):
            raise OSError("no parquet writer")
        monkeypatch.setattr(pd.DataFrame, "to_parquet", broken)
    for pkg, sub in (("port", "p"), ("jax", "j")):
        os.makedirs(sub)
        os.chdir(sub)
        if pkg == "port":
            api._save_frames(save, scores, players)
        else:
            japi._save_frames(save, pd.DataFrame(scores), api._players_df(players))
        os.chdir("..")
    written = sorted(os.listdir("p"))
    assert written == sorted(os.listdir("j")) and len(written) == 2
    for f in written:
        if f.endswith(".parquet"):
            pd.testing.assert_frame_equal(pd.read_parquet(f"p/{f}"), pd.read_parquet(f"j/{f}"))
        else:
            assert open(f"p/{f}", "rb").read() == open(f"j/{f}", "rb").read(), f


def test_live_and_fourth_down_routes_equal_runner(files, hand):
    kw = dict(sp_path=files["sp"], artifact_dir=ART, **CPU)
    row, s = api.simulate_live_game("Team A", "Team B", Q4, n_games=1024, seed=4, **kw)
    row_h, s_h = api.simulate_live_game("Team A", "Team B", Q4, n_games=1024, seed=4,
                                        runner=hand["runner"])
    assert row == row_h
    _same_summary(s, s_h)
    sits = [Q4, Q4._replace(sec=1500, score_a=3)]
    cols, cs = api.simulate_live_curve_columns("Team A", "Team B", sits, n_games_per=256,
                                               seed=1, **kw)
    cols_h, cs_h = api.simulate_live_curve_columns("Team A", "Team B", sits, n_games_per=256,
                                                   seed=1, runner=hand["runner"])
    _same_columns(cols, cols_h)
    _same_summary(cs, cs_h)
    got = api.evaluate_fourth_down("Team A", "Team B", FOURTH, n_games=512, seed=2, **kw)
    assert got == api.evaluate_fourth_down("Team A", "Team B", FOURTH, n_games=512, seed=2,
                                           runner=hand["runner"])
    assert set(got["choices"]) == {"fg", "go", "policy", "punt"}


def test_parlay_route_equals_runner(files, hand):
    got = api.simulate_parlay_core("Team A", "Team B", LEGS, sp_path=files["sp"],
                                   artifact_dir=ART, n_pairs=512, seed=6, correlations=True,
                                   round_robin=2, **CPU)
    want = api.simulate_parlay_core("Team A", "Team B", LEGS, n_pairs=512, seed=6,
                                    correlations=True, round_robin=2, runner=hand["runner"])
    labels, corr = got.pop("leg_corr")
    labels_h, corr_h = want.pop("leg_corr")
    assert labels == labels_h
    np.testing.assert_array_equal(corr, corr_h)
    assert got == want
    with pytest.raises(ValueError):     # a bad leg fails before the runner
        api.simulate_parlay_core("Team A", "Team B", [{"kind": "nope"}], sp_path=files["sp"],
                                 artifact_dir=ART, **CPU)


def test_slate_routes_equal_hand_built(files, hand):
    """The loop layout over two games and the game_shard layout
    (SlateRunner(heads=)) over one, from the sheet and the artifacts, equal
    to the same layouts on the hand-built contexts and nano tables."""
    games = [("Team A", "Team B"), ("Team A", "Team B")]
    pairs, tables = [(hand["a"], hand["b"])] * 2, [hand["tables"]] * 2
    kw = dict(n_pairs=256, chunk_pairs=128, seed=9, **CPU)
    rows, summs = api.simulate_slate_summary_rows(games, sp_path=files["sp"],
                                                  artifact_dir=ART, layout="loop", **kw)
    rows_h, summs_h = api.simulate_slate_summary_rows(games, contexts=pairs,
                                                      nano_tables=tables, layout="loop", **kw)
    assert rows == rows_h and rows[0] != rows[1]
    for s, t in zip(summs, summs_h):
        _same_summary(s, t)
    rows, _ = api.simulate_slate_summary_rows(games[:1], sp_path=files["sp"], artifact_dir=ART,
                                              layout="game_shard", **kw)
    rows_h, _ = api.simulate_slate_summary_rows(games[:1], contexts=pairs[:1],
                                                nano_tables=tables[:1], layout="game_shard",
                                                **kw)
    assert rows == rows_h and rows[0]["n_games"] == 512
    got = api.simulate_slate_rows(games, sp_path=files["sp"], artifact_dir=ART, n=64, seed=2,
                                  **CPU)
    assert got == api.simulate_slate_rows(games, contexts=pairs, nano_tables=tables, n=64,
                                          seed=2, **CPU)


def test_slate_runner_from_heads_equals_hand_tables():
    """SlateRunner(heads=) builds each matchup's nano tables as
    nano_tables_from_heads does (the tables MatchupRunner(heads=) packs) and
    launches exactly what SlateRunner(nano_tables=) launches on them."""
    heads = fixtures.heads(0, "small")
    matchups, _ = fixtures.slate(2, 8)
    cfg = SimConfig()
    tables = [nano_tables_from_heads(a, b, heads, cfg) for a, b in matchups]
    from_heads = api.SlateRunner(matchups, heads, cfg, **CPU)
    by_hand = api.SlateRunner(matchups, None, cfg, nano_tables=tables, **CPU)
    assert torch.equal(from_heads.heads_state.nano_values, by_hand.heads_state.nano_values)
    single = api.MatchupRunner(*matchups[1], heads, cfg, "table", **CPU)
    per = single.heads_state.nano_values.shape[0]
    assert torch.equal(single.heads_state.nano_values,
                       from_heads.heads_state.nano_values[per:])
    out, out_h = from_heads.run(64, seed=3), by_hand.run(64, seed=3)
    for f in out._fields:
        assert torch.equal(getattr(out, f), getattr(out_h, f)), f
    sr = api.SlateRunner(matchups, heads, cfg, game_shard=True, **CPU)
    sr_h = api.SlateRunner(matchups, None, cfg, nano_tables=tables, game_shard=True, **CPU)
    assert sr.run_summary_rows(64, seed=1)[0] == sr_h.run_summary_rows(64, seed=1)[0]


def test_season_route_equals_hand_built(files, hand):
    games = [("Team A", "Team B")] * 2          # a rematch, as a title game can be
    kw = dict(n_pairs=256, chunk_pairs=256, seed=3, line=1.5, **CPU)
    got = api.project_season_rows("Team A", games=games, sp_path=files["sp"],
                                  artifact_dir=ART, **kw)
    want = api.project_season_rows("Team A", games=games,
                                   contexts=[(hand["a"], hand["b"])] * 2,
                                   nano_tables=[hand["tables"]] * 2, **kw)
    assert got == want and len(got["schedule"]) == 2


def test_slate_props_route_equals_hand_built(files, hand):
    """A prop sheet over the focus rosters in exact mode (the heads split on
    these players, so their tables would not fuse), 900-s games: the sheet
    route equals the same scan on hand-built contexts."""
    cfg = SimConfig()
    cfg = cfg.replace(clock=dataclasses.replace(cfg.clock, game_seconds=900,
                                                half_seconds=450, quarter_seconds=225))
    props = fixtures.prop_rows(4)
    games = [("Team A", "Team B")]
    kw = dict(props_csv=props, n_pairs=16, seed=5, min_abs_edge_pct=0.0, mode="exact",
              cfg=cfg, artifact_dir=ART, **CPU)
    got = api.simulate_slate_prop_rows(games, sp_path=files["sp"], focus_csv=files["focus"],
                                       **kw)
    a, b = _ctx(files, "Team A", "focus"), _ctx(files, "Team B", "focus")
    assert got == api.simulate_slate_prop_rows(games, contexts=[(a, b)], **kw)
    assert len(got) == 33        # the sheet's resolvable rows


def test_route_refusals(files, hand, tmp_path):
    """What still raises on the routes: heads without stage 1 (an empty
    artifact directory) and a missing sheet.  Trial sharding no longer
    raises: in a world of one it plays the unsharded games bit for bit.
    sd_mode 'cachewarm' no longer raises: it is held to the JAX package in
    test_torch_cachewarm.py."""
    kw = dict(sp_path=files["sp"], artifact_dir=ART, **CPU)
    row, s = api.simulate_live_game("Team A", "Team B", Q4, n_games=64, **kw, shard=True)
    row0, s0 = api.simulate_live_game("Team A", "Team B", Q4, n_games=64, **kw)
    assert row == row0 and all(np.array_equal(x, y, equal_nan=True) for x, y in zip(s, s0))
    got = api.simulate_upcoming_matchup_columns("Team A", "Team B", n=8, shard=True, **kw)
    want = api.simulate_upcoming_matchup_columns("Team A", "Team B", n=8, **kw)
    for g, w in zip(got[:3], want[:3]):
        assert g.keys() == w.keys() and all(np.array_equal(g[c], w[c]) for c in g)
    with pytest.raises(ValueError, match="stage 1"):
        api.simulate_live_game("Team A", "Team B", Q4, sp_path=files["sp"],
                               artifact_dir=str(tmp_path), **CPU)
    with pytest.raises(FileNotFoundError):
        api.simulate_slate_summary_rows([("Team A", "Team B")], artifact_dir=ART,
                                        sp_path=str(tmp_path / "none.csv"), **CPU)
    with pytest.raises(ValueError, match="no SP\\+ row matches"):
        api.evaluate_fourth_down("Team A", "Nowhere U", FOURTH, **kw)

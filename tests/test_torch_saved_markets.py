"""The markets over saved sim files (`edge.py`'s file half) and
`parallel.aggregate.player_stat_probs`, on the CPU, held to the JAX package.

The files are what both packages' `_save_frames` write (CSV and parquet)
from one seeded focus-roster run of the port, plus the reference's packed
players layout (columns 0, 1, ... of dict strings).  Over the same files
every market dict, row and printed line of the port equals the JAX
package's exactly: the port reads a CSV as pandas does, bit for bit, also
where pandas' parser lands an ulp away from Python's float on a 17-digit
yard cell.  `player_stat_probs` equals the JAX function's probabilities
exactly; its mean sums in float64 and rounds once, the JAX package sums in
float32, so the two means agree within 2e-7 relative."""
import contextlib
import io
import math
import os
import sys

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from fast_monte_carlo_tpu import api as japi
from fast_monte_carlo_tpu import edge as jedge
from fast_monte_carlo_tpu.parallel.aggregate import player_stat_probs as jax_player_stat_probs
from fast_monte_carlo_tpu_torch import api, edge, fixtures
from fast_monte_carlo_tpu_torch.config import SimConfig
from fast_monte_carlo_tpu_torch.data import columns
from fast_monte_carlo_tpu_torch.parallel import player_stat_probs

torch.set_num_threads(1)

BASE = "teama_teamb_wk1_sims.csv"
PQ_BASE = "teama_teamb_wk1_sims.parquet"
A, B = "Team A", "Team B"
QB = fixtures.roster_name(A, "pass", 0)
RB = fixtures.roster_name(B, "rush", 1)
WR = fixtures.roster_name(B, "rec", 0)
PROPS = [(A, QB, "pass_yds", 230.5, None), (A, QB, "pass_yards", 215.0, "QB"),
         (B, RB, "rush_yds", 40.5, None), (B, WR, "rec", 4.0, None),
         (B, WR, "rec_td", 0.5, None), (A, QB, "INT", 1.0, "QB")]


def _frames(pairs: int = 384):
    a, b = fixtures.focus_teams(3)
    r = api.MatchupRunner(a, b, None, SimConfig(), "table",
                          nano_tables=fixtures.nano_tables(7), device="cpu")
    out = r.run_pairs(pairs, seed=5, collect_players=True)
    return api.scores_columns(out, a.name, b.name), api.players_columns(out, a, b)


def _packed(players: pd.DataFrame, k: int = 3) -> pd.DataFrame:
    """The reference's packed players layout: column j holds the dict text
    of every k-th row from j, padded with NaN."""
    recs = [str(d) for d in players.drop(columns=["team_low", "player_low"],
                                         errors="ignore").to_dict("records")]
    cols = {str(j): recs[j::k] for j in range(k)}
    n = max(len(v) for v in cols.values())
    return pd.DataFrame({c: v + [np.nan] * (n - len(v)) for c, v in cols.items()})


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """dirs: 'port' and 'jax' (CSV by each package's _save_frames),
    'parquet' (the JAX package's parquet) and 'packed' (CSV scores, packed
    players); the prop sheet; the run's columns."""
    scores, players = _frames()
    root = tmp_path_factory.mktemp("saved")
    dirs = {k: root / k for k in ("port", "jax", "parquet", "packed")}
    here = os.getcwd()
    try:
        for k, d in dirs.items():
            d.mkdir()
            os.chdir(d)
            if k == "port":
                api._save_frames(BASE, scores, players)
            elif k == "jax":
                japi._save_frames(BASE, pd.DataFrame(scores), api._players_df(players))
            elif k == "parquet":
                japi._save_frames(PQ_BASE, pd.DataFrame(scores), api._players_df(players))
            else:   # every 8th player row, literal_eval being slow
                pd.DataFrame(scores).to_csv(f"scores_{BASE}", index=False)
                _packed(api._players_df(players).iloc[::8]).to_csv(f"players_{BASE}",
                                                                     index=False)
    finally:
        os.chdir(here)
    sheet = root / "props.csv"
    fixtures.write_csv(sheet, fixtures.prop_rows(4), fixtures.PROP_COLS)
    return {"dirs": {k: str(v) for k, v in dirs.items()}, "props": str(sheet),
            "scores": scores, "players": players, "root": root}


def _base(layout: str) -> str:
    return PQ_BASE if layout == "parquet" else BASE


def _same(got, want):
    """Equal dicts, NaN equal to NaN (a market of a side with no rows)."""
    assert list(got) == list(want)
    for k in want:
        if isinstance(want[k], dict):
            _same(got[k], want[k])
        elif isinstance(want[k], float) and math.isnan(want[k]):
            assert math.isnan(got[k]), k
        else:
            assert got[k] == want[k] and type(got[k]) is type(want[k]), (k, got[k], want[k])


def _out(fn, *a, **k) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*a, **k)
    return buf.getvalue()


def test_saved_files_are_the_jax_packages(saved):
    """Both packages' _save_frames wrote the same CSV bytes, so every test
    below reads files the JAX package writes."""
    for name in (f"scores_{BASE}", f"players_{BASE}"):
        assert (open(os.path.join(saved["dirs"]["port"], name), "rb").read()
                == open(os.path.join(saved["dirs"]["jax"], name), "rb").read())


@pytest.mark.parametrize("layout", ["port", "parquet"])
def test_load_table_equals_jax(saved, layout):
    d = saved["dirs"][layout]
    for kind in ("scores", "players"):
        path = os.path.join(d, f"{kind}_{_base(layout)}")
        pd.testing.assert_frame_equal(edge.load_table(path), jedge.load_table(path))
        cols = edge.read_table_columns(path)
        want = jedge.load_table(path)
        assert list(cols) == list(want.columns)
        for c in want.columns:
            np.testing.assert_array_equal(cols[c], want[c].to_numpy(), err_msg=c)


@pytest.mark.parametrize("layout", ["port", "parquet", "packed"])
def test_load_players_table_equals_jax(saved, layout):
    path = os.path.join(saved["dirs"][layout], f"players_{_base(layout)}")
    got, want = edge.load_players_table(path), jedge.load_players_table(path)
    assert list(got.columns) == list(want.columns) and len(got) == len(want) > 0
    for c in want.columns:
        g, w = got[c].to_numpy(), want[c].to_numpy()
        assert g.dtype.kind == w.dtype.kind or {g.dtype.kind, w.dtype.kind} <= {"O", "U"}, c
        assert all(x == y or (x != x and y != y) for x, y in zip(g, w)), c


@pytest.mark.parametrize("layout", ["port", "parquet", "packed"])
def test_player_prop_odds_equals_jax(saved, layout):
    d = saved["dirs"][layout]
    players = jedge.load_players_table(os.path.join(d, f"players_{_base(layout)}"))
    for team, player, stat, line, role in PROPS:
        want = jedge.player_prop_odds(_base(layout), team, player, stat, line, role=role,
                                      directory=d)
        _same(edge.player_prop_odds(_base(layout), team, player, stat, line, role=role,
                                    directory=d), want)
        _same(edge.player_prop_odds(None, team, player, stat, line, role=role,
                                    players_df=players), want)
        _same(edge.player_prop_odds(None, team, player, stat, line, role=role,
                                    players_df=columns.columns_of(players)), want)


def test_player_prop_errors_equal_jax(saved, tmp_path):
    d = saved["dirs"]["port"]
    cases = [((BASE, A, "Nobody", "pass_yds", 200.5), ValueError),
             ((BASE, A, QB, "fantasy_pts", 20.5), ValueError),
             ((BASE, B, QB, "pass_yds", 200.5), ValueError),
             (("nothere.csv", A, QB, "pass_yds", 200.5), FileNotFoundError)]
    for args, exc in cases:
        for mod in (edge, jedge):
            with pytest.raises(exc):
                mod.player_prop_odds(*args, directory=d)
    # scores saved without players: no players file
    os.makedirs(tmp_path / "noplayers")
    pd.DataFrame(saved["scores"]).to_csv(tmp_path / "noplayers" / f"scores_{BASE}", index=False)
    for mod in (edge, jedge):
        with pytest.raises(FileNotFoundError, match="no players_"):
            mod.player_prop_odds(BASE, A, QB, "pass_yds", 200.5,
                                 directory=str(tmp_path / "noplayers"))


@pytest.mark.parametrize("layout", ["port", "parquet"])
def test_game_markets_equal_jax(saved, layout):
    d = saved["dirs"][layout]
    sims = jedge.load_table(os.path.join(d, f"scores_{_base(layout)}"))
    for team, opp in ((A, B), (B, A), ("team a", "TEAM B")):
        for spread, total in ((-3.5, 44.5), (7.0, None), (None, 41.0)):
            want = jedge.game_market_odds(_base(layout), team, opp, spread=spread,
                                          total=total, directory=d)
            _same(edge.game_market_odds(_base(layout), team, opp, spread=spread,
                                        total=total, directory=d), want)
            _same(edge.game_market_odds(None, team, opp, spread=spread, total=total,
                                        sims=sims), want)
        _same(edge.moneyline_from_sims(_base(layout), team, opp, directory=d),
              jedge.moneyline_from_sims(_base(layout), team, opp, directory=d))
        _same(edge.moneyline_from_sims(None, team, opp, sims=columns.columns_of(sims)),
              jedge.moneyline_from_sims(None, team, opp, sims=sims))
        got, want = edge._margin_dist(sims, team, opp), jedge._margin_dist(sims, team, opp)
        np.testing.assert_array_equal(got.values, want.values)
        rows = edge._team_rows(sims, team, opp)
        np.testing.assert_array_equal(rows["pts"], jedge._team_rows(sims, team, opp)["pts"])
    for mod in (edge, jedge):
        with pytest.raises(ValueError, match="no rows"):
            mod.game_market_odds(None, A, "Team C", spread=3.0, sims=sims)
        with pytest.raises(ValueError, match="nothing to price"):
            mod.game_market_odds(None, A, B, sims=sims)


def test_moneyline_with_one_side_missing_equals_jax(saved):
    """Only team A's rows: the other side's price is one minus A's, as in
    the JAX package; no rows at all: both refuse to price NaN."""
    sims = pd.DataFrame(saved["scores"])
    one = sims[sims["team"] == A]
    _same(edge.moneyline_from_sims(None, A, B, sims=one),
          jedge.moneyline_from_sims(None, A, B, sims=one))
    _same(edge.moneyline_from_sims(None, B, A, sims=one),
          jedge.moneyline_from_sims(None, B, A, sims=one))
    for mod in (edge, jedge):
        with pytest.raises(ValueError):
            mod.moneyline_from_sims(None, "X", "Y", sims=one)


@pytest.mark.parametrize("layout,min_edge", [("port", 2.0), ("port", 0.0), ("parquet", 2.0),
                                             ("packed", 5.0)])
def test_scan_props_equals_jax(saved, layout, min_edge):
    d = saved["dirs"][layout]
    want = jedge.scan_props_for_matchup(_base(layout), A, B, saved["props"], directory=d,
                                        min_abs_edge_pct=min_edge)
    got = edge.scan_props_for_matchup(_base(layout), A, B, saved["props"], directory=d,
                                      min_abs_edge_pct=min_edge)
    assert len(want) > 5
    pd.testing.assert_frame_equal(got, want)
    rows = edge.scan_props_for_matchup_rows(_base(layout), A, B, saved["props"],
                                            directory=d, min_abs_edge_pct=min_edge)
    assert rows == want.to_dict("records")
    players = jedge.load_players_table(os.path.join(d, f"players_{_base(layout)}"))
    pd.testing.assert_frame_equal(
        edge.scan_props_for_matchup(None, A, B, saved["props"], players_df=players,
                                    min_abs_edge_pct=min_edge),
        jedge.scan_props_for_matchup(None, A, B, saved["props"], players_df=players,
                                     min_abs_edge_pct=min_edge))


def test_scan_props_ties_and_skipped_rows_equal_jax(saved, tmp_path):
    """Rows that tie on |edge| and EV keep their sheet order (pandas' sort
    is stable); rows a scan cannot price are skipped as in the JAX package:
    an empty or junk line, an unknown player or stat, an empty player cell,
    a team outside the matchup; the fuzzy search (no base) finds the file."""
    sheet = tmp_path / "props.csv"
    wr_a = fixtures.roster_name(A, "rec", 0)
    rows = [{"team": B, "player": WR, "stat": "rec", "yards": 3.5},
            {"team": B, "player": WR, "stat": "rec_td", "yards": 99.5},  # under for sure:
            {"team": A, "player": wr_a, "stat": "rec_td", "yards": 99.5},  # the edge and EV
            {"team": B, "player": WR, "stat": "tgt", "yards": 99.5},     # of all three tie
            {"team": A, "player": QB, "stat": "INT", "yards": 1.5},      # role Receiver
            {"team": A, "player": QB, "stat": "pass_yds", "yards": ""},
            {"team": A, "player": QB, "stat": "pass_yds", "yards": "junk"},
            {"team": A, "player": "", "stat": "pass_yds", "yards": 200.5},
            {"team": A, "player": "Nobody", "stat": "pass_yds", "yards": 200.5},
            {"team": "team b", "player": WR.upper(), "stat": "rec_yards", "yards": 40.5},
            {"team": "Team C", "player": QB, "stat": "pass_yds", "yards": 200.5},
            {"team": A, "player": QB, "stat": "", "yards": 200.5}]
    fixtures.write_csv(sheet, rows, fixtures.PROP_COLS)
    d = saved["dirs"]["port"]
    for base in (BASE, None):
        want = jedge.scan_props_for_matchup(base, A, B, str(sheet), directory=d,
                                            min_abs_edge_pct=0.0)
        got = edge.scan_props_for_matchup(base, A, B, str(sheet), directory=d,
                                          min_abs_edge_pct=0.0)
        pd.testing.assert_frame_equal(got, want)
        assert (want["edge_pct"].abs() == 47.62).sum() >= 3     # the tie is real
    empty = tmp_path / "none.csv"
    fixtures.write_csv(empty, rows[-2:], fixtures.PROP_COLS)
    assert edge.scan_props_for_matchup(BASE, A, B, str(empty), directory=d).empty
    assert jedge.scan_props_for_matchup(BASE, A, B, str(empty), directory=d).empty
    assert edge.scan_props_for_matchup_rows(BASE, A, B, str(empty), directory=d) == []


@pytest.mark.parametrize("layout", ["port", "parquet"])
def test_ladders_and_middles_equal_jax(saved, layout):
    d = saved["dirs"][layout]
    sims = jedge.load_table(os.path.join(d, f"scores_{_base(layout)}"))
    for kw in ({"spread": -3.5, "total": 44.5}, {"spread": 2.0, "width": 3.0, "step": 0.5},
               {"total": 40.0, "price": -120}):
        want = jedge.alt_lines_from_sims(sims, A, B, **kw)
        got = edge.alt_lines_from_sims(sims, A, B, **kw)
        assert list(got) == list(want)
        for k in want:
            pd.testing.assert_frame_equal(got[k], want[k])
        assert edge.alt_line_rows_from_sims(sims, A, B, **kw) == {
            k: v.to_dict("records") for k, v in want.items()}
    for kw in ({"mid_spread": (-3.5, 7.5), "mid_total": (40.5, 47.5)},
               {"mid_total": (41.0, 45.0), "price": -105}):
        assert edge.middles_from_sims(sims, A, B, **kw) == jedge.middles_from_sims(
            sims, A, B, **kw)
    for team, player, stat, line, role in PROPS:
        for kw in ({}, {"width": 4.0, "step": 1.0, "price": 110}):
            pd.testing.assert_frame_equal(
                edge.player_prop_ladder(_base(layout), team, player, stat, line, role=role,
                                        directory=d, **kw),
                jedge.player_prop_ladder(_base(layout), team, player, stat, line, role=role,
                                         directory=d, **kw))
        assert edge._prop_ladder_grid(stat) == jedge._prop_ladder_grid(stat)
        assert edge.infer_role_from_stat(stat) == jedge.infer_role_from_stat(stat)
    dist = jedge.Dist.from_values(sims["pts"].to_numpy())
    pd.testing.assert_frame_equal(
        edge.alt_prop_table(edge.Dist.from_values(sims["pts"].to_numpy()), [20.5, 21, 30]),
        jedge.alt_prop_table(dist, [20.5, 21, 30]))
    for mod in (edge, jedge):
        with pytest.raises(ValueError, match="no rows"):
            mod.alt_lines_from_sims(sims, A, "Team C", spread=1.0)
        with pytest.raises(ValueError, match="no rows"):
            mod.middles_from_sims(sims, "Team C", B, mid_total=(40.5, 47.5))


def test_printers_equal_jax(saved, tmp_path):
    """print_game_market_readable (with the projected scores, a zero margin
    among them), print_moneyline_readable, print_prop_table (rows or a
    DataFrame, ties within a group) and find_edges print the JAX package's
    lines."""
    d = saved["dirs"]["port"]
    gm = jedge.game_market_odds(BASE, A, B, spread=-3.5, total=44.5, directory=d)
    for res in (gm, {"spread": gm["spread"]}, {"total": gm["total"]}, {}):
        assert _out(edge.print_game_market_readable, res) == _out(
            jedge.print_game_market_readable, res)
    zero = {"spread": {**gm["spread"], "mean_margin": 0.0, "median_margin": -1.0},
            "total": gm["total"]}
    assert _out(edge._print_projected_scores, zero) == _out(jedge._print_projected_scores, zero)
    ml = jedge.moneyline_from_sims(BASE, A, B, directory=d)
    assert _out(edge.print_moneyline_readable, ml) == _out(jedge.print_moneyline_readable, ml)
    table = jedge.scan_props_for_matchup(BASE, A, B, saved["props"], directory=d,
                                         min_abs_edge_pct=0.0)
    tied = pd.concat([table, table.iloc[:3]]).reset_index(drop=True)
    tied.loc[len(tied) - 1, "stat"] = "receptions"
    for t in (table, tied, table.iloc[:0], pd.DataFrame(), None):
        want = _out(jedge.print_prop_table, t)
        assert _out(edge.print_prop_table, t) == want
        if t is not None and not t.empty:
            assert _out(edge.print_prop_table, t.to_dict("records")) == want
    for kw in ({"spread": -3.5, "total": 44.5, "props_csv": saved["props"]},
               {"spread": None, "total": None, "props_csv": saved["props"]},
               {"spread": 1.5, "total": None, "props_csv": str(tmp_path / "missing.csv")}):
        for base in (BASE, None):
            assert _out(edge.find_edges, csv_base=base, team_a=A, team_b=B, directory=d,
                        **kw) == _out(jedge.find_edges, csv_base=base, team_a=A, team_b=B,
                                      directory=d, **kw)


def test_find_saved_files_equals_jax(tmp_path):
    """The search order (a base's parquet before its CSV; for teams, sorted
    scores_*.csv, then sorted scores_*.parquet), the players partner, and
    the same exceptions for a missing file or no team."""
    names = ["scores_teama_teamb_wk1_sims.csv", "scores_teama_teamb_wk1_sims.parquet",
             "players_teama_teamb_wk1_sims.parquet", "scores_teama_teamb_wk2_sims.csv",
             "scores_aaa_teama_teamb.parquet", "players_teama_teamb_wk2_sims.csv",
             "scores_teamc_teama_wk1_sims.csv"]
    for n in names:
        (tmp_path / n).write_text("x\n")
    d = str(tmp_path)
    calls = [dict(csv_base="teama_teamb_wk1_sims"), dict(csv_base="teama_teamb_wk1_sims.csv"),
             dict(csv_base="teama_teamb_wk2_sims.csv"),
             dict(csv_base="teama_teamb_wk1_sims.parquet"),
             dict(team_a="Team A", team_b="Team B"), dict(team_a="team-a"),
             dict(team_a="Team C", team_b="Team A"), dict(team_a="Team B", team_b="Team A")]
    for kw in calls:
        assert edge.find_saved_files(directory=d, **kw) == jedge.find_saved_files(
            directory=d, **kw), kw
    for kw, exc in ((dict(csv_base="nothere"), FileNotFoundError),
                    (dict(team_a="Team Z"), FileNotFoundError), ({}, ValueError)):
        for mod in (edge, jedge):
            with pytest.raises(exc):
                mod.find_saved_files(directory=d, **kw)


@pytest.mark.parametrize("layout", ["plain", "quoted"])
def test_read_csv_columns_equals_pandas(tmp_path, layout):
    """Every column typed and valued as pandas' read_csv gives it, bit for
    bit: 17-digit floats (where pandas' parser and Python's float part by
    an ulp), float32 values widened, e-notation, whole numbers with and
    without NA cells, booleans, text with NA strings, spaces around a
    number, infinities, blank lines, duplicate headers; cut in bulk
    ("plain"), or by the `csv` module where a cell is quoted and a row is
    short ("quoted")."""
    quoted = layout == "quoted"
    rng = np.random.default_rng(0)
    n = 4000
    x = rng.standard_normal(n) * 10.0 ** rng.integers(-12, 12, n)
    cols = {
        "f17": [repr(float(v)) for v in x],
        "f32": [repr(float(np.float32(v))) for v in x],
        "e": [f"{v:.16e}" for v in x],
        "short": [f"{v:.3f}" for v in x],
        "ints": [str(v) for v in rng.integers(-10 ** 12, 10 ** 12, n)],
        "intna": ["" if i % 7 == 0 else str(i) for i in range(n)],
        "mixed": ["x" if i == 5 else "1.5" for i in range(n)],
        "bools": ["True" if i % 2 else "false" for i in range(n)],
        "boolna": ["True" if i % 2 else "NA" for i in range(n)],
        "text": [["Team A", "N/A", "", "null", "x,y" if quoted else "x y"][i % 5]
                 for i in range(n)],
        "ws": [" 3.25 " if i % 3 == 0 else "4.5" for i in range(n)],
        "inf": ["inf" if i % 3 == 0 else "-Infinity" if i % 5 == 0 else "1e-320"
                for i in range(n)],
        "lead": ["+.5" if i % 2 else "5." for i in range(n)],
        "long": ["123456789012345678901.5" if i % 2 else "0.0000000000000000000123456789012345678"
                 for i in range(n)],
        "dup": [str(i) for i in range(n)],
    }
    path = tmp_path / "cells.csv"
    names = list(cols) + ["dup"]
    with open(path, "w") as f:
        f.write(",".join(names) + "\n")
        for i in range(n):
            cells = [cols[k][i] for k in cols] + [cols["dup"][i]]
            f.write(",".join(f'"{c}"' if "," in c else c for c in cells) + "\n")
            if i == 10:
                f.write("\n")
        if quoted:
            f.write("1.5,2\n")
    assert (columns._byte_fields(path.read_bytes()) is None) == quoted
    got, want = columns.read_csv_columns(path), pd.read_csv(path)
    assert list(got) == list(want.columns)
    for c in want.columns:
        g, w = got[c], want[c].to_numpy()
        if w.dtype.kind in "fiub":
            assert g.dtype == w.dtype, c
            np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8), err_msg=c)
        else:
            assert g.dtype == object and all(
                x == y and type(x) is type(y) or (x != x and y != y) for x, y in zip(g, w)), c
    bad = tmp_path / "bad.csv"
    for text in ("a,b\n1,2,3\n", "a,b\n1,2\n1,2,3\n", ""):
        bad.write_text(text)
        with pytest.raises(ValueError):
            columns.read_csv_columns(bad)
    bad.write_text("a,b\n")
    assert {k: v.dtype for k, v in columns.read_csv_columns(bad).items()} == {
        k: v.to_numpy().dtype for k, v in pd.read_csv(bad).items()}


def test_csv_read_probe_on_the_cpu(capsys):
    """probes/csv_read.py writes a players file, reads it with both
    splitters, finds them equal and prints both times."""
    from fast_monte_carlo_tpu_torch.probes import csv_read

    assert csv_read.main(["--pairs", "64", "--reps", "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "read, numpy splitter" in out and "read, csv splitter" in out


def test_parquet_without_pandas_raises(saved, monkeypatch):
    """A host without pandas reads the CSV files and refuses a parquet path
    by naming pandas, with no silent skip."""
    monkeypatch.setitem(sys.modules, "pandas", None)
    d = saved["dirs"]
    assert len(edge.read_table_columns(os.path.join(d["port"], f"scores_{BASE}"))["pts"]) > 0
    with pytest.raises(ModuleNotFoundError, match="pandas"):
        edge.read_table_columns(os.path.join(d["parquet"], f"scores_{PQ_BASE}"))
    with pytest.raises(ModuleNotFoundError, match="pandas"):
        edge.game_market_odds(PQ_BASE, A, B, spread=1.5, directory=d["parquet"])


@pytest.mark.parametrize("seed", [0, 1])
def test_player_stat_probs_equals_jax(seed):
    """p_over, p_under and push exactly the JAX function's, over pstats of
    whole-number counts and fractional yards, lines on the values (pushes)
    and between them; the mean within 2e-7 relative (f64 sum here, f32 in
    XLA's order there)."""
    rng = np.random.default_rng(seed)
    b, k = 4096, 8
    pstats = rng.integers(0, 12, (b, 2, 3, k, 6)).astype(np.float32)
    yards = rng.normal(60, 45, (b, 2, 3, k)).astype(np.float32)
    pstats[..., 2] = np.where(rng.random((b, 2, 3, k)) < 0.1, 0, yards)
    t = torch.from_numpy(pstats)
    for team, role, slot, col, line in [(0, 0, 0, 2, 60.5), (1, 1, 2, 2, float(yards[3, 1, 1, 2])),
                                        (0, 2, 1, 0, 4.0), (1, 0, 0, 4, 1.0),
                                        (0, 2, 7, 1, 0.0), (1, 2, 3, 3, 2.5)]:
        got = player_stat_probs(t, team, role, slot, col, line)
        want = jax_player_stat_probs(jnp.asarray(pstats), team, role, slot, col, line)
        assert all(v.dtype == torch.float32 for v in got.values())
        for key in ("p_over", "p_under", "push"):
            assert got[key].item() == float(want[key]), key
        assert got["mean"].item() == pytest.approx(float(want["mean"]), rel=2e-7, abs=1e-12)
        v = pstats[:, team, role, slot, col]
        assert got["mean"].item() == np.float32(v.astype(np.float64).mean())
    assert float(player_stat_probs(t, 1, 1, 2, 2, float(yards[3, 1, 1, 2]))["push"]) > 0

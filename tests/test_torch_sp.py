"""The port's SP+ sheet readers and team contexts (`data/sp.py`,
`data/context.py`) against the JAX package's (pandas) on the same sheets,
written here from seeds: the same tables, the same three floats for every
team, the same contexts field by field."""
import csv
import os

import numpy as np
import pytest
import torch

from fast_monte_carlo_tpu.data import context as jctx
from fast_monte_carlo_tpu.data import sp as jsp
from fast_monte_carlo_tpu_torch import fixtures
from fast_monte_carlo_tpu_torch.data import context as tctx
from fast_monte_carlo_tpu_torch.data import sp as tsp

from test_torch_support import write_focus

torch.set_num_threads(1)

N_TEAMS = 136


def _write(path, header, rows):
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)
    return str(path)


def _clear():
    for m in (jsp, tsp):
        m.load_sp_flex.cache_clear()
        m.load_sp_historical.cache_clear()


@pytest.fixture(autouse=True)
def _fresh_caches():
    _clear()
    yield
    _clear()


def _same_table(port, jax_df):
    assert port.columns == list(jax_df.columns)
    assert len(port) == len(jax_df)
    for c in port.columns:
        want = jax_df[c].to_numpy()
        if want.dtype.kind == "f":
            np.testing.assert_array_equal(port[c], want, err_msg=c)
            assert port[c].dtype == np.float64
        else:
            assert [str(v) for v in port[c]] == [str(v) for v in want], c


def _schema_a(path, rng, n=40):
    """Schema A with the sheet's extra columns, a blank team, a duplicate
    team, a padded name and a missing rating."""
    rows = [[f"Team {i:03d}", round(float(rng.normal(5, 12)), 1),
             round(float(rng.uniform(18, 42)), 1), round(float(rng.uniform(12, 36)), 1),
             2025, 3] for i in range(n)]
    rows[5][0] = ""
    rows[7][0] = rows[3][0]
    rows[9][0] = "  Team 009 "
    rows[11][1] = ""
    return _write(path, ["team", "RATING", "OFFENSE", "DEFENSE", "year", "week"], rows)


def test_schema_b_sheet_equals_jax_and_resolves_every_team(tmp_path):
    """The fixture sheet in the 2025 schema: the same table (Current rows,
    then Past-only rows, blanks dropped, duplicates kept first) and every
    team's three floats equal to the JAX package's."""
    path = fixtures.write_sp_sheet(tmp_path / "sp.csv", N_TEAMS, 0)
    port, jdf = tsp.load_sp_flex(path), jsp.load_sp_flex(path)
    _same_table(port, jdf)
    assert len(port) == N_TEAMS + 2          # two Past-only teams
    for team in list(jdf["team"]):
        got = tsp.lookup_sp_flex(team, port)
        assert got == jsp.lookup_sp_flex(team, jdf), team
        assert all(isinstance(v, float) for v in got)
    assert tsp.lookup_sp_flex("Team A", port) == fixtures.TEAM_A[3:]


def test_schema_a_sheet_equals_jax(tmp_path):
    path = _schema_a(tmp_path / "a.csv", np.random.default_rng(1))
    port, jdf = tsp.load_sp_flex(path), jsp.load_sp_flex(path)
    _same_table(port, jdf)
    names = list(port["team"])
    assert "Team 009" in names and sum(isinstance(t, float) and np.isnan(t) for t in names) == 1
    for team in [t for t in jdf["team"] if isinstance(t, str)] + ["nan", "NaN"]:
        np.testing.assert_array_equal(tsp.lookup_sp_flex(team, port),
                                      jsp.lookup_sp_flex(team, jdf))


def test_neither_schema_raises_the_jax_message(tmp_path):
    path = _write(tmp_path / "x.csv", ["school", "RATING", "Offense Rating"], [["A", 1, 2]])
    with pytest.raises(ValueError) as want:
        jsp.load_sp_flex(path)
    with pytest.raises(ValueError) as got:
        tsp.load_sp_flex(path)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("query", ["Team A", "team a", "TEAM-A", " team_a ", "Team 0",
                                   "eam 01", "Past Team", "Team", "Nobody", "team 99"])
def test_lookup_strategies_equal_jax(tmp_path, query):
    """Normalized, then case-insensitive, then substring matches, the first
    row winning; no match raises the same ValueError."""
    path = fixtures.write_sp_sheet(tmp_path / "sp.csv", N_TEAMS, 3)
    port, jdf = tsp.load_sp_flex(path), jsp.load_sp_flex(path)
    try:
        want = jsp.lookup_sp_flex(query, jdf)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tsp.lookup_sp_flex(query, port)
        assert str(got.value) == str(e)
        return
    assert tsp.lookup_sp_flex(query, port) == want


def test_duplicate_and_blank_rows_of_schema_b(tmp_path):
    """A team in both name columns keeps its Current row; blank names are
    dropped; a name that differs only by padding is a row of its own
    before the strip (as pandas' drop_duplicates sees it)."""
    header = list(fixtures.SP_SHEET_COLS)
    rows = [[1, "Alpha", 20.5, 35.0, 14.5, "Beta"],
            [2, "Beta", 10.0, 30.0, 20.0, "Alpha"],
            [3, "", 5.0, 25.0, 20.0, "Gamma"],
            [4, "Alpha ", 1.0, 20.0, 19.0, ""],
            [5, "NA", 2.0, 21.0, 19.0, "Delta"]]
    path = _write(tmp_path / "b.csv", header, rows)
    port, jdf = tsp.load_sp_flex(path), jsp.load_sp_flex(path)
    _same_table(port, jdf)
    assert list(port["team"]) == ["Alpha", "Beta", "Alpha", "Gamma", "Delta"]
    for q in ("Alpha", "Gamma", "Delta", "alp"):
        assert tsp.lookup_sp_flex(q, port) == jsp.lookup_sp_flex(q, jdf)


def _historical(path, rng):
    rows = []
    for team in ("Alpha", "Beta", "Gamma State"):
        for year in (2024, 2025):
            for week in (3, 1, 7, 5):
                rows.append([team, round(float(rng.normal(5, 10)), 2),
                             round(float(rng.uniform(20, 40)), 2),
                             round(float(rng.uniform(10, 30)), 2), year, week, "Big 12"])
    return _write(path, ["team", "RATING", "OFFENSE", "DEFENSE", "year", "week", "conference"],
                  rows)


@pytest.mark.parametrize("team,year,week", [
    ("Alpha", 2025, 4), ("alpha", 2024, 7), ("Beta", 2025, 9), ("Gamma State", 2025, 0),
    ("GAMMA STATE", 2024, 1), ("Beta", 2023, 5), ("Gamma", 2025, 5)])
def test_historical_lookup_equals_jax(tmp_path, team, year, week):
    """The latest week at or before the asked one, else the year's latest
    week; an unknown team or year raises the same ValueError."""
    path = _historical(tmp_path / "hist.csv", np.random.default_rng(4))
    _same_table(tsp.load_sp_historical(path), jsp.load_sp_historical(path))
    try:
        want = jsp.lookup_sp_historical(team, year, week, path)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tsp.lookup_sp_historical(team, year, week, path)
        assert str(got.value) == str(e)
        return
    assert tsp.lookup_sp_historical(team, year, week, path) == want


def assert_same_context(port, jax):
    for k in ("name", "year", "week", "sp_rating", "sp_offense", "sp_defense"):
        assert getattr(port, k) == getattr(jax, k), k
    for role in ("qb", "rush", "target"):
        p, j = getattr(port, role), getattr(jax, role)
        assert p.names == j.names, role
        for f in ("share", "tracked", "is_other"):
            np.testing.assert_array_equal(getattr(p, f), getattr(j, f), err_msg=f"{role}.{f}")
            assert getattr(p, f).dtype == getattr(j, f).dtype


@pytest.mark.parametrize("focus", [False, True])
@pytest.mark.parametrize("slots", [8, 4])
def test_contexts_from_the_sheet_equal_jax(tmp_path, focus, slots):
    """build_team_context_from_sp_flex, by sheet path and by table, with
    and without a focus sheet, for the two fixture teams and a filler team."""
    path = fixtures.write_sp_sheet(tmp_path / "sp.csv", N_TEAMS, 1)
    focus_csv = str(write_focus(tmp_path / "focus.csv")) if focus else None
    for team in ("Team A", "team b", "Team 010"):
        got = tctx.build_team_context_from_sp_flex(team, 2025, 2, sp_path=path,
                                                   focus_csv=focus_csv, player_slots=slots)
        want = jctx.build_team_context_from_sp_flex(team, 2025, 2, sp_path=path,
                                                    focus_csv=focus_csv, player_slots=slots)
        assert_same_context(got, want)
        by_table = tctx.build_team_context_from_sp_flex(
            team, 2025, 2, tsp.load_sp_flex(path), focus_csv=focus_csv, player_slots=slots)
        assert by_table is got
    assert got.any_tracking is False
    with pytest.raises(ValueError, match="provide sp_df or sp_path"):
        tctx.build_team_context_from_sp_flex("Team A", 2025, 1)


@pytest.mark.parametrize("focus", [False, True])
def test_contexts_from_the_historical_table_equal_jax(tmp_path, focus):
    path = _historical(tmp_path / "hist.csv", np.random.default_rng(5))
    focus_csv = str(write_focus(tmp_path / "focus.csv")) if focus else None
    for team, week in (("Alpha", 6), ("gamma state", 2)):
        assert_same_context(
            tctx.build_team_context(team, 2025, week, sp_hist_path=path, focus_csv=focus_csv),
            jctx.build_team_context(team, 2025, week, sp_hist_path=path, focus_csv=focus_csv))


def test_context_memo_hits_and_misses_as_jax(tmp_path):
    """The context memo keys on content: the same sheet read again hits (a
    new table of the same content too), a rewritten sheet or focus sheet
    misses, in both packages alike."""
    path = fixtures.write_sp_sheet(tmp_path / "sp.csv", N_TEAMS, 2)
    focus_csv = str(write_focus(tmp_path / "focus.csv"))
    outs = {}
    for name, sp_mod, ctx_mod in (("port", tsp, tctx), ("jax", jsp, jctx)):
        def build(team="Team A"):
            return ctx_mod.build_team_context_from_sp_flex(
                team, 2025, 1, sp_mod.load_sp_flex(path), focus_csv=focus_csv)
        first = build()
        hits = [build() is first]
        sp_mod.load_sp_flex.cache_clear()           # a new table, the same content
        hits.append(build() is first)
        rows = fixtures.sp_sheet_rows(N_TEAMS, 2)
        rows[[r["Current SP+"] for r in rows].index("Team A")]["Rating"] = 99.5
        fixtures.write_csv(path, rows, fixtures.SP_SHEET_COLS)
        sp_mod.load_sp_flex.cache_clear()
        rewritten = build()
        hits.append(rewritten is first)
        st = os.stat(focus_csv)
        write_focus(tmp_path / "focus.csv", seed=9)
        os.utime(focus_csv, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
        hits.append(build() is rewritten)
        outs[name] = (hits, rewritten.sp_rating)
        fixtures.write_sp_sheet(path, N_TEAMS, 2)
        write_focus(tmp_path / "focus.csv")
    assert outs["port"] == outs["jax"] == ([True, True, False, False], 99.5)

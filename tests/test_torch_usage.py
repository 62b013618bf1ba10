"""The port's player-usage readers (`data/usage.py`, csv module) and rosters
(`data/context.py`) against the JAX package's pandas readers: the same focus
sheet or fallback usage files give the same share tables, and contexts equal
field for field (names, tracked and is_other exact, shares within 1e-12)."""
import dataclasses

import numpy as np
import pandas as pd
import pytest
import torch

from fast_monte_carlo_tpu.config import SimConfig as JaxSimConfig
from fast_monte_carlo_tpu.data import context as jctx
from fast_monte_carlo_tpu.data import usage as jusage
from fast_monte_carlo_tpu.models.heads import ModelHeads
from fast_monte_carlo_tpu.ops.pack import build_packs
from fast_monte_carlo_tpu_torch import fixtures
from fast_monte_carlo_tpu_torch.config import SimConfig
from fast_monte_carlo_tpu_torch.data import context, usage
from fast_monte_carlo_tpu_torch.matchup import build_direction
from fast_monte_carlo_tpu_torch.ops.pack import MatchupPack, pack_matchup

from test_torch_support import FOCUS_SEED, jax_teams, write_focus

torch.set_num_threads(1)

TEAM_C = ("Team C", 2025, 1, 5.0, 25.0, 25.0)   # on no sheet: the Unknown fallback


def _variant(rows, variant: str):
    """The fixture sheet in percent (as made), as fractions, summing over
    1 in every role, or with a blank usage, a player listed twice for one
    stat, unsorted names and padded, upper-case stat and team keys."""
    rows = [dict(r) for r in rows]
    if variant == "fraction":
        for r in rows:
            r["usage"] = r["usage"] / 100.0
    elif variant == "over":
        for r in rows:
            r["usage"] = round(r["usage"] * 1.3, 1)
    elif variant == "messy":
        rows[1]["usage"] = ""                       # Team A Passer 2: tracked, share 0
        rows.append(dict(rows[5], usage=4.5))       # Team A Receiver 1 twice
        rows.append({**rows[6], "player": "AAA Zed", "usage": 3.0})
        rows[7]["stat"] = "  REC_Yards "
        rows[8]["team"] = "  Team A "
    return rows


def _same_role(got, ref, what):
    assert got.names == ref.names, what
    for f in ("tracked", "is_other"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), err_msg=f"{what} {f}")
    assert got.share.dtype == ref.share.dtype and got.tracked.dtype == ref.tracked.dtype
    np.testing.assert_allclose(got.share, ref.share, rtol=0, atol=1e-12, err_msg=what)


def _same_context(got, ref):
    for f in ("name", "year", "week", "sp_rating", "sp_offense", "sp_defense"):
        assert getattr(got, f) == getattr(ref, f), f
    for role in ("qb", "rush", "target"):
        _same_role(getattr(got, role), getattr(ref, role), f"{got.name} {role}")
    assert got.any_tracking == ref.any_tracking


@pytest.mark.parametrize("k", [4, 8])
@pytest.mark.parametrize("variant", ["percent", "fraction", "over", "messy"])
def test_focus_contexts_equal_jax(k, variant, tmp_path):
    path = str(tmp_path / "focus.csv")
    fixtures.write_csv(path, _variant(fixtures.focus_rows(FOCUS_SEED), variant),
                       fixtures.FOCUS_COLS)
    jfocus = jusage.build_focus_usage_tables(path)
    focus = usage.focus_usage_columns(path)
    assert set(focus) == set(jfocus) == {"Team A", "Team B"}
    others = 0
    for team in (fixtures.TEAM_A, fixtures.TEAM_B, TEAM_C):
        got = context.team_context(*team, player_slots=k, focus_usage=focus)
        _same_context(got, jctx._build(*team, jfocus, ".", k))
        others += sum(getattr(got, r).is_other.sum() for r in ("qb", "rush", "target"))
        assert got.any_tracking == (team is not TEAM_C)
    # a shortfall gives each role an __Other__ slot (where k leaves room)
    assert (others > 0) == (variant != "over")


def test_focus_teams_fixture_reads_back_the_sheet(tmp_path):
    for k in (4, 8):
        for got, ref in zip(fixtures.focus_teams(FOCUS_SEED, player_slots=k),
                            jax_teams(k, write_focus(tmp_path / f"focus{k}.csv"))):
            _same_context(got, ref)
    a, _ = fixtures.focus_teams(FOCUS_SEED)
    assert a.qb.names[:2] == [fixtures.roster_name("Team A", "pass", i) for i in range(2)]
    assert a.qb.tracked[:2].all() and a.qb.is_other[2] and not a.qb.tracked[2:].any()
    # the unknown-only fixture teams come out as before
    for got, ref in zip(fixtures.teams(), jax_teams()):
        _same_context(got, ref)
        assert not got.any_tracking


def test_share_tables_equal_jax_frames(tmp_path):
    path = str(tmp_path / "focus.csv")
    fixtures.write_csv(path, _variant(fixtures.focus_rows(FOCUS_SEED), "messy"),
                       fixtures.FOCUS_COLS)
    got, want = usage.build_focus_usage_tables(path), jusage.build_focus_usage_tables(path)
    for team in want:
        for key, ref in want[team].items():
            if key.endswith("_share"):
                pd.testing.assert_frame_equal(got[team][key], ref, check_exact=False,
                                              rtol=0, atol=1e-12)
            else:
                assert got[team][key] == ref, (team, key)
    assert usage.build_focus_usage_tables(str(tmp_path / "missing.csv")) == {}
    frames = [pd.DataFrame({"player": [], "usage": []}),
              pd.DataFrame({"player": ["b", "a"], "usage": [0.0, 0.0]}),
              pd.DataFrame({"player": ["b", "a", "b"], "usage": [40.0, "x", 35.0]}),
              pd.DataFrame({"player": ["b", "a"], "usage": [0.7, 0.6]}),
              pd.DataFrame({"player": ["b", "a"], "usage": [np.inf, 0.2]})]
    for df in frames:
        pd.testing.assert_frame_equal(usage._share_frame(df, "rusher_name"),
                                      jusage._share_frame(df, "rusher_name"))
    pd.testing.assert_frame_equal(usage._share_frame(None, "passer_name"),
                                  jusage._share_frame(None, "passer_name"))


def test_fallback_usage_files_equal_jax(tmp_path):
    """Per-team usage CSVs (offense, year, <name>, share): the rows of the
    team and year, blank names or shares dropped, shares clipped at 0 and
    renormalized; a team in no file falls back to Unknown."""
    for fname, name_col in (("usage_qb_share.csv", "passer_name"),
                            ("usage_rush_share.csv", "rusher_name"),
                            ("usage_target_share.csv", "receiver_name")):
        rows = [{"offense": "Team C", "year": 2025, name_col: "C One", "share": 0.6},
                {"offense": "Team C", "year": 2024, name_col: "C Old", "share": 0.9},
                {"offense": "Team C", "year": 2025, name_col: "C Two", "share": 0.5},
                {"offense": "Team C", "year": 2025, name_col: "C Neg", "share": -0.2},
                {"offense": "Team C", "year": 2025, name_col: "", "share": 0.3},
                {"offense": "Team C", "year": 2025, name_col: "C Blank", "share": ""},
                {"offense": "Team D", "year": 2025, name_col: "D One", "share": 1.0}]
        fixtures.write_csv(tmp_path / fname, rows, ("offense", "year", name_col, "share"))
    d = str(tmp_path)
    for team in ("Team C", "Team D", "Team E"):
        got = usage.usage_for_team(team, 2025, {}, d)
        want = jusage.usage_for_team(team, 2025, {}, d)
        for g, w in zip(got[:3], want[:3]):
            pd.testing.assert_frame_equal(g, w.reset_index(drop=True))
        assert got[3:] == want[3:]
        _same_context(context.team_context(team, 2025, 1, 5.0, 25.0, 25.0, usage_dir=d),
                      jctx._build(team, 2025, 1, 5.0, 25.0, 25.0, {}, d, 8))
    assert usage.load_usage_table(str(tmp_path / "usage_qb_share.csv"), "Team C", 2025,
                                  "rusher_name") is None
    assert jusage.load_usage_table(str(tmp_path / "usage_qb_share.csv"), "Team C", 2025,
                                   "rusher_name") is None
    # no usage_dir: no files read, Unknown players
    assert context.team_context("Team C", 2025, 1, 5.0, 25.0, 25.0).qb.names[0] == "Unknown"


def test_role_table_helpers_equal_jax(tmp_path):
    (a, b), (ja, jb) = fixtures.focus_teams(FOCUS_SEED), jax_teams(
        8, write_focus(tmp_path / "focus.csv"))
    us = np.random.default_rng(0).random(200).tolist() + [0.0, 1.0, 0.999999]
    for got, ref in ((a, ja), (b, jb)):
        for role in ("qb", "rush", "target"):
            g, r = getattr(got, role), getattr(ref, role)
            assert [g.sample_name(u) for u in us] == [r.sample_name(u) for u in us]
            assert [g.model_name(s) for s in range(g.k)] == [r.model_name(s) for s in range(r.k)]
    assert "Unknown" in [a.qb.model_name(s) for s in range(a.qb.k)]   # __Other__ and padding


def test_focus_pack_equals_jax(tmp_path):
    """The port's MatchupPack of the focus teams equals the JAX package's
    field for field: cumulative shares, tracked slots, -1 model ids."""
    (a, b), (ja, jb) = fixtures.focus_teams(FOCUS_SEED), jax_teams(
        8, write_focus(tmp_path / "focus.csv"))
    cfg = SimConfig()
    pack = pack_matchup(build_direction(a, b, cfg), build_direction(b, a, cfg), "cpu")
    ref = build_packs(ja, jb, ModelHeads(), JaxSimConfig())[0]
    for f in dataclasses.fields(MatchupPack):
        want = np.asarray(getattr(ref, f.name))
        got = getattr(pack, f.name).numpy()
        assert got.dtype == want.dtype, f.name
        np.testing.assert_array_equal(got, want, err_msg=f.name)
    assert pack.qb_tracked.any() and not pack.qb_tracked.all()

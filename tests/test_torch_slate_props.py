"""The port's slate-wide prop scan (`simulate_slate_prop_rows`,
`simulate_slate_props`) on the CPU over a focus-rostered fixture slate
(`fixtures.focus_slate(5, ·)` with `fixtures.slate_prop_rows(5, ·)`: rows
for matchups 0, 1 and 3 only): each matchup's rows are the prop table of
its own run under fold_in(root, gi), the skipped matchups run nothing,
and the JAX package's `simulate_slate_props`, its SP+ reads and runner
stubbed to hand it the port's player stats, builds the same table up to
the order of rows tied on |edge_pct|."""
import json
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from fast_monte_carlo_tpu import api as japi
from fast_monte_carlo_tpu import edge as jedge
from fast_monte_carlo_tpu.data.context import _build
from fast_monte_carlo_tpu.data.usage import build_focus_usage_tables
from fast_monte_carlo_tpu_torch import api, edge, fixtures
from fast_monte_carlo_tpu_torch.config import SimConfig
from fast_monte_carlo_tpu_torch.ops.rng import fold_in, root_key
from test_torch_support import table_cache_off  # noqa: F401 (autouse)

torch.set_num_threads(1)

G, SEED = 5, 6
PAIRS = 256
RUN_SEED = 21
PRICED = (0, 1, 3)          # the matchups slate_prop_rows covers


@pytest.fixture(scope="module")
def slate(tmp_path_factory):
    """The focus slate (port contexts and tables), its games, its prop
    sheet, the JAX package's contexts of the same focus sheet, and the
    port's scan at min edge 0 and 2."""
    d = tmp_path_factory.mktemp("slate_props")
    focus = d / "focus.csv"
    matchups, tables = fixtures.focus_slate(G, SEED, path=str(focus))
    focus_tab = build_focus_usage_tables(str(focus))
    jctx = {r[0]: _build(*r, focus_tab, ".", 8) for r in fixtures.slate_teams(G, SEED)}
    games = [(a.name, b.name) for a, b in matchups]
    props = fixtures.slate_prop_rows(G, SEED)
    kw = dict(contexts=matchups, nano_tables=tables, n_pairs=PAIRS, seed=RUN_SEED,
              device="cpu")
    return dict(matchups=matchups, tables=tables, games=games, props=props, jctx=jctx, kw=kw,
                rows={e: api.simulate_slate_prop_rows(games, props_csv=props,
                                                      min_abs_edge_pct=e, **kw)
                      for e in (0.0, 2.0)})


def _key(r) -> str:
    return json.dumps(r, sort_keys=True)


# float32 sums and quantiles over the games, which torch and XLA reduce in
# different orders (held within 1e-6, as tests/test_torch_props.py does)
FLOAT_SUMS = ("mean", "median", "p75", "p90")


def _exact_key(r) -> str:
    """A row's key less the fields reduced in float32."""
    return _key({k: v for k, v in r.items() if k not in FLOAT_SUMS})


def _matchup_run(slate, gi):
    """Matchup gi's own run under fold_in(root_key(seed), gi) on its
    memoized runner."""
    a, b = slate["matchups"][gi]
    runner = api._runner_for(a, b, slate["tables"][gi], SimConfig(), "table", "nano", False,
                             "cpu")
    return runner.run_pairs(PAIRS, key=fold_in(root_key(RUN_SEED), gi), collect_players=True)


def test_slate_prop_fixtures():
    matchups, tables = fixtures.focus_slate(G, SEED)
    assert len(matchups) == len(tables) == G
    assert [a.name for a, _ in matchups] == [f"Team {2 * i:03d}" for i in range(G)]
    for a, b in matchups:
        for tc in (a, b):
            assert f"{tc.name} Passer 1" in tc.qb.names
            assert sum(tc.target.tracked) == 5
    props = fixtures.slate_prop_rows(G, SEED)
    widths = {}
    for gi, (a, b) in enumerate(matchups):
        idx, meta = edge.resolve_prop_rows(a, b, props)
        widths[gi] = 0 if idx is None else len(idx[0])
    assert widths == {0: 32, 1: 16, 2: 0, 3: 32, 4: 0}
    assert props[-1]["team"] == f"Team {2 * G:03d}"
    # the slate's focus sheet covers every team, in focus_rows' layout
    assert fixtures._focus_rows(["Team A", "Team B"], np.random.default_rng(3)) == \
        fixtures.focus_rows(3)


@pytest.mark.parametrize("min_edge", [0.0, 2.0])
def test_each_matchup_is_its_own_run_reduced(slate, min_edge):
    """Matchup gi's rows are the prop table of run_pairs(key=fold_in(root,
    gi)) reduced on its rows; the whole scan is sorted by |edge_pct|."""
    rows = slate["rows"][min_edge]
    assert rows and {r["matchup"] for r in rows} <= {
        f"{slate['games'][gi][0]} vs {slate['games'][gi][1]}" for gi in PRICED}
    assert list(rows[0]) == ["matchup"] + list(edge.PROP_TABLE_COLS)
    edges = [abs(r["edge_pct"]) for r in rows]
    assert edges == sorted(edges, reverse=True)
    for gi in PRICED:
        a, b = slate["matchups"][gi]
        idx, meta = edge.resolve_prop_rows(a, b, slate["props"])
        red = edge.reduce_props_device(_matchup_run(slate, gi).pstats, idx)
        label = f"{a.name} vs {b.name}"
        want = [{"matchup": label, **r}
                for r in edge.prop_rows_from_reductions(meta, red, min_edge)]
        got = [r for r in rows if r["matchup"] == label]
        assert sorted(map(_key, got)) == sorted(map(_key, want))
        if min_edge == 0.0:
            assert len(got) == len(meta)


def test_skipped_matchups_launch_nothing(slate, monkeypatch, tmp_path):
    """Three launches for three priced matchups; a sheet that resolves in
    no matchup launches nothing and returns no row.  A CSV path and a
    DataFrame give the same rows as row dicts."""
    from fast_monte_carlo_tpu_torch.parallel import mesh

    calls = []
    real = mesh.simulate_games

    def spy(*args, **kw):
        calls.append(kw)
        return real(*args, **kw)

    # a runner's launches go through parallel.mesh (on its group)
    monkeypatch.setattr(mesh, "simulate_games", spy)
    sheet = tmp_path / "props.csv"
    fixtures.write_csv(sheet, slate["props"], fixtures.PROP_COLS)
    for props in (str(sheet), sheet, pd.DataFrame(slate["props"])):
        calls.clear()
        got = api.simulate_slate_prop_rows(slate["games"], props_csv=props,
                                           min_abs_edge_pct=0.0, **slate["kw"])
        assert len(calls) == len(PRICED)
        assert all(c["collect_players"] for c in calls)
        assert got == slate["rows"][0.0]
    calls.clear()
    outside = slate["props"][-1:]
    assert api.simulate_slate_prop_rows(slate["games"], props_csv=outside,
                                        **slate["kw"]) == []
    assert calls == []


def test_empty_scan_matches_jax(slate, monkeypatch):
    """No resolvable row: an empty frame in both packages; a floor no row
    reaches: the same."""
    _stub_jax(slate, monkeypatch, {})
    outside = slate["props"][-1:]
    want = japi.simulate_slate_props(slate["games"], sp_path="unread.csv",
                                     props_csv=pd.DataFrame(outside))
    got = api.simulate_slate_props(slate["games"], props_csv=outside, **slate["kw"])
    pd.testing.assert_frame_equal(got, want)
    assert got.empty and list(got.columns) == []
    got = api.simulate_slate_props(slate["games"], props_csv=slate["props"],
                                   min_abs_edge_pct=1e9, **slate["kw"])
    assert got.empty


def _stub_jax(slate, monkeypatch, pstats):
    """The JAX entry's reads stubbed: contexts built by its own `_build`
    from the same focus sheet, and a runner whose run_pairs hands back the
    port's player stats of that matchup."""
    monkeypatch.setattr(japi, "load_heads", lambda *a, **k: None)
    monkeypatch.setattr(japi, "load_sp_flex", lambda *a, **k: None)
    monkeypatch.setattr(japi, "build_team_context_from_sp_flex",
                        lambda t, *a, **k: slate["jctx"][t])
    monkeypatch.setattr(japi, "_runner_for", lambda a, *rest: SimpleNamespace(
        run_pairs=lambda *args, **kw: SimpleNamespace(pstats=jnp.asarray(pstats[a.name]))))


@pytest.mark.parametrize("min_edge", [0.0, 2.0])
def test_simulate_slate_props_matches_jax_up_to_ties(slate, monkeypatch, min_edge):
    pstats = {}
    for gi in PRICED:
        a, b = slate["matchups"][gi]
        pstats[a.name] = _matchup_run(slate, gi).pstats.numpy()
        ja, jb = slate["jctx"][a.name], slate["jctx"][b.name]
        # both packages map the sheet onto the same cells
        (gi_, gm), (wi, wm) = (edge.resolve_prop_rows(a, b, slate["props"]),
                               jedge.resolve_prop_rows(ja, jb, pd.DataFrame(slate["props"])))
        assert gm == wm
        for x, y in zip(gi_, wi):
            np.testing.assert_array_equal(x, y)
    _stub_jax(slate, monkeypatch, pstats)
    want = japi.simulate_slate_props(slate["games"], sp_path="unread.csv",
                                     props_csv=pd.DataFrame(slate["props"]), n_pairs=PAIRS,
                                     seed=RUN_SEED, min_abs_edge_pct=min_edge)
    got = api.simulate_slate_props(slate["games"], props_csv=slate["props"],
                                   min_abs_edge_pct=min_edge, **slate["kw"])
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want) > 0
    pd.testing.assert_series_equal(got.dtypes, want.dtypes)
    # the order where |edge_pct| differs; tied rows as a set
    ge, we = got["edge_pct"].abs().to_numpy(), want["edge_pct"].abs().to_numpy()
    np.testing.assert_array_equal(ge, we)
    for v in np.unique(ge):
        g = sorted(got[ge == v].to_dict("records"), key=_exact_key)
        w = sorted(want[we == v].to_dict("records"), key=_exact_key)
        assert list(map(_exact_key, g)) == list(map(_exact_key, w)), v
        for x, y in zip(g, w):
            np.testing.assert_allclose([x[k] for k in FLOAT_SUMS], [y[k] for k in FLOAT_SUMS],
                                       rtol=1e-6, atol=1e-6)
    assert len(set(ge)) < len(ge)            # the sheet has ties to order


def test_slate_props_needs_built_inputs(slate):
    """Contexts or an SP+ sheet, not both (the sheet route:
    tests/test_torch_routes.py); trial sharding in a world of one scans the
    unsharded games."""
    games, props = slate["games"], slate["props"]
    for kw in (dict(sp_path="sp.csv"), dict(focus_csv="f.csv")):
        with pytest.raises(ValueError, match="not both"):
            api.simulate_slate_props(games, props_csv=props, **dict(slate["kw"], **kw))
    with pytest.raises(ValueError, match="needs sp_path="):
        api.simulate_slate_props(games, props_csv=props)
    with pytest.raises(ValueError, match="5 games need as many context pairs"):
        api.simulate_slate_props(games, props_csv=props,
                                 **dict(slate["kw"], contexts=slate["matchups"][:4]))
    got = api.simulate_slate_prop_rows(games, props_csv=props, shard=True, **slate["kw"])
    assert [_key(r) for r in got] == [_key(r) for r in slate["rows"][2.0]]

"""Sim bundles (`store.py`) and the checkpointed sweep
(`api.simulate_matchup_batched`) on the CPU, held to the JAX package.

`make_signature` gives the JAX package's hex; a bundle written by either
package is read by the other.  The sweep's chunks are, bitwise, the port's
keyed runs (chunk ci under fold_in(root_key(seed), ci)); a second call skips
the chunks on disk; a run directory under another chunk-key tag, or with
chunks and no tag, is refused, and the JAX package refuses the port's tag.
The two packages draw different streams (Philox here, threefry there), so
their sweeps agree within 4 Monte-Carlo standard errors."""
import dataclasses
import json
import os

import numpy as np
import pandas as pd
import pytest
import torch

from fast_monte_carlo_tpu import api as japi
from fast_monte_carlo_tpu import store as jstore
from fast_monte_carlo_tpu.config import SimConfig as JaxSimConfig
from fast_monte_carlo_tpu_torch import api, fixtures, store
from fast_monte_carlo_tpu_torch.config import SimConfig
from fast_monte_carlo_tpu_torch.ops.rng import fold_in, root_key

from test_torch_support import jax_teams, within

torch.set_num_threads(1)

METAS = [
    {},
    {"seed": 3, "n": 16384, "mode": "exact"},
    {"b": [1, 2.5, None, True], "a": {"z": {"y": [{"x": "é"}, -0.0]}, "k": 1e-300}},
    {"teams": ["Team A", "Team B"], "cfg": {"rng_impl": "threefry", "lines": [-3.5, 44.5]},
     "note": "saved sims, bundles and the backtest", "unicode": "Zürich ✓"},
]


def _runner():
    return api.MatchupRunner(*fixtures.teams(), None, SimConfig(), mode="analytic",
                             device="cpu")


@pytest.mark.parametrize("i", range(len(METAS)))
def test_make_signature_equals_jax(i):
    assert store.make_signature(METAS[i]) == jstore.make_signature(METAS[i])
    assert len(store.make_signature(METAS[i])) == 64


@pytest.mark.parametrize("players", [True, False])
def test_bundles_cross_read(tmp_path, players):
    """A bundle the port writes (from columns) the JAX package loads, and
    the other way round (from DataFrames); margin and total computed, the
    missing GAMES_KEEP columns 0, meta.json carrying the signature."""
    out = _runner().run_pairs(64, seed=1, collect_players=players)
    a, b = fixtures.teams()
    scores = api.scores_columns(out, a.name, b.name)
    pl = api.players_columns(out, a, b) if players else None
    meta = METAS[3]
    sig = store.save_sim_bundle(tmp_path / "port", scores, pl, meta)
    jsig = jstore.save_sim_bundle(tmp_path / "jax", pd.DataFrame(scores),
                                  None if pl is None else api._players_df(pl), meta)
    assert sig == jsig == jstore.make_signature(meta)
    for writer in ("port", "jax"):
        got = store.load_sim_bundle(tmp_path / writer)
        want = jstore.load_sim_bundle(tmp_path / writer)
        pd.testing.assert_frame_equal(got[0], want[0])
        assert (got[1] is None) == (want[1] is None) == (not players)
        if players:
            pd.testing.assert_frame_equal(got[1], want[1])
        assert got[2] == want[2] == {**meta, "signature": sig}
    g = store.load_sim_bundle(tmp_path / "port")[0]
    assert list(g.columns) == store.GAMES_KEEP == jstore.GAMES_KEEP
    assert (g["margin"] == g["pts"] - g["opp_pts"]).all() and (g["seed"] == 0).all()
    pd.testing.assert_frame_equal(g, store.load_sim_bundle(tmp_path / "jax")[0])


def test_batched_chunks_are_the_keyed_runs():
    """Each chunk of the pandas-free core is simulate_matchup_columns under
    fold_in(root_key(seed), ci), bitwise; the last chunk holds what is left;
    `done` chunks are not played."""
    a, b = fixtures.teams()
    runner = _runner()
    got = list(api.simulate_matchup_batched_chunks(a, b, None, 160, 64, seed=9, mode="analytic",
                                                   runner=runner))
    assert [ci for ci, _, _ in got] == [0, 1, 2]
    for ci, cols, players in got:
        assert players is None
        want, _, _ = api.simulate_matchup_columns(a, b, None, [64, 64, 32][ci], runner=runner,
                                                  key=fold_in(root_key(9), ci))
        for c in want:
            np.testing.assert_array_equal(cols[c], want[c], err_msg=f"chunk {ci} {c}")
    again = list(api.simulate_matchup_batched_chunks(a, b, None, 160, 64, seed=9,
                                                     mode="analytic", runner=runner,
                                                     done={0, 2}))
    assert [ci for ci, _, _ in again] == [1]
    np.testing.assert_array_equal(again[0][1]["pts"], got[1][1]["pts"])
    with pytest.raises(ValueError):
        next(api.simulate_matchup_batched_chunks(a, b, None, 10, 0, runner=runner))


def test_batched_sweep_resumes_past_done_chunks(tmp_path, monkeypatch):
    """The parquet wrapper writes every chunk (players too), tags the run
    directory, and a second call after a lost chunk replays that chunk
    alone, giving the same frame."""
    a, b = fixtures.teams()
    d = tmp_path / "run"
    first = api.simulate_matchup_batched(a, b, None, 96, 32, str(d), seed=4, mode="analytic",
                                         collect_players=True, device="cpu")
    assert len(first) == 2 * 96
    assert (d / "KEY_SCHEME").read_text().strip() == api._CHUNK_KEY_SCHEME
    names = sorted(os.listdir(d))
    assert names == ["KEY_SCHEME"] + [f"players_chunk_{i:05d}.parquet" for i in range(3)] + [
        f"scores_chunk_{i:05d}.parquet" for i in range(3)]
    os.remove(d / "scores_chunk_00001.parquet")
    played = []
    real = api.simulate_matchup_columns

    def spy(*args, **kw):
        played.append(kw["key"])
        return real(*args, **kw)

    monkeypatch.setattr(api, "simulate_matchup_columns", spy)
    second = api.simulate_matchup_batched(a, b, None, 96, 32, str(d), seed=4, mode="analytic",
                                          collect_players=True, device="cpu")
    assert played == [fold_in(root_key(4), 1)]
    pd.testing.assert_frame_equal(second, first)
    played.clear()
    pd.testing.assert_frame_equal(api.simulate_matchup_batched(
        a, b, None, 96, 32, str(d), seed=4, mode="analytic", device="cpu"), first)
    assert played == []


def test_key_scheme_refusals(tmp_path):
    """A run directory tagged by the JAX package ("fold_in-v2") and one with
    chunks and no tag are refused with the JAX package's messages, before
    any game; the JAX package refuses the port's tag."""
    a, b = fixtures.teams()
    jax_dir = tmp_path / "jax"
    jax_dir.mkdir()
    (jax_dir / "KEY_SCHEME").write_text("fold_in-v2\n")
    with pytest.raises(ValueError, match="'fold_in-v2'; this build uses "
                                         f"'{api._CHUNK_KEY_SCHEME}'"):
        api.simulate_matchup_batched(a, b, None, 64, 32, str(jax_dir), mode="analytic",
                                     device="cpu")
    untagged = tmp_path / "untagged"
    untagged.mkdir()
    pd.DataFrame({"pts": [1]}).to_parquet(untagged / "scores_chunk_00000.parquet")
    with pytest.raises(ValueError, match="no KEY_SCHEME marker"):
        api.simulate_matchup_batched(a, b, None, 64, 32, str(untagged), mode="analytic",
                                     device="cpu")
    port_dir = tmp_path / "port"
    api.simulate_matchup_batched(a, b, None, 16, 16, str(port_dir), mode="analytic",
                                 device="cpu")
    ja, jb = jax_teams()
    with pytest.raises(ValueError, match=f"'{api._CHUNK_KEY_SCHEME}'; this build uses "
                                         "'fold_in-v2'"):
        japi.simulate_matchup_batched(ja, jb, None, 64, 32, str(port_dir), mode="analytic")
    assert api._CHUNK_KEY_SCHEME != japi._CHUNK_KEY_SCHEME


def _side_a(df: pd.DataFrame, team_a: str):
    a_first = (df["team"] == team_a).to_numpy()
    pa = np.where(a_first, df["pts"], df["opp_pts"]).astype(float)
    pb = np.where(a_first, df["opp_pts"], df["pts"]).astype(float)
    return pa, pb


def test_batched_sweep_agrees_with_jax_within_mc_error(tmp_path):
    """The port's sweep and the JAX package's, same teams, analytic heads,
    2 chunks of 1,024 pairs: mean margin, mean total and team A's win rate
    within 4 standard errors."""
    a, b = fixtures.teams()
    got = api.simulate_matchup_batched(a, b, None, 2048, 1024, str(tmp_path / "p"), seed=2,
                                       mode="analytic", device="cpu")
    c = JaxSimConfig()
    cfg1 = c.replace(engine=dataclasses.replace(c.engine, scan_unroll=1))
    want = japi.simulate_matchup_batched(*jax_teams(), None, 2048, 1024, str(tmp_path / "j"),
                                         cfg=cfg1, seed=2, mode="analytic")
    assert len(got) == len(want) == 4096
    (ga, gb), (wa, wb) = _side_a(got, a.name), _side_a(want, a.name)
    n = len(got)
    for g, w in ((ga - gb, wa - wb), (ga + gb, wa + wb)):
        se = np.sqrt(g.var(ddof=1) / n + w.var(ddof=1) / n)
        assert abs(g.mean() - w.mean()) <= 4 * se, (g.mean(), w.mean(), se)
    pw = float((wa > wb).mean())
    assert within(float((ga > gb).mean()), pw, pw, n)
    assert json.loads(json.dumps(sorted(os.listdir(tmp_path / "p"))))[0] == "KEY_SCHEME"

"""Box-score and player accrual of the port's play step and game loop against
the JAX package, on the same injected draws, with both collectors on and the
focus roster's pack (tracked, untracked and `__Other__` slots per role).

As in test_torch_game.py, XLA on the CPU contracts multiply-adds and torch
does not, so a row whose draw sits within an ulp of a threshold may take
the other branch: such rows must flip back under a 1e-4 nudge of one draw.
On every other row the count columns are equal and the yards allclose."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_monte_carlo_tpu.config import SimConfig as JaxSimConfig
from fast_monte_carlo_tpu.ops import game as jg
from fast_monte_carlo_tpu_torch import fixtures
from fast_monte_carlo_tpu_torch.config import SimConfig
from fast_monte_carlo_tpu_torch.ops import game as tg
from fast_monte_carlo_tpu_torch.ops.rng import root_key
from fast_monte_carlo_tpu_torch.stats import (PC_ATT, PC_COMP, PC_TD, PC_YDS, ROLE_PASS,
                                              ROLE_REC, ROLE_RUSH, TEAM_STAT_FIELDS, TS)

from test_torch_support import (flips_back, heads_pair, jax_pack, jax_state, port_pack,
                                port_state, row_mismatch, write_focus)

torch.set_num_threads(1)

N_STATES = 12000
TEAM_YARDS = [TS["pass_yds"], TS["rush_yds"]]
TEAM_COUNTS = [i for i in range(len(TEAM_STAT_FIELDS)) if i not in TEAM_YARDS]
PLAYER_COUNTS = [c for c in range(6) if c != PC_YDS]


def _with_fumbles(cfg):
    """Fumbles on (off by default), so fumbles_lost accrues too."""
    return cfg.replace(model=dataclasses.replace(cfg.model, enable_fumbles=True))


def _same_stats(got_stats, got_pstats, want_stats, want_pstats, rows, yards_atol):
    np.testing.assert_array_equal(got_stats[rows][..., TEAM_COUNTS],
                                  want_stats[rows][..., TEAM_COUNTS])
    np.testing.assert_allclose(got_stats[rows][..., TEAM_YARDS],
                               want_stats[rows][..., TEAM_YARDS], rtol=1e-5, atol=yards_atol)
    np.testing.assert_array_equal(got_pstats[rows][..., PLAYER_COUNTS],
                                  want_pstats[rows][..., PLAYER_COUNTS])
    np.testing.assert_allclose(got_pstats[rows][..., PC_YDS], want_pstats[rows][..., PC_YDS],
                               rtol=1e-5, atol=yards_atol)


@pytest.mark.parametrize("mode", ["analytic", "table"])
def test_play_step_accrual_matches_jax_on_injected_draws(mode, tmp_path):
    rng = np.random.default_rng(21)
    d = fixtures.play_states(rng, N_STATES, k=8)
    u, z = fixtures.play_draws(rng, (N_STATES,))
    jpack = jax_pack(focus_csv=write_focus(tmp_path / "focus.csv"))
    pack = port_pack(jpack)
    jhe, jhs, he, hs = heads_pair(mode)
    jcfg, cfg = _with_fumbles(JaxSimConfig()), _with_fumbles(SimConfig())
    step = jax.jit(lambda s, uu, zz, h: jg.play_step(
        s, jax.random.PRNGKey(0), jpack, jcfg, jhe, h, True, True, draws=(uu, zz)))
    want = step(jax_state(d), jnp.asarray(u), jnp.asarray(z), jhs)
    got = tg.play_step(port_state(d), (torch.from_numpy(u), torch.from_numpy(z)),
                       pack, cfg, he, hs, collect_players=True, collect_stats=True)

    bad = row_mismatch(want, got)
    assert bad.mean() <= 0.001, f"{bad.sum()} of {N_STATES} rows differ"
    wants = {f: np.asarray(getattr(want, f)) for f in ("off", "sec", "down", "period",
                                                       "in_rz", "going", "score")}
    for i in np.flatnonzero(bad):
        assert flips_back(d, i, u, z, {f: v[i] for f, v in wants.items()},
                          pack, he, hs), f"row {i} differs off any threshold"
    ws, wp = np.asarray(want.stats), np.asarray(want.pstats)
    gs, gp = got.stats.numpy(), got.pstats.numpy()
    _same_stats(gs, gp, ws, wp, ~bad, 1e-4)

    # every team column but points moved in some row (fumbles only where
    # the heads give them: the fixture table's p_fumble is 0), and only the
    # offense's
    moved = (gs != d["stats"])
    for f in TEAM_STAT_FIELDS:
        want_moved = f != "points" and (f != "fumbles_lost" or mode == "analytic")
        assert moved[..., TS[f]].any() == want_moved, f
    side = np.arange(2)[None, :] == d["off"][:, None]
    assert not moved[~side].any()
    # players: tracked slots of the offense only, each role's columns
    tracked = np.stack([np.asarray(jpack.qb_tracked), np.asarray(jpack.rb_tracked),
                        np.asarray(jpack.wr_tracked)], axis=1)     # (2, 3, K) by role
    assert tracked.any() and not tracked.all()
    pm = (gp != d["pstats"]).any(axis=-1)                           # (B, 2, 3, K)
    assert not pm[:, ~tracked].any() and not pm[~side].any()
    for role in (ROLE_PASS, ROLE_RUSH, ROLE_REC):
        for c in (PC_ATT, PC_YDS, PC_TD) + ((PC_COMP,) if role != ROLE_RUSH else ()):
            assert (gp[:, :, role, :, c] != d["pstats"][:, :, role, :, c]).any(), (role, c)


def test_indexed_add_is_bitwise_the_dense_one_hot_add():
    """tg.add_player_rows (one index_add_ on a flat view) against the JAX
    package's dense form (ops/game.py:641-653) written out in torch: every
    cell equal bit for bit, though other cells add +-0 and gated-off
    yards add -0.  (States start at +0, so no cell holds -0.)"""
    g = np.random.default_rng(5)
    b, k = 4096, 8
    start = g.uniform(-50, 300, (b, 2, 3, k, 6)).astype(np.float32)
    start[g.random(start.shape) < 0.3] = 0.0
    off = torch.from_numpy(g.integers(0, 2, b, dtype=np.int32))
    slot = torch.from_numpy(g.integers(0, k, (b, 3), dtype=np.int32))
    gate = torch.from_numpy((g.random((b, 3)) < 0.6).astype(np.float32))
    delta = g.integers(0, 2, (b, 3, 6)).astype(np.float32)
    delta[..., PC_YDS] = np.round(g.uniform(-15, 80, (b, 3)), 1) * (g.random((b, 3)) < 0.8)
    delta = torch.from_numpy(delta)
    assert ((delta[..., PC_YDS] < 0) & (gate == 0)).any()

    pstats = torch.from_numpy(start)
    oh_f = torch.nn.functional.one_hot(off.long(), 2).float()
    dense = pstats + torch.stack(
        [torch.einsum("bs,bk,bc->bskc", oh_f,
                      torch.nn.functional.one_hot(slot[:, r].long(), k).float()
                      * gate[:, r, None], delta[:, r]) for r in range(3)], dim=2)
    got = tg.add_player_rows(pstats.clone(), off, slot, gate, delta)
    assert torch.equal(got.view(torch.int32), dense.view(torch.int32))
    assert not torch.equal(got, pstats)


@pytest.mark.parametrize("mode", ["analytic", "table"])
def test_whole_games_accrue_as_jax(mode, tmp_path):
    """512 games fed one (max_plays, B, 17) draw table on both sides: at
    least 98% agree on the score, every count stat and every player count,
    and those within 1e-3 on yards.  A game whose score agrees but a count
    does not took the other branch at a threshold on some play and still
    ended level (as the one-step test shows, such flips sit within an ulp):
    at most 1%."""
    b = 512
    cfg, jcfg = SimConfig(), JaxSimConfig()
    steps = cfg.engine.max_plays
    u, z = fixtures.play_draws(np.random.default_rng(22), (steps, b))
    jpack = jax_pack(focus_csv=write_focus(tmp_path / "focus.csv"))
    pack = port_pack(jpack)
    jhe, jhs, he, hs = heads_pair(mode)
    fo = np.arange(b) % 2

    def run_jax(h, uu, zz):
        s0 = jg.initial_state(b, jnp.asarray(fo, jnp.int32), jcfg, 8)

        def body(s, xs):
            return jg.play_step(s, jax.random.PRNGKey(0), jpack, jcfg, jhe, h,
                                True, True, draws=xs), None

        return jax.lax.scan(body, s0, (uu, zz))[0]

    want = jax.jit(run_jax)(jhs, jnp.asarray(u), jnp.asarray(z))
    s = tg.initial_state(b, torch.from_numpy(fo), cfg, "cpu", k=8)
    ut, zt = torch.from_numpy(u), torch.from_numpy(z)
    for j in range(steps):
        s = tg.play_step(s, (ut[j], zt[j]), pack, cfg, he, hs, True, True)
    assert (s.sec == 0).all()
    gs, gp = s.stats.numpy(), s.pstats.numpy()
    ws, wp = np.asarray(want.stats), np.asarray(want.pstats)
    same = (s.score.numpy() == np.asarray(want.score)).all(axis=1)
    agree = same & (gs[..., TEAM_COUNTS] == ws[..., TEAM_COUNTS]).all(axis=(1, 2)) \
        & (gp[..., PLAYER_COUNTS] == wp[..., PLAYER_COUNTS]).all(axis=(1, 2, 3, 4))
    assert agree.mean() >= 0.98, f"{(~agree).sum()} of {b} games differ"
    assert (same & ~agree).sum() <= b // 100, f"{(same & ~agree).sum()} level games differ"
    _same_stats(gs, gp, ws, wp, agree, 1e-3)
    assert s.pstats.numpy()[..., PC_ATT].sum() > 0


def test_simulate_games_writes_points_and_keeps_dummies(tmp_path):
    """The game loop writes the final score into `points`; box-score and
    player identities hold; a disabled collector carries the JAX package's
    1-element dummy, and no collector changes the games."""
    jpack = jax_pack(focus_csv=write_focus(tmp_path / "focus.csv"))
    pack = port_pack(jpack)
    cfg = SimConfig()
    cfg = cfg.replace(engine=dataclasses.replace(cfg.engine, rng_impl="pallas_chunk"))
    he = tg.make_analytic_heads_eval(cfg)
    fo = torch.arange(256) % 2
    out = tg.simulate_games(pack, cfg, he, None, root_key(4), 256, fo)
    st, ps = out.stats, out.pstats
    assert st.shape == (256, 2, 19) and ps.shape == (256, 2, 3, 8, 6)
    assert torch.equal(st[:, :, TS["points"]], out.score.float())
    assert (st[..., TS["comp"]] <= st[..., TS["pass_att"]]).all()
    for role, team_col in ((ROLE_PASS, "pass_att"), (ROLE_RUSH, "rush_att")):
        assert (ps[:, :, role, :, PC_ATT].sum(-1) <= st[..., TS[team_col]]).all()
    assert (ps[:, :, ROLE_REC, :, PC_ATT] >= ps[:, :, ROLE_REC, :, PC_COMP]).all()
    for role, td in ((ROLE_PASS, "pass_td"), (ROLE_RUSH, "rush_td"), (ROLE_REC, "pass_td")):
        assert (ps[:, :, role, :, PC_TD].sum(-1) <= st[..., TS[td]]).all()
    assert ps[..., PC_ATT].sum() > 0
    for players, stats in ((False, True), (True, False), (False, False)):
        o = tg.simulate_games(pack, cfg, he, None, root_key(4), 256, fo,
                              collect_players=players, collect_stats=stats)
        ref = jg.initial_state(256, 0, JaxSimConfig(), 8, collect_players=players,
                               collect_stats=stats)
        assert tuple(o.stats.shape) == ref.stats.shape
        assert tuple(o.pstats.shape) == ref.pstats.shape
        assert torch.equal(o.score, out.score)
        if stats:
            assert torch.equal(o.stats, st)
        if players:
            assert torch.equal(o.pstats, ps)

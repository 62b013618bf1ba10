"""The PyTorch port's play step and game loop against the JAX package, fed
the same draws (`play_step(..., draws=(u, n))`).

Integer state must agree; floats agree to a few ulp, because XLA on the CPU
contracts multiply-adds into FMAs and torch rounds each op.  Such an ulp can
flip an outcome only where a draw sits on a threshold, so every row whose
integer state differs must be shown to flip back when its draws move by at
most 1e-4."""
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

from test_torch_support import (FLOAT_FIELDS, INT_FIELDS, flips_back, heads_pair,
                                jax_pack, jax_state, port_pack, port_state,
                                row_mismatch)

torch.set_num_threads(1)

N_STATES = 12000


@pytest.mark.parametrize("mode", ["analytic", "table"])
def test_play_step_matches_jax_on_injected_draws(mode):
    rng = np.random.default_rng(11)
    d = fixtures.play_states(rng, N_STATES)
    u, z = fixtures.play_draws(rng, (N_STATES,))
    jpack = jax_pack()
    pack = port_pack(jpack)
    jhe, jhs, he, hs = heads_pair(mode)
    jcfg = JaxSimConfig()
    step = jax.jit(lambda s, uu, zz, h: jg.play_step(
        s, jax.random.PRNGKey(0), jpack, jcfg, jhe, h, False, False,
        draws=(uu, zz)))
    want = step(jax_state(d), jnp.asarray(u), jnp.asarray(z), jhs)
    got = tg.play_step(port_state(d), (torch.from_numpy(u), torch.from_numpy(z)),
                       pack, SimConfig(), he, hs)

    # every branch is reached: ticks name the outcome (10 incomplete,
    # 12 FG or INT, 16 punt, 20 pass TD, 24 sack, 26 pass gain, 28 run)
    sec1 = np.asarray(want.sec)
    tick = d["sec"] - sec1
    assert {10, 12, 16, 20, 24, 26, 28} <= set(np.unique(tick))
    pts = np.asarray(want.score).sum(1) - d["score"].sum(1)
    assert (pts == 7).any() and (pts == 3).any()
    flipped = np.asarray(want.off) != d["off"]
    period1 = np.asarray(want.period)
    assert ((d["period"] == 2) & (period1 == 3)).any()                # halftime
    assert ((d["down"] == 4) & np.isin(tick, [10, 20, 24, 26, 28])).any()  # go
    assert ((tick == 12) & flipped & (pts == 0) & (d["down"] < 4)).any()   # INT
    assert ((d["ytg"] <= 12) & (pts == 7)).any()                      # red zone
    assert ((d["ytg"] > 25) & (u[:, tg.U_EXP] < 0.005)
            & np.isin(tick, [20, 26, 28])).any()                      # explosive
    assert (d["sec"] == 0).any() and (tick[d["sec"] == 0] == 0).all()

    bad = row_mismatch(want, got)
    assert bad.mean() <= 0.001, f"{bad.sum()} of {N_STATES} rows differ"
    wants = {f: np.asarray(getattr(want, f)) for f in INT_FIELDS}
    for i in np.flatnonzero(bad):
        assert flips_back(d, i, u, z, {f: v[i] for f, v in wants.items()},
                           pack, he, hs), f"row {i} differs off any threshold"
    ok = ~bad
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy()[ok],
                                   np.asarray(getattr(want, f))[ok],
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    for f in INT_FIELDS + FLOAT_FIELDS:
        assert getattr(got, f).dtype == {
            "int32": torch.int32, "float32": torch.float32, "bool": torch.bool
        }[str(np.asarray(getattr(want, f)).dtype)], f


@pytest.mark.parametrize("mode", ["analytic", "table"])
def test_whole_games_match_jax_on_one_draw_table(mode):
    """512 games fed one (max_plays, B, 17) draw table on both sides."""
    b = 512
    cfg, jcfg = SimConfig(), JaxSimConfig()
    steps = cfg.engine.max_plays
    rng = np.random.default_rng(12)
    u, z = fixtures.play_draws(rng, (steps, b))
    jpack = jax_pack()
    pack = port_pack(jpack)
    jhe, jhs, he, hs = heads_pair(mode)
    fo = np.arange(b) % 2

    def run_jax(h, uu, zz):
        s0 = jg.initial_state(b, jnp.asarray(fo, jnp.int32), jcfg, 8,
                              collect_players=False, collect_stats=False)

        def body(s, xs):
            return jg.play_step(s, jax.random.PRNGKey(0), jpack, jcfg, jhe, h,
                                False, False, draws=xs), None

        return jax.lax.scan(body, s0, (uu, zz))[0]

    want = np.asarray(jax.jit(run_jax)(jhs, jnp.asarray(u), jnp.asarray(z)).score)
    s = tg.initial_state(b, torch.from_numpy(fo), cfg, "cpu")
    ut, zt = torch.from_numpy(u), torch.from_numpy(z)
    for j in range(steps):
        s = tg.play_step(s, (ut[j], zt[j]), pack, cfg, he, hs)
    got = s.score.numpy()
    assert (s.sec == 0).all()
    same = (got == want).all(axis=1)
    assert same.mean() >= 0.98, f"{(~same).sum()} of {b} games differ"
    assert 10 < want.mean() < 50


def _runner_cfg(**engine):
    cfg = SimConfig()
    return cfg.replace(engine=dataclasses.replace(cfg.engine, **engine))


def test_simulate_games_per_step_equals_chunked_draws():
    """rng_impl 'pallas' (a launch per play) and 'pallas_chunk' (a launch
    per chunk) draw the same stream, so the games are identical; so are
    early_exit and full-length runs."""
    pack = port_pack(jax_pack())
    he = tg.make_analytic_heads_eval(SimConfig())
    fo = torch.arange(256) % 2
    key = root_key(5)
    outs = [tg.simulate_games(pack, _runner_cfg(rng_impl=r, early_exit=e), he,
                              None, key, 256, fo)
            for r, e in (("pallas_chunk", True), ("pallas", True),
                         ("pallas_chunk", False))]
    for o in outs[1:]:
        for f in INT_FIELDS + FLOAT_FIELDS:
            assert torch.equal(getattr(o, f), getattr(outs[0], f)), f
    assert (outs[0].sec == 0).all()


def test_unported_engine_options_raise():
    pack = port_pack(jax_pack())
    he = tg.make_analytic_heads_eval(SimConfig())
    for cfg in (SimConfig(), _runner_cfg(rng_impl="rbg")):   # threefry, rbg
        with pytest.raises(NotImplementedError):
            tg.simulate_games(pack, cfg, he, None, 1, 8, 0)
    with pytest.raises(NotImplementedError):
        tg.simulate_games(pack, _runner_cfg(rng_impl="pallas_chunk",
                                            antithetic=True), he, None, 1, 8, 0)

"""Shared helpers for the PyTorch-port tests, and checks of the fixtures.

Inputs are made from numpy seeds and handed to both packages as numpy
arrays: the JAX package (the reference, on the CPU) and its PyTorch port
`fast_monte_carlo_tpu_torch` (here on the CPU, where each kernel wrapper
runs its plain PyTorch version)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from fast_monte_carlo_tpu.config import SimConfig as JaxSimConfig
from fast_monte_carlo_tpu.config import resolve_nano_select
from fast_monte_carlo_tpu.data.context import _build
from fast_monte_carlo_tpu.data.usage import build_focus_usage_tables
from fast_monte_carlo_tpu.models import tables as jt
from fast_monte_carlo_tpu.models.heads import ModelHeads
from fast_monte_carlo_tpu.ops import game as jg
from fast_monte_carlo_tpu.ops import table_lookup as jtl
from fast_monte_carlo_tpu.ops.pack import build_packs
from fast_monte_carlo_tpu_torch import fixtures
from fast_monte_carlo_tpu_torch.config import SimConfig
from fast_monte_carlo_tpu_torch.models.tables import FUSED_CHANNELS, nano_profile
from fast_monte_carlo_tpu_torch.ops import game as tg
from fast_monte_carlo_tpu_torch.ops import table_lookup as ttl
from fast_monte_carlo_tpu_torch.ops.pack import matchup_pack_from_numpy

torch.set_num_threads(1)

TABLE_SEED = 7


FOCUS_SEED = 3


def jax_teams(k: int = 8, focus_csv=None):
    """The fixture teams through the JAX package's own `_build`, with the
    rosters of the focus sheet at `focus_csv` if given."""
    focus = build_focus_usage_tables(str(focus_csv)) if focus_csv else {}
    return (_build(*fixtures.TEAM_A, focus, ".", k),
            _build(*fixtures.TEAM_B, focus, ".", k))


def write_focus(path, seed: int = FOCUS_SEED):
    """`fixtures.focus_rows(seed)` written as a focus sheet at `path`."""
    fixtures.write_csv(path, fixtures.focus_rows(seed), fixtures.FOCUS_COLS)
    return path


def jax_pack(cfg=None, k: int = 8, focus_csv=None):
    a, b = jax_teams(k, focus_csv)
    return build_packs(a, b, ModelHeads(), cfg or JaxSimConfig())[0]


def pack_arrays(jpack) -> dict:
    return {f.name: np.asarray(getattr(jpack, f.name))
            for f in dataclasses.fields(jpack)}


def port_pack(jpack, device="cpu"):
    return matchup_pack_from_numpy(pack_arrays(jpack), device)


def jax_host(t) -> "jt.HostTable":
    """A port HostTable (fused layout) as the JAX package's HostTable."""
    return jt.HostTable(values=t.values, shape=t.shape, row_map=t.row_map,
                        profile=t.profile, has_sd=t.has_sd,
                        channels=t.channels)


def jax_table_heads(seed: int = TABLE_SEED):
    """The fixture's fused grids, re-laid out and packed by the JAX
    package (TableSet(..., nano=...) -> pack_tables)."""
    prof = jt.nano_profile()
    sets = []
    for t in fixtures.fused_tables(seed):
        sets.append(jt.TableSet(
            stage1=None, stage2=None, pq=None, rq=None, sq=None, fumble=None,
            play=None, fine=jt.fine_profile(), coarse=jt.coarse_profile(),
            nano=jt.nano_from_fused(jax_host(t), prof)))
    return jtl.pack_tables(sets[0], sets[1], k=8, nano_prof=prof)


def heads_pair(mode: str):
    """(jax heads_eval, jax heads_state, port heads_eval, port heads_state)
    for "analytic" or "table" (the fixture's nano table) heads."""
    if mode == "analytic":
        return (jg.make_analytic_heads_eval(JaxSimConfig()), None,
                tg.make_analytic_heads_eval(SimConfig()), None)
    jcfg = resolve_nano_select(JaxSimConfig(), collect_stats=False)
    return (jtl.make_table_heads_eval(jcfg), jax_table_heads(),
            ttl.make_table_heads_eval(SimConfig()),
            ttl.pack_tables(*fixtures.nano_tables(TABLE_SEED), device="cpu"))


def jax_state(d: dict) -> "jg.GameState":
    """`fixtures.play_states` rows as a JAX GameState; its stats and pstats
    are the rows' (nonzero with `k`, else the 1-element dummies)."""
    return jg.GameState(**{k: jnp.asarray(v) for k, v in d.items()})


def port_state(d: dict, device="cpu") -> "tg.GameState":
    """The same rows as a port GameState, each field a copy."""
    return tg.GameState(**{k: torch.tensor(v, device=device) for k, v in d.items()})


INT_FIELDS = ("off", "sec", "down", "period", "in_rz", "going", "score")
FLOAT_FIELDS = ("dist", "ytg")


def row_mismatch(jax_out, port_out) -> np.ndarray:
    """(B,) bool: rows whose integer fields differ between the packages."""
    bad = None
    for f in INT_FIELDS:
        x = np.asarray(getattr(jax_out, f))
        y = getattr(port_out, f).cpu().numpy()
        m = x != y
        m = m.any(axis=1) if m.ndim > 1 else m
        bad = m if bad is None else bad | m
    return bad


NUDGE = 1e-4


def flips_back(d, i, u, z, want, pack, he, hs) -> bool:
    """Does row i reach the JAX outcome `want` (integer fields) when one of
    its 17 draws moves by +-NUDGE?  (True = the row sits within NUDGE of a
    threshold.)"""
    variants = []
    for c in range(17):
        for sgn in (-1.0, 1.0):
            uu, zz = u[i].copy(), z[i].copy()
            if c < 13:
                uu[c] = np.clip(uu[c] + sgn * NUDGE, 0.0, 1.0 - 2.0 ** -24)
            else:
                zz[c - 13] += sgn * NUDGE
            variants.append((uu, zz))
    m = len(variants)
    rows = {k: np.repeat(v[i:i + 1], m, axis=0) for k, v in d.items()}
    out = tg.play_step(port_state(rows),
                       (torch.from_numpy(np.stack([v[0] for v in variants])),
                        torch.from_numpy(np.stack([v[1] for v in variants]))),
                       pack, SimConfig(), he, hs)
    match = np.ones(m, bool)
    for f in INT_FIELDS:
        ok = getattr(out, f).numpy() == want[f]
        match &= ok.all(axis=1) if ok.ndim > 1 else ok
    return bool(match.any())


def test_fixture_grid_shape_and_ranges():
    a, b = fixtures.fused_tables(TABLE_SEED)
    assert a.shape + (a.channels,) == fixtures.FUSED_GRID_SHAPE
    assert a.values.dtype == np.float32 and a.has_sd
    prof = nano_profile()
    assert fixtures.FUSED_GRID_SHAPE[2:6] == (
        len(prof.dist), len(prof.ytg), len(prof.sec), len(prof.sd))
    for i, name in enumerate(FUSED_CHANNELS[:7]):
        lo, hi = fixtures.CHANNEL_RANGES[name]
        col = a.values[:, i]
        assert lo <= col.min() and col.max() <= hi, name
    assert not np.array_equal(a.values, b.values)   # a grid per direction
    again, _ = fixtures.fused_tables(TABLE_SEED)
    np.testing.assert_array_equal(a.values, again.values)


def test_random_states_are_consistent():
    d = fixtures.play_states(np.random.default_rng(0), 1000)
    assert (d["period"] == np.where(d["sec"] > 0,
                                    4 - (d["sec"] - 1) // 900, 4)).all()
    assert set(np.unique(d["down"])) == {1, 2, 3, 4}
    assert (d["sec"] == 0).any() and ((d["sec"] > 1800) & (d["sec"] < 1830)).any()
    js, ps = jax_state(d), port_state(d)
    for f in INT_FIELDS + FLOAT_FIELDS + ("stats", "pstats"):
        np.testing.assert_array_equal(np.asarray(getattr(js, f)),
                                      getattr(ps, f).numpy())
    assert d["stats"].shape == (1000, 1, 1) and d["pstats"].shape == (1000, 1, 1, 1, 1)
    # with k the box score and player stats start nonzero: counts whole,
    # yards in tenths; the JAX and port states carry them alike
    d = fixtures.play_states(np.random.default_rng(0), 1000, k=8)
    assert d["stats"].shape == (1000, 2, 19) and d["pstats"].shape == (1000, 2, 3, 8, 6)
    for x, yards in ((d["stats"], [3, 8]), (d["pstats"], [2])):
        assert (x != 0).mean() > 0.9
        counts = np.delete(x, yards, axis=-1)
        assert (counts == np.round(counts)).all()
        assert (np.take(x, yards, axis=-1) != np.round(np.take(x, yards, axis=-1))).any()
    js, ps = jax_state(d), port_state(d)
    for f in ("stats", "pstats"):
        np.testing.assert_array_equal(np.asarray(getattr(js, f)), getattr(ps, f).numpy())

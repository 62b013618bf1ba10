"""The fused play-step probe of the PyTorch port (probes/step_arith.py)
against the JAX probe `benchmarks/pallas_step_arith.py`, on the CPU.

The probe's Pallas kernels draw from the TPU's hardware PRNG
(`pltpu.prng_seed`), which has no CPU form, so the port is held to the JAX
functions those kernels wrap (`rep_arith`, `table_select`, `init_state`,
`make_table`): exact on integer state when both are fed the same draws.  The
whole runs draw different streams (threefry there, Philox here), so they
agree within Monte-Carlo error.  The CUDA kernels themselves run only on a
card, where `chip_smoke.py` holds them to the plain versions tested here."""
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_monte_carlo_tpu_torch import fixtures
from fast_monte_carlo_tpu_torch.ops import rng
from fast_monte_carlo_tpu_torch.probes import step_arith as sa

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
B, STEPS = 4096, 48
KEY = rng.root_key(21)


@pytest.fixture(scope="module")
def jp():
    """benchmarks/pallas_step_arith.py, loaded unedited with B and STEPS
    parsed from argv.  It sets the persistent compilation cache at import;
    those settings are restored, since other tests share the process."""
    names = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {n: getattr(jax.config, n) for n in names}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["pallas_step_arith.py", str(B), str(STEPS)])
        mp.setattr(sys, "path", list(sys.path))
        spec = importlib.util.spec_from_file_location(
            "pallas_step_arith_probe", REPO / "benchmarks" / "pallas_step_arith.py")
        mod = importlib.util.module_from_spec(spec)
        try:
            spec.loader.exec_module(mod)
        finally:
            for n, v in saved.items():
                jax.config.update(n, v)
    assert (mod.B, mod.STEPS) == (B, STEPS)
    return mod


def _states(seed: int, n: int = B):
    """n random play-start states in STATE_FIELDS order (numpy), and their
    draws: uniforms on the Philox 2^-24 grid, standard normals."""
    g = np.random.default_rng(seed)
    d = fixtures.play_states(g, n)
    arrays = (d["off"], d["sec"], d["down"], d["dist"], d["ytg"], d["period"],
              d["in_rz"].astype(np.int32), d["score"][:, 0].copy(),
              d["score"][:, 1].copy())
    u, z = fixtures.play_draws(g, (n,))
    return arrays, u, z


def _assert_same_state(jax_out, port_out):
    for f, x, y in zip(sa.STATE_FIELDS, jax_out, port_out):
        x, y = np.asarray(x), y.numpy()
        if x.dtype.kind == "f":
            np.testing.assert_allclose(y, x, rtol=1e-5, atol=1e-5, err_msg=f)
        else:
            assert x.dtype == y.dtype == np.int32, f
            np.testing.assert_array_equal(y, x, err_msg=f"{f}: {(x != y).sum()} differ")


def _jax_heads(jp, arrays, values):
    return jp._heads_of(tuple(jnp.asarray(a) for a in arrays), values)


@pytest.mark.parametrize("table_heads", [False, True], ids=["analytic", "table"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_step_arith_equals_rep_arith_on_injected_draws(jp, seed, table_heads):
    arrays, u, z = _states(seed)
    jvalues = jp.make_table()
    jheads = _jax_heads(jp, arrays, jvalues) if table_heads else None
    want = jax.jit(jp.rep_arith)(tuple(jnp.asarray(a) for a in arrays),
                                 [jnp.asarray(u[:, i]) for i in range(13)],
                                 [jnp.asarray(z[:, i]) for i in range(4)], jheads)
    state = sa.state_from_numpy(arrays, "cpu")
    heads = (sa.heads_of(state, sa.table_from_numpy(np.asarray(jvalues), "cpu"))
             if table_heads else None)
    got = sa.step_arith(state, torch.from_numpy(u), torch.from_numpy(z), heads)
    _assert_same_state(want, got)
    # the states reach the machine's branches: scores, flips, 4th downs
    assert (got[7] + got[8] > state[7] + state[8]).any()
    assert (got[0] != state[0]).any() and (state[2] == 4).any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_table_select_matches_jax(jp, seed):
    arrays, _, _ = _states(seed)
    state = sa.state_from_numpy(arrays, "cpu")
    jvalues = jp.make_table()
    want = _jax_heads(jp, arrays, jvalues)
    got = sa.heads_of(state, sa.table_from_numpy(np.asarray(jvalues), "cpu"))
    assert len(got) == len(want) == sa.N_HC
    for g_, w in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w), rtol=1e-6, atol=0)
    # a table whose entry is row * 128 + channel shows the selected row and
    # channel themselves: identical in every game and head
    code = (np.arange(2 * sa.R_DIR)[:, None] * 128
            + np.arange(sa.N_CH)[None, :]).astype(np.float32)
    want = _jax_heads(jp, arrays, jnp.asarray(code))
    got = sa.heads_of(state, sa.table_from_numpy(code, "cpu"))
    for g_, w in zip(got, want):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w))
    rows = got[0].numpy().astype(np.int64) // 128
    assert np.unique(rows).size > 500 and (rows >= sa.R_DIR).any()


def test_init_state_and_make_table_match_jax(jp):
    for x, y in zip(jp.init_state(B), sa.init_state(B, "cpu")):
        assert np.asarray(x).dtype == y.numpy().dtype
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    np.testing.assert_array_equal(np.asarray(jp.make_table()), sa.make_table("cpu").numpy())


def _mc_check(jax_scores, port_scores):
    """Mean points per side and side-A win rate within 4 Monte-Carlo
    standard errors of the difference of two independent B-game runs."""
    ja, jb = (np.asarray(s, np.float64) for s in jax_scores)
    pa, pb = (s.numpy().astype(np.float64) for s in port_scores)
    for j, p in ((ja, pa), (jb, pb)):
        se = np.sqrt(j.var() / j.size + p.var() / p.size)
        assert abs(j.mean() - p.mean()) < 4 * se, (j.mean(), p.mean(), se)
    jw, pw = (ja > jb).mean(), (pa > pb).mean()
    se = np.sqrt(jw * (1 - jw) / ja.size + pw * (1 - pw) / pa.size)
    assert abs(jw - pw) < 4 * se, (jw, pw, se)
    assert 1.0 < pa.mean() < 15.0 and 0.2 < pw < 0.7


def test_eager_run_matches_jax_xla_within_mc_error(jp):
    want = jax.jit(jp.make_xla("threefry"))(jax.random.PRNGKey(0))
    got = sa.run_structure("eager", B, STEPS, KEY, "cpu")
    _mc_check(want, got)


def test_eager_tab_run_matches_jax_xla_tab_within_mc_error(jp):
    jvalues = jp.make_table()
    want = jax.jit(jp.make_xla_tab(jvalues))(jax.random.PRNGKey(0))
    got = sa.run_structure("eager-tab", B, STEPS, KEY, "cpu",
                           sa.table_from_numpy(np.asarray(jvalues), "cpu"))
    _mc_check(want, got)


def test_chunked_equals_per_step_on_the_plain_path():
    arrays, _, _ = _states(5, 2048)
    s0 = sa.state_from_numpy(arrays, "cpu")
    chunk = sa.fused_step(s0, KEY, 48, sa.CH)
    step = eager = s0
    for j in range(sa.CH):
        step = sa.fused_step(step, KEY, 48 + j, 1)
        u, z = rng.step_draws(KEY, 48 + j, 2048, "cpu")
        eager = sa.step_arith(eager, u, z)
    for a, b, c in zip(chunk, step, eager):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert not torch.equal(chunk[1], s0[1])


def test_structures_agree_on_the_cpu():
    """On the CPU every structure runs the plain step on one Philox stream,
    so the analytic three agree exactly, and so do the two table ones."""
    runs = {n: sa.run_structure(n, 512, 48, KEY, "cpu") for n in sa.STRUCTURES}
    for n in ("fused-step", "fused-chunk24"):
        assert all(torch.equal(x, y) for x, y in zip(runs[n], runs["eager"])), n
    assert all(torch.equal(x, y) for x, y in zip(runs["hybrid-tab"], runs["eager-tab"]))
    assert not torch.equal(runs["eager"][0], runs["eager-tab"][0])


def test_wrappers_run_the_plain_version_on_the_cpu():
    before = (sa.fused_step.launches, sa.fused_step_tab.launches)
    arrays, _, _ = _states(7, 256)
    s = sa.state_from_numpy(arrays, "cpu")
    values = sa.make_table("cpu")
    heads = sa.heads_of(s, values)
    got = sa.fused_step_tab(s, heads, KEY, 9)
    want = sa.fused_step_reference(s, KEY, 9, 1, heads)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    got = sa.fused_step(s, KEY, 9, 3)
    want = sa.fused_step_reference(s, KEY, 9, 3)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert (sa.fused_step.launches, sa.fused_step_tab.launches) == before
    with pytest.raises(ValueError):
        sa.fused_step(s[:8] + (s[8].to(torch.int64),), KEY, 0)
    with pytest.raises(ValueError):
        sa.fused_step_tab(s, heads[:6], KEY, 0)
    with pytest.raises(ValueError):
        sa.run_structure("fused-chunk24", 64, 30, KEY, "cpu")
    with pytest.raises(ValueError):
        sa.state_from_numpy(arrays[:8], "cpu")
    with pytest.raises(ValueError):
        sa.table_from_numpy(np.zeros((10, sa.N_CH)), "cpu")


def _is_one_slab(heads) -> bool:
    p = heads[0].data_ptr()
    return p % 16 == 0 and all(h.stride() == (sa.N_HC,) and h.data_ptr() == p + 4 * k
                               for k, h in enumerate(heads))


def test_head_slab_gives_the_kernel_one_b_by_7_tensor():
    """The tab kernel reads the heads only as the columns of one
    16-byte-aligned (B, 7) tensor.  table_select's heads are that and pass
    as they are; seven separate vectors, a mix, or columns one float off
    16 bytes are stacked into one.  The wrapper raises on a head of the
    wrong dtype or length."""
    arrays, _, _ = _states(8, 129)
    s = sa.state_from_numpy(arrays, "cpu")
    h7 = sa.heads_of(s, sa.make_table("cpu"))
    assert _is_one_slab(h7) and sa.head_slab(h7) is h7
    h1 = [h.contiguous() for h in h7]
    wide = torch.stack(h1[:1] + h1, 1)[:, 1:]        # starts 4 bytes past 16
    for heads in (h1, h1[:6] + h7[6:], wide.unbind(1)):
        got = sa.head_slab(heads)
        assert _is_one_slab(got)
        assert all(torch.equal(x, y) for x, y in zip(got, h7))
    with pytest.raises(ValueError):
        sa.fused_step_tab(s, h7[:6] + [h7[6].double()], KEY, 3)
    with pytest.raises(ValueError):
        sa.fused_step_tab(s, h7[:6] + [h7[6][:-1]], KEY, 3)


def test_cuda_request_without_cuda_raises_in_the_probe():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    with pytest.raises(RuntimeError):
        sa.init_state(8, "cuda")
    with pytest.raises(RuntimeError):
        sa.run_structure("fused-step", 8, 24, KEY, "cuda")
    with pytest.raises(RuntimeError):
        sa.main(["256", "24"])          # the command line defaults to the card


def test_command_line_on_the_cpu(capsys):
    assert sa.main(["256", "24", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert lines[0] == "device: cpu cpu B=256 steps=24"
    for name in sa.STRUCTURES:
        assert any(line.startswith(f"{name} ") and "eq-games/s" in line for line in lines)
    assert out.count("ms/step") == len(sa.STRUCTURES)
    assert out.count("x vs eager") == len(sa.STRUCTURES)
    assert "hybrid-tab vs eager-tab" in out

"""Philox play-step draws of the PyTorch port (ops/rng.py), on the CPU.

The CUDA kernel itself runs only on a card; `chip_smoke.py` holds it to
`philox_draws_reference` there.  Here: the Random123 known answers, the
(seed, step, row) counter contract, chunked == per-step, and the draws'
distribution against the JAX package's `chunk_draws` (which off the TPU
draws threefry, rng_pallas.py:140-147)."""
import jax
import numpy as np
import pytest
import torch
from scipy import stats

from fast_monte_carlo_tpu.ops.rng_pallas import chunk_draws as jax_chunk_draws
from fast_monte_carlo_tpu_torch.ops import rng

torch.set_num_threads(1)

KEY = 0x0123456789ABCDEF


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, want):
    """Random123's published Philox4x32-10 known-answer vectors."""
    c = [torch.tensor([v], dtype=torch.int64) for v in ctr]
    got = rng.philox4x32_10(*c, *key)
    assert tuple(int(g) for g in got) == want


def test_draws_depend_only_on_seed_step_row():
    u1, z1 = rng.philox_draws(KEY, 40, 2, 1000, "cpu")
    u2, z2 = rng.philox_draws(KEY, 40, 2, 1000, "cpu")
    assert torch.equal(u1, u2) and torch.equal(z1, z2)
    # a row's draws do not depend on the batch size
    u5, z5 = rng.philox_draws(KEY, 40, 2, 5000, "cpu")
    assert torch.equal(u1[:, 5], u5[:, 5]) and torch.equal(z1[:, 5], z5[:, 5])
    assert torch.equal(u1, u5[:, :1000])
    # other seeds, steps and rows draw other numbers
    u_other_key, _ = rng.philox_draws(KEY + 1, 40, 2, 1000, "cpu")
    u_other_step, _ = rng.philox_draws(KEY, 41, 2, 1000, "cpu")
    assert (u1 != u_other_key).float().mean() > 0.99
    assert torch.equal(u1[1], u_other_step[0])   # absolute step 41 either way
    assert (u1[0] != u_other_step[0]).float().mean() > 0.99
    assert (u1[0, 5] != u1[0, 6]).all()
    # the launch keys themselves
    assert rng.fold_in(rng.root_key(3), 0) != rng.fold_in(rng.root_key(3), 1)
    assert rng.root_key(3) != rng.root_key(4)


def test_chunked_equals_per_step():
    ch, n, base = 24, 700, 96
    u, z = rng.chunk_draws(KEY, base, ch, n, "cpu")
    assert u.shape == (ch, n, 13) and z.shape == (ch, n, 4)
    assert u.dtype == torch.float32 and z.dtype == torch.float32
    for j in (0, 7, 23):
        us, zs = rng.step_draws(KEY, base + j, n, "cpu")
        assert torch.equal(u[j], us) and torch.equal(z[j], zs)


def test_cpu_wrapper_is_the_reference_and_counts_no_launch():
    before = rng.philox_draws.launches
    out = (torch.empty((3, 50, 13)), torch.empty((3, 50, 4)))
    got = rng.chunk_draws(KEY, 5, 3, 50, "cpu", out=out)
    want = rng.philox_draws_reference(KEY, 5, 3, 50, "cpu")
    assert got[0] is out[0]
    assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])
    assert rng.philox_draws.launches == before
    # uniforms sit on the 2^-24 grid in [0, 1)
    u = want[0]
    assert torch.equal(u * 2 ** 24, torch.round(u * 2 ** 24))
    assert u.min() >= 0 and u.max() < 1


def test_output_buffer_must_start_16_byte_aligned():
    """The kernel stores whole float4s: the wrapper's check refuses a buffer
    4 bytes past a 16-byte boundary before any launch."""
    dev = torch.device("cpu")
    flat = torch.empty(3 * 50 * 13 + 4)
    assert flat.data_ptr() % 16 == 0
    rng._check_out(flat[:1950].view(3, 50, 13), (3, 50, 13), dev)
    for off in (1, 2, 3):
        with pytest.raises(ValueError, match="16-byte"):
            rng._check_out(flat[off:off + 1950].view(3, 50, 13), (3, 50, 13), dev)
    with pytest.raises(ValueError, match="contiguous"):
        rng._check_out(flat[:1950].view(3, 50, 13)[:, ::2], (3, 25, 13), dev)


def _sd_se(x: np.ndarray) -> float:
    """Standard error of the sample sd (delta method on the variance)."""
    v = x.var()
    m4 = ((x - x.mean()) ** 4).mean()
    return float(np.sqrt((m4 - v * v) / x.size) / (2 * np.sqrt(v)))


def test_distribution_matches_jax_chunk_draws():
    """1M rows of draws against the JAX package's chunk_draws CPU output."""
    ch, n = 4, 250_000
    tu, tz = (t.numpy().astype(np.float64)
              for t in rng.chunk_draws(rng.root_key(11), 0, ch, n, "cpu"))
    ju, jz = (np.asarray(a, np.float64) for a in
              jax_chunk_draws(jax.random.PRNGKey(11), 0, ch, n))
    assert tu.shape == ju.shape and tz.shape == jz.shape
    for t, j in ((tu, ju), (tz, jz)):
        tf, jf = t.reshape(-1), j.reshape(-1)
        mean_se = np.sqrt(tf.var() / tf.size + jf.var() / jf.size)
        assert abs(tf.mean() - jf.mean()) < 4 * mean_se
        sd_se = np.hypot(_sd_se(tf), _sd_se(jf))
        assert abs(tf.std() - jf.std()) < 4 * sd_se
        assert stats.ks_2samp(tf[:400_000], jf[:400_000]).pvalue > 1e-3
    # theory: U[0,1) and N(0,1), plus the +-1.96 sigma coverage
    assert abs(tu.mean() - 0.5) < 4 * np.sqrt(1 / 12 / tu.size)
    assert abs(tu.std() - np.sqrt(1 / 12)) < 4 * _sd_se(tu.reshape(-1))
    assert abs(tz.std() - 1.0) < 4 * _sd_se(tz.reshape(-1))
    cover = (np.abs(tz) < 1.96).mean()
    assert abs(cover - 0.95) < 4 * np.sqrt(0.95 * 0.05 / tz.size)
    # independence: lag-1 along rows and across the 17 columns
    rows = np.concatenate([tu, tz], axis=-1).reshape(-1, 17)   # 1M x 17
    lag = [np.corrcoef(rows[:-1, c], rows[1:, c])[0, 1] for c in range(17)]
    assert max(abs(x) for x in lag) < 0.006
    cc = np.corrcoef(rows.T)
    assert np.abs(cc[np.triu_indices(17, 1)]).max() < 0.006

"""The row-gather probes of the PyTorch port (probes/gather.py) against
`jnp.take`, on the CPU, at the shapes of the JAX package's Pallas gather
probes (B3 `pallas_gather_probe.py`, B4 `pallas_gather_forms.py`, B5
`pallas_dyngather.py`, B6 `pallas_dma_gather.py`).  Here the wrappers run
their plain versions; `chip_smoke.py` holds the CUDA kernels to them on a
card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_monte_carlo_tpu_torch.probes import gather as ga

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _mod_np(rows: int, cols: int) -> np.ndarray:
    return (np.arange(rows * cols) % 997).astype(np.float32).reshape(rows, cols)


def test_b3_row_sum_equals_jnp_take_sum():
    tab, idx = ga.b3_inputs(CPU)
    assert tab.shape == (ga.B3_ROWS, ga.B3_COLS) and idx.shape == (ga.B3_B,)
    for k in (0, 1, 359):
        i = (idx + k * 9973) % ga.B3_ROWS
        want = jnp.take(tab.numpy(), i.numpy(), axis=0).sum(axis=1)
        np.testing.assert_array_equal(ga.row_gather_sum(tab, i).numpy(), np.asarray(want))
        np.testing.assert_array_equal(ga.row_gather(tab, i).numpy(),
                                      np.asarray(jnp.take(tab.numpy(), i.numpy(), axis=0)))


def test_b4_gather_equals_every_jax_form():
    table = ga.mod_table(ga.B4_ROWS, ga.B4_COLS, CPU)
    np.testing.assert_array_equal(table.numpy(), _mod_np(ga.B4_ROWS, ga.B4_COLS))
    idx = (torch.arange(ga.B4_B, dtype=torch.int32) * 7) % ga.B4_ROWS
    t, i = jnp.asarray(table.numpy()), jnp.asarray(idx.numpy())
    got = ga.row_gather(table, idx).numpy()
    forms = (jnp.take(t, i, axis=0),
             jnp.take_along_axis(t, jnp.broadcast_to(i[:, None], (ga.B4_B, ga.B4_COLS)), axis=0),
             t[i])
    for want in forms:
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("rows", ga.B5_ROWS)
def test_b5_gather_equals_take_along_axis(rows):
    table = ga.mod_table(rows, ga.B5_COLS, CPU)
    idx1 = (torch.arange(rows, dtype=torch.int32) * 1103 + 7) % rows
    t = jnp.asarray(table.numpy())
    for i in (0, 17, ga.B5_ITERS - 1):
        k = (idx1 + i) % rows
        kj = jnp.asarray(k.numpy())
        want = jnp.take_along_axis(t, jnp.broadcast_to(kj[:, None], (rows, ga.B5_COLS)),
                                   axis=0)
        np.testing.assert_array_equal(ga.row_gather(table, k).numpy(), np.asarray(want))


@pytest.mark.parametrize("b", ga.B6_BS)
def test_b6_gather_equals_rows_of_the_8x_block_output(b):
    table = ga.mod_table(ga.B6_ROWS, ga.B6_COLS, CPU)
    idx = (torch.arange(b, dtype=torch.int32) * 1103 + 7) % ga.B6_ROWS
    # the Pallas kernel wrote each gathered row over an 8-row block; its
    # probe checked out[::8]
    blocks = jnp.repeat(jnp.take(jnp.asarray(table.numpy()), jnp.asarray(idx.numpy()),
                                 axis=0), 8, axis=0)
    assert blocks.shape == (8 * b, ga.B6_COLS)
    np.testing.assert_array_equal(ga.row_gather(table, idx).numpy(), np.asarray(blocks)[::8])


def test_probes_run_and_check_on_the_cpu():
    res = ga.run_probes("cpu")
    assert set(res) == {"B3", "B4", "B5 R=512", "B5 R=2048", "B5 R=8192",
                        "B6 B=1024", "B6 B=8192"}
    assert all(r["correct"] for r in res.values())
    assert all(v > 0 for r in res.values() for k, v in r.items() if "ms" in k)


def test_wrappers_run_the_plain_version_on_the_cpu():
    before = (ga.row_gather.launches, ga.row_gather_sum.launches)
    table = torch.arange(40, dtype=torch.float32).view(10, 4)
    idx = torch.tensor([3, 0, 9, 3], dtype=torch.int32)
    assert torch.equal(ga.row_gather(table, idx), table[idx.long()])
    assert torch.equal(ga.row_gather_sum(table, idx), table[idx.long()].sum(1))
    assert (ga.row_gather.launches, ga.row_gather_sum.launches) == before
    with pytest.raises(ValueError):
        ga.row_gather(table, idx.long())
    with pytest.raises(ValueError):
        ga.row_gather(table.double(), idx)
    with pytest.raises(ValueError):
        ga.row_gather_sum(table.t(), idx)


def test_cuda_request_without_cuda_raises_in_the_probe():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    with pytest.raises(RuntimeError):
        ga.run_probes("cuda")
    with pytest.raises(RuntimeError):
        ga.main([])                      # the command line defaults to the card

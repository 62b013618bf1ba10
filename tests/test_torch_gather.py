"""The row-gather probes of the PyTorch port (probes/gather.py) against
`jnp.take`, on the CPU, at the shapes of the JAX package's Pallas gather
probes (B3 `pallas_gather_probe.py`, B4 `pallas_gather_forms.py`, B5
`pallas_dyngather.py`, B6 `pallas_dma_gather.py`).  Here the wrappers run
their plain versions; `chip_smoke.py` holds the CUDA kernels to them on a
card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_monte_carlo_tpu_torch.probes import gather as ga
from fast_monte_carlo_tpu_torch.probes import kernels

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


@pytest.mark.parametrize("fn", ["row_gather", "row_gather_sum"])
def test_indices_outside_the_table_clip_as_jnp_take_clip(fn):
    """The kernels clip indices to [0, rows); so do the plain versions, as
    the probes' XLA reference does (pallas_gather_probe.py:29)."""
    g = np.random.default_rng(3)
    t = g.random((37, 5), dtype=np.float32)
    i = np.array([-2 ** 31, -40, -1, 0, 17, 36, 37, 38, 1000, 2 ** 31 - 1], np.int32)
    want = jnp.take(jnp.asarray(t), jnp.asarray(i), axis=0, mode="clip")
    if fn == "row_gather_sum":
        want = want.sum(axis=1)
    got = getattr(ga, fn)(torch.from_numpy(t), torch.from_numpy(i))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ref = getattr(ga, f"{fn}_reference")(torch.from_numpy(t), torch.from_numpy(i))
    np.testing.assert_array_equal(ref.numpy(), np.asarray(want))


@pytest.mark.parametrize("cols", [1, 3, 5, 8, 127, 128, 129, 1000])
def test_row_sum_at_every_lane_group_width(cols):
    """Widths that take the kernel's float4 and scalar paths, one item per
    lane and a loop within the warp.  torch and XLA sum in their own
    orders: within 1e-6 relative, the gate `chip_smoke.py` holds the kernel
    to."""
    g = np.random.default_rng(cols)
    t = g.random((300, cols), dtype=np.float32)
    i = g.integers(0, 300, 1001).astype(np.int32)
    want = np.asarray(jnp.take(jnp.asarray(t), jnp.asarray(i), axis=0).sum(axis=1))
    got = ga.row_gather_sum(torch.from_numpy(t), torch.from_numpy(i)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_the_timer_takes_its_row_sum_shapes_from_the_probes():
    """probes.kernels times row_gather_sum at B3's shape and at B6's 8,192
    rows of 128, which chip_smoke.py reports, on the probes' own inputs."""
    shapes = ga.probe_shapes(CPU)
    assert tuple(what for what, _, _ in shapes) == ga.PROBE_SHAPES
    timed = {n.split(" ", 1)[1] for n in kernels.RUNS if n.startswith("row_gather_sum")}
    assert timed == {"B3", f"B6 B={ga.B6_BS[-1]}"} and timed <= set(ga.PROBE_SHAPES)
    for what, table, idx in shapes:
        assert idx.dtype == torch.int32 and int(idx.min()) >= 0
        assert int(idx.max()) < table.shape[0], what
    tab, idx = ga.b3_inputs(CPU)
    assert torch.equal(shapes[0][1], tab) and torch.equal(shapes[0][2], idx)


def test_b3_loop_accumulates_the_shifted_row_sums():
    """B3's loop, cut to `steps` as probes.kernels.path_times runs it."""
    tab, idx = ga.mod_table(97, 8, CPU), torch.arange(40, dtype=torch.int32) * 5
    want = sum(tab[((idx.long() + k * 9973) % 97)].sum(1) for k in range(3))
    assert torch.allclose(ga.b3_loop(ga.row_gather_sum, tab, idx, steps=3), want)
    assert torch.equal(ga.b3_loop(ga.row_gather_sum, tab, idx, steps=3),
                       ga.b3_loop(ga.row_gather_sum, tab, idx, sync=True, steps=3))


@pytest.mark.parametrize("rows", ga.B5_ROWS)
def test_b5_loop_equals_the_jax_probes_xla_loop(rows):
    """gather.b5_loop against pallas_dyngather.py's `xla_loop` (:36-40; the
    Pallas loop :23-27 sums the same gathers): jnp.take of 50 shifted index
    sets summed by a fori_loop, on the probe's inputs (:15-16).  The
    table's values are integers below 997, so every f32 sum is exact and
    the two agree bit for bit."""
    table, idx1 = ga.b5_inputs(rows, CPU)
    np.testing.assert_array_equal(table.numpy(), _mod_np(rows, ga.B5_COLS))
    np.testing.assert_array_equal(idx1.numpy(), (np.arange(rows) * 1103 + 7) % rows)

    @jax.jit
    def xla_loop(t, i1):
        def body(i, acc):
            return acc + jnp.take(t, (i1 + i) % rows, axis=0)
        return jax.lax.fori_loop(0, ga.B5_ITERS, body,
                                 jnp.zeros((rows, ga.B5_COLS), jnp.float32))

    want = np.asarray(xla_loop(jnp.asarray(table.numpy()), jnp.asarray(idx1.numpy())))
    got = ga.b5_loop(ga.row_gather, table, idx1)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ga.b5_loop(ga.row_gather, table, idx1, sync=True).numpy(), want)


@pytest.mark.parametrize("cols", [1, 3, 5, 8, 127, 128, 129, 1000])
def test_row_gather_at_every_lane_group_width(cols):
    """The widths at which the kernel takes each lane group (1-32 lanes,
    float4 items and floats, one item a lane and a loop within the warp),
    some indices outside the table: row_gather equals jnp.take with
    mode="clip", bit for bit, as `chip_smoke.py` holds the kernel to its
    plain version."""
    g = np.random.default_rng(100 + cols)
    t = g.random((300, cols), dtype=np.float32)
    i = g.integers(-5, 305, 1001).astype(np.int32)
    want = np.asarray(jnp.take(jnp.asarray(t), jnp.asarray(i), axis=0, mode="clip"))
    np.testing.assert_array_equal(ga.row_gather(torch.from_numpy(t), torch.from_numpy(i)).numpy(),
                                  want)


def test_the_timer_takes_every_row_gather_shape_and_b5_step_from_the_probes():
    """probes.kernels times row_gather at every gather probe's shape and a
    step of B5's loop at each R, on the probes' own inputs, beside the
    bytes row_gather must move."""
    timed = {n.split(" ", 1)[1] for n in kernels.RUNS if n.startswith("row_gather ")}
    assert timed == set(ga.PROBE_SHAPES)
    steps = {n: k for n, k in kernels.PATH_STEPS.items() if n.startswith("B5 loop step")}
    assert steps == {f"B5 loop step R={r}": ga.B5_ITERS for r in ga.B5_ROWS}
    shapes = {what: (table, idx) for what, table, idx in ga.probe_shapes(CPU)}
    for rows in ga.B5_ROWS:
        table, idx1 = ga.b5_inputs(rows, CPU)
        assert torch.equal(shapes[f"B5 R={rows}"][0], table)
        assert torch.equal(shapes[f"B5 R={rows}"][1], idx1)
    # B5 at R = 8,192: the indices, every row once in and once out
    assert ga.row_gather_bytes(*shapes["B5 R=8192"]) == 4 * 8192 + 2 * 8192 * 128 * 4
    table, idx = shapes["B6 B=1024"]
    assert ga.row_gather_bytes(table, idx) == 4 * 1024 + 2 * 1024 * 128 * 4
    table, idx = torch.zeros(10, 4), torch.tensor([3, 3, 3, 7], dtype=torch.int32)
    assert ga.row_gather_bytes(table, idx) == 4 * 4 + (2 + 4) * 4 * 4


def test_gather_sass_sizes_counts_each_gather_kernel(tmp_path):
    """`probes.kernels --sass` counts the instructions of each gather
    kernel in a `cuobjdump -sass` dump, and of nothing else."""
    ins = "        /*{:04x}*/                   {} ;      /* 0x000000000000000000 */"
    dump = ["", "\tcode for sm_90a",
            "\t\tFunction : _ZN12_GLOBAL__N_117row_gather_kernelI6float4Li2EEEvPKT_PKiPS2_iiii"]
    ops = ["LDC R1, c[0x0][0x28]", "S2R R0, SR_TID.X", "EXIT", "BRA 0x30"]
    dump += [ins.format(16 * k, op) for k, op in enumerate(ops)]
    dump += ["\t\tFunction : _ZN12_GLOBAL__N_121row_gather_sum_kernelIfEEvPKT_PKiPfiiii"]
    dump += [ins.format(16 * k, "NOP") for k in range(3)]
    dump += ["\t\tFunction : _Z11other_kernelv", ins.format(0, "EXIT")]
    path = tmp_path / "row_gather.sass"
    path.write_text("\n".join(dump) + "\n")
    assert kernels.gather_sass_sizes(path) == {
        "_ZN12_GLOBAL__N_117row_gather_kernelI6float4Li2EEEvPKT_PKiPS2_iiii": 4,
        "_ZN12_GLOBAL__N_121row_gather_sum_kernelIfEEvPKT_PKiPfiiii": 3}

"""Row-gather probes: ports of the JAX package's Pallas gather probes.

One function, one table row per game, probed four ways on the TPU:

  B3  benchmarks/pallas_gather_probe.py   take(tab, idx, 0).sum(1), looped 360x
  B4  benchmarks/pallas_gather_forms.py   five spellings of table[idx]
  B5  benchmarks/pallas_dyngather.py      take_along_axis with a per-row index
  B6  benchmarks/pallas_dma_gather.py     per-row DMA through prefetched indices

Two kernels of `csrc/row_gather.cu` serve them: `row_gather` (table[idx],
B4-B6) and `row_gather_sum` (table[idx].sum(1), B3).  Their plain versions
are `row_gather_reference` and `row_gather_sum_reference`; CPU tensors run
them, CUDA tensors launch the kernel.  B6's Pallas kernel wrote each row 8
times because Mosaic's smallest block is 8 rows; that copy is a TPU block
size artefact and is not ported, so B6 here checks `out` itself where the
original checked `out[::8]`.

    python -m fast_monte_carlo_tpu_torch.probes.gather [--device cuda|cpu]

runs each probe at its original shapes, checks it as the original does and
prints ms per call; it exits 1 if a check fails.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import sys
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device

B3_ROWS, B3_COLS, B3_B, B3_STEPS = 58320 * 2, 8, 131072, 360
B4_ROWS, B4_COLS, B4_B = 512, 8, 1024
B4_FORMS = ("jnp.take", "take_along_axis", "advanced-index", "lax.gather",
            "transposed tala (lane-dim)")
B5_ROWS, B5_COLS, B5_ITERS = (512, 2048, 8192), 128, 50
B6_ROWS, B6_COLS, B6_BS = 16384, 128, (1024, 8192)


# ---------------------------------------------------------------------------
# plain versions and kernel wrappers
# ---------------------------------------------------------------------------

def _clipped(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """idx as int64, clipped to [0, rows), as the kernels and the probes'
    XLA reference (`jnp.take(..., mode="clip")`) clip."""
    return idx.long().clamp(0, table.shape[0] - 1)


def row_gather_reference(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table[_clipped(table, idx)]


def row_gather_sum_reference(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table[_clipped(table, idx)].sum(1)


@functools.lru_cache(maxsize=None)
def _launcher(symbol: str):
    from ..utils.cuda_build import load_kernel_library

    fn = getattr(load_kernel_library("row_gather"), symbol)
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(table: torch.Tensor, idx: torch.Tensor) -> torch.device:
    if (table.dtype != torch.float32 or table.dim() != 2 or table.shape[0] == 0
            or not table.is_contiguous()):
        raise ValueError(f"table must be a contiguous non-empty float32 matrix; "
                         f"got {table.dtype} {tuple(table.shape)}")
    if idx.dtype != torch.int32 or idx.dim() != 1 or not idx.is_contiguous():
        raise ValueError(f"idx must be a contiguous int32 vector; got {idx.dtype} "
                         f"{tuple(idx.shape)}")
    if idx.device != table.device or table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"table on {table.device}, idx on {idx.device}: one "
                         "device, cpu or cuda")
    if table.numel() >= 2 ** 31 or idx.numel() * table.shape[1] >= 2 ** 31:
        raise ValueError("row_gather takes fewer than 2^31 elements")
    return table.device


def _launch(symbol: str, table, idx, out) -> None:
    dev = table.device
    with torch.cuda.device(dev):
        err = _launcher(symbol)(table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                                table.shape[0], table.shape[1], idx.shape[0],
                                torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{symbol} failed: CUDA error {err}")


def row_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx]: (n, cols) from a (rows, cols) f32 table and (n,) int32
    indices, each clipped to [0, rows) (by the kernel on CUDA, the plain
    version on the CPU).  `row_gather.launches` counts kernel launches."""
    if _check(table, idx).type == "cpu":
        return row_gather_reference(table, idx)
    out = torch.empty((idx.shape[0], table.shape[1]), dtype=torch.float32,
                      device=table.device)
    _launch("row_gather_launch", table, idx, out)
    row_gather.launches += 1
    return out


row_gather.launches = 0


def row_gather_sum(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx].sum(1): (n,), indices clipped as in `row_gather`.  On CUDA
    a group of lanes sums each row and reduces by shuffles, so the sum is
    not taken in column order: it agrees with the plain version to f32
    rounding (`chip_smoke.py` holds it within 1e-6 relative).
    `row_gather_sum.launches` counts kernel launches."""
    if _check(table, idx).type == "cpu":
        return row_gather_sum_reference(table, idx)
    out = torch.empty(idx.shape[0], dtype=torch.float32, device=table.device)
    _launch("row_gather_sum_launch", table, idx, out)
    row_gather_sum.launches += 1
    return out


row_gather_sum.launches = 0


# ---------------------------------------------------------------------------
# the probes
# ---------------------------------------------------------------------------

def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _ms(fn: Callable[[], object], dev: torch.device, reps: int) -> float:
    """Host-clock ms per call of `fn` over `reps` calls after one warm-up,
    the run ended by a device synchronise."""
    fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(dev)
    return (time.perf_counter() - t0) * 1e3 / reps


def _once(fn: Callable[[], torch.Tensor], dev: torch.device):
    """(fn(), host-clock ms of that one call, ended by a device synchronise)."""
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, (time.perf_counter() - t0) * 1e3


def mod_table(rows: int, cols: int, dev: torch.device) -> torch.Tensor:
    """(rows, cols) f32 with entry k = k % 997, the probes' test table."""
    return (torch.arange(rows * cols, device=dev) % 997).to(torch.float32).view(rows, cols)


def b3_inputs(dev: torch.device):
    """B3's table (116,640, 8) U[0, 1) and indices (131,072,) in [0, rows),
    from numpy seed 0."""
    g = np.random.default_rng(0)
    tab = torch.from_numpy(g.random((B3_ROWS, B3_COLS), dtype=np.float32)).to(dev)
    idx = torch.from_numpy(g.integers(0, B3_ROWS, B3_B, dtype=np.int32)).to(dev)
    return tab, idx


def b5_inputs(rows: int, dev: torch.device):
    """B5's table (rows, 128) on `mod_table` and its indices idx1 (rows,),
    (k * 1103 + 7) % rows (pallas_dyngather.py:15-16)."""
    idx1 = (torch.arange(rows, dtype=torch.int32, device=dev) * 1103 + 7) % rows
    return mod_table(rows, B5_COLS, dev), idx1


def probe_shapes(dev: torch.device):
    """[(name, table, idx)] at each probe's timed shape, names as in
    `PROBE_SHAPES`: B3's inputs, then B4, B5 and B6 on `mod_table`."""
    tab3, idx3 = b3_inputs(dev)
    shapes = [("B3", tab3, idx3),
              ("B4", mod_table(B4_ROWS, B4_COLS, dev),
               (torch.arange(B4_B, dtype=torch.int32, device=dev) * 7) % B4_ROWS)]
    for rows in B5_ROWS:
        shapes.append((f"B5 R={rows}", *b5_inputs(rows, dev)))
    for b in B6_BS:
        shapes.append((f"B6 B={b}", mod_table(B6_ROWS, B6_COLS, dev),
                       (torch.arange(b, dtype=torch.int32, device=dev) * 1103 + 7) % B6_ROWS))
    return shapes


def row_gather_bytes(table: torch.Tensor, idx: torch.Tensor) -> int:
    """Bytes `row_gather(table, idx)` must move: the indices and each row
    they touch read once, the output written once."""
    touched = int(torch.unique(idx).numel())
    return 4 * idx.numel() + (touched + idx.numel()) * table.shape[1] * 4


PROBE_SHAPES = ("B3", "B4", *(f"B5 R={r}" for r in B5_ROWS), *(f"B6 B={b}" for b in B6_BS))


def b3_loop(fn: Callable, tab: torch.Tensor, idx: torch.Tensor,
            sync: bool = False, steps: int = B3_STEPS) -> torch.Tensor:
    """B3's loop (pallas_gather_probe.py:26-30): fn(tab, idx shifted by
    k * 9973) accumulated over `steps` k, 360 in the probe.  `sync`
    synchronises the device after every call of fn, so that no call
    overlaps another."""
    c = torch.zeros(idx.shape[0], dtype=torch.float32, device=tab.device)
    for k in range(steps):
        c = c + fn(tab, (idx + k * 9973) % tab.shape[0])
        if sync:
            _sync(tab.device)
    return c


def b5_loop(fn: Callable, table: torch.Tensor, idx1: torch.Tensor,
            steps: int = B5_ITERS, sync: bool = False) -> torch.Tensor:
    """B5's loop (pallas_dyngather.py:23-27, and its XLA reference
    `xla_loop` :36-40): fn(table, (idx1 + i) % rows) accumulated over
    `steps` i, 50 in the probe.  `sync` synchronises the device after every
    call of fn, so that no call overlaps another."""
    rows = table.shape[0]
    acc = torch.zeros((idx1.shape[0], table.shape[1]), dtype=torch.float32, device=table.device)
    for i in range(steps):
        acc = acc + fn(table, (idx1 + i) % rows)
        if sync:
            _sync(table.device)
    return acc


def probe_b3(dev: torch.device) -> dict:
    """take(tab, idx).sum(1) once and accumulated over 360 shifted index
    sets (pallas_gather_probe.py:26-30, 63-66); the looped sum is checked
    against the plain loop."""
    tab, idx = b3_inputs(dev)
    ms_x1 = _ms(lambda: row_gather_sum(tab, idx), dev, 20)    # also warms the kernel
    got, ms_loop = _once(lambda: b3_loop(row_gather_sum, tab, idx), dev)
    want, plain_ms_loop = _once(lambda: b3_loop(row_gather_sum_reference, tab, idx), dev)
    return dict(correct=bool(torch.allclose(got, want, rtol=1e-5, atol=0)),
                ms_x1=ms_x1, ms_loop=ms_loop, plain_ms_loop=plain_ms_loop)


def probe_b4(dev: torch.device) -> dict:
    """table[idx] at (512, 8) x 1024 (pallas_gather_forms.py:10-17); the
    five TPU spellings are one function, and one kernel, here."""
    table = mod_table(B4_ROWS, B4_COLS, dev)
    idx = (torch.arange(B4_B, dtype=torch.int32, device=dev) * 7) % B4_ROWS
    out = row_gather(table, idx)
    return dict(correct=bool(torch.allclose(out, table[idx.long()])),
                ms=_ms(lambda: row_gather(table, idx), dev, 20))


def probe_b5(dev: torch.device, rows: int) -> dict:
    """table[idx1] at (R, 128), once and accumulated over 50 shifted index
    sets (pallas_dyngather.py:14-33)."""
    table, idx1 = b5_inputs(rows, dev)
    out = row_gather(table, idx1)
    correct = bool(torch.allclose(out, table[idx1.long()]))
    got, ms = _once(lambda: b5_loop(row_gather, table, idx1), dev)
    want, plain_ms = _once(lambda: b5_loop(row_gather_reference, table, idx1), dev)
    return dict(correct=correct and bool(torch.equal(got, want)),
                ms_per_call=ms / B5_ITERS, plain_ms_per_call=plain_ms / B5_ITERS)


def probe_b6(dev: torch.device, b: int) -> dict:
    """table[idx] at (16384, 128) x B (pallas_dma_gather.py:15-37)."""
    table = mod_table(B6_ROWS, B6_COLS, dev)
    idx = (torch.arange(b, dtype=torch.int32, device=dev) * 1103 + 7) % B6_ROWS
    out = row_gather(table, idx)
    return dict(correct=bool(torch.allclose(out, table[idx.long()])),
                ms=_ms(lambda: row_gather(table, idx), dev, 5))


def run_probes(device="cuda") -> Dict[str, dict]:
    """Every probe at its original shapes; results keyed by probe name."""
    dev = resolve_device(device)
    res = {"B3": probe_b3(dev), "B4": probe_b4(dev)}
    for rows in B5_ROWS:
        res[f"B5 R={rows}"] = probe_b5(dev, rows)
    for b in B6_BS:
        res[f"B6 B={b}"] = probe_b6(dev, b)
    return res


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="Row-gather probes (B3-B6) on the card")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {dev.type} {name}", flush=True)
    res = run_probes(dev)
    r = res["B3"]
    print(f"B3 row_gather_sum (116640, 8) x 131072: correct={r['correct']}  "
          f"x1 {r['ms_x1']:.4f} ms  loop x{B3_STEPS} {r['ms_loop']:.3f} ms  "
          f"plain loop {r['plain_ms_loop']:.3f} ms", flush=True)
    r = res["B4"]
    print(f"B4 row_gather (512, 8) x 1024, for {', '.join(B4_FORMS)}: "
          f"correct={r['correct']}  {r['ms']:.4f} ms", flush=True)
    for rows in B5_ROWS:
        r = res[f"B5 R={rows}"]
        print(f"B5 row_gather R={rows} L={B5_COLS}: correct={r['correct']}  "
              f"{r['ms_per_call']:.4f} ms/call  {rows / r['ms_per_call'] * 1e3:,.0f} rows/s  "
              f"(plain {r['plain_ms_per_call']:.4f} ms/call)", flush=True)
    for b in B6_BS:
        r = res[f"B6 B={b}"]
        print(f"B6 row_gather B={b}: correct={r['correct']}  {r['ms']:.4f} ms  "
              f"{b / r['ms'] * 1e3:,.0f} rows/s", flush=True)
    return 0 if all(r["correct"] for r in res.values()) else 1


if __name__ == "__main__":
    sys.exit(main())

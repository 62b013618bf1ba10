"""Play-step draws: Philox4x32-10, 13 uniforms + 4 normals per (step, row).

Port of `fast_monte_carlo_tpu/ops/rng_pallas.py`.  `step_draws` (K3) and
`chunk_draws` (K4) are one CUDA kernel, `csrc/philox_draws.cu`, with a step
axis of 1 or of a whole play chunk.  The stream is counter-based: key = the
64-bit launch key, counter = (row, absolute step, block, 0), so a game's
draws depend only on (key, absolute step, row) and the chunked stream equals
the per-step stream.  The TPU kernels draw from the chip's hardware PRNG, so
the two packages agree in distribution only (the same contract the JAX
package states for its rbg and pallas paths).  A launch may start at row
`row0`: a rank that plays games row0 .. row0 + n - 1 of a wider launch
draws exactly their rows (`parallel.mesh`).

`philox_draws_reference` is the same function in plain torch: the CPU path
and the tests use it, and `chip_smoke.py` holds the kernel to it on the
card.  `philox_draws` sends CPU tensors to it and CUDA tensors to the kernel,
never one for the other.

Launch keys are derived on the host from (seed, launch index) by SplitMix64
(`root_key`, `fold_in`), the counterpart of `jax.random.PRNGKey` and
`fold_in`.
"""
from __future__ import annotations

import ctypes
import math
from collections import Counter
from typing import Optional, Tuple

import numpy as np
import torch

N_UNIFORMS = 13
N_NORMALS = 4
N_WORDS = N_UNIFORMS + N_NORMALS   # 17 of the 20 words of 5 Philox blocks
_BLOCKS = 5

_MASK32 = 0xFFFFFFFF
_MASK64 = 0xFFFFFFFFFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_TWO_PI_F32 = float(np.float32(2.0 * math.pi))
_EPS = 1e-7

_KERNEL = "philox_draws"


# ---------------------------------------------------------------------------
# launch keys
# ---------------------------------------------------------------------------

def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def root_key(seed: int) -> int:
    """64-bit key of a seed (counterpart of jax.random.PRNGKey)."""
    return _splitmix64(int(seed) & _MASK64)


def fold_in(key: int, data: int) -> int:
    """Independent 64-bit key for (key, data) (counterpart of
    jax.random.fold_in): launch ci of a run draws from fold_in(root, ci)."""
    return _splitmix64(key ^ _splitmix64(int(data) & _MASK64))


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 tensors holding uint32 words.  The 32x32->64
    products overflow int64 and wrap, which keeps both 32-bit halves right;
    k0/k1 are uint32 Python ints or int64 tensors."""
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        p0 = c0 * _M0
        p1 = c2 * _M1
        c0, c1, c2, c3 = (((p1 >> 32) & _MASK32) ^ c1 ^ k0, p1 & _MASK32,
                          ((p0 >> 32) & _MASK32) ^ c3 ^ k1, p0 & _MASK32)
    return c0, c1, c2, c3


def _transform(words: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., 17) uint32 words in int64 -> (uniforms (..., 13), normals (..., 4))."""
    u01 = (words & 0x00FFFFFF).to(torch.float32) * (1.0 / (1 << 24))
    a0 = torch.clamp_min(u01[..., 13], _EPS)
    a1 = torch.clamp_min(u01[..., 15], _EPS)
    r0 = torch.sqrt(-2.0 * torch.log(a0))
    r1 = torch.sqrt(-2.0 * torch.log(a1))
    t0 = _TWO_PI_F32 * u01[..., 14]
    t1 = _TWO_PI_F32 * u01[..., 16]
    z = torch.stack([r0 * torch.cos(t0), r0 * torch.sin(t0),
                     r1 * torch.cos(t1), r1 * torch.sin(t1)], dim=-1)
    return u01[..., :N_UNIFORMS].contiguous(), z


def philox_draws_reference(key: int, step_base: int, ch: int, n: int,
                           device, row0: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch twin of the kernel: (u (ch, n, 13), z (ch, n, 4)) f32,
    the draws of rows row0 .. row0 + n - 1 (so a slice of a launch too
    wide to draw in plain torch can be checked)."""
    dev = torch.device(device)
    k0, k1 = key & _MASK32, (key >> 32) & _MASK32
    row = torch.arange(row0, row0 + n, dtype=torch.int64, device=dev).expand(ch, n)
    step = ((step_base + torch.arange(ch, dtype=torch.int64, device=dev))
            & _MASK32).view(ch, 1).expand(ch, n)
    zero = torch.zeros((ch, n), dtype=torch.int64, device=dev)
    words = []
    for b in range(_BLOCKS):
        words.extend(philox4x32_10(row, step, zero + b, zero, k0, k1))
    return _transform(torch.stack(words[:N_WORDS], dim=-1))


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

def _launcher():
    from ..utils.cuda_build import load_kernel_library

    lib = load_kernel_library(_KERNEL)
    fn = lib.philox_draws_launch
    fn.argtypes = [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_out(t: torch.Tensor, shape, dev: torch.device) -> None:
    """Raises unless `t` is a contiguous float32 `shape` on `dev` starting
    on a 16-byte boundary (the kernel stores whole float4s)."""
    if (t.shape != shape or t.dtype != torch.float32 or t.device != dev
            or not t.is_contiguous()):
        raise ValueError(f"output buffer must be contiguous float32 {shape} "
                         f"on {dev}; got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")
    if t.data_ptr() % 16:
        raise ValueError(f"output buffer must start 16-byte aligned; got "
                         f"address {t.data_ptr():#x}")


def philox_draws(key: int, step_base: int, ch: int, n: int, device,
                 out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 row0: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(u (ch, n, 13), z (ch, n, 4)) for absolute steps step_base..+ch-1
    and rows row0..row0+n-1.

    On CUDA this launches the hand-written kernel on the current stream
    (into `out` when given, so a launch reuses one buffer; each buffer
    contiguous and 16-byte aligned, or it raises); on the CPU it
    runs `philox_draws_reference`.  `philox_draws.launches` counts kernel
    launches and nothing else; `philox_draws.launches_by_ch` splits that
    count by ch."""
    dev = torch.device(device)
    if ch < 0 or n < 0 or ch * n >= 2 ** 31:
        raise ValueError(f"bad draw shape ch={ch}, n={n}")
    if row0 < 0 or row0 + n > 2 ** 32:
        raise ValueError(f"rows {row0}..{row0 + n - 1} outside the 32-bit row counter")
    if dev.type == "cpu":
        u, z = philox_draws_reference(key, step_base, ch, n, dev, row0)
        if out is not None:
            out[0].copy_(u)
            out[1].copy_(z)
            return out
        return u, z
    if dev.type != "cuda":
        raise ValueError(f"philox_draws: unsupported device {dev}")
    if out is None:
        out = (torch.empty((ch, n, N_UNIFORMS), dtype=torch.float32, device=dev),
               torch.empty((ch, n, N_NORMALS), dtype=torch.float32, device=dev))
    if dev.index is None:
        dev = out[0].device
    _check_out(out[0], (ch, n, N_UNIFORMS), dev)
    _check_out(out[1], (ch, n, N_NORMALS), dev)
    launch = _launcher()
    with torch.cuda.device(dev):
        err = launch(key & _MASK32, (key >> 32) & _MASK32,
                     step_base & _MASK32, row0, ch, n, out[0].data_ptr(),
                     out[1].data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"philox_draws kernel launch failed: CUDA error {err}")
    philox_draws.launches += 1
    philox_draws.launches_by_ch[ch] += 1
    return out


philox_draws.launches = 0
philox_draws.launches_by_ch = Counter()


def step_draws(key: int, step: int, n: int, device, row0: int = 0):
    """One play step's draws (port of rng_pallas.step_draws, K3):
    (u (n, 13), z (n, 4)) of rows row0..row0+n-1."""
    u, z = philox_draws(key, step, 1, n, device, row0=row0)
    return u[0], z[0]


def chunk_draws(key: int, step_base: int, ch: int, n: int, device, out=None,
                row0: int = 0):
    """A whole play chunk's draws (port of rng_pallas.chunk_draws, K4):
    (u (ch, n, 13), z (ch, n, 4)) of rows row0..row0+n-1."""
    return philox_draws(key, step_base, ch, n, device, out=out, row0=row0)

"""fast_monte_carlo_tpu_torch — the PyTorch/CUDA port of fast_monte_carlo_tpu.

The JAX package `fast_monte_carlo_tpu` is the reference this package is held
against; nothing here imports it (or JAX or scikit-learn), and pandas is
imported only inside the functions that return a DataFrame, when called:
each wraps a pandas-free core that returns the same columns.  Module names
mirror the JAX package's, so each function's counterpart is found at the
same path.  Hand-written Hopper kernels live in `csrc/` and are built
from source at first use (`utils/cuda_build.py`).

Every function that allocates takes a `device`; the entry points
(`api.MatchupRunner`, the probes' command lines) default to the card.
Asking for CUDA where it is absent raises, and nothing falls back to the
CPU.  The CPU path exists for the tests, where each kernel wrapper runs its
plain PyTorch version.
"""
from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; raises if it names CUDA and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; this package never falls back to the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


__all__ = ["resolve_device", "__version__"]

"""Build the kernel sources in `csrc/` with nvcc and load them through ctypes.

Each `.cu` file exposes a plain `extern "C"` launcher, so it compiles in
seconds without PyTorch's headers and needs neither ninja nor
`torch.utils.cpp_extension`.  The shared library lands in
`<checkout>/.torch_ext_build/`, named by `build_digest`: a hash of the
source, every shared header `csrc/*.cuh` and the flags, so an edited source
or header rebuilds and an unchanged one loads the cached build.  Nothing is
built at import time: the first call of a kernel wrapper builds, and
`load_kernel_libraries` builds several sources with one nvcc each, all
started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / ".torch_ext_build"
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC")
# per-source flags on top of NVCC_FLAGS.  fused_step and nano_game must
# round every f32 multiply and add on its own, as the eager torch step they
# are held to does (one elementwise kernel per operation), so nvcc may not
# contract them into FMAs.
EXTRA_FLAGS = {"fused_step": ("--fmad=false",), "nano_game": ("--fmad=false",)}

_LOADED: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); "
                           "the CUDA kernels are built from source")
    return found


def nvcc_flags(name: str) -> Tuple[str, ...]:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def build_digest(name: str, csrc: Path = CSRC) -> str:
    """Hash naming the build of `csrc/<name>.cu`: its bytes, every shared
    header `csrc/*.cuh` (name and bytes, in name order) and the flags."""
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(nvcc_flags(name)).encode())
    return h.hexdigest()[:16]


def load_kernel_libraries(*names: str, csrc: Path = CSRC) -> List[ctypes.CDLL]:
    """ctypes handles of `csrc/<name>.cu` for each name, compiled for sm_90a
    on first use; sources not built yet compile concurrently.  The first
    library loaded under a name serves every later call in the process, the
    kernel wrappers' included: loading another copy of the sources first
    (`probes.kernels --csrc DIR`) makes the wrappers run that copy."""
    # a loaded library is returned without hashing its sources again
    outs = {name: BUILD_DIR / f"lib{name}_{build_digest(name, csrc)}.so"
            for name in names if name not in _LOADED}
    builds = []
    for name, out in outs.items():
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # compile to a private name, then rename: concurrent first uses
        # never load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(
            [_nvcc(), *nvcc_flags(name), "-o", tmp, str(csrc / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        builds.append((name, proc, tmp))
    errors = []
    for name, proc, tmp in builds:
        try:
            _, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {csrc / name}.cu:\n{err}")
            else:
                os.replace(tmp, outs[name])
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    if errors:
        raise RuntimeError("\n".join(errors))
    for name in names:
        if name not in _LOADED:
            _LOADED[name] = ctypes.CDLL(str(outs[name]))
    return [_LOADED[name] for name in names]


def load_kernel_library(name: str) -> ctypes.CDLL:
    """ctypes handle of `csrc/<name>.cu`, compiled for sm_90a on first use."""
    return load_kernel_libraries(name)[0]


def ptxas_usage(name: str, csrc: Path = CSRC,
                sass_out: Optional[Path] = None) -> Dict[str, Dict[str, int]]:
    """Registers and spill bytes of each kernel of `csrc/<name>.cu`, as
    `nvcc -cubin -Xptxas -v` reports them under the library's flags (less
    the shared-library ones): {mangled kernel: {"registers", "spill_stores",
    "spill_loads"}}.  With `sass_out`, `cuobjdump -sass` of that cubin is
    written there too."""
    flags = [f for f in nvcc_flags(name) if f not in ("-shared", "-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        cubin = Path(tmp) / f"{name}.cubin"
        proc = subprocess.run([_nvcc(), *flags, "-cubin", "-Xptxas", "-v", "-o", str(cubin),
                               str(csrc / f"{name}.cu")], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc -cubin failed for {csrc / name}.cu:\n{proc.stderr}")
        if sass_out is not None:
            dump = subprocess.run([str(Path(_nvcc()).with_name("cuobjdump")), "-sass",
                                   str(cubin)], capture_output=True, text=True, check=True)
            Path(sass_out).write_text(dump.stdout)
    out, kernel = {}, None
    for line in proc.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = m.group(1)
            out[kernel] = {"registers": 0, "spill_stores": 0, "spill_loads": 0}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and kernel:
            out[kernel].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            out[kernel]["registers"] = int(m.group(1))
    return out

"""The kernel build of the PyTorch port (utils/cuda_build.py), on the CPU.

No nvcc runs here: the digest that names a build is checked on its own.
An edited source, shared header or flag must give a new digest, or an old
shared library would be loaded for new code."""
import shutil

import pytest
import torch

from fast_monte_carlo_tpu_torch.probes import kernels
from fast_monte_carlo_tpu_torch.utils import cuda_build

torch.set_num_threads(1)

SOURCES = ("philox_draws", "fused_step", "row_gather")


@pytest.fixture
def csrc(tmp_path):
    d = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, d)
    return d


def test_every_kernel_source_and_header_is_in_the_package():
    names = {p.name for p in cuda_build.CSRC.iterdir()}
    assert {f"{s}.cu" for s in SOURCES} | {"philox.cuh"} <= names


@pytest.mark.parametrize("name", SOURCES)
def test_digest_follows_source_headers_and_flags(csrc, name, monkeypatch):
    d0 = cuda_build.build_digest(name, csrc)
    assert d0 == cuda_build.build_digest(name, cuda_build.CSRC)
    assert d0 == cuda_build.build_digest(name, csrc)             # stable
    header = csrc / "philox.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    d1 = cuda_build.build_digest(name, csrc)
    assert d1 != d0                                               # header edit
    (csrc / "extra.cuh").write_text("#pragma once\n")
    d2 = cuda_build.build_digest(name, csrc)
    assert d2 not in (d0, d1)                                     # new header
    src = csrc / f"{name}.cu"
    src.write_bytes(src.read_bytes() + b"\n")
    d3 = cuda_build.build_digest(name, csrc)
    assert d3 not in (d0, d1, d2)                                 # source edit
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS", cuda_build.NVCC_FLAGS + ("-lineinfo",))
    assert cuda_build.build_digest(name, csrc) not in (d0, d1, d2, d3)


def test_fused_step_is_built_without_fma_contraction():
    assert "--fmad=false" in cuda_build.nvcc_flags("fused_step")
    assert "--fmad=false" not in cuda_build.nvcc_flags("philox_draws")


def test_libraries_build_from_the_given_sources(csrc, tmp_path, monkeypatch):
    """`load_kernel_libraries(csrc=DIR)` compiles DIR's sources into
    libraries named by DIR's digests, and a loaded name serves later calls:
    that is how `probes.kernels --csrc DIR` times another copy of csrc/."""
    src = csrc / "philox_draws.cu"
    src.write_bytes(src.read_bytes() + b"\n// another version\n")
    ran = []

    class FakeNvcc:
        def __init__(self, cmd, **kw):
            ran.append(cmd)
            self.returncode, self.out = 0, cmd[cmd.index("-o") + 1]

        def communicate(self):
            open(self.out, "wb").close()
            return "", ""

    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_LOADED", {})
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(cuda_build.subprocess, "Popen", FakeNvcc)
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda path: path)
    libs = cuda_build.load_kernel_libraries("philox_draws", "row_gather", csrc=csrc)
    assert [cmd[-1] for cmd in ran] == [str(src), str(csrc / "row_gather.cu")]
    digest = cuda_build.build_digest("philox_draws", csrc)
    assert digest != cuda_build.build_digest("philox_draws")
    assert libs[0].endswith(f"libphilox_draws_{digest}.so")
    assert cuda_build.load_kernel_library("philox_draws") == libs[0] and len(ran) == 2


def test_kernel_probe_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    assert kernels.main([]) == 1

"""Build, load and launch the hand-written CUDA kernels.

Each kernel is a CUDA C++ source under ``gypsum_tpu_torch/csrc/`` with a
plain C entry point. At first use it is compiled with ``nvcc`` for Hopper
(``sm_90a``) into a shared library under ``build/kernels/`` at the root of
the checkout and loaded with ``ctypes``: no PyTorch headers are compiled, so
a build takes seconds. The library name carries a hash of the source, the
shared headers (``csrc/*.cuh``) and the flags, so an edited source is never
served a stale build. Nothing here runs
when a module is imported: the CPU tests import every module and this
machine may have no ``nvcc``.

Each entry point returns ``cudaGetLastError()``; the launch raises when it
is not 0. Every ``CudaKernel`` counts its launches, so a run can show that
the main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"

# No fast math: __sinf/__expf would break parity with the plain versions.
# -fmad=false keeps a*b+c as two roundings, as the plain versions compute it.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)


# The current stream's handle straight from the binding, where this build of
# PyTorch has it: torch.cuda.current_stream() builds a Stream object per call,
# which costs as much as the launch itself.
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def current_stream_handle() -> int:
    """The handle of PyTorch's current CUDA stream on the current device."""
    if _raw_stream is not None:
        return _raw_stream(torch.cuda.current_device())
    return torch.cuda.current_stream().cuda_stream


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def library_path(source: str) -> Path:
    """Where the build of ``csrc/<source>.cu`` lives."""
    # The shared headers count too: an edited header must not be served a
    # stale build of a source that includes it.
    text = b"".join(
        path.read_bytes()
        for path in [CSRC_DIR / f"{source}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]
    )
    tag = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source}_{tag}.so"


def build(source: str) -> float:
    """Compile ``csrc/<source>.cu`` unless its build exists; returns the
    seconds spent (0.0 when the build was already there)."""
    lib = library_path(source)
    if lib.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{source}.cu")],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {source}.cu:\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent builder sees all or nothing
    return time.perf_counter() - t0


def build_all(sources: list[str]) -> dict[str, float]:
    """Build several sources at once, one nvcc each; {source: seconds}."""
    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        return dict(zip(sources, pool.map(build, sources)))


class CudaKernel:
    """One C entry point of one CUDA source, built and loaded at first
    launch, with a count of its launches."""

    def __init__(self, source: str, symbol: str, argtypes: list) -> None:
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def _load(self):
        build(self.source)
        lib = ctypes.CDLL(str(library_path(self.source)))
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._fn = fn
        return fn

    def launch(self, *args) -> None:
        """Launch on PyTorch's current stream (appended as the last
        argument); raises if the launch was refused.

        Pointers, ints and the stream are passed as plain Python ints
        (``tensor.data_ptr()``): the function is bound once and its
        ``argtypes`` convert them, so a call builds no ctypes object."""
        fn = self._fn or self._load()
        err = fn(*args, current_stream_handle())
        if err != 0:
            raise RuntimeError(
                f"CUDA kernel {self.symbol} ({self.source}.cu) failed to launch: "
                f"cudaError {err}"
            )
        self.launches += 1


def check_cuda_tensor(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and ``shape``."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")

"""Build and launch the benchmark's own CUDA kernel (``csrc/synth.cu``).

The kernel is compiled with ``nvcc`` at its first use in a checkout, into
``build/portbench/`` at the checkout's root (a fixed path: a second run
finds the build), under a name that carries a hash of the source and the
flags, and is loaded with ``ctypes``. Nothing here runs when the module is
imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "synth.cu"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "portbench"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
         "-shared", "-Xcompiler", "-fPIC")


class _SatArrays(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "chip_rate", "chip0", "freq", "cycles0", "amp", "code_row", "codes", "symbols", "stagger")]


class _Shape(ctypes.Structure):
    _fields_ = [
        *((name, ctypes.c_int) for name in (
            "n_caps", "n_sats", "length", "chips", "periods", "n_sym", "capture_ms",
            "block_ms", "ring")),
        ("fs", ctypes.c_double), ("sigma", ctypes.c_float),
        ("s1", ctypes.c_uint), ("s2", ctypes.c_uint),
    ]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def library_path() -> Path:
    tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libsynth_{tag}.so"


_LIB = None


def _library():
    global _LIB
    if _LIB is None:
        lib = library_path()
        if not lib.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run([_nvcc(), *FLAGS, "-o", str(tmp), str(SOURCE)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed for {SOURCE.name}:\n{proc.stderr}")
            os.replace(tmp, lib)
        fn = ctypes.CDLL(str(lib)).synth_pool
        fn.argtypes = [_SatArrays, _Shape, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIB = fn
    return _LIB


def synthesize_pool(caps, device: torch.device) -> torch.Tensor:
    """The pool [R, B, C, L, 2] int8 of ``caps`` (generator.Captures) on
    ``device``, made by one launch."""
    fn = _library()
    n_caps, n_sats = caps.signals.shape

    def up(a, dtype):
        return torch.from_numpy(np.array(a, dtype=dtype)).to(device)

    keep = {
        "chip_rate": up(caps.chip_rate, np.float64), "chip0": up(caps.chip0, np.float64),
        "freq": up(caps.freq_hz, np.float64), "cycles0": up(caps.cycles0, np.float64),
        "amp": up(caps.amplitude, np.float32), "code_row": up(caps.code_rows, np.int32),
        "codes": up(caps.code_table, np.int8), "symbols": up(caps.symbols, np.int8),
        "stagger": up(caps.stagger, np.int32),
    }
    arrays = _SatArrays(**{k: v.data_ptr() for k, v in keep.items()})
    shape = _Shape(
        n_caps=n_caps, n_sats=n_sats, length=caps.samples_per_ms, chips=caps.chips,
        periods=caps.symbol_periods, n_sym=caps.symbols.shape[2], capture_ms=caps.capture_ms,
        block_ms=caps.block_ms, ring=caps.ring, fs=caps.sample_rate, sigma=caps.noise_lsb,
        s1=caps.seed_words[0], s2=caps.seed_words[1],
    )
    pool = torch.empty((caps.ring, caps.block_ms, n_caps, caps.samples_per_ms, 2),
                       dtype=torch.int8, device=device)
    err = fn(arrays, shape, pool.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"synth_pool failed to launch: cudaError {err}")
    torch.cuda.synchronize(device)
    del keep
    return pool

"""ctypes bindings for the native C++ IQ reader (the host's read path).

Port of gypsum_tpu/io/native.py. ``native/iqreader.cpp`` is compiled with
``g++`` at first use into ``build/native/libiqreader_<hash>.so`` at the root
of the checkout, where the hash covers the source, the compiler and its
flags (so an edited source is never served a stale build), and loaded with
``ctypes``. The hash also covers the host's name: ``-march=native`` builds
for this host's CPU, so a build directory shared with another machine never
serves it a library that machine cannot run. Nothing is written into the
package. A build that fails raises with the compiler's output: there is no
numpy fallback (the plain numpy conversion, ``io/sources.py:convert_numpy``,
is the reference the tests hold this reader to, not a second path). The
library loads once per process through ``core/aot.py``, which the CLI uses
to start its build on a background thread before it reads the capture.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import subprocess
import time
from pathlib import Path

import numpy as np

from gypsum_tpu_torch.core import aot

_logger = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parent.parent / "native" / "iqreader.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-pthread")

_DTYPE_CODES = {
    np.float32: 0,
    np.int16: 1,
    np.int8: 2,
    np.uint8: 3,
}

_FLOAT_P = ctypes.POINTER(ctypes.c_float)


def library_path() -> Path:
    """Where the build of ``native/iqreader.cpp`` lives."""
    key = SOURCE.read_bytes() + " ".join((CXX, *CXX_FLAGS, platform.node())).encode()
    return BUILD_DIR / f"libiqreader_{hashlib.sha256(key).hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the reader unless its build exists; returns the library."""
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [CXX, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    _logger.info("building the native IQ reader: %s", " ".join(cmd))
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as exc:
        raise RuntimeError(f"native IQ reader: cannot run {CXX!r}: {exc}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"native IQ reader: {' '.join(cmd)} failed (rc {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent builder sees all or nothing
    return lib


def timed_build() -> tuple[Path, float]:
    """``build()`` and its seconds (0.0 when the build was already there)."""
    if library_path().exists():
        return library_path(), 0.0
    t0 = time.perf_counter()
    lib = build()
    return lib, time.perf_counter() - t0


def open_library() -> tuple[ctypes.CDLL, float]:
    """Build the reader unless built, load it and bind its functions: (the
    library, the build's seconds). Called through ``core/aot.py:library``,
    which runs it once per process."""
    path, seconds = timed_build()
    lib = ctypes.CDLL(str(path))
    lib.iq_open.restype = ctypes.c_void_p
    lib.iq_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_float]
    lib.iq_n_samples.restype = ctypes.c_longlong
    lib.iq_n_samples.argtypes = [ctypes.c_void_p]
    lib.iq_read.restype = ctypes.c_longlong
    lib.iq_read.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, _FLOAT_P]
    lib.iq_close.restype = None
    lib.iq_close.argtypes = [ctypes.c_void_p]
    lib.iq_prefetch_start.restype = ctypes.c_int
    lib.iq_prefetch_start.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong]
    lib.iq_prefetch_take.restype = ctypes.c_longlong
    lib.iq_prefetch_take.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, _FLOAT_P,
    ]
    return lib, seconds


class NativeIqReader:
    """One open capture file; ``read(start, count)`` -> complex64[count].

    A handle has one outstanding prefetch and is used from one thread (the
    receiver reads its source, read-ahead included, from its own loop).
    ``prefetched_reads`` counts the reads served by the prefetch."""

    def __init__(self, info) -> None:
        lib = aot.library(aot.NATIVE_READER)  # joins a preload in flight
        code = _DTYPE_CODES[np.dtype(info.component_dtype).type]
        self._lib = lib
        self._handle = lib.iq_open(str(info.path).encode(), code, float(info.component_offset))
        if not self._handle:
            raise OSError(f"native reader could not open {info.path}")
        self.n_samples = int(lib.iq_n_samples(self._handle))
        self.prefetched_reads = 0

    def read(self, start: int, count: int) -> np.ndarray:
        if not self._handle:
            raise ValueError("read from a closed NativeIqReader")
        out = np.empty(count, dtype=np.complex64)
        ptr = out.ctypes.data_as(_FLOAT_P)
        # Served from the C++ prefetch when the caller asks for exactly the
        # block it queued; -1 means no or another prefetch (it is dropped).
        got = self._lib.iq_prefetch_take(self._handle, int(start), int(count), ptr)
        if got < 0:
            got = self._lib.iq_read(self._handle, int(start), int(count), ptr)
        else:
            self.prefetched_reads += 1
        if got != count:
            raise EOFError(f"requested {count} samples at {start}, got {got}")
        return out

    def prefetch(self, start: int, count: int) -> None:
        """Queue [start, start+count) for conversion on the C++ worker thread
        (overlaps file IO + dtype conversion with device compute)."""
        if self._handle and start + count <= self.n_samples:
            self._lib.iq_prefetch_start(self._handle, int(start), int(count))

    def close(self) -> None:
        """Join the worker thread, then unmap and close the file."""
        handle, self._handle = getattr(self, "_handle", None), None
        if handle:
            self._lib.iq_close(handle)

    def __del__(self):
        self.close()

"""Kernel preload: the port's counterpart of gypsum_tpu/core/aot.py.

The JAX package ships serialized TPU executables and loads them on a
background thread while the receiver acquires (``preload_aot`` of its
engine and tracker). The port cannot ship binaries: its CUDA kernels
(``csrc/*.cu``, ``ops/kernels.py``) and its native reader
(``native/iqreader.cpp``, ``io/native.py``) are built from the checkout's
sources into ``build/``. So its counterpart of "load the shipped executable
in the background" is: *start building and loading the libraries a path
will use on background threads, as soon as the path knows which they are*,
so that ``nvcc`` runs while the process imports torch, makes its CUDA
context, reads the capture and acquires, instead of after them, at the
kernel's first launch.

Where a preload starts: the places that decide which kernel runs
(``track/loop.py:make_track_block_fn`` for the tracker's K1, K3 or K4, the
acquisition engines for K2, ``io/sources.py:DecimatingSampleSource`` for
K5) and, earlier, the CLI (``cli/main.py``), which picks the libraries from
its command and flags before it imports torch or reads the capture.

Every library loads once per process, whoever asks first: ``library``
joins a load in flight (a preload, or another thread's first use) and
adopts its result. A preload thread is host only (a compiler process,
``dlopen``; no torch, no CUDA call). Nothing falls back: a build or a
``dlopen`` that fails in a preload is raised by the first use, with the
compiler's output, as a build at first use raises. ``GYPSUM_AOT=0`` turns
preloads off (every library then builds at its first use), as it turns off
the JAX package's shipped executables.

The JAX package's persistent compile cache (gypsum_tpu/core/compile_cache.py)
needs no module here: its counterpart is the hash-keyed build cache of
``ops/kernels.py`` and ``io/native.py`` (a library is rebuilt only when its
source, headers, compiler or flags change).

This module imports neither torch nor numpy, so the CLI can start a preload
before it imports torch.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import Counter

_logger = logging.getLogger(__name__)

#: The native raw-capture reader's name among the libraries (the others are
#: the CUDA sources under ``csrc/``, by file stem).
NATIVE_READER = "iqreader"

#: The two-phase tracker's libraries (``track/matmul.py``), which every
#: receiver loads: the samples' operand, then K1 (left out with the scan
#: fixup backend).
TRACKER_LIBRARIES = ("iq_operand", "fixup")

#: How many times paths asked for each library since the counts were last
#: cleared, and how many times each was fetched through ``library``. A run
#: can hold what it preloaded against what it used (``chip_smoke.py``).
requests: Counter = Counter()
uses: Counter = Counter()

_LOCK = threading.Lock()
_JOBS: dict = {}  # library path -> _Load


def enabled() -> bool:
    """False when ``GYPSUM_AOT=0`` turns preloads off."""
    return os.environ.get("GYPSUM_AOT", "1") != "0"


class _Load:
    """One library's build and ``dlopen``, in flight or done."""

    def __init__(self, name: str, preloaded: bool) -> None:
        self.name = name
        self.preloaded = preloaded  # started by a preload (else by its first use)
        self.done = threading.Event()
        self.library = None
        self.error: Exception | None = None
        self.build_s = 0.0  # compiler seconds, 0.0 when the build was cached
        self.seconds = 0.0  # build and dlopen
        self.used = False

    def run(self, opener) -> None:
        t0 = time.perf_counter()
        try:
            self.library, self.build_s = opener()
        except Exception as exc:  # carried to the first use, which raises it
            self.error = exc
        finally:
            self.seconds = time.perf_counter() - t0
            self.done.set()


def _target(name: str):
    """(the library's path, which names its build, and its opener)."""
    if name == NATIVE_READER:
        from gypsum_tpu_torch.io import native

        return native.library_path(), native.open_library
    from gypsum_tpu_torch.ops import kernels

    return kernels.library_path(name), lambda: kernels.open_library(name)


def preload(names, device) -> None:
    """Start building and loading each library of ``names`` (CUDA sources
    by stem, or ``NATIVE_READER``) on a thread of its own, unless it is
    loaded or loading. Only for a CUDA ``device`` and unless
    ``GYPSUM_AOT=0``; counts each request in ``requests``.

    The threads are not daemons: a process that ends before a preload
    finishes waits for its compiler instead of leaving it behind."""
    if str(getattr(device, "type", device)).split(":")[0] != "cuda" or not enabled():
        return
    started = []
    for name in names:
        requests[name] += 1
        path, opener = _target(name)
        with _LOCK:
            if path in _JOBS:
                continue
            job = _JOBS[path] = _Load(name, preloaded=True)
        threading.Thread(target=job.run, args=(opener,), name=f"preload-{name}").start()
        started.append(name)
    if started:
        _logger.info("preload: started %s", ", ".join(started))


def library(name: str):
    """The loaded library ``name``: joins its load in flight, or builds and
    loads it on this thread when nothing has started it. Raises what the
    load raised (the load is then forgotten, so a later use tries again)."""
    path, opener = _target(name)
    with _LOCK:
        job = _JOBS.get(path)
        here = job is None
        if here:
            job = _JOBS[path] = _Load(name, preloaded=False)
    if here:
        job.run(opener)
    t0 = time.perf_counter()
    job.done.wait()
    waited = time.perf_counter() - t0
    if job.error is not None:
        with _LOCK:
            if _JOBS.get(path) is job:
                del _JOBS[path]
        raise job.error
    uses[name] += 1
    if not job.used:
        job.used = True
        _logger.info(
            "library %s: %s, %s in %.3f s; first use waited %.3f s", name,
            "preloaded" if job.preloaded else "loaded at first use",
            "built" if job.build_s else "cached", job.seconds, waited,
        )
    return job.library

"""The port's cold chain on the CPU: kernel preload (core/aot.py, the
counterpart of gypsum_tpu/core/aot.py), the prebuild entry
(``python -m gypsum_tpu_torch.ops.kernels``) and the process-wide track
program (track/loop.py:_TRACK_FN_CACHE, the twin of
tests/test_program_cache.py).

No card and no nvcc here: builds and ``dlopen`` are faked where a test
needs them to succeed, and ``kernels._nvcc`` raises where a test needs to
show that nothing compiles.
"""

import tests._torch_cpu  # noqa: F401  # isort: skip (first: caps torch's threads)

import dataclasses
import os
import sys
import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch

from gypsum_tpu.core.config import TrackingConfig as JaxTrackingConfig
from gypsum_tpu.track.loop import make_track_block_fn as jax_make_track_block_fn
from gypsum_tpu_torch.acquire.deep import DeepAcquisitionEngine
from gypsum_tpu_torch.acquire.engine import AcquisitionEngine, shared_acquisition_engine
from gypsum_tpu_torch.cli.main import build_parser, libraries
from gypsum_tpu_torch.cli.main import main as cli_main
from gypsum_tpu_torch.core import aot
from gypsum_tpu_torch.core.config import (
    AcquisitionConfig,
    DeepAcquisitionConfig,
    TrackingConfig,
)
from gypsum_tpu_torch.io import native
from gypsum_tpu_torch.io.sources import (
    ArraySampleSource,
    DecimatingSampleSource,
    FileSampleSource,
    RecordingInfo,
)
from gypsum_tpu_torch.ops import kernels
from gypsum_tpu_torch.track.loop import TrackerBank, make_track_block_fn

FS = 2.046e6
L = 2046
JOIN_S = 10.0  # every thread a test starts ends well within this


@pytest.fixture
def fresh(monkeypatch):
    """An empty load registry and request counts, preloads on."""
    monkeypatch.setattr(aot, "_JOBS", {})
    monkeypatch.setattr(aot, "requests", Counter())
    monkeypatch.setattr(aot, "uses", Counter())
    monkeypatch.delenv("GYPSUM_AOT", raising=False)


def preload_threads():
    return [t for t in threading.enumerate() if t.name.startswith("preload-")]


def join_preloads():
    for t in preload_threads():
        t.join(JOIN_S)
        assert not t.is_alive()


class FakeLib:
    """Stands in for a ``ctypes.CDLL``: each symbol a fresh function object."""

    def __init__(self, path):
        self.path = path

    def __getitem__(self, symbol):
        return type("FakeFn", (), {"symbol": symbol})()


@pytest.fixture
def fake_build(monkeypatch, fresh):
    """``kernels.build`` sleeps 0.2 s and records (source, thread);
    ``ctypes.CDLL`` is ``FakeLib``. Set ``state["error"]`` to make the build
    raise it."""
    state = {"calls": [], "error": None}

    def build(source):
        state["calls"].append((source, threading.current_thread().name))
        time.sleep(0.2)
        if state["error"] is not None:
            raise state["error"]
        return 0.2

    monkeypatch.setattr(kernels, "build", build)
    monkeypatch.setattr(kernels.ctypes, "CDLL", FakeLib)
    yield state
    join_preloads()


def fixup_kernel():
    return kernels.CudaKernel("fixup", "fixup_f32", [])


# ---------------------------------------------------------------- (a) CPU


def test_cpu_paths_start_no_preload(tmp_path, monkeypatch, fresh):
    """Every preload site on device='cpu', the CLI with --device cpu (a
    decimated capture, so K5's site too) and a torch CPU device: no thread,
    no load, no nvcc."""
    nvcc_calls = []

    def no_nvcc():
        nvcc_calls.append(threading.current_thread().name)
        raise RuntimeError("nvcc must not run on a CPU path")

    monkeypatch.setattr(kernels, "_nvcc", no_nvcc)
    capture = tmp_path / "fast.npy"
    rng = np.random.default_rng(1)
    iq = (rng.standard_normal(4092 * 30) + 1j * rng.standard_normal(4092 * 30)).astype(np.complex64)
    np.save(capture, iq)
    assert cli_main(["--device", "cpu", "replay", "--file", str(capture), "--sample-rate",
                     "4.092e6", "--block-ms", "10"]) == 0
    for tracking in (TrackingConfig(), TrackingConfig(use_pallas_block_tracker=True),
                     TrackingConfig(use_matmul_tracker=False, use_pallas_block_tracker=False,
                                    use_pallas_correlator=True)):
        make_track_block_fn(tracking, L, FS, 4, device="cpu")
    AcquisitionEngine(FS, L, AcquisitionConfig(use_pallas_peak_reduce=True), device="cpu")
    DeepAcquisitionEngine(FS, L, DeepAcquisitionConfig(total_ms=20), device="cpu")
    aot.preload(["fixup", aot.NATIVE_READER], torch.device("cpu"))
    assert preload_threads() == [] and aot._JOBS == {} and aot.requests == Counter()
    assert nvcc_calls == []


# ------------------------------------------- (b) the preload and the launch


def test_launch_joins_preloads_and_builds_once(fake_build):
    """Two preloads from two threads and the first launch's load of the same
    kernel: one build, on the first preload's thread; the load waits for it
    and binds its symbol; no launch is counted."""
    kernel = fixup_kernel()
    first = threading.Thread(target=aot.preload, args=(["fixup"], "cuda"))
    first.start()
    first.join(JOIN_S)
    second = threading.Thread(target=aot.preload, args=(["fixup"], "cuda:0"))
    second.start()
    t0 = time.perf_counter()
    fn = kernel._load()
    waited = time.perf_counter() - t0
    second.join(JOIN_S)
    assert not first.is_alive() and not second.is_alive()
    assert fake_build["calls"] == [("fixup", "preload-fixup")]
    assert waited > 0.05  # it joined the build in flight rather than building
    assert fn.symbol == "fixup_f32" and kernel._fn is fn and kernel.launches == 0
    (job,) = aot._JOBS.values()
    assert job.preloaded and job.build_s == 0.2 and job.used
    assert aot.requests == Counter(fixup=2) and aot.uses == Counter(fixup=1)


@pytest.mark.parametrize("where", ["nvcc", "dlopen"])
def test_failed_preload_raises_at_first_launch(fake_build, monkeypatch, where):
    """No fallback: what a preload raised, the first launch raises, with the
    compiler's (or the loader's) message; a later launch tries again."""
    if where == "nvcc":
        fake_build["error"] = RuntimeError("nvcc failed for fixup.cu:\nptxas fatal: bad register")
        match = r"(?s)nvcc failed for fixup\.cu.*bad register"
    else:
        def refuse(path):
            raise OSError(f"{path}: cannot open shared object file")

        monkeypatch.setattr(kernels.ctypes, "CDLL", refuse)
        match = "cannot open shared object file"
    aot.preload(["fixup"], "cuda")
    kernel = fixup_kernel()
    with pytest.raises((RuntimeError, OSError), match=match):
        kernel._load()
    assert kernel._fn is None and kernel.launches == 0 and aot._JOBS == {}
    with pytest.raises((RuntimeError, OSError), match=match):
        kernel._load()
    assert [c[1] for c in fake_build["calls"]] == ["preload-fixup", "MainThread"]


def test_many_threads_load_one_library_once(fake_build):
    """More threads than cores, preloading and loading one library at once,
    with a short switch interval: one build, one library for all."""
    got, errors = [], []

    def worker(i):
        try:
            if i % 2:
                aot.preload(["fixup"], "cuda")
            got.append(aot.library("fixup"))
        except Exception as exc:  # noqa: BLE001 - reported by the assertion below
            errors.append(exc)

    old_interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(4 * (os.cpu_count() or 2))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(JOIN_S)
    finally:
        sys.setswitchinterval(old_interval)
    assert not any(t.is_alive() for t in threads) and errors == []
    assert len(fake_build["calls"]) == 1 and len(got) == len(threads)
    assert all(lib is got[0] for lib in got)


def test_gypsum_aot_0_starts_no_thread(fake_build, monkeypatch):
    """GYPSUM_AOT=0: no preload; the kernel builds at its first launch, on the
    launching thread."""
    monkeypatch.setenv("GYPSUM_AOT", "0")
    aot.preload(["fixup", "peak_reduce", aot.NATIVE_READER], "cuda")
    assert preload_threads() == [] and aot._JOBS == {} and fake_build["calls"] == []
    fixup_kernel()._load()
    assert fake_build["calls"] == [("fixup", "MainThread")]
    (job,) = aot._JOBS.values()
    assert not job.preloaded


def test_file_source_adopts_the_native_reader_preload(tmp_path, monkeypatch, fresh):
    """The native reader's row: a preload (as the CLI starts it for a raw
    capture) is joined by FileSampleSource, which builds nothing itself."""
    built = []

    def timed_build():
        built.append(threading.current_thread().name)
        time.sleep(0.2)
        return native.build(), 0.0

    monkeypatch.setattr(native, "timed_build", timed_build)
    path = tmp_path / "cap.f32"
    iq = (np.arange(3 * L) % 7 + 1j).astype(np.complex64)
    path.write_bytes(np.stack([iq.real, iq.imag], axis=1).astype(np.float32).tobytes())
    aot.preload([aot.NATIVE_READER], "cuda")
    source = FileSampleSource(RecordingInfo(path=path, sample_rate=FS))
    _, block = source.read_block(2)
    join_preloads()
    assert np.array_equal(block.ravel(), iq[: 2 * L])
    assert built == [f"preload-{aot.NATIVE_READER}"]
    (job,) = aot._JOBS.values()
    assert job.preloaded and aot.uses[aot.NATIVE_READER] == 1


def test_prebuild_entry_builds_every_source(monkeypatch, capsys):
    """``python -m gypsum_tpu_torch.ops.kernels``: every csrc/*.cu and the
    native reader, at once, each with its seconds."""
    threads = set()

    def build(source):
        threads.add(threading.current_thread().name)
        time.sleep(0.1)
        return 1.5

    monkeypatch.setattr(kernels, "build", build)
    monkeypatch.setattr(native, "timed_build", lambda: (native.library_path(), 0.0))
    assert kernels.main() == 0
    out = capsys.readouterr().out
    sources = sorted(p.name for p in kernels.CSRC_DIR.glob("*.cu"))
    assert {"fixup.cu", "peak_reduce.cu", "track_block.cu", "wipeoff_lag.cu",
            "fir_decimate.cu", "iq_operand.cu"} <= set(sources)
    for name in sources:
        assert f"csrc/{name}: built in 1.50 s" in out
    assert "native/iqreader.cpp: already built" in out
    assert len(threads) == len(sources)  # one compiler at a time would reuse a thread


# ----------------------------------------------- (c) which kernels a path preloads


def _track(**kw):
    return lambda: make_track_block_fn(TrackingConfig(**kw), L, FS, 4, device="cpu")


SITES = {
    "K1 two-phase tracker": (_track(), list(aot.TRACKER_LIBRARIES)),
    "K1 scan fixup backend": (_track(fixup_backend="scan"), ["iq_operand"]),
    "K3 whole-block tracker": (_track(use_pallas_block_tracker=True), ["track_block"]),
    "K4 scan tracker": (_track(use_matmul_tracker=False, use_pallas_block_tracker=False,
                               use_pallas_correlator=True), ["wipeoff_lag"]),
    "K2 engine": (lambda: AcquisitionEngine(FS, L, AcquisitionConfig(use_pallas_peak_reduce=True),
                                            device="cpu"), ["peak_reduce"]),
    "K2 deep engine": (lambda: DeepAcquisitionEngine(FS, L, DeepAcquisitionConfig(total_ms=20),
                                                     device="cpu"), ["peak_reduce"]),
    "K5 decimating source": (lambda: DecimatingSampleSource(
        ArraySampleSource(np.zeros(4092 * 4, np.complex64), 4.092e6), FS, device="cpu"),
        ["fir_decimate"]),
}


def test_tracker_libraries_name_the_kernels_the_tracker_launches():
    """The one list of the two-phase tracker's libraries, which the tracker
    and the CLI preload, holds the sources of the kernels it launches."""
    from gypsum_tpu_torch.ops.fixup import FIXUP_KERNEL
    from gypsum_tpu_torch.ops.iq_operand import IQ_OPERAND_KERNEL

    assert aot.TRACKER_LIBRARIES == (IQ_OPERAND_KERNEL.source, FIXUP_KERNEL.source)


@pytest.mark.parametrize("site", list(SITES))
def test_site_preloads_the_kernels_it_launches(site, monkeypatch):
    make, want = SITES[site]
    asked = []
    monkeypatch.setattr(aot, "preload", lambda names, device: asked.append((list(names), str(device))))
    obj = make()
    make()  # a shared track program or engine, fetched again, asks again
    assert asked == [(want, "cpu")] * 2
    assert list(obj.libraries) == want
    assert all((kernels.CSRC_DIR / f"{name}.cu").exists() for name in want)


@pytest.fixture
def captures(tmp_path):
    """Capture names the CLI reads sidecars of (the files need not exist)."""
    (tmp_path / "fast.npy.json").write_text('{"sample_rate": 4092000.0}')
    (tmp_path / "raw.i8.json").write_text('{"sample_rate": 8184000.0, "dtype": "int8"}')
    (tmp_path / "raw.f32.json").write_text('{"sample_rate": 2046000.0}')
    return tmp_path


# The two-phase tracker's kernels, which every receiver loads.
TRACKER = list(aot.TRACKER_LIBRARIES)

CLI = {
    "replay npy": ("replay --file {d}/c.npy", TRACKER),
    "replay npy at 4.092 Msps by sidecar": ("replay --file {d}/fast.npy", [*TRACKER, "fir_decimate"]),
    "replay npy at a rational rate": ("replay --file {d}/c.npy --sample-rate 10e6", TRACKER),
    "replay raw int8 by sidecar": ("replay --file {d}/raw.i8",
                                   [*TRACKER, aot.NATIVE_READER, "fir_decimate"]),
    "replay raw float32 by sidecar": ("replay --file {d}/raw.f32", [*TRACKER, aot.NATIVE_READER]),
    "replay hackrf format": ("replay --file {d}/h.bin --format hackrf",
                             [*TRACKER, aot.NATIVE_READER, "fir_decimate"]),
    "replay glonass at 8.184 Msps": ("replay --glonass-file {d}/g.npy --glonass-rate 8184000",
                                     [*TRACKER, "fir_decimate"]),
    "acquire": ("acquire --file {d}/c.npy", []),
    "acquire --deep": ("acquire --file {d}/c.npy --deep", ["peak_reduce"]),
    "rtk captures": ("rtk --base-file {d}/b.npy --rover-file {d}/r.npy --base-lla 1 2 3",
                     TRACKER),
    "rtk rinex": ("rtk --base-rinex b --rover-rinex r --nav n --base-lla 1 2 3", []),
    "synth": ("synth --out {d}/s.npy", []),
}


@pytest.mark.parametrize("case", list(CLI))
def test_cli_selects_the_libraries_of_its_command(case, captures):
    argv, want = CLI[case]
    assert libraries(build_parser().parse_args(argv.format(d=captures).split())) == want


def test_cli_starts_its_preload_before_the_command(tmp_path, monkeypatch, fresh):
    """main() preloads before the command runs (here the default device
    raises in the command: this box has no card)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the replay would run")
    asked = []
    monkeypatch.setattr(aot, "preload", lambda names, device: asked.append((names, device)))
    capture = tmp_path / "c.npy"
    np.save(capture, np.zeros(L * 20, np.complex64))
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        cli_main(["replay", "--file", str(capture)])
    assert asked[0] == (TRACKER, "cuda")


# ------------------------- (d) the shared track program, against the JAX package


ZEROS = np.zeros(8, np.int32)
ALTERNATE = np.arange(8, dtype=np.int32) % 2
SPLITS = {
    "same parameters": ({}, {}, True),
    "channels": ({}, {"n": 16}, False),
    "block_size_ms": ({}, {"block_size_ms": 200}, False),
    "input_offset": ({}, {"input_offset": 127.5}, False),
    "farm against single stream": ({}, {"farm": ZEROS}, False),
    "two farm assignments": ({"farm": ZEROS}, {"farm": ALTERNATE}, False),
    "same farm assignment": ({"farm": ZEROS}, {"farm": ZEROS.copy()}, True),
}


def _fetch(make, config_cls, kw, **extra):
    cfg = config_cls()
    if "block_size_ms" in kw:
        cfg = dataclasses.replace(cfg, block_size_ms=kw["block_size_ms"])
    return make(cfg, L, FS, kw.get("n", 8), stream_of_channel=kw.get("farm"),
                input_offset=kw.get("input_offset", 0.0), **extra)


@pytest.mark.parametrize("case", list(SPLITS))
def test_track_program_shared_where_the_jax_package_shares_it(case):
    a, b, want = SPLITS[case]
    jax_shared = _fetch(jax_make_track_block_fn, JaxTrackingConfig, a) is _fetch(
        jax_make_track_block_fn, JaxTrackingConfig, b)
    port_shared = _fetch(make_track_block_fn, TrackingConfig, a, device="cpu") is _fetch(
        make_track_block_fn, TrackingConfig, b, device="cpu")
    assert jax_shared == port_shared == want


def test_tracker_banks_share_program_but_not_state():
    b1 = TrackerBank(FS, L, TrackingConfig(), n_channels=8, device="cpu")
    b2 = TrackerBank(FS, L, TrackingConfig(), n_channels=8, device="cpu")
    assert b1._fn is b2._fn
    b1.assign(prn=7, doppler_hz=1000.0, code_phase_samples=10.0, carrier_phase_rad=0.5)
    assert b2.slot_prn == [None] * 8
    assert float(b2.state.doppler[0]) == 0.0
    assert b1._pending is not b2._pending


def test_acquisition_engine_shared_and_keyed_on_config():
    e1 = shared_acquisition_engine(FS, L, AcquisitionConfig(), device="cpu")
    assert shared_acquisition_engine(FS, L, AcquisitionConfig(), device="cpu") is e1
    assert shared_acquisition_engine(FS, L, AcquisitionConfig(integration_period_ms=20),
                                     device="cpu") is not e1
    # Engines are stateless across detect() calls, so sharing is safe; guard
    # against per-call mutable state added without notice (nn.Module's own
    # registries aside).
    module_own = set(vars(torch.nn.Module()))
    mutable = [k for k, v in vars(e1).items()
               if isinstance(v, (list, dict, set)) and k not in module_own]
    assert mutable == [], f"AcquisitionEngine grew mutable state {mutable}; sharing is no longer safe"

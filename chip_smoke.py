"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port (``gypsum_tpu_torch``) on the card, with no JAX:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: both hand-written kernels from ``gypsum_tpu_torch/csrc`` with
   ``nvcc`` (one process each, in parallel);
3. K1 (loop-filter fixup) against its plain PyTorch version on the
   correlations of a real phase-1 pass over a synthesized 1000 ms block at
   the main path's shape (12 channels, NLE 35), triangle and HRC;
4. K2 (acquisition peak reduce) against its plain version on the real
   [928, 2046] coarse acquisition grid, odd sizes and planted ties;
5. end to end: the 4-satellite, 23 s cold-start scene replayed to a fix
   through ``python -m gypsum_tpu_torch replay --until-fix`` and through
   ``Receiver(device="cuda")`` twice (default config, and with the
   acquisition's peak reduce on K2), with each kernel's launch count read
   around the run, then with async upload and without the pipeline (host
   ms per block waiting in ``collect_block``);
6. one more replay under torch.profiler: the device's busy share and the
   kernels that take it;
7. a ``{"kernels": [...]}`` line with each kernel's launches, error and
   times beside its bound;
8. last line: ``{"ok": true, "device": {...}}``.

Any failure raises, so the exit code is not 0 and no result line is printed.
It exits with an error at once when no CUDA device is present.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
FS, L = 2.046e6, 2046
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
SCENE_PRNS = [25, 28, 31, 32]
TRUTH_LLA = (51.5, -0.1, 80.0)
GPS_T0 = 21600.0


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, n_iter: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` (CUDA events around ``n_iter`` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_iter):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n_iter


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """Least time (ms) the card could take: the larger of bytes over the
    memory rate and float32 operations over the float32 peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- phase 3: K1


def check_fixup(dev) -> dict:
    from gypsum_tpu_torch.core.config import TrackingConfig
    from gypsum_tpu_torch.ops import fixup as fx
    from gypsum_tpu_torch.signal.synth import SyntheticSatellite, synthesize_iq
    from gypsum_tpu_torch.track.loop import TrackerBank

    b_ms, n_ch = 1000, 12
    rng = np.random.default_rng(7)
    sats = [
        SyntheticSatellite(prn=p, doppler_hz=float(d), delay_samples=int(c), amplitude=0.25)
        for p, d, c in zip(
            [1, 4, 7, 11, 14, 19, 22, 30],
            rng.uniform(-4000, 4000, 8),
            rng.integers(0, L, 8),
        )
    ]
    iq = synthesize_iq(sats, b_ms * L, FS, noise_sigma=0.35, seed=11).reshape(b_ms, L)
    samples = torch.from_numpy(iq).to(dev)
    worst = 0.0
    times = {}
    for meas in ("triangle", "hrc"):
        bank = TrackerBank(FS, L, TrackingConfig(code_phase_measurement=meas),
                           n_channels=n_ch, device=dev)
        # 8 channels pulling in 3 Hz and half a sample off the truth, 4 on
        # PRNs that are not on the air.
        for s in sats:
            bank.assign(s.prn, s.doppler_hz + 3.0, s.delay_samples + 0.5, 0.0)
        for prn in (2, 3, 5, 6):
            bank.assign(prn, 500.0, 1000.0, 0.0)
        prn_idx = np.array([bank._prn_row[p] for p in bank.slot_prn])
        replicas = bank._device_replicas(prn_idx)
        _, init, corr_r, corr_i = bank._fn.phase1(bank.state, samples, replicas)
        params = bank._fn.fixup_params
        if corr_r.shape != (b_ms, n_ch, 35):
            raise AssertionError(f"unexpected phase-1 shape {tuple(corr_r.shape)}")
        fin_k, outs_k = fx.fixup_cuda(init, corr_r, corr_i, params)
        fin_p, outs_p = fx.fixup_reference(init, corr_r, corr_i, params)
        torch.cuda.synchronize()
        for row in (fx.O_LOCKED, fx.O_LOST):
            if not torch.equal(outs_k[:, row], outs_p[:, row]):
                raise AssertionError(f"K1 {meas}: output row {row} (locked/lost) differs")
        if not torch.equal(fin_k[fx.STEP], fin_p[fx.STEP]) or not torch.equal(fin_k[fx.LOST], fin_p[fx.LOST]):
            raise AssertionError(f"K1 {meas}: step count or lost flag differs")
        # Tolerance: 1e-4 of each row's scale (the JAX package's own bar for
        # its fixup kernel against its scan, tests/test_matmul_tracker.py);
        # the two sides use the same float32 operation order, and only the
        # card's cosf/sinf/expf against PyTorch's may differ in the last bit.
        for name, a, b in (("outs", outs_k, outs_p), ("fin", fin_k, fin_p)):
            diff = (a - b).abs()
            scale = b.abs().amax(dim=(0, 2) if name == "outs" else 1).clamp(min=1.0)
            rows_err = diff.amax(dim=(0, 2) if name == "outs" else 1)
            if bool((rows_err > 1e-4 * scale).any()):
                raise AssertionError(f"K1 {meas} {name}: per-row max error {rows_err.tolist()}")
            worst = max(worst, float(diff.max()))
        locked = int(outs_k[-1, fx.O_LOCKED].sum())
        times[meas] = (
            cuda_ms(lambda: fx.fixup_cuda(init, corr_r, corr_i, params), 20),
            cuda_ms(lambda: fx.fixup_reference(init, corr_r, corr_i, params), 1, warmup=1),
        )
        log(f"K1 {meas}: kernel == plain (locked/lost/step exact, max |err| {worst:.3g}); "
            f"{locked}/{n_ch} channels locked at block end; "
            f"kernel {times[meas][0]:.4f} ms, plain {times[meas][1]:.2f} ms")
    b_count, s_count, nle = corr_r.shape
    n_lags = 2 * params.k_half + 1
    # Bytes the function needs: per ms and channel only the 2K+1 lags around
    # the prompt of corr_r and corr_i (not all NLE), the outputs, and the
    # carry in and out.
    n_bytes = 4 * (2 * b_count * s_count * n_lags + b_count * fx.N_OUT * s_count
                   + 2 * fx.N_CARRY * s_count)
    # Per ms and channel: 2K+1 powers (3 ops), the argmax compares, ~110
    # operations of discriminators, EMAs and NCO updates.
    n_ops = b_count * s_count * (4 * n_lags + 110)
    bound_ms, bound_by = bound(n_bytes, n_ops)
    log(f"K1 bound at [{b_count}, {s_count}, {nle}], {n_lags} lags read per ms and channel: "
        f"{bound_ms:.6f} ms ({bound_by}, {n_bytes} bytes)")
    return {
        "name": "K1 fixup",
        "route": "cuda",
        "source": "gypsum_tpu_torch/csrc/fixup.cu",
        "replaces": "gypsum_tpu/ops/pallas_fixup.py:58",
        "max_abs_err": worst,
        "ms": times["triangle"][0],
        "plain_ms": times["triangle"][1],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }


# ---------------------------------------------------------------- phase 4: K2


def check_peak_reduce(dev) -> dict:
    from gypsum_tpu_torch.acquire.engine import AcquisitionEngine
    from gypsum_tpu_torch.ops.correlate import noncoherent_acquisition_sweep
    from gypsum_tpu_torch.ops.peak_reduce import peak_reduce_cuda, peak_reduce_reference
    from gypsum_tpu_torch.signal.synth import SyntheticSatellite, synthesize_iq

    sats = [SyntheticSatellite(prn=p, doppler_hz=d, delay_samples=c, amplitude=0.3)
            for p, d, c in [(3, 1250.0, 100), (11, -2100.0, 900), (25, -3400.0, 2000)]]
    iq = synthesize_iq(sats, 10 * L, FS, noise_sigma=0.35, seed=5).reshape(10, L)
    eng = AcquisitionEngine(FS, L, device=dev)
    x = torch.from_numpy(iq).to(dev)
    grid = noncoherent_acquisition_sweep(x, eng.coarse_dopplers, eng.prn_fft_conj, FS)
    main = grid.reshape(-1, L).contiguous()
    if main.shape != (928, 2046):
        raise AssertionError(f"unexpected grid shape {tuple(main.shape)}")
    g = torch.Generator(device=dev).manual_seed(3)
    cases = [main]
    for rows, n in ((1, 1), (7, 3001), (33, 129), (5, 2047)):
        t = torch.rand((rows, n), device=dev, generator=g)
        t[:, n // 3] = 2.0  # planted ties: the lowest index must win
        t[:, n - 1] = 2.0
        cases.append(t)
    tie = torch.zeros((3, 1000), device=dev)  # every element ties
    cases.append(tie)
    worst = 0.0
    for t in cases:
        mk, ak, sk = peak_reduce_cuda(t)
        mp, ap, sp = peak_reduce_reference(t)
        torch.cuda.synchronize()
        if not (torch.equal(mk, mp) and torch.equal(ak, ap)):
            raise AssertionError(f"K2 max/argmax differ at shape {tuple(t.shape)}")
        # Sum: rtol 1e-5 (float32 sums of up to 3001 terms in another order).
        if not torch.allclose(sk, sp, rtol=1e-5, atol=0.0):
            raise AssertionError(f"K2 sum differs at shape {tuple(t.shape)}")
        worst = max(worst, float((sk - sp).abs().max()))
    ms = cuda_ms(lambda: peak_reduce_cuda(main), 200)
    plain_ms = cuda_ms(lambda: peak_reduce_reference(main), 200)
    library_ms = cuda_ms(lambda: (torch.max(main, dim=1), main.sum(dim=1)), 200)
    rows, n = main.shape
    bound_ms, bound_by = bound(4 * rows * n + 12 * rows, 2 * rows * n)
    log(f"K2 peak reduce: kernel == plain on {len(cases)} cases (argmax/max exact, "
        f"sum max |err| {worst:.3g}); [928, 2046]: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, torch.max+sum {library_ms:.4f} ms, bound {bound_ms:.4f} ms")
    return {
        "name": "K2 peak_reduce",
        "route": "cuda",
        "source": "gypsum_tpu_torch/csrc/peak_reduce.cu",
        "replaces": "gypsum_tpu/ops/pallas_kernels.py:194",
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }


# ---------------------------------------------------------- phase 5: e2e


def synthesize_scene():
    from gypsum_tpu_torch.signal.constellation import synthesize_constellation
    from gypsum_tpu_torch.signal.scenarios import demo_constellation
    from gypsum_tpu_torch.solve.geodesy import lla_to_ecef

    rx = lla_to_ecef(*TRUTH_LLA)
    iq, _ = synthesize_constellation(
        demo_constellation(SCENE_PRNS), rx, gps_start_time_sow=GPS_T0, duration_s=23.0,
        sample_rate=FS, noise_sigma=0.35, subframe_pattern="123", seed=0,
    )
    return rx, iq


def run_cli(capture: Path, rx: np.ndarray) -> float:
    from gypsum_tpu_torch.solve.geodesy import lla_to_ecef

    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "gypsum_tpu_torch", "replay", "--file", str(capture), "--until-fix"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"CLI replay failed (rc {proc.returncode}):\n{proc.stderr[-3000:]}")
    fixes = re.findall(r"FIX lat=(-?[\d.]+) lon=(-?[\d.]+) alt=(-?\d+)m", proc.stdout)
    if not fixes:
        raise AssertionError(f"CLI replay printed no FIX line:\n{proc.stdout[-3000:]}")
    lat, lon, alt = (float(v) for v in fixes[-1])
    err = float(np.linalg.norm(lla_to_ecef(lat, lon, alt) - rx))
    if err >= 100.0:
        raise AssertionError(f"CLI fix {err:.1f} m from truth")
    log(f"e2e CLI: replay --until-fix printed FIX lat={lat} lon={lon} alt={alt:.0f}m, "
        f"{err:.2f} m from truth, {wall:.1f} s wall (process start included)")
    return err


def run_receiver(iq: np.ndarray, rx: np.ndarray, dev, peak_kernel: bool = False,
                 async_upload: bool = False, pipelined: bool | None = None):
    """One in-process replay. ``recv.collect`` then summarizes the host ms
    per block spent in ``TrackerBank.collect_block`` (waiting for the
    block's outputs, then building its observations)."""
    import dataclasses

    from gypsum_tpu_torch.core.config import AcquisitionConfig, ReceiverConfig
    from gypsum_tpu_torch.io.sources import ArraySampleSource
    from gypsum_tpu_torch.runtime.receiver import Receiver

    cfg = ReceiverConfig()
    if peak_kernel:
        cfg = cfg.replace(acquisition=AcquisitionConfig(use_pallas_peak_reduce=True))
    cfg = cfg.replace(tracking=dataclasses.replace(
        cfg.tracking, async_upload=async_upload, pipeline_tracking=pipelined))
    recv = Receiver(ArraySampleSource(iq, FS), cfg, device=dev)
    collect, collect_s = recv.bank.collect_block, []

    def timed_collect():
        t = time.perf_counter()
        out = collect()
        collect_s.append(time.perf_counter() - t)
        return out

    recv.bank.collect_block = timed_collect
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    recv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ms = 1e3 * np.asarray(collect_s)
    recv.collect = (f"collect_block mean {ms.mean():.3f}, median {np.median(ms):.3f}, "
                    f"max {ms.max():.3f} ms per block")
    fixes = recv.world.position_fixes
    if not fixes:
        raise AssertionError("Receiver(device='cuda') made no fix on the 23 s scene")
    errs = [float(np.linalg.norm(f.ecef - rx)) for f in fixes]
    if min(errs) >= 100.0:
        raise AssertionError(f"best fix {min(errs):.1f} m from truth")
    acq = [(h.prn, h.code_phase_samples, h.doppler_hz, h.carrier_phase_rad, h.strength)
           for r in recv.block_reports for h in r.newly_acquired]
    if {a[0] for a in acq} < set(SCENE_PRNS):
        raise AssertionError(f"acquired {sorted(a[0] for a in acq)}, scene has {SCENE_PRNS}")
    return recv, acq, errs, wall


def block_timings(recv, iq: np.ndarray) -> tuple[float, float]:
    """Device ms of one 1000 ms tracking block (phase 1 + K1 + glue) at the
    receiver's channel binding, and of one 10 ms acquisition sweep."""
    bank = recv.bank
    block = torch.from_numpy(np.ascontiguousarray(iq[: 1000 * L].reshape(1000, L))).to(bank.device)
    prn_idx = np.array([bank._prn_row[p] if p is not None else 0 for p in bank.slot_prn])
    replicas = bank._device_replicas(prn_idx)
    bank.sync_host_state()
    state = bank.state
    track_ms = cuda_ms(lambda: bank._fn.packed(state, block, replicas), 5)
    x10 = torch.from_numpy(np.ascontiguousarray(iq[: 10 * L].reshape(10, L))).to(bank.device)
    acq_ms = cuda_ms(lambda: recv.acquisition(x10), 5)
    return track_ms, acq_ms


def profile_run(iq: np.ndarray, dev) -> None:
    """One more replay of the scene under torch.profiler: the device's busy
    share of the wall time and the kernels that take it (the profiler's own
    overhead lengthens the wall time, so the share is a lower bound)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gypsum_tpu_torch.core.config import ReceiverConfig
    from gypsum_tpu_torch.io.sources import ArraySampleSource
    from gypsum_tpu_torch.runtime.receiver import Receiver

    recv = Receiver(ArraySampleSource(iq, FS), ReceiverConfig(), device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        recv.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Device-side entries only (kernels and copies): the host operators that
    # launched them carry the same time again.
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    if not events:
        log("profile: the profiler recorded no device time (not measured)")
        return
    busy_ms = sum(e.device_time_total for e in events) / 1e3
    log(f"profile: replay of {recv.source.seconds_consumed:.0f} s of signal, wall "
        f"{wall * 1e3:.1f} ms under the profiler, device busy {busy_ms:.2f} ms "
        f"({100 * busy_ms / (wall * 1e3):.1f} %)")
    for e in sorted(events, key=lambda e: -e.device_time_total)[:10]:
        log(f"profile:   {e.device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"device: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    from gypsum_tpu_torch.core.device import resolve_device
    from gypsum_tpu_torch.ops import kernels
    from gypsum_tpu_torch.ops.fixup import FIXUP_KERNEL
    from gypsum_tpu_torch.ops.peak_reduce import PEAK_REDUCE_KERNEL

    resolve_device(dev)
    t0 = time.perf_counter()
    built = kernels.build_all(["fixup", "peak_reduce"])
    log(f"build: {', '.join(f'{k} {v:.2f} s' for k, v in built.items())} "
        f"({time.perf_counter() - t0:.2f} s wall, nvcc sm_90a, in parallel)")

    k1 = check_fixup(dev)
    k2 = check_peak_reduce(dev)

    t0 = time.perf_counter()
    rx, iq = synthesize_scene()
    log(f"e2e scene: PRNs {SCENE_PRNS}, 23 s at {FS:.0f} sps, noise 0.35, "
        f"synthesized in {time.perf_counter() - t0:.1f} s (host)")
    with tempfile.TemporaryDirectory() as tmp:
        capture = Path(tmp) / "scene.npy"
        np.save(capture, iq)
        run_cli(capture, rx)

    # The main path: counts set to 0 just before each run, read just after.
    FIXUP_KERNEL.launches = PEAK_REDUCE_KERNEL.launches = 0
    recv, acq_a, errs_a, wall_a = run_receiver(iq, rx, dev, peak_kernel=False)
    k1["launches"] = FIXUP_KERNEL.launches
    if FIXUP_KERNEL.launches == 0:
        raise AssertionError("the main path never launched K1")
    log(f"e2e Receiver(device='cuda'), default config: {len(errs_a)} fixes, best "
        f"{min(errs_a):.2f} m, last {errs_a[-1]:.2f} m; {wall_a:.2f} s wall for "
        f"{recv.source.seconds_consumed:.0f} s of signal; launches K1 {FIXUP_KERNEL.launches}, "
        f"K2 {PEAK_REDUCE_KERNEL.launches}; {recv.collect} (depth-1 pipeline)")

    FIXUP_KERNEL.launches = PEAK_REDUCE_KERNEL.launches = 0
    recv_b, acq_b, errs_b, wall_b = run_receiver(iq, rx, dev, peak_kernel=True)
    k2["launches"] = PEAK_REDUCE_KERNEL.launches
    if PEAK_REDUCE_KERNEL.launches == 0 or FIXUP_KERNEL.launches == 0:
        raise AssertionError("the peak-reduce run did not launch both K1 and K2")
    if [a[:4] for a in acq_a] != [b[:4] for b in acq_b] or not np.allclose(
        [a[4] for a in acq_a], [b[4] for b in acq_b], rtol=1e-5
    ):
        raise AssertionError(f"acquisitions differ:\n{acq_a}\n{acq_b}")
    log(f"e2e Receiver(device='cuda'), use_pallas_peak_reduce=True: identical acquisitions; "
        f"{len(errs_b)} fixes, best {min(errs_b):.2f} m; {wall_b:.2f} s wall; "
        f"launches K1 {FIXUP_KERNEL.launches}, K2 {PEAK_REDUCE_KERNEL.launches}; {recv_b.collect}")

    # The one-block read-ahead with its copy on a side stream from pinned
    # memory (async_upload) must not change what the receiver computes.
    recv_c, acq_c, errs_c, wall_c = run_receiver(iq, rx, dev, async_upload=True)
    if acq_c != acq_a or not np.allclose(errs_c, errs_a, rtol=0, atol=1e-6):
        raise AssertionError(f"async_upload changed the replay: {errs_c} vs {errs_a}")
    log(f"e2e Receiver(device='cuda'), async_upload=True: same acquisitions and fixes; "
        f"{wall_c:.2f} s wall; {recv_c.collect}")

    # Without the pipeline each collect waits for its block's whole device
    # work: the contrast shows what the depth-1 pipeline hides.
    recv_d, _, errs_d, wall_d = run_receiver(iq, rx, dev, pipelined=False)
    log(f"e2e Receiver(device='cuda'), pipeline_tracking=False: {len(errs_d)} fixes, best "
        f"{min(errs_d):.2f} m; {wall_d:.2f} s wall; {recv_d.collect}")

    track_ms, acq_ms = block_timings(recv, iq)
    log(f"timing: one 1000 ms tracking block (phase 1 bf16 matmul with float32 "
        f"output + K1) {track_ms:.3f} ms; one 10 ms acquisition sweep {acq_ms:.3f} ms")

    profile_run(iq, dev)

    log(json.dumps({"kernels": [k1, k2]}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

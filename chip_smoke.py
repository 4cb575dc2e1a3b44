"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port (``gypsum_tpu_torch``) on the card, with no JAX:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: the five hand-written kernels from ``gypsum_tpu_torch/csrc`` with
   ``nvcc`` (one process each, in parallel), and a kernel that does nothing
   (``csrc/empty.cu``, the yardstick of a launch);
3. each kernel against its plain PyTorch version, timed beside its bound:
   K1 (loop-filter fixup) on the correlations of a real phase-1 pass over a
   synthesized 1000 ms block (12 channels, NLE 35), triangle and HRC;
   K2 (acquisition peak reduce) on the real [928, 2046] coarse grid, odd
   sizes, rows shorter than one 16-byte load, a row count the blocks do not
   divide, views 4 and 12 bytes into their storage, planted ties and rows
   of -inf; K5 (FIR decimator) on one 1000 ms block at 8.184 Msps (factor
   4, 49 taps) and 16.368 Msps (factor 8, 97 taps), odd lengths and N == T,
   beside ``F.conv1d``; K4 (per-ms wipeoff + lag correlate) on chunks of
   that block with the bank's (theta, f, base), on 1 to 64 channels, three
   lengths, 1 to 33 lags and 1 to 8 blocks per channel, each run twice and
   the two runs held equal to the bit; K3 (whole-block tracker) on that
   block.

   Every kernel, its plain version and its library call are timed two ways
   (``two_way``), in turns within this one run. The **issue time** is what
   a caller in a Python loop pays per call: CUDA events around a loop of
   calls (``issue_ms``); for a kernel shorter than its launch path that is
   host time. The **device time** is what the call costs the card alone,
   free of the host: the same calls captured into one CUDA graph and the
   graph replayed between two events (``device_ms``). In the ``kernels``
   line ``ms``, ``plain_ms`` and ``library_ms`` are device times;
   ``issue_ms``, ``plain_issue_ms`` and ``library_issue_ms`` are issue
   times. Where the two agree the device bounds the call; where the issue
   time is the larger the host does;
4. end to end at 2.046 Msps: the 4-satellite, 23 s cold-start scene replayed
   to a fix through ``python -m gypsum_tpu_torch replay --until-fix`` and
   through ``Receiver(device="cuda")`` (default config; K2 peak reduce;
   async upload; no pipeline), each kernel's launch count read around its
   run; then the same scene with the whole-block tracker (K3) and with the
   per-ms scan tracker through K4, held to the default run's acquisitions
   and pseudosymbol signs;
5. end to end through the decimating front end: the scene synthesized at
   8.184 Msps, through the CLI and through
   ``Receiver(DecimatingSampleSource(...))`` to a fix, K5's launches counted;
6. one more replay under torch.profiler: the device's busy share and the
   kernels that take it;
7. a ``{"kernels": [...]}`` line with each kernel's launches, error and
   both times beside its bound;
8. last line: ``{"ok": true, "device": {...}}``.

Any failure raises, so the exit code is not 0 and no result line is printed.
It exits with an error at once when no CUDA device is present.

``python3 chip_smoke.py --kernels-only`` stops after step 3, and
``--kernels-only=K2,K4`` checks and times only the kernels it names: a
short run for work on a kernel (no replay, so no launch counts and no result
line). The checks call the wrappers with their oldest signatures (K4's
optional ``n_split`` is probed), so a copy of this script and of
``csrc/empty.cu`` in a checkout of an earlier commit times that commit's
kernels the same way, for a comparison of two commits within one run on one
card.
"""

from __future__ import annotations

import ctypes
import inspect
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
FS_FAST = 8.184e6  # the gnu_radio_8x capture rate: decimated by 4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
SCENE_PRNS = [25, 28, 31, 32]
TRUTH_LLA = (51.5, -0.1, 80.0)
GPS_T0 = 21600.0


def log(msg: str) -> None:
    print(msg, flush=True)


def issue_ms(fn, n_iter: int, warmup: int = 2) -> float:
    """What a caller in a Python loop pays per call of ``fn``: CUDA events
    around ``n_iter`` calls. It is the device's time only while the device
    is slower than the host can issue; for a short kernel it is the cost of
    the launch path on the host."""
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


def device_ms(fn, n_iter: int, warmup: int = 2, n_replays: int = 3) -> float:
    """What a call of ``fn`` costs the card alone, free of the host:
    ``n_iter`` calls captured into one ``torch.cuda.CUDAGraph`` (a wrapper's
    launch reads PyTorch's current stream at each call, so the capture sees
    it; its ``torch.empty`` comes from the graph's own pool) and the graph
    replayed between two events, the mean of ``n_replays`` replays over the
    count. The card runs the captured kernels back to back, so the time holds
    each kernel's duration and the card's own hand-over from one kernel to
    the next, and nothing of Python, the allocator or the launch call.

    Not ``torch.profiler``: on the H100 host this was written on (torch
    2.11.0+cu128) its sessions lost records (once all of 200 launches, once
    1 of 200, and after one session of 128 000 launches 2 to 16 of 20 in
    every later one), so a sum of recorded durations is not safe. Where it
    lost nothing it read 0.1 to 0.4 us per kernel under the graph's time."""
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):  # capture needs every lazy set-up done
        for _ in range(max(warmup, 1)):
            fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n_iter):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(n_replays):
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / n_replays / n_iter


def two_way(fns: dict) -> dict:
    """Time every ``name: (fn, n_iter, warmup)`` both ways, in turns on this
    card: once in the given order and once in reverse (plain, kernel, kernel,
    plain). Returns ``name: (device ms, issue ms)``, each the mean of its two
    turns; both turns are logged."""
    turns = {name: [] for name in fns}
    for order in (list(fns), list(reversed(fns))):
        for name in order:
            fn, n_iter, warmup = fns[name]
            issue = issue_ms(fn, n_iter, warmup)
            turns[name].append((device_ms(fn, n_iter, warmup), issue))
    out = {}
    for name, t in turns.items():
        out[name] = (sum(d for d, _ in t) / len(t), sum(i for _, i in t) / len(t))
        log(f"  two-way {name}: device {' / '.join(f'{d:.5f}' for d, _ in t)} ms, "
            f"issue {' / '.join(f'{i:.5f}' for _, i in t)} ms")
    return out


def timing_keys(t: dict) -> dict:
    """The timing keys of a ``kernels`` entry from a ``two_way`` result with
    the names kernel, plain and (optionally) library: ``ms``, ``plain_ms``
    and ``library_ms`` are device times, the ``*issue_ms`` keys issue times."""
    lib = t.get("library", (None, None))
    return {
        "ms": t["kernel"][0], "issue_ms": t["kernel"][1],
        "plain_ms": t["plain"][0], "plain_issue_ms": t["plain"][1],
        "library_ms": lib[0], "library_issue_ms": lib[1],
    }


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """Least time (ms) the card could take: the larger of bytes over the
    memory rate and float32 operations over the float32 peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- phase 3: K1


B_MS, N_CH = 1000, 12


def synthetic_block(dev):
    """The kernel checks' 1000 ms block: 8 satellites at seeded Dopplers and
    delays, noise sigma 0.35. Returns (satellites, [B, L] complex on dev)."""
    from gypsum_tpu_torch.signal.synth import SyntheticSatellite, synthesize_iq

    rng = np.random.default_rng(7)
    sats = [
        SyntheticSatellite(prn=p, doppler_hz=float(d), delay_samples=int(c), amplitude=0.25)
        for p, d, c in zip(
            [1, 4, 7, 11, 14, 19, 22, 30],
            rng.uniform(-4000, 4000, 8),
            rng.integers(0, L, 8),
        )
    ]
    iq = synthesize_iq(sats, B_MS * L, FS, noise_sigma=0.35, seed=11).reshape(B_MS, L)
    return sats, torch.from_numpy(iq).to(dev)


def checks_bank(sats, dev, config, off_air: bool = True):
    """A 12-channel bank on the synthetic block: 8 channels pulling in 3 Hz
    and half a sample off the truth, and 4 more either on PRNs that are not
    on the air or (``off_air=False``) on the first four satellites again from
    another pull-in offset. A channel on noise alone is chaotic: two
    versions that differ in the last bit drift apart on it, so the checks
    that compare different sum orders keep every channel on a signal.
    Returns (bank, replica rows on the device)."""
    from gypsum_tpu_torch.track.loop import TrackerBank

    bank = TrackerBank(FS, L, config, n_channels=N_CH, device=dev)
    for s in sats:
        bank.assign(s.prn, s.doppler_hz + 3.0, s.delay_samples + 0.5, 0.0)
    if off_air:
        for prn in (2, 3, 5, 6):
            bank.assign(prn, 500.0, 1000.0, 0.0)
    else:
        for s in sats[:4]:
            bank.assign(s.prn, s.doppler_hz - 5.0, s.delay_samples - 0.3, 1.0)
    prn_idx = np.array([bank._prn_row[p] for p in bank.slot_prn])
    return bank, bank._device_replicas(prn_idx)


def check_fixup(dev, sats, samples) -> dict:
    from gypsum_tpu_torch.core.config import TrackingConfig
    from gypsum_tpu_torch.ops import fixup as fx

    b_ms, n_ch = B_MS, N_CH
    worst = 0.0
    for meas in ("triangle", "hrc"):
        bank, replicas = checks_bank(sats, dev, TrackingConfig(code_phase_measurement=meas))
        _, init, corr_r, corr_i = bank._fn.phase1(bank.state, samples, replicas)
        params = bank._fn.fixup_params
        if corr_r.shape != (b_ms, n_ch, 35):
            raise AssertionError(f"unexpected phase-1 shape {tuple(corr_r.shape)}")
        fin_k, outs_k = fx.fixup_cuda(init, corr_r, corr_i, params)
        fin_p, outs_p = fx.fixup_reference(init, corr_r, corr_i, params)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(outs_k).all() and torch.isfinite(outs_p).all()):
            raise AssertionError(f"K1 {meas}: non-finite outputs")
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
        log(f"K1 {meas}: kernel == plain (locked/lost/step exact, max |err| {worst:.3g}); "
            f"{locked}/{n_ch} channels locked at block end")
        if meas == "triangle":
            # The plain version (1000 Python steps, some 128 000 launches)
            # has just run: one call, no warm-up of its own.
            times = two_way({
                "kernel": (lambda: fx.fixup_cuda(init, corr_r, corr_i, params), 20, 2),
                "plain": (lambda: fx.fixup_reference(init, corr_r, corr_i, params), 1, 0),
            })
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
        **timing_keys(times),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
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

    def planted(rows, n, offset=0):
        """Random rows with two planted maxima each (the lowest index must
        win), as a contiguous view ``offset`` floats into its storage."""
        t = torch.rand(rows * n + offset, device=dev, generator=g)[offset:].view(rows, n)
        t[:, n // 3] = 2.0
        t[:, n - 1] = 2.0
        return t

    # The main grid; odd sizes; a row count that is not a multiple of the
    # rows per block; rows shorter than one 16-byte load; views 4 and 12 bytes
    # into their storage, so that no row starts where the base suggests.
    cases = [main]
    cases += [planted(rows, n) for rows, n in (
        (1, 1), (7, 3001), (33, 129), (5, 2047), (929, 2046), (9, 1), (9, 2), (9, 3), (9, 2047))]
    cases += [planted(928, 2046, offset=1), planted(9, 2047, offset=1), planted(5, 3, offset=3)]
    if cases[-3].data_ptr() % 16 != 4 or not cases[-3].is_contiguous():
        raise AssertionError("the offset view is not 4 bytes off a 16-byte boundary")
    cases.append(torch.zeros((3, 1000), device=dev))  # every element ties
    inf_rows = planted(6, 2046)
    inf_rows[1] = float("-inf")  # a row of -inf: index 0
    inf_rows[4, 5:] = float("-inf")
    cases.append(inf_rows)
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
        worst = max(worst, float((sk - sp)[torch.isfinite(sp)].abs().max()))
    rows, n = main.shape
    bound_ms, bound_by = bound(4 * rows * n + 12 * rows, 2 * rows * n)
    log(f"K2 peak reduce: kernel == plain on {len(cases)} cases (argmax/max exact, "
        f"sum max |err| {worst:.3g}); [928, 2046], bound {bound_ms:.5f} ms ({bound_by}); the "
        f"7.6 MB input stays warm in the 50 MB L2 between calls, as the real caller finds it "
        f"(the sweep has just written it)")
    # The library yardstick: torch.max(dim=1) gives max and argmax in one
    # call, sum the third result; its device time holds both kernels. The
    # kernel that does nothing runs on K2's grid.
    times = two_way({
        "plain": (lambda: peak_reduce_reference(main), 200, 2),
        "kernel": (lambda: peak_reduce_cuda(main), 200, 2),
        "library": (lambda: (torch.max(main, dim=1), main.sum(dim=1)), 200, 2),
        "empty": (lambda: EMPTY_KERNEL.launch(116, 256), 200, 2),
    })
    return {
        "name": "K2 peak_reduce",
        "route": "cuda",
        "source": "gypsum_tpu_torch/csrc/peak_reduce.cu",
        "replaces": "gypsum_tpu/ops/pallas_kernels.py:194",
        "max_abs_err": worst,
        **timing_keys(times),
        "empty_ms": times["empty"][0],
        "empty_issue_ms": times["empty"][1],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
    }


# ---------------------------------------------------------------- K5, K4, K3


def check_fir_decimate(dev) -> dict:
    import torch.nn.functional as F

    from gypsum_tpu_torch.ops.decimate import decimation_filter
    from gypsum_tpu_torch.ops.fir_decimate import fir_decimate_cuda, fir_decimate_reference

    g = torch.Generator(device=dev).manual_seed(5)
    worst = 0.0
    timed = {}
    # One 1000 ms block as the streaming source hands it over (history +
    # block + tail), at the gnu_radio_8x and gnu_radio_16x rates; then odd
    # lengths, a factor that does not divide the filter span, and N == T.
    cases = [(8_184_000 + 48 + 50, 4), (16_368_000 + 96 + 98, 8),
             (12_345, 4), (4_099, 8), (1_001, 5), (1_000, 2), (49, 4), (97, 8)]
    for n, factor in cases:
        taps = torch.from_numpy(decimation_filter(factor)).to(dev)
        x = torch.randn((n, 2), device=dev, generator=g)
        y_k = fir_decimate_cuda(x, taps, factor)
        y_p = fir_decimate_reference(x, taps, factor)
        torch.cuda.synchronize()
        if y_k.shape != y_p.shape or y_k.shape[0] != (n - len(taps)) // factor + 1:
            raise AssertionError(f"K5 shape {tuple(y_k.shape)} vs plain {tuple(y_p.shape)} at N={n}")
        # Tolerance: rtol 1e-4, atol 1e-5 of the input scale (1.0), the bar of
        # the JAX package's decimator tests: float32 sums of 49 or 97 terms in
        # another order than the convolution's.
        if not torch.allclose(y_k, y_p, rtol=1e-4, atol=1e-5):
            raise AssertionError(
                f"K5 differs at N={n}, factor {factor}: max |err| {float((y_k - y_p).abs().max()):.3g}")
        worst = max(worst, float((y_k - y_p).abs().max()))
        if n > 1_000_000:
            v = x.T[:, None, :].contiguous()
            w = taps[None, None, :]
            t_len, n_out = len(taps), y_k.shape[0]
            bound_ms, bound_by = bound(4 * (2 * n + 2 * n_out + t_len), 2 * t_len * 2 * n_out)
            log(f"K5 fir_decimate [{n}, 2] / {factor}, {t_len} taps: bound {bound_ms:.4f} ms "
                f"({bound_by})")
            # The library call: one float32 strided convolution (TF32 is
            # off, core/device.py) on planes already laid out [2, 1, N].
            timed[factor] = dict(**timing_keys(two_way({
                "plain": (lambda: fir_decimate_reference(x, taps, factor), 20, 2),
                "kernel": (lambda: fir_decimate_cuda(x, taps, factor), 20, 2),
                "library": (lambda: F.conv1d(v, w, stride=factor), 20, 2),
            })), bound_ms=bound_ms, bound_by=bound_by)
    log(f"K5 fir_decimate: kernel == plain on {len(cases)} cases (rtol 1e-4, atol 1e-5; "
        f"max |err| {worst:.3g})")
    return {
        "name": "K5 fir_decimate",
        "route": "cuda",
        "source": "gypsum_tpu_torch/csrc/fir_decimate.cu",
        "replaces": "gypsum_tpu/ops/pallas_kernels.py:63",
        "max_abs_err": worst,
        **timed[4],
    }


def hold_wipeoff_lag(args, what: str, **kw) -> tuple[float, float]:
    """K4 against its plain version on ``args``, and against itself: two
    launches on the same inputs must give the same bits (the blocks of a
    channel are added in a fixed order). Returns (max |err|, scale)."""
    from gypsum_tpu_torch.ops.wipeoff_lag import wipeoff_lag_cuda, wipeoff_lag_reference

    out_k = wipeoff_lag_cuda(*args, **kw)
    again = wipeoff_lag_cuda(*args, **kw)
    out_p = wipeoff_lag_reference(*args)
    torch.cuda.synchronize()
    if out_k.shape != out_p.shape or not bool(torch.isfinite(out_k).all()):
        raise AssertionError(f"K4 at {what}: shape {tuple(out_k.shape)} or non-finite values")
    if not torch.equal(out_k, again):
        raise AssertionError(f"K4 at {what}: two runs on the same inputs differ")
    scale = float(out_p.abs().max())
    err = float((out_k - out_p).abs().max())
    # Tolerance: 1e-4 of the correlation scale. Both sides run the same
    # float32 phase arithmetic; the sums run in another order and the card's
    # sincosf against PyTorch's cos and sin may differ in the last bit.
    if err > 1e-4 * scale:
        raise AssertionError(f"K4 differs at {what}: max |err| {err:.3g} at scale {scale:.3g}")
    return err, scale


def check_wipeoff_lag(dev, sats, samples) -> dict:
    from gypsum_tpu_torch.core.config import TrackingConfig
    from gypsum_tpu_torch.ops.wipeoff_lag import wipeoff_lag_cuda, wipeoff_lag_reference

    cfg = TrackingConfig()
    k_half = cfg.lag_window_half_width
    n_lags = 2 * k_half + 1
    bank, replicas = checks_bank(sats, dev, cfg, off_air=False)
    st = bank.state
    worst, scale = 0.0, 0.0
    # The bank's real (theta, f, base) at block start, on three chunks of
    # the block, and one set of phases away from zero.
    for ms, theta in ((0, st.carrier_phase), (1, st.carrier_phase + 1.7), (999, st.carrier_phase)):
        chunk_iq = torch.stack([samples[ms].real, samples[ms].imag]).contiguous()
        base = np.mod(L - np.floor(st.code_phase).astype(np.int64) - k_half, L)
        params = torch.from_numpy(
            np.stack([theta, st.doppler, base.astype(np.float32)], axis=-1).astype(np.float32)
        ).to(dev)
        args = (chunk_iq, replicas, params, L, n_lags, 1.0 / FS)
        err, scale = hold_wipeoff_lag(args, f"ms {ms}")
        worst = max(worst, err)
    # Other shapes on seeded random inputs: 1, 12 and 64 channels (8, 8 and 2
    # blocks per channel on 132 SMs), lengths that the blocks do not divide,
    # 1 to 33 lags, the window base at 0 and at its clamp, and one set of
    # replicas that are not +/-1 (the fused multiply-add then rounds once).
    # These take only what every version of the wrapper takes.
    g = torch.Generator(device=dev).manual_seed(4)
    n_shapes = 0
    for s_count in (1, 12, 64):
        for length in (2046, 2047, 4092):
            for lags in (1, 9, 33):
                w_len = 2 * length + lags - 1
                wide = torch.randn((s_count, w_len), device=dev, generator=g)
                if (s_count, lags) != (12, 9):
                    wide = torch.sign(wide)
                base = torch.randint(0, length, (s_count,), device=dev, generator=g).float()
                base[0], base[-1] = 0.0, float(w_len - length - (lags - 1))
                shape_params = torch.stack([
                    6.28 * torch.rand(s_count, device=dev, generator=g),
                    10e3 * torch.rand(s_count, device=dev, generator=g) - 5e3, base], dim=-1)
                shape_args = (torch.randn((2, length), device=dev, generator=g), wide,
                              shape_params, length, lags, 1.0 / FS)
                hold_wipeoff_lag(shape_args, f"S {s_count}, L {length}, {lags} lags")
                n_shapes += 1
    if "n_split" in inspect.signature(wipeoff_lag_cuda).parameters:
        # Every number of blocks per channel, whatever the card would pick.
        for n_split in (1, 2, 4, 8):
            hold_wipeoff_lag(args, f"{n_split} blocks per channel", n_split=n_split)
            n_shapes += 1
    times = two_way({
        "plain": (lambda: wipeoff_lag_reference(*args), 50, 2),
        "kernel": (lambda: wipeoff_lag_cuda(*args), 200, 2),
        # A kernel that does nothing, on K4's grid of 96 blocks of 512
        # threads: what a launch alone costs the card and the host.
        "empty": (lambda: EMPTY_KERNEL.launch(96, 512), 200, 2),
    })
    w_len = replicas.shape[1]
    # Bytes: the chunk, each channel's L + 2K window, the parameters, the
    # outputs. Operations: per channel and sample 12 for the wipeoff and 4
    # per lag.
    n_bytes = 4 * (2 * L + N_CH * (L + 2 * k_half) + 3 * N_CH + 2 * N_CH * n_lags)
    bound_ms, bound_by = bound(n_bytes, N_CH * L * (12 + 4 * n_lags))
    log(f"K4 wipeoff_lag [{N_CH}, {w_len}], {n_lags} lags: kernel == plain on 3 chunks of the "
        f"block (max |err| {worst:.3g} at scale {scale:.3g}) and on {n_shapes} other shapes (bar "
        f"1e-4 of scale), two runs on the same inputs equal to the bit; bound {bound_ms:.6f} ms "
        f"({bound_by})")
    return {
        "name": "K4 wipeoff_lag",
        "route": "cuda",
        "source": "gypsum_tpu_torch/csrc/wipeoff_lag.cu",
        "replaces": "gypsum_tpu/ops/pallas_kernels.py:281",
        "max_abs_err": worst,
        **timing_keys(times),
        "empty_ms": times["empty"][0],
        "empty_issue_ms": times["empty"][1],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
    }


def check_track_block(dev, sats, samples) -> dict:
    from gypsum_tpu_torch.core.config import TrackingConfig
    from gypsum_tpu_torch.core.planes import to_planes
    from gypsum_tpu_torch.ops import fixup as fx
    from gypsum_tpu_torch.ops import track_block as tb
    from gypsum_tpu_torch.track.loop import carry_rows, device_state

    cfg = TrackingConfig()
    bank, replicas = checks_bank(sats, dev, cfg, off_air=False)
    params = tb.TrackBlockParams.from_config(cfg, L, FS)
    state = device_state(bank.state, dev)
    rows = torch.stack([*carry_rows(state), torch.zeros(N_CH, device=dev)]).contiguous()
    planes = to_planes(samples).contiguous()
    nle = 2 * params.k_eff + 1
    fin_k, outs_k = tb.track_block_cuda(rows, planes, replicas, params)
    fin_p, outs_p = tb.track_block_reference(rows, planes, replicas, params)
    torch.cuda.synchronize()
    if outs_k.shape != (B_MS, fx.N_OUT, N_CH) or fin_k.shape != (tb.N_CARRY, N_CH):
        raise AssertionError(f"K3 shapes {tuple(outs_k.shape)}, {tuple(fin_k.shape)}")
    for name, t in (("kernel outs", outs_k), ("kernel carry", fin_k), ("plain outs", outs_p)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"K3 {name}: non-finite values")
    for row in (fx.O_LOCKED, fx.O_LOST):
        if not torch.equal(outs_k[:, row], outs_p[:, row]):
            n_diff = int((outs_k[:, row] != outs_p[:, row]).sum())
            raise AssertionError(f"K3: output row {row} (locked/lost) differs at {n_diff} places")
    for row in (fx.STEP, fx.LOST, fx.CPI0):
        if not torch.equal(fin_k[row], fin_p[row]):
            raise AssertionError(f"K3: carry row {row} (step/lost/window center) differs")
    # Tolerance: the JAX package's own bar for this kernel against its scan,
    # 2e-3 of each row's scale on the carry and 5e-3 on the outputs. The
    # multiply-reduce over 2046 samples sums in another order than the plain
    # version's, and 1000 ms of loop filter integrate the difference.
    worst, worst_rel = 0.0, 0.0
    for name, a, b, tol in (("outs", outs_k, outs_p, 5e-3), ("fin", fin_k, fin_p, 2e-3)):
        dims = (0, 2) if name == "outs" else 1
        scale = b.abs().amax(dim=dims).clamp(min=1.0)
        rows_err = (a - b).abs().amax(dim=dims)
        if bool((rows_err > tol * scale).any()):
            raise AssertionError(f"K3 {name}: per-row max error {rows_err.tolist()} at scale {scale.tolist()}")
        worst = max(worst, float(rows_err.max()))
        worst_rel = max(worst_rel, float((rows_err / scale).max()))
    locked = int(outs_k[-1, fx.O_LOCKED].sum())
    # The plain version (1000 Python steps) has just run: one call, no
    # warm-up of its own.
    times = two_way({
        "kernel": (lambda: tb.track_block_cuda(rows, planes, replicas, params), 5, 2),
        "plain": (lambda: tb.track_block_reference(rows, planes, replicas, params), 1, 0),
    })
    # Bytes: the block's samples and the S windows once, the outputs, the
    # carry in and out. Operations: per ms and channel, 2 NLE dot products of
    # L multiply-adds and ~12 L for the wipeoff.
    n_bytes = 4 * (2 * B_MS * L + N_CH * (L + 2 * params.k_eff) + B_MS * fx.N_OUT * N_CH
                   + 2 * tb.N_CARRY * N_CH)
    n_ops = B_MS * N_CH * (2 * nle * L * 2 + 12 * L)
    bound_ms, bound_by = bound(n_bytes, n_ops)
    log(f"K3 track_block [{B_MS}, {L}, 2] x {N_CH} channels, NLE {nle}: kernel == plain "
        f"(locked/lost/step exact; max |err| {worst:.3g}, {worst_rel:.3g} of row scale; bars 5e-3 "
        f"outputs, 2e-3 carry); {locked}/{N_CH} channels locked at block end; "
        f"bound {bound_ms:.4f} ms ({bound_by}, {n_ops / 1e9:.2f} GFLOP)")
    return {
        "name": "K3 track_block",
        "route": "cuda",
        "source": "gypsum_tpu_torch/csrc/track_block.cu",
        "replaces": "gypsum_tpu/ops/pallas_track.py:54",
        "max_abs_err": worst,
        **timing_keys(times),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
    }


def check_scan_variants(dev, sats, samples) -> None:
    """One 1000 ms block through the per-ms scan tracker on the card in its
    three forms: K4 as the correlator, the per-ms plain correlator and the
    hoisted plain correlator."""
    from gypsum_tpu_torch.core.config import TrackingConfig
    from gypsum_tpu_torch.ops.wipeoff_lag import WIPEOFF_LAG_KERNEL

    scan = dict(use_matmul_tracker=False, use_pallas_block_tracker=False)
    runs = {}
    for name, kw in (("K4", dict(use_pallas_correlator=True)),
                     ("per-ms plain", dict(hoist_lag_window=False)),
                     ("hoisted plain", {})):
        bank, _ = checks_bank(sats, dev, TrackingConfig(**scan, **kw), off_air=False)
        before = WIPEOFF_LAG_KERNEL.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        obs = bank.process_block(samples, 0.0)
        torch.cuda.synchronize()
        runs[name] = (obs, time.perf_counter() - t0, WIPEOFF_LAG_KERNEL.launches - before)
    if runs["K4"][2] != B_MS or runs["per-ms plain"][2] or runs["hoisted plain"][2]:
        raise AssertionError(f"K4 launches per scan block: {[r[2] for r in runs.values()]}")
    worst_fd = worst_cp = 0.0
    for name in ("per-ms plain", "hoisted plain"):
        for a, b in zip(runs["K4"][0], runs[name][0]):
            # Bars of the JAX package's tracker-bank comparison of two
            # trackers (tests/test_pallas_block_tracker.py): equal
            # pseudosymbols, Doppler within 0.5 Hz, code phase within 0.01.
            d_fd = float(np.abs(a.dopplers - b.dopplers).max())
            d_cp = np.abs(a.code_phases - b.code_phases)
            d_cp = float(np.minimum(d_cp, L - d_cp).max())
            if not np.array_equal(a.pseudosymbol_signs, b.pseudosymbol_signs) or d_fd > 0.5 or d_cp > 0.01:
                raise AssertionError(
                    f"scan with K4 vs {name}, PRN {a.prn} slot {a.slot}: signs equal "
                    f"{np.array_equal(a.pseudosymbol_signs, b.pseudosymbol_signs)}, "
                    f"Doppler {d_fd:.3g} Hz, code phase {d_cp:.3g}")
            worst_fd, worst_cp = max(worst_fd, d_fd), max(worst_cp, d_cp)
    log(f"scan tracker, one 1000 ms block x {N_CH} channels on the card: K4 == per-ms plain == "
        f"hoisted plain (equal pseudosymbols; Doppler within {worst_fd:.3g} Hz, code phase within "
        f"{worst_cp:.3g}); wall " + ", ".join(f"{k} {v[1]:.2f} s" for k, v in runs.items()))


# ---------------------------------------------------------- phase 5: e2e


def synthesize_scene(sample_rate: float = FS):
    from gypsum_tpu_torch.signal.constellation import synthesize_constellation
    from gypsum_tpu_torch.signal.scenarios import demo_constellation
    from gypsum_tpu_torch.solve.geodesy import lla_to_ecef

    rx = lla_to_ecef(*TRUTH_LLA)
    iq, _ = synthesize_constellation(
        demo_constellation(SCENE_PRNS), rx, gps_start_time_sow=GPS_T0, duration_s=23.0,
        sample_rate=sample_rate, noise_sigma=0.35, subframe_pattern="123", seed=0,
    )
    return rx, iq


def run_cli(capture: Path, rx: np.ndarray, *extra: str) -> float:
    from gypsum_tpu_torch.solve.geodesy import lla_to_ecef

    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "gypsum_tpu_torch", "replay", "--file", str(capture),
         "--until-fix", *extra],
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
    log(f"e2e CLI: replay --until-fix {' '.join(extra)} printed FIX lat={lat} lon={lon} "
        f"alt={alt:.0f}m, {err:.2f} m from truth, {wall:.1f} s wall (process start included)")
    return err


def run_receiver(iq: np.ndarray, rx: np.ndarray, dev, peak_kernel: bool = False,
                 source=None, **tracking):
    """One in-process replay of ``iq`` at 2.046 Msps (or of ``source``), with
    ``tracking`` fields set on the default TrackingConfig. ``recv.collect``
    then summarizes the host ms per block spent in
    ``TrackerBank.collect_block`` (waiting for the block's outputs, then
    building its observations)."""
    import dataclasses

    from gypsum_tpu_torch.core.config import AcquisitionConfig, ReceiverConfig
    from gypsum_tpu_torch.io.sources import ArraySampleSource
    from gypsum_tpu_torch.runtime.receiver import Receiver

    cfg = ReceiverConfig()
    if peak_kernel:
        cfg = cfg.replace(acquisition=AcquisitionConfig(use_pallas_peak_reduce=True))
    cfg = cfg.replace(tracking=dataclasses.replace(cfg.tracking, **tracking))
    recv = Receiver(source if source is not None else ArraySampleSource(iq, FS), cfg, device=dev)
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


KERNELS = {}  # name -> CudaKernel, filled by main()
EMPTY_KERNEL = None  # the kernel that does nothing (csrc/empty.cu), set by main()


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launches() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def signs_by_prn(recv) -> dict:
    out: dict[int, list[np.ndarray]] = {}
    for report in recv.block_reports:
        for obs in report.observations:
            out.setdefault(obs.prn, []).append(np.asarray(obs.pseudosymbol_signs))
    return {p: np.concatenate(v) for p, v in out.items()}


def check_same_tracking(name: str, recv, acq, ref_recv, ref_acq) -> str:
    """``recv`` against the default run: the same acquisitions and > 99.9 %
    pseudosymbol sign agreement per PRN."""
    if [a[:4] for a in acq] != [a[:4] for a in ref_acq]:
        raise AssertionError(f"{name}: acquisitions differ from the default run:\n{acq}\n{ref_acq}")
    got, want = signs_by_prn(recv), signs_by_prn(ref_recv)
    agreement = {}
    for prn in SCENE_PRNS:
        if got[prn].shape != want[prn].shape:
            raise AssertionError(
                f"{name}: PRN {prn} has {len(got[prn])} pseudosymbols, the default run {len(want[prn])}")
        agreement[prn] = float(np.mean(got[prn] == want[prn]))
        if agreement[prn] <= 0.999:
            raise AssertionError(f"{name}: PRN {prn} sign agreement {agreement[prn]:.4%} with the default run")
    return ", ".join(f"PRN {p} {100 * a:.2f} % of {len(got[p])}" for p, a in agreement.items())


def block_timings(recv, iq: np.ndarray) -> tuple[float, float]:
    """Device ms of one 1000 ms tracking block (phase 1 + K1 + glue) at the
    receiver's channel binding, and of one 10 ms acquisition sweep."""
    bank = recv.bank
    block = torch.from_numpy(np.ascontiguousarray(iq[: 1000 * L].reshape(1000, L))).to(bank.device)
    prn_idx = np.array([bank._prn_row[p] if p is not None else 0 for p in bank.slot_prn])
    replicas = bank._device_replicas(prn_idx)
    bank.sync_host_state()
    state = bank.state
    track_ms = issue_ms(lambda: bank._fn.packed(state, block, replicas), 5)
    x10 = torch.from_numpy(np.ascontiguousarray(iq[: 10 * L].reshape(10, L))).to(bank.device)
    acq_ms = issue_ms(lambda: recv.acquisition(x10), 5)
    return track_ms, acq_ms


def profile_run(iq: np.ndarray, dev) -> None:
    """One more replay of the scene under torch.profiler: the device's busy
    share of the wall time and the kernels that take it (the profiler's own
    overhead lengthens the wall time and it may lose records, ``device_ms``,
    so the share is a lower bound)."""
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
    from gypsum_tpu_torch.io.sources import ArraySampleSource, DecimatingSampleSource
    from gypsum_tpu_torch.ops import kernels
    from gypsum_tpu_torch.ops.fir_decimate import FIR_DECIMATE_KERNEL
    from gypsum_tpu_torch.ops.fixup import FIXUP_KERNEL
    from gypsum_tpu_torch.ops.peak_reduce import PEAK_REDUCE_KERNEL
    from gypsum_tpu_torch.ops.track_block import TRACK_BLOCK_KERNEL
    from gypsum_tpu_torch.ops.wipeoff_lag import WIPEOFF_LAG_KERNEL

    global EMPTY_KERNEL
    EMPTY_KERNEL = kernels.CudaKernel(
        "empty", "empty_launch", [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    KERNELS.update(K1=FIXUP_KERNEL, K2=PEAK_REDUCE_KERNEL, K3=TRACK_BLOCK_KERNEL,
                   K4=WIPEOFF_LAG_KERNEL, K5=FIR_DECIMATE_KERNEL)
    resolve_device(dev)
    t0 = time.perf_counter()
    built = kernels.build_all([k.source for k in (*KERNELS.values(), EMPTY_KERNEL)])
    log(f"build: {', '.join(f'{k} {v:.2f} s' for k, v in built.items())} "
        f"({time.perf_counter() - t0:.2f} s wall, nvcc sm_90a, in parallel)")

    sats, samples = synthetic_block(dev)
    only = [a.partition("=")[2] for a in sys.argv[1:] if a.startswith("--kernels-only")]
    if only:
        # A short run for work on a kernel: the checks of the kernels named
        # (all five without names); no replay, so no launch counts and no
        # result line.
        checks = {
            "K1": lambda: check_fixup(dev, sats, samples),
            "K2": lambda: check_peak_reduce(dev),
            "K3": lambda: check_track_block(dev, sats, samples),
            "K4": lambda: check_wipeoff_lag(dev, sats, samples),
            "K5": lambda: check_fir_decimate(dev),
        }
        names = only[0].split(",") if only[0] else list(checks)
        log(json.dumps({"kernels": [checks[name]() for name in names]}))
        return 0
    k1 = check_fixup(dev, sats, samples)
    k2 = check_peak_reduce(dev)
    k5 = check_fir_decimate(dev)
    k4 = check_wipeoff_lag(dev, sats, samples)
    k3 = check_track_block(dev, sats, samples)
    check_scan_variants(dev, sats, samples)
    del samples
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    rx, iq = synthesize_scene()
    log(f"e2e scene: PRNs {SCENE_PRNS}, 23 s at {FS:.0f} sps, noise 0.35, "
        f"synthesized in {time.perf_counter() - t0:.1f} s (host)")
    with tempfile.TemporaryDirectory() as tmp:
        capture = Path(tmp) / "scene.npy"
        np.save(capture, iq)
        run_cli(capture, rx)

    # The main paths: counts set to 0 just before each run, read just after.
    reset_launches()
    recv, acq_a, errs_a, wall_a = run_receiver(iq, rx, dev, peak_kernel=False)
    n = launches()
    k1["launches"] = n["K1"]
    if n["K1"] == 0:
        raise AssertionError("the main path never launched K1")
    log(f"e2e Receiver(device='cuda'), default config: {len(errs_a)} fixes, best "
        f"{min(errs_a):.2f} m, last {errs_a[-1]:.2f} m; {wall_a:.2f} s wall for "
        f"{recv.source.seconds_consumed:.0f} s of signal; launches {n}; "
        f"{recv.collect} (depth-1 pipeline)")

    reset_launches()
    recv_b, acq_b, errs_b, wall_b = run_receiver(iq, rx, dev, peak_kernel=True)
    n = launches()
    k2["launches"] = n["K2"]
    if n["K2"] == 0 or n["K1"] == 0:
        raise AssertionError("the peak-reduce run did not launch both K1 and K2")
    if [a[:4] for a in acq_a] != [b[:4] for b in acq_b] or not np.allclose(
        [a[4] for a in acq_a], [b[4] for b in acq_b], rtol=1e-5
    ):
        raise AssertionError(f"acquisitions differ:\n{acq_a}\n{acq_b}")
    log(f"e2e Receiver(device='cuda'), use_pallas_peak_reduce=True: identical acquisitions; "
        f"{len(errs_b)} fixes, best {min(errs_b):.2f} m; {wall_b:.2f} s wall; "
        f"launches {n}; {recv_b.collect}")

    # The one-block read-ahead with its copy on a side stream from pinned
    # memory (async_upload) must not change what the receiver computes.
    recv_c, acq_c, errs_c, wall_c = run_receiver(iq, rx, dev, async_upload=True)
    if acq_c != acq_a or not np.allclose(errs_c, errs_a, rtol=0, atol=1e-6):
        raise AssertionError(f"async_upload changed the replay: {errs_c} vs {errs_a}")
    log(f"e2e Receiver(device='cuda'), async_upload=True: same acquisitions and fixes; "
        f"{wall_c:.2f} s wall; {recv_c.collect}")

    # Without the pipeline each collect waits for its block's whole device
    # work: the contrast shows what the depth-1 pipeline hides.
    recv_d, _, errs_d, wall_d = run_receiver(iq, rx, dev, pipeline_tracking=False)
    log(f"e2e Receiver(device='cuda'), pipeline_tracking=False: {len(errs_d)} fixes, best "
        f"{min(errs_d):.2f} m; {wall_d:.2f} s wall; {recv_d.collect}")

    # The whole-block tracker: every block of the replay through K3.
    reset_launches()
    recv_e, acq_e, errs_e, wall_e = run_receiver(iq, rx, dev, use_pallas_block_tracker=True)
    n = launches()
    k3["launches"] = n["K3"]
    blocks = round(recv_e.source.seconds_consumed)  # 1000 ms blocks dispatched
    if n["K3"] != blocks or n["K1"] != 0:
        raise AssertionError(f"block-kernel replay of {blocks} blocks launched {n}")
    agree = check_same_tracking("block kernel", recv_e, acq_e, recv, acq_a)
    log(f"e2e Receiver(device='cuda'), use_pallas_block_tracker=True: {len(errs_e)} fixes, best "
        f"{min(errs_e):.2f} m; acquisitions as the default run; sign agreement {agree}; "
        f"{wall_e:.2f} s wall; launches {n}; {recv_e.collect}")

    # The per-ms scan tracker with K4 as its correlator: one launch per ms.
    reset_launches()
    recv_f, acq_f, errs_f, wall_f = run_receiver(
        iq, rx, dev, use_matmul_tracker=False, use_pallas_block_tracker=False,
        use_pallas_correlator=True)
    n = launches()
    k4["launches"] = n["K4"]
    blocks = round(recv_f.source.seconds_consumed)
    if n["K4"] != 1000 * blocks or n["K1"] != 0 or n["K3"] != 0:
        raise AssertionError(f"K4 scan replay of {blocks} blocks launched {n}")
    agree = check_same_tracking("K4 scan", recv_f, acq_f, recv, acq_a)
    log(f"e2e Receiver(device='cuda'), scan tracker with use_pallas_correlator=True, "
        f"{recv_f.source.seconds_consumed:.0f} s of signal: {len(errs_f)} fixes, best "
        f"{min(errs_f):.2f} m; acquisitions as the default run; "
        f"sign agreement {agree}; {wall_f:.2f} s wall; launches {n}; {recv_f.collect}")

    # The decimating front end at full width: the same scene as an
    # 8.184 Msps capture, through the CLI and through the source. The code
    # phases shift by the filter's group delay; the fix must not.
    t0 = time.perf_counter()
    _, iq_fast = synthesize_scene(FS_FAST)
    log(f"e2e decimated scene: 23 s at {FS_FAST:.0f} sps ({iq_fast.nbytes / 1e9:.2f} GB), "
        f"synthesized in {time.perf_counter() - t0:.1f} s (host)")
    with tempfile.TemporaryDirectory() as tmp:
        capture = Path(tmp) / "scene_8x.npy"
        np.save(capture, iq_fast)
        run_cli(capture, rx, "--sample-rate", f"{FS_FAST:.0f}")
    reset_launches()
    source = DecimatingSampleSource(ArraySampleSource(iq_fast, FS_FAST), FS, device=dev)
    read_block, read_s = source.read_block, []

    def timed_read(n_ms):
        t = time.perf_counter()
        out = read_block(n_ms)
        read_s.append(time.perf_counter() - t)
        return out

    source.read_block = timed_read
    recv_g, _, errs_g, wall_g = run_receiver(None, rx, dev, source=source)
    n = launches()
    k5["launches"] = n["K5"]
    if n["K5"] == 0 or n["K1"] == 0:
        raise AssertionError(f"the decimated replay launched {n}")
    log(f"e2e Receiver(DecimatingSampleSource(8.184 -> 2.046 Msps), device='cuda'): "
        f"{len(errs_g)} fixes, best {min(errs_g):.2f} m, last {errs_g[-1]:.2f} m; {wall_g:.2f} s "
        f"wall for {source.seconds_consumed:.0f} s of signal; launches {n}; the source's "
        f"read_block (host buffer, 65 MB upload, K5, 16 MB download) mean "
        f"{1e3 * np.mean(read_s):.1f} ms per block; {recv_g.collect}")
    del iq_fast, source, recv_g

    track_ms, acq_ms = block_timings(recv, iq)
    log(f"timing: one 1000 ms tracking block (phase 1 bf16 matmul with float32 "
        f"output + K1) {track_ms:.3f} ms; one 10 ms acquisition sweep {acq_ms:.3f} ms")

    profile_run(iq, dev)

    log(json.dumps({"kernels": [k1, k2, k3, k4, k5]}))
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

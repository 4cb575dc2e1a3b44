"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port (``gypsum_tpu_torch``) on the card, with no JAX:

1. device: the card's name and power limit (``nvidia-smi``); the replays'
   scenes start synthesizing in worker processes (``Scenes``), which takes
   the host minutes and overlaps steps 2-4;
2. build: the five hand-written kernels from ``gypsum_tpu_torch/csrc`` with
   ``nvcc`` (one process each, in parallel), and a kernel that does nothing
   (``csrc/empty.cu``, the yardstick of a launch);
3. each kernel against its plain PyTorch version, timed beside its bound:
   K1 (loop-filter fixup) on the correlations of a real phase-1 pass over a
   synthesized 1000 ms block (12 channels, NLE 35), triangle and HRC at the
   default K = 4 (the kernel's unrolled instantiation) and triangle at
   K = 2 (its generic one), every output and carry row identical to the
   bit;
   K2 (acquisition peak reduce) on the real [928, 2046] coarse grid, odd
   sizes, rows shorter than one 16-byte load, a row count the blocks do not
   divide, views 4 and 12 bytes into their storage, planted ties and rows
   of -inf; K5 (FIR decimator) on one 1000 ms block at 8.184 Msps (factor
   4, 49 taps), 16.368 Msps (factor 8, 97 taps) and 10.23 Msps (factor 5,
   61 taps), each timed beside ``F.conv1d`` and beside what a model of the
   first design's shared-memory bank conflicts predicts, odd lengths,
   N == T, an asymmetric filter, a view 8 bytes into its storage, and the
   longest filters of the TPU kernel's range (factor 120's default filter,
   128 taps per phase at factor 66); K4 (per-ms wipeoff + lag correlate) on
   chunks of that block with the bank's (theta, f, base), on 1 to 64
   channels, three
   lengths, 1 to 33 lags and 1 to 8 blocks per channel, each run twice and
   the two runs held equal to the bit; K3 (whole-block tracker) on that
   block at K = 4 and K = 3 (its two instantiations), each run twice and
   held equal to the bit, its bound counting the 2K+1 lags the loop filter
   reads (not all NLE of the window).

   Then K1, K2, K4 and K5 again at the GLONASS inputs: K1 on a real
   phase-1 pass over 1000 ms of the GLONASS scene at NLE 43 (L1OF) and 49
   (L2OF), 12 channels at FDMA offsets with odd and even k, identical to
   the bit; K2 on the real [406, 4092] FDMA grid (14 channels x 29
   Dopplers), with the engine's coarse peak by both routes; K4 at L = 4092
   with wipe frequencies of k x 562.5 kHz (437.5 kHz) + Doppler, up to
   3.94 MHz; K5 at factor 2 (8.184 -> 4.092 Msps) with its default filter.
   And K2 at the deep sweep's shape (K2 D): the [256, 2046] accumulator
   (32 PRNs x 8 Doppler bins) of a default 200 ms deep search, max and
   argmax exact, the sum within 1e-6 of the largest row sum, two runs equal.

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
7. the GLONASS bands end to end: the 5-channel, 13 s GLONASS-only scene of
   tests/test_glonass_receiver.py through ``Receiver(band="glonass")``
   (default config, K1 each block; K2 peak reduce, held to the first run's
   acquisitions; the per-ms scan tracker through K4, held to its signs)
   with that test's bars (a fix by 11 s, every fix within 15 m, the last
   within 5 m); the same scene at 8.184 Msps through the CLI's
   ``--glonass-file --glonass-rate 8184000 --until-fix`` (K5 each block);
   GPS + GLONASS through ``--file --glonass-file`` (4 + 3 satellites
   within 5 m, the inter-system bias within 250 ns of the injected
   -800 ns); GLONASS L1OF + L2OF of an iono-loaded scene through
   ``DualBandReceiver`` (the measured ionosphere on >= 4 satellites, the
   fix within 5 m); then one GLONASS replay under torch.profiler. The CLI
   runs in this process (its ``main``), so the launch counts see it;
8. the deep tier: the weak PRN 7 scene of tests/test_deep_acquire.py
   (400 ms; the 10 ms engine blind, the deep search on code phase 512
   within 5 Hz, PRN 3 under the threshold); a default 200 ms search over 32
   PRNs on the eight demo satellites (36 K2 launches; ms per search and per
   chunk; the sweep by stage, between events and replayed from a CUDA
   graph); ``deep_acquire_glonass`` on the GLONASS-only scene (its channels
   on the air on the 10 ms FDMA engine's code phases); the 38 s deep-fade
   scene of tests/test_deepcoast.py through the default Receiver with that
   test's tracking config, unpipelined (as that test runs) and pipelined
   (the card's default), both held to that test's bars (the JAX receiver's
   own pipelined fixes, which miss them, ``FADE_PIPELINED_REFERENCE``, are
   logged beside the port's);
   that receiver checkpointed and reloaded, ``acquire --deep --snapshot``
   on its orbits (held to the JAX CLI's fix, ``SNAPSHOT_REFERENCE``), and
   the 23 s GPS scene replayed with ``--duration 12 --checkpoint``, then
   resumed, within 1 m of the uninterrupted run's fixes; one fade replay
   under torch.profiler;
9. the front ends and the circulant sweep: the circulant-matmul coarse
   sweep (``correlator="matmul"``) against the FFT sweep on the 23 s
   scene's first 10 ms (the bars of tests/test_acquisition.py:160-185),
   both timed beside their bounds with the per-satellite form, K2 on its
   grid, the 23 s scene replayed through it (held to the default run), and
   the GLONASS FDMA family's one-row table (this step runs after step 4's
   replays); the 25 s CW-jammed scene of tests/test_interference.py
   through ``NotchingSampleSource`` and ``replay --notch`` (its bars), the
   notch's times per 1000 ms block beside the numpy notch's, the card
   against the CPU and against itself; the 23 s 4-element array scene of
   tests/test_beamform.py through ``null_jammers`` (> 15 dB, the
   contraction against numpy's), the default receiver (within 15 m) and
   ``replay --beamform`` (the MUSIC bearing within 4 deg);
10. the rtk entry point and the replay's exports (``run_rtk``): the static
   pair of tests/test_rtk.py:223-270 (six PRNs, the rover 13.46 m away;
   24 s read of a 60 s pair, so that the base decodes its orbits) through
   ``python -m gypsum_tpu_torch rtk`` in this process, static,
   ``--kinematic`` and ``--attitude`` (that file's and
   tests/test_attitude.py's bars), the rover on its own clock with
   ``--independent-clocks`` (the offset within 0.5 us, the drift within
   2e-9), RINEX mode on the 60 s pair's ``replay --rinex-obs`` exports;
   K1's launches around each capture-mode run equal to the blocks its two
   receivers dispatch, each receiver's wall, the phase logs' pin residual
   and arcs, and the host ms of each solve stage; then the 23 s scene's
   ``--rinex-obs --rinex-nav --nmea-out`` files (tests/test_rinex.py's
   bars, one GGA per FIX line) and ``--assist-nav --assist-time`` on the
   pair's base (tests/test_assist.py's bars);
11. scale-out on torch.distributed (``run_mesh``), each launch's ranks
   ``python3 chip_smoke.py --mesh-rank=...`` processes on cuda:0 meeting
   through a FileStore under build/mesh/, every rank killed at the launch's
   limit and any rank's failure failing the script: first two gloo ranks
   try nine collectives on CUDA tensors (which gloo takes is logged), then
   rank 1 raises before a collective and rank 0 must fail out of it within
   the limit; then M1 (NCCL, world 1) and M2 (gloo, world 2, sat 2 x time
   1), where each rank runs the five steps of
   __graft_entry__.py:dryrun_multichip (the sharded sweep finds the planted
   PRN 7 with the single-device sweep's indices; the halo sweep equals a
   single-device linear correlation; the channel-sharded scan block and
   the sharded fast tracker are held to the unsharded ones on this card,
   K1 on a rank's channels to the bit to its slice of K1 on all 12) and
   ``Receiver(device="cuda", mesh=...)`` replays the 23 s scene; each
   replay is held here to the parity ladder against the default card
   replay of step 4, with fixes < 2 m from truth, 23 K1 launches a rank,
   and M2's two ranks' reports the same bytes. Each rank prints its steps'
   times, ms per 1000 ms tracking block sharded and not, and the
   all_gather's ms per block between events. Before the replays, the
   farm (``check_farm``): ``make_farm_track_block_fn`` at bench.py:353's
   8 streams x 8 channels, one block, against each stream alone;
12. the host surfaces (``run_host_surfaces``): the 23 s scene written as a
   raw interleaved float32 capture (2.046 Msps) and the 8.184 Msps scene as
   an interleaved int8 one (scaled so that its largest component is 127;
   the log states the scale), each with its sidecar; the port's
   ``FileSampleSource`` (the native C++ reader, io/native.py, with its
   prefetch thread) held to the bit to ``convert_numpy`` on both (three
   blocks, a block at an odd offset, the prefetch's and the spot's reads);
   the host ms per 1000 ms ``read_block`` of both readers in turns (at
   ``DecimatingSampleSource.read_block`` for the int8 file); each file
   replayed by ``replay --file ... --until-fix`` in this process to a fix
   within 100 m, the int8 one with one K5 launch per decimated block; the
   port's dashboard server on 127.0.0.1:0 and ``Receiver(device="cuda")``
   over the 23 s scene with a ``DashboardClient`` and a
   ``TrackerVisualizer`` (tests/test_obs.py's bars, K1 launches equal to
   the blocks, PNGs that decode or, without matplotlib, none and one
   warning); ``replay --web-ui --render-figures`` with no server
   listening, in a scratch working directory, to its fix; and ``replay
   --duration 3 --profile-dir``, its trace parsed, its CUDA kernel events
   and K1's counted;
13. the campaign (``run_campaign``, tools/campaign_torch.py): the scenes
   of six JAX receiver tests synthesized in the scene pool and replayed
   through the port in the card's default pipelined mode, each held to its
   test's asserts and to the JAX receiver's pipelined record in
   tools/campaign_reference.jsonl (made on the CPU by
   tools/campaign_reference.py; equal status and satellite sets, the epoch
   and position differences logged beside the parity ladder's bars): an
   SBAS GEO acquired, MT9 decoded and a 5-SV fix within 5 m
   (tests/test_sbas.py:187-256), MT1 + MT2 fast corrections on (within
   2 m) and off (beyond 3 m; tests/test_sbas_corrections.py:93-150), the
   rescue tier on a 12 Hz Doppler step at 500 ms blocks through
   ``TrackerBank`` on the default tracker (K1), on and off
   (tests/test_rescue.py:24-101), an outage, reacquisition and geometry
   reseed back in the fix within 2.5 s (tests/test_reseed.py:71-130), a
   meacon from 12 s with no alert before and vestigial alerts on >= 3 PRNs
   after (tests/test_spoofing.py:105-150), and TDCP velocity within
   0.02 m/s with the Doppler fallback within 1.5 m/s
   (tests/test_tdcp.py:60-100); then campaign seeds 0, 1, 11, 17 and seed 0
   under a CW jammer through the notch, each at its record's status and
   satellite sets and within 15 m; K1's launches counted at 200 and 500 ms
   blocks;
14. the cold chain (``run_cold_chain``): the port and this script copied
   into a temporary directory as a fresh checkout has them (no build/, no
   bytecode), and ``python -m gypsum_tpu_torch replay --file <23 s GPS .npy>
   --until-fix`` run there in processes of their own, in turns: cold with
   the kernel preload (core/aot.py: the CLI starts K1's build before it
   imports torch), cold with ``GYPSUM_AOT=0`` (K1 built at its first
   launch) and warm, each with its wall from spawn to exit, its fix (within
   100 m) and K1's build seconds from the CLI's log; a cold start split in a
   fresh process (import torch, the first CUDA touch, the engine's import
   and construction, the first 10 ms 32-PRN sweep, cold, and the next
   five's mean, warm, against BASELINE.json's < 1 s); and two Receivers
   with one config in this process, the process-wide engine and track
   program emptied first: both construction times, the shared ``_fn`` and
   the second replay equal to the first to the bit. Every CLI and Receiver
   replay of the script (``run_cli``, ``run_cli_here``, ``run_receiver``,
   ``run_glonass_receiver``) is held to ``hold_preloads``: the libraries
   its preload sites asked for are those it launched (the native reader
   opened), and with the preload on none was built at a launch; one line
   lists each path's two lists;
15. a ``{"kernels": [...]}`` line with each kernel's launches, error and
   both times beside its bound, and an entry per kernel at its GLONASS
   inputs (launches from the GLONASS replays), at the deep sweep's and at
   the mesh's (K1 M: a shard's S = 6 and 3, the farm's S = 64; launches
   from M2's rank 0, the other ranks' and the farm's beside them), and K1
   at 200 and 500 ms blocks (K1 B=200 and B=500: [200, 12, 27] and
   [500, 12, 31] held to the bit at step 3, launches from step 13); K1's
   entry carries its launches per ``rtk`` run (``rtk_launches``);
16. last line: ``{"ok": true, "device": {...}}``.

Any failure raises, so the exit code is not 0 and no result line is printed.
It exits with an error at once when no CUDA device is present.

``python3 chip_smoke.py --kernels-only`` stops after step 3, and
``--kernels-only=K2,K4`` checks and times only the kernels it names (K1G,
K2G, K4G and K5G name the GLONASS checks, K2D the deep sweep's, K1M the
mesh's, K1B200 and K1B500 K1 at 200 and 500 ms blocks): a short run for work on a kernel (no replay, so no launch counts
and no result line). ``--mesh-only`` runs K1 M, the farm, the default
replay of the GPS scene and step 11 (no result line); ``--cold-only`` runs
step 14 alone, on the GPS scene (no result line); ``--campaign-only`` holds
K1 at 200 and 500 ms blocks and runs every record of
tools/campaign_reference.jsonl through the port on the card in its
recorded mode (synthesis in worker processes), each held to its record,
all before it fails, with the pass counts per level (no result line; the
records go to build/campaign_set.jsonl). The checks call the wrappers with their oldest signatures (K4's
optional ``n_split`` is probed), so a copy of this script and of
``csrc/empty.cu`` in a checkout of an earlier commit times that commit's
kernels the same way, for a comparison of two commits within one run on one
card.
"""

from __future__ import annotations

import contextlib
import ctypes
import datetime
import inspect
import json
import logging
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
FS, L = 2.046e6, 2046
FS_FAST = 8.184e6  # the gnu_radio_8x capture rate: decimated by 4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM bf16 on the tensor cores, dense
SCENE_PRNS = [25, 28, 31, 32]
TRUTH_LLA = (51.5, -0.1, 80.0)
GPS_T0 = 21600.0


T_START = time.perf_counter()


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


def bound(n_bytes: float, n_ops: float, n_bf16_ops: float = 0.0) -> tuple[float, str]:
    """Least time (ms) the card could take: the larger of bytes over the
    memory rate and the operations over the peak rate of their type (float32
    outside the tensor cores, bf16 products on them)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = (n_ops / FP32_OPS_PER_S + n_bf16_ops / BF16_OPS_PER_S) * 1e3
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


def hold_fixup(what: str, init, corr_r, corr_i, params) -> float:
    """K1 against its plain version on one block's correlations: every
    output and carry row identical to the bit. Returns the max |err| (0)."""
    from gypsum_tpu_torch.ops import fixup as fx

    fin_k, outs_k = fx.fixup_cuda(init, corr_r, corr_i, params)
    fin_p, outs_p = fx.fixup_reference(init, corr_r, corr_i, params)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(outs_k).all() and torch.isfinite(outs_p).all()):
        raise AssertionError(f"K1 {what}: non-finite outputs")
    for row in (fx.O_LOCKED, fx.O_LOST):
        if not torch.equal(outs_k[:, row], outs_p[:, row]):
            raise AssertionError(f"K1 {what}: output row {row} (locked/lost) differs")
    if not torch.equal(fin_k[fx.STEP], fin_p[fx.STEP]) or not torch.equal(fin_k[fx.LOST], fin_p[fx.LOST]):
        raise AssertionError(f"K1 {what}: step count or lost flag differs")
    # Tolerance: none. The two sides run the same float32 operations in
    # the same order (the kernel's branch-free divisions and floor-mods
    # keep a result only where they prove it exact, and redo the chunk
    # otherwise: tests/test_torch_fixup.py), and the card's sincosf and
    # expf against PyTorch's cos, sin and exp: every output and carry row
    # must be identical to the bit.
    worst = 0.0
    for name, a, b in (("outs", outs_k, outs_p), ("fin", fin_k, fin_p)):
        diff = (a - b).abs()
        worst = max(worst, float(diff.max()))
        if not torch.equal(a, b):
            rows_err = diff.amax(dim=(0, 2) if name == "outs" else 1)
            raise AssertionError(f"K1 {what} {name}: not identical to the bit, per-row max "
                                 f"error {rows_err.tolist()}")
    locked = int(outs_k[-1, fx.O_LOCKED].sum())
    log(f"K1 {what}: kernel == plain, identical to the bit (max |err| {worst:.3g}); "
        f"{locked}/{outs_k.shape[2]} channels locked at block end")
    return worst


def fixup_bound(corr_r, params) -> tuple[float, str]:
    """K1's bound: per ms and channel only the 2K+1 lags around the prompt
    of corr_r and corr_i (not all NLE), the outputs, and the carry in and
    out; ~110 operations of discriminators, EMAs and NCO updates besides
    the 2K+1 powers (3 ops) and the argmax compares."""
    from gypsum_tpu_torch.ops import fixup as fx

    (b_count, s_count, nle), n_lags = corr_r.shape, 2 * params.k_half + 1
    n_bytes = 4 * (2 * b_count * s_count * n_lags + b_count * fx.N_OUT * s_count
                   + 2 * fx.N_CARRY * s_count)
    n_ops = b_count * s_count * (4 * n_lags + 110)
    bound_ms, bound_by = bound(n_bytes, n_ops)
    log(f"K1 bound at [{b_count}, {s_count}, {nle}], {n_lags} lags read per ms and channel: "
        f"{bound_ms:.6f} ms ({bound_by}, {n_bytes} bytes)")
    return bound_ms, bound_by


def check_fixup(dev, sats, samples) -> dict:
    from gypsum_tpu_torch.core.config import TrackingConfig
    from gypsum_tpu_torch.ops import fixup as fx

    b_ms, n_ch = B_MS, N_CH
    worst = 0.0
    # K = 4 (the default; the kernel's unrolled instantiation) with both
    # measurements, and K = 2, which runs the generic instantiation.
    for meas, k_half in (("triangle", 4), ("hrc", 4), ("triangle", 2)):
        cfg = TrackingConfig(code_phase_measurement=meas, lag_window_half_width=k_half)
        bank, replicas = checks_bank(sats, dev, cfg)
        _, init, corr_r, corr_i = bank._fn.phase1(bank.state, samples, replicas)
        params = bank._fn.fixup_params
        if corr_r.shape != (b_ms, n_ch, 35 - 2 * (4 - k_half)):
            raise AssertionError(f"unexpected phase-1 shape {tuple(corr_r.shape)}")
        meas = f"{meas} K={k_half}"
        worst = max(worst, hold_fixup(meas, init, corr_r, corr_i, params))
        if meas == "triangle K=4":
            # The plain version (1000 Python steps, some 128 000 launches)
            # has just run: one call, no warm-up of its own.
            times = two_way({
                "kernel": (lambda: fx.fixup_cuda(init, corr_r, corr_i, params), 20, 2),
                "plain": (lambda: fx.fixup_reference(init, corr_r, corr_i, params), 1, 0),
            })
            bound_ms, bound_by = fixup_bound(corr_r, params)
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


def check_fixup_block_length(dev, sats, samples, b_ms: int) -> dict:
    """K1 at a campaign block length (200 or 500 ms: tools/campaign_torch.py
    draws both, the rescue scenes run at 500): the phase-1 correlations of
    the first ``b_ms`` ms of the synthetic block through ``hold_fixup`` (to
    the bit), timed both ways beside the plain version. The lag window
    narrows with the block (track/matmul.py:lag_window_size, its margin the
    block's worst code drift): [200, 12, 27] and [500, 12, 31]."""
    from gypsum_tpu_torch.core.config import TrackingConfig
    from gypsum_tpu_torch.ops import fixup as fx
    from gypsum_tpu_torch.track.matmul import lag_window_size

    cfg = TrackingConfig(block_size_ms=b_ms)
    bank, replicas = checks_bank(sats, dev, cfg)
    _, init, corr_r, corr_i = bank._fn.phase1(bank.state, samples[:b_ms], replicas)
    params = bank._fn.fixup_params
    shape = (b_ms, N_CH, lag_window_size(cfg, L))
    if corr_r.shape != shape:
        raise AssertionError(f"unexpected phase-1 shape {tuple(corr_r.shape)}, not {shape}")
    worst = hold_fixup(f"B={b_ms} {list(shape)}", init, corr_r, corr_i, params)
    times = two_way({
        "kernel": (lambda: fx.fixup_cuda(init, corr_r, corr_i, params), 20, 2),
        "plain": (lambda: fx.fixup_reference(init, corr_r, corr_i, params), 1, 0),
    })
    bound_ms, bound_by = fixup_bound(corr_r, params)
    return {
        "name": f"K1 fixup B={b_ms}",
        "shape": list(shape),
        "route": "cuda",
        "source": "gypsum_tpu_torch/csrc/fixup.cu",
        "replaces": "gypsum_tpu/ops/pallas_fixup.py:58",
        "max_abs_err": worst,
        **timing_keys(times),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
    }


FARM_STREAMS, FARM_CHANNELS = 8, 8  # bench.py:353's farm geometry, 64 channels


def farm_inputs(sats, samples):
    """The farm's block: 8 streams, each the kernel checks' 1000 ms block
    shifted by its own number of samples (whole ms plus n x 311), so each
    stream holds the 8 satellites at other code phases; each stream's 8
    channels pull in on them 3 Hz and half a sample off. Returns
    (stream_of_channel [64], state, [B, 8, L] complex, replicas [64, W])."""
    from gypsum_tpu_torch.core.config import TrackingConfig
    from gypsum_tpu_torch.signal.prn import replica_table
    from gypsum_tpu_torch.track.loop import fresh_state

    shifts = [n * (37 * L + 311) for n in range(FARM_STREAMS)]
    flat = samples.reshape(-1)
    streams = torch.stack([flat.roll(s).reshape(samples.shape) for s in shifts], dim=1)
    k = TrackingConfig().lag_window_half_width
    reps = replica_table(L)
    wide = np.concatenate([reps, reps, reps[:, : 2 * k]], axis=1).astype(np.float32)
    state = fresh_state(FARM_STREAMS * FARM_CHANNELS)
    for n, shift in enumerate(shifts):
        for j, s in enumerate(sats[:FARM_CHANNELS]):
            state.doppler[n * FARM_CHANNELS + j] = s.doppler_hz + 3.0
            state.code_phase[n * FARM_CHANNELS + j] = (s.delay_samples + shift) % L + 0.5
    prns = [s.prn for s in sats[:FARM_CHANNELS]] * FARM_STREAMS
    replicas = torch.from_numpy(wide[[p - 1 for p in prns]]).to(samples.device)
    stream_of_channel = np.repeat(np.arange(FARM_STREAMS), FARM_CHANNELS).astype(np.int32)
    return stream_of_channel, state, streams, replicas


def check_fixup_mesh(dev, sats, samples) -> dict:
    """K1 at the shapes scale-out gives it (K1 M): each shard's slice of a
    real 12-channel phase 1 at S = 6 (sat 2) and S = 3 (sat 4), and the
    farm's phase 1 at S = 64. Every slice identical to the bit to the plain
    version, and to the slice of K1 run on all 12 channels (K1 is one warp
    a channel: a shard changes its grid and its carry, not its sums)."""
    from gypsum_tpu_torch.core.config import TrackingConfig
    from gypsum_tpu_torch.ops import fixup as fx
    from gypsum_tpu_torch.track.loop import make_farm_track_block_fn

    cfg = TrackingConfig()
    bank, replicas = checks_bank(sats, dev, cfg)
    _, init, corr_r, corr_i = bank._fn.phase1(bank.state, samples, replicas)
    params = bank._fn.fixup_params
    fin_all, outs_all = fx.fixup_cuda(init, corr_r, corr_i, params)
    worst, shard6 = 0.0, None
    for n_sat in (2, 4):
        per = N_CH // n_sat
        for c in range(n_sat):
            cols = slice(c * per, (c + 1) * per)
            args = (init[:, cols].contiguous(), corr_r[:, cols].contiguous(),
                    corr_i[:, cols].contiguous())
            worst = max(worst, hold_fixup(f"shard {c} of sat {n_sat}, S={per}", *args, params))
            fin, outs = fx.fixup_cuda(*args, params)
            if not (torch.equal(outs, outs_all[:, :, cols]) and torch.equal(fin, fin_all[:, cols])):
                raise AssertionError(f"K1 on shard {c} of sat {n_sat} differs from its slice of "
                                     "K1 on all 12 channels")
            shard6 = shard6 or args
    log(f"K1 M: every shard of sat 2 and 4 identical to the bit to its slice of K1 on all "
        f"{N_CH} channels")
    soc, state, streams, farm_replicas = farm_inputs(sats, samples)
    farm = make_farm_track_block_fn(cfg, L, FS, len(soc), soc, device=dev)
    _, f_init, f_r, f_i = farm.phase1(state, streams, farm_replicas)
    worst = max(worst, hold_fixup(f"farm, S={len(soc)}", f_init, f_r, f_i, farm.fixup_params))
    times = two_way({
        "kernel": (lambda: fx.fixup_cuda(*shard6, params), 20, 2),
        "plain": (lambda: fx.fixup_reference(*shard6, params), 1, 0),
    })
    bound_ms, bound_by = fixup_bound(shard6[1], params)
    return {
        "name": "K1 fixup at a mesh shard (S=6) and the farm (S=64)",
        "route": "cuda",
        "source": "gypsum_tpu_torch/csrc/fixup.cu",
        "replaces": "gypsum_tpu/ops/pallas_fixup.py:58",
        "max_abs_err": worst,
        **timing_keys(times),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
    }


def check_farm(dev, sats, samples) -> int:
    """``make_farm_track_block_fn`` at bench.py:353's geometry (8 streams x
    8 channels, one 1000 ms block) against each stream tracked alone, with
    tests/test_farm.py's bars; K1's launches around each. Returns the farm
    block's K1 launches."""
    from gypsum_tpu_torch.core.config import TrackingConfig
    from gypsum_tpu_torch.ops.fixup import FIXUP_KERNEL
    from gypsum_tpu_torch.track.loop import make_farm_track_block_fn, make_track_block_fn

    soc, state, streams, replicas = farm_inputs(sats, samples)
    cfg = TrackingConfig()
    farm = make_farm_track_block_fn(cfg, L, FS, len(soc), soc, device=dev)
    single = make_track_block_fn(cfg, L, FS, FARM_CHANNELS, device=dev)
    farm(state, streams, replicas)  # warm: the first call pays cuBLAS's set-up
    torch.cuda.synchronize()
    FIXUP_KERNEL.launches = 0
    t0 = time.perf_counter()
    s_farm, o_farm = farm(state, streams, replicas)
    torch.cuda.synchronize()
    farm_ms, farm_launches = 1e3 * (time.perf_counter() - t0), FIXUP_KERNEL.launches
    FIXUP_KERNEL.launches = 0
    alone_s, identical = 0.0, True
    worst = {"doppler": 0.0, "code_phase": 0.0, "prompt_i": 0.0}
    for n in range(FARM_STREAMS):
        cols = slice(n * FARM_CHANNELS, (n + 1) * FARM_CHANNELS)
        st = type(state)(*(a[cols] for a in state))
        t0 = time.perf_counter()
        s1, o1 = single(st, streams[:, n].contiguous(), replicas[cols])
        torch.cuda.synchronize()
        alone_s += time.perf_counter() - t0
        for field, got, want, rtol, atol in (
            ("doppler", s_farm.doppler[cols], s1.doppler, 1e-6, 0.0),
            ("code_phase", s_farm.code_phase[cols], s1.code_phase, 1e-6, 0.0),
            ("prompt_i", o_farm.prompt_i[:, cols], o1.prompt_i, 1e-5, 1e-2),
        ):
            err = float((got - want).abs().max())
            worst[field] = max(worst[field], err)
            if not torch.allclose(got, want, rtol=rtol, atol=atol):
                raise AssertionError(f"farm stream {n}: {field} differs from the stream tracked "
                                     f"alone by up to {err:.3g} (rtol {rtol}, atol {atol})")
        if not torch.equal(o_farm.locked[:, cols], o1.locked):
            raise AssertionError(f"farm stream {n}: locked differs from the stream tracked alone")
        identical &= all(torch.equal(a[cols], b) for a, b in zip(s_farm, s1)) and all(
            torch.equal(a[:, cols], b) for a, b in zip(o_farm, o1))
    locked = int(o_farm.locked[-1].sum())
    if farm_launches != 1 or FIXUP_KERNEL.launches != FARM_STREAMS:
        raise AssertionError(f"farm launched K1 {farm_launches} times, the streams alone "
                             f"{FIXUP_KERNEL.launches}")
    log(f"farm: make_farm_track_block_fn, {FARM_STREAMS} streams x {FARM_CHANNELS} channels, "
        f"one 1000 ms block: equals each stream tracked alone"
        f"{', identical to the bit' if identical else ''} (max |diff| doppler "
        f"{worst['doppler']:.3g} Hz, code phase {worst['code_phase']:.3g} samples, prompt_i "
        f"{worst['prompt_i']:.3g}; locked equal; {locked}/{len(soc)} locked at block end); "
        f"{farm_ms:.3f} ms for the farm's block, {1e3 * alone_s:.3f} ms for the 8 streams alone "
        f"(host clock, synchronized); K1 launches: farm {farm_launches}, alone {FARM_STREAMS}")
    return farm_launches


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


def conflict_model_ms(n_out: int, t_len: int, factor: int) -> tuple[float, float]:
    """K5's first design (one thread per output, 256 per block, the tile
    interleaved as float2 in shared memory) under a model of shared-memory
    wavefronts: each tap is one 8-byte load per lane, ``max(2, gcd(2
    factor, 32))`` wavefronts for a warp whose lanes lie ``8 factor`` bytes
    apart, plus one for the broadcast read of the tap, at one wavefront per
    clock on each of the 132 SMs. Returns the predicted ms at 1.755 and at
    1.98 GHz."""
    from math import gcd

    warps = -(-n_out // 256) * 8
    wavefronts = warps * t_len * (max(2, gcd(2 * factor, 32)) + 1)
    return tuple(wavefronts / (132 * clock) * 1e3 for clock in (1.755e9, 1.98e9))


def hold_fir_decimate(x, taps, factor: int) -> float:
    """K5 against its plain version on ``x`` [N, 2]; returns max |err|."""
    from gypsum_tpu_torch.ops import fir_decimate as k5

    n, t_len = x.shape[0], len(taps)
    y_k = k5.fir_decimate_cuda(x, taps, factor)
    y_p = k5.fir_decimate_reference(x, taps, factor)
    torch.cuda.synchronize()
    if y_k.shape != y_p.shape or y_k.shape[0] != (n - t_len) // factor + 1:
        raise AssertionError(f"K5 shape {tuple(y_k.shape)} vs plain {tuple(y_p.shape)} at N={n}")
    err = float((y_k - y_p).abs().max())
    # Tolerance: up to 97 taps, rtol 1e-4 and atol 1e-5 of the input
    # scale (1.0), the bar of the JAX package's decimator tests: float32
    # sums in another order than the convolution's. For longer filters
    # each of the two sums lies within T 2^-24 sum|taps| max|x| of the
    # exact one, so they lie within twice that of each other.
    if t_len <= 97:
        ok = torch.allclose(y_k, y_p, rtol=1e-4, atol=1e-5)
        bar = "rtol 1e-4, atol 1e-5"
    else:
        tol = 2 * t_len * 2.0**-24 * float(taps.abs().sum()) * float(x.abs().max())
        ok = err <= tol
        bar = f"atol {tol:.3g} = 2 T 2^-24 sum|taps| max|x|"
    if not ok:
        raise AssertionError(f"K5 differs at N={n}, factor {factor}, {t_len} taps: "
                             f"max |err| {err:.3g} ({bar})")
    return err


def time_fir_decimate(x, taps, factor: int) -> dict:
    """K5's timing keys at ``x`` [N, 2], beside its plain version and
    ``F.conv1d``, with its bound."""
    import torch.nn.functional as F

    from gypsum_tpu_torch.ops import fir_decimate as k5

    n, t_len = x.shape[0], len(taps)
    n_out = (n - t_len) // factor + 1
    v = x.T[:, None, :].contiguous()
    w = taps.flip(0)[None, None, :]
    bound_ms, bound_by = bound(4 * (2 * n + 2 * n_out + t_len), 2 * t_len * 2 * n_out)
    lo, hi = conflict_model_ms(n_out, t_len, factor)
    log(f"K5 fir_decimate [{n}, 2] / {factor}, {t_len} taps: bound {bound_ms:.4f} ms "
        f"({bound_by}); the one-thread-per-output design under the shared-memory "
        f"wavefront model: {lo:.4f}-{hi:.4f} ms at 1.98-1.755 GHz")
    # The library call: one float32 strided convolution (TF32 is off,
    # core/device.py) on planes already laid out [2, 1, N], with the taps
    # reversed once, outside the timing.
    timed = dict(**timing_keys(two_way({
        "plain": (lambda: k5.fir_decimate_reference(x, taps, factor), 20, 2),
        "kernel": (lambda: k5.fir_decimate_cuda(x, taps, factor), 20, 2),
        "library": (lambda: F.conv1d(v, w, stride=factor), 20, 2),
    })), bound_ms=bound_ms, bound_by=bound_by)
    log(f"K5 at factor {factor}: device {timed['ms']:.5f} ms, "
        f"{100 * bound_ms / timed['ms']:.1f} % of its bound")
    return timed


def check_fir_decimate(dev) -> dict:
    from gypsum_tpu_torch.ops import fir_decimate as k5
    from gypsum_tpu_torch.ops.decimate import decimation_filter

    g = torch.Generator(device=dev).manual_seed(5)
    worst = 0.0
    timed = {}
    asymmetric = np.linspace(0.1, 1.0, 13, dtype=np.float32)
    # (N, factor, taps, samples skipped at the start of the storage): one
    # 1000 ms block as the streaming source hands it over (history + block
    # + tail) at the gnu_radio_8x, gnu_radio_16x and 10.23 Msps rates; odd
    # lengths, a factor that does not divide the filter span, N == T; an
    # asymmetric filter, which shows the direction the taps run in; a view
    # 8 bytes into its storage, which at factor 8 takes the kernel's
    # one-phase rows (two-phase rows need 16-byte aligned samples).
    cases = [(8_184_000 + 48 + 50, 4, None, 0), (16_368_000 + 96 + 98, 8, None, 0),
             (10_230_000 + 60 + 62, 5, None, 0), (12_345, 4, None, 0), (4_099, 8, None, 0),
             (1_001, 5, None, 0), (1_000, 2, None, 0), (49, 4, None, 0), (97, 8, None, 0),
             (100_003, 3, asymmetric, 0), (4_099, 8, None, 1)]
    # Long filters, which the first design's wrapper refused (it has no
    # launch plan; a copy of this script in a checkout of that commit skips
    # them): the
    # package's default filter at factor 120 (1441 taps) and a filter of 128
    # taps per phase, the TPU kernel's limit, at factor 66 (8383 taps).
    if hasattr(k5, "launch_plan"):
        cases += [(2_000_003, 120, None, 0),
                  (2_000_003, 66, decimation_filter(66, taps_per_phase=127), 0)]
    for n, factor, taps, skip in cases:
        taps = torch.from_numpy(decimation_filter(factor) if taps is None else taps).to(dev)
        x = torch.randn((n + skip, 2), device=dev, generator=g)[skip:]
        worst = max(worst, hold_fir_decimate(x, taps, factor))
        if n > 8_000_000:
            timed[factor] = time_fir_decimate(x, taps, factor)
        del x
    log(f"K5 fir_decimate: kernel == plain on {len(cases)} cases (max |err| {worst:.3g})")
    # The main path's block (factor 4) under the plain keys; the 16.368 and
    # 10.23 Msps blocks under the same keys with _f8 and _f5.
    return {
        "name": "K5 fir_decimate",
        "route": "cuda",
        "source": "gypsum_tpu_torch/csrc/fir_decimate.cu",
        "replaces": "gypsum_tpu/ops/pallas_kernels.py:63",
        "max_abs_err": worst,
        **timed[4],
        **{f"{key}_f{f}": value for f in (8, 5) for key, value in timed[f].items()},
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

    planes = to_planes(samples).contiguous()
    worst, worst_rel = 0.0, 0.0
    # K = 4 (the default; the kernel's unrolled instantiation), timed, and
    # K = 3, which runs the generic instantiation.
    for k_half in (4, 3):
        cfg = TrackingConfig(lag_window_half_width=k_half)
        bank, replicas = checks_bank(sats, dev, cfg, off_air=False)
        params = tb.TrackBlockParams.from_config(cfg, L, FS)
        state = device_state(bank.state, dev)
        rows = torch.stack([*carry_rows(state), torch.zeros(N_CH, device=dev)]).contiguous()
        nle = 2 * params.k_eff + 1
        fin_k, outs_k = tb.track_block_cuda(rows, planes, replicas, params)
        again = tb.track_block_cuda(rows, planes, replicas, params)
        fin_p, outs_p = tb.track_block_reference(rows, planes, replicas, params)
        torch.cuda.synchronize()
        what = f"K3 K={k_half}"
        if outs_k.shape != (B_MS, fx.N_OUT, N_CH) or fin_k.shape != (tb.N_CARRY, N_CH):
            raise AssertionError(f"{what} shapes {tuple(outs_k.shape)}, {tuple(fin_k.shape)}")
        for name, t in (("kernel outs", outs_k), ("kernel carry", fin_k), ("plain outs", outs_p)):
            if not bool(torch.isfinite(t).all()):
                raise AssertionError(f"{what} {name}: non-finite values")
        if not (torch.equal(again[0], fin_k) and torch.equal(again[1], outs_k)):
            raise AssertionError(f"{what}: two runs on the same inputs differ")
        for row in (fx.O_LOCKED, fx.O_LOST):
            if not torch.equal(outs_k[:, row], outs_p[:, row]):
                n_diff = int((outs_k[:, row] != outs_p[:, row]).sum())
                raise AssertionError(f"{what}: output row {row} (locked/lost) differs at {n_diff} places")
        for row in (fx.STEP, fx.LOST, fx.CPI0):
            if not torch.equal(fin_k[row], fin_p[row]):
                raise AssertionError(f"{what}: carry row {row} (step/lost/window center) differs")
        # Tolerance: the JAX package's own bar for this kernel against its
        # scan, 2e-3 of each row's scale on the carry and 5e-3 on the outputs.
        # The multiply-reduce over 2046 samples sums in another order than
        # the plain version's, and 1000 ms of loop filter integrate the
        # difference.
        for name, a, b, tol in (("outs", outs_k, outs_p, 5e-3), ("fin", fin_k, fin_p, 2e-3)):
            dims = (0, 2) if name == "outs" else 1
            scale = b.abs().amax(dim=dims).clamp(min=1.0)
            rows_err = (a - b).abs().amax(dim=dims)
            if bool((rows_err > tol * scale).any()):
                raise AssertionError(
                    f"{what} {name}: per-row max error {rows_err.tolist()} at scale {scale.tolist()}")
            worst = max(worst, float(rows_err.max()))
            worst_rel = max(worst_rel, float((rows_err / scale).max()))
        locked = int(outs_k[-1, fx.O_LOCKED].sum())
        log(f"{what} track_block [{B_MS}, {L}, 2] x {N_CH} channels, NLE {nle}: kernel == plain "
            f"(locked/lost/step/window centre exact; max |err| so far {worst:.3g}, {worst_rel:.3g} "
            f"of row scale; bars 5e-3 outputs, 2e-3 carry; two runs equal to the bit); "
            f"{locked}/{N_CH} channels locked at block end")
        if k_half == 4:
            # The plain version (1000 Python steps) has just run: one call,
            # no warm-up of its own.
            timed_params = params
            times = two_way({
                "kernel": (lambda: tb.track_block_cuda(rows, planes, replicas, params), 5, 2),
                "plain": (lambda: tb.track_block_reference(rows, planes, replicas, params), 1, 0),
            })
    params = timed_params
    # Bytes: the block's samples and the S windows once, the outputs, the
    # carry in and out. Operations: per ms and channel, the 2 (2K+1) dot
    # products of L multiply-adds that the function needs (the loop filter
    # reads only the 2K+1 lags around the prompt, as K1's bound counts them,
    # not all NLE of the window), and ~12 L for the wipeoff.
    n_lags = 2 * params.loop.k_half + 1
    n_bytes = 4 * (2 * B_MS * L + N_CH * (L + 2 * params.k_eff) + B_MS * fx.N_OUT * N_CH
                   + 2 * tb.N_CARRY * N_CH)
    n_ops = B_MS * N_CH * (2 * n_lags * L * 2 + 12 * L)
    bound_ms, bound_by = bound(n_bytes, n_ops)
    log(f"K3 bound at [{B_MS}, {L}, 2] x {N_CH} channels, {n_lags} lags: {bound_ms:.4f} ms "
        f"({bound_by}, {n_ops / 1e9:.2f} GFLOP)")
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


# ------------------------------------------------------ GLONASS kernel checks


FS_GLO, L_GLO = 4.092e6, 4092  # the GLONASS processing rate: 4092 samples per ms
GLO_START_SOW = 21618.0  # a GLONASS frame boundary at t = 0 (tests/test_glonass_receiver.py)
GLO_OFFSET_S = 8e-7  # the scenes' GPS-GLONASS time offset, which the receiver solves
GLO_KS = [-2, -1, 0, 1, 2]


def glonass_band(band: str) -> tuple[float, float]:
    """(base Hz, channel spacing Hz) of the L1OF ("l1") or L2OF ("l2") band."""
    from gypsum_tpu_torch.core import constants as c

    if band == "l1":
        return c.GLONASS_L1_BASE_HZ, c.GLONASS_L1_CHANNEL_SPACING_HZ
    return c.GLONASS_L2_BASE_HZ, c.GLONASS_L2_CHANNEL_SPACING_HZ


def glonass_block(band: str, dev):
    """The GLONASS kernel checks' 1000 ms block: the first second of the
    5-channel (k = -2..2) GLONASS-only scene in ``band`` at 4.092 Msps.
    Returns (satellites, truth, [B, L] complex on dev)."""
    from gypsum_tpu_torch.signal.constellation import synthesize_constellation
    from gypsum_tpu_torch.signal.scenarios import demo_glonass_constellation, demo_receiver_ecef

    sats = demo_glonass_constellation(GLO_KS)
    iq, truth = synthesize_constellation(
        sats, demo_receiver_ecef(), GLO_START_SOW, 1.0, FS_GLO, noise_sigma=0.25,
        glonass_time_offset_s=GLO_OFFSET_S, glonass_band=band,
    )
    return sats, truth, torch.from_numpy(iq.reshape(B_MS, L_GLO)).to(dev)


def glonass_bank(band: str, sats, truth, dev, config=None):
    """A 12-channel GLONASS bank in ``band``, set up as the Receiver sets
    up its band (aiding carrier, 511 chips, offset-relative Doppler, each
    channel at its sub-band offset): the 5 on-air channels 3 Hz and half a
    sample off the truth, and the 7 FDMA ids k = -7..-3, 3, 4 on noise, so
    that both odd and even k run. Returns (bank, replica rows on dev)."""
    import dataclasses

    from gypsum_tpu_torch.core.config import TrackingConfig
    from gypsum_tpu_torch.signal.prn import GLONASS_PRN_IDS, glonass_frequency_number
    from gypsum_tpu_torch.track.loop import TrackerBank

    base_hz, spacing_hz = glonass_band(band)
    cfg = dataclasses.replace(config or TrackingConfig(), aiding_carrier_hz=base_hz,
                              chips_per_code=511)
    bank = TrackerBank(FS_GLO, L_GLO, cfg, n_channels=N_CH, prns=GLONASS_PRN_IDS, device=dev)
    on_air = [s.prn for s in sats]
    for prn in on_air:
        off = glonass_frequency_number(prn) * spacing_hz
        bank.assign(prn, truth.doppler_hz[prn] - off + 3.0, truth.code_phase_samples[prn] + 0.5,
                    0.0, carrier_offset_hz=off)
    for prn in [p for p in GLONASS_PRN_IDS if p not in on_air][: N_CH - len(on_air)]:
        bank.assign(prn, 300.0, 1000.0, 0.0,
                    carrier_offset_hz=glonass_frequency_number(prn) * spacing_hz)
    prn_idx = np.array([bank._prn_row[p] for p in bank.slot_prn])
    return bank, bank._device_replicas(prn_idx)


def check_fixup_glonass(dev, blocks) -> dict:
    """K1 on a real phase-1 pass over each band's block: NLE 43 (L1OF) and
    49 (L2OF), 12 channels at FDMA offsets with odd and even k (for odd k
    the offset's advance per ms is +/-0.5 cycle up to float32 rounding, so
    the kernel's rintf and PyTorch's round must break ties alike)."""
    from gypsum_tpu_torch.ops import fixup as fx

    worst = 0.0
    for band, nle in (("l1", 43), ("l2", 49)):
        sats, truth, samples = blocks[band]
        bank, replicas = glonass_bank(band, sats, truth, dev)
        _, init, corr_r, corr_i = bank._fn.phase1(bank.state, samples, replicas)
        params = bank._fn.fixup_params
        if corr_r.shape != (B_MS, N_CH, nle):
            raise AssertionError(f"unexpected GLONASS phase-1 shape {tuple(corr_r.shape)}")
        ks = torch.round(init[fx.OFF] / glonass_band(band)[1]).to(torch.int64)
        if not (bool((ks % 2 == 1).any()) and bool((ks[ks != 0] % 2 == 0).any())):
            raise AssertionError(f"GLONASS {band}: offsets {ks.tolist()} lack odd or even k")
        frac = fx.offset_cycle_fraction(init[fx.OFF], params.t_ms)
        log(f"K1 GLONASS {band.upper()}OF: k {ks.tolist()}, offset advance per ms mod 1 cycle "
            f"{[round(v, 6) for v in frac.tolist()]}")
        what = f"GLONASS {band.upper()}OF NLE {nle}"
        worst = max(worst, hold_fixup(what, init, corr_r, corr_i, params))
        if band == "l1":
            times = two_way({
                "kernel": (lambda: fx.fixup_cuda(init, corr_r, corr_i, params), 20, 2),
                "plain": (lambda: fx.fixup_reference(init, corr_r, corr_i, params), 1, 0),
            })
            bound_ms, bound_by = fixup_bound(corr_r, params)
    return {
        "name": "K1 fixup, GLONASS L1OF [1000, 12, 43] (L2OF NLE 49 held too)",
        "route": "cuda",
        "source": "gypsum_tpu_torch/csrc/fixup.cu",
        "replaces": "gypsum_tpu/ops/pallas_fixup.py:58",
        "max_abs_err": worst,
        **timing_keys(times),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
    }


def check_peak_reduce_glonass(dev, samples) -> dict:
    """K2 on the real FDMA coarse grid: 14 channels x 29 Dopplers flattened
    into [406, 4092] rows; then the engine's coarse peak, whose Doppler bin
    is picked over each channel's 29 rows with the lowest index on ties, by
    both routes."""
    from gypsum_tpu_torch.acquire.engine import AcquisitionEngine, coarse_peak
    from gypsum_tpu_torch.ops.correlate import noncoherent_acquisition_sweep
    from gypsum_tpu_torch.ops.peak_reduce import peak_reduce_cuda, peak_reduce_reference
    from gypsum_tpu_torch.signal.prn import GLONASS_PRN_IDS, glonass_frequency_number

    spacing = glonass_band("l1")[1]
    eng = AcquisitionEngine(
        FS_GLO, L_GLO, prns=GLONASS_PRN_IDS, device=dev,
        center_offsets_hz=tuple(glonass_frequency_number(p) * spacing for p in GLONASS_PRN_IDS),
    )
    noncoh = noncoherent_acquisition_sweep(
        samples[:10], eng.sweep_dopplers, eng.prn_fft_conj, FS_GLO)
    grid = noncoh.reshape(-1, L_GLO).contiguous()
    if grid.shape != (406, 4092):
        raise AssertionError(f"unexpected FDMA grid shape {tuple(grid.shape)}")
    mk, ak, sk = peak_reduce_cuda(grid)
    mp, ap, sp = peak_reduce_reference(grid)
    torch.cuda.synchronize()
    if not (torch.equal(mk, mp) and torch.equal(ak, ap)):
        raise AssertionError("K2 max/argmax differ on the FDMA grid")
    # Sum: rtol 1e-5, as on the GPS grid (float32 sums in another order).
    if not torch.allclose(sk, sp, rtol=1e-5, atol=0.0):
        raise AssertionError("K2 sum differs on the FDMA grid")
    worst = float((sk - sp).abs().max())
    grid3 = grid.view(len(GLONASS_PRN_IDS), -1, L_GLO)
    d_k, cp_k, st_k = coarse_peak(grid3, True)
    d_p, cp_p, st_p = coarse_peak(grid3, False)
    if not (torch.equal(d_k, d_p) and torch.equal(cp_k, cp_p)) or not torch.allclose(
            st_k, st_p, rtol=1e-5):
        raise AssertionError(f"coarse peak on the FDMA grid: K2 route {d_k.tolist()} "
                             f"{cp_k.tolist()}, plain {d_p.tolist()} {cp_p.tolist()}")
    rows, n = grid.shape
    bound_ms, bound_by = bound(4 * rows * n + 12 * rows, 2 * rows * n)
    log(f"K2 peak reduce on the GLONASS FDMA grid [406, 4092]: argmax/max exact, sum max |err| "
        f"{worst:.3g}; coarse peak by K2 == plain on 14 channels (Doppler bins "
        f"{d_k.tolist()}); bound {bound_ms:.5f} ms ({bound_by})")
    times = two_way({
        "plain": (lambda: peak_reduce_reference(grid), 200, 2),
        "kernel": (lambda: peak_reduce_cuda(grid), 200, 2),
        "library": (lambda: (torch.max(grid, dim=1), grid.sum(dim=1)), 200, 2),
        "empty": (lambda: EMPTY_KERNEL.launch(51, 256), 200, 2),
    })
    return {
        "name": "K2 peak_reduce, GLONASS FDMA grid [406, 4092]",
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


def check_wipeoff_lag_glonass(dev, blocks) -> dict:
    """K4 at L = 4092 with the banks' wipe frequencies: each channel's
    offset-relative Doppler plus its k x 562.5 kHz (L2OF: 437.5 kHz)
    sub-band, up to 3.94 MHz, on three chunks of each band's block."""
    from gypsum_tpu_torch.core.config import TrackingConfig
    from gypsum_tpu_torch.ops.wipeoff_lag import wipeoff_lag_cuda, wipeoff_lag_reference

    k_half = TrackingConfig().lag_window_half_width
    n_lags = 2 * k_half + 1
    worst, scale, f_max = 0.0, 0.0, 0.0
    for band in ("l1", "l2"):
        sats, truth, samples = blocks[band]
        bank, replicas = glonass_bank(band, sats, truth, dev)
        st = bank.state
        freq = st.doppler + st.carrier_offset
        f_max = max(f_max, float(np.abs(freq).max()))
        base = np.mod(L_GLO - np.floor(st.code_phase).astype(np.int64) - k_half, L_GLO)
        for ms, theta in ((0, st.carrier_phase), (1, st.carrier_phase + 1.7), (999, st.carrier_phase)):
            chunk_iq = torch.stack([samples[ms].real, samples[ms].imag]).contiguous()
            params = torch.from_numpy(
                np.stack([theta, freq, base.astype(np.float32)], axis=-1).astype(np.float32)
            ).to(dev)
            args = (chunk_iq, replicas, params, L_GLO, n_lags, 1.0 / FS_GLO)
            err, scale = hold_wipeoff_lag(args, f"GLONASS {band} ms {ms}")
            worst = max(worst, err)
            if band == "l1" and ms == 0:
                timed_args = args
    args = timed_args
    times = two_way({
        "plain": (lambda: wipeoff_lag_reference(*args), 50, 2),
        "kernel": (lambda: wipeoff_lag_cuda(*args), 200, 2),
        "empty": (lambda: EMPTY_KERNEL.launch(96, 512), 200, 2),
    })
    n_bytes = 4 * (2 * L_GLO + N_CH * (L_GLO + 2 * k_half) + 3 * N_CH + 2 * N_CH * n_lags)
    bound_ms, bound_by = bound(n_bytes, N_CH * L_GLO * (12 + 4 * n_lags))
    log(f"K4 wipeoff_lag GLONASS [{N_CH}, {replicas.shape[1]}], {n_lags} lags, wipe frequencies "
        f"up to {f_max / 1e6:.4f} MHz: kernel == plain on 3 chunks of each band's block (max "
        f"|err| {worst:.3g} at scale {scale:.3g}; bar 1e-4 of scale), two runs equal to the "
        f"bit; bound {bound_ms:.6f} ms ({bound_by})")
    return {
        "name": "K4 wipeoff_lag, GLONASS L1OF [12, 2, 9] from [2, 4092] at MHz",
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


def check_fir_decimate_glonass(dev) -> dict:
    """K5 at factor 2 with its default filter, on one 1000 ms block of an
    8.184 Msps GLONASS capture as the streaming source hands it over
    (history + block + tail) on its way to 4.092 Msps."""
    from gypsum_tpu_torch.ops.decimate import decimation_filter

    taps = torch.from_numpy(decimation_filter(2)).to(dev)
    t_len = len(taps)
    n = 8_184_000 + -(-(t_len - 1) // 2) * 2 + t_len + 1
    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn((n, 2), device=dev, generator=g)
    err = hold_fir_decimate(x, taps, 2)
    log(f"K5 fir_decimate GLONASS 8.184 -> 4.092 Msps [{n}, 2] / 2, {t_len} taps: kernel == "
        f"plain (max |err| {err:.3g}; rtol 1e-4, atol 1e-5)")
    return {
        "name": f"K5 fir_decimate, GLONASS factor 2 [{n}, 2]",
        "route": "cuda",
        "source": "gypsum_tpu_torch/csrc/fir_decimate.cu",
        "replaces": "gypsum_tpu/ops/pallas_kernels.py:63",
        "max_abs_err": err,
        **time_fir_decimate(x, taps, 2),
    }


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


def synthesize_named(name: str) -> np.ndarray:
    """The IQ of one of the replays' scenes (numpy on the host, no device):
    the GPS scene at 2.046 and 8.184 Msps; the GLONASS-only scene of
    tests/test_glonass_receiver.py (13 s; at 8.184 Msps cut to 11 s, its
    first fix lands at 9 s); the GPS + GLONASS pair of that file's
    dual-band test (24 s, k = -2, 0, 2); the iono-loaded L1OF + L2OF
    pair of tests/test_dualfreq.py (16 s); the 38 s deep-fade scene of
    tests/test_deepcoast.py:181-198 (PRNs 25/28/31/32/3 faded to 0.03 over
    23-33 s, clock drift 2e-8, noise 0.35); the 25 s, 5-PRN CW-jammed scene
    of tests/test_interference.py:151-186; and the 23 s, 4-element array
    scene of tests/test_beamform.py:129-153 with its broadband jammer."""
    from gypsum_tpu_torch.signal.constellation import synthesize_constellation
    from gypsum_tpu_torch.signal.scenarios import (
        DEMO_GPS_START_SOW,
        demo_constellation,
        demo_glonass_constellation,
        demo_iono_page18,
        demo_receiver_ecef,
    )
    from gypsum_tpu_torch.solve.geodesy import lla_to_ecef
    from gypsum_tpu_torch.solve.iono import IonoUtcParams

    if name in ("gps", "gps_8x"):
        return synthesize_scene(FS if name == "gps" else FS_FAST)[1]
    rx = demo_receiver_ecef()
    glo = dict(noise_sigma=0.25, glonass_time_offset_s=GLO_OFFSET_S)
    if name in ("glonass", "glonass_8x"):
        rate, seconds = (FS_GLO, 13.0) if name == "glonass" else (FS_FAST, 11.0)
        sats = demo_glonass_constellation(GLO_KS)
        return synthesize_constellation(sats, rx, GLO_START_SOW, seconds, rate, **glo)[0]
    if name == "dual_gps":
        return synthesize_constellation(demo_constellation(SCENE_PRNS), rx, GLO_START_SOW,
                                        24.0, FS, noise_sigma=0.3)[0]
    if name == "dual_glonass":
        return synthesize_constellation(demo_glonass_constellation([-2, 0, 2]), rx,
                                        GLO_START_SOW, 24.0, FS_GLO, **glo)[0]
    if name == "fade":
        sats = demo_constellation(FADE_PRNS)
        for sat in sats:
            sat.faded_s = [(DEEP_FADE[0], DEEP_FADE[1], 0.03)]
        return synthesize_constellation(sats, lla_to_ecef(*TRUTH_LLA), DEMO_GPS_START_SOW, 38.0,
                                        FS, noise_sigma=0.35, receiver_clock_drift=2e-8)[0]
    if name in ("iono_l1", "iono_l2"):
        iono = IonoUtcParams.from_page(demo_iono_page18())
        return synthesize_constellation(demo_glonass_constellation(GLO_KS), rx, GLO_START_SOW,
                                        16.0, FS_GLO, noise_sigma=0.25, iono=iono,
                                        glonass_band=name[-2:])[0]
    if name == "notch":
        from gypsum_tpu_torch.signal.constellation import RfImpairments, apply_rf_impairments
        from gypsum_tpu_torch.signal.scenarios import DEMO_PRNS_8

        iq, _ = synthesize_constellation(demo_constellation(DEMO_PRNS_8[:5]), lla_to_ecef(*TRUTH_LLA),
                                         DEMO_GPS_START_SOW, 25.0, FS, noise_sigma=0.25)
        return apply_rf_impairments(iq, FS, RfImpairments(cw_amplitude=NOTCH_CW[0],
                                                          cw_freq_hz=NOTCH_CW[1]))
    if name.startswith("rtk_"):
        return synthesize_rtk(name)
    if name == "array":
        from gypsum_tpu_torch.signal.array import ArrayJammer, synthesize_array

        jam = ArrayJammer(azimuth_deg=ARRAY_JAMMER[0], elevation_deg=ARRAY_JAMMER[1],
                          amplitude=6.0, kind="noise", bandwidth_hz=1.4e6)
        return synthesize_array(demo_constellation(SCENE_PRNS), lla_to_ecef(*TRUTH_LLA),
                                DEMO_GPS_START_SOW, 23.0, FS, noise_sigma=0.3, jammer=jam)[0]
    raise ValueError(f"no scene {name!r}")


RTK_PRNS = [25, 28, 31, 32, 3, 7]  # signal/scenarios.py:DEMO_PRNS_8[:6]
RTK_ENU = (11.0, -7.5, 2.0)  # tests/test_rtk.py:246: the rover's offset from the base, m
RTK_SECONDS = 24.0  # the capture-mode runs (--duration): ~19-20 s to decode the orbits
RTK_EXPORT_SECONDS = 60.0  # the RINEX-mode pair: ~40 exported epochs for the fix
RTK_CLOCK = (2.37e-3, 2e-8)  # tests/test_rtk.py:410-411: the rover's start offset s, drift


def synthesize_rtk(name: str) -> np.ndarray:
    """The rtk pairs of tests/test_rtk.py:223-270 and :386-449 (the six
    demo PRNs, noise 0.25, the base at ``TRUTH_LLA``): the base and the
    rover at ``RTK_ENU`` for ``RTK_EXPORT_SECONDS`` (the capture-mode runs
    read their first ``RTK_SECONDS``, which equal a capture of that length),
    and the rover on its own clock for ``RTK_SECONDS``."""
    from gypsum_tpu_torch.signal.constellation import synthesize_constellation
    from gypsum_tpu_torch.signal.scenarios import DEMO_GPS_START_SOW, demo_constellation
    from gypsum_tpu_torch.solve.geodesy import enu_basis, lla_to_ecef

    base = lla_to_ecef(*TRUTH_LLA)
    rover = base + np.asarray(RTK_ENU) @ np.stack(enu_basis(base))
    rx, sow, seconds, drift = {
        "rtk_base": (base, DEMO_GPS_START_SOW, RTK_EXPORT_SECONDS, 0.0),
        "rtk_rover": (rover, DEMO_GPS_START_SOW, RTK_EXPORT_SECONDS, 0.0),
        "rtk_clock": (rover, DEMO_GPS_START_SOW + RTK_CLOCK[0], RTK_SECONDS, RTK_CLOCK[1]),
    }[name]
    return synthesize_constellation(demo_constellation(RTK_PRNS), rx, sow, seconds, FS,
                                    noise_sigma=0.25, receiver_clock_drift=drift)[0]


def synthesize_to(name: str, path: str) -> float:
    """Worker process: synthesize scene ``name`` into ``path`` (.npy, or
    for a campaign capture tools/campaign_torch.py's .npz); returns the
    seconds it took."""
    if name.startswith("campaign_"):
        from tools import campaign_torch as twin

        return twin.synthesize_to(campaign_spec(name), path)
    t0 = time.perf_counter()
    np.save(path, synthesize_named(name))
    return time.perf_counter() - t0


class Scenes:
    """The replays' scenes, synthesized in worker processes (spawned, no
    CUDA) into ``directory`` while the kernels are built and checked; the
    host's synthesis is most of this script's time when run in turn."""

    def __init__(self, names: list[str], directory: str) -> None:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        self.directory = Path(directory)
        workers = max(1, min(len(names), (os.cpu_count() or 2) - 2))
        self._pool = ProcessPoolExecutor(
            max_workers=workers, mp_context=multiprocessing.get_context("spawn"))
        self._futures = {n: self._pool.submit(synthesize_to, n, str(self.path(n))) for n in names}
        log(f"scenes: synthesizing {', '.join(names)} in {workers} worker processes")

    def path(self, name: str) -> Path:
        return self.directory / f"{name}.npy"

    def get(self, name: str) -> np.ndarray:
        t0 = time.perf_counter()
        seconds = self._futures[name].result()
        log(f"scene {name}: synthesized in {seconds:.1f} s (host, worker process; waited "
            f"{time.perf_counter() - t0:.1f} s for it)")
        return np.load(self.path(name))

    def get_campaign(self, name: str) -> tuple[dict, dict, float]:
        """A campaign capture's (arrays, facts, seconds its synthesis took)."""
        from tools import campaign_torch as twin

        t0 = time.perf_counter()
        seconds = self._futures[name].result()
        log(f"scene {name}: synthesized in {seconds:.1f} s (host, worker process; waited "
            f"{time.perf_counter() - t0:.1f} s for it)")
        return (*twin.load_synthesized(self.path(name)), seconds)

    def close(self) -> None:
        self._pool.shutdown(wait=True, cancel_futures=True)


PRELOAD_STARTED = re.compile(r"preload: started (.+)$", re.MULTILINE)
LIBRARY_LOADED = re.compile(r"library (\w+): (preloaded|loaded at first use), (built|cached) in "
                            r"([\d.]+) s; first use waited ([\d.]+) s")
PRELOAD_CHECKS = []  # [path, preloaded, launched] of each path held, printed at the end


def hold_preloads(label: str, preloaded, launched) -> None:
    """Each library the path preloaded was used (a kernel launched, the
    native reader opened) in its run, and each it used was preloaded."""
    preloaded, launched = sorted(set(preloaded)), sorted(set(launched))
    if preloaded != launched:
        raise AssertionError(f"{label}: preloaded {preloaded}, launched {launched}")
    PRELOAD_CHECKS.append([label, preloaded, launched])


@contextlib.contextmanager
def preload_window(label: str):
    """``hold_preloads`` over what runs in the ``with`` block, in this
    process: the requests the paths' preload sites made (core/aot.py) against
    the kernels launched and the native reader's opens."""
    from gypsum_tpu_torch.core import aot

    requests, uses, before = Counter(aot.requests), Counter(aot.uses), launches()
    yield
    after = launches()
    launched = {KERNELS[k].source for k in after if after[k] > before[k]}
    if aot.uses[aot.NATIVE_READER] > uses[aot.NATIVE_READER]:
        launched.add(aot.NATIVE_READER)
    hold_preloads(label, [n for n in aot.requests if aot.requests[n] > requests[n]], launched)


def cli_libraries(stderr: str) -> dict:
    """What a CLI process's log says of its libraries (core/aot.py's lines):
    {"preloaded": names whose preload started, "loads": {name: (how, built
    or cached, seconds, seconds its first use waited)}}."""
    started = [n.strip() for line in PRELOAD_STARTED.findall(stderr) for n in line.split(",")]
    loads = {m[0]: (m[1], m[2], float(m[3]), float(m[4])) for m in LIBRARY_LOADED.findall(stderr)}
    return {"preloaded": started, "loads": loads}


def run_cli(capture: Path, rx: np.ndarray, *extra: str, root: Path = ROOT,
            env: dict | None = None, label: str = "") -> dict:
    """``python -m gypsum_tpu_torch replay --file capture --until-fix`` in a
    process of its own, from the checkout at ``root``: its fix held within
    100 m of truth, and its libraries to ``hold_preloads`` (preloaded ==
    used, none built at first use while preloads are on). Returns its wall
    from spawn to exit, the fix's error and ``cli_libraries``."""
    from gypsum_tpu_torch.solve.geodesy import lla_to_ecef

    env = {**os.environ, **(env or {})}
    env["PYTHONPATH"] = str(root) + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "gypsum_tpu_torch", "replay", "--file", str(capture),
         "--until-fix", *extra],
        cwd=root, env=env, capture_output=True, text=True, timeout=300,
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
    libs = cli_libraries(proc.stderr)
    label = f"CLI replay {label or ' '.join(extra)}".strip()
    how = {load[0] for load in libs["loads"].values()}
    if env.get("GYPSUM_AOT", "1") != "0":
        if how - {"preloaded"}:
            raise AssertionError(f"{label}: a library loaded at first use with the preload "
                                 f"on:\n{proc.stderr[-3000:]}")
        hold_preloads(label, libs["preloaded"], libs["loads"])
    elif libs["preloaded"] or how - {"loaded at first use"}:
        raise AssertionError(f"{label}: a preload ran under GYPSUM_AOT=0:\n{proc.stderr[-3000:]}")
    else:
        PRELOAD_CHECKS.append([label, [], sorted(libs["loads"])])
    log(f"e2e CLI: replay --until-fix {' '.join(extra)} printed FIX lat={lat} lon={lon} "
        f"alt={alt:.0f}m, {err:.2f} m from truth, {wall:.1f} s wall (process start included)")
    return {"wall": wall, "err": err, **libs}


def timed_run(recv) -> float:
    """Run ``recv`` (a Receiver or DualBandReceiver) to the end of its
    stream; returns the wall seconds. ``recv.collect`` then summarizes the
    host ms per block spent in ``TrackerBank.collect_block`` (waiting for
    the block's outputs, then building its observations) of every band."""
    bands = getattr(recv, "_bands", [recv])
    collect_s = []
    for band in bands:
        def timed_collect(collect=band.bank.collect_block):
            t = time.perf_counter()
            out = collect()
            collect_s.append(time.perf_counter() - t)
            return out

        band.bank.collect_block = timed_collect
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    recv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ms = 1e3 * np.asarray(collect_s)
    recv.collect = (f"collect_block mean {ms.mean():.3f}, median {np.median(ms):.3f}, "
                    f"max {ms.max():.3f} ms per block")
    return wall


def run_receiver(iq: np.ndarray, rx: np.ndarray, dev, peak_kernel: bool = False,
                 source=None, correlator: str | None = None, **tracking):
    """One in-process replay of ``iq`` at 2.046 Msps (or of ``source``), with
    ``tracking`` fields set on the default TrackingConfig (``timed_run``)."""
    import dataclasses

    from gypsum_tpu_torch.core.config import AcquisitionConfig, ReceiverConfig
    from gypsum_tpu_torch.io.sources import ArraySampleSource
    from gypsum_tpu_torch.runtime.receiver import Receiver

    cfg = ReceiverConfig()
    if peak_kernel or correlator:
        cfg = cfg.replace(acquisition=AcquisitionConfig(
            use_pallas_peak_reduce=True if peak_kernel else None, correlator=correlator))
    cfg = cfg.replace(tracking=dataclasses.replace(cfg.tracking, **tracking))
    # A caller that opens its own source holds its preloads itself.
    window = (preload_window(f"Receiver {tracking} peak_kernel={peak_kernel} "
                             f"correlator={correlator}") if source is None
              else contextlib.nullcontext())
    with window:
        recv = Receiver(source if source is not None else ArraySampleSource(iq, FS), cfg,
                        device=dev)
        wall = timed_run(recv)
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
SMI = []  # the card's "name, power limit" line from nvidia-smi, set by main()
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


def check_same_tracking(name: str, recv, acq, ref_recv, ref_acq, prns=SCENE_PRNS) -> str:
    """``recv`` against the default run: the same acquisitions and > 99.9 %
    pseudosymbol sign agreement per PRN of ``prns``."""
    if [a[:4] for a in acq] != [a[:4] for a in ref_acq]:
        raise AssertionError(f"{name}: acquisitions differ from the default run:\n{acq}\n{ref_acq}")
    got, want = signs_by_prn(recv), signs_by_prn(ref_recv)
    agreement = {}
    for prn in prns:
        if got[prn].shape != want[prn].shape:
            raise AssertionError(
                f"{name}: PRN {prn} has {len(got[prn])} pseudosymbols, the default run {len(want[prn])}")
        agreement[prn] = float(np.mean(got[prn] == want[prn]))
        if agreement[prn] <= 0.999:
            raise AssertionError(f"{name}: PRN {prn} sign agreement {agreement[prn]:.4%} with the default run")
    return ", ".join(f"PRN {p} {100 * a:.2f} % of {len(got[p])}" for p, a in agreement.items())


# ------------------------------------------------------------ GLONASS e2e


GLO_PRNS = [208 + k for k in GLO_KS]  # channel ids of k = -2..2
FIX_LINE = re.compile(r"FIX lat=(-?[\d.]+) lon=(-?[\d.]+) alt=(-?\d+)m.*?"
                      r"(?: isb=([+-][\d.]+)ns)? sats=\(([\d, ]*)\)")


def run_glonass_receiver(iq: np.ndarray, dev, peak_kernel: bool = False, **tracking):
    """The GLONASS-only scene through ``Receiver(band="glonass")``, with
    ``tracking`` fields set on the default TrackingConfig, held to the bars
    of tests/test_glonass_receiver.py:26-48: a fix by 11 s, every fix within
    15 m on >= 4 GLONASS satellites, the last within 5 m and static within
    0.5 m/s, >= 4 strings per channel. Returns (recv, acquisitions, fix
    errors m, wall s)."""
    import dataclasses

    from gypsum_tpu_torch.core.config import AcquisitionConfig, ReceiverConfig
    from gypsum_tpu_torch.io.sources import ArraySampleSource
    from gypsum_tpu_torch.runtime.receiver import Receiver
    from gypsum_tpu_torch.signal.scenarios import demo_receiver_ecef

    cfg = ReceiverConfig()
    if peak_kernel:
        cfg = cfg.replace(acquisition=AcquisitionConfig(use_pallas_peak_reduce=True))
    cfg = cfg.replace(tracking=dataclasses.replace(cfg.tracking, **tracking))
    with preload_window(f"GLONASS Receiver {tracking} peak_kernel={peak_kernel}"):
        recv = Receiver(ArraySampleSource(iq, FS_GLO), cfg, band="glonass", device=dev)
        wall = timed_run(recv)
    rx = demo_receiver_ecef()
    fixes = recv.world.position_fixes
    if not fixes or fixes[0].receiver_timestamp > 11.0:
        raise AssertionError(f"GLONASS-only: first fix at "
                             f"{fixes[0].receiver_timestamp if fixes else None} s (bar 11 s)")
    errs = [float(np.linalg.norm(f.ecef - rx)) for f in fixes]
    for f, err in zip(fixes, errs):
        if err >= 15.0 or len(f.satellites_used) < 4 or not all(
                201 <= p <= 214 for p in f.satellites_used):
            raise AssertionError(f"GLONASS-only fix at {f.receiver_timestamp} s: {err:.2f} m, "
                                 f"satellites {f.satellites_used}")
    if errs[-1] >= 5.0 or np.linalg.norm(fixes[-1].velocity_ecef_mps) >= 0.5:
        raise AssertionError(f"GLONASS-only last fix {errs[-1]:.2f} m, velocity "
                             f"{fixes[-1].velocity_ecef_mps}")
    n_strings = sum(len(r.glonass_strings) for r in recv.block_reports)
    if n_strings < 4 * len(GLO_KS):
        raise AssertionError(f"GLONASS-only: {n_strings} strings decoded")
    acq = [(h.prn, h.code_phase_samples, h.doppler_hz, h.carrier_phase_rad, h.strength)
           for r in recv.block_reports for h in r.newly_acquired]
    if {a[0] for a in acq} < set(GLO_PRNS):
        raise AssertionError(f"acquired {sorted(a[0] for a in acq)}, scene has {GLO_PRNS}")
    recv.n_strings = n_strings
    return recv, acq, errs, wall


def run_cli_here(*argv: str, command: str = "replay", options: tuple = ()) -> tuple[str, float]:
    """``python -m gypsum_tpu_torch <options> <command> ...`` run in this
    process (the CLI's own ``main``), so that the kernels' launch counts see
    it. Returns (its standard output, wall s)."""
    import io
    import logging

    from gypsum_tpu_torch.cli.main import main as cli_main

    out = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), preload_window(
            f"CLI {command} {' '.join(Path(a).name if '/' in a else a for a in argv)}"):
        rc = cli_main([*options, command, *argv])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    logging.getLogger().setLevel(logging.WARNING)  # the CLI turned on INFO for its run
    if rc != 0:
        raise AssertionError(f"CLI {command} {' '.join(argv)} returned {rc}:\n{out.getvalue()[-3000:]}")
    return out.getvalue(), wall


def cli_fixes(text: str) -> list[tuple[np.ndarray, float | None, tuple[int, ...]]]:
    """(ECEF, inter-system bias s or None, satellites) of each FIX line."""
    from gypsum_tpu_torch.solve.geodesy import lla_to_ecef

    return [
        (lla_to_ecef(float(lat), float(lon), float(alt)),
         float(isb) * 1e-9 if isb else None,
         tuple(int(p) for p in sats.split(",") if p.strip()))
        for lat, lon, alt, isb, sats in FIX_LINE.findall(text)
    ]


def processed_blocks(text: str) -> int:
    """1000 ms blocks the CLI reports as processed."""
    m = re.search(r"processed ([\d.]+)s", text)
    if m is None:
        raise AssertionError(f"CLI printed no 'processed' line:\n{text[-2000:]}")
    return round(float(m.group(1)))


def run_glonass_replays(dev, scenes: "Scenes", g1: dict, g2: dict, g4: dict, g5: dict) -> None:
    """The GLONASS bands end to end on the card, each kernel's launches
    counted around each run (the counts set to 0 just before it and read
    just after): the GLONASS-only scene through Receiver(band="glonass")
    (K1), with the K2 peak reduce, and with the per-ms scan tracker through
    K4; the same scene at 8.184 Msps through the CLI (K5); GPS + GLONASS
    through the CLI; and GLONASS L1OF + L2OF through DualBandReceiver."""
    from gypsum_tpu_torch.core.config import ReceiverConfig
    from gypsum_tpu_torch.io.sources import ArraySampleSource
    from gypsum_tpu_torch.runtime.receiver import DualBandReceiver, Receiver
    from gypsum_tpu_torch.signal.scenarios import demo_receiver_ecef

    rx = demo_receiver_ecef()
    iq = scenes.get("glonass")
    reset_launches()
    recv, acq, errs, wall = run_glonass_receiver(iq, dev)
    n = launches()
    g1["launches"] = n["K1"]
    blocks = round(recv.source.seconds_consumed)
    if n["K1"] != blocks or n["K2"] != 0:
        raise AssertionError(f"GLONASS-only replay of {blocks} blocks launched {n}")
    log(f"e2e GLONASS-only Receiver(band='glonass', device='cuda'), default config: "
        f"{len(errs)} fixes, first at {recv.world.position_fixes[0].receiver_timestamp:.1f} s, "
        f"best {min(errs):.2f} m, last {errs[-1]:.2f} m; {recv.n_strings} strings; "
        f"{wall:.2f} s wall for {recv.source.seconds_consumed:.0f} s of signal; launches {n}; "
        f"{recv.collect}")
    glonass_recv = recv

    reset_launches()
    recv_b, acq_b, errs_b, wall_b = run_glonass_receiver(iq, dev, peak_kernel=True)
    n = launches()
    g2["launches"] = n["K2"]
    if n["K2"] == 0 or n["K1"] == 0:
        raise AssertionError(f"the GLONASS peak-reduce run launched {n}")
    if [a[:4] for a in acq] != [b[:4] for b in acq_b] or not np.allclose(
            [a[4] for a in acq], [b[4] for b in acq_b], rtol=1e-5):
        raise AssertionError(f"GLONASS acquisitions differ with K2:\n{acq}\n{acq_b}")
    log(f"e2e GLONASS-only, use_pallas_peak_reduce=True: identical acquisitions "
        f"({len(acq_b)} channels); {len(errs_b)} fixes, last {errs_b[-1]:.2f} m; "
        f"{wall_b:.2f} s wall; launches {n}")

    reset_launches()
    recv_c, acq_c, errs_c, wall_c = run_glonass_receiver(
        iq, dev, use_matmul_tracker=False, use_pallas_block_tracker=False,
        use_pallas_correlator=True)
    n = launches()
    g4["launches"] = n["K4"]
    if n["K4"] != 1000 * blocks or n["K1"] != 0 or n["K3"] != 0:
        raise AssertionError(f"GLONASS K4 scan replay of {blocks} blocks launched {n}")
    agree = check_same_tracking("GLONASS K4 scan", recv_c, acq_c, glonass_recv, acq, GLO_PRNS)
    log(f"e2e GLONASS-only, scan tracker with use_pallas_correlator=True: {len(errs_c)} fixes, "
        f"last {errs_c[-1]:.2f} m; acquisitions as the default run; sign agreement {agree}; "
        f"{wall_c:.2f} s wall; launches {n}")
    del recv_b, recv_c

    iq_fast = scenes.get("glonass_8x")
    reset_launches()
    out, wall = run_cli_here("--glonass-file", str(scenes.path("glonass_8x")),
                             "--glonass-rate", f"{FS_FAST:.0f}", "--until-fix")
    n = launches()
    g5["launches"] = n["K5"]
    blocks = processed_blocks(out)
    fixes = cli_fixes(out)
    if n["K5"] < blocks or n["K1"] == 0 or not fixes:
        raise AssertionError(f"GLONASS 8.184 Msps CLI replay: {blocks} blocks, {len(fixes)} "
                             f"fixes, launches {n}:\n{out[-2000:]}")
    errs = [float(np.linalg.norm(f[0] - rx)) for f in fixes]
    if max(errs) >= 15.0:
        raise AssertionError(f"GLONASS 8.184 Msps CLI fixes {errs} m from truth (bar 15 m)")
    log(f"e2e CLI replay --glonass-file (8.184 Msps, {iq_fast.nbytes / 1e9:.2f} GB) "
        f"--glonass-rate 8184000 --until-fix: FIX {errs[-1]:.2f} m from truth after {blocks} "
        f"blocks; {wall:.2f} s wall; launches {n}")
    del iq_fast

    scenes.get("dual_gps"), scenes.get("dual_glonass")
    reset_launches()
    out, wall = run_cli_here("--file", str(scenes.path("dual_gps")),
                             "--glonass-file", str(scenes.path("dual_glonass")))
    n = launches()
    blocks = processed_blocks(out)
    fixes = cli_fixes(out)
    if not fixes or n["K1"] != 2 * blocks:
        raise AssertionError(f"GPS + GLONASS CLI replay: {len(fixes)} fixes, {blocks} blocks, "
                             f"launches {n}:\n{out[-2000:]}")
    ecef, isb, sats = fixes[-1]
    err = float(np.linalg.norm(ecef - rx))
    gps, glo = [p for p in sats if p <= 32], [p for p in sats if p >= 201]
    if err >= 5.0 or len(gps) != 4 or len(glo) != 3 or isb is None or abs(isb + GLO_OFFSET_S) >= 250e-9:
        raise AssertionError(f"GPS + GLONASS last fix: {err:.2f} m, satellites {sats}, isb {isb}")
    log(f"e2e CLI replay --file --glonass-file (GPS + GLONASS, 24 s): {len(fixes)} fixes, last "
        f"{err:.2f} m on {len(gps)} GPS + {len(glo)} GLONASS, isb {isb * 1e9:+.1f} ns (injected "
        f"offset -{GLO_OFFSET_S * 1e9:.0f} ns, bar 250 ns); {wall:.2f} s wall; launches {n}")

    l1, l2 = scenes.get("iono_l1"), scenes.get("iono_l2")
    dual = DualBandReceiver(None, ArraySampleSource(l1, FS_GLO),
                            glonass_l2_source=ArraySampleSource(l2, FS_GLO), device=dev)
    reset_launches()
    wall = timed_run(dual)
    n = launches()
    fixes = dual.world.position_fixes
    blocks = round(dual.glonass.source.seconds_consumed)
    if not fixes or n["K1"] != 2 * blocks:
        raise AssertionError(f"L1OF + L2OF: {len(fixes)} fixes, {blocks} blocks, launches {n}")
    last = fixes[-1]
    err = float(np.linalg.norm(last.ecef - rx))
    iono = last.iono_measured_m or {}
    if err >= 5.0 or len(iono) < 4 or not all(2.0 < v < 40.0 for v in iono.values()):
        raise AssertionError(f"L1OF + L2OF last fix: {err:.2f} m, measured iono {iono}")
    log(f"e2e DualBandReceiver(L1OF + L2OF, --iono scene, 16 s, device='cuda'): {len(fixes)} "
        f"fixes, last {err:.2f} m, measured iono {np.mean(list(iono.values())):.1f} m mean on "
        f"{len(iono)} satellites; {wall:.2f} s wall; launches {n}; {dual.collect}")
    track_ms, acq_ms = block_timings(glonass_recv, iq)
    log(f"timing GLONASS: one 1000 ms tracking block (NLE 43, phase 1 + K1) {track_ms:.3f} ms; "
        f"one 10 ms FDMA acquisition sweep [406, 4092] {acq_ms:.3f} ms")
    profile_run(lambda: Receiver(ArraySampleSource(iq, FS_GLO), ReceiverConfig(), band="glonass",
                                 device=dev))


def block_timings(recv, iq: np.ndarray) -> tuple[float, float]:
    """Issue ms of one 1000 ms tracking block (phase 1 + K1 + glue) at the
    receiver's channel binding, and of one 10 ms acquisition sweep."""
    bank, length = recv.bank, recv.samples_per_prn
    block = torch.from_numpy(np.ascontiguousarray(iq[: 1000 * length].reshape(1000, length))).to(bank.device)
    prn_idx = np.array([bank._prn_row[p] if p is not None else 0 for p in bank.slot_prn])
    replicas = bank._device_replicas(prn_idx)
    bank.sync_host_state()
    state = bank.state
    track_ms = issue_ms(lambda: bank._fn.packed(state, block, replicas), 5)
    x10 = torch.from_numpy(np.ascontiguousarray(iq[: 10 * length].reshape(10, length))).to(bank.device)
    acq_ms = issue_ms(lambda: recv.acquisition(x10), 5)
    return track_ms, acq_ms


def profile_run(make_receiver) -> None:
    """One more replay, of the receiver ``make_receiver()`` builds, under
    torch.profiler: the device's busy share of the wall time and the kernels
    that take it (the profiler's own overhead lengthens the wall time and it
    may lose records, ``device_ms``, so the share is a lower bound)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    recv = make_receiver()
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
    log(f"profile: {recv.band} replay of {recv.source.seconds_consumed:.0f} s of signal, wall "
        f"{wall * 1e3:.1f} ms under the profiler, device busy {busy_ms:.2f} ms "
        f"({100 * busy_ms / (wall * 1e3):.1f} %)")
    for e in sorted(events, key=lambda e: -e.device_time_total)[:10]:
        log(f"profile:   {e.device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")


# ------------------------------------ deep search, deep coast, checkpoints


DEEP_FADE = (23.0, 33.0)  # tests/test_deepcoast.py: PRNs faded to 0.03 over 23-33 s
FADE_PRNS = [25, 28, 31, 32, 3]
# The JAX receiver with pipeline_tracking=True (the card's and the TPU's
# default; tests/test_deepcoast.py runs unpipelined, on the CPU backend) on
# the fade scene: its in-fade lsq fix errors (m) by epoch, and the 6 of its
# 17 protection levels that do not bound them. A fault of the reference
# (its coast anchor one block off, ROADMAP.md §C1), repaired in the port,
# whose pipelined replay is held to the unpipelined bars; logged beside the
# port's for the record, and checked on the CPU by
# tests/test_torch_deepcoast.py::test_pipelined_fade_reference_of_chip_smoke.
FADE_PIPELINED_REFERENCE = {28.0: 192.14, 29.0: 152.32, 30.0: 129.11, 31.0: 108.19,
                            32.0: 93.86, 33.0: 83.06}
FADE_PIPELINED_PL_MISSES = 6
# The snapshot phase's priors: ~40 km and 4 s off (tests/test_snapshot.py:80-113).
SNAPSHOT_OFFSET_M = (-30e3, 20e3, 15e3)
SNAPSHOT_DT_S = 4.0
# With the fade replay's 5 orbits the snapshot solve is exactly determined
# (residual 0): the JAX CLI, on the same capture with a JAX checkpoint of the
# same replay and these priors, prints this fix, 536 m from truth (outside
# tests/test_snapshot.py's 400 m bar, which it holds on 8 satellites; no
# priors do better). The card is held to it:
# tests/test_torch_deepcoast.py::test_fade_snapshot_reference_of_chip_smoke
# checks this value against the JAX CLI on the CPU.
SNAPSHOT_REFERENCE = (51.496925, -0.094137, 10.0)


def deep_scene():
    """The default deep search's input: the eight demo satellites from the
    demo start time, 250 ms at 2.046 Msps (host numpy), and their truth."""
    from gypsum_tpu_torch.signal.constellation import synthesize_constellation
    from gypsum_tpu_torch.signal.scenarios import (
        DEMO_GPS_START_SOW,
        DEMO_PRNS_8,
        demo_constellation,
        demo_receiver_ecef,
    )

    return synthesize_constellation(demo_constellation(DEMO_PRNS_8), demo_receiver_ecef(),
                                    DEMO_GPS_START_SOW, 0.25, FS, noise_sigma=0.35, seed=4)


def check_peak_reduce_deep(dev, iq, truth) -> dict:
    """K2 at the deep sweep's shape: the [32 PRNs x 8 Doppler bins, 2046]
    accumulator of a default 200 ms search (acquire/deep.py), the chunk that
    holds PRN 25's Doppler; max and argmax exact, the sum within 1e-6 of the
    largest row sum, two runs equal to the bit."""
    from gypsum_tpu_torch.acquire.deep import DeepAcquisitionEngine
    from gypsum_tpu_torch.ops.peak_reduce import peak_reduce_cuda, peak_reduce_reference

    eng = DeepAcquisitionEngine(FS, L, device=dev)
    x = torch.from_numpy(np.ascontiguousarray(iq[: 200 * L].reshape(200, L))).to(dev)
    c = eng.config.doppler_chunk
    start = int(np.argmin(np.abs(eng.dopplers - truth.doppler_hz[25]))) // c * c
    chunk = eng.dopplers[start:start + c]
    acc = eng.accumulate(x, torch.from_numpy(chunk).to(dev),
                         torch.from_numpy(eng._roll_indices(chunk).astype(np.int64)).to(dev))
    grid = acc.reshape(-1, L).contiguous()
    if grid.shape != (256, 2046):
        raise AssertionError(f"unexpected deep accumulator shape {tuple(grid.shape)}")
    mk, ak, sk = peak_reduce_cuda(grid)
    mk2, ak2, sk2 = peak_reduce_cuda(grid)
    mp, ap, sp = peak_reduce_reference(grid)
    torch.cuda.synchronize()
    if not (torch.equal(mk, mp) and torch.equal(ak, ap)):
        raise AssertionError("K2 max/argmax differ on the deep accumulator")
    if not (torch.equal(mk, mk2) and torch.equal(ak, ak2) and torch.equal(sk, sk2)):
        raise AssertionError("K2 gave two answers on the deep accumulator")
    scale = float(sp.abs().max())
    worst = float((sk - sp).abs().max())
    # Sum: 1e-6 of the largest row sum (float32 sums of 2046 positive terms
    # in another order).
    if worst > 1e-6 * scale:
        raise AssertionError(f"K2 sum on the deep accumulator off by {worst:.3g} of {scale:.3g}")
    row = 8 * eng.prns.index(25) + int(np.argmin(np.abs(chunk - truth.doppler_hz[25])))
    rows, n = grid.shape
    bound_ms, bound_by = bound(4 * rows * n + 12 * rows, 2 * rows * n)
    log(f"K2 peak reduce on the deep accumulator [256, 2046] (200 ms, bins {chunk[0]:+.0f}.."
        f"{chunk[-1]:+.0f} Hz): argmax/max exact, two runs equal, sum max |err| {worst:.3g} of "
        f"{scale:.4g}; PRN 25's row peaks at code phase {int(ak[row])} (truth "
        f"{truth.code_phase_samples[25]:.2f}); bound {bound_ms:.5f} ms ({bound_by})")
    times = two_way({
        "plain": (lambda: peak_reduce_reference(grid), 200, 2),
        "kernel": (lambda: peak_reduce_cuda(grid), 200, 2),
        "library": (lambda: (torch.max(grid, dim=1), grid.sum(dim=1)), 200, 2),
        "empty": (lambda: EMPTY_KERNEL.launch(32, 256), 200, 2),
    })
    return {
        "name": "K2 peak_reduce, deep sweep [256, 2046]",
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


def deep_split(eng, x) -> tuple[dict, dict]:
    """One default deep search's sweep, stage by stage: the Doppler
    wipeoff, the forward FFTs, the group sums, the product with the replica
    FFTs, the inverse FFTs, |.| + roll gather + group accumulation, and K2.
    Returns (ms per stage between CUDA events around each stage, summed over
    the chunks: the device's timeline, the host's issue gaps included;
    ms per stage of one chunk alone, its calls replayed from a CUDA graph,
    ``device_ms``, times the chunk count). The stages are
    acquire/deep.py:DeepAcquisitionEngine.accumulate's, held equal to it to
    the bit on the first chunk."""
    from gypsum_tpu_torch.ops.correlate import doppler_wipeoff
    from gypsum_tpu_torch.ops.peak_reduce import peak_reduce

    cfg = eng.config
    c = cfg.doppler_chunk
    n_chunks = -(-len(eng.dopplers) // c)
    s_count = eng._prn_fft_conj.shape[0]
    events, device, out = {}, {}, {}
    for start in range(0, len(eng.dopplers), c):
        chunk = eng.dopplers[start:start + c]
        chunk = np.concatenate([chunk, np.repeat(chunk[-1:], c - len(chunk))])
        d = torch.from_numpy(chunk).to(x.device)
        roll = torch.from_numpy(eng._roll_indices(chunk).astype(np.int64)).to(x.device)
        idx = roll.permute(1, 0, 2)[None].expand(s_count, -1, -1, -1)
        # Each stage reads the one before it from ``out``.
        steps = [
            ("wipeoff", lambda: doppler_wipeoff(x, d, eng.sample_rate)),
            ("fft", lambda: torch.fft.fft(out["wipeoff"], dim=-1)),
            ("group sum", lambda: out["fft"].reshape(c, eng.n_groups, cfg.coherent_ms, L).sum(dim=2)),
            ("product", lambda: out["group sum"][None] * eng._prn_fft_conj[:, None, None, :]),
            ("ifft", lambda: torch.fft.ifft(out["product"], dim=-1)),
            ("abs+gather+sum", lambda: torch.gather(out["ifft"].abs(), -1, idx).sum(dim=2)),
            ("K2", lambda: peak_reduce(out["abs+gather+sum"].reshape(-1, L))),
        ]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(steps) + 1)]
        ev[0].record()
        for i, (name, step) in enumerate(steps):
            out[name] = step()
            ev[i + 1].record()
        torch.cuda.synchronize()
        for i, (name, _) in enumerate(steps):
            events[name] = events.get(name, 0.0) + ev[i].elapsed_time(ev[i + 1])
        if start == 0:
            if not torch.equal(out["abs+gather+sum"], eng.accumulate(x, d, roll)):
                raise AssertionError("the timed stages do not compute the engine's accumulator")
            device = {name: n_chunks * device_ms(step, 5) for name, step in steps}
    return events, device


def run_deep_searches(dev, scenes: "Scenes", k2d: dict) -> None:
    """Deep acquisition on the card, K2's launches counted around each
    search: the weak PRN 7 scene of tests/test_deep_acquire.py (400 ms, 4 kHz
    span; the 10 ms engine blind, the deep engine on code phase 512 within
    5 Hz, PRN 3 below the threshold); a default 200 ms search over all 32
    PRNs on the eight demo satellites, timed per search, per chunk and by
    stage; deep_acquire_glonass on the GLONASS-only scene, its on-air
    channels on the 10 ms FDMA engine's code phases."""
    from gypsum_tpu_torch.acquire.deep import DeepAcquisitionEngine, deep_acquire_glonass
    from gypsum_tpu_torch.acquire.engine import AcquisitionEngine
    from gypsum_tpu_torch.core.config import AcquisitionConfig, DeepAcquisitionConfig
    from gypsum_tpu_torch.signal.prn import GLONASS_PRN_IDS, glonass_frequency_number
    from gypsum_tpu_torch.signal.synth import SyntheticSatellite, synthesize_iq

    sats = [SyntheticSatellite(prn=7, doppler_hz=1743.0, delay_samples=512, amplitude=0.012)]
    weak = synthesize_iq(sats, 400 * L, FS, noise_sigma=0.3, seed=5).reshape(400, L)
    std = AcquisitionEngine(FS, L, AcquisitionConfig(correlator="fft"), prns=(7, 3), device=dev)
    std7 = {r.prn: r for r in std.acquire_all(weak[:10])}[7].strength
    if std7 >= 3.0:
        raise AssertionError(f"the 10 ms engine sees the weak PRN 7 (strength {std7:.2f})")
    deep = DeepAcquisitionEngine(FS, L, DeepAcquisitionConfig(total_ms=400, doppler_span_hz=4000.0),
                                 prns=(7, 3), device=dev)
    reset_launches()
    hits = {r.prn: r for r in deep.acquire_all(weak)}
    n = launches()
    chunks = -(-len(deep.dopplers) // deep.config.doppler_chunk)
    h7, h3 = hits[7], hits[3]
    if n["K2"] != chunks:
        raise AssertionError(f"the weak deep search of {chunks} chunks launched {n}")
    if (h7.code_phase_samples != 512 or abs(h7.doppler_hz - 1743.0) >= 5.0
            or h7.strength <= deep.detection_threshold or h3.strength >= deep.detection_threshold):
        raise AssertionError(f"weak deep search: PRN 7 {h7}, PRN 3 {h3}, threshold "
                             f"{deep.detection_threshold:.3f}")
    log(f"deep search, weak PRN 7 (amplitude 0.012, 400 ms, +/-4 kHz): the 10 ms engine blind "
        f"(strength {std7:.2f} < 3.0); deep: code phase {h7.code_phase_samples}, Doppler "
        f"{h7.doppler_hz:.2f} Hz (truth 1743), strength {h7.strength:.2f}; PRN 3 "
        f"{h3.strength:.2f} < threshold {deep.detection_threshold:.3f}; launches {n}")

    iq, truth = deep_scene()
    eng = DeepAcquisitionEngine(FS, L, device=dev)
    x = torch.from_numpy(np.ascontiguousarray(iq[: 200 * L].reshape(200, L))).to(dev)
    eng.acquire_all(x)  # cuFFT plans and the first allocations
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.acquire_all(x)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    n = launches()
    chunks = -(-len(eng.dopplers) // eng.config.doppler_chunk)
    k2d["launches"] = n["K2"]
    if n["K2"] != chunks:
        raise AssertionError(f"the default deep search of {chunks} chunks launched {n}")
    found = {r.prn: r for r in res if r.strength > eng.detection_threshold}
    for prn, cp in truth.code_phase_samples.items():
        r = found.get(prn)
        if r is None or abs((r.code_phase_samples - cp + L / 2) % L - L / 2) > 1.0:
            raise AssertionError(f"default deep search: PRN {prn} {r} (truth code phase {cp:.2f})")
    events, device = deep_split(eng, x)

    def shares(split):
        total = sum(split.values())
        fft_ms = split["fft"] + split["ifft"]
        return (f"{total:.2f} ms: " + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
                + f"; FFTs {fft_ms:.3f} ms ({100 * fft_ms / total:.1f} %)")

    log(f"deep search, default (200 ms, 10 ms groups, +/-7 kHz / 50 Hz: {len(eng.dopplers)} bins "
        f"in {chunks} chunks of 8, 32 PRNs): the 8 satellites on the air found on their code "
        f"phases; {wall_ms:.2f} ms per search (host clock, synchronized), {wall_ms / chunks:.3f} "
        f"ms per chunk; launches {n}; the sweep by stage, between events (the device's "
        f"timeline, the host's issue gaps in it) {shares(events)}; by stage, device alone "
        f"(CUDA graph, x {chunks} chunks) {shares(device)}")

    glo = scenes.get("glonass")
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    deep_glo = {r.prn: r for r in deep_acquire_glonass(glo[: 200 * L_GLO], FS_GLO, L_GLO,
                                                        device=dev)}
    wall_glo = time.perf_counter() - t0
    n = launches()
    k2d["launches_glonass_search"] = n["K2"]
    if n["K2"] != len(GLONASS_PRN_IDS) * chunks:
        raise AssertionError(f"the GLONASS deep search launched {n}")
    spacing = glonass_band("l1")[1]
    fdma = AcquisitionEngine(FS_GLO, L_GLO, prns=GLONASS_PRN_IDS, device=dev,
                             center_offsets_hz=tuple(glonass_frequency_number(p) * spacing
                                                     for p in GLONASS_PRN_IDS))
    std_glo = {r.prn: r for r in fdma.acquire_all(glo[: 10 * L_GLO].reshape(10, L_GLO))}
    threshold = 1.0 + DeepAcquisitionConfig().detection_k / np.sqrt(20)
    for prn in GLO_PRNS:
        a, b = deep_glo[prn], std_glo[prn]
        if (a.strength <= threshold or b.strength <= 3.0
                or abs((a.code_phase_samples - b.code_phase_samples + L_GLO / 2) % L_GLO
                       - L_GLO / 2) > 1):
            raise AssertionError(f"GLONASS deep {a} against the 10 ms FDMA engine {b}")
    log(f"deep search, GLONASS (deep_acquire_glonass, 14 channels x 200 ms, f64 pre-rotation): "
        f"the {len(GLO_PRNS)} channels on the air on the 10 ms FDMA engine's code phases "
        f"({', '.join(f'{p}: {deep_glo[p].code_phase_samples}' for p in GLO_PRNS)}); "
        f"{wall_glo:.2f} s wall; launches {n}")


def fade_config(**tracking):
    """The TrackingConfig of tests/test_deepcoast.py:_run on the default
    ReceiverConfig (coast_deep_measurement stays at its default, True),
    with ``tracking`` fields set on it."""
    from gypsum_tpu_torch.core.config import ReceiverConfig, TrackingConfig

    return ReceiverConfig(tracking=TrackingConfig(
        watchdog_warmup_ms=1500, quality_drop_threshold=0.25, coast_max_s=6.0, **tracking))


def fade_fix_errors(recv) -> tuple[dict, int, int]:
    """({epoch: error m} of the in-fade lsq fixes, lsq fixes with protection
    levels, how many of those levels do not bound their error)."""
    from gypsum_tpu_torch.solve.geodesy import enu_basis, lla_to_ecef

    rx = lla_to_ecef(*TRUTH_LLA)
    enu = enu_basis(rx)
    in_fade = {round(f.receiver_timestamp, 1): float(np.linalg.norm(f.ecef - rx))
               for f in recv.world.position_fixes
               if DEEP_FADE[0] + 5.0 <= f.receiver_timestamp <= DEEP_FADE[1] and f.kind == "lsq"}
    checked = misses = 0
    for f in recv.world.position_fixes:
        if f.kind != "lsq" or f.protection is None:
            continue
        e = enu @ (np.asarray(f.ecef) - rx)
        checked += 1
        misses += bool(np.hypot(e[0], e[1]) > f.protection["hpl_m"]
                       or abs(e[2]) > f.protection["vpl_m"])
    return in_fade, checked, misses


def run_fade_replay(dev, iq: np.ndarray, pipelined: bool):
    """The 38 s deep-fade scene through the default Receiver with the fade
    test's tracking config. Unpipelined (as tests/test_deepcoast.py ran on
    the JAX CPU backend), held to that test's bars: every PRN deep-measured
    and none dropped; >= 4 lsq fixes in [28, 33] s, max error < 50 m, median
    < 25 m; recovery within 3 s of the fade's end, post-fade fixes < 5 m;
    every published protection level bounding its error. Pipelined (the
    card's default) to the same bars, with the JAX receiver's pipelined
    fixes (FADE_PIPELINED_REFERENCE, which miss them) logged beside. The
    snapshot fixes in the fade are logged for both. Returns the receiver."""
    from gypsum_tpu_torch.io.sources import ArraySampleSource
    from gypsum_tpu_torch.runtime.receiver import Receiver
    from gypsum_tpu_torch.solve.geodesy import lla_to_ecef
    from gypsum_tpu_torch.track.deepmeas import DeepCoastMeasurer

    rx = lla_to_ecef(*TRUTH_LLA)
    recv = Receiver(ArraySampleSource(iq, FS), fade_config(pipeline_tracking=pipelined),
                    device=dev)
    if not recv.config.tracking.coast_deep_measurement or recv._pipeline_depth != int(pipelined):
        raise AssertionError("the fade replay must run the default deep measurement")
    # The receiver builds this measurer lazily; built here, its calls are timed.
    meas = DeepCoastMeasurer(FS, L, recv.bank.prns, recv.bank.config, device=dev)
    measure, meas_s = meas.measure, []

    def timed_measure(*args, **kw):
        t = time.perf_counter()
        out = measure(*args, **kw)
        meas_s.append(time.perf_counter() - t)
        return out

    meas.measure = timed_measure
    recv._coast_measurer = meas
    reset_launches()
    wall = timed_run(recv)
    n = launches()
    if n["K1"] == 0:
        raise AssertionError(f"the fade replay launched {n}")
    name = "pipelined" if pipelined else "unpipelined"
    reports = recv.block_reports
    measured = {p for r in reports for p in r.deep_measured_prns}
    dropped = [(r.block_start, p) for r in reports for p in r.dropped_prns]
    if measured != set(FADE_PRNS) or dropped:
        raise AssertionError(f"{name} fade replay: deep-measured {sorted(measured)}, dropped {dropped}")
    recovered = [(r.block_start, p) for r in reports for p in r.coast_recovered_prns]
    if not recovered or not all(DEEP_FADE[1] <= t <= DEEP_FADE[1] + 3.0 for t, _ in recovered):
        raise AssertionError(f"{name} fade replay: recoveries {recovered}")
    post = [float(np.linalg.norm(f.ecef - rx)) for f in recv.world.position_fixes
            if f.receiver_timestamp >= DEEP_FADE[1] + 3.0 and f.kind == "lsq"]
    if not post or max(post) >= 5.0:
        raise AssertionError(f"{name} fade replay: post-fade fix errors {post}")
    in_fade, checked, misses = fade_fix_errors(recv)
    errs = list(in_fade.values())
    if (len(errs) < 4 or max(errs) >= 50.0 or float(np.median(errs)) >= 25.0 or misses
            or checked < 10):
        raise AssertionError(f"{name} fade replay: in-fade lsq fix errors {in_fade}; {misses} "
                             f"of {checked} protection levels do not bound their errors")
    snaps = {round(f.receiver_timestamp, 1): float(np.linalg.norm(f.ecef - rx))
             for f in recv.world.position_fixes
             if DEEP_FADE[0] <= f.receiver_timestamp <= DEEP_FADE[1] and f.kind == "snapshot"}
    jax_piped = ("; the JAX receiver pipelined (its coast anchor one block off, not held): "
                 + ", ".join(f"{t:.0f} s {e:.2f} m" for t, e in sorted(FADE_PIPELINED_REFERENCE.items()))
                 + f", {FADE_PIPELINED_PL_MISSES} of 17 protection levels missed"
                 if pipelined else "")
    ms = 1e3 * np.asarray(meas_s)
    log(f"e2e deep-fade Receiver(device='cuda', {name}), 38 s, PRNs {FADE_PRNS} faded to 0.03 "
        f"over {DEEP_FADE[0]:.0f}-{DEEP_FADE[1]:.0f} s: all {len(measured)} deep-measured, none "
        f"dropped; in-fade lsq fix errors "
        + ", ".join(f"{t:.0f} s {e:.2f} m" for t, e in sorted(in_fade.items()))
        + f" (max {max(errs):.2f}, median {np.median(errs):.2f}){jax_piped}; snapshot fixes in "
        f"the fade " + (", ".join(f"{t:.0f} s {e:.2f} m" for t, e in sorted(snaps.items()))
                        or "none")
        + f"; recovered at {sorted({t for t, _ in recovered})} s; post-fade max {max(post):.2f} m; "
        f"{checked - misses} of {checked} protection levels bound their errors; measurer "
        f"{meas.calls} calls, {ms.mean():.2f} ms per call (median {np.median(ms):.2f}, "
        f"{ms.sum():.0f} ms in all, {100 * ms.sum() / (1e3 * wall):.1f} % of the wall); "
        f"{wall:.2f} s wall; launches {n}; {recv.collect}")
    return recv


def run_checkpoints(dev, scenes: "Scenes", fade_recv, uninterrupted: list) -> None:
    """Checkpoints and the new CLI paths on the card: the fade replay's
    receiver saved and loaded (timed); ``acquire --deep --snapshot`` on the
    fade capture with that checkpoint's orbits and priors ~40 km and 4 s
    off (the JAX CLI's SNAPSHOT FIX, ``SNAPSHOT_REFERENCE``); the 23 s GPS scene replayed with
    ``--duration 12 --checkpoint``, then again from the checkpoint, each
    resumed fix within 1 m of the uninterrupted run's at the same epoch
    (``uninterrupted``: (epoch s, ECEF) of the default replay's fixes)."""
    from gypsum_tpu_torch.io.sources import ArraySampleSource
    from gypsum_tpu_torch.runtime.checkpoint import load_checkpoint, save_checkpoint
    from gypsum_tpu_torch.runtime.receiver import Receiver
    from gypsum_tpu_torch.signal.scenarios import DEMO_GPS_START_SOW
    from gypsum_tpu_torch.solve.geodesy import ecef_to_lla, lla_to_ecef

    rx = lla_to_ecef(*TRUTH_LLA)
    work = Path(tempfile.mkdtemp(prefix="ckpt", dir=scenes.directory))
    ckpt = work / "fade.ckpt.gz"
    t0 = time.perf_counter()
    save_checkpoint(fade_recv, ckpt)
    save_ms = 1e3 * (time.perf_counter() - t0)
    fresh = Receiver(ArraySampleSource(np.zeros(20 * L, np.complex64), FS), fade_config(),
                     device=dev)
    t0 = time.perf_counter()
    at = load_checkpoint(fresh, ckpt)
    load_ms = 1e3 * (time.perf_counter() - t0)
    orbits = sorted(p for p, rec in fresh.world._sats.items() if rec.has_orbit)
    if abs(at - fade_recv.stream_position_s) > 1e-9 or orbits != sorted(FADE_PRNS):
        raise AssertionError(f"checkpoint reloaded at {at} s with orbits {orbits}")
    log(f"checkpoint: the fade replay's receiver saved in {save_ms:.1f} ms "
        f"({ckpt.stat().st_size / 1e3:.0f} kB) and loaded in {load_ms:.1f} ms, at "
        f"{at:.1f} s with the orbits of {orbits}")

    lat, lon, alt = ecef_to_lla(rx + np.array(SNAPSHOT_OFFSET_M))
    reset_launches()
    out, wall = run_cli_here(
        "--file", str(scenes.path("fade")), "--deep", "--snapshot", "--checkpoint", str(ckpt),
        "--assume-lla", f"{lat},{lon},{alt}", "--assume-tow",
        str(DEMO_GPS_START_SOW + SNAPSHOT_DT_S), command="acquire")
    n = launches()
    m = re.search(r"SNAPSHOT FIX lat=(-?[\d.]+) lon=(-?[\d.]+) alt=(-?\d+)m.*", out)
    if m is None or n["K2"] != 36:
        raise AssertionError(f"acquire --deep --snapshot: launches {n}:\n{out[-2000:]}")
    got = [float(v) for v in m.groups()]
    err = float(np.linalg.norm(lla_to_ecef(*got) - rx))
    # The FIX line prints 6 decimals of a degree and whole metres: one unit
    # of the last printed digit of slack.
    if (max(abs(got[0] - SNAPSHOT_REFERENCE[0]), abs(got[1] - SNAPSHOT_REFERENCE[1])) > 1.5e-6
            or abs(got[2] - SNAPSHOT_REFERENCE[2]) > 1.0):
        raise AssertionError(f"SNAPSHOT FIX {got}, the JAX CLI's {SNAPSHOT_REFERENCE}")
    log(f"e2e CLI acquire --deep --snapshot --checkpoint (priors "
        f"{np.linalg.norm(SNAPSHOT_OFFSET_M) / 1e3:.0f} km, {SNAPSHOT_DT_S:.0f} s off): "
        f"{m.group(0)}; the JAX CLI's fix, {err:.1f} m from truth; {wall:.2f} s wall; "
        f"launches {n}")

    gps_ckpt = work / "gps.ckpt.gz"
    first, wall1 = run_cli_here("--file", str(scenes.path("gps")), "--duration", "12",
                                "--checkpoint", str(gps_ckpt))
    reset_launches()
    second, wall2 = run_cli_here("--file", str(scenes.path("gps")), "--checkpoint",
                                 str(gps_ckpt))
    n = launches()
    reacquired = re.findall(r"acquired PRN (\d+)", second)
    if any(int(p) in SCENE_PRNS for p in reacquired) or n["K1"] == 0:
        raise AssertionError(f"resumed replay re-acquired {reacquired}, launches {n}")
    want = dict(uninterrupted)
    pairs = []
    for t, lat, lon, alt in re.findall(
            r"\[\s*([\d.]+)s\] FIX lat=(-?[\d.]+) lon=(-?[\d.]+) alt=(-?\d+)m", second):
        if float(t) in want:
            ecef = lla_to_ecef(float(lat), float(lon), float(alt))
            pairs.append((float(t), float(np.linalg.norm(ecef - want[float(t)]))))
    # The FIX line prints 6 decimals of a degree (~0.1 m) and whole metres of
    # altitude: 1 m holds that rounding.
    if not pairs or max(d for _, d in pairs) >= 1.0:
        raise AssertionError(f"resumed fixes against the uninterrupted run: {pairs}\n{second[-2000:]}")
    log(f"e2e CLI replay --duration 12 --checkpoint ({wall1:.2f} s wall), then resumed from the "
        f"checkpoint ({wall2:.2f} s wall): {len(pairs)} fixes at the uninterrupted run's epochs "
        f"{[t for t, _ in pairs]}, max {max(d for _, d in pairs):.3f} m from them; no scene PRN "
        f"re-acquired; launches {n}")


# ------------------------------- the circulant sweep and the front ends


NOTCH_CW = (10.0, 257e3)  # tests/test_interference.py:167: CW amplitude, offset Hz
NOTCH_PRNS = [25, 28, 31, 32, 3]  # signal/scenarios.py:DEMO_PRNS_8[:5]
ARRAY_JAMMER = (300.0, 12.0)  # tests/test_beamform.py:141: azimuth, elevation deg


def sweep_bars(what: str, mm_hits, fft_hits, on_air) -> None:
    """The circulant sweep held to the FFT sweep with the bars of
    tests/test_acquisition.py:160-185: the same detected set; on the air,
    code phase equal and Doppler within 2 Hz; every row's strength within
    5 % of max(1, strength)."""
    fft = {h.prn: h for h in fft_hits}
    if {h.prn for h in mm_hits if h.detected} != {p for p, h in fft.items() if h.detected} or not (
            set(on_air) <= {h.prn for h in mm_hits if h.detected}):
        raise AssertionError(f"{what}: detected sets differ: {mm_hits} / {fft_hits}")
    for h in mm_hits:
        f = fft[h.prn]
        if h.prn in on_air and (h.code_phase_samples != f.code_phase_samples
                                or abs(h.doppler_hz - f.doppler_hz) >= 2.0):
            raise AssertionError(f"{what}: PRN {h.prn} matmul {h}, FFT {f}")
        if abs(h.strength - f.strength) >= 0.05 * max(1.0, f.strength):
            raise AssertionError(f"{what}: PRN {h.prn} strength {h.strength} vs {f.strength}")


def time_sweeps(what: str, x, dopplers, mm_engine, fft_engine, fs: float) -> dict:
    """Both coarse sweeps on the same 10 ms, by ``two_way``, beside the
    circulant sweep as a loop of one product per satellite (the JAX
    package's ``lax.map`` form, kept out of the port: the batched product
    measured faster, ``ops/correlate.py``)."""
    from gypsum_tpu_torch.ops.correlate import (
        doppler_wipeoff,
        noncoherent_acquisition_sweep,
        noncoherent_acquisition_sweep_matmul,
    )

    table = mm_engine.circulant
    m_count, length = x.shape
    d_count = dopplers.shape[0]

    def per_satellite():
        z = doppler_wipeoff(x, dopplers, fs).reshape(-1, length)
        z = torch.cat([z.real, z.imag]).to(torch.bfloat16)
        out = []
        for c in table:
            c = torch.mm(z, c, out_dtype=torch.float32)
            mag = torch.sqrt(c[: d_count * m_count] ** 2 + c[d_count * m_count:] ** 2)
            out.append(mag.reshape(d_count, m_count, length).sum(dim=1))
        return torch.stack(out)

    ref = noncoherent_acquisition_sweep_matmul(x, dopplers, table, fs)
    if not torch.allclose(per_satellite(), ref, rtol=1e-5, atol=1e-3):
        raise AssertionError(f"{what}: the per-satellite form differs from the batched one")
    return two_way({
        "fft sweep": (lambda: noncoherent_acquisition_sweep(
            x, dopplers, fft_engine.prn_fft_conj, fs), 10, 2),
        "matmul sweep": (lambda: noncoherent_acquisition_sweep_matmul(x, dopplers, table, fs),
                         10, 2),
        "matmul sweep, per satellite": (per_satellite, 10, 2),
    })


def sweep_bounds(s_count: int, d_count: int, m_count: int, length: int) -> dict:
    """Bounds of the two coarse sweeps (``bound``'s rule). The circulant: a
    bf16 product of 2 x 2 x (D M) x L^2 operations per satellite, the table
    read once; the wipeoff and |.| in float32. The FFT sweep: 5 n log2 n per
    complex transform (D M forward, S D M inverse), 6 per complex product,
    3 per |.|; the replica FFT table read once. Both write [S, D, L]."""
    rows = d_count * m_count
    io = 8 * m_count * length + 4 * s_count * d_count * length
    fp32 = 10 * rows * length + 4 * s_count * rows * length
    mm = bound(io + 2 * s_count * length * length, fp32, 4 * s_count * rows * length * length)
    fft_ops = 5 * length * np.log2(length) * rows * (1 + s_count) + 9 * s_count * rows * length
    fft = bound(io + 8 * s_count * length, fft_ops)
    return {"matmul": mm, "fft": fft}


def run_circulant_sweep(dev, scenes: "Scenes", iq: np.ndarray, rx: np.ndarray, ref_recv,
                        ref_acq) -> None:
    """The circulant-matmul sweep (``correlator="matmul"``) on the card: its
    table's build, its acquisitions against the FFT sweep's on the first
    10 ms of the 23 s scene, both sweeps timed, K2 on its grid, then the
    23 s scene replayed to a fix through it (K2 and K1 launched, held to
    the default run), and the GLONASS FDMA family's one-row table against
    the FFT sweep on the GLONASS-only scene's first 10 ms."""
    from gypsum_tpu_torch.acquire.engine import AcquisitionEngine
    from gypsum_tpu_torch.core.config import AcquisitionConfig
    from gypsum_tpu_torch.core.constants import GLONASS_L1_CHANNEL_SPACING_HZ
    from gypsum_tpu_torch.ops.correlate import build_circulant_table
    from gypsum_tpu_torch.signal.prn import (
        ALL_PRN_IDS,
        GLONASS_PRN_IDS,
        glonass_frequency_number,
        replica_table,
    )

    block = np.ascontiguousarray(iq[: 10 * L].reshape(10, L))
    fft_engine = AcquisitionEngine(FS, L, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mm_engine = AcquisitionEngine(FS, L, AcquisitionConfig(correlator="matmul"), device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    table = mm_engine.circulant
    reps = replica_table(L, ALL_PRN_IDS)
    idx = (np.arange(L)[:, None] - np.arange(L)[None, :]) % L
    for s in (0, 17, 31):
        if not np.array_equal(table[s].float().cpu().numpy(), reps[s][idx]):
            raise AssertionError(f"circulant table row {s} differs from r[(l - tau) mod L]")
    reps_dev = torch.from_numpy(reps.copy()).to(dev)
    table_issue = issue_ms(lambda: build_circulant_table(reps_dev, dev), 5)
    mm_hits = mm_engine.acquire_all(block)
    sweep_bars("GPS circulant sweep", mm_hits, fft_engine.acquire_all(block), SCENE_PRNS)

    x = torch.from_numpy(block).to(dev)
    t = time_sweeps("GPS", x, fft_engine.coarse_dopplers, mm_engine, fft_engine, FS)
    b = sweep_bounds(32, fft_engine.coarse_dopplers.shape[0], 10, L)
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    log(f"circulant sweep, GPS [32, 29, 2046] from 10 ms: the table {table.numel() * 2 / 1e6:.1f} MB "
        f"bf16 (3 rows checked exact), the engine built in {1e3 * build_s:.2f} ms (host clock, "
        f"synchronized), the table alone {table_issue:.3f} ms issue; matmul sweep device "
        f"{t['matmul sweep'][0]:.4f} ms, issue {t['matmul sweep'][1]:.4f} ms, bound "
        f"{b['matmul'][0]:.4f} ms ({b['matmul'][1]}); per satellite device "
        f"{t['matmul sweep, per satellite'][0]:.4f} ms, issue "
        f"{t['matmul sweep, per satellite'][1]:.4f} ms; FFT sweep device "
        f"{t['fft sweep'][0]:.4f} ms, issue {t['fft sweep'][1]:.4f} ms, bound "
        f"{b['fft'][0]:.5f} ms ({b['fft'][1]}); acquisitions as the FFT sweep's (bars of "
        f"tests/test_acquisition.py:160-185); peak device memory so far {peak_mb:.0f} MB")

    k2_engine = AcquisitionEngine(FS, L, AcquisitionConfig(correlator="matmul",
                                                           use_pallas_peak_reduce=True), device=dev)
    reset_launches()
    k2_hits = k2_engine.acquire_all(block)
    n = launches()
    if n["K2"] != 1 or [(h.prn, h.code_phase_samples, h.doppler_hz) for h in k2_hits] != [
            (h.prn, h.code_phase_samples, h.doppler_hz) for h in mm_hits]:
        raise AssertionError(f"K2 on the matmul grid: launches {n}, hits differ:\n{k2_hits}")
    del k2_engine, fft_engine, mm_engine

    reset_launches()
    recv, acq, errs, wall = run_receiver(iq, rx, dev, peak_kernel=True, correlator="matmul")
    n = launches()
    if n["K1"] == 0 or n["K2"] == 0:
        raise AssertionError(f"the circulant-sweep replay launched {n}")
    agree = check_same_tracking("circulant sweep", recv, acq, ref_recv, ref_acq)
    log(f"e2e Receiver(device='cuda'), correlator='matmul', use_pallas_peak_reduce=True: "
        f"{len(errs)} fixes, best {min(errs):.2f} m, last {errs[-1]:.2f} m; acquisitions as the "
        f"default run; sign agreement {agree}; {wall:.2f} s wall; launches {n}; {recv.collect}")
    del recv

    glo = scenes.get("glonass")[: 10 * L_GLO].reshape(10, L_GLO).copy()
    kw = dict(prns=GLONASS_PRN_IDS, device=dev, center_offsets_hz=tuple(
        glonass_frequency_number(p) * GLONASS_L1_CHANNEL_SPACING_HZ for p in GLONASS_PRN_IDS))
    fft_engine = AcquisitionEngine(FS_GLO, L_GLO, **kw)
    mm_engine = AcquisitionEngine(FS_GLO, L_GLO, AcquisitionConfig(correlator="matmul"), **kw)
    sweep_bars("GLONASS FDMA circulant sweep", mm_engine.acquire_all(glo),
               fft_engine.acquire_all(glo), GLO_PRNS)
    x = torch.from_numpy(glo).to(dev)
    t = time_sweeps("GLONASS", x, fft_engine.sweep_dopplers, mm_engine, fft_engine, FS_GLO)
    b = sweep_bounds(1, fft_engine.sweep_dopplers.shape[0], 10, L_GLO)
    log(f"circulant sweep, GLONASS FDMA [1, 406, 4092] from 10 ms (one shared code row, table "
        f"{mm_engine.circulant.numel() * 2 / 1e6:.1f} MB): matmul device "
        f"{t['matmul sweep'][0]:.4f} ms, issue {t['matmul sweep'][1]:.4f} ms, bound "
        f"{b['matmul'][0]:.4f} ms ({b['matmul'][1]}); FFT device {t['fft sweep'][0]:.4f} ms, "
        f"issue {t['fft sweep'][1]:.4f} ms, bound {b['fft'][0]:.5f} ms ({b['fft'][1]}); "
        f"the 5 channels on the air as the FFT sweep finds them")


class LogLines(logging.Handler):
    """The messages of INFO and above logged to one logger while it is
    attached (whatever level an earlier CLI run left the root logger at)."""

    def __init__(self, name: str) -> None:
        super().__init__(logging.INFO)
        self.lines: list[str] = []
        self.logger = logging.getLogger(name)
        self._level = self.logger.level

    def emit(self, record) -> None:
        self.lines.append(record.getMessage())

    def __enter__(self):
        self.logger.addHandler(self)
        self.logger.setLevel(logging.INFO)
        return self

    def __exit__(self, *exc) -> None:
        self.logger.removeHandler(self)
        self.logger.setLevel(self._level)


def run_notch(dev, scenes: "Scenes") -> None:
    """The STFT notch on the card: the 25 s, 5-PRN scene with a CW jammer
    of amplitude 10 at 257 kHz (tests/test_interference.py:151-186) through
    ``Receiver(NotchingSampleSource(...))`` and through ``replay --notch
    --until-fix``, to that test's bars; the notch's device and issue ms per
    1000 ms block beside the numpy notch's host time; one block on the card
    against the same function on the CPU, and two card runs bit-equal."""
    from gypsum_tpu_torch.core.config import ReceiverConfig
    from gypsum_tpu_torch.io.sources import ArraySampleSource, NotchingSampleSource
    from gypsum_tpu_torch.ops.interference import make_stft_notch, stft_notch_np
    from gypsum_tpu_torch.runtime.receiver import Receiver
    from gypsum_tpu_torch.solve.geodesy import lla_to_ecef

    rx = lla_to_ecef(*TRUTH_LLA)
    jammed = scenes.get("notch")
    source = NotchingSampleSource(ArraySampleSource(jammed, FS), device=dev)
    read_block, read_s = source.read_block, []

    def timed_read(n_ms):
        t = time.perf_counter()
        out = read_block(n_ms)
        read_s.append(time.perf_counter() - t)
        return out

    source.read_block = timed_read
    recv = Receiver(source, ReceiverConfig(), eligible_prns=NOTCH_PRNS, device=dev)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    recv.run(until_fix=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = launches()
    fixes = recv.world.position_fixes
    if not fixes or n["K1"] == 0:
        raise AssertionError(f"notch replay: {len(fixes)} fixes, launches {n}")
    fix = fixes[0]
    err = float(np.linalg.norm(fix.ecef - rx))
    fractions = [rep.fraction for _, rep in source.events]
    if err >= 20.0 or source.interference_seconds < fix.receiver_timestamp - 2.0 or max(
            fractions) >= 0.01:
        raise AssertionError(f"notch replay: fix {err:.2f} m at {fix.receiver_timestamp} s, "
                             f"{source.interference_seconds} s of interference, fractions {fractions}")
    rep = source.events[0][1]
    log(f"e2e Receiver(NotchingSampleSource(25 s, CW {NOTCH_CW[0]} at {NOTCH_CW[1]:.0f} Hz), "
        f"device='cuda'): first fix at {fix.receiver_timestamp:.1f} s, {err:.2f} m from truth (bar "
        f"20 m); interference on {source.interference_seconds:.0f} blocks, {rep.n_bins} bins at "
        f"{rep.peak_over_median_db:.1f} dB, fractions <= {max(fractions):.5f} (bar 0.01); "
        f"{wall:.2f} s wall; launches {n}; read_block (upload 16 MB, notch, download 16 MB) "
        f"mean {1e3 * np.mean(read_s):.2f} ms, median {1e3 * np.median(read_s):.2f} ms over "
        f"{len(read_s)} calls")

    with LogLines("gypsum_tpu_torch.io.sources") as lines:
        reset_launches()
        out, wall = run_cli_here("--file", str(scenes.path("notch")), "--notch", "--until-fix",
                                 "--prns", *map(str, NOTCH_PRNS))
        n = launches()
    fixes = cli_fixes(out)
    excised = [m for m in lines.lines if "interference:" in m and "excised" in m]
    if not fixes or n["K1"] == 0 or not excised:
        raise AssertionError(f"replay --notch: {len(fixes)} fixes, {len(excised)} excision lines, "
                             f"launches {n}:\n{out[-2000:]}")
    err = float(np.linalg.norm(fixes[0][0] - rx))
    if err >= 20.0:
        raise AssertionError(f"replay --notch first fix {err:.2f} m from truth (bar 20 m)")
    log(f"e2e CLI replay --notch --until-fix (in process): FIX {err:.2f} m from truth after "
        f"{processed_blocks(out)} blocks, {len(excised)} excision lines; {wall:.2f} s wall; "
        f"launches {n}")

    n = 1000 * L
    block = jammed[:n]
    planes = torch.from_numpy(np.stack([block.real, block.imag]))
    notch = make_stft_notch(n, FS, guard_bins=2, device=dev)
    x = planes.to(dev)
    a, sa = notch(x)
    b, sb = notch(x)
    cpu, sc = make_stft_notch(n, FS, guard_bins=2, device="cpu")(planes)
    if not (torch.equal(a, b) and torch.equal(sa, sb)):
        raise AssertionError("two card runs of the notch differ")
    rel = float((a.cpu() - cpu).norm() / cpu.norm())
    # Tolerance: the CPU and the card take the same float32 FFTs, means and
    # median in another order (~3e-6 measured); bins held equal.
    if int(sa[0]) != int(sc[0]) or sa[2] != sc[2] or rel > 1e-5:
        raise AssertionError(f"notch on the card vs the CPU: stats {sa.tolist()} / {sc.tolist()}, "
                             f"relative error {rel:.3g}")
    t = two_way({"notch": (lambda: notch(x), 20, 2)})
    t0 = time.perf_counter()
    _, rep_np = stft_notch_np(block, FS, guard_bins=2)
    np_s = time.perf_counter() - t0
    if rep_np.n_bins != int(sa[0]):
        raise AssertionError(f"numpy notch masks {rep_np.n_bins} bins, the card {int(sa[0])}")
    log(f"notch per 1000 ms block ([2, 2046000], {notch.n_frames} frames x 4096): device "
        f"{t['notch'][0]:.4f} ms, issue {t['notch'][1]:.4f} ms; card vs CPU relative error "
        f"{rel:.3g}, {int(sa[0])} bins on both, two card runs equal to the bit; the numpy notch "
        f"(the JAX package's, host) {1e3 * np_s:.1f} ms on this host")


def run_beamform(dev, scenes: "Scenes") -> None:
    """The CRPA beamformer on the card: the 23 s 4-element scene with a
    broadband jammer of amplitude 6 from (300, 12) deg
    (tests/test_beamform.py:129-153) through ``null_jammers`` (suppression
    > 15 dB, the contraction within 1e-6 of numpy's ``apply_weights``), the
    beamformed stream through the default Receiver to a fix within 15 m,
    and ``replay --beamform --until-fix`` on the capture with an
    ``elements_enu`` sidecar, its MUSIC bearing within 4 deg of the
    jammer's."""
    import json

    from gypsum_tpu_torch.core.config import ReceiverConfig
    from gypsum_tpu_torch.io.sources import ArraySampleSource
    from gypsum_tpu_torch.ops.beamform import (
        apply_weights,
        apply_weights_torch,
        contract,
        null_jammers,
    )
    from gypsum_tpu_torch.runtime.receiver import Receiver
    from gypsum_tpu_torch.signal.array import square_array_enu
    from gypsum_tpu_torch.solve.geodesy import lla_to_ecef

    rx = lla_to_ecef(*TRUTH_LLA)
    arr = scenes.get("array")
    t0 = time.perf_counter()
    y, w, supp = null_jammers(arr, device=dev)
    null_s = time.perf_counter() - t0
    if supp <= 15.0:
        raise AssertionError(f"beamform suppression {supp:.2f} dB (bar 15 dB)")
    t0 = time.perf_counter()
    y_np = apply_weights(arr, w)
    np_s = time.perf_counter() - t0
    rel = float(np.linalg.norm(y - y_np) / np.linalg.norm(y_np))
    if rel > 1e-6:
        raise AssertionError(f"the card's contraction is {rel:.3g} from numpy's (bar 1e-6)")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    apply_weights_torch(arr, w, dev)
    card_s = time.perf_counter() - t0
    chunk = torch.from_numpy(np.ascontiguousarray(arr[:, :2_000_000])).to(dev)
    wc = torch.from_numpy(np.conj(w).astype(np.complex64)).to(dev)
    t = two_way({"contraction": (lambda: contract(wc, chunk), 20, 2)})
    b = bound(chunk.numel() * 8 + chunk.shape[1] * 8, 8 * chunk.numel())
    log(f"beamform, 23 s x 4 elements ({arr.nbytes / 1e9:.2f} GB): null_jammers on the card "
        f"{null_s:.3f} s (covariance, solve on the host; contraction on the card), suppression "
        f"{supp:.2f} dB (bar 15), |w| {np.round(np.abs(w), 3).tolist()}; the contraction alone "
        f"{1e3 * card_s:.1f} ms with its transfers vs numpy's {1e3 * np_s:.1f} ms on the host, "
        f"relative error {rel:.3g} (bar 1e-6); one 2M-sample slab resident on the card: device "
        f"{t['contraction'][0]:.4f} ms, issue {t['contraction'][1]:.4f} ms, bound {b[0]:.4f} ms "
        f"({b[1]})")
    del chunk, y_np

    recv = Receiver(ArraySampleSource(y, FS), ReceiverConfig(), eligible_prns=SCENE_PRNS,
                    device=dev)
    reset_launches()
    wall = timed_run(recv)
    n = launches()
    fixes = recv.world.position_fixes
    if not fixes or n["K1"] == 0:
        raise AssertionError(f"beamformed replay: {len(fixes)} fixes, launches {n}")
    err = float(np.linalg.norm(fixes[-1].ecef - rx))
    if err >= 15.0:
        raise AssertionError(f"beamformed replay: last fix {err:.2f} m from truth (bar 15 m)")
    log(f"e2e Receiver(ArraySampleSource(beamformed), device='cuda'): {len(fixes)} fixes, first at "
        f"{fixes[0].receiver_timestamp:.1f} s, last {err:.2f} m from truth (bar 15 m); {wall:.2f} s "
        f"wall; launches {n}; {recv.collect}")
    del recv, y

    path = scenes.path("array")
    elements = square_array_enu()
    Path(str(path) + ".json").write_text(json.dumps({
        "sample_rate": FS, "dtype": "complex64", "elements": len(elements),
        "elements_enu": elements.tolist()}))
    with LogLines("gypsum_tpu_torch") as lines:
        reset_launches()
        out, wall = run_cli_here("--file", str(path), "--beamform", "--until-fix",
                                 "--prns", *map(str, SCENE_PRNS))
        n = launches()
    fixes = cli_fixes(out)
    bearings = [tuple(float(v) for v in m) for m in re.findall(
        r"interference bearing: azimuth (\d+) deg, elevation (-?\d+) deg", "\n".join(lines.lines))]
    if not fixes or n["K1"] == 0 or len(bearings) != 1:
        raise AssertionError(f"replay --beamform: {len(fixes)} fixes, bearings {bearings}, "
                             f"launches {n}:\n{out[-2000:]}")
    az, el = bearings[0]
    err = float(np.linalg.norm(fixes[0][0] - rx))
    if (abs((az - ARRAY_JAMMER[0] + 180.0) % 360.0 - 180.0) > 4.0
            or abs(el - ARRAY_JAMMER[1]) > 4.0 or err >= 15.0):
        raise AssertionError(f"replay --beamform: bearing ({az}, {el}), fix {err:.2f} m")
    log(f"e2e CLI replay --beamform --until-fix (in process, elements_enu sidecar): bearing "
        f"azimuth {az:.0f} deg, elevation {el:.0f} deg (jammer at {ARRAY_JAMMER}, bar 4 deg); "
        f"FIX {err:.2f} m from truth; {wall:.2f} s wall (np.load of the capture included); "
        f"launches {n}")


class RtkInstruments:
    """While active: each ``Receiver.run`` timed (synchronized) with the
    blocks it dispatched, and the host ms of each solve stage of
    solve/rtk.py and solve/attitude.py, with its last result. The rtk CLI
    imports these functions when it runs, so it calls the wrapped ones."""

    STAGES = {"rtk": ["form_double_differences", "dd_from_rinex", "solve_baseline",
                      "integer_least_squares", "bootstrap_success_rate", "solve_kinematic",
                      "estimate_stream_alignment"],
              "attitude": ["solve_attitude"]}

    def __init__(self) -> None:
        self.ms: dict[str, list[float]] = {}
        self.result: dict[str, object] = {}
        self.args: dict[str, tuple] = {}
        self.runs: list[tuple[float, int]] = []  # (wall s, blocks) per receiver run
        self.logs: list = []  # the run's CarrierPhaseLogs, base first
        self._saved = []

    def _wrap(self, owner, name: str) -> None:
        fn = getattr(owner, name)

        def timed(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            self.ms.setdefault(name, []).append(1e3 * (time.perf_counter() - t0))
            self.result[name], self.args[name] = out, (args, kw)
            return out

        self._saved.append((owner, name, fn))
        setattr(owner, name, timed)

    def __enter__(self):
        import gypsum_tpu_torch.solve.attitude as attitude
        import gypsum_tpu_torch.solve.rtk as rtk
        from gypsum_tpu_torch.runtime.receiver import Receiver

        for module, names in ((rtk, self.STAGES["rtk"]), (attitude, self.STAGES["attitude"])):
            for name in names:
                self._wrap(module, name)
        logs = self.logs

        class KeptLog(rtk.CarrierPhaseLog):
            def __init__(self, *args, **kw):
                super().__init__(*args, **kw)
                logs.append(self)

        self._saved.append((rtk, "CarrierPhaseLog", rtk.CarrierPhaseLog))
        rtk.CarrierPhaseLog = KeptLog
        run = Receiver.run

        def timed_run(recv, *args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run(recv, *args, **kw)
            torch.cuda.synchronize()
            self.runs.append((time.perf_counter() - t0, round(recv.source.seconds_consumed)))
            return out

        self._saved.append((Receiver, "run", run))
        Receiver.run = timed_run
        return self

    def __exit__(self, *exc) -> None:
        for owner, name, fn in reversed(self._saved):
            setattr(owner, name, fn)

    def stage_line(self) -> str:
        """Host ms of each stage this run called. The float solve is inline
        in ``solve_baseline``, so it is run again 7 times in turns with the
        full solve on the same inputs: the least time of ``fix=False`` is
        the float solve, the rest of the full solve's least time the integer
        step (the ILS search and the bootstrap bound, timed in the run, and
        the fixed solve)."""
        parts = [f"{k} {sum(v):.2f}" for k, v in self.ms.items() if k != "solve_baseline"]
        if "solve_baseline" in self.ms:
            import gypsum_tpu_torch.solve.rtk as rtk

            args, kw = self.args["solve_baseline"]
            least = {False: np.inf, True: np.inf}
            for _ in range(7):
                for fix in least:
                    t0 = time.perf_counter()
                    rtk.solve_baseline(*args, **{**kw, "fix": fix})
                    least[fix] = min(least[fix], 1e3 * (time.perf_counter() - t0))
            parts += [f"solve_baseline {sum(self.ms['solve_baseline']):.2f} (again, least of 7: "
                      f"{least[True]:.2f}, of which the float solve {least[False]:.2f} and the "
                      f"integer step {least[True] - least[False]:.2f})"]
        return "host ms: " + ", ".join(parts)


def rtk_cli(label: str, *argv: str, blocks: int) -> tuple[str, "RtkInstruments"]:
    """``python -m gypsum_tpu_torch rtk ...`` in this process, K1's launches
    counted around it and held to the blocks its two receivers dispatched
    (``blocks``; none in RINEX mode), K3 and K4 held at 0."""
    with RtkInstruments() as inst:
        reset_launches()
        out, wall = run_cli_here(*argv, command="rtk")
        n = launches()
    dispatched = sum(b for _, b in inst.runs)
    if dispatched != blocks or n["K1"] != blocks or n["K3"] or n["K4"]:
        raise AssertionError(f"rtk {label}: receivers dispatched {dispatched} blocks (want "
                             f"{blocks}), launches {n}:\n{out[-2000:]}")
    # The phase logs rebuild each ms's unwrapped phase from the tracker's
    # exported values (bf16 phase-1 operands here): the pin residual stays
    # at float32 rounding, and every PRN keeps one arc across the blocks
    # (tests/test_rtk.py:143, :148).
    arcs = [{p: len(a) for p, a in lg.arcs.items()} for lg in inst.logs]
    pins = [lg.max_pin_residual_rad for lg in inst.logs]
    if any(pin >= 0.5 for pin in pins) or any(set(a.values()) != {1} for a in arcs):
        raise AssertionError(f"rtk {label}: pin residuals {pins} rad, arcs per PRN {arcs}")
    runs = ", ".join(f"{w:.2f} s for {b} blocks" for w, b in inst.runs)
    logs = (f"; phase logs: pin residual {', '.join(f'{p:.2e}' for p in pins)} rad, one arc per "
            f"PRN ({len(arcs[0])} PRNs)" if inst.logs else "")
    log(f"rtk {label} (in process): {wall:.2f} s wall; receivers {runs or 'none'}; launches "
        f"{n}{logs}; {inst.stage_line()}; {SMI[0]}")
    return out, inst


def run_rtk(dev, scenes: "Scenes", k1: dict) -> None:
    """The rtk entry point on the card, with the JAX tests' bars: the static
    pair (tests/test_rtk.py:223-270; the CLI needs the base's decoded orbits,
    so RTK_SECONDS of it) static, ``--kinematic`` and ``--attitude`` (the
    pair's own separation; tests/test_attitude.py:201-205's bars at the
    headings the ENU truth implies), the independent-clock pair
    (:386-449), and RINEX mode on the pair's ``replay --rinex-obs`` exports
    (RTK_EXPORT_SECONDS, ~40 epochs: tests/test_rinex.py's solve fixes on
    40) with a NAV file of its six orbits. K1's launches are counted around
    each capture-mode run (``k1["rtk_launches"]``). Then the exports of the
    23 s GPS scene (tests/test_rinex.py:141-200's bars on the OBS file, one
    GGA per FIX line) and the assisted start on the pair's base
    (tests/test_assist.py:101-157's bars) with the NAV file its own export
    replay decoded."""
    from gypsum_tpu_torch.obs import nmea
    from gypsum_tpu_torch.obs.rinex import parse_nav, parse_obs, render_nav
    from gypsum_tpu_torch.signal.constellation import synthesize_constellation
    from gypsum_tpu_torch.signal.scenarios import (
        DEMO_EPHEMERIDES,
        DEMO_GPS_START_SOW,
        DEMO_PRNS_8,
        demo_constellation,
    )
    from gypsum_tpu_torch.solve.ephemeris import satellite_position
    from gypsum_tpu_torch.solve.geodesy import enu_basis, lla_to_ecef

    base = lla_to_ecef(*TRUTH_LLA)
    east, north, up = enu_basis(base)
    truth = np.asarray(RTK_ENU) @ np.stack((east, north, up))
    lla = [str(v) for v in TRUTH_LLA]
    for name in ("rtk_base", "rtk_rover", "rtk_clock"):
        scenes.get(name)  # synthesized: the CLI reads the files
    pair = ["--base-file", str(scenes.path("rtk_base")), "--rover-file",
            str(scenes.path("rtk_rover")), "--base-lla", *lla, "--duration", f"{RTK_SECONDS:g}"]
    blocks = 2 * round(RTK_SECONDS)

    def enu_err(b) -> float:
        return float(np.linalg.norm(np.asarray(b) - truth))

    # Static: tests/test_rtk.py:264-270.
    out, inst = rtk_cli("static", *pair, blocks=blocks)
    sol = inst.result["solve_baseline"]
    err_f, err_x = enu_err(sol.baseline_float_m), enu_err(sol.baseline_fixed_m)
    if not (sol.fixed and sol.ratio >= 2.0 and err_x < 0.010 and err_f < 0.5
            and sol.phase_rms_half_cycles < 0.02):
        raise AssertionError(f"rtk static: fixed {sol.fixed}, ratio {sol.ratio:.2f}, fixed "
                             f"{1e3 * err_x:.1f} mm, float {err_f:.3f} m, phase RMS "
                             f"{sol.phase_rms_half_cycles:.4f}:\n{out}")
    log(f"rtk static: FIXED, ratio {sol.ratio:.2f}, bootstrap {sol.bootstrap_success:.5f}, "
        f"{sol.n_epochs} epochs; fixed {1e3 * err_x:.2f} mm from truth (bar 10), float "
        f"{err_f:.3f} m (bar 0.5), phase RMS {sol.phase_rms_half_cycles:.4f} half-cycles "
        f"(bar 0.02)")
    k1["rtk_launches"] = blocks

    # Kinematic: every epoch within 30 mm (tests/test_rtk.py:322-324).
    out, inst = rtk_cli("--kinematic", *pair, "--kinematic", blocks=blocks)
    sol = inst.result["solve_kinematic"]
    errs = np.linalg.norm(sol.baselines_fixed_m - truth, axis=1) if sol.fixed else [np.inf]
    if not sol.fixed or max(errs) >= 0.03:
        raise AssertionError(f"rtk --kinematic: fixed {sol.fixed}, ratio {sol.ratio:.2f}, worst "
                             f"epoch {max(errs):.4f} m:\n{out[-2000:]}")
    log(f"rtk --kinematic: FIXED, ratio {sol.ratio:.2f}, {len(errs)} epochs, worst "
        f"{1e3 * max(errs):.2f} mm, median {1e3 * np.median(errs):.2f} mm from truth (bar 30)")

    # Attitude of the pair's own axis: tests/test_attitude.py:201-205.
    separation = float(np.linalg.norm(RTK_ENU))
    heading = float(np.degrees(np.arctan2(RTK_ENU[0], RTK_ENU[1])))
    pitch = float(np.degrees(np.arctan2(RTK_ENU[2], np.hypot(RTK_ENU[0], RTK_ENU[1]))))
    out, inst = rtk_cli("--attitude", *pair, "--attitude", f"{separation:.2f}", blocks=blocks)
    sol = inst.result["solve_attitude"]
    dh = float(np.max(np.abs((sol.heading_deg - heading + 180.0) % 360.0 - 180.0)))
    dp = float(np.max(np.abs(sol.pitch_deg - pitch)))
    if not (sol.fixed and sol.length_rms_m < 0.01 and dh < 0.12 and dp < 0.25):
        raise AssertionError(f"rtk --attitude: fixed {sol.fixed}, length RMS "
                             f"{sol.length_rms_m:.4f} m, heading {dh:.3f}, pitch {dp:.3f} deg off:"
                             f"\n{out[-2000:]}")
    log(f"rtk --attitude {separation:.2f}: FIXED by {sol.fixed_by}, ratio {sol.ratio:.2f}, "
        f"length RMS {1e3 * sol.length_rms_m:.2f} mm (bar 10), heading within {dh:.4f} deg of "
        f"{heading:.3f} (bar 0.12), pitch within {dp:.4f} deg of {pitch:.3f} (bar 0.25)")

    # Independent clocks: tests/test_rtk.py:435-449.
    out, inst = rtk_cli("--independent-clocks", "--base-file", str(scenes.path("rtk_base")),
                        "--rover-file", str(scenes.path("rtk_clock")), "--base-lla", *lla,
                        "--duration", f"{RTK_SECONDS:g}", "--independent-clocks", blocks=blocks)
    align, sol = inst.result["estimate_stream_alignment"], inst.result["solve_baseline"]
    d_off, d_drift = align.offset_s - RTK_CLOCK[0], align.drift + RTK_CLOCK[1]
    err_x = enu_err(sol.baseline_fixed_m)
    if not (abs(d_off) < 0.5e-6 and abs(d_drift) < 2e-9 and sol.fixed and err_x < 0.010):
        raise AssertionError(f"rtk --independent-clocks: offset {align.offset_s!r}, drift "
                             f"{align.drift!r}, fixed {sol.fixed}, {1e3 * err_x:.1f} mm:\n{out}")
    log(f"rtk --independent-clocks: offset {1e6 * align.offset_s:.4f} us ({1e9 * d_off:+.1f} ns "
        f"off, bar 500), drift {align.drift:.4e} ({d_drift:+.2e} off, bar 2e-9); FIXED, ratio "
        f"{sol.ratio:.2f}, {1e3 * err_x:.2f} mm from truth (bar 10)")

    # RINEX mode: the pair exported by replay, the NAV of its six orbits
    # rendered as tests/test_rinex.py:92-140 does.
    d = Path(scenes.directory)
    files = {k: d / f"rtk.{k}" for k in ("base.obs", "rover.obs", "base.nav", "base.nmea",
                                          "orbits.nav")}
    for role, extra in (("base", ("--rinex-nav", str(files["base.nav"]), "--nmea-out",
                                  str(files["base.nmea"]))), ("rover", ())):
        reset_launches()
        out, wall = run_cli_here("--file", str(scenes.path(f"rtk_{role}")), "--rinex-obs",
                                 str(files[f"{role}.obs"]), *extra)
        n = launches()
        if n["K1"] != processed_blocks(out) or not files[f"{role}.obs"].exists():
            raise AssertionError(f"replay --rinex-obs of the {role}: launches {n}:\n{out[-2000:]}")
        log(f"replay --rinex-obs of the rtk {role} ({RTK_EXPORT_SECONDS:g} s): {wall:.2f} s wall; "
            f"launches {n}; " + "; ".join(m for m in out.splitlines() if m.startswith("wrote")))
    files["orbits.nav"].write_text(render_nav(
        {p: DEMO_EPHEMERIDES[DEMO_PRNS_8.index(p)] for p in RTK_PRNS}))
    out, inst = rtk_cli("RINEX mode", "--base-rinex", str(files["base.obs"]), "--rover-rinex",
                        str(files["rover.obs"]), "--nav", str(files["orbits.nav"]),
                        "--base-lla", *lla, blocks=0)
    sol = inst.result["solve_baseline"]
    err_x = enu_err(sol.baseline_fixed_m)
    if not (sol.fixed and err_x < 0.010):
        raise AssertionError(f"rtk RINEX mode: fixed {sol.fixed}, ratio {sol.ratio:.2f}, "
                             f"{1e3 * err_x:.1f} mm:\n{out}")
    log(f"rtk RINEX mode: FIXED, ratio {sol.ratio:.2f}, bootstrap {sol.bootstrap_success:.5f}, "
        f"{sol.n_epochs} epochs, {1e3 * err_x:.2f} mm from truth (bar 10)")

    # The 23 s GPS scene's exports: tests/test_rinex.py:141-200's bars.
    gps = {k: d / f"gps.{k}" for k in ("obs", "nav", "nmea")}
    reset_launches()
    out, wall = run_cli_here("--file", str(scenes.path("gps")), "--rinex-obs", str(gps["obs"]),
                             "--rinex-nav", str(gps["nav"]), "--nmea-out", str(gps["nmea"]))
    n = launches()
    eph = parse_nav(gps["nav"].read_text())
    if sorted(eph) != sorted(SCENE_PRNS) or n["K1"] != processed_blocks(out):
        raise AssertionError(f"gps exports: NAV holds {sorted(eph)}, launches {n}")
    _, scene_truth = synthesize_constellation(demo_constellation(SCENE_PRNS), base, GPS_T0, 0.01,
                                              FS, noise_sigma=0.0)
    parsed = parse_obs(gps["obs"].read_text())
    orbits = {p: DEMO_EPHEMERIDES[DEMO_PRNS_8.index(p)] for p in SCENE_PRNS}  # the truth
    week = 2048 + orbits[SCENE_PRNS[0]].week_number
    code_err, dop_err = 0.0, 0.0
    for i, (when, rows) in enumerate(parsed.epochs):
        sow = (when - datetime.datetime(1980, 1, 6)).total_seconds() - week * 7 * 86400.0
        for prn, vals in rows.items():
            rng = float(np.linalg.norm(satellite_position(orbits[prn], sow - 0.072) - base))
            code_err = max(code_err, abs(vals["C1C"] - rng))
            if i == 0:
                dop_err = max(dop_err, abs(vals["D1C"] - scene_truth.doppler_hz[prn]))
    lines = gps["nmea"].read_text().splitlines()
    bad = [s for s in lines if nmea.checksum(s[1:].rsplit("*", 1)[0]) != s.rsplit("*", 1)[1]]
    ggas = [nmea.parse_gga(s) for s in lines if s[3:6] == "GGA"]
    fix_lines = [m for m in out.splitlines() if " FIX lat=" in m]
    pos = [tuple(float(v) for v in FIX_LINE.search(m).groups()[:3]) for m in fix_lines]
    off = [max(abs(g.lat_deg - p[0]), abs(g.lon_deg - p[1])) for g, p in zip(ggas, pos)]
    alt = [abs(g.alt_m - p[2]) for g, p in zip(ggas, pos)]
    if (not parsed.epochs or code_err >= 50.0 or dop_err >= 25.0 or bad
            or len(ggas) != len(fix_lines) or not ggas or max(off) > 6e-7 or max(alt) > 0.55):
        raise AssertionError(f"gps exports: {len(parsed.epochs)} epochs, C1C {code_err:.1f} m, "
                             f"D1C {dop_err:.1f} Hz, {len(bad)} bad checksums, {len(ggas)} GGA "
                             f"for {len(fix_lines)} FIX lines, offsets {off} {alt}")
    log(f"replay --rinex-obs --rinex-nav --nmea-out of the 23 s GPS scene: {wall:.2f} s wall; "
        f"launches {n}; NAV {len(eph)} ephemerides; OBS {len(parsed.epochs)} epochs, C1C within "
        f"{code_err:.2f} m of the true range (bar 50), D1C within {dop_err:.2f} Hz (bar 25); "
        f"{len(ggas)} GGA for {len(fix_lines)} FIX lines, within {max(off):.1e} deg and "
        f"{max(alt):.2f} m of the printed fix, {len(lines)} sentences, every checksum valid")

    # Assisted start on the pair's base: tests/test_assist.py:101-157.
    assist = ("--file", str(scenes.path("rtk_base")), "--assist-nav", str(files["base.nav"]),
              "--assist-time", f"{DEMO_GPS_START_SOW + 7.5}")
    reset_launches()
    out, wall = run_cli_here(*assist, "--until-fix")
    n = launches()
    first = next((m for m in out.splitlines() if re.search(r"\] (FIX|SNAPSHOT|COAST) lat=", m)),
                 "")
    m = re.search(r"\[\s*([\d.]+)s\] SNAPSHOT lat=(-?[\d.]+) lon=(-?[\d.]+) alt=(-?\d+)m", first)
    err0 = float(np.linalg.norm(lla_to_ecef(*map(float, m.groups()[1:])) - base)) if m else np.inf
    if m is None or float(m.group(1)) >= 5.0 or err0 >= 150.0:
        raise AssertionError(f"assisted --until-fix: first fix {first!r}, {err0:.1f} m")
    log(f"replay --assist-nav --assist-time {DEMO_GPS_START_SOW + 7.5} --until-fix: SNAPSHOT at "
        f"{m.group(1)} s (bar 5), {err0:.2f} m from truth (bar 150); {wall:.2f} s wall; "
        f"launches {n}")
    out, wall = run_cli_here(*assist, "--duration", "14")
    subframe_t = min(float(x) for x in re.findall(r"\[\s*([\d.]+)s\] PRN \d+ subframe", out))
    lsq = [(float(t), lla_to_ecef(*map(float, v))) for t, *v in
           re.findall(r"\[\s*([\d.]+)s\] FIX lat=(-?[\d.]+) lon=(-?[\d.]+) alt=(-?\d+)m", out)]
    if not lsq or lsq[0][0] - subframe_t >= 2.5 or np.linalg.norm(lsq[-1][1] - base) >= 10.0:
        raise AssertionError(f"assisted 14 s: subframe at {subframe_t}, lsq fixes "
                             f"{[(t, np.linalg.norm(x - base)) for t, x in lsq]}")
    log(f"replay --assist-nav --assist-time --duration 14: first subframe in the block from "
        f"{subframe_t:.1f} s, first lsq FIX at {lsq[0][0]:.1f} s (bar 2.5 s after), last "
        f"{np.linalg.norm(lsq[-1][1] - base):.2f} m from truth (bar 10); {wall:.2f} s wall")


# ------------------------- raw captures, the dashboard, the profile flag


def write_raw_captures(scenes: "Scenes") -> dict:
    """The 23 s GPS scene as an interleaved float32 capture at 2.046 Msps and
    the same scene at 8.184 Msps as an interleaved int8 capture (hackrf's
    format: each component times a scale that puts the scene's largest at
    127, rounded), each with its ``.json`` sidecar, written in 1 s chunks
    beside the scenes. Returns name -> (path, RecordingInfo, scale)."""
    from gypsum_tpu_torch.io.sources import RecordingInfo

    out = {}
    for name, scene, rate, dtype in (("raw_f32", "gps", FS, np.float32),
                                     ("raw_i8", "gps_8x", FS_FAST, np.int8)):
        iq = scenes.get(scene)
        parts = iq.view(np.float32)  # interleaved re, im: the capture's own layout
        scale = 1.0 if dtype == np.float32 else 127.0 / float(np.abs(parts).max())
        path = scenes.directory / f"{name}.{np.dtype(dtype).name}"
        chunk = 2 * int(rate)
        t0 = time.perf_counter()
        with open(path, "wb") as f:
            for lo in range(0, len(parts), chunk):
                words = parts[lo : lo + chunk]
                if dtype != np.float32:
                    words = np.round(words * np.float32(scale))
                words.astype(dtype).tofile(f)
        meta = {"sample_rate": rate, "dtype": np.dtype(dtype).name}
        Path(f"{path}.json").write_text(json.dumps(meta))
        out[name] = (path, RecordingInfo.from_sidecar(path), scale)
        log(f"raw capture {path.name}: the {scene} scene, {len(iq) / rate:.0f} s at "
            f"{rate / 1e6:.3f} Msps, interleaved {np.dtype(dtype).name}"
            f"{f' x {scale:.4f} (the largest component at 127)' if scale != 1.0 else ''}, "
            f"{path.stat().st_size / 1e6:.0f} MB, sidecar {meta}; "
            f"written in {time.perf_counter() - t0:.2f} s")
        del iq, parts
    return out


def hold_file_source(name: str, info) -> None:
    """The port's FileSampleSource (the native reader, its prefetch) against
    the plain numpy conversion on the same file, to the bit: the first three
    1000 ms blocks (the second and third served by the prefetch), a block at
    an odd sample offset after the cursor moved (read on the spot) and the
    block after it (the prefetch again)."""
    from gypsum_tpu_torch.io.sources import FileSampleSource, convert_numpy

    src = FileSampleSource(info)
    words = np.memmap(info.path, dtype=info.component_dtype, mode="r")
    spp = src.attributes.samples_per_prn
    odd = 3000 * spp + 1001
    plan = [(0, 0), (1000 * spp, 1), (2000 * spp, 2), (odd, 2), (odd + 1000 * spp, 3)]
    for start, hits in plan:
        if start == odd:
            src._cursor = odd  # as a resume moves it, with a prefetch queued
        _, block = src.read_block(1000)
        want = convert_numpy(words, start, 1000 * spp, info.component_offset)
        if block.tobytes() != want.tobytes():
            raise AssertionError(f"{name}: the block at sample {start} differs from numpy's")
        if src._native.prefetched_reads != hits:
            raise AssertionError(f"{name}: {src._native.prefetched_reads} prefetched reads "
                                 f"after the block at {start}, expected {hits}")
    log(f"{name}: FileSampleSource blocks at samples {[s for s, _ in plan]} (1000 ms each) "
        f"equal to the bit to convert_numpy; {src._native.prefetched_reads} of 5 served by "
        f"the prefetch")


def read_block_ms(make_source, n_blocks: int = 12) -> list[float]:
    """Host ms of each of ``n_blocks`` sequential 1000 ms ``read_block`` calls
    of a fresh source from ``make_source()``."""
    source, ms = make_source(), []
    for _ in range(n_blocks):
        t0 = time.perf_counter()
        source.read_block(1000)
        ms.append(1e3 * (time.perf_counter() - t0))
    return ms


def time_reads(name: str, make_native, make_numpy) -> None:
    """Median host ms per read_block, the native reader against numpy's
    conversion, in turns (numpy, native, native, numpy) on this host."""
    turns = {"numpy": [], "native": []}
    for which in ("numpy", "native", "native", "numpy"):
        turns[which].append(read_block_ms(make_native if which == "native" else make_numpy))
    med = {k: [float(np.median(t)) for t in v] for k, v in turns.items()}
    log(f"{name}: read_block host ms per 1000 ms block, median of 12 a turn: native "
        f"{' / '.join(f'{m:.3f}' for m in med['native'])}, numpy "
        f"{' / '.join(f'{m:.3f}' for m in med['numpy'])} (the native turns' first read is "
        f"not prefetched)")


def run_raw_captures(dev, scenes: "Scenes", rx: np.ndarray) -> None:
    """Raw captures through the native reader: both files held to numpy's
    conversion, their read times, and each replayed to a fix through the CLI
    in this process (the int8 capture through K5, one launch a block)."""
    from gypsum_tpu_torch.io.sources import (
        DecimatingSampleSource,
        FileSampleSource,
        convert_numpy,
    )

    class NumpyFileSource(FileSampleSource):
        """The plain version's source: numpy's conversion, no prefetch."""

        def _convert(self, start: int, count: int) -> np.ndarray:
            return convert_numpy(self._words, start, count, self.info.component_offset)

        def read_block(self, n_ms: int):
            ts, block = self.peek_block(n_ms)
            self._cursor += n_ms * self._spp
            return ts, block

    captures = write_raw_captures(scenes)
    for name, (path, info, _) in captures.items():
        hold_file_source(name, info)
    info = captures["raw_f32"][1]
    time_reads("raw_f32 FileSampleSource", lambda: FileSampleSource(info),
               lambda: NumpyFileSource(info))
    info8 = captures["raw_i8"][1]
    time_reads("raw_i8 DecimatingSampleSource(FileSampleSource), K5 on the card",
               lambda: DecimatingSampleSource(FileSampleSource(info8), FS, device=dev),
               lambda: DecimatingSampleSource(NumpyFileSource(info8), FS, device=dev))

    for name, (path, _, scale) in captures.items():
        reset_launches()
        out, wall = run_cli_here("--file", str(path), "--until-fix")
        n = launches()
        blocks = processed_blocks(out)
        fixes = cli_fixes(out)
        if not fixes or n["K1"] == 0:
            raise AssertionError(f"replay --file {path.name}: {len(fixes)} fixes, launches {n}:\n"
                                 f"{out[-2000:]}")
        err = float(np.linalg.norm(fixes[-1][0] - rx))
        if err >= 100.0:
            raise AssertionError(f"replay --file {path.name}: FIX {err:.1f} m from truth")
        if name == "raw_i8" and n["K5"] != blocks:
            raise AssertionError(f"replay --file {path.name}: {blocks} decimated blocks, "
                                 f"launches {n}")
        log(f"e2e CLI replay --file {path.name} --until-fix: FIX {err:.2f} m from truth after "
            f"{blocks} blocks; {wall:.2f} s wall; launches {n}")


def run_dashboard(dev, scenes: "Scenes", rx: np.ndarray) -> None:
    """The port's dashboard server on 127.0.0.1:0 in a thread and
    ``Receiver(device="cuda")`` over the 23 s scene with a
    ``DashboardClient`` and a ``TrackerVisualizer`` attached, held to
    tests/test_obs.py's bars; then ``replay --web-ui --render-figures`` with
    no server listening, in a scratch working directory, to its fix."""
    import base64
    import contextlib
    import threading
    import urllib.request

    from gypsum_tpu_torch.core.config import ObservabilityConfig, ReceiverConfig
    from gypsum_tpu_torch.io.sources import ArraySampleSource
    from gypsum_tpu_torch.obs import dashboard_server
    from gypsum_tpu_torch.obs.dashboard_client import DashboardClient
    from gypsum_tpu_torch.obs.visualizer import TrackerVisualizer
    from gypsum_tpu_torch.runtime.receiver import Receiver

    try:
        import matplotlib  # noqa: F401
    except ImportError:
        have_matplotlib = False
    else:
        have_matplotlib = True
    server = dashboard_server.ThreadingHTTPServer(("127.0.0.1", 0), dashboard_server._Handler)
    url = f"http://127.0.0.1:{server.server_address[1]}/"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        # A render every 5 s of signal: with matplotlib a render of the four
        # channels takes seconds of host.
        vis = TrackerVisualizer(render_period_s=5.0)
        client = DashboardClient(ObservabilityConfig(dashboard_url=url, dashboard_scan_period_s=0.0),
                                 visualizer=vis)
        recv = Receiver(ArraySampleSource(scenes.get("gps"), FS), ReceiverConfig(), device=dev)
        recv.add_block_listener(client.on_block)
        reset_launches()
        with LogLines("gypsum_tpu_torch.obs.visualizer") as warned:
            wall = timed_run(recv)
        n = launches()
        blocks = round(recv.source.seconds_consumed)

        def get(route: str) -> str:
            with urllib.request.urlopen(url + route, timeout=10) as resp:
                return resp.read().decode()

        state = json.loads(get("state.json"))
        pages = {route: get(route) for route in
                 ("", "satellite_infos", "receiver_stats", "tracker_visualizers")}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    errs = [float(np.linalg.norm(f.ecef - rx)) for f in recv.world.position_fixes]
    if not client._connected or state["metrics"]["blocks"] < 1 or \
            not set(SCENE_PRNS) <= set(state["tracked_prns"]):
        raise AssertionError(f"dashboard state: connected {client._connected}, blocks "
                             f"{state['metrics']['blocks']}, tracked {state['tracked_prns']}")
    needles = {"": ("gypsum_tpu", "initPanel"), "satellite_infos": ("PRN 25",),
               "receiver_stats": ("Signal time",), "tracker_visualizers": ("<body>",)}
    for route, want in needles.items():
        if not all(w in pages[route] for w in want):
            raise AssertionError(f"route /{route} lacks {want}: {pages[route][:500]}")
    if not errs or max(errs) >= 100.0 or n["K1"] != blocks:
        raise AssertionError(f"dashboard replay: fixes {errs} m, {blocks} blocks, launches {n}")
    pngs = {prn: base64.b64decode(b) for prn, b in vis.rendered_png_base64.items()}
    if have_matplotlib:
        import io

        import matplotlib.image

        shapes = [matplotlib.image.imread(io.BytesIO(p), format="png").shape for p in pngs.values()]
        if not set(SCENE_PRNS) <= set(pngs):
            raise AssertionError(f"figures rendered for {sorted(pngs)}")
        figures = f"{len(pngs)} PNGs, each decodes ({shapes[0]})"
    else:
        said = [line for line in warned.lines if "matplotlib" in line]
        if pngs or len(said) != 1:
            raise AssertionError(f"no matplotlib: {len(pngs)} PNGs rendered, warnings {said}")
        figures = f"no matplotlib here: no PNG rendered, one warning: {said[0]!r}"
    log(f"dashboard: Receiver(device='cuda') with DashboardClient + TrackerVisualizer, server "
        f"on {url}: state.json blocks {state['metrics']['blocks']}, tracked "
        f"{state['tracked_prns']}; the four routes serve their needles; {len(errs)} fixes, "
        f"last {errs[-1]:.2f} m; K1 launches {n['K1']} for {blocks} blocks; {figures}; "
        f"{wall:.2f} s wall")

    with tempfile.TemporaryDirectory() as cwd, contextlib.chdir(cwd):
        out, wall = run_cli_here("--file", str(scenes.path("gps")), "--until-fix",
                                 "--web-ui", "--render-figures")
        written = sorted(p.name for p in Path(cwd).rglob("*"))
    fixes = cli_fixes(out)
    if not fixes or np.linalg.norm(fixes[-1][0] - rx) >= 100.0 or written:
        raise AssertionError(f"replay --web-ui --render-figures: {len(fixes)} fixes, wrote "
                             f"{written}:\n{out[-2000:]}")
    log(f"e2e CLI replay --until-fix --web-ui --render-figures, no server listening: FIX "
        f"{np.linalg.norm(fixes[-1][0] - rx):.2f} m from truth; nothing written to its "
        f"working directory; {wall:.2f} s wall")


def run_profile_dir(scenes: "Scenes") -> None:
    """``replay --duration 3 --profile-dir``: the trace parses as JSON and
    holds the card's kernels (K1's among them)."""
    with tempfile.TemporaryDirectory() as prof:
        _, wall = run_cli_here("--file", str(scenes.path("gps")), "--duration", "3",
                               options=("--profile-dir", prof))
        traces = list(Path(prof).glob("replay.*.pt.trace.json"))
        if len(traces) != 1:
            raise AssertionError(f"--profile-dir wrote {traces}")
        size = traces[0].stat().st_size
        events = json.loads(traces[0].read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k1 = [e for e in kernels if "fixup_kernel" in e.get("name", "")]
    if not kernels:
        raise AssertionError(f"--profile-dir trace: {len(events)} events, no CUDA kernel")
    log(f"e2e CLI --profile-dir replay --duration 3: trace {size / 1e6:.1f} MB, {len(events)} "
        f"events, {len(kernels)} CUDA kernel events, {len(k1)} of them K1's; {wall:.2f} s wall")


def run_host_surfaces(dev, scenes: "Scenes") -> None:
    """The raw-capture reader, the dashboard and figures, and the profile
    flag on the card, with this step's wall."""
    from gypsum_tpu_torch.solve.geodesy import lla_to_ecef

    t0 = time.perf_counter()
    rx = lla_to_ecef(*TRUTH_LLA)
    run_raw_captures(dev, scenes, rx)
    run_dashboard(dev, scenes, rx)
    run_profile_dir(scenes)
    log(f"raw captures, dashboard, profile: {time.perf_counter() - t0:.1f} s wall")


# ---------------------------------------------------------- the campaign


CAMPAIGN_REFERENCE = ROOT / "tools" / "campaign_reference.jsonl"
# The full run's campaign trials (tools/campaign_torch.py): seeds 0 (8 SVs,
# 200 ms blocks, moving, a GEO with two fast-correction biases), 1 (6 SVs,
# 500 ms, moving with drift, a GEO), 11 (4 SVs, 200 ms), 17 (7 SVs, 500 ms,
# drift, a GEO with two biases) and seed 0 under a CW jammer through the
# notch front end. ``--campaign-only`` runs the whole recorded set.
CAMPAIGN_TRIALS = [("gps", 0, "none"), ("gps", 1, "none"), ("gps", 11, "none"),
                   ("gps", 17, "none"), ("gps", 0, "cw")]
CAMPAIGN_CAPTURES = ["campaign_sbas_ranging", "campaign_fast_corrections", "campaign_rescue",
                     "campaign_outage_reseed", "campaign_meaconing", "campaign_tdcp",
                     *(f"campaign_gps{s}" + ("" if imp == "none" else f"_{imp}")
                       for _, s, imp in CAMPAIGN_TRIALS)]


def campaign_spec(capture: str) -> dict:
    """The tools/campaign_torch.py spec a campaign capture synthesizes."""
    from tools import campaign_torch as twin

    name = capture.removeprefix("campaign_")
    if not name.startswith("gps"):
        return twin.scene_spec(next(s for s in twin.SCENES if twin.capture_of(s) == name))
    seed, _, impairment = name.removeprefix("gps").partition("_")
    return twin.gps_spec(int(seed), impairment or "none")


def campaign_runs() -> list[tuple[dict, str]]:
    """(spec, capture) of the full run's campaign phase: the nine scene runs
    (pairs share a capture) and the five trials."""
    from tools import campaign_torch as twin

    runs = [(twin.scene_spec(s), f"campaign_{twin.capture_of(s)}") for s in twin.SCENES]
    return runs + [(campaign_spec(c), c) for c in CAMPAIGN_CAPTURES if c.startswith("campaign_gps")]


def campaign_block_ms(spec: dict) -> int:
    """The block length a campaign run tracks at (K1's B)."""
    from tools import campaign_torch as twin

    if spec["kind"] == "gps":
        return twin.make_scenario(spec["seed"]).block_size_ms
    return twin.RESCUE_BLOCK_MS if spec.get("scene", "").startswith("rescue") else 1000


def hold_campaign_record(rec: dict, reference: list[dict], gate: bool = True) -> dict:
    """One campaign record on the card against its JAX record: not an
    error, the status and every fix's satellite set equal the record's
    (tools/campaign_torch.py:compare, the card's rung), and with ``gate``
    a scene at its test's bars and a trial within 15 m (status ``pass``).
    Returns the differences beside the ladder's bars."""
    from tools import campaign_torch as twin

    label = f"{twin.spec_label(rec)} (pipelined={rec['pipelined']})"
    if rec["status"] == "error":
        raise AssertionError(f"campaign {label}: {rec['error']}")
    ref = twin.reference_for(reference, rec, rec["pipelined"])
    if ref is None:
        raise AssertionError(f"campaign {label}: no JAX record in {CAMPAIGN_REFERENCE.name}")
    diffs = twin.compare(rec, ref, ladder=False)
    if diffs:
        raise AssertionError(f"campaign {label} (seed {rec.get('seed')}) diverges from the JAX "
                             "record:\n" + "\n".join(diffs))
    if gate and rec["status"] != "pass":
        raise AssertionError(f"campaign {label}: {rec['status']}, failed bars "
                             f"{rec.get('failed_bars')}, error {rec.get('position_error_m')} m")
    return twin.differences(rec, ref)


def run_campaign(dev, scenes: "Scenes", k1b: dict) -> None:
    """The six scenes of the JAX receiver tests (nine runs) and five
    campaign trials through the port on the card in its default pipelined
    mode, each held to its test's bars and to its pipelined JAX record
    (``hold_campaign_record``); K1's launches counted per block length."""
    from tools import campaign_torch as twin

    t_phase = time.perf_counter()
    reference = twin.load_records(CAMPAIGN_REFERENCE)
    api = twin.port_api(str(dev))
    records = []
    for spec, capture in campaign_runs():
        arrays, facts, synth_s = scenes.get_campaign(capture)
        block_ms = campaign_block_ms(spec)
        reset_launches()
        with preload_window(f"campaign {twin.spec_label(spec)}"):
            rec = twin.replay(spec, arrays, facts, api)
            torch.cuda.synchronize()
        n = launches()
        rec["synthesis_s"] = synth_s
        del arrays
        if not rec["pipelined"]:
            raise AssertionError(f"campaign {twin.spec_label(spec)} ran unpipelined")
        if n["K1"] == 0:
            raise AssertionError(f"campaign {twin.spec_label(spec)} never launched K1: {n}")
        if f"B{block_ms}" in k1b:
            k1b[f"B{block_ms}"].setdefault("launches_by_run", {})[twin.spec_label(spec)] = n["K1"]
            k1b[f"B{block_ms}"]["launches"] = k1b[f"B{block_ms}"].get("launches", 0) + n["K1"]
        d = hold_campaign_record(rec, reference)
        records.append(rec)
        log(f"campaign {twin.summary_line(rec)}; K1 {n['K1']} launches at B = {block_ms}; "
            f"against the pipelined JAX record: status and satellite sets equal, first fix "
            f"epoch {d['first_fix_epoch_diff_s']} s apart (ladder's bar 0), fix epochs equal "
            f"{d['fix_epochs_equal']}, positions up to {d['max_position_diff_m']} m apart "
            f"(bar 1), error difference {d['error_diff_m']} m")
    bars = twin.pair_bars(records)
    if bars:
        raise AssertionError("campaign: " + "; ".join(bars))
    log(f"campaign: {len(records)} runs met their bars and matched their JAX records; "
        f"replays {sum(r['replay_s'] for r in records):.2f} s, the phase "
        f"{time.perf_counter() - t_phase:.1f} s wall")


def run_campaign_set(dev, k1b: dict) -> None:
    """``--campaign-only``: every record of tools/campaign_reference.jsonl
    through the port on the card in its recorded mode (synthesis in worker
    processes, the replays here), each held by ``hold_campaign_record``;
    every trial runs before the phase fails, and the log has the pass counts
    per level and each difference."""
    from tools import campaign_torch as twin

    t_phase = time.perf_counter()
    reference = twin.load_records(CAMPAIGN_REFERENCE)
    specs = [{k: r[k] for k in ("kind", "seed", "impairment", "scene") if k in r}
             for r in reference]
    modes = [r["pipelined"] for r in reference]
    records, failures = [], []
    jobs = max(1, (os.cpu_count() or 2) - 2)
    by_length = Counter()
    reset_launches()
    for rec in twin.run_specs(specs, str(dev), jobs, modes=modes):
        # Counted from the last record's replay to this one's: only the
        # replays launch (the workers synthesize on the host).
        rec["k1_launches"] = launches()["K1"]
        by_length[campaign_block_ms(rec)] += rec["k1_launches"]
        reset_launches()
        rec["phase1"] = "bf16"
        records.append(rec)
        try:
            d = hold_campaign_record(rec, reference, gate=False)
            log(f"campaign set [{len(records)}/{len(specs)}] pipelined={rec['pipelined']} "
                f"{twin.summary_line(rec)}; against JAX: {json.dumps(d)}")
        except AssertionError as exc:
            failures.append(str(exc))
            log(f"campaign set [{len(records)}/{len(specs)}] FAILED: {exc}")
    for key, entry in k1b.items():
        entry["launches_campaign_set"] = by_length[int(key[1:])]
    out = ROOT / "build" / "campaign_set.jsonl"
    out.parent.mkdir(exist_ok=True)
    out.write_text("".join(json.dumps(r) + "\n" for r in records))
    twin.report(records, reference, ladder=False)
    for bar in twin.pair_bars(records):
        failures.append(bar)
    log(f"campaign set: {len(records)} runs, {sum(r['status'] in twin.ACCEPTED for r in records)} "
        f"passed; synthesis {sum(r['synthesis_s'] for r in records):.1f} s (worker processes), "
        f"replays {sum(r['replay_s'] for r in records):.1f} s; K1 launches by block length "
        f"{dict(sorted(by_length.items()))}; the phase "
        f"{time.perf_counter() - t_phase:.1f} s wall; records in {out.relative_to(ROOT)}")
    if failures:
        raise AssertionError(f"campaign set: {len(failures)} failure(s):\n" + "\n".join(failures))


# ------------------------------------------------------- the cold chain


# A cold start split in a process of its own: what a first acquisition pays
# before and at its first sweep (the counterparts of bench.py:427-459's
# acquisition_cold_s and acquisition_warm_s), on the 23 s scene's first
# 10 ms. Prints one JSON line of seconds.
COLD_SPLIT = """
import json, sys, time
t = [time.perf_counter()]
import torch
t.append(time.perf_counter())
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
t.append(time.perf_counter())
import numpy as np
from gypsum_tpu_torch.acquire.engine import shared_acquisition_engine
t.append(time.perf_counter())
eng = shared_acquisition_engine(2.046e6, 2046, device="cuda")
torch.cuda.synchronize()
t.append(time.perf_counter())
x = np.array(np.load(sys.argv[1], mmap_mode="r")[: 10 * 2046])
t0 = time.perf_counter()
hits = eng.detect(x)
cold = time.perf_counter() - t0
warm = []
for _ in range(5):
    t0 = time.perf_counter()
    eng.detect(x)
    warm.append(time.perf_counter() - t0)
print(json.dumps({"import_torch_s": t[1] - t[0], "cuda_context_s": t[2] - t[1],
                  "import_engine_s": t[3] - t[2], "engine_s": t[4] - t[3],
                  "sweep_cold_s": cold, "sweep_warm_s": sum(warm) / len(warm),
                  "detected": sorted(h.prn for h in hits)}))
"""


def copy_tree(work: Path, name: str) -> Path:
    """The port and this script copied to ``work/name``, as a fresh checkout
    has them: no build/ (no kernel, no native reader) and no bytecode."""
    tree = work / name
    shutil.copytree(ROOT / "gypsum_tpu_torch", tree / "gypsum_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy2(ROOT / "chip_smoke.py", tree / "chip_smoke.py")
    return tree


def replay_bits(recv) -> bytes:
    """A replay's acquisitions, pseudosymbol signs, subframes and fixes, as
    bytes that are equal only when the replays are equal to the bit."""
    ref = mesh_reference(recv)
    acq = [(h.prn, h.code_phase_samples, h.doppler_hz, h.carrier_phase_rad, h.strength)
           for r in recv.block_reports for h in r.newly_acquired]
    fixes = [(f.receiver_timestamp, sorted(f.satellites_used), np.asarray(f.ecef).tobytes())
             for f in ref["fixes"]]
    signs = sorted((prn, s.tobytes()) for prn, s in ref["signs"].items())
    return pickle.dumps((acq, signs, ref["subframes"], fixes))


def run_restart(dev, iq: np.ndarray, rx: np.ndarray) -> None:
    """Two Receivers with one config in this process, the process-wide
    engine and track program emptied first: the second shares the first's
    engine and track function, costs less to build, and replays the 23 s
    scene equal to the first to the bit."""
    from gypsum_tpu_torch.acquire import engine as engine_module
    from gypsum_tpu_torch.core.config import ReceiverConfig
    from gypsum_tpu_torch.io.sources import ArraySampleSource
    from gypsum_tpu_torch.runtime.receiver import Receiver
    from gypsum_tpu_torch.track import loop as loop_module

    engine_module._ENGINE_CACHE.clear()
    loop_module._TRACK_FN_CACHE.clear()
    build_ms, recvs = [], []
    with preload_window("restart: two Receivers, one config"):
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            recvs.append(Receiver(ArraySampleSource(iq, FS), ReceiverConfig(), device=dev))
            torch.cuda.synchronize()
            build_ms.append(1e3 * (time.perf_counter() - t0))
        for recv in recvs:
            recv.run()
    first, second = recvs
    same_fn, same_engine = first.bank._fn is second.bank._fn, first.acquisition is second.acquisition
    equal = replay_bits(first) == replay_bits(second)
    errs = [float(np.linalg.norm(f.ecef - rx)) for f in second.world.position_fixes]
    if not (same_fn and same_engine and equal) or not errs or max(errs) >= 2.0:
        raise AssertionError(f"restart: shared track function {same_fn}, engine {same_engine}, "
                             f"replays equal to the bit {equal}, fixes {errs} m")
    log(f"restart: Receiver construction {build_ms[0]:.3f} ms the first time (process-wide "
        f"engine and track program emptied), {build_ms[1]:.3f} ms the second with one config; "
        f"the two banks' _fn the same object: {same_fn}; one engine: {same_engine}; the second "
        f"replay of the 23 s scene equals the first to the bit (acquisitions, signs, "
        f"{len(mesh_reference(second)['subframes'])} subframes, {len(errs)} fixes, "
        f"{min(errs):.2f}-{max(errs):.2f} m from truth): {equal}")


def run_cold_chain(dev, scenes: "Scenes") -> None:
    """The port's cold start: the 23 s scene replayed to its fix by the CLI
    in processes of their own from fresh copies of the tree, cold with the
    preload, cold with GYPSUM_AOT=0 (K1 built at its first launch, the
    order before core/aot.py) and warm, each from spawn to exit; a cold
    start split in a fresh process; then the restart in this process."""
    from gypsum_tpu_torch.solve.geodesy import lla_to_ecef

    t_phase = time.perf_counter()
    rx = lla_to_ecef(*TRUTH_LLA)
    iq = scenes.get("gps")
    capture = scenes.path("gps")
    work = Path(tempfile.mkdtemp(prefix="gypsum-cold-"))
    try:
        runs = {}
        off_tree = None
        for label, aot_env in (("cold, preload", "1"), ("cold, GYPSUM_AOT=0", "0"),
                               ("warm", "1")):
            if label.startswith("cold"):
                tree = copy_tree(work, f"tree{len(runs)}")
                off_tree = tree
            else:
                tree = off_tree  # built by the GYPSUM_AOT=0 run
            runs[label] = run_cli(capture, rx, root=tree, env={"GYPSUM_AOT": aot_env},
                                  label=label)
            k1 = runs[label]["loads"].get("fixup")
            if k1 is None or (k1[1] == "built") != label.startswith("cold"):
                raise AssertionError(f"{label}: K1's library {k1}")
        parts = []
        for label, run in runs.items():
            how, built, seconds, waited = run["loads"]["fixup"]
            parts.append(f"{label} {run['wall']:.3f} s (K1 {how}, {built} in {seconds:.3f} s, "
                         f"its first launch waited {waited:.3f} s; fix {run['err']:.2f} m)")
        log("cold chain: python -m gypsum_tpu_torch replay --file <23 s GPS .npy> --until-fix "
            "from spawn to exit: " + "; ".join(parts))

        env = {**os.environ, "PYTHONPATH": str(ROOT)}
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", COLD_SPLIT, str(capture)], cwd=ROOT,
                              env=env, capture_output=True, text=True, timeout=300)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"the cold split failed:\n{proc.stderr[-3000:]}")
        split = json.loads(proc.stdout.strip().splitlines()[-1])
        if not set(SCENE_PRNS) <= set(split["detected"]):
            raise AssertionError(f"the cold split's sweep detected {split['detected']}")
        inside = sum(split[k] for k in ("import_torch_s", "cuda_context_s", "import_engine_s",
                                        "engine_s", "sweep_cold_s")) + 5 * split["sweep_warm_s"]
        log(f"cold split (a fresh process): import torch {split['import_torch_s']:.3f} s, first "
            f"CUDA touch {split['cuda_context_s']:.3f} s, import the engine "
            f"{split['import_engine_s']:.3f} s, shared_acquisition_engine "
            f"{split['engine_s']:.3f} s, first 10 ms 32-PRN sweep (cold, cuFFT plans) "
            f"{split['sweep_cold_s']:.4f} s, the next five's mean (warm) "
            f"{split['sweep_warm_s']:.4f} s (detected {split['detected']}); process start, the "
            f"capture's load and exit {wall - inside:.3f} s of {wall:.3f} s from spawn; the cold "
            f"sweep {'meets' if split['sweep_cold_s'] < 1.0 else 'misses'} BASELINE.json's "
            f"< 1 s target (a report, not a bar)")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    run_restart(dev, iq, rx)
    log(f"cold chain: {time.perf_counter() - t_phase:.1f} s wall")


# ------------------------------------------------------------- the mesh


MESH_DIR = ROOT / "build" / "mesh"  # each launch's FileStore, rank logs and results
MESH_LIMIT_S = 240.0  # a launch's time limit: every rank still running then is killed
MESH_PG_TIMEOUT_S = 60.0  # the process group's: a rank waiting on a failed peer raises by then
GLOO_CUDA_OPS = ("all_reduce", "all_gather", "broadcast", "all_gather_into_tensor",
                 "reduce_scatter_tensor", "reduce", "gather", "scatter", "all_to_all_single")


def mesh_launch(name: str, world: int, backend: str, scene: str = "",
                pg_timeout_s: float = MESH_PG_TIMEOUT_S):
    """Start ``world`` ranks (``python3 chip_smoke.py --mesh-rank=...``),
    every one on cuda:0, meeting through a FileStore under build/ (no port
    to collide on). Returns the launch for ``mesh_wait``."""
    directory = MESH_DIR / name
    shutil.rmtree(directory, ignore_errors=True)
    directory.mkdir(parents=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    # The ranks talk over the loopback only.
    env.update(GLOO_SOCKET_IFNAME="lo", NCCL_SOCKET_IFNAME="lo", NCCL_IB_DISABLE="1")
    procs = [
        subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"),
             f"--mesh-rank={name},{rank},{world},{backend},{pg_timeout_s},{scene}"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=ROOT, env=env,
        )
        for rank in range(world)
    ]
    return name, directory, procs, time.perf_counter()


def mesh_wait(launch, expect_failure: bool = False) -> tuple[list, float]:
    """Wait for a launch's ranks, each rank's output logged. Fails if the
    time limit had to kill a rank, or if a rank failed (with
    ``expect_failure``: if one did not). Returns (each rank's result, the
    launch's wall seconds)."""
    name, directory, procs, t0 = launch
    outs, killed = [], False
    try:
        for p in procs:
            try:
                out, _ = p.communicate(timeout=max(0.1, t0 + MESH_LIMIT_S - time.perf_counter()))
            except subprocess.TimeoutExpired:
                killed = True
                p.kill()
                out, _ = p.communicate()
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for rank, out in enumerate(outs):
        for line in out.strip().splitlines()[-30:]:
            log(f"  [{name} rank {rank}] {line}")
    rcs = [p.returncode for p in procs]
    if killed:
        raise AssertionError(f"mesh {name}: a rank ran into the {MESH_LIMIT_S:.0f} s limit and "
                             f"was killed (return codes {rcs})")
    if expect_failure:
        if 0 in rcs:
            raise AssertionError(f"mesh {name}: a rank should have failed, return codes {rcs}")
        return [], wall
    if any(rcs):
        raise AssertionError(f"mesh {name}: rank(s) failed, return codes {rcs}")
    return [pickle.loads((directory / f"rank{r}.pkl").read_bytes())
            for r in range(len(procs))], wall


def mesh_rank(spec: str) -> int:
    """One rank of a launch (``mesh_launch``), on cuda:0."""
    import torch.distributed as dist

    from gypsum_tpu_torch.ops.fixup import FIXUP_KERNEL
    from gypsum_tpu_torch.parallel.mesh import make_receiver_mesh

    name, rank, world, backend, pg_timeout_s, scene = spec.split(",")
    rank, world = int(rank), int(world)
    directory = MESH_DIR / name
    torch.cuda.set_device(0)  # one card: every rank on it, set before the mesh is built
    dev = torch.device("cuda:0")
    KERNELS["K1"] = FIXUP_KERNEL
    dist.init_process_group(
        backend, store=dist.FileStore(str(directory / "store"), world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=float(pg_timeout_s)))
    try:
        if name == "probe":
            result = gloo_probe(rank, world, dev, directory)
        else:
            result = mesh_steps(make_receiver_mesh("cuda", world, 1), dev, scene)
        (directory / f"rank{rank}.pkl").write_bytes(pickle.dumps(result))
    finally:
        dist.destroy_process_group()
    return 0


def gloo_probe(rank: int, world: int, dev, directory: Path) -> dict:
    """Which collectives gloo takes on CUDA tensors (each result checked),
    then a rank that fails: rank 1 raises before a last all_reduce, which
    rank 0 enters and must leave with an error, not wait in forever. Each
    op's outcome is appended to a file as it comes, so a crash still says
    where."""
    import torch.distributed as dist

    def full(v, n=world):
        return torch.full((n,), float(v), device=dev)

    want_sum = float(sum(range(1, world + 1)))
    ranks_plus_1 = [float(r + 1) for r in range(world)]

    def run(op: str) -> bool:
        """One collective on CUDA tensors; True when its result is right."""
        mine = full(rank + 1)
        if op == "all_reduce":
            dist.all_reduce(mine)
            return bool(mine.eq(want_sum).all())
        if op == "all_gather":
            parts = [full(0) for _ in range(world)]
            dist.all_gather(parts, mine)
            return [float(p[0]) for p in parts] == ranks_plus_1
        if op == "broadcast":
            dist.broadcast(mine, src=0)
            return bool(mine.eq(1.0).all())
        if op == "all_gather_into_tensor":
            whole = full(0, world * world)
            dist.all_gather_into_tensor(whole, mine)
            return whole.reshape(world, world)[:, 0].tolist() == ranks_plus_1
        if op == "reduce_scatter_tensor":
            part = full(0, 1)
            dist.reduce_scatter_tensor(part, mine)
            return bool(part.eq(want_sum).all())
        if op == "reduce":
            dist.reduce(mine, dst=0)
            return bool(mine.eq(want_sum if rank == 0 else rank + 1).all())
        if op == "gather":
            parts = [full(0) for _ in range(world)] if rank == 0 else None
            dist.gather(mine, parts, dst=0)
            return rank != 0 or [float(p[0]) for p in parts] == ranks_plus_1
        if op == "scatter":
            got = full(0)
            dist.scatter(got, [full(r + 1) for r in range(world)] if rank == 0 else None, src=0)
            return bool(got.eq(rank + 1).all())
        if op == "all_to_all_single":
            got = full(0)
            dist.all_to_all_single(got, mine)
            return got.tolist() == ranks_plus_1
        raise ValueError(op)

    taken = {}
    with open(directory / f"probe{rank}.txt", "w") as f:
        for op in GLOO_CUDA_OPS:
            f.write(f"{op}: ...\n")
            f.flush()
            try:
                ok = run(op)
                torch.cuda.synchronize()
                taken[op] = "taken" if ok else "taken, wrong result"
            except Exception as exc:  # noqa: BLE001 — the probe records what gloo refuses
                taken[op] = "refused: " + str(exc).strip().splitlines()[0][:160]
            f.write(f"{op}: {taken[op]}\n")
            f.flush()
    (directory / f"rank{rank}.pkl").write_bytes(pickle.dumps(taken))
    print(f"gloo on CUDA tensors: {taken}", flush=True)
    if rank == 1:
        raise RuntimeError("rank 1 fails before its collective")
    t0 = time.perf_counter()
    try:
        dist.all_reduce(full(1))
    finally:
        print(f"rank 0 left the all_reduce after {time.perf_counter() - t0:.2f} s", flush=True)
    return taken


def mesh_steps(mesh, dev, scene: str) -> dict:
    """The five steps of __graft_entry__.py:dryrun_multichip on this rank:
    the sharded sweep, the halo sweep, the channel-sharded scan block, the
    sharded fast tracker (K1) and ``Receiver(mesh=...)`` on the 23 s scene.
    Each step is held here against its single-device run on the same card;
    the replay's reports go back for the parity ladder."""
    import torch.distributed as dist

    from gypsum_tpu_torch.core.config import ReceiverConfig, TrackingConfig
    from gypsum_tpu_torch.core.planes import to_complex, to_planes
    from gypsum_tpu_torch.io.sources import ArraySampleSource
    from gypsum_tpu_torch.ops import fixup as fx
    from gypsum_tpu_torch.ops.correlate import (
        noncoherent_acquisition_sweep,
        peak_strength,
        replica_fft_conj_table,
    )
    from gypsum_tpu_torch.parallel import sharded
    from gypsum_tpu_torch.parallel.mesh import all_gather_cat, mesh_shape
    from gypsum_tpu_torch.parallel.streaming import (
        _chunk_linear_power,
        linear_replica_fft_conj,
        time_sharded_correlation_power,
    )
    from gypsum_tpu_torch.runtime.receiver import Receiver
    from gypsum_tpu_torch.signal.prn import replica_table, sampled_replica
    from gypsum_tpu_torch.track.loop import TrackState, carry_rows, make_track_block_fn

    rank, world = dist.get_rank(), dist.get_world_size()
    n_sat = mesh_shape(mesh)["sat"]
    out = {"mesh": mesh_shape(mesh)}
    log(f"rank {rank} of {world}, {dist.get_backend()}, mesh {out['mesh']}, "
        f"{torch.cuda.get_device_name(dev)}")

    def hold(what, got, want, rtol, atol):
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=rtol, atol=atol):
            raise AssertionError(f"{what}: differs from the single-device run by up to {err:.3g} "
                                 f"(rtol {rtol}, atol {atol})")
        return err

    # 1. The sharded sweep over PRN rows, the all-reduce argmax; PRN 7 planted.
    t0 = time.perf_counter()
    reps = replica_table(L)
    n_rows = n_sat * -(-32 // n_sat)
    pfc = torch.from_numpy(to_planes(replica_fft_conj_table(reps[np.arange(n_rows) % 32]))).to(dev)
    rng = np.random.default_rng(0)
    iq_ms = (0.5 * (rng.standard_normal((2, L)) + 1j * rng.standard_normal((2, L)))
             + 0.4 * sampled_replica(7, L)[None, :]).astype(np.complex64)
    samples_ms = torch.from_numpy(to_planes(iq_ms)).to(dev)
    dops = torch.arange(-1000.0, 1001.0, 500.0, device=dev)
    strength, d_idx, code_phase, row, val = sharded.sharded_acquisition_sweep(
        mesh, samples_ms, dops, pfc, FS)
    noncoh = noncoherent_acquisition_sweep(to_complex(samples_ms), dops, to_complex(pfc), FS)
    flat = torch.argmax(noncoh.reshape(n_rows, -1), dim=-1)
    ref_strength = peak_strength(noncoh[torch.arange(n_rows, device=dev), flat // L])
    if int(row) % 32 != 6 or not torch.isfinite(strength).all():
        raise AssertionError(f"sharded sweep: best row {int(row)}, PRN 7 was planted")
    if not (torch.equal(d_idx.long(), flat // L) and torch.equal(code_phase.long(), flat % L)):
        raise AssertionError("sharded sweep: Doppler or code-phase indices differ")
    err = hold("sharded sweep strength", strength, ref_strength, 1e-5, 0.0)
    log(f"M step 1, sharded sweep ({n_rows} rows, {n_rows // n_sat} a rank): best row "
        f"{int(row)} (PRN 7), strength {float(val):.2f}; indices equal to the single-device "
        f"sweep's, strengths within {err:.3g}; {1e3 * (time.perf_counter() - t0):.1f} ms")

    # 2. The halo sweep: a burst across the rank 0 -> 1 edge where there is
    # one (4 chunks at world 1 and 2).
    t0 = time.perf_counter()
    n_chunks = 2 * max(world, 2)
    rep = reps[4].astype(np.float32)
    iq = (0.3 * (rng.standard_normal(n_chunks * L) + 1j * rng.standard_normal(n_chunks * L))
          ).astype(np.complex64)
    pos = 2 * L - 700
    iq[pos:pos + L] += 0.8 * rep
    iq_t = torch.from_numpy(iq).to(dev)
    power = time_sharded_correlation_power(mesh, torch.view_as_real(iq_t).contiguous(), rep)
    pfc2 = torch.from_numpy(linear_replica_fft_conj(rep)).to(dev)
    ref_power = _chunk_linear_power(torch.cat([iq_t, iq_t[:L]]), pfc2, L)
    err = hold("halo sweep", power, ref_power, 1e-4, 1e-3)
    ci, lag = divmod(int(torch.argmax(power)), L)
    if ci * L + lag != pos:
        raise AssertionError(f"halo sweep: burst found at {ci * L + lag}, planted at {pos}")
    log(f"M step 2, halo sweep ({n_chunks} chunks, {n_chunks // world} a rank): burst at "
        f"sample {pos} found; "
        f"within {err:.3g} of the single-device linear correlation; "
        f"{1e3 * (time.perf_counter() - t0):.1f} ms")

    sats, block = synthetic_block(dev)

    def inputs(cfg):
        bank, replicas = checks_bank(sats, dev, cfg, off_air=False)
        return TrackState(*(a.copy() for a in bank.state)), replicas

    def hold_tracker(what, outs, carry, ref_outs, ref_carry):
        """Every output and carry row within 1e-3 of its scale, locked,
        lost and the step count exact: the bar of tests/test_torch_tracker.py
        for phase-1 sums taken in another order (cuBLAS may take another
        GEMM for a shard's [2046, 2 S NLE] than for the whole's), which the
        loop integrates over the block's 1000 ms."""
        errs = []
        for name, got, want in (("outputs", outs, ref_outs), ("carry", carry, ref_carry)):
            for r in range(got.shape[-2]):
                a, b = got[..., r, :], want[..., r, :]
                errs.append(hold(f"{what} {name} row {r}", a, b, 0.0,
                                 1e-3 * max(1.0, float(b.abs().max()))))
        if not (torch.equal(outs[:, fx.O_LOCKED], ref_outs[:, fx.O_LOCKED])
                and torch.equal(outs[:, fx.O_LOST], ref_outs[:, fx.O_LOST])
                and torch.equal(carry[fx.STEP], ref_carry[fx.STEP])):
            raise AssertionError(f"{what}: locked, lost or the step count differs")
        return max(errs)

    # 3. The channel-sharded scan block: this rank's slice through the per-ms
    # scan tracker (200 ms), gathered over 'sat'.
    t0 = time.perf_counter()
    cfg = TrackingConfig(block_size_ms=200, use_matmul_tracker=False,
                         use_pallas_block_tracker=False)
    state, replicas = inputs(cfg)
    whole = make_track_block_fn(cfg, L, FS, N_CH, device=dev)
    ref_state, ref_outs = whole.packed(state, block[:200], replicas)
    local = make_track_block_fn(cfg, L, FS, N_CH // n_sat, device=dev)
    st, outs = local.packed(*sharded.shard_tracking_inputs(mesh, state, block[:200], replicas))
    group = mesh.get_group("sat")
    err = hold_tracker("scan block", all_gather_cat(outs, group, 2),
                       all_gather_cat(torch.stack(carry_rows(st)), group, 1),
                       ref_outs, torch.stack(carry_rows(ref_state)))
    log(f"M step 3, channel-sharded scan block (200 ms, {N_CH // n_sat} of {N_CH} channels a "
        f"rank): within {err:.3g} of the unsharded block; {time.perf_counter() - t0:.2f} s")

    # 4. The sharded fast tracker: phase 1 and K1 on each rank's channels.
    cfg = TrackingConfig()
    state, replicas = inputs(cfg)
    whole = make_track_block_fn(cfg, L, FS, N_CH, device=dev)
    fast = sharded.make_sharded_track_block_fn(mesh, cfg, L, FS, N_CH, device=dev)
    ref_state, ref_outs = whole.packed(state, block, replicas)
    got_state, got_outs = fast.packed(state, block, replicas)
    got_carry, ref_carry = torch.stack(carry_rows(got_state)), torch.stack(carry_rows(ref_state))
    identical = torch.equal(got_outs, ref_outs) and torch.equal(got_carry, ref_carry)
    diff = max(float((got_outs - ref_outs).abs().max()), float((got_carry - ref_carry).abs().max()))
    err = hold_tracker("fast tracker", got_outs, got_carry, ref_outs, ref_carry)
    # K1 on this rank's slice of the unsharded phase 1 is K1's slice.
    _, init, corr_r, corr_i = whole.phase1(state, block, replicas)
    rows = sharded._sat_block(mesh, N_CH, "channels")
    fin_s, outs_s = fx.fixup_cuda(init[:, rows].contiguous(), corr_r[:, rows].contiguous(),
                                  corr_i[:, rows].contiguous(), whole.fixup_params)
    fin_w, outs_w = fx.fixup_cuda(init, corr_r, corr_i, whole.fixup_params)
    if not (torch.equal(outs_s, outs_w[:, :, rows]) and torch.equal(fin_s, fin_w[:, rows])):
        raise AssertionError("fast tracker: K1 on this rank's channels differs from its slice")

    def per_call_ms(fn, n=10):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n, 1e3 * (time.perf_counter() - t0) / n

    rows_block = torch.zeros(1000 * fx.N_OUT + 9, N_CH // n_sat, device=dev)
    whole_ms = per_call_ms(lambda: whole.packed(state, block, replicas))
    fast_ms = per_call_ms(lambda: fast.packed(state, block, replicas))
    gather_ms = per_call_ms(lambda: all_gather_cat(rows_block, group, 1))
    out["block_ms"] = {"unsharded": whole_ms, "sharded": fast_ms, "all_gather": gather_ms}
    log(f"M step 4, sharded fast tracker (1000 ms, {N_CH // n_sat} of {N_CH} channels a "
        f"rank): {'identical to the bit to' if identical else f'within {err:.3g} of'} the "
        f"unsharded tracker (max |diff| {diff:.3g}); K1 on this rank's channels identical to "
        f"the bit to its slice of K1 on all {N_CH}. One 1000 ms block (events; host clock): "
        f"unsharded {whole_ms[0]:.3f}; {whole_ms[1]:.3f} ms, sharded {fast_ms[0]:.3f}; "
        f"{fast_ms[1]:.3f} ms, of which the all_gather of its [{rows_block.shape[0]}, "
        f"{rows_block.shape[1]}] float32 rows {gather_ms[0]:.3f}; {gather_ms[1]:.3f} ms")
    del block

    # 5. Receiver(mesh=...) replays the 23 s scene; the all_gather of each
    # block between events, K1's launches counted around the run.
    iq = np.load(scene)
    gathers = []
    plain_gather = sharded.all_gather_cat

    def timed_gather(t, grp, dim):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        res = plain_gather(t, grp, dim)
        end.record()
        gathers.append((start, end, 1e3 * (time.perf_counter() - t0)))
        return res

    sharded.all_gather_cat = timed_gather
    recv = Receiver(ArraySampleSource(iq, FS), ReceiverConfig(), device=dev, mesh=mesh)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    recv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sharded.all_gather_cat = plain_gather
    out["k1_launches"] = launches()["K1"]
    dev_ms = [s.elapsed_time(e) for s, e, _ in gathers]
    host_ms = [h for _, _, h in gathers]
    out["local_channels"] = recv.bank._fn.local_channels
    out["blocks"] = round(recv.source.seconds_consumed)  # 1000 ms blocks dispatched
    out["reports"] = recv.block_reports
    log(f"M step 5, Receiver(device='cuda', mesh=...): {out['blocks']} blocks, "
        f"{len(recv.world.position_fixes)} fixes, {wall:.2f} s wall for "
        f"{recv.source.seconds_consumed:.0f} s of signal; K1 launches {out['k1_launches']} "
        f"at S={out['local_channels']}; the all_gather {len(gathers)} times, mean "
        f"{np.mean(dev_ms):.3f} ms between events, {np.mean(host_ms):.3f} ms host")
    return out


def mesh_reference(recv) -> dict:
    """What the parity ladder reads of a replay (tests/test_multichip_receiver.py)."""
    return {
        "acq": [(h.prn, h.code_phase_samples) for h in recv.block_reports[0].newly_acquired],
        "signs": signs_by_prn(recv),
        "subframes": [(prn, ev.decoded.handover.tow_count, ev.decoded.handover.subframe_id.value)
                      for r in recv.block_reports for prn, ev in r.subframes],
        "fixes": [r.fix for r in recv.block_reports if r.fix is not None],
    }


def hold_ladder(label: str, reports, ref: dict, rx: np.ndarray) -> str:
    """The parity ladder against the single-device card replay: equal
    acquisitions, > 99.9 % sign agreement, equal subframes, equal fix epochs
    and sets, positions within 1 m; every fix < 2 m from truth."""
    from types import SimpleNamespace

    got = mesh_reference(SimpleNamespace(block_reports=reports))
    if got["acq"] != ref["acq"]:
        raise AssertionError(f"{label}: acquisitions {got['acq']} != {ref['acq']}")
    agree = {}
    for prn in SCENE_PRNS:
        a, b = ref["signs"][prn], got["signs"].get(prn)
        if b is None or a.shape != b.shape:
            raise AssertionError(f"{label}: PRN {prn}'s pseudosymbol stream differs in length")
        agree[prn] = float(np.mean(a == b))
        if agree[prn] <= 0.999:
            raise AssertionError(f"{label}: PRN {prn} sign agreement {agree[prn]:.4%}")
    if got["subframes"] != ref["subframes"] or len(got["subframes"]) < 3 * len(SCENE_PRNS):
        raise AssertionError(f"{label}: subframe streams differ")
    fa, fb = ref["fixes"], got["fixes"]
    if not fb or len(fa) != len(fb):
        raise AssertionError(f"{label}: {len(fb)} fixes, the single-device replay {len(fa)}")
    apart, errs = [], []
    for sa, sb in zip(fa, fb):
        if sa.receiver_timestamp != sb.receiver_timestamp or \
                sorted(sa.satellites_used) != sorted(sb.satellites_used):
            raise AssertionError(f"{label}: fix epochs or satellite sets differ")
        apart.append(float(np.linalg.norm(sa.ecef - sb.ecef)))
        errs.append(float(np.linalg.norm(sb.ecef - rx)))
    if max(apart) >= 1.0 or max(errs) >= 2.0:
        raise AssertionError(f"{label}: fixes {apart} m from the single-device run's, "
                             f"{errs} m from truth")
    return (f"acquisitions equal, sign agreement {min(agree.values()):.4%} or more, "
            f"{len(got['subframes'])} subframes equal, {len(fb)} "
            f"fixes at the same epochs on the same satellites, at most {max(apart):.3f} m from "
            f"the single-device run's, {min(errs):.2f}-{max(errs):.2f} m from truth")


def run_mesh(scenes: "Scenes", ref: dict, rx: np.ndarray, k1m: dict) -> None:
    """Scale-out on one card: gloo's collectives on CUDA tensors and a
    failing rank (two ranks), M1 (NCCL, world 1) and M2 (gloo, world 2, both
    ranks on cuda:0, sat 2 x time 1), each rank's steps held there, each
    replay held to the parity ladder here; both M2 ranks' reports must be
    the same bytes."""
    scene = str(scenes.path("gps"))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    probe = mesh_launch("probe", 2, "gloo", pg_timeout_s=20.0)
    _, probe_wall = mesh_wait(probe, expect_failure=True)
    taken = {}
    for rank in range(2):
        text = (MESH_DIR / "probe" / f"probe{rank}.txt").read_text()
        taken[rank] = [line for line in text.splitlines() if not line.endswith("...")]
    log(f"mesh probe (gloo, 2 ranks on cuda:0): rank 0: {'; '.join(taken[0])}")
    if taken[0] != taken[1]:
        log(f"mesh probe: rank 1 saw otherwise: {'; '.join(taken[1])}")
    for op in ("all_reduce", "all_gather", "broadcast"):
        if f"{op}: taken" not in taken[0]:
            raise AssertionError(f"gloo did not take {op} on CUDA tensors")
    log(f"mesh probe: rank 1 raised before its collective, rank 0 failed out of it; the launch "
        f"failed in {probe_wall:.1f} s, inside its {MESH_LIMIT_S:.0f} s limit")

    results = {}
    for label, world, backend in (("M1", 1, "nccl"), ("M2", 2, "gloo")):
        ranks, wall = mesh_wait(mesh_launch(label, world, backend, scene))
        for rank, res in enumerate(ranks):
            summary = hold_ladder(f"{label} rank {rank}", res["reports"], ref, rx)
            if res["k1_launches"] != res["blocks"]:
                raise AssertionError(f"{label} rank {rank}: {res['k1_launches']} K1 launches for "
                                     f"{res['blocks']} blocks")
            log(f"{label} ({backend}, world {world}) rank {rank}: Receiver(mesh=...) against "
                f"Receiver(device='cuda'): {summary}; K1 {res['k1_launches']} launches at "
                f"S={res['local_channels']}")
        if world > 1 and len({pickle.dumps(r["reports"]) for r in ranks}) != 1:
            raise AssertionError(f"{label}: the ranks' block reports differ")
        results[label] = ranks
        log(f"mesh {label}: {world} rank(s), {backend}; {wall:.1f} s wall for the launch "
            f"(process start, the five steps, the replay)")
    k1m["launches"] = results["M2"][0]["k1_launches"]
    k1m["mesh_launches"] = {label: [r["k1_launches"] for r in ranks]
                            for label, ranks in results.items()}
    k1m["gloo_cuda_collectives"] = taken[0]
    k1m["mesh_block_ms"] = {label: ranks[0]["block_ms"] for label, ranks in results.items()}
    log(f"mesh phase: {time.perf_counter() - t0:.1f} s wall")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA card",
              file=sys.stderr)
        return 1
    ranks = [a for a in sys.argv[1:] if a.startswith("--mesh-rank=")]
    if ranks:
        return mesh_rank(ranks[0].partition("=")[2])
    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    SMI.append(smi)
    log(smi)
    log(f"device: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    flags = [a for a in sys.argv[1:] if a.startswith("--kernels-only")]
    if flags:
        return smoke(dev, flags[0].partition("=")[2], None)
    short = next((m for m in ("mesh", "cold", "campaign") if f"--{m}-only" in sys.argv[1:]),
                 None)
    tmp = tempfile.TemporaryDirectory()
    scenes = Scenes({None: SCENE_NAMES, "campaign": []}.get(short, ["gps"]), tmp.name)
    try:
        return smoke(dev, short, scenes)
    finally:
        scenes.close()
        tmp.cleanup()


# The replays' scenes (``synthesize_named``), in the order they are needed,
# except the array scene (four syntheses of 23 s, the longest), which
# starts first.
SCENE_NAMES = ["gps", "array", "gps_8x", "fade", "glonass", "glonass_8x", "dual_gps",
               "dual_glonass", "rtk_base", "rtk_rover", "iono_l1", "iono_l2", "notch",
               "rtk_clock", *CAMPAIGN_CAPTURES]


def smoke(dev, only: str | None, scenes: Scenes | None) -> int:
    """Everything after the device check: with ``only`` (names, or "" for
    all) the kernel checks alone, with ``only="mesh"`` K1 M, the farm and
    the mesh phase on the GPS scene, with ``only="cold"`` the cold chain on
    it, else the whole run on ``scenes``."""
    from gypsum_tpu_torch.core.config import ReceiverConfig
    from gypsum_tpu_torch.core.device import resolve_device
    from gypsum_tpu_torch.io.sources import ArraySampleSource, DecimatingSampleSource
    from gypsum_tpu_torch.runtime.receiver import Receiver
    from gypsum_tpu_torch.solve.geodesy import lla_to_ecef
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
    if only == "cold":
        # A short run for work on the cold chain (no result line).
        run_cold_chain(dev, scenes)
        log("preload against launches (path, preloaded, launched): " + json.dumps(PRELOAD_CHECKS))
        return 0
    t0 = time.perf_counter()
    built = kernels.build_all([k.source for k in (*KERNELS.values(), EMPTY_KERNEL)])
    log(f"build: {', '.join(f'{k} {v:.2f} s' for k, v in built.items())} "
        f"({time.perf_counter() - t0:.2f} s wall, nvcc sm_90a, in parallel)")

    sats, samples = synthetic_block(dev)
    glonass_blocks = {}

    def glonass():
        """The GLONASS checks' two 1000 ms blocks, synthesized at first use."""
        if not glonass_blocks:
            glonass_blocks.update(l1=glonass_block("l1", dev), l2=glonass_block("l2", dev))
        return glonass_blocks

    deep_cache = []

    def deep_inputs():
        """The default deep search's scene, synthesized at first use."""
        if not deep_cache:
            deep_cache.extend(deep_scene())
        return deep_cache

    checks = {
        "K1": lambda: check_fixup(dev, sats, samples),
        "K2": lambda: check_peak_reduce(dev),
        "K3": lambda: check_track_block(dev, sats, samples),
        "K4": lambda: check_wipeoff_lag(dev, sats, samples),
        "K5": lambda: check_fir_decimate(dev),
        "K1G": lambda: check_fixup_glonass(dev, glonass()),
        "K2G": lambda: check_peak_reduce_glonass(dev, glonass()["l1"][2]),
        "K4G": lambda: check_wipeoff_lag_glonass(dev, glonass()),
        "K5G": lambda: check_fir_decimate_glonass(dev),
        "K2D": lambda: check_peak_reduce_deep(dev, *deep_inputs()),
        "K1M": lambda: check_fixup_mesh(dev, sats, samples),
        "K1B200": lambda: check_fixup_block_length(dev, sats, samples, 200),
        "K1B500": lambda: check_fixup_block_length(dev, sats, samples, 500),
    }
    if only == "mesh":
        # A short run for work on scale-out (no result line).
        k1m = checks["K1M"]()
        k1m["farm_launches"] = check_farm(dev, sats, samples)
        del samples
        rx = lla_to_ecef(*TRUTH_LLA)
        recv = run_receiver(scenes.get("gps"), rx, dev)[0]
        run_mesh(scenes, mesh_reference(recv), rx, k1m)
        log(json.dumps({"kernels": [k1m]}))
        return 0
    if only == "campaign":
        # The whole recorded campaign set (no result line).
        k1b = {"B200": checks["K1B200"](), "B500": checks["K1B500"]()}
        del samples
        torch.cuda.empty_cache()
        run_campaign_set(dev, k1b)
        log(json.dumps({"kernels": list(k1b.values())}))
        return 0
    if only is not None:
        # A short run for work on a kernel: the checks of the kernels named
        # (all of them without names); no replay, so no launch counts and
        # no result line.
        names = only.split(",") if only else list(checks)
        log(json.dumps({"kernels": [checks[name]() for name in names]}))
        return 0
    entries = {name: check() for name, check in checks.items()}
    check_scan_variants(dev, sats, samples)
    entries["K1M"]["farm_launches"] = check_farm(dev, sats, samples)
    del samples, glonass_blocks
    torch.cuda.empty_cache()
    k1, k2, k3, k4, k5 = (entries[k] for k in ("K1", "K2", "K3", "K4", "K5"))

    iq = scenes.get("gps")
    rx = lla_to_ecef(*TRUTH_LLA)
    run_cli(scenes.path("gps"), rx)

    # The main paths: counts set to 0 just before each run, read just after.
    reset_launches()
    recv, acq_a, errs_a, wall_a = run_receiver(iq, rx, dev, peak_kernel=False)
    n = launches()
    mesh_ref = mesh_reference(recv)  # what the mesh replays are held to
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
    iq_fast = scenes.get("gps_8x")
    run_cli(scenes.path("gps_8x"), rx, "--sample-rate", f"{FS_FAST:.0f}")
    reset_launches()
    read_s = []

    def timed(read_block):
        def timed_read(n_ms):
            t = time.perf_counter()
            out = read_block(n_ms)
            read_s.append(time.perf_counter() - t)
            return out

        return timed_read

    with preload_window("Receiver(DecimatingSampleSource)"):
        source = DecimatingSampleSource(ArraySampleSource(iq_fast, FS_FAST), FS, device=dev)
        source.read_block = timed(source.read_block)
        recv_g, _, errs_g, wall_g = run_receiver(None, rx, dev, source=source)
    n = launches()
    k5["launches"] = n["K5"]
    if n["K5"] < len(read_s) or n["K1"] == 0:
        raise AssertionError(f"the decimated replay read {len(read_s)} blocks and launched {n}")
    log(f"e2e Receiver(DecimatingSampleSource(8.184 -> 2.046 Msps), device='cuda'): "
        f"{len(errs_g)} fixes, best {min(errs_g):.2f} m, last {errs_g[-1]:.2f} m; {wall_g:.2f} s "
        f"wall for {source.seconds_consumed:.0f} s of signal; launches {n}; the source's "
        f"read_block (host buffer, 65 MB upload, K5, 16 MB download) mean "
        f"{1e3 * np.mean(read_s):.1f} ms per block; {recv_g.collect}")
    del iq_fast, source, recv_g

    # The circulant sweep: on the 23 s scene's first 10 ms, then the scene
    # replayed through it (K1 and K2), held to the default run.
    run_circulant_sweep(dev, scenes, iq, rx, recv, acq_a)

    track_ms, acq_ms = block_timings(recv, iq)
    log(f"timing: one 1000 ms tracking block (phase 1 bf16 matmul with float32 "
        f"output + K1) {track_ms:.3f} ms; one 10 ms acquisition sweep {acq_ms:.3f} ms")

    profile_run(lambda: Receiver(ArraySampleSource(iq, FS), ReceiverConfig(), device=dev))
    uninterrupted = [(round(r.block_end, 1), r.fix.ecef) for r in recv.block_reports
                     if r.fix is not None]
    del iq, recv

    # The GLONASS bands: the K1, K2, K4 and K5 entries at GLONASS inputs get
    # their launches from these replays.
    run_glonass_replays(dev, scenes, *(entries[k] for k in ("K1G", "K2G", "K4G", "K5G")))

    # Deep acquisition (K2 D gets its launches here), the deep-fade replay
    # through the coast tier's deep measurement, and checkpoints.
    run_deep_searches(dev, scenes, entries["K2D"])
    fade_iq = scenes.get("fade")
    fade_recv = run_fade_replay(dev, fade_iq, pipelined=False)
    run_fade_replay(dev, fade_iq, pipelined=True)
    run_checkpoints(dev, scenes, fade_recv, uninterrupted)
    profile_run(lambda: Receiver(ArraySampleSource(fade_iq, FS),
                                 fade_config(pipeline_tracking=False), device=dev))
    del fade_iq, fade_recv

    # The interference front ends: the STFT notch and the CRPA beamformer.
    run_notch(dev, scenes)
    run_beamform(dev, scenes)

    # The rtk entry point (two receivers through K1 each, the host solve)
    # and the replay's exports and assisted start.
    run_rtk(dev, scenes, k1)

    # Scale-out on torch.distributed: the mesh's ranks on this card.
    run_mesh(scenes, mesh_ref, rx, entries["K1M"])

    # Raw captures through the native reader, the dashboard and the tracker
    # figures, and the CLI's --profile-dir.
    run_host_surfaces(dev, scenes)

    # The receiver paths of six JAX tests and five campaign trials, each held
    # to its test's bars and to the JAX receiver's record (K1 at 200 and
    # 500 ms blocks gets its launches here).
    run_campaign(dev, scenes, {"B200": entries["K1B200"], "B500": entries["K1B500"]})

    # The cold chain: the CLI's first replay from a fresh tree with and
    # without the kernel preload, a cold start split, and a restart.
    run_cold_chain(dev, scenes)
    log("preload against launches (path, preloaded, launched): " + json.dumps(PRELOAD_CHECKS))

    log(f"total: {time.perf_counter() - T_START:.1f} s since the script started")
    log(SMI[0])  # again at the end, where a kept tail of the output still shows it
    log(json.dumps({"kernels": list(entries.values())}))
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

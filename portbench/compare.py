"""How ``correct`` is decided: the kept blocks against the plain reference.

For each block the window kept (a reservoir sample drawn from the seed),
the reference tracks the same int8 words from the carry the program started
the block from, except on the channels whose capture restarted there: those
start from the reference's own hand-off of the capture's truth. Its outputs
are compared with the outputs the program's copy brought to the host, and
its ending carry with the carry the program handed to the next block (the
chain between blocks, which following the program block by block would
otherwise skip).

Two correct computations of the tracker differ in the order of the phase-1
sums; the loop filter carries that on. On a channel the reference holds in
lock through the whole block (its lock flag set every ms: the loops are in
their linear regime) the difference stays at the sums' rounding, but for
two discontinuities of the tracker's design, where the smallest difference
takes the two computations down different branches:

- the prompt is the correlation at the lag of greatest power among the
  2K+1 around the loop's code phase. In a ms where a data-symbol edge
  cancels most of the correlation, the lags come close and the two
  computations can take different ones (prompt and measured code phase
  apart for that ms; GLONASS's meander puts an edge every 10-20 ms);
- the early and late lags are read around floor(code phase): where the
  loop's code phase sits on a whole sample, the two can read different
  lags for a ms and their code phases part by a few hundredths of a sample,
  which the DLL holds there. The 2K+1 lags of the ms are read around the
  same floor, so the two windows then sit one lag apart; where the peak
  lies near a window's end (a GLONASS meander edge inside the ms bends the
  lags: the peak 2.7 samples from the loop's code phase on a held channel),
  one side's triangle reads a neighbour that the other's window cuts off,
  and the measured code phases part by up to a sample.

A discontinuity leaves the loops of the two apart by a few mrad and a
few mHz for some hundred ms, until the loop pulls them together: the
widest gap over a run's held channels then reads up to 0.04 (GLONASS) where
it reads 1e-4 elsewhere, and a block that ends within some hundred ms of one
hands on a carrier phase and Doppler a few mHz and mrad apart (0.0053 on one
GLONASS seed, where the control reads 0.013-0.018). So the prompt, Doppler
and the carry's phase and Doppler are 99th percentiles over the held
channel-blocks, and a single altered prompt among thousands of
channel-blocks shows only in ``departed_share``'s count. Sum-order noise
cannot move a whole ms count or a lock flag, so those carry gaps are held at
the widest: one such fault on one held channel-block fails. The numbers:

- ``held_prompt_gap``: for each held channel-block, the widest gap of a
  prompt (I + jQ) over the ms whose reference prompt is clear (at least
  ``CLEAR`` of the channel's RMS reference prompt), as a share of that
  RMS; the 99th percentile over held channel-blocks;
- ``held_doppler_gap_hz``: for each held channel-block, the widest gap of
  the per-ms Doppler (Hz); the 99th percentile;
- ``held_code_gap_samples``: the widest gap of the measured code phase
  (samples, modulo the period) over the held channels' clear ms at which
  the reference's peak lies near the middle of its lags (``central``);
- ``held_carry_gap``: over the held channel-blocks, the larger of the 99th
  percentile of the ending carry's carrier phase (rad, modulo 2 pi) and
  Doppler (Hz) gaps, each channel-block's the wider of the two, and the
  widest gap of its ms count and lost flag (its code phase is judged in
  ``departed_share``);
- ``departed_share``: over every kept channel and block, the share whose
  outputs or ending carry (the code phase too) depart from the reference
  by more than ``DEPART`` anywhere (every ms: the prompt, the Doppler, the
  measured code phase, a lock flag).

Each has the limit of ``limits/<cell>.json``; a number that is not finite
fails.
"""

from __future__ import annotations

import importlib
import math

import numpy as np
import torch

from portbench import generator

O_PI, O_PQ, O_CP, O_CPM, O_FD, O_LOCKED = 0, 1, 2, 3, 4, 8
NAMES = ("held_prompt_gap", "held_doppler_gap_hz", "held_code_gap_samples", "held_carry_gap",
         "departed_share")
# A channel's block departs when any of its gaps exceeds these: prompt (share
# of its RMS), Doppler (Hz), code phase (samples), carry (each row in its
# unit), or a lock flag differs.
DEPART = {"prompt": 1e-2, "doppler_hz": 1e-2, "code_samples": 1e-2, "carry": 1e-2}
CLEAR = 0.5  # a ms's reference prompt against the channel's RMS
HELD_QUANTILE = 0.99  # of the held channel-blocks' prompt, Doppler and carry phase/Doppler gaps


def _wrapped(d: torch.Tensor, period: float) -> torch.Tensor:
    return torch.remainder(d + period / 2.0, period) - period / 2.0


def central_reach(config: dict) -> float:
    """How far (samples) the reference's measured code phase may lie from
    floor(its loop's code phase), the middle of the ms's 2K+1 lags, for the
    lags that the measurement reads (the peak and 1 lag each side for the
    triangle, 2 for HRC) to lie inside a window one lag to either side as
    well: then both sides read the same lags whichever floor each took. The
    peak is at most K - 1 - reach lags from the middle, and the measurement
    adds at most ``frac`` (0.5 triangle, 1.5 HRC) to it: K - reach - frac."""
    tr = config["tracking"]
    reach, frac = (2, 1.5) if tr["code_phase_measurement"] == "hrc" else (1, 0.5)
    return int(tr["lag_window_half_width"]) - reach - frac


def reference_module(config: dict):
    return importlib.import_module(f"portbench.reference.{config['reference']}")


def reference_blocks(config: dict, traffic: dict, caps, pool: torch.Tensor, kept: list,
                     restart_mask: torch.Tensor, device) -> list[dict]:
    """The reference's inputs for each kept block: the block's words, its
    starting carry, and the reference's own replicas."""
    ref = reference_module(config)
    reps = ref.channel_replicas(config, caps.signals, device)
    restart = generator.handoff(caps, np.zeros(caps.signals.shape[0]), traffic)
    restart = {f: torch.from_numpy(np.asarray(v, dtype=np.float32)).to(device)
               for f, v in restart.items()}
    blocks = []
    for blk in kept:
        mask = restart_mask[blk.ring_pos]
        carry = {f: torch.where(mask, restart[f], getattr(blk.carry_in, f).to(torch.float32))
                 for f in generator.STATE_FIELDS}
        blocks.append({"samples": pool[blk.ring_pos], "carry": carry, "replicas": reps})
    return blocks


def channel_gaps(p: torch.Tensor, r: torch.Tensor, carry_out, fin: dict, length: float,
                 reach: float) -> dict:
    """Per channel [S]: the gaps of one block's outputs ``p`` against the
    reference's ``r`` ([B, N_OUT, S]) and of the ending carries; the
    ``clear_*`` gaps over the ms with a clear reference prompt only, the
    code phase's also only where the reference's measured code phase lies
    within ``reach`` (``central_reach``) of floor(its loop's code phase)."""
    f32 = torch.float32
    pp = torch.complex(p[:, O_PI], p[:, O_PQ])
    pr = torch.complex(r[:, O_PI], r[:, O_PQ])
    rms = torch.sqrt(torch.mean(pr.abs() ** 2, dim=0))
    clear = pr.abs() >= CLEAR * rms
    prompt = (pp - pr).abs() / rms
    code = _wrapped(p[:, O_CPM] - r[:, O_CPM], length).abs()
    central = _wrapped(r[:, O_CPM] - torch.floor(r[:, O_CP]), length).abs() < reach
    zero = torch.zeros((), dtype=f32, device=p.device)
    loop = torch.maximum(
        _wrapped(carry_out.carrier_phase.to(f32) - fin["carrier_phase"], 2.0 * math.pi).abs(),
        (carry_out.doppler.to(f32) - fin["doppler"]).abs())
    count = torch.maximum((carry_out.step_count.to(f32) - fin["step_count"]).abs(),
                          (carry_out.lost.to(f32) - fin["lost"].to(f32)).abs())
    cp = _wrapped(carry_out.code_phase.to(f32) - fin["code_phase"], length).abs()
    return {
        "prompt": prompt.amax(dim=0),
        "clear_prompt": torch.where(clear, prompt, zero).amax(dim=0),
        "doppler_hz": (p[:, O_FD] - r[:, O_FD]).abs().amax(dim=0),
        "code_samples": code.amax(dim=0),
        "clear_code_samples": torch.where(clear & central, code, zero).amax(dim=0),
        "loop_carry": loop,
        "count_carry": count,
        "carry": torch.maximum(torch.maximum(loop, count), cp),
        "lock": ((p[:, O_LOCKED] > 0.5) != (r[:, O_LOCKED] > 0.5)).any(dim=0),
        "held": (r[:, O_LOCKED] > 0.5).all(dim=0),
    }


def widest(v: torch.Tensor, q: float = 1.0) -> float:
    """The largest of ``v``, or its ``q`` quantile; 0 for none, NaN where
    one is not finite."""
    if not v.numel():
        return 0.0
    if not bool(torch.isfinite(v).all()):
        return math.nan
    return float(v.max()) if q == 1.0 else float(torch.quantile(v.double(), q))


def carry_gap(loop: torch.Tensor, count: torch.Tensor) -> float:
    """``held_carry_gap`` from the held channel-blocks' phase/Doppler gaps
    (their 99th percentile) and ms count/lost flag gaps (their widest)."""
    a, b = widest(loop, HELD_QUANTILE), widest(count)
    return math.nan if math.isnan(a) or math.isnan(b) else max(a, b)


def numbers(config: dict, traffic: dict, caps, pool: torch.Tensor, kept: list,
            restart_mask: torch.Tensor, device, raw: dict | None = None) -> dict[str, float]:
    """The compared numbers over the kept blocks; ``raw``, when given, gets
    the held channel-blocks' gaps (for ``calibrate.py``)."""
    if not kept:
        return {name: math.nan for name in NAMES}
    ref = reference_module(config)
    blocks = reference_blocks(config, traffic, caps, pool, kept, restart_mask, device)
    results = ref.track_blocks(config, blocks, "bf16")
    length, reach = float(caps.samples_per_ms), central_reach(config)
    held = {"clear_prompt": [], "doppler_hz": [], "clear_code_samples": [], "loop_carry": [],
            "count_carry": []}
    departed, total, finite = 0, 0, True
    for blk, (fin, r) in zip(kept, results):
        p = blk.outs.to(device=device, dtype=torch.float32)
        finite &= bool(torch.isfinite(p).all())
        g = channel_gaps(p, r, blk.carry_out, fin, length, reach)
        for key in held:
            held[key].append(g[key][g["held"]])
        # A gap that is not finite departs (NaN compares false: negate <=).
        away = g["lock"].clone()
        for key, tol in DEPART.items():
            away |= ~(g[key] <= tol)
        departed += int(away.sum())
        total += away.numel()

    held = {k: torch.cat(v) for k, v in held.items()}
    if raw is not None:
        raw.update({k: v.cpu().numpy() for k, v in held.items()})
    return {
        "held_prompt_gap": widest(held["clear_prompt"], HELD_QUANTILE),
        "held_doppler_gap_hz": widest(held["doppler_hz"], HELD_QUANTILE),
        "held_code_gap_samples": widest(held["clear_code_samples"]),
        "held_carry_gap": carry_gap(held["loop_carry"], held["count_carry"]),
        "departed_share": departed / total if finite else math.nan,
        # Not judged: how much of the sample the held numbers cover.
        "held_share": float(held["doppler_hz"].numel()) / total,
    }


"""The system under test: the port's replay-farm entry, driven block after
block as a farm host drives it.

``Farm`` builds ``make_farm_track_block_fn(...).packed`` for the
configuration's streams and channels, the channels' replica rows as
``TrackerBank`` builds them (``signal/prn.py:replica_table``), and the carry
of every stream at its place in its capture. Block k is the pool's ring
block k mod R; before it, the streams whose capture restarts there get the
restart hand-off on their 12 channels (an edit of the carry on the device,
out of place, so a carry kept for the check is never changed).

``Window`` runs the blocks as ``TrackerBank.dispatch_block`` and
``collect_block`` do: one non-blocking copy of the packed [B, N_OUT, S]
outputs into pinned memory with an event behind it, at depth 1 (dispatch
block k, then collect block k - 1). It keeps a reservoir sample, drawn from
the seed, of the window's blocks (their starting carry, outputs and ending
carry) for the correctness check.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np
import torch

from portbench import codes, generator

N_OUT = 11


@dataclass
class Block:
    k: int
    ring_pos: int
    t_in: float  # host clock when the block was handed to the entry
    issue_s: float  # host time inside the entry's call
    carry_in: tuple  # the carry the block started from (post-restart)
    carry_out: tuple  # the carry the entry returned
    outs: torch.Tensor  # [B, N_OUT, S]: pinned host copy on a card
    ready: object = None  # CUDA event after the copy
    marks: tuple | None = None  # CUDA events around a traced block


class Farm:
    def __init__(self, config: dict, traffic: dict, caps: generator.Captures, pool: torch.Tensor,
                 device, wrap=None) -> None:
        """``wrap(packed) -> packed'`` puts something else in the entry's
        place (the tests' faults, the control)."""
        from gypsum_tpu_torch.core.config import TrackingConfig
        from gypsum_tpu_torch.signal import prn
        from gypsum_tpu_torch.track.loop import TrackState, make_farm_track_block_fn

        self.device = torch.device(device)
        self.caps, self.pool, self.ring = caps, pool, caps.ring
        n_streams, per = caps.signals.shape
        self.n_channels = n_streams * per
        self.block_ms = caps.block_ms
        cfg = TrackingConfig(**config["tracking"])
        soc = np.repeat(np.arange(n_streams), per).astype(np.int32)
        fn = make_farm_track_block_fn(cfg, config["samples_per_ms"], config["sample_rate_hz"],
                                      self.n_channels, soc, device=self.device)
        self.packed = wrap(fn.packed) if wrap else fn.packed
        self.TrackState = TrackState
        band = codes.band(caps.band)
        family = band.port_ids
        ids = [int(p) for p in band.port_id(caps.signals.reshape(-1))]
        reps = prn.replica_table(caps.samples_per_ms, family)
        k = cfg.lag_window_half_width
        wide = np.concatenate([reps, reps, reps[:, : 2 * k]], axis=1).astype(np.float32)
        row = {p: i for i, p in enumerate(family)}
        self.replicas = torch.from_numpy(wide[[row[p] for p in ids]]).to(self.device)
        # Every stream starts where its ring offset puts it in its capture.
        self.state = self.device_state(generator.handoff(caps, caps.stagger * caps.block_ms, traffic))
        self.restart_state = self.device_state(generator.handoff(caps, np.zeros(n_streams), traffic))
        restarts = np.zeros((self.ring, self.n_channels), dtype=bool)
        for n in range(n_streams):
            restarts[(-int(caps.stagger[n])) % self.ring, n * per:(n + 1) * per] = True
        self.restart_any = restarts.any(axis=1)
        self.restart_mask = torch.from_numpy(restarts).to(self.device)

    def device_state(self, rows: dict) -> tuple:
        """A TrackState of [S] tensors on the device from hand-off rows."""
        dtypes = {"step_count": torch.int32, "lost": torch.bool}
        return self.TrackState(*(
            torch.from_numpy(np.asarray(rows[f])).to(dtypes.get(f, torch.float32)).to(self.device)
            for f in generator.STATE_FIELDS
        ))

    def dispatch(self, k: int) -> Block:
        """Hand block k to the entry (after its restarts)."""
        j = k % self.ring
        state = self.state
        if self.restart_any[j]:
            mask = self.restart_mask[j]
            state = self.TrackState(*(torch.where(mask, r, s)
                                      for r, s in zip(self.restart_state, state)))
        t_in = time.perf_counter()
        new_state, outs = self.packed(state, self.pool[j], self.replicas)
        issue = time.perf_counter() - t_in
        self.state = new_state
        return Block(k, j, t_in, issue, state, new_state, outs)

    def release(self) -> None:
        """Drop the entry and its carry: the program's state after a run."""
        self.packed = None
        self.state = None


@contextmanager
def pinned_thread():
    """Hold the calling thread on the core it runs on. The farm's host loop
    is one thread issuing every launch; moved between cores it ran 8-15 %
    slower and less evenly (NVIDIA H100 host, 8 cores). Affects this thread
    only (threads started earlier keep theirs)."""
    try:
        with open("/proc/thread-self/stat") as f:
            cpu = int(f.read().rsplit(")", 1)[1].split()[36])
        old = os.sched_getaffinity(0)
        os.sched_setaffinity(0, {cpu})
    except (OSError, ValueError, IndexError, AttributeError):
        yield
        return
    try:
        yield
    finally:
        os.sched_setaffinity(0, old)


class Window:
    """Blocks at depth 1 with their outputs copied to the host, timed by the
    host clock, and a reservoir of ``n_keep`` blocks for the check."""

    def __init__(self, farm: Farm, n_keep: int, seed: int) -> None:
        self.farm = farm
        self.cuda = farm.device.type == "cuda"
        self.n_keep = n_keep
        shape = (farm.block_ms, N_OUT, farm.n_channels)
        self.free = ([torch.empty(shape, dtype=torch.float32, pin_memory=True)
                      for _ in range(n_keep + 2)] if self.cuda else [])
        self.rng = np.random.default_rng([seed, 0x5EED])
        self.kept: list[Block] = []
        self.next_k = 0

    def _launch(self, session=None) -> Block:
        marks = None
        if session is not None and session.active:
            marks = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            marks[0].record()
        blk = self.farm.dispatch(self.next_k)
        self.next_k += 1
        if self.cuda:
            host = self.free.pop()
            host.copy_(blk.outs, non_blocking=True)
            blk.ready = torch.cuda.Event()
            blk.ready.record()
            blk.outs = host
            if marks is not None:
                marks[1].record()
                session.block_spans.append(marks)
        blk.marks = marks
        return blk

    def _finish(self, blk: Block) -> float:
        if blk.ready is not None:
            blk.ready.synchronize()
        return time.perf_counter()

    def _drop(self, blk: Block) -> None:
        if self.cuda:
            self.free.append(blk.outs)

    def _sample(self, blk: Block, i: int) -> None:
        """Reservoir sampling over the window's blocks (i: the block's place
        in the window)."""
        if len(self.kept) < self.n_keep:
            self.kept.append(blk)
            return
        r = int(self.rng.integers(0, i + 1))
        if r < self.n_keep:
            self._drop(self.kept[r])
            self.kept[r] = blk
        else:
            self._drop(blk)

    def warm(self, n_blocks: int) -> None:
        """The first blocks of the run, each collected before the next: the
        entry's first calls (its kernel build, cuBLAS's set-up) and the
        restart edit run here."""
        for _ in range(n_blocks):
            blk = self._launch()
            self._finish(blk)
            self._drop(blk)

    def run(self, seconds: float, session=None, traced: tuple[int, int] = (0, 0)) -> dict:
        """Blocks for ``seconds`` of host time, then the last one drained.
        ``session``: a trace.Session over the window's blocks
        ``traced[0] .. traced[1] - 1`` (counted from the window's first)."""
        with pinned_thread():
            return self._run(seconds, session, traced)

    def _run(self, seconds: float, session, traced: tuple[int, int]) -> dict:
        first = self.next_k
        latency, issue, pending, i = [], [], None, 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            place = self.next_k - first
            if session is not None and place == traced[0]:
                torch.cuda.synchronize()
                session.start()
            if session is not None and session.active and place == traced[1]:
                session.stop()
            blk = self._launch(session)
            if blk.marks is None:
                issue.append(blk.issue_s)
            if pending is not None:
                latency.append(self._finish(pending) - pending.t_in)
                self._sample(pending, i)
                i += 1
            pending = blk
        if pending is not None:
            latency.append(self._finish(pending) - pending.t_in)
            self._sample(pending, i)
            i += 1
        wall = time.perf_counter() - t0
        if session is not None and session.active:
            session.stop()
        return {"blocks": i, "wall_s": wall, "latency_s": latency, "issue_s": issue,
                "traced_blocks": len(session.block_spans) if session is not None else 0}

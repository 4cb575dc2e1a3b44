"""Pseudosymbol -> navigation-bit integration (host side).

Behavioral mirror of the reference's NavigationBitIntegrator
(gypsum/navigation_bit_intergrator.py), re-implemented array-oriented: the
tracker delivers whole blocks of pseudosymbols at once (one device dispatch =
hundreds of ms), so the integrator consumes numpy arrays and only walks
per-symbol state where the control flow genuinely depends on it.

Key behaviors preserved:
- bit phase chosen by maximizing mean |sum of 20 pseudosymbols| / 20 over the
  last <=16 bits of history, over all 20 phases (reference :113-145);
- resync triggers: 1 s periodic timer, first-ever selection, or >=50% UNKNOWN
  bits among the last 10 (reference :210-239), all gated to the first 40 s of
  receiver time (reference :281-282);
- a bit integrates 20 symbols; |sum|/20 <= 50% -> UNKNOWN (reference :147-159);
- 30 sequential UNKNOWN bits reset the bit phase (reference :164-171);
- phase changes slide the queue cursor (reference :241-270).
"""

from __future__ import annotations

import numpy as np

from gypsum_tpu_torch.core.config import NavConfig
from gypsum_tpu_torch.core.constants import (
    PSEUDOSYMBOLS_PER_NAVIGATION_BIT as SPB,
    PSEUDOSYMBOLS_PER_SECOND,
)
from gypsum_tpu_torch.core.events import BitValue, EmitNavigationBitEvent, Event


class BitIntegrator:
    def __init__(self, config: NavConfig | None = None) -> None:
        self.config = config or NavConfig()
        cfg = self.config
        self._history_len = SPB * cfg.bit_phase_history_bits
        self._min_history = SPB * cfg.bit_phase_min_history_bits
        self._resync_period = int(PSEUDOSYMBOLS_PER_SECOND * cfg.resync_bit_phase_period_s)

        # Rolling sign history for phase scoring.
        self._history: list[int] = []
        # Working queue of (sign, start_time, end_time) awaiting bit emission.
        self._queue_signs: list[int] = []
        self._queue_starts: list[float] = []
        self._queue_ends: list[float] = []
        self._cursor = 0

        self.bit_phase: int | None = None
        self._previous_phase_decision: int | None = None
        self.processed_count = 0
        self.emitted_bit_count = 0
        self.failed_bit_count = 0
        self._sequential_unknown = 0
        self._last_bits: list[BitValue] = []  # bounded to 50

    @property
    def recent_bits(self) -> list[int]:
        """Last <=50 emitted bit values for observability (1/0; UNKNOWN=-1).
        Analogue of the reference's bit history deque consumed by the
        visualizer (gypsum/navigation_bit_intergrator.py:85-97)."""
        out = []
        for b in self._last_bits:
            out.append(b.value if b.value in (0, 1) else -1)
        return out

    # ------------------------------------------------------------- scoring

    def _score_phases(self) -> np.ndarray:
        """Mean |sum of SPB symbols| / SPB at every candidate phase.

        One cumulative sum gives every SPB-symbol window sum at once; phase
        p's bit sums are the windows starting at p, p+SPB, ... — identical
        values to the per-phase roll/reshape loop (including its wraparound
        of the final bit) at ~1/60th the cost, which matters because the
        periodic re-score is the integrator's safety net against a
        confidently-wrong early phase pick and must stay cheap enough to
        run every second forever."""
        sym = np.asarray(self._history[-self._history_len :], dtype=np.int64)
        n_bits = len(sym) // SPB
        # np.roll wraps: phase p's last bit reads up to p + n_bits*SPB - 1
        # >= len(sym), folding onto the window's first SPB-1 symbols.
        ext = np.concatenate([sym, sym[: SPB - 1]])
        c = np.concatenate([[0], np.cumsum(ext)])
        window_sums = c[SPB:] - c[:-SPB]  # [len(ext)-SPB+1] = [len(sym)]
        idx = np.arange(SPB)[:, None] + SPB * np.arange(n_bits)[None, :]
        return np.abs(window_sums[idx]).mean(axis=1) / SPB

    def _redetermine_bit_phase(self) -> int | None:
        if len(self._history) < self._min_history:
            return None
        scores = self._score_phases()
        # Convert window-relative phases to stream-relative ones. The scoring
        # window is the *last* N symbols, whose start is generally not a
        # multiple of 20 symbols into the stream; without this correction a
        # periodic resync can return a phase shifted by the window offset and
        # slide the cursor off the true bit boundary. (The reference has this
        # latent misalignment — its 40 s resync cutoff band-aid,
        # gypsum/navigation_bit_intergrator.py:278-282, hides it.)
        window_start = self.processed_count + 1 - min(len(self._history), self._history_len)
        stream_scores = np.roll(scores, window_start % SPB)
        best = int(np.argmax(stream_scores))
        # Sticky tie-breaking: a window spanning a constant bit run scores
        # (near-)1.0 at *every* phase — argmax alone would then slide the
        # cursor arbitrarily. Keep the current phase unless the best phase is
        # strictly better. (A second latent reference bug: its periodic resync
        # over low-transition nav data corrupts a healthy alignment,
        # gypsum/navigation_bit_intergrator.py:272-282 "bandaid" comment.)
        current = self._previous_phase_decision
        if current is not None and stream_scores[current] >= stream_scores[best] - 1e-9:
            return current
        return best

    def _should_resync(self) -> bool:
        # NOTE: do NOT gate the periodic trigger on recent-bit health — a
        # WRONG phase over a low-transition bit stretch decodes "clean"
        # bits with offset edges (ms-level tick-anchor slips downstream),
        # and the periodic re-score with a longer history is exactly what
        # corrects it. The re-score is cheap now (_score_phases cumsum).
        cfg = self.config
        if self.processed_count % self._resync_period == 0:
            return True
        if self.processed_count == 0:
            return False
        if self.processed_count % SPB != 0:
            return False
        if self._previous_phase_decision is None:
            return True
        mem = cfg.resync_bit_health_memory_bits
        recent = self._last_bits[-mem:]
        if len(recent) == mem:
            pct_failed = 100.0 * sum(b == BitValue.UNKNOWN for b in recent) / mem
            if pct_failed >= cfg.resync_bit_health_threshold_pct:
                return True
        return False

    def _resync_if_necessary(self) -> None:
        if not self._should_resync():
            return
        previous = self._previous_phase_decision
        new_phase = self._redetermine_bit_phase()
        self._previous_phase_decision = new_phase
        self.bit_phase = new_phase
        if previous is None and new_phase is not None:
            self._cursor = new_phase
        elif previous is not None and new_phase is not None and new_phase != previous:
            self._cursor += new_phase - previous

    # ------------------------------------------------------------ emission

    def _emit_bit(self, lo: int) -> EmitNavigationBitEvent:
        signs = self._queue_signs[lo : lo + SPB]
        total = sum(signs)
        bit = BitValue.ONE if total > 0 else BitValue.ZERO
        confidence = abs(int(total / SPB * 100))
        if confidence <= self.config.unknown_bit_confidence_pct:
            bit = BitValue.UNKNOWN
            self._sequential_unknown += 1
            self.failed_bit_count += 1
            if self._sequential_unknown >= self.config.max_sequential_unknown_bits:
                self.bit_phase = None
        else:
            self._sequential_unknown = 0
        self._last_bits.append(bit)
        del self._last_bits[:-50]
        self.emitted_bit_count += 1
        return EmitNavigationBitEvent(
            receiver_timestamp=self._queue_starts[lo],
            trailing_edge_receiver_timestamp=self._queue_ends[lo + SPB - 1],
            bit_value=bit,
        )

    def _drain_queue(self) -> list[Event]:
        if self.bit_phase is None:
            return []
        events: list[Event] = []
        while self._cursor + SPB <= len(self._queue_signs) and self.bit_phase is not None:
            events.append(self._emit_bit(self._cursor))
            self._cursor += SPB
        # Trim consumed symbols, keeping one bit of history for backward phase
        # slides (reference :201-206).
        if self._cursor > SPB:
            drop = self._cursor - SPB
            del self._queue_signs[:drop]
            del self._queue_starts[:drop]
            del self._queue_ends[:drop]
            self._cursor = SPB
        return events

    # ------------------------------------------------------------- ingest

    def process_block(
        self,
        signs: np.ndarray,
        start_times: np.ndarray,
        end_times: np.ndarray,
    ) -> list[Event]:
        """Consume a block of +/-1 pseudosymbols with their timestamps.

        Fast path: resync checks can only FIRE at symbol indices that are
        multiples of SPB (the periodic trigger's 1 s cadence is a multiple of
        SPB symbols, and the first-selection / bit-health triggers gate on
        ``processed_count % SPB == 0``), so symbols between those checkpoints
        reduce to batched appends + queue drains — identical state and event
        sequence to the per-symbol walk at ~SPB times fewer Python steps.
        A non-SPB-aligned resync period falls back to the per-symbol loop.
        """
        if self._resync_period % SPB != 0:
            return self._process_block_per_symbol(signs, start_times, end_times)
        events: list[Event] = []
        cutoff = self.config.bit_phase_resync_cutoff_s
        s_list = signs.tolist()
        t0_list = start_times.tolist()
        t1_list = end_times.tolist()
        n = len(s_list)
        k = 0
        while k < n:
            # Segment end: just before the NEXT index where a check can fire
            # (index i fires when (processed_count + offset) % SPB == 0).
            fire_now = self.processed_count % SPB == 0
            next_fire = k + (-self.processed_count) % SPB
            if fire_now:
                # Checkpoint semantics: append exactly one symbol, then the
                # resync check, then drain — byte-for-byte the per-symbol
                # order.
                self._queue_signs.append(s_list[k])
                self._queue_starts.append(t0_list[k])
                self._queue_ends.append(t1_list[k])
                self._history.append(s_list[k])
                del self._history[: -self._history_len]
                if t0_list[k] < cutoff:
                    self._resync_if_necessary()
                events.extend(self._drain_queue())
                self.processed_count += 1
                k += 1
                continue
            end = min(n, next_fire if next_fire > k else k + SPB)
            self._queue_signs.extend(s_list[k:end])
            self._queue_starts.extend(t0_list[k:end])
            self._queue_ends.extend(t1_list[k:end])
            self._history.extend(s_list[k:end])
            del self._history[: -self._history_len]
            events.extend(self._drain_queue())
            self.processed_count += end - k
            k = end
        return events

    def _process_block_per_symbol(
        self,
        signs: np.ndarray,
        start_times: np.ndarray,
        end_times: np.ndarray,
    ) -> list[Event]:
        """Reference implementation: one Python step per pseudosymbol (kept
        as the oracle for the fast path's parity test and the fallback for
        non-SPB-aligned resync periods)."""
        events: list[Event] = []
        cutoff = self.config.bit_phase_resync_cutoff_s
        for sign, t0, t1 in zip(signs.tolist(), start_times.tolist(), end_times.tolist()):
            self._queue_signs.append(sign)
            self._queue_starts.append(t0)
            self._queue_ends.append(t1)
            self._history.append(sign)
            del self._history[: -self._history_len]
            if t0 < cutoff:
                self._resync_if_necessary()
            events.extend(self._drain_queue())
            self.processed_count += 1
        return events

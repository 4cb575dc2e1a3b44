"""Navigation bits -> subframes: preamble search, polarity, framing.

Behavioral mirror of the reference's NavigationMessageDecoder
(gypsum/navigation_message_decoder.py):

- the 8-bit TLM preamble is searched in both polarities; a phase is accepted
  only when two occurrences sit exactly 300 bits apart (reference :88-114);
- after 12 subframes' worth of bits with no phase, gives up with
  CannotDetermineSubframePhaseEvent (reference :155-170) — the pipeline
  translates that to lost lock;
- once phased, the bit queue drains 300 bits at a time; any subframe
  containing an UNKNOWN bit is discarded and the phase reset (reference
  :210-224);
- preamble/subframe-ID parse errors reset the phase (reference :232-244).

The preamble scan is vectorized with a correlation over the +/-1 bit values
instead of the reference's per-index sublist comparison
(gypsum/utils.py:45-48).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from gypsum_tpu_torch.core.config import NavConfig
from gypsum_tpu_torch.core.constants import BITS_PER_SUBFRAME, TELEMETRY_PREAMBLE_BITS
from gypsum_tpu_torch.core.events import (
    BitValue,
    CannotDetermineSubframePhaseEvent,
    DeterminedSubframePhaseEvent,
    EmitNavigationBitEvent,
    Event,
)
from gypsum_tpu_torch.nav.subframes import (
    DecodedSubframe,
    IncorrectPreambleError,
    InvalidSubframeIdError,
    decode_subframe,
)

_PREAMBLE_PM1 = np.array([1 if b else -1 for b in TELEMETRY_PREAMBLE_BITS], dtype=np.int32)


@dataclass(frozen=True)
class EmitSubframeEvent(Event):
    receiver_timestamp: float
    trailing_edge_receiver_timestamp: float
    decoded: DecodedSubframe


class SubframeDecoder:
    def __init__(self, config: NavConfig | None = None) -> None:
        self.config = config or NavConfig()
        self._queue: list[EmitNavigationBitEvent] = []
        self.subframe_phase: int | None = None
        self.polarity: int | None = None  # +1 upright, -1 inverted
        self.emitted_subframe_count = 0

    # ----------------------------------------------------------- phase scan

    def _bit_values_pm1(self) -> np.ndarray:
        """Queued bits as +1/-1 with 0 for UNKNOWN (never matches preamble)."""
        return np.array(
            [
                1 if e.bit_value == BitValue.ONE else (-1 if e.bit_value == BitValue.ZERO else 0)
                for e in self._queue
            ],
            dtype=np.int32,
        )

    @staticmethod
    def _preamble_indexes(vals: np.ndarray, polarity: int) -> np.ndarray:
        """All start indexes where the (possibly inverted) preamble matches."""
        if len(vals) < len(_PREAMBLE_PM1):
            return np.empty(0, dtype=np.int64)
        pattern = polarity * _PREAMBLE_PM1
        windows = np.lib.stride_tricks.sliding_window_view(vals, len(pattern))
        return np.nonzero((windows == pattern).all(axis=1))[0]

    def _determine_phase(self) -> list[Event]:
        events: list[Event] = []
        if len(self._queue) < BITS_PER_SUBFRAME * 2:
            return events
        vals = self._bit_values_pm1()
        for polarity in (1, -1):
            candidates = self._preamble_indexes(vals, polarity)
            candidate_set = set(candidates.tolist())
            for c in candidates[:-1].tolist():
                if c + BITS_PER_SUBFRAME in candidate_set:
                    self.subframe_phase = c
                    self.polarity = polarity
                    events.append(DeterminedSubframePhaseEvent(subframe_phase=c, polarity=polarity))
                    # Discard the partial subframe before the first preamble.
                    del self._queue[: c % BITS_PER_SUBFRAME]
                    return events
        if len(self._queue) >= BITS_PER_SUBFRAME * self.config.max_subframes_of_bits_without_phase:
            events.append(CannotDetermineSubframePhaseEvent())
        return events

    def _reset_phase(self) -> None:
        self.subframe_phase = None
        self.polarity = None

    # ------------------------------------------------------------- framing

    def _parse_next_subframe(self) -> EmitSubframeEvent | None:
        sf_bits = self._queue[:BITS_PER_SUBFRAME]
        del self._queue[:BITS_PER_SUBFRAME]
        receiver_timestamp = sf_bits[0].receiver_timestamp
        trailing_edge = sf_bits[-1].trailing_edge_receiver_timestamp

        if any(e.bit_value == BitValue.UNKNOWN for e in sf_bits):
            # An unknown bit is a slip: polarity may have flipped, so both the
            # phase and polarity are re-determined (reference :210-224).
            self._reset_phase()
            return None

        bits = np.array(
            [e.bit_value.value if self.polarity == 1 else e.bit_value.inverted().value for e in sf_bits],
            dtype=np.int8,
        )
        try:
            decoded = decode_subframe(bits, strict_parity=self.config.strict_parity)
        except (IncorrectPreambleError, InvalidSubframeIdError):
            self._reset_phase()
            return None
        self.emitted_subframe_count += 1
        return EmitSubframeEvent(
            receiver_timestamp=receiver_timestamp,
            trailing_edge_receiver_timestamp=trailing_edge,
            decoded=decoded,
        )

    # -------------------------------------------------------------- ingest

    def process_bit(self, bit_event: EmitNavigationBitEvent) -> list[Event]:
        events: list[Event] = []
        self._queue.append(bit_event)
        if self.subframe_phase is None:
            events.extend(self._determine_phase())
        if self.subframe_phase is not None:
            while len(self._queue) >= BITS_PER_SUBFRAME and self.subframe_phase is not None:
                maybe = self._parse_next_subframe()
                if maybe is not None:
                    events.append(maybe)
        return events

"""Typed events flowing between pipeline stages, and framework errors.

The reference signals between stages with Event subclasses dispatched through
handler tables and raises LostSatelliteLockError for unrecoverable degradation
(reference: gypsum/events.py, gypsum/tracker.py:33,
gypsum/satellite_signal_processing_pipeline.py:81-136). This module keeps the
same vocabulary but as frozen dataclasses with explicit payloads.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum


class GypsumTpuError(Exception):
    """Base class for framework errors."""


class NoMoreSamplesError(GypsumTpuError):
    """The sample source is exhausted (reference: antenna_sample_provider.py:20)."""


class LostSatelliteLockError(GypsumTpuError):
    """Raised by any pipeline stage when tracking degrades beyond recovery;
    the receiver drops the satellite and returns it to the acquisition pool
    (reference: gypsum/tracker.py:33, gypsum/receiver.py:248-256)."""


class UnknownEventError(GypsumTpuError):
    pass


class BitValue(IntEnum):
    """A decoded navigation bit. UNKNOWN = low-confidence integration
    (reference: gypsum/tracker.py:48-84)."""

    ZERO = 0
    ONE = 1
    UNKNOWN = 2

    def inverted(self) -> "BitValue":
        if self == BitValue.UNKNOWN:
            raise ValueError("Cannot invert an unknown bit value")
        return BitValue.ONE if self == BitValue.ZERO else BitValue.ZERO


@dataclass(frozen=True)
class Event:
    pass


@dataclass(frozen=True)
class EmittedPseudosymbol(Event):
    """One 1 ms prompt-correlation observation from the tracker.

    Timestamps are code-phase corrected: they include the sub-millisecond PRN
    arrival delay (reference: gypsum/tracker.py:319-328)."""

    start_time: float
    end_time: float
    sign: int  # +1 / -1 = sign of Re(prompt peak)
    prompt: complex


@dataclass(frozen=True)
class EmitNavigationBitEvent(Event):
    receiver_timestamp: float
    trailing_edge_receiver_timestamp: float
    bit_value: BitValue


@dataclass(frozen=True)
class CannotDetermineBitPhaseEvent(Event):
    confidence: float


@dataclass(frozen=True)
class LostBitCoherenceEvent(Event):
    confidence: float


@dataclass(frozen=True)
class DeterminedBitPhaseEvent(Event):
    bit_phase: int


@dataclass(frozen=True)
class CannotDetermineSubframePhaseEvent(Event):
    pass


@dataclass(frozen=True)
class DeterminedSubframePhaseEvent(Event):
    subframe_phase: int
    polarity: int  # +1 upright, -1 inverted

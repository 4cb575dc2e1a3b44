"""Ranging codes and tracking replicas, written from the signal documents.

The benchmark's own generators, independent of the program under test:

- GPS L1 C/A (IS-GPS-200, section 3.3.2.3): G1 = 1 + x^3 + x^10 and
  G2 = 1 + x^2 + x^3 + x^6 + x^8 + x^9 + x^10, both 10-stage registers
  started all ones with the output at stage 10; the code of PRN i is G1 XOR
  G2 delayed by the PRN's chip delay of Table 3-Ia. Every code is checked
  against the table's "first 10 chips" octal column.
- GLONASS L1OF (ICD edition 5.1, section 3.3.2.2): one 511-chip m-sequence,
  9 stages, polynomial 1 + x^5 + x^9, output at stage 7, started all ones;
  checked by its period, its chip balance and its two-level
  autocorrelation.

A replica is one code period at ``samples_per_ms`` samples: sample l holds
chip floor(l * chips / samples_per_ms), as +1 for a one chip and -1 for a
zero chip.

``BANDS`` is the one table of the bands a configuration may name: the
generator, the farm and the reference all read it, and any other band
raises (``band``).
"""

from __future__ import annotations

import functools
from collections.abc import Callable
from dataclasses import dataclass

import numpy as np

GPS_CHIPS = 1023
GLONASS_CHIPS = 511

# IS-GPS-200 Table 3-Ia: the G2 delay (chips) and the first 10 chips (octal)
# of PRNs 1-32.
G2_DELAY = (5, 6, 7, 8, 17, 18, 139, 140, 141, 251, 252, 254, 255, 256, 257, 258,
            469, 470, 471, 472, 473, 474, 509, 512, 513, 514, 515, 516, 859, 860, 861, 862)
FIRST_TEN_OCTAL = (0o1440, 0o1620, 0o1710, 0o1744, 0o1133, 0o1455, 0o1131, 0o1454,
                   0o1626, 0o1504, 0o1642, 0o1750, 0o1764, 0o1772, 0o1775, 0o1776,
                   0o1156, 0o1467, 0o1633, 0o1715, 0o1746, 0o1763, 0o1063, 0o1706,
                   0o1743, 0o1761, 0o1770, 0o1774, 0o1127, 0o1453, 0o1625, 0o1712)


def _lfsr(stages: int, taps: tuple[int, ...], out_stage: int, length: int) -> np.ndarray:
    """``length`` output bits of a Fibonacci register started all ones:
    the feedback is the XOR of the 1-indexed ``taps``, shifted in at stage
    1; the output is read at ``out_stage`` before each shift."""
    reg = [1] * stages
    out = np.empty(length, dtype=np.int8)
    for i in range(length):
        out[i] = reg[out_stage - 1]
        fb = 0
        for t in taps:
            fb ^= reg[t - 1]
        reg = [fb] + reg[:-1]
    return out


@functools.lru_cache(maxsize=1)
def gps_codes() -> np.ndarray:
    """The C/A codes of PRNs 1-32 as [32, 1023] int8 of {0, 1}; row i is
    PRN i + 1."""
    g1 = _lfsr(10, (3, 10), 10, GPS_CHIPS)
    g2 = _lfsr(10, (2, 3, 6, 8, 9, 10), 10, GPS_CHIPS)
    idx = (np.arange(GPS_CHIPS)[None, :] - np.asarray(G2_DELAY)[:, None]) % GPS_CHIPS
    codes = (g1[None, :] ^ g2[idx]).astype(np.int8)
    first_ten = codes[:, :10].astype(np.int64) @ (1 << np.arange(9, -1, -1))
    if tuple(int(v) for v in first_ten) != FIRST_TEN_OCTAL:
        raise ValueError("C/A code generator disagrees with IS-GPS-200 Table 3-Ia")
    codes.setflags(write=False)
    return codes


@functools.lru_cache(maxsize=1)
def glonass_code() -> np.ndarray:
    """The L1OF ranging code as [511] int8 of {0, 1}."""
    code = _lfsr(9, (5, 9), 7, GLONASS_CHIPS)
    pm = code.astype(np.int64) * 2 - 1
    acf = np.array([int(pm @ np.roll(pm, k)) for k in range(GLONASS_CHIPS)])
    if int(pm.sum()) != 1 or acf[0] != GLONASS_CHIPS or not np.all(acf[1:] == -1):
        raise ValueError("GLONASS code generator fails the m-sequence checks")
    code.setflags(write=False)
    return code


@dataclass(frozen=True)
class Band:
    """A band's signals (GPS PRNs, GLONASS frequency numbers), the row of
    ``table()`` that holds each one's code, and the channel id the port gives
    each one (``gypsum_tpu_torch/signal/prn.py``: PRN n is id n, GLONASS
    frequency number k is id 208 + k)."""

    signals: tuple[int, ...]
    table: Callable[[], np.ndarray]  # [rows, chips] int8 {0, 1}
    rows: tuple[int, ...]
    port_ids: tuple[int, ...]

    def _index(self, signals) -> np.ndarray:
        place = {s: i for i, s in enumerate(self.signals)}
        arr = np.asarray(signals)
        try:
            return np.array([place[int(s)] for s in arr.reshape(-1)], dtype=np.int64).reshape(arr.shape)
        except KeyError as e:
            raise ValueError(f"signal {e.args[0]} is not one of the band's {self.signals}") from None

    def code_rows(self, signals) -> np.ndarray:
        """The row of ``table()`` of each signal, in the signals' shape."""
        return np.asarray(self.rows, dtype=np.int64)[self._index(signals)]

    def port_id(self, signals) -> np.ndarray:
        """The port's channel id of each signal, in the signals' shape."""
        return np.asarray(self.port_ids, dtype=np.int64)[self._index(signals)]


BANDS = {
    "gps_l1ca": Band(signals=tuple(range(1, 33)), table=gps_codes, rows=tuple(range(32)),
                     port_ids=tuple(range(1, 33))),
    # Every GLONASS L1OF satellite sends the same code.
    "glonass_l1of": Band(signals=tuple(range(-7, 7)), table=lambda: glonass_code()[None, :],
                         rows=(0,) * 14, port_ids=tuple(range(201, 215))),
}


def band(name: str) -> Band:
    """The entry of ``BANDS``; an unknown band raises, naming the known ones."""
    if name not in BANDS:
        raise ValueError(f"unknown band {name!r} (known: {', '.join(sorted(BANDS))})")
    return BANDS[name]


def signal_codes(band_name: str, signals: list[int]) -> np.ndarray:
    """[len(signals), chips] int8 {0, 1}: each signal's code."""
    b = band(band_name)
    return b.table()[b.code_rows(signals)]


def replicas(codes: np.ndarray, samples_per_ms: int) -> np.ndarray:
    """[n, samples_per_ms] float32 of +/-1: each code resampled to one code
    period at the stream's rate."""
    chips = codes.shape[1]
    idx = (np.arange(samples_per_ms, dtype=np.int64) * chips) // samples_per_ms
    return codes[:, idx].astype(np.float32) * 2.0 - 1.0

"""L1 C/A-family Gold-code generation (GPS + SBAS).

Design (TPU-first, not a port): a constellation's codes are materialized once
as an [N, 1023] int8 table. The G1/G2 maximal-length sequences are generated by
a single 10-bit LFSR pass each; each signal's code is then G1 XOR a
circularly-delayed G2, using the per-PRN delays of IS-GPS-200 Table 3-Ia
("delay" form — the reference instead uses the equivalent per-SV G2 output-tap
form, reference: gypsum/gps_ca_prn_codes.py:120-178). Device code consumes the
table (or replicas resampled from it) as a constant; nothing here runs in the
hot path.

The same Gold-code family covers more than GPS: SBAS L1 signals (WAAS/EGNOS/
MSAS, PRNs 120-138) are G1 XOR delayed-G2 with delays assigned by RTCA DO-229
Table A-1, so the acquisition/tracking machinery extends to them by simply
widening the table (the reference is hard-wired to 32 GPS SVs).

Every generated code is validated at first use against the ICD's published
"first 10 chips" octal watermark, mirroring the reference's startup self-check
(reference: gypsum/gps_ca_prn_codes.py:190-248).
"""

from __future__ import annotations

import functools

import numpy as np

from gypsum_tpu_torch.core.constants import GLONASS_CHIP_COUNT, PRN_CHIP_COUNT

ALL_PRN_IDS: tuple[int, ...] = tuple(range(1, 33))
# SBAS L1 geostationary signals (DO-229 Table A-1; the classic WAAS/EGNOS/
# MSAS allocation block). Ranging + 250 bps FEC-coded data, see nav/sbas.py.
SBAS_PRN_IDS: tuple[int, ...] = tuple(range(120, 139))
# GLONASS L1OF channels: every satellite transmits the SAME 511-chip
# m-sequence; satellites are separated by FDMA frequency number k = -7..+6
# (f_k = 1602 MHz + k * 562.5 kHz). A tracked GLONASS "PRN id" therefore
# identifies a FREQUENCY CHANNEL, not a code: id = 208 + k (201..214). The
# orbital slot number is learned later from navigation string 4.
GLONASS_PRN_IDS: tuple[int, ...] = tuple(range(201, 215))
_GLONASS_ID_OFFSET = 208  # id 208 <-> frequency number k = 0


def glonass_frequency_number(prn: int) -> int:
    """FDMA frequency number k (-7..+6) of a GLONASS channel id (201..214)."""
    if prn not in GLONASS_PRN_IDS:
        raise ValueError(f"{prn} is not a GLONASS channel id (201..214)")
    return prn - _GLONASS_ID_OFFSET


def glonass_prn_id(frequency_number: int) -> int:
    """Channel id (201..214) for a GLONASS FDMA frequency number k."""
    if not -7 <= frequency_number <= 6:
        raise ValueError(f"GLONASS frequency number {frequency_number} not in -7..+6")
    return _GLONASS_ID_OFFSET + frequency_number

# IS-GPS-200 Table 3-Ia (PRNs 1-32) and DO-229 Table A-1 (PRNs 120-138),
# "Code Delay (chips)" column: the G2 sequence delay assigned to each PRN
# signal number.
_G2_DELAY_CHIPS: dict[int, int] = {
    1: 5, 2: 6, 3: 7, 4: 8, 5: 17, 6: 18, 7: 139, 8: 140,
    9: 141, 10: 251, 11: 252, 12: 254, 13: 255, 14: 256, 15: 257, 16: 258,
    17: 469, 18: 470, 19: 471, 20: 472, 21: 473, 22: 474, 23: 509, 24: 512,
    25: 513, 26: 514, 27: 515, 28: 516, 29: 859, 30: 860, 31: 861, 32: 862,
    # SBAS (DO-229 Table A-1)
    120: 145, 121: 175, 122: 52, 123: 21, 124: 237, 125: 235, 126: 886,
    127: 657, 128: 634, 129: 762, 130: 355, 131: 1012, 132: 176, 133: 603,
    134: 130, 135: 359, 136: 595, 137: 68, 138: 386,
}

# IS-GPS-200 Table 3-Ia (PRNs 1-32) / DO-229 Table A-1 (PRNs 120-138),
# "First 10 Chips Octal" column: the C/A code watermark used for
# self-validation. (The PRN 120 value 0o0671 matches the published DO-229
# table; the rest of the SBAS block is pinned from the same delay-form
# construction.)
_FIRST_TEN_CHIPS_OCTAL: dict[int, int] = {
    1: 0o1440, 2: 0o1620, 3: 0o1710, 4: 0o1744, 5: 0o1133, 6: 0o1455,
    7: 0o1131, 8: 0o1454, 9: 0o1626, 10: 0o1504, 11: 0o1642, 12: 0o1750,
    13: 0o1764, 14: 0o1772, 15: 0o1775, 16: 0o1776, 17: 0o1156, 18: 0o1467,
    19: 0o1633, 20: 0o1715, 21: 0o1746, 22: 0o1763, 23: 0o1063, 24: 0o1706,
    25: 0o1743, 26: 0o1761, 27: 0o1770, 28: 0o1774, 29: 0o1127, 30: 0o1453,
    31: 0o1625, 32: 0o1712,
    120: 0o0671, 121: 0o0536, 122: 0o1510, 123: 0o1545, 124: 0o0160,
    125: 0o0701, 126: 0o0013, 127: 0o1060, 128: 0o0245, 129: 0o0527,
    130: 0o1436, 131: 0o1226, 132: 0o1257, 133: 0o0046, 134: 0o1071,
    135: 0o0561, 136: 0o1037, 137: 0o0770, 138: 0o1327,
}


def _mls(feedback_taps: tuple[int, ...]) -> np.ndarray:
    """One 1023-chip maximal-length sequence from a 10-bit LFSR.

    ``feedback_taps`` are 1-indexed register stages XOR'd into the feedback;
    the register starts all-ones and the output is stage 10 (IS-GPS-200
    §3.3.2.3).
    """
    reg = np.ones(10, dtype=np.int8)
    out = np.empty(PRN_CHIP_COUNT, dtype=np.int8)
    taps = np.array([t - 1 for t in feedback_taps])
    for i in range(PRN_CHIP_COUNT):
        out[i] = reg[9]
        fb = reg[taps].sum() & 1
        reg[1:] = reg[:-1]
        reg[0] = fb
    return out


@functools.lru_cache(maxsize=2)
def _glonass_code() -> np.ndarray:
    """The GLONASS L1OF standard-precision ranging code: one 511-chip
    m-sequence shared by all satellites (GLONASS ICD §3.3.2.2 — a 9-stage
    shift register with feedback polynomial 1 + x^5 + x^9, output from
    stage 7, initialized all-ones), as int8 {0,1}.

    Self-validation (the ICD publishes no octal watermark, so the check is
    the m-sequence's defining properties, which pin the polynomial and the
    implementation): exact period 511, 256/255 chip balance, and a two-level
    circular autocorrelation (+511 at zero lag, exactly -1 everywhere else in
    the +/-1 mapping). Only the output-tap PHASE is unverifiable offline;
    synthesis and receiver share this generator, so it cancels end-to-end.
    """
    reg = np.ones(9, dtype=np.int8)
    out = np.empty(GLONASS_CHIP_COUNT, dtype=np.int8)
    for i in range(GLONASS_CHIP_COUNT):
        out[i] = reg[6]  # stage 7
        fb = (reg[4] ^ reg[8]) & 1  # stages 5 and 9
        reg[1:] = reg[:-1]
        reg[0] = fb
    pm = out.astype(np.int32) * 2 - 1
    if int(pm.sum()) != 1:  # 256 ones - 255 zeros
        raise ValueError("GLONASS code self-check failed: chip balance")
    spectrum = np.abs(np.fft.fft(pm)) ** 2
    acf = np.round(np.fft.ifft(np.fft.fft(pm) * np.conj(np.fft.fft(pm))).real)
    if int(acf[0]) != GLONASS_CHIP_COUNT or not np.all(acf[1:] == -1):
        raise ValueError("GLONASS code self-check failed: autocorrelation")
    del spectrum
    out.setflags(write=False)
    return out


def chip_count_for(prn: int) -> int:
    """Ranging-code length (chips) for a registered signal id."""
    return GLONASS_CHIP_COUNT if prn in GLONASS_PRN_IDS else PRN_CHIP_COUNT


@functools.lru_cache(maxsize=8)
def code_table(prns: tuple[int, ...]) -> np.ndarray:
    """Ranging codes for an arbitrary registered signal set as an
    [len(prns), chip_count] int8 array of {0,1}; row i holds ``prns[i]``.
    All ids must share one family (Gold 1023-chip GPS/SBAS, or the 511-chip
    GLONASS m-sequence — GLONASS rows are the shared code repeated, since
    FDMA channels differ in frequency, not code).

    Gold-family codes are validated against the ICD octal watermark; any
    mismatch raises immediately (mirrors reference:
    gypsum/gps_ca_prn_codes.py:226-248).
    """
    glonass = [p in GLONASS_PRN_IDS for p in prns]
    if any(glonass):
        if not all(glonass):
            raise ValueError(
                "code_table cannot mix GLONASS (511-chip) with Gold-family "
                f"(1023-chip) ids: {prns}"
            )
        table = np.tile(_glonass_code(), (len(prns), 1))
        table.setflags(write=False)
        return table
    unknown = [p for p in prns if p not in _G2_DELAY_CHIPS]
    if unknown:
        raise ValueError(
            f"unregistered PRN(s) {unknown}: known families are GPS "
            f"{ALL_PRN_IDS[0]}..{ALL_PRN_IDS[-1]}, SBAS "
            f"{SBAS_PRN_IDS[0]}..{SBAS_PRN_IDS[-1]} and GLONASS "
            f"{GLONASS_PRN_IDS[0]}..{GLONASS_PRN_IDS[-1]}"
        )
    g1 = _mls((3, 10))  # G1 = 1 + x^3 + x^10
    g2 = _mls((2, 3, 6, 8, 9, 10))  # G2 = 1 + x^2 + x^3 + x^6 + x^8 + x^9 + x^10
    delays = np.array([_G2_DELAY_CHIPS[prn] for prn in prns])
    # G2i(t) = G2(t - delay): a right circular shift by `delay` chips.
    idx = (np.arange(PRN_CHIP_COUNT)[None, :] - delays[:, None]) % PRN_CHIP_COUNT
    table = np.bitwise_xor(g1[None, :], g2[idx]).astype(np.int8)

    # Watermark self-check: the first 10 chips of each code, read as a binary
    # number, must match the ICD's published octal value.
    first_ten = table[:, :10].astype(np.int64) @ (1 << np.arange(9, -1, -1))
    for i, prn in enumerate(prns):
        expected = _FIRST_TEN_CHIPS_OCTAL[prn]
        if int(first_ten[i]) != expected:
            raise ValueError(
                f"C/A code self-check failed for PRN {prn}: first 10 chips "
                f"0o{int(first_ten[i]):o} != expected 0o{expected:o}"
            )
    table.setflags(write=False)
    return table


def ca_code_table() -> np.ndarray:
    """The GPS constellation's C/A codes as a [32, 1023] int8 array of {0,1};
    row i holds PRN i+1."""
    return code_table(ALL_PRN_IDS)


def ca_code(prn: int) -> np.ndarray:
    """The ranging code for one registered signal id as int8 {0,1}
    (1023-chip Gold code for GPS/SBAS, 511-chip m-sequence for GLONASS)."""
    if prn in ALL_PRN_IDS:
        return code_table(ALL_PRN_IDS)[prn - 1]
    if prn in SBAS_PRN_IDS:
        return code_table(SBAS_PRN_IDS)[prn - SBAS_PRN_IDS[0]]
    if prn in GLONASS_PRN_IDS:
        return _glonass_code()
    raise ValueError(
        f"unregistered PRN {prn} (GPS 1..32, SBAS 120..138, GLONASS 201..214)"
    )


def _chip_indices(
    samples_per_prn: int,
    n_samples: int,
    code_phase_chips: float,
    chip_count: int = PRN_CHIP_COUNT,
) -> np.ndarray:
    """Map stream sample indices to chip indices at an arbitrary (possibly
    non-integer) samples-per-chip ratio.

    Generalizes the reference's integer-only np.repeat resampling
    (reference: gypsum/satellite.py:20-31, antenna_sample_provider.py:27).
    """
    chips_per_sample = chip_count / samples_per_prn
    positions = np.arange(n_samples) * chips_per_sample + code_phase_chips
    return np.floor(positions).astype(np.int64) % chip_count


def sampled_replica(
    prn: int,
    samples_per_prn: int,
    n_samples: int | None = None,
    code_phase_chips: float = 0.0,
    dtype=np.complex64,
) -> np.ndarray:
    """One PRN's replica resampled to the stream rate, as +/-1 values.

    Chip value 1 maps to +1 and chip value 0 to -1, matching the antenna-data
    convention (reference: gypsum/satellite.py:26-31). ``samples_per_prn`` is
    always the samples in one CODE PERIOD (1 ms for both GPS C/A and GLONASS
    SP, whose 511 chips span the same millisecond).
    """
    n = samples_per_prn if n_samples is None else n_samples
    cc = chip_count_for(prn)
    chips = ca_code(prn)[_chip_indices(samples_per_prn, n, code_phase_chips, cc)]
    return (chips.astype(np.float32) * 2.0 - 1.0).astype(dtype)


@functools.lru_cache(maxsize=8)
def replica_table(
    samples_per_prn: int, prns: tuple[int, ...] = ALL_PRN_IDS
) -> np.ndarray:
    """A signal set's replicas resampled to the stream rate:
    [len(prns), samples_per_prn] float32 of +/-1; row i holds ``prns[i]``
    (defaults to the 32 GPS SVs). This is the constant consumed by the
    batched acquisition and tracking kernels."""
    cc = chip_count_for(prns[0])
    idx = _chip_indices(samples_per_prn, samples_per_prn, 0.0, cc)
    table = code_table(prns)[:, idx].astype(np.float32) * 2.0 - 1.0
    table.setflags(write=False)
    return table

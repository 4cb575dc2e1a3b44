"""IS-GPS-200 subframe bit-field parsing *and* encoding.

Design: each subframe's layout is a declarative table of ``Field`` specs
(positions within the 240 source data bits, scale factor, signedness). One
generic routine decodes fields and its exact inverse encodes them — unlike the
reference's one-way imperative cursor reads
(gypsum/navigation_message_parser.py:426-673). The encoder exists so the
synthetic-signal generator can emit real navigation messages with correct
parity, giving the framework hermetic end-to-end fixtures (the reference's
only fixture is a vendored SDR recording).

Field positions follow IS-GPS-200 Figure 20-1 (Data Format sheets 1-11);
scale factors follow Tables 20-I..20-IV. Values are returned in ICD units
(semicircles, seconds, meters^0.5 ...) exactly like the reference parser; the
solver converts semicircles to radians.
"""

from __future__ import annotations

from dataclasses import dataclass, fields as dc_fields
from enum import Enum

import numpy as np

from gypsum_tpu_torch.core.constants import (
    BITS_PER_SUBFRAME,
    DATA_BITS_PER_WORD,
    TELEMETRY_PREAMBLE_BITS,
    WORDS_PER_SUBFRAME,
)
from gypsum_tpu_torch.nav.words import decode_words, encode_word, solve_parity_closing_bits


class IncorrectPreambleError(Exception):
    """TLM preamble mismatch
    (reference: gypsum/navigation_message_parser.py:393-409)."""


class InvalidSubframeIdError(Exception):
    """HOW subframe-ID field not in 1..5
    (reference: gypsum/navigation_message_parser.py:52-65)."""


class GpsSubframeId(Enum):
    ONE = 1
    TWO = 2
    THREE = 3
    FOUR = 4
    FIVE = 5

    @classmethod
    def from_bits(cls, bits: tuple[int, int, int]) -> "GpsSubframeId":
        value = (bits[0] << 2) | (bits[1] << 1) | bits[2]
        try:
            return cls(value)
        except ValueError:
            raise InvalidSubframeIdError(f"subframe id bits {bits}") from None


# ------------------------------------------------------------------ fields


@dataclass(frozen=True)
class Field:
    """One (possibly split) bit field in the 240-bit source-data space."""

    name: str
    parts: tuple[tuple[int, int], ...]  # (start_bit, n_bits), MSB-first concat
    scale_exp2: int = 0
    signed: bool = False
    integer: bool = False  # return int (unscaled counters / indexes)

    @property
    def n_bits(self) -> int:
        return sum(n for _, n in self.parts)


def _bits_to_int(bits: np.ndarray) -> int:
    out = 0
    for b in bits:
        out = (out << 1) | int(b)
    return out


def _int_to_bits(value: int, n_bits: int) -> np.ndarray:
    return np.array([(value >> (n_bits - 1 - i)) & 1 for i in range(n_bits)], dtype=np.int8)


def decode_field(source_bits: np.ndarray, field: Field):
    raw_bits = np.concatenate([source_bits[s : s + n] for s, n in field.parts])
    raw = _bits_to_int(raw_bits)
    if field.signed and raw >= (1 << (field.n_bits - 1)):
        raw -= 1 << field.n_bits
    if field.integer:
        return raw
    return raw * (2.0**field.scale_exp2)


def encode_field(source_bits: np.ndarray, field: Field, value) -> None:
    if field.integer:
        raw = int(value)
    else:
        raw = int(round(value / (2.0**field.scale_exp2)))
    if field.signed:
        lo, hi = -(1 << (field.n_bits - 1)), (1 << (field.n_bits - 1)) - 1
        if not lo <= raw <= hi:
            raise ValueError(f"{field.name}={value} out of range for {field.n_bits} signed bits")
        raw &= (1 << field.n_bits) - 1
    elif not 0 <= raw < (1 << field.n_bits):
        raise ValueError(f"{field.name}={value} out of range for {field.n_bits} unsigned bits")
    bits = _int_to_bits(raw, field.n_bits)
    cursor = 0
    for s, n in field.parts:
        source_bits[s : s + n] = bits[cursor : cursor + n]
        cursor += n


# ------------------------------------------------------- subframe payloads


@dataclass(frozen=True)
class TelemetryWord:
    """reference: gypsum/navigation_message_parser.py:68-73."""

    tlm_message: int
    integrity_status_flag: int
    spare_bit: int


@dataclass(frozen=True)
class HandoverWord:
    """reference: gypsum/navigation_message_parser.py:76-93."""

    tow_count: int  # 17-bit truncated TOW count (units of 6 s)
    alert_flag: int
    anti_spoof_flag: int
    subframe_id: GpsSubframeId

    @property
    def time_of_week_seconds(self) -> float:
        # Each TOW count unit is 6 seconds (1.5 s * 4, IS-GPS-200 §20.3.3.2).
        return float(self.tow_count * 6)


@dataclass(frozen=True)
class Subframe1:
    """Clock/health parameters (IS-GPS-200 §20.3.3.3;
    reference: gypsum/navigation_message_parser.py:426-474)."""

    week_number_mod_1024: int
    ca_or_p_on_l2: int
    ura_index: int
    sv_health: int
    issue_of_data_clock: int
    l2_p_data_flag: int
    t_gd: float  # s
    t_oc: float  # s
    a_f2: float  # s/s^2
    a_f1: float  # s/s
    a_f0: float  # s

    FIELDS = (
        Field("week_number_mod_1024", ((48, 10),), integer=True),
        Field("ca_or_p_on_l2", ((58, 2),), integer=True),
        Field("ura_index", ((60, 4),), integer=True),
        Field("sv_health", ((64, 6),), integer=True),
        Field("issue_of_data_clock", ((70, 2), (168, 8)), integer=True),
        Field("l2_p_data_flag", ((72, 1),), integer=True),
        Field("t_gd", ((160, 8),), scale_exp2=-31, signed=True),
        Field("t_oc", ((176, 16),), scale_exp2=4),
        Field("a_f2", ((192, 8),), scale_exp2=-55, signed=True),
        Field("a_f1", ((200, 16),), scale_exp2=-43, signed=True),
        Field("a_f0", ((216, 22),), scale_exp2=-31, signed=True),
    )

    @property
    def subframe_id(self) -> GpsSubframeId:
        return GpsSubframeId.ONE


@dataclass(frozen=True)
class Subframe2:
    """Ephemeris part 1 (IS-GPS-200 §20.3.3.4;
    reference: gypsum/navigation_message_parser.py:476-537)."""

    issue_of_data_ephemeris: int
    crs: float  # m
    delta_n: float  # semicircles/s
    m0: float  # semicircles
    cuc: float  # rad
    eccentricity: float
    cus: float  # rad
    sqrt_a: float  # m^0.5
    t_oe: float  # s
    fit_interval_flag: int
    age_of_data_offset: int

    FIELDS = (
        Field("issue_of_data_ephemeris", ((48, 8),), integer=True),
        Field("crs", ((56, 16),), scale_exp2=-5, signed=True),
        Field("delta_n", ((72, 16),), scale_exp2=-43, signed=True),
        Field("m0", ((88, 8), (96, 24)), scale_exp2=-31, signed=True),
        Field("cuc", ((120, 16),), scale_exp2=-29, signed=True),
        Field("eccentricity", ((136, 8), (144, 24)), scale_exp2=-33),
        Field("cus", ((168, 16),), scale_exp2=-29, signed=True),
        Field("sqrt_a", ((184, 8), (192, 24)), scale_exp2=-19),
        Field("t_oe", ((216, 16),), scale_exp2=4),
        Field("fit_interval_flag", ((232, 1),), integer=True),
        Field("age_of_data_offset", ((233, 5),), integer=True),
    )

    @property
    def subframe_id(self) -> GpsSubframeId:
        return GpsSubframeId.TWO


@dataclass(frozen=True)
class Subframe3:
    """Ephemeris part 2 (IS-GPS-200 §20.3.3.4;
    reference: gypsum/navigation_message_parser.py:539-597)."""

    cic: float  # rad
    omega0: float  # semicircles
    cis: float  # rad
    i0: float  # semicircles
    crc: float  # m
    omega: float  # semicircles (argument of perigee)
    omega_dot: float  # semicircles/s
    issue_of_data_ephemeris: int
    idot: float  # semicircles/s

    FIELDS = (
        Field("cic", ((48, 16),), scale_exp2=-29, signed=True),
        Field("omega0", ((64, 8), (72, 24)), scale_exp2=-31, signed=True),
        Field("cis", ((96, 16),), scale_exp2=-29, signed=True),
        Field("i0", ((112, 8), (120, 24)), scale_exp2=-31, signed=True),
        Field("crc", ((144, 16),), scale_exp2=-5, signed=True),
        Field("omega", ((160, 8), (168, 24)), scale_exp2=-31, signed=True),
        Field("omega_dot", ((192, 24),), scale_exp2=-43, signed=True),
        Field("issue_of_data_ephemeris", ((216, 8),), integer=True),
        Field("idot", ((224, 14),), scale_exp2=-43, signed=True),
    )

    @property
    def subframe_id(self) -> GpsSubframeId:
        return GpsSubframeId.THREE


@dataclass(frozen=True)
class Subframe4:
    """Page id only, like the reference
    (gypsum/navigation_message_parser.py:599-618) — except page 18, which
    decodes into Subframe4Page18 below."""

    data_id: int
    page_id: int

    FIELDS = (
        Field("data_id", ((48, 2),), integer=True),
        Field("page_id", ((50, 6),), integer=True),
    )

    @property
    def subframe_id(self) -> GpsSubframeId:
        return GpsSubframeId.FOUR


# The SV-ID field value that marks subframe 4 page 18 (IS-GPS-200 Table
# 20-V: pages are identified by the SV ID they carry; page 18 uses ID 56).
PAGE18_SV_ID = 56


@dataclass(frozen=True)
class Subframe4Almanac:
    """Subframe 4 pages 2-5 and 7-10: almanac for SVs 25-32, in exactly the
    subframe-5 layout (IS-GPS-200 §20.3.3.5.1.2 — 'the almanac data ...
    for SV 25 through 32 ... shall be as shown for subframe 5'). The
    reference drops these pages; decoding them completes the warm-start
    almanac for the FULL constellation (subframe 5 only covers SVs 1-24).
    Field set mirrors Subframe5 so AlmanacStore.ingest handles both."""

    data_id: int
    almanac_sv_id: int
    eccentricity: float
    t_oa: float
    delta_i: float
    omega_dot: float
    sv_health: int
    sqrt_a: float
    omega0: float
    omega: float
    m0: float
    a_f0: float
    a_f1: float

    @property
    def subframe_id(self) -> GpsSubframeId:
        return GpsSubframeId.FOUR


@dataclass(frozen=True)
class Subframe4Page18:
    """Ionospheric (Klobuchar) and UTC parameters, subframe 4 page 18
    (IS-GPS-200 §20.3.3.5.1.6-1.8, Figure 20-1 sheet 8). The reference
    skips every subframe-4 payload (gypsum/navigation_message_parser.py:
    599-618); decoding this page is the accuracy lever that lets the solver
    remove ionospheric group delay (solve/iono.py) and convert GPS time to
    UTC."""

    data_id: int
    page_id: int
    # Klobuchar ionosphere: vertical-delay amplitude polynomial (s,
    # s/semicircle, ...) and period polynomial (s, s/semicircle, ...).
    alpha0: float
    alpha1: float
    alpha2: float
    alpha3: float
    beta0: float
    beta1: float
    beta2: float
    beta3: float
    # UTC conversion: t_UTC = t_GPS - delta_t_ls - A0 - A1 (t - t_ot).
    a1_utc: float  # s/s
    a0_utc: float  # s
    t_ot: float  # s of week (reference time for the UTC polynomial)
    wn_t: int  # UTC reference week number (mod 256)
    delta_t_ls: int  # s — current leap-second count
    wn_lsf: int  # week number of a scheduled future leap second (mod 256)
    dn: int  # day number of that event
    delta_t_lsf: int  # s — leap seconds after the event

    FIELDS = (
        Field("data_id", ((48, 2),), integer=True),
        Field("page_id", ((50, 6),), integer=True),
        Field("alpha0", ((56, 8),), scale_exp2=-30, signed=True),
        Field("alpha1", ((64, 8),), scale_exp2=-27, signed=True),
        Field("alpha2", ((72, 8),), scale_exp2=-24, signed=True),
        Field("alpha3", ((80, 8),), scale_exp2=-24, signed=True),
        Field("beta0", ((88, 8),), scale_exp2=11, signed=True),
        Field("beta1", ((96, 8),), scale_exp2=14, signed=True),
        Field("beta2", ((104, 8),), scale_exp2=16, signed=True),
        Field("beta3", ((112, 8),), scale_exp2=16, signed=True),
        Field("a1_utc", ((120, 24),), scale_exp2=-50, signed=True),
        Field("a0_utc", ((144, 24), (168, 8)), scale_exp2=-30, signed=True),
        Field("t_ot", ((176, 8),), scale_exp2=12),
        Field("wn_t", ((184, 8),), integer=True),
        Field("delta_t_ls", ((192, 8),), integer=True, signed=True),
        Field("wn_lsf", ((200, 8),), integer=True),
        Field("dn", ((208, 8),), integer=True),
        Field("delta_t_lsf", ((216, 8),), integer=True, signed=True),
    )

    @property
    def subframe_id(self) -> GpsSubframeId:
        return GpsSubframeId.FOUR


@dataclass(frozen=True)
class Subframe5:
    """Almanac, pages 1-24 (IS-GPS-200 §20.3.3.5;
    reference: gypsum/navigation_message_parser.py:620-673)."""

    data_id: int
    almanac_sv_id: int
    eccentricity: float
    t_oa: float  # s
    delta_i: float  # semicircles
    omega_dot: float  # semicircles/s
    sv_health: int
    sqrt_a: float  # m^0.5
    omega0: float  # semicircles
    omega: float  # semicircles
    m0: float  # semicircles
    a_f0: float  # s
    a_f1: float  # s/s

    FIELDS = (
        Field("data_id", ((48, 2),), integer=True),
        Field("almanac_sv_id", ((50, 6),), integer=True),
        Field("eccentricity", ((56, 16),), scale_exp2=-21),
        Field("t_oa", ((72, 8),), scale_exp2=12),
        Field("delta_i", ((80, 16),), scale_exp2=-19, signed=True),
        Field("omega_dot", ((96, 16),), scale_exp2=-38, signed=True),
        Field("sv_health", ((112, 8),), integer=True),
        Field("sqrt_a", ((120, 24),), scale_exp2=-11),
        Field("omega0", ((144, 24),), scale_exp2=-23, signed=True),
        Field("omega", ((168, 24),), scale_exp2=-23, signed=True),
        Field("m0", ((192, 24),), scale_exp2=-23, signed=True),
        Field("a_f0", ((216, 8), (235, 3)), scale_exp2=-20, signed=True),
        Field("a_f1", ((224, 11),), scale_exp2=-38, signed=True),
    )

    @property
    def subframe_id(self) -> GpsSubframeId:
        return GpsSubframeId.FIVE


# Subframe-4 almanac pages use subframe 5's exact field layout (ICD
# §20.3.3.5.1.2); the SV-ID range 25-32 selects this decode in
# decode_subframe.
Subframe4Almanac.FIELDS = Subframe5.FIELDS

Subframe = (
    Subframe1 | Subframe2 | Subframe3 | Subframe4 | Subframe4Page18
    | Subframe4Almanac | Subframe5
)

_SUBFRAME_CLASSES: dict[GpsSubframeId, type] = {
    GpsSubframeId.ONE: Subframe1,
    GpsSubframeId.TWO: Subframe2,
    GpsSubframeId.THREE: Subframe3,
    GpsSubframeId.FOUR: Subframe4,
    GpsSubframeId.FIVE: Subframe5,
}


# ------------------------------------------------------------------ decode


@dataclass(frozen=True)
class DecodedSubframe:
    telemetry: TelemetryWord
    handover: HandoverWord
    subframe: Subframe
    failed_parity_words: tuple[int, ...]


def decode_subframe(transmitted_bits: np.ndarray, strict_parity: bool = False) -> DecodedSubframe:
    """Parse 300 transmitted subframe bits (upright polarity).

    Raises IncorrectPreambleError / InvalidSubframeIdError exactly where the
    reference does (gypsum/navigation_message_parser.py:393-424).
    """
    source, failed = decode_words(transmitted_bits, strict=strict_parity)

    if tuple(int(b) for b in source[:8]) != TELEMETRY_PREAMBLE_BITS:
        raise IncorrectPreambleError(f"TLM preamble {source[:8].tolist()}")
    telemetry = TelemetryWord(
        tlm_message=_bits_to_int(source[8:22]),
        integrity_status_flag=int(source[22]),
        spare_bit=int(source[23]),
    )
    handover = HandoverWord(
        tow_count=_bits_to_int(source[24:41]),
        alert_flag=int(source[41]),
        anti_spoof_flag=int(source[42]),
        subframe_id=GpsSubframeId.from_bits((int(source[43]), int(source[44]), int(source[45]))),
    )
    cls = _SUBFRAME_CLASSES[handover.subframe_id]
    if cls is Subframe4:
        sv_id = decode_field(source, Subframe4.FIELDS[1])
        if sv_id == PAGE18_SV_ID:
            cls = Subframe4Page18  # ionosphere/UTC (IS-GPS-200 Table 20-V)
        elif 25 <= sv_id <= 32:
            cls = Subframe4Almanac  # almanac for SVs 25-32 (sf5 layout)
    values = {f.name: decode_field(source, f) for f in cls.FIELDS}
    return DecodedSubframe(
        telemetry=telemetry,
        handover=handover,
        subframe=cls(**values),
        failed_parity_words=tuple(failed),
    )


# ------------------------------------------------------------------ encode


def encode_subframe(
    payload: Subframe,
    tow_count: int,
    tlm_message: int = 0,
    alert_flag: int = 0,
    anti_spoof_flag: int = 0,
) -> np.ndarray:
    """Build the 300 transmitted bits for one subframe.

    ``tow_count`` is the 17-bit truncated TOW count of the *next* subframe's
    leading edge, per IS-GPS-200 §20.3.3.2. Words 2 and 10's final data bits
    are solved so the parity chain closes at D29=D30=0.
    """
    source = np.zeros(DATA_BITS_PER_WORD * WORDS_PER_SUBFRAME, dtype=np.int8)
    # Word 1: TLM.
    source[0:8] = np.array(TELEMETRY_PREAMBLE_BITS, dtype=np.int8)
    source[8:22] = _int_to_bits(tlm_message, 14)
    # Word 2: HOW.
    if not 0 <= tow_count < (1 << 17):
        raise ValueError(f"tow_count {tow_count} out of 17-bit range")
    source[24:41] = _int_to_bits(tow_count, 17)
    source[41] = alert_flag
    source[42] = anti_spoof_flag
    sid = payload.subframe_id.value
    source[43:46] = _int_to_bits(sid, 3)
    # Payload words 3..10.
    for f in type(payload).FIELDS:
        encode_field(source, f, getattr(payload, f.name))

    # Encode word-by-word, solving the reserved closing bits of words 2 and 10.
    out = np.empty(BITS_PER_SUBFRAME, dtype=np.int8)
    d29_star, d30_star = 0, 0
    for w in range(WORDS_PER_SUBFRAME):
        src = source[w * DATA_BITS_PER_WORD : (w + 1) * DATA_BITS_PER_WORD]
        if w in (1, 9):
            src = solve_parity_closing_bits(src[:22], d29_star, d30_star)
        word = encode_word(src, d29_star, d30_star)
        out[w * 30 : (w + 1) * 30] = word
        d29_star, d30_star = int(word[-2]), int(word[-1])
    return out


def roundtrip_fields(payload: Subframe) -> Subframe:
    """Quantize a payload to its transmitted precision (encode+decode of the
    field layer only) — handy for constructing self-consistent fixtures."""
    source = np.zeros(DATA_BITS_PER_WORD * WORDS_PER_SUBFRAME, dtype=np.int8)
    for f in type(payload).FIELDS:
        encode_field(source, f, getattr(payload, f.name))
    values = {f.name: decode_field(source, f) for f in type(payload).FIELDS}
    return type(payload)(**values)

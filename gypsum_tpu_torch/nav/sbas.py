"""SBAS L1 data channel: rate-1/2 convolutional FEC, framing, and messages.

Beyond the reference (which is GPS-only, 32 SVs): SBAS geostationary signals
(WAAS/EGNOS/MSAS, PRNs 120-138) share the GPS Gold-code family (signal/prn.py)
and the same acquisition/tracking path, but carry a completely different data
channel per RTCA DO-229 §A.4:

- 250 bps data, convolutionally encoded (K=7, rate 1/2, generators G1=171o,
  G2=133o, G1 symbol transmitted first) to 500 symbols/s — each symbol spans
  2 PRN periods (2 ms), vs the GPS nav bit's 20.
- 250-bit / 1 s message blocks: 8-bit preamble (a 24-bit pattern 01010011
  10011010 11000110 distributed over 3 successive blocks), 6-bit message
  type, 212-bit data field, 24-bit CRC-24Q over the first 226 bits.
- Message type 9 carries the GEO's navigation data: an ECEF
  position/velocity/acceleration polynomial plus an SNT clock model — the
  ranging analogue of a GPS ephemeris subframe trio.

Everything here is host-side numpy (the 250 bps decode is nowhere near the
compute path); the device-side tracking of SBAS channels is the ordinary
tracker (track/loop.py) fed by the widened replica table.

The decoder is deliberately *windowed*: the transmit encoder is continuous
across blocks, but any 500-symbol message window can be decoded independently
by running Viterbi over the window plus a guard of ~3 constraint lengths on
each side with free boundary states — interior bits converge to the maximum-
likelihood path, so no streaming decoder state needs checkpointing.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# 8-bit block preambles: a 24-bit pattern distributed over 3 successive
# 250-bit blocks (DO-229 §A.4.3.3).
PREAMBLES: tuple[int, int, int] = (0b01010011, 0b10011010, 0b11000110)
BLOCK_BITS = 250
DATA_BITS = 212
SYMBOLS_PER_SECOND = 500
BITS_PER_SECOND = 250

# Convolutional code generators (K=7): octal 171/133, newest bit in the MSB.
_G1 = 0o171
_G2 = 0o133
_K = 7
_N_STATES = 1 << (_K - 1)  # 64


def _parity(x: np.ndarray | int):
    """Bit-parity of every element (values < 2^7)."""
    x = np.asarray(x)
    x = x ^ (x >> 4)
    x = x ^ (x >> 2)
    x = x ^ (x >> 1)
    return x & 1


# Precomputed encoder tables: for register value r (7 bits, newest bit = MSB),
# the two output symbols.
_REG = np.arange(1 << _K)
_OUT1 = _parity(_REG & _G1).astype(np.int8)
_OUT2 = _parity(_REG & _G2).astype(np.int8)


def convolutional_encode(bits01: np.ndarray, state: int = 0) -> tuple[np.ndarray, int]:
    """Encode {0,1} bits to interleaved symbols [g1_0, g2_0, g1_1, ...].

    ``state`` is the 6-bit shift register (previous bits, newest = MSB);
    returned so successive calls form one continuous encoder, as the SBAS
    signal does across block boundaries (DO-229 §A.4.3.2).
    """
    bits = np.asarray(bits01, dtype=np.int64) & 1
    out = np.empty(2 * len(bits), dtype=np.int8)
    s = int(state) & (_N_STATES - 1)
    for i, b in enumerate(bits):
        reg = (int(b) << (_K - 1)) | s
        out[2 * i] = _OUT1[reg]
        out[2 * i + 1] = _OUT2[reg]
        s = reg >> 1
    return out, s


def viterbi_decode(soft_symbols: np.ndarray) -> np.ndarray:
    """Soft-decision Viterbi decode of interleaved symbols to {0,1} bits.

    ``soft_symbols``: float array, one entry per transmitted symbol, positive
    for a transmitted '1' (length 2N for N bits; an odd tail symbol is
    dropped). Initial and final states are free (uniform metrics), so a
    window cut from a continuous symbol stream decodes correctly away from
    its edges.
    """
    sym = np.asarray(soft_symbols, dtype=np.float64)
    n_bits = len(sym) // 2
    if n_bits == 0:
        return np.zeros(0, dtype=np.int8)
    sym = sym[: 2 * n_bits]

    # Branch structure: from state s, input bit b -> register r = b<<6 | s,
    # next state r>>1, outputs (_OUT1[r], _OUT2[r]) in +/-1 form.
    regs = (np.arange(2)[:, None] << (_K - 1)) | np.arange(_N_STATES)[None, :]  # [2, 64]
    next_state = regs >> 1
    exp1 = _OUT1[regs].astype(np.float64) * 2.0 - 1.0  # [2, 64]
    exp2 = _OUT2[regs].astype(np.float64) * 2.0 - 1.0

    metrics = np.zeros(_N_STATES)
    # back[t, s'] = register value whose transition won state s' at step t.
    back = np.empty((n_bits, _N_STATES), dtype=np.int16)
    for t in range(n_bits):
        g1, g2 = sym[2 * t], sym[2 * t + 1]
        cand = metrics[None, :] + exp1 * g1 + exp2 * g2  # [2(b), 64(s)]
        new_metrics = np.full(_N_STATES, -np.inf)
        winner = np.zeros(_N_STATES, dtype=np.int16)
        for b in (0, 1):
            ns = next_state[b]
            # Two source states (s even / s odd) map onto each next state;
            # resolve the 2-to-1 scatter as two conflict-free halves.
            for half in (0, 1):
                src = np.arange(half, _N_STATES, 2)
                tgt = ns[src]
                m = cand[b, src]
                upd = m > new_metrics[tgt]
                new_metrics[tgt] = np.where(upd, m, new_metrics[tgt])
                winner[tgt] = np.where(upd, regs[b, src], winner[tgt])
        metrics = new_metrics - new_metrics.max()
        back[t] = winner

    # Traceback from the best final state.
    s = int(np.argmax(metrics))
    bits = np.empty(n_bits, dtype=np.int8)
    for t in range(n_bits - 1, -1, -1):
        reg = int(back[t, s])
        bits[t] = reg >> (_K - 1)
        s = reg & (_N_STATES - 1)
    return bits


# ----------------------------------------------------------------- CRC-24Q

_CRC24Q_POLY = 0x1864CFB


def crc24q(bits01: np.ndarray) -> int:
    """CRC-24Q (RTCM/SBAS) over a {0,1} bit array, MSB-first, zero initial."""
    crc = 0
    for b in np.asarray(bits01, dtype=np.int64) & 1:
        crc = (crc << 1) | int(b)
        if crc & 0x1000000:
            crc ^= _CRC24Q_POLY
    # Flush 24 zero bits (equivalent closed form: multiply by x^24 mod poly).
    for _ in range(24):
        crc <<= 1
        if crc & 0x1000000:
            crc ^= _CRC24Q_POLY
    return crc & 0xFFFFFF


# ------------------------------------------------------------- bit packing


def _pack(value: int, n_bits: int) -> list[int]:
    return [(int(value) >> (n_bits - 1 - i)) & 1 for i in range(n_bits)]


def _unpack(bits: np.ndarray, cursor: int, n_bits: int, signed: bool = False) -> tuple[int, int]:
    raw = 0
    for b in bits[cursor : cursor + n_bits]:
        raw = (raw << 1) | int(b)
    if signed and raw >= 1 << (n_bits - 1):
        raw -= 1 << n_bits
    return raw, cursor + n_bits


# ---------------------------------------------------------------- messages


@dataclass(frozen=True)
class GeoNavigationMessage:
    """SBAS message type 9: GEO navigation (DO-229 §A.4.4.11).

    Position/velocity/acceleration are an ECEF Taylor expansion around
    ``t0_sec_of_day`` (SNT seconds of day); the clock model is
    a_gf0 + a_gf1 * (t - t0).
    """

    prn: int  # filled by the decoder (not in the air interface)
    t0_sec_of_day: float  # 13 bits x 16 s
    ura: int  # 4 bits
    xyz_m: tuple[float, float, float]  # 30/30/25 bits x 0.08/0.08/0.4 m
    vel_mps: tuple[float, float, float]  # 17/17/18 bits x 0.000625/0.000625/0.004
    acc_mps2: tuple[float, float, float]  # 10/10/10 bits x 1.25e-5/1.25e-5/6.25e-5
    a_gf0_s: float  # 12 bits x 2^-31 s
    a_gf1_ss: float  # 8 bits x 2^-40 s/s

    def position_velocity(self, t_sec_of_day: float) -> tuple[np.ndarray, np.ndarray]:
        """ECEF position (m) and velocity (m/s) at SNT time-of-day t."""
        dt = t_sec_of_day - self.t0_sec_of_day
        # Day wrap (scenes near midnight): pick the representation closest
        # to t0.
        if dt > 43200.0:
            dt -= 86400.0
        elif dt < -43200.0:
            dt += 86400.0
        p = np.asarray(self.xyz_m) + np.asarray(self.vel_mps) * dt \
            + 0.5 * np.asarray(self.acc_mps2) * dt * dt
        v = np.asarray(self.vel_mps) + np.asarray(self.acc_mps2) * dt
        return p, v

    def clock_correction_s(self, t_sec_of_day: float) -> float:
        dt = t_sec_of_day - self.t0_sec_of_day
        if dt > 43200.0:
            dt -= 86400.0
        elif dt < -43200.0:
            dt += 86400.0
        return self.a_gf0_s + self.a_gf1_ss * dt

    # Vectorized forms (synthesizer grids / solver batches).

    def _dt(self, t_sec_of_day: np.ndarray) -> np.ndarray:
        dt = np.asarray(t_sec_of_day, dtype=np.float64) - self.t0_sec_of_day
        dt = np.where(dt > 43200.0, dt - 86400.0, dt)
        return np.where(dt < -43200.0, dt + 86400.0, dt)

    def positions(self, t_sec_of_day: np.ndarray) -> np.ndarray:
        """ECEF positions [N, 3] (m) at SNT times-of-day [N]."""
        dt = self._dt(t_sec_of_day)[:, None]
        return (
            np.asarray(self.xyz_m)[None, :]
            + np.asarray(self.vel_mps)[None, :] * dt
            + 0.5 * np.asarray(self.acc_mps2)[None, :] * dt * dt
        )

    def clock_corrections(self, t_sec_of_day: np.ndarray) -> np.ndarray:
        return self.a_gf0_s + self.a_gf1_ss * self._dt(t_sec_of_day)


# (scale, n_bits, signed) per MT9 field, in air-interface order after the
# 8-bit IODN/spare field.
_MT9_LAYOUT = (
    ("t0", 16.0, 13, False),
    ("ura", 1, 4, False),
    ("x", 0.08, 30, True),
    ("y", 0.08, 30, True),
    ("z", 0.4, 25, True),
    ("vx", 0.000625, 17, True),
    ("vy", 0.000625, 17, True),
    ("vz", 0.004, 18, True),
    ("ax", 0.0000125, 10, True),
    ("ay", 0.0000125, 10, True),
    ("az", 0.0000625, 10, True),
    ("agf0", 2.0**-31, 12, True),
    ("agf1", 2.0**-40, 8, True),
)


def encode_mt9_data(msg: GeoNavigationMessage) -> np.ndarray:
    """MT9 212-bit data field as {0,1}."""
    values = {
        "t0": msg.t0_sec_of_day,
        "ura": msg.ura,
        "x": msg.xyz_m[0], "y": msg.xyz_m[1], "z": msg.xyz_m[2],
        "vx": msg.vel_mps[0], "vy": msg.vel_mps[1], "vz": msg.vel_mps[2],
        "ax": msg.acc_mps2[0], "ay": msg.acc_mps2[1], "az": msg.acc_mps2[2],
        "agf0": msg.a_gf0_s, "agf1": msg.a_gf1_ss,
    }
    bits: list[int] = _pack(0, 8)  # IODN / spare
    for name, scale, n, signed in _MT9_LAYOUT:
        raw = int(round(values[name] / scale))
        lo = -(1 << (n - 1)) if signed else 0
        hi = (1 << (n - 1)) - 1 if signed else (1 << n) - 1
        if not lo <= raw <= hi:
            raise ValueError(f"MT9 field {name}={values[name]} out of range")
        bits += _pack(raw & ((1 << n) - 1), n)
    out = np.array(bits, dtype=np.int8)
    assert len(out) == DATA_BITS
    return out


def parse_mt9_data(data_bits: np.ndarray, prn: int) -> GeoNavigationMessage:
    cur = 8  # skip IODN / spare
    vals = {}
    for name, scale, n, signed in _MT9_LAYOUT:
        raw, cur = _unpack(data_bits, cur, n, signed)
        vals[name] = raw * scale
    return GeoNavigationMessage(
        prn=prn,
        t0_sec_of_day=vals["t0"],
        ura=int(vals["ura"]),
        xyz_m=(vals["x"], vals["y"], vals["z"]),
        vel_mps=(vals["vx"], vals["vy"], vals["vz"]),
        acc_mps2=(vals["ax"], vals["ay"], vals["az"]),
        a_gf0_s=vals["agf0"],
        a_gf1_ss=vals["agf1"],
    )


# --------------------------------------------------------------------------
# MT1 (PRN mask) + MT2-5 (fast corrections): the DGPS payload (DO-229 §A.4.4.2
# / §A.4.4.3). Slot arithmetic: the 210-bit mask's set bits, in ascending
# slot order, define the correction sequence; MT(2+g) carries sequence
# entries 13g+1 .. 13g+13. Mask slots 1-37 are GPS PRNs 1-37.
# --------------------------------------------------------------------------

#: DO-229 Table A-6 sigma^2_UDRE (m^2), UDREI 0-13; 14 = not monitored,
#: 15 = do not use. The values are (bound / 3.29)^2 of the 99.9% bounds
#: 0.75, 1.0, 1.25, 1.75, 2.25, 3.0, 3.75, 4.5, 5.25, 6.0, 7.5, 15, 50, 150 m.
UDRE_VARIANCE_M2: tuple[float, ...] = tuple(
    (b / 3.29) ** 2
    for b in (0.75, 1.0, 1.25, 1.75, 2.25, 3.0, 3.75, 4.5, 5.25, 6.0,
              7.5, 15.0, 50.0, 150.0)
)
PRC_SCALE_M = 0.125  # 12-bit signed LSB: +/-256 m range
N_MASK_SLOTS = 210
CORRECTIONS_PER_MESSAGE = 13


@dataclass(frozen=True)
class PrnMask:
    """MT1: which of the 210 PRN slots carry corrections (IODP-versioned)."""

    iodp: int
    slots: tuple[int, ...]  # ascending 1-based mask slots (== GPS PRN for 1-37)


@dataclass(frozen=True)
class FastCorrections:
    """One MT2-5 block: 13 consecutive correction-sequence entries."""

    message_type: int  # 2..5; sequence offset = (mt - 2) * 13
    iodf: int
    iodp: int
    prc_m: tuple[float, ...]  # 13 entries
    udrei: tuple[int, ...]  # 13 entries


def encode_mt1_data(mask: PrnMask) -> np.ndarray:
    bits = np.zeros(DATA_BITS, dtype=np.int8)
    for slot in mask.slots:
        if not 1 <= slot <= N_MASK_SLOTS:
            raise ValueError(f"mask slot {slot} outside 1..{N_MASK_SLOTS}")
        bits[slot - 1] = 1
    bits[N_MASK_SLOTS : N_MASK_SLOTS + 2] = _pack(mask.iodp, 2)
    return bits


def parse_mt1_data(data_bits: np.ndarray) -> PrnMask:
    slots = tuple(int(i) + 1 for i in np.flatnonzero(data_bits[:N_MASK_SLOTS]))
    iodp, _ = _unpack(data_bits, N_MASK_SLOTS, 2)
    return PrnMask(iodp=int(iodp), slots=slots)


def encode_fast_corrections_data(fc: FastCorrections) -> np.ndarray:
    if not 2 <= fc.message_type <= 5:
        raise ValueError(f"fast corrections are MT2-5, got {fc.message_type}")
    if len(fc.prc_m) != CORRECTIONS_PER_MESSAGE or len(fc.udrei) != CORRECTIONS_PER_MESSAGE:
        raise ValueError("fast corrections carry exactly 13 slots")
    bits: list[int] = _pack(fc.iodf, 2) + _pack(fc.iodp, 2)
    for prc in fc.prc_m:
        raw = int(round(prc / PRC_SCALE_M))
        if not -2048 <= raw <= 2047:
            raise ValueError(f"PRC {prc} m outside the +/-256 m field")
        bits += _pack(raw & 0xFFF, 12)
    for u in fc.udrei:
        bits += _pack(int(u), 4)
    bits += [0] * (DATA_BITS - len(bits))
    return np.array(bits, dtype=np.int8)


def parse_fast_corrections_data(
    data_bits: np.ndarray, message_type: int
) -> FastCorrections:
    iodf, cur = _unpack(data_bits, 0, 2)
    iodp, cur = _unpack(data_bits, cur, 2)
    prc = []
    for _ in range(CORRECTIONS_PER_MESSAGE):
        raw, cur = _unpack(data_bits, cur, 12, signed=True)
        prc.append(raw * PRC_SCALE_M)
    udrei = []
    for _ in range(CORRECTIONS_PER_MESSAGE):
        raw, cur = _unpack(data_bits, cur, 4)
        udrei.append(int(raw))
    return FastCorrections(
        message_type=int(message_type), iodf=int(iodf), iodp=int(iodp),
        prc_m=tuple(prc), udrei=tuple(udrei),
    )


def encode_block(message_type: int, data_bits: np.ndarray, preamble_idx: int) -> np.ndarray:
    """One 250-bit SBAS block: preamble, 6-bit type, 212-bit data, CRC-24Q."""
    data_bits = np.asarray(data_bits, dtype=np.int8)
    if len(data_bits) != DATA_BITS:
        raise ValueError(f"data field must be {DATA_BITS} bits, got {len(data_bits)}")
    head = np.array(
        _pack(PREAMBLES[preamble_idx % 3], 8) + _pack(message_type, 6), dtype=np.int8
    )
    body = np.concatenate([head, data_bits])
    crc = crc24q(body)
    return np.concatenate([body, np.array(_pack(crc, 24), dtype=np.int8)])


def encode_symbol_stream(
    messages: list[tuple[int, np.ndarray]], first_preamble_idx: int = 0
) -> np.ndarray:
    """Transmit side: successive 1 s messages -> one continuous +/-1 symbol
    stream (the encoder register carries across block boundaries, DO-229
    §A.4.3.2). Used by the constellation synthesizer."""
    state = 0
    parts = []
    for k, (mt, data) in enumerate(messages):
        block = encode_block(mt, data, first_preamble_idx + k)
        sym, state = convolutional_encode(block, state)
        parts.append(sym)
    return (np.concatenate(parts).astype(np.int8) * 2 - 1).astype(np.int8)


@dataclass(frozen=True)
class SbasBlock:
    """One CRC-verified 250-bit block with its receiver timing."""

    prn: int
    message_type: int
    data_bits: np.ndarray
    # Receiver timestamp of the block's FIRST symbol leading edge (code-phase
    # corrected, like GPS subframe edges) — the SBAS ranging time base.
    leading_edge_timestamp: float
    preamble_idx: int


class SbasFrameDecoder:
    """Symbol stream -> CRC-verified blocks for one SBAS channel.

    Consumes the tracker's 1 ms prompt correlations (2 pseudosymbols per
    FEC symbol), establishes the three nested phases the GPS decoder solves
    one at a time (nav/bits.py + nav/frames.py) in a single search:
    millisecond-pair phase (2), G1/G2 symbol pairing (2), and polarity (2)
    x block alignment (500), by Viterbi-decoding the candidate stream and
    scanning for preamble-consistent, CRC-passing blocks.
    """

    # Decode guard on each side of a block window, in bits.
    _GUARD_BITS = 8
    _SYNC_SYMBOLS = 2 * SYMBOLS_PER_SECOND + 64  # need ~2 blocks buffered

    def __init__(self, prn: int) -> None:
        self.prn = prn
        self._soft: list[float] = []  # per-ms prompt (i) stream
        self._times: list[float] = []  # leading-edge timestamp per ms
        self._ms_phase: int | None = None  # 0/1: first ms of a symbol
        self._sym_phase: int | None = None  # 0/1: G1 symbol within a pair
        self._polarity: int = 1
        self._next_block_sym: int | None = None  # symbol index of next block
        self._next_preamble_idx: int = 0
        self._n_ms_seen = 0

    # ------------------------------------------------------------ ingestion

    def process_block(
        self, prompt_i: np.ndarray, start_times: np.ndarray
    ) -> list[SbasBlock]:
        """Feed one tracking block's per-ms prompt I values (+ their
        code-phase-corrected leading-edge timestamps); returns any blocks
        completed."""
        self._soft.extend(np.asarray(prompt_i, dtype=np.float64).tolist())
        self._times.extend(np.asarray(start_times, dtype=np.float64).tolist())
        self._n_ms_seen += len(prompt_i)
        out: list[SbasBlock] = []
        if self._next_block_sym is None:
            self._try_sync()
        if self._next_block_sym is not None:
            out = self._drain_blocks()
        self._trim()
        return out

    # ----------------------------------------------------------- internals

    def _symbols(self) -> np.ndarray:
        """Pair milliseconds into soft FEC symbols at the current ms phase."""
        s = np.asarray(self._soft[self._ms_phase or 0 :], dtype=np.float64)
        n = len(s) // 2
        return s[: 2 * n].reshape(n, 2).sum(axis=1)

    def _symbol_time(self, sym_idx: int) -> float:
        return self._times[(self._ms_phase or 0) + 2 * sym_idx]

    def _try_sync(self) -> None:
        if len(self._soft) < 2 * self._SYNC_SYMBOLS:
            return
        # Millisecond-pair phase: the alignment whose paired sums have the
        # larger magnitude (symbol boundaries double the coherent sum).
        best = None
        for ms_phase in (0, 1):
            s = np.asarray(self._soft[ms_phase:], dtype=np.float64)
            n = len(s) // 2
            strength = float(np.abs(s[: 2 * n].reshape(n, 2).sum(axis=1)).mean())
            if best is None or strength > best[1]:
                best = (ms_phase, strength)
        self._ms_phase = best[0]
        symbols = self._symbols()

        # Symbol pairing + polarity + block alignment: decode both pairings,
        # scan for a preamble-led CRC-passing block in both polarities.
        for sym_phase in (0, 1):
            window = symbols[sym_phase:]
            bits = viterbi_decode(window)
            for pol in (1, -1):
                b = bits if pol == 1 else 1 - bits
                hit = self._scan_blocks(b)
                if hit is not None:
                    bit_idx, pre_idx = hit
                    self._sym_phase = sym_phase
                    self._polarity = pol
                    # Block start in symbol coordinates.
                    self._next_block_sym = sym_phase + 2 * bit_idx
                    self._next_preamble_idx = pre_idx
                    return

    def _scan_blocks(self, bits: np.ndarray) -> tuple[int, int] | None:
        """Find (bit_index, preamble_idx) of a CRC-verified block start."""
        pre_bits = [np.array(_pack(p, 8), dtype=np.int8) for p in PREAMBLES]
        limit = len(bits) - BLOCK_BITS
        for i in range(0, max(0, limit)):
            for pi, pb in enumerate(pre_bits):
                if np.array_equal(bits[i : i + 8], pb):
                    if crc24q(bits[i : i + BLOCK_BITS]) == 0:
                        return i, pi
        return None

    def _drain_blocks(self) -> list[SbasBlock]:
        out: list[SbasBlock] = []
        symbols = self._symbols()
        guard_sym = 2 * self._GUARD_BITS
        while True:
            start = self._next_block_sym
            end = start + 2 * BLOCK_BITS
            if end + guard_sym > len(symbols):
                break
            lo = max(self._sym_phase, start - guard_sym)
            # Keep the G1/G2 pairing: lo must share start's parity.
            if (lo - start) % 2:
                lo += 1
            window = symbols[lo:end + guard_sym]
            bits = viterbi_decode(window)
            if self._polarity < 0:
                bits = 1 - bits
            off = (start - lo) // 2
            block_bits = bits[off : off + BLOCK_BITS]
            expected_pre = np.array(
                _pack(PREAMBLES[self._next_preamble_idx % 3], 8), dtype=np.int8
            )
            ok = (
                np.array_equal(block_bits[:8], expected_pre)
                and crc24q(block_bits) == 0
            )
            if ok:
                mt, _ = _unpack(block_bits, 8, 6)
                out.append(
                    SbasBlock(
                        prn=self.prn,
                        message_type=mt,
                        data_bits=block_bits[14 : 14 + DATA_BITS].copy(),
                        leading_edge_timestamp=self._symbol_time(start),
                        preamble_idx=self._next_preamble_idx % 3,
                    )
                )
                self._next_block_sym = end
                self._next_preamble_idx += 1
            else:
                # Lost sync: fall back to a fresh search on the next feed.
                self._next_block_sym = None
                break
        return out

    def _trim(self) -> None:
        """Bound the buffers: drop whole consumed symbols, keeping alignment
        parity (trim in multiples of 2 ms so ms/symbol phases survive)."""
        if self._next_block_sym is None:
            keep_ms = 2 * self._SYNC_SYMBOLS + 16
        else:
            keep_sym = len(self._symbols()) - self._next_block_sym + 2 * self._GUARD_BITS
            keep_ms = 2 * keep_sym + 4
        drop = len(self._soft) - keep_ms
        drop -= drop % 4  # preserve ms-pair and symbol-pair parity
        if drop > 0:
            del self._soft[:drop]
            del self._times[:drop]
            if self._next_block_sym is not None:
                self._next_block_sym -= drop // 2

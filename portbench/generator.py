"""The traffic generator: a pool of recorded captures, made from the seed.

One general generator for every configuration and farm mix. From the
configuration (band, rate, streams, channels, front end) and the traffic
file (capture length, C/N0 range, Doppler range, restart hand-off), a seed
draws each capture's satellites: signal (PRN or FDMA frequency number),
Doppler, code phase, carrier phase, C/N0 and data symbols. The captures are
then synthesized sample by sample:

    x[n] = sum_s A_s c_s(C_s(t)) d_s(C_s(t)) exp(j 2 pi (f_s t + phi_s)) + noise

with t = n / fs, C_s(t) = R_s t + C0_s the received code position in chips
(R_s the chip rate scaled by 1 + Doppler / carrier: code Doppler consistent
with the carrier), f_s the FDMA offset plus the Doppler, the code c_s and
data symbols d_s of the chip position, and complex Gaussian noise of
``agc_noise_lsb`` per component; I and Q are rounded to int8. Positions and
phases are float64, so 60 s of code and carrier do not drift; the carrier is
reduced to one cycle before its float32 sine and cosine.

The pool is laid out in playback order, [R, B, N, L, 2] int8: ring block j
holds, for stream n, its capture at ms ((j + o_n) mod R) B + m, where R is
the capture length in blocks and o_n spreads the streams' restarts evenly
over the ring. So block k of a run is ``pool[k % R]``, one contiguous
[B, N, L, 2] slice, every block reads new bytes, and no stream repeats a
block within R blocks.

On a card the pool is made by one kernel (``csrc/synth.cu``); ``synth_plain``
is the same arithmetic in PyTorch, for the CPU and as the kernel's check.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from portbench import codes as codegen

TWO_PI = 2.0 * math.pi
# Carry rows of a hand-off: the program's TrackState fields in order.
STATE_FIELDS = ("code_phase", "carrier_phase", "doppler", "carrier_offset", "ema_err",
                "ema_err_sq", "ema_quality", "step_count", "lost")


@dataclass
class Captures:
    """Every capture's truth, [C, S] arrays (C captures, S satellites)."""

    band: str
    samples_per_ms: int  # L
    sample_rate: float  # fs = 1000 L
    chips: int  # N
    symbol_periods: int  # code periods per data symbol
    capture_ms: int  # T
    block_ms: int  # B
    stagger: np.ndarray  # [C] int: o_n, the stream's ring offset in blocks
    signals: np.ndarray  # [C, S] int: PRN (GPS) or frequency number (GLONASS)
    code_rows: np.ndarray  # [C, S] int: row of ``code_table``
    code_table: np.ndarray  # [n, N] int8 {0, 1}
    offset_hz: np.ndarray  # [C, S] float64: FDMA offset
    doppler_hz: np.ndarray  # [C, S] float64
    chip_rate: np.ndarray  # [C, S] float64: received chips per second
    chip0: np.ndarray  # [C, S] float64: code position (chips) at t = 0
    cycles0: np.ndarray  # [C, S] float64: carrier phase at t = 0 (cycles)
    amplitude: np.ndarray  # [C, S] float32, LSB
    symbols: np.ndarray  # [C, S, n_sym] int8 +/-1
    noise_lsb: float
    seed_words: tuple[int, int]  # the noise hash's two 32-bit keys

    @property
    def ring(self) -> int:
        return self.capture_ms // self.block_ms

    @property
    def freq_hz(self) -> np.ndarray:
        return self.offset_hz + self.doppler_hz


def make_captures(config: dict, traffic: dict, seed: int) -> Captures:
    """Draw every capture's satellites from ``seed``; the same seed gives
    the same captures."""
    rng = np.random.default_rng(seed)
    n_caps, n_sats = config["streams"], config["channels_per_stream"]
    length = config["samples_per_ms"]
    fs = float(config["sample_rate_hz"])
    if abs(fs - 1000.0 * length) > 1e-6:
        raise ValueError("sample_rate_hz must be 1000 x samples_per_ms")
    band, chips = config["band"], config["chips_per_code"]
    block_ms = config["tracking"]["block_size_ms"]
    capture_ms = int(round(1000 * traffic["capture_s"]))
    if capture_ms % block_ms:
        raise ValueError("capture_s must be a whole number of blocks")
    ring = capture_ms // block_ms
    pool_signals = np.asarray(config["signals"])
    signals = np.stack([rng.choice(pool_signals, n_sats, replace=False) for _ in range(n_caps)])
    codes = codegen.band(band)
    table, code_rows = codes.table(), codes.code_rows(signals)
    offset = signals * float(config["fdma_spacing_hz"])
    carrier = float(config["carrier_hz"]) + offset
    dmax = float(traffic["doppler_hz"])
    doppler = rng.uniform(-dmax, dmax, (n_caps, n_sats))
    chip_rate = float(config["chip_rate_hz"]) * (1.0 + doppler / carrier)
    period = config["symbol_periods"]
    # A random code phase and a random first data-symbol edge.
    chip0 = rng.uniform(0.0, chips, (n_caps, n_sats)) + chips * rng.integers(0, period, (n_caps, n_sats))
    cycles0 = rng.uniform(0.0, 1.0, (n_caps, n_sats))
    lo, hi = traffic["cn0_dbhz"]
    cn0 = rng.uniform(lo, hi, (n_caps, n_sats))
    sigma = float(config["agc_noise_lsb"])
    # C/N0 = A^2 fs / (2 sigma^2) for complex noise of sigma per component.
    amplitude = (sigma * np.sqrt(2.0 * 10.0 ** (cn0 / 10.0) / fs)).astype(np.float32)
    n_sym = capture_ms // period + 3
    if config.get("meander"):
        bits = rng.choice(np.array([-1, 1], dtype=np.int8), (n_caps, n_sats, (n_sym + 1) // 2))
        meander = np.where(np.arange(n_sym) % 2 == 0, 1, -1).astype(np.int8)
        symbols = np.repeat(bits, 2, axis=2)[..., :n_sym] * meander
    else:
        symbols = rng.choice(np.array([-1, 1], dtype=np.int8), (n_caps, n_sats, n_sym))
    words = rng.integers(0, 2**32, 2, dtype=np.uint64)
    stagger = (np.arange(n_caps) * ring) // n_caps
    return Captures(
        band=band, samples_per_ms=length, sample_rate=fs, chips=chips, symbol_periods=period,
        capture_ms=capture_ms, block_ms=block_ms, stagger=stagger, signals=signals,
        code_rows=code_rows, code_table=np.ascontiguousarray(table), offset_hz=offset,
        doppler_hz=doppler, chip_rate=chip_rate, chip0=chip0, cycles0=cycles0,
        amplitude=amplitude, symbols=symbols.astype(np.int8), noise_lsb=sigma,
        seed_words=(int(words[0]), int(words[1])),
    )


def handoff(caps: Captures, t_ms: np.ndarray, traffic: dict) -> dict[str, np.ndarray]:
    """The carry a restarted channel starts from at capture time ``t_ms``
    ([C] ms): the truth, with the Doppler and the code phase pulled off by
    the traffic's hand-off offsets (what an acquisition would hand over).
    Returns the carry rows flattened to [C S], channel n S + s."""
    t = (np.asarray(t_ms, dtype=np.float64) * 1e-3)[:, None]
    length, chips = caps.samples_per_ms, caps.chips
    position = caps.chip_rate * t + caps.chip0
    code_phase = np.mod(-np.mod(position, chips) * (length / chips), length)
    off = traffic["handoff"]
    cyc = caps.freq_hz * t + caps.cycles0
    z = np.zeros(caps.signals.shape)
    rows = {
        "code_phase": np.mod(code_phase + off["code_phase_samples"], length),
        "carrier_phase": TWO_PI * (cyc - np.floor(cyc)),
        "doppler": caps.doppler_hz + off["doppler_hz"],
        "carrier_offset": caps.offset_hz,
        "ema_err": z, "ema_err_sq": z, "ema_quality": z, "step_count": z, "lost": z,
    }
    return {k: v.reshape(-1) for k, v in rows.items()}


# ----------------------------------------------------------------- noise hash

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2^32 for int64 x in [0, 2^32), in halves so that no product
    leaves int64."""
    hi = ((x >> 16) * c) & 0xFFFF
    return ((hi << 16) + (x & 0xFFFF) * c) & _M32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (the 'lowbias32' constants), on int64 tensors
    holding 32-bit values; ``csrc/synth.cu:mix32`` is the same."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _noise(caps: Captures, cap: int, t: torch.Tensor, l_idx: torch.Tensor):
    """Standard normal (n_i, n_q) float32 of every sample (ms t, sample l)
    of capture ``cap``: Box-Muller on two hashes of the sample's place."""
    s1, s2 = caps.seed_words
    row = (cap * caps.capture_ms + t) & _M32
    k1 = mix32(row ^ s1)
    ha = mix32(k1 ^ mix32((2 * l_idx) ^ s2))
    hb = mix32(k1 ^ mix32((2 * l_idx + 1) ^ s2))
    u1 = ((ha >> 9).to(torch.float32) + 0.5) * 2.0**-23
    u2 = (hb >> 9).to(torch.float32) * 2.0**-23
    r = torch.sqrt(-2.0 * torch.log(u1))
    ang = np.float32(TWO_PI) * u2
    return r * torch.cos(ang), r * torch.sin(ang)


def synth_plain(caps: Captures, cap: int, t0: int, n_ms: int, device="cpu") -> torch.Tensor:
    """Capture ``cap``'s ms t0 .. t0 + n_ms as [n_ms, L, 2] int8, in plain
    PyTorch (the arithmetic of ``csrc/synth.cu``, operation for
    operation)."""
    length = caps.samples_per_ms
    t = torch.arange(t0, t0 + n_ms, device=device, dtype=torch.int64)[:, None]
    l_idx = torch.arange(length, device=device, dtype=torch.int64)[None, :]
    tabs = (t * length + l_idx).to(torch.float64) / caps.sample_rate
    table = torch.from_numpy(np.array(caps.code_table)).to(device)
    acc_i = torch.zeros((n_ms, length), dtype=torch.float32, device=device)
    acc_q = torch.zeros_like(acc_i)
    chips = float(caps.chips)
    for s in range(caps.signals.shape[1]):
        pos = caps.chip_rate[cap, s] * tabs + caps.chip0[cap, s]
        epoch = torch.floor(pos / chips)
        frac = pos - epoch * chips
        low, high = frac < 0.0, frac >= chips
        frac = torch.where(low, frac + chips, torch.where(high, frac - chips, frac))
        epoch = torch.where(low, epoch - 1.0, torch.where(high, epoch + 1.0, epoch))
        cidx = torch.clamp(torch.floor(frac).to(torch.int64), 0, caps.chips - 1)
        chip = table[int(caps.code_rows[cap, s])][cidx].to(torch.float32) * 2.0 - 1.0
        syms = torch.as_tensor(caps.symbols[cap, s], device=device)
        sym = syms[torch.remainder(epoch.to(torch.int64) // caps.symbol_periods, syms.numel())]
        cyc = caps.freq_hz[cap, s] * tabs + caps.cycles0[cap, s]
        ph = (TWO_PI * (cyc - torch.floor(cyc))).to(torch.float32)
        v = float(caps.amplitude[cap, s]) * (chip * sym.to(torch.float32))
        acc_i = acc_i + v * torch.cos(ph)
        acc_q = acc_q + v * torch.sin(ph)
    n_i, n_q = _noise(caps, cap, t, l_idx)
    sigma = np.float32(caps.noise_lsb)
    acc_i = acc_i + sigma * n_i
    acc_q = acc_q + sigma * n_q
    out = torch.stack([acc_i, acc_q], dim=-1)
    return torch.clamp(torch.round(out), -127.0, 127.0).to(torch.int8)


def make_pool(caps: Captures, device) -> torch.Tensor:
    """The whole pool [R, B, C, L, 2] int8 on ``device``: the synthesis
    kernel on a card, ``synth_plain`` capture by capture on the CPU."""
    dev = torch.device(device)
    ring, block = caps.ring, caps.block_ms
    n_caps, length = caps.signals.shape[0], caps.samples_per_ms
    if dev.type == "cuda":
        from portbench import native

        return native.synthesize_pool(caps, dev)
    pool = torch.empty((ring, block, n_caps, length, 2), dtype=torch.int8)
    for n in range(n_caps):
        whole = synth_plain(caps, n, 0, caps.capture_ms)
        for j in range(ring):
            t0 = ((j + int(caps.stagger[n])) % ring) * block
            pool[j, :, n] = whole[t0:t0 + block]
    return pool

"""Synthetic GPS L1 C/A IQ signal generation.

The reference has no signal synthesizer: its only end-to-end fixture is a
vendored 2-satellite-hour SDR recording (reference: gypsum/radio_input.py:101-111).
This module generates physically-modeled IQ so every stage — acquisition,
tracking, bit sync, framing, ephemeris decode, position fix — can be tested
hermetically with known ground truth (SURVEY.md §4 "signal-synthesis fixtures").

Model per satellite (baseband, after the SDR's L1 downconversion):

    x(t) = A * C((t - tau(t)) * chip_rate_tx) * D(t - tau(t)) * exp(j*(2*pi*fd*t + phi))

where C is the +/-1 C/A code, D the +/-1 navigation bit stream (50 bps), tau
the signal delay, and fd the carrier Doppler. Code Doppler is modeled
consistently: the received chip rate is scaled by (1 + fd / f_L1), so long
captures keep code and carrier coherent exactly like a real SV.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from gypsum_tpu_torch.core.constants import (
    CA_CHIP_RATE_HZ,
    GPS_L1_FREQUENCY_HZ,
    PRN_CHIP_COUNT,
    PSEUDOSYMBOLS_PER_NAVIGATION_BIT,
)
from gypsum_tpu_torch.signal.prn import ca_code


@dataclass
class SyntheticSatellite:
    """Ground-truth parameters for one simulated SV."""

    prn: int
    doppler_hz: float = 0.0
    # Signal delay at t=0, expressed in stream samples (so the acquisition
    # code-phase estimate should equal this mod samples_per_prn).
    delay_samples: float = 0.0
    carrier_phase_rad: float = 0.0
    amplitude: float = 0.2
    # Navigation bits as +/-1; tiled if the capture outlasts them. Defaults to
    # an alternating pattern so bit edges exist for bit-phase sync.
    nav_bits: np.ndarray = field(default_factory=lambda: np.array([1, -1], dtype=np.int8))
    # Linear Doppler drift (Hz/s), for stress-testing tracking loops.
    doppler_rate_hz_per_s: float = 0.0
    # PRN periods per data symbol: 20 for GPS nav bits (50 bps), 2 for SBAS
    # L1 FEC symbols (500 sps, DO-229 §A.4.3).
    symbol_periods: int = PSEUDOSYMBOLS_PER_NAVIGATION_BIT


def synthesize_iq(
    satellites: list[SyntheticSatellite],
    n_samples: int,
    sample_rate: float,
    noise_sigma: float = 0.0,
    t0: float = 0.0,
    seed: int = 0,
    dtype=np.complex64,
) -> np.ndarray:
    """Generate ``n_samples`` of baseband IQ containing the given satellites.

    Generation is vectorized per satellite over the whole capture; float64 time
    is used internally (host-side numpy) so multi-minute captures stay phase
    exact.
    """
    t = t0 + np.arange(n_samples, dtype=np.float64) / sample_rate
    out = np.zeros(n_samples, dtype=np.complex128)

    for sat in satellites:
        code = ca_code(sat.prn).astype(np.float64) * 2.0 - 1.0
        bits = np.asarray(sat.nav_bits, dtype=np.float64)
        # Received chip rate includes code Doppler (carrier and code are
        # generated from the same SV oscillator).
        chip_rate_rx = CA_CHIP_RATE_HZ * (1.0 + sat.doppler_hz / GPS_L1_FREQUENCY_HZ)
        delay_s = sat.delay_samples / sample_rate
        # Transmit-time coordinate of each sample.
        t_tx = t - delay_s
        chip_pos = t_tx * chip_rate_rx
        # Integrate-and-dump chip sampling (see constellation.py): preserves
        # sub-sample code timing instead of quantizing it to whole samples.
        step = chip_rate_rx / sample_rate
        i0 = np.floor(chip_pos).astype(np.int64)
        i1 = np.floor(chip_pos + step).astype(np.int64)
        c0 = code[i0 % PRN_CHIP_COUNT]
        c1 = code[i1 % PRN_CHIP_COUNT]
        w = np.clip((chip_pos + step - i1) / step, 0.0, 1.0)
        chips = np.where(i1 > i0, c0 * (1.0 - w) + c1 * w, c0)
        # Data symbol index: symbol_periods PRN periods per symbol
        # (20 for GPS nav bits, 2 for SBAS FEC symbols).
        bit_idx = np.floor(chip_pos / (PRN_CHIP_COUNT * sat.symbol_periods)).astype(np.int64)
        bit_vals = bits[bit_idx % len(bits)]
        # Carrier: Doppler (+ optional drift) relative to stream time.
        phase = (
            2.0 * np.pi * (sat.doppler_hz * t + 0.5 * sat.doppler_rate_hz_per_s * t * t)
            + sat.carrier_phase_rad
        )
        out += sat.amplitude * chips * bit_vals * np.exp(1j * phase)

    if noise_sigma > 0.0:
        rng = np.random.default_rng(seed)
        out += noise_sigma * (rng.standard_normal(n_samples) + 1j * rng.standard_normal(n_samples)) / np.sqrt(2.0)

    return out.astype(dtype)


def nav_bit_schedule(
    bits_pm1: np.ndarray, n_ms: int,
    symbol_periods: int = PSEUDOSYMBOLS_PER_NAVIGATION_BIT,
) -> np.ndarray:
    """Expand +/-1 data symbols to the per-millisecond pseudosymbol truth: the
    sign the tracker's prompt correlation should report each millisecond."""
    per_ms = np.repeat(np.asarray(bits_pm1, dtype=np.int8), symbol_periods)
    reps = int(np.ceil(n_ms / len(per_ms)))
    return np.tile(per_ms, reps)[:n_ms]

"""Multi-element antenna-array capture synthesis (CRPA fixtures).

Copy of gypsum_tpu/signal/array.py (numpy on the host; its captures are
bit-identical to the JAX package's).

A controlled-reception-pattern antenna (CRPA) receives the same scene on N
elements a fraction of a carrier wavelength apart; each arriving wavefront
hits the elements with relative phases ``2*pi * (d_e . u_src) / lambda``
(element offset d_e, source unit direction u_src). GPS signals ride ~20 dB
below the thermal floor, so the spatial covariance of the array output is
dominated by noise + any jammer — which is exactly what makes blind
power-inversion nulling work (ops/beamform.py).

The synthesizer reuses synthesize_constellation once per element with the
per-satellite wavefront phase injected through
``ConstellationSatellite.extra_carrier_phase_rad`` (directions from the real
ephemeris geometry at scene midpoint; over the few-second captures these
change by micro-radians). The code-delay difference across a <1 m array is
<3 ns — 0.006 samples at 2.046 Msps — so a pure phase model is exact at
this scale. Thermal noise is independent per element; a jammer (CW or
band-limited noise — the kind the STFT excision CANNOT remove) arrives from
its own azimuth/elevation with the same wavefront phasing.

reference: no counterpart — gypsum is a single-antenna receiver by
construction (gypsum/antenna_sample_provider.py).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from gypsum_tpu_torch.core.constants import (
    GPS_L1_FREQUENCY_HZ,
    SPEED_OF_LIGHT_M_PER_S as C,
)
from gypsum_tpu_torch.signal.constellation import (
    ConstellationSatellite,
    ConstellationTruth,
    synthesize_constellation,
)
from gypsum_tpu_torch.solve.ephemeris import satellite_position
from gypsum_tpu_torch.solve.geodesy import enu_basis

L1_WAVELENGTH_M = C / GPS_L1_FREQUENCY_HZ  # ~0.1903 m


@dataclass(frozen=True)
class ArrayJammer:
    """One interferer arriving from a fixed direction (local ENU angles).

    ``kind="noise"``: band-limited complex Gaussian — broadband, so the
    spectral-mask excision path (ops/interference.py) cannot remove it
    without erasing the signal band too; the CRPA null is the only defense.
    ``kind="cw"``: a tone at ``freq_hz`` baseband offset (also removable by
    the notch; useful for cross-validating the two defenses)."""

    azimuth_deg: float
    elevation_deg: float
    amplitude: float  # same units as satellite amplitudes (~0.2) / noise sigma
    kind: str = "noise"
    freq_hz: float = 257e3  # cw offset
    bandwidth_hz: float = 1.0e6  # noise kind: two-sided bandwidth
    seed: int = 99


def square_array_enu(spacing_m: float = L1_WAVELENGTH_M / 2.0) -> np.ndarray:
    """A 4-element square in the local horizontal plane, ``spacing_m`` on a
    side (default half the L1 wavelength — the classic grating-lobe-free
    CRPA layout). Returns [4, 3] ENU offsets in meters."""
    h = spacing_m / 2.0
    return np.array(
        [[-h, -h, 0.0], [h, -h, 0.0], [h, h, 0.0], [-h, h, 0.0]]
    )


def direction_enu(azimuth_deg: float, elevation_deg: float) -> np.ndarray:
    """Unit vector (ENU) pointing FROM the receiver TOWARD a source at the
    given azimuth (deg clockwise from north) and elevation (deg up)."""
    az = np.radians(azimuth_deg)
    el = np.radians(elevation_deg)
    return np.array(
        [np.sin(az) * np.cos(el), np.cos(az) * np.cos(el), np.sin(el)]
    )


def _jammer_waveform(jam: ArrayJammer, n: int, sample_rate: float) -> np.ndarray:
    rng = np.random.default_rng(jam.seed ^ 0x1A33E5)
    if jam.kind == "cw":
        t = np.arange(n, dtype=np.float64) / sample_rate
        return (jam.amplitude * np.exp(2j * np.pi * jam.freq_hz * t)).astype(
            np.complex64
        )
    if jam.kind != "noise":
        raise ValueError(f"unknown jammer kind {jam.kind!r}")
    # Band-limited complex Gaussian: white -> brick-wall in the frequency
    # domain, renormalized to the requested amplitude (RMS).
    white = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) / np.sqrt(2.0)
    spec = np.fft.fft(white)
    freqs = np.fft.fftfreq(n, d=1.0 / sample_rate)
    spec[np.abs(freqs) > jam.bandwidth_hz / 2.0] = 0.0
    shaped = np.fft.ifft(spec)
    rms = np.sqrt(np.mean(np.abs(shaped) ** 2))
    return (jam.amplitude / max(rms, 1e-30) * shaped).astype(np.complex64)


def synthesize_array(
    satellites: list[ConstellationSatellite],
    receiver_ecef: np.ndarray,
    gps_start_time_sow: float,
    duration_s: float,
    sample_rate: float,
    elements_enu: np.ndarray | None = None,
    noise_sigma: float = 0.3,
    jammer: ArrayJammer | None = None,
    seed: int = 0,
    **synth_kwargs,
) -> tuple[np.ndarray, ConstellationTruth]:
    """Synthesize an [N_elements, n_samples] complex64 array capture.

    Element 0's stream is a normal single-antenna capture of the scene (its
    truth is returned); the other elements carry the same signals with the
    wavefront phases of their geometry and independent thermal noise.
    """
    rx = np.asarray(receiver_ecef, np.float64)
    elements = (
        square_array_enu() if elements_enu is None else np.asarray(elements_enu)
    )
    east, north, up = enu_basis(rx)
    basis = np.stack([east, north, up])  # [3(enu), 3(ecef)]
    elements_ecef = elements @ basis  # [N, 3]

    # Satellite unit directions at scene midpoint (ephemeris geometry).
    mid = gps_start_time_sow + duration_s / 2.0
    dir_of = {}
    for sat in satellites:
        pos = satellite_position(sat.ephemeris, mid)
        los = pos - rx
        dir_of[sat.prn] = los / np.linalg.norm(los)

    n_samples = int(round(duration_s * sample_rate))
    out = np.empty((len(elements), n_samples), dtype=np.complex64)
    truth = None
    for e, d in enumerate(elements_ecef):
        sats_e = [
            dataclasses.replace(
                sat,
                extra_carrier_phase_rad=2.0
                * np.pi
                * float(d @ dir_of[sat.prn])
                / L1_WAVELENGTH_M,
            )
            for sat in satellites
        ]
        iq_e, truth_e = synthesize_constellation(
            sats_e, rx, gps_start_time_sow, duration_s, sample_rate,
            noise_sigma=noise_sigma, seed=seed + 7919 * e, **synth_kwargs,
        )
        out[e, : len(iq_e)] = iq_e[:n_samples]
        if e == 0:
            truth = truth_e

    if jammer is not None:
        wave = _jammer_waveform(jammer, n_samples, sample_rate)
        u_jam = direction_enu(jammer.azimuth_deg, jammer.elevation_deg) @ basis
        for e, d in enumerate(elements_ecef):
            phase = 2.0 * np.pi * float(d @ u_jam) / L1_WAVELENGTH_M
            out[e] += (wave * np.exp(1j * phase)).astype(np.complex64)

    return out, truth

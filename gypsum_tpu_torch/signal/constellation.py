"""Physically-consistent constellation-level IQ synthesis.

Extends the single-satellite synthesizer (signal/synth.py) to a full scene:
given per-SV broadcast ephemerides, a receiver position, and a GPS start
time, generate baseband IQ whose code phases, Doppler, carrier phase, nav
message content and inter-satellite timing are all mutually consistent —
so the complete receiver chain (acquisition -> tracking -> bit sync ->
subframe decode -> ephemeris assembly -> position fix) can be validated
end-to-end against ground truth with no recorded capture. (The reference's
only end-to-end fixture is a vendored SDR recording,
gypsum/radio_input.py:101-111.)

Model per satellite: the sample taken at GPS time t carries the signal the
SV emitted at t_em(t) = t - tau(t), where tau solves
tau = |sat(t - tau) - rx| / c. The SV modulates its C/A code and nav data
against its own clock t_sv = t_em + delta_t_sv(t_em); subframe leading edges
sit at t_sv = tow_count * 6 exactly. After an ideal L1 downconversion the
baseband carrier phase is -2 pi f_L1 tau(t): geometry-driven Doppler, code
Doppler, and inter-satellite range differences all fall out automatically.
tau and delta_t_sv are evaluated on a 10 ms grid and linearly interpolated
(range acceleration ~ m/s^2 keeps the interpolation error sub-millimeter).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from gypsum_tpu_torch.core.constants import (
    CA_CHIP_RATE_HZ,
    GPS_L1_FREQUENCY_HZ,
    PRN_CHIP_COUNT,
    SPEED_OF_LIGHT_M_PER_S as C,
)
from gypsum_tpu_torch.nav.sbas import (
    GeoNavigationMessage,
    SYMBOLS_PER_SECOND,
    encode_mt9_data,
    encode_symbol_stream,
)
from gypsum_tpu_torch.nav.subframes import Subframe4, Subframe5, encode_subframe
from gypsum_tpu_torch.signal.prn import ca_code
from gypsum_tpu_torch.solve.ephemeris import (
    Ephemeris,
    clock_correction,
    satellite_position,
    subframes_from_ephemeris,
)

_GRID_STEP_S = 0.01  # tau / SV-clock interpolation grid
_BIT_DURATION_S = 0.02  # 50 bps


@dataclass
class ConstellationSatellite:
    prn: int
    ephemeris: Ephemeris
    amplitude: float = 0.2
    sf4: Subframe4 = field(default_factory=lambda: Subframe4(data_id=1, page_id=1))
    # Almanac pages this SV relays on subframe 5, cycled in order of
    # occurrence (every real SV broadcasts the whole constellation's almanac;
    # see almanac_pages_for_scene). Empty -> subframe-5 slots carry sf4's
    # payload, as before.
    sf5_pages: list[Subframe5] = field(default_factory=list)
    # Fault injection: the SV transmits only inside this *stream-time*
    # window (seconds; None = unbounded). An SV masked mid-capture models
    # an obstruction/outage — the drop-to-coast scenario the navigation
    # EKF (solve/ekf.py) exists for.
    visible_from_s: float | None = None
    visible_until_s: float | None = None
    # Obstruction windows (stream-time [start, end) seconds): the SV
    # transmits OUTSIDE these intervals. Unlike visible_until_s the signal
    # RETURNS — the vector-coast scenario (runtime/receiver.py:_enter_coast)
    # where a blocked channel must resume ranging in place.
    blocked_s: list = field(default_factory=list)
    # Deep-fade windows (stream-time [start, end, amplitude_scale)): the SV
    # transmits at ``amplitude * scale`` inside each window — below the
    # tracking loops' threshold but above the deep-integration floor, the
    # coast-with-measurement scenario (track/deepmeas.py). Unlike blocked_s
    # the signal is still PRESENT, just weak (foliage/indoor attenuation).
    faded_s: list = field(default_factory=list)
    # Fault injection for SBAS fast corrections: a satellite clock error
    # (range-equivalent meters) present in the SIGNAL but absent from the
    # broadcast clock model — the receiver's pseudorange comes out SHORT by
    # this much until an SBAS GEO's MT2 PRC (= +this value) corrects it.
    unmodeled_clock_error_m: float = 0.0
    # Constant extra carrier phase (rad) on this satellite's signal: the
    # per-element wavefront phase of an antenna-array capture
    # (signal/array.py) — d . u / lambda for element offset d and satellite
    # direction u. Zero for single-antenna scenes.
    extra_carrier_phase_rad: float = 0.0


@dataclass
class GlonassSatellite:
    """A GLONASS L1OF satellite in a GLONASS-band scene (FDMA: the capture's
    front end is centered at 1602 MHz and each satellite rides its own
    k * 562.5 kHz sub-band; satellites share the 511-chip SP code).

    The scene timeline stays GPS seconds-of-week; the satellite's own data
    and code timelines run on GLONASS time (UTC+3h, see solve/glonass.py)
    plus the scene's ``glonass_time_offset_s`` — the sub-microsecond
    inter-system offset the receiver must SOLVE, not assume."""

    ephemeris: "object"  # solve.glonass.GlonassEphemeris
    amplitude: float = 0.2
    visible_from_s: float | None = None
    visible_until_s: float | None = None
    # Obstruction windows [start, end) s — the signal RETURNS (vector coast).
    blocked_s: list = field(default_factory=list)

    @property
    def prn(self) -> int:
        from gypsum_tpu_torch.signal.prn import glonass_prn_id

        return glonass_prn_id(self.ephemeris.frequency_number)


def _glonass_symbols(
    sat: "GlonassSatellite", glo_day_start: float, duration_s: float
) -> tuple[np.ndarray, float]:
    """(+/-1 100 sps symbol stream, GLONASS-day time of its first symbol)
    covering the capture with slack. Strings are emitted against the SV's
    own clock; frame starts sit on 30 s boundaries of the GLONASS day and
    string 1's tk stamps each frame."""
    from gypsum_tpu_torch.nav.glonass import encode_frame_symbols, frame_strings_for_ephemeris
    from gypsum_tpu_torch.solve.glonass import strings_from_glonass_ephemeris

    eph_strings = strings_from_glonass_ephemeris(sat.ephemeris)
    first_frame = int(np.floor((glo_day_start - 2.0) / 30.0))
    n_frames = int(np.ceil((duration_s + 6.0) / 30.0)) + 1
    chunks = []
    for f in range(first_frame, first_frame + n_frames):
        frame_start_day_s = (f * 30.0) % 86400.0
        chunks.append(encode_frame_symbols(
            frame_strings_for_ephemeris(eph_strings, frame_start_day_s)
        ))
    return np.concatenate(chunks).astype(np.float64), first_frame * 30.0


@dataclass
class SbasGeoSatellite:
    """An SBAS GEO in the scene: ranges exactly like a GPS SV (same Gold-code
    family, signal/prn.py) but broadcasts the DO-229 data channel — 500 sps
    FEC symbols carrying 1 s message blocks, MT9 (its own ECEF polynomial
    ephemeris) every ``mt9_every`` seconds with MT63 null filler between.
    Message leading edges align to integer SNT seconds, which is what gives
    the receiver its sub-second SBAS time base."""

    prn: int  # 120..138
    geo: GeoNavigationMessage
    amplitude: float = 0.2
    mt9_every: int = 4
    visible_from_s: float | None = None
    visible_until_s: float | None = None
    # Obstruction windows [start, end) s — the signal RETURNS (vector coast).
    blocked_s: list = field(default_factory=list)
    # Fast corrections to broadcast: GPS PRN -> PRC meters (DO-229 MT1 mask
    # + MT2 every other second). Pair with ConstellationSatellite
    # .unmodeled_clock_error_m on the corrected SVs: PRC = +that value.
    fast_corrections: dict[int, float] | None = None
    correction_udrei: int = 5


def _sbas_symbols(
    sat: "SbasGeoSatellite", gps_start_time_sow: float, duration_s: float, seed: int
) -> tuple[np.ndarray, float]:
    """(+/-1 symbol stream, SV-time of its first symbol edge) covering the
    capture with slack on both sides."""
    first_sec = int(np.floor(gps_start_time_sow)) - 2
    n_msgs = int(np.ceil(duration_s)) + 5
    rng = np.random.default_rng(seed ^ (0x5BA5 + sat.prn))
    mt1 = mt2 = None
    if sat.fast_corrections:
        from gypsum_tpu_torch.nav.sbas import (
            CORRECTIONS_PER_MESSAGE,
            FastCorrections,
            PrnMask,
            encode_fast_corrections_data,
            encode_mt1_data,
        )

        prns = sorted(sat.fast_corrections)
        if len(prns) > CORRECTIONS_PER_MESSAGE:
            raise ValueError("demo GEO broadcasts a single MT2 (<= 13 SVs)")
        mask = PrnMask(iodp=0, slots=tuple(prns))  # GPS PRN == mask slot
        pad = CORRECTIONS_PER_MESSAGE - len(prns)
        fc = FastCorrections(
            message_type=2, iodf=0, iodp=0,
            prc_m=tuple(sat.fast_corrections[p] for p in prns) + (0.0,) * pad,
            udrei=(sat.correction_udrei,) * len(prns) + (14,) * pad,
        )
        mt1 = encode_mt1_data(mask)
        mt2 = encode_fast_corrections_data(fc)
    msgs = []
    for k in range(n_msgs):
        sec = first_sec + k
        if sec % sat.mt9_every == 0:
            msgs.append((9, encode_mt9_data(sat.geo)))
        elif mt1 is not None and sec % sat.mt9_every == 1:
            msgs.append((1, mt1))
        elif mt2 is not None and sec % sat.mt9_every == 2:
            msgs.append((2, mt2))
        else:
            msgs.append((63, rng.integers(0, 2, 212).astype(np.int8)))
    sym = encode_symbol_stream(msgs, first_preamble_idx=first_sec % 3)
    return sym.astype(np.float64), float(first_sec)


@dataclass(frozen=True)
class RfImpairments:
    """Front-end realism knobs (VERDICT round-1 item 6: the reference's
    validation story is real SDR captures; these model what a recording has
    that clean synthesis lacks).

    Applied in signal-chain order: multipath (per satellite, inside the
    scene loop) -> TCXO phase noise -> front-end band-limiting -> thermal
    noise (in synthesize_constellation) -> ADC quantization.
    """

    # One extra propagation ray per satellite: excess delay (s), amplitude
    # relative to the direct ray, and carrier phase offset (rad). None = off.
    multipath_delay_s: float | None = None
    multipath_amplitude: float = 0.5
    multipath_phase_rad: float = 2.1
    # Receiver TCXO phase noise: random-walk standard deviation in
    # rad/sqrt(s) on the downconversion LO (typical TCXO ~ 0.1-1).
    phase_noise_rad_per_sqrt_s: float = 0.0
    # Front-end low-pass 3 dB cutoff (one-sided, Hz). An rtl-sdr at
    # 2.046 Msps passes roughly +/-1 MHz; tighter cutoffs round the code
    # chips and widen the correlation peak. None = off.
    frontend_bandwidth_hz: float | None = None
    # ADC resolution in bits per I/Q component (None = float capture).
    # 8 models rtl-sdr/hackrf; 1-4 stress hard limiting. Scale is counts
    # per unit amplitude (None = auto from the signal RMS, ~3 sigma full
    # scale).
    adc_bits: int | None = None
    adc_scale: float | None = None
    # CW / narrowband jammer entering the antenna: complex tone of this
    # amplitude (same units as satellite amplitudes ~1 and noise sigma) at
    # the given baseband offset, optionally swept (chirp). Applied FIRST so
    # the LO phase noise, front-end filter and ADC all act on it, exactly
    # as they would on a real interferer. None = off.
    cw_amplitude: float | None = None
    cw_freq_hz: float = 257e3
    cw_chirp_hz_per_s: float = 0.0


def apply_rf_impairments(
    iq: np.ndarray,
    sample_rate: float,
    imp: "RfImpairments",
    seed: int = 0,
    chunk: int = 2_000_000,
) -> np.ndarray:
    """Post-synthesis impairments: phase noise -> band-limit -> quantize.

    (Multipath is geometric and is applied inside synthesize_constellation's
    per-satellite loop, not here.)"""
    out = np.asarray(iq)
    rng = np.random.default_rng(seed ^ 0x5EED)
    n = len(out)

    if imp.cw_amplitude:
        res = np.empty_like(out)
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            t = np.arange(lo, hi, dtype=np.float64) / sample_rate
            ph = 2.0 * np.pi * (imp.cw_freq_hz * t
                                + 0.5 * imp.cw_chirp_hz_per_s * t * t)
            res[lo:hi] = out[lo:hi] + (
                imp.cw_amplitude * np.exp(1j * ph)
            ).astype(np.complex64)
        out = res

    if imp.phase_noise_rad_per_sqrt_s:
        # Random-walk phase: increments N(0, sigma^2 / fs) per sample.
        sigma_step = imp.phase_noise_rad_per_sqrt_s / np.sqrt(sample_rate)
        phi_last = 0.0
        res = np.empty_like(out)
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            steps = rng.standard_normal(hi - lo) * sigma_step
            phi = phi_last + np.cumsum(steps)
            phi_last = phi[-1]
            res[lo:hi] = out[lo:hi] * np.exp(1j * phi).astype(np.complex64)
        out = res

    if imp.frontend_bandwidth_hz is not None:
        # Windowed-sinc low-pass (81 taps, Hamming), overlap-correct chunked
        # convolution ('same' alignment).
        t_len = 81
        fc = imp.frontend_bandwidth_hz / sample_rate  # normalized one-sided
        m = np.arange(t_len) - (t_len - 1) / 2
        taps = 2 * fc * np.sinc(2 * fc * m) * np.hamming(t_len)
        taps = (taps / taps.sum()).astype(np.float64)
        half = (t_len - 1) // 2
        res = np.empty_like(out)
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            a = max(0, lo - half)
            b = min(n, hi + half)
            seg = np.convolve(out[a:b], taps, mode="same")
            res[lo:hi] = seg[lo - a : lo - a + (hi - lo)].astype(np.complex64)
        out = res

    if imp.adc_bits is not None:
        levels_half = 2 ** (imp.adc_bits - 1)
        if imp.adc_scale is not None:
            scale = imp.adc_scale
        else:
            rms = float(np.sqrt(np.mean(np.abs(out[: min(n, 1 << 20)]) ** 2)))
            scale = (levels_half - 0.5) / max(3.0 * rms / np.sqrt(2.0), 1e-12)
        # Mid-rise quantizer per component, clipped to the ADC range, and
        # rescaled back so downstream amplitudes stay comparable.
        q = np.empty_like(out)
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            re = np.clip(np.floor(out[lo:hi].real * scale) + 0.5, -levels_half + 0.5, levels_half - 0.5)
            im = np.clip(np.floor(out[lo:hi].imag * scale) + 0.5, -levels_half + 0.5, levels_half - 0.5)
            q[lo:hi] = ((re + 1j * im) / scale).astype(np.complex64)
        out = q

    return out


@dataclass(frozen=True)
class ConstellationTruth:
    """Ground truth for end-to-end assertions."""

    receiver_ecef: np.ndarray  # at t=0
    gps_start_time_sow: float
    doppler_hz: dict[int, float]  # at t=0
    code_phase_samples: dict[int, float]  # acquisition lag at t=0
    transit_time_s: dict[int, float]  # tau at t=0
    receiver_velocity_ecef: np.ndarray | None = None  # m/s (None = static)


def _nav_bits(
    sat: ConstellationSatellite, first_tow_count: int, n_subframes: int, pattern: str
) -> np.ndarray:
    """Transmitted nav bits (+1/-1) for subframes ``first_tow_count`` onward.
    Each subframe's HOW carries the *next* subframe's TOW count."""
    sf1, sf2, sf3 = subframes_from_ephemeris(sat.ephemeris)
    chunks = []
    n_sf5 = 0
    for k in range(n_subframes):
        tow = first_tow_count + k
        sid = (tow % 5) + 1 if pattern == "live" else int(pattern[k % len(pattern)])
        payload = {1: sf1, 2: sf2, 3: sf3}.get(sid, sat.sf4)
        if sid == 5 and sat.sf5_pages:
            payload = sat.sf5_pages[n_sf5 % len(sat.sf5_pages)]
            n_sf5 += 1
        chunks.append(encode_subframe(payload, tow_count=(tow + 1) % (1 << 17)))
    stream01 = np.concatenate(chunks)
    return (stream01.astype(np.int8) * 2 - 1).astype(np.int8)


def synthesize_constellation(
    satellites: list[ConstellationSatellite],
    receiver_ecef: np.ndarray,
    gps_start_time_sow: float,
    duration_s: float,
    sample_rate: float,
    noise_sigma: float = 0.3,
    subframe_pattern: str = "123",
    seed: int = 0,
    chunk_seconds: float = 1.0,
    receiver_velocity_ecef: np.ndarray | None = None,
    receiver_clock_drift: float = 0.0,
    impairments: "RfImpairments | None" = None,
    # GLONASS-band scenes (all satellites GlonassSatellite): the residual
    # GPS->GLONASS time offset beyond the deterministic UTC+3h/leap mapping
    # (receiver hardware biases + broadcast-level offset, typically well
    # under a microsecond). The receiver must SOLVE this as its
    # per-constellation clock unknown; it is never handed over.
    glonass_time_offset_s: float = 0.0,
    leap_seconds: int = 18,
    # GLONASS sub-band to synthesize: "l1" (1602 MHz + k*562.5 kHz) or "l2"
    # (1246 MHz + k*437.5 kHz). The SAME scene list synthesized at both
    # bands yields a coherent dual-frequency capture pair — the iono group
    # delay scales by (f_l1_gps/f)^2 per band, which is exactly what the
    # receiver's measured dual-frequency correction removes.
    glonass_band: str = "l1",
    iono=None,  # solve.iono.IonoUtcParams: inject Klobuchar-consistent delay
    # Saastamoinen tropospheric delay: ON by default — real signals always
    # carry it, and the solver's default correction removes it (set False
    # for geometric-only fixtures).
    tropo: bool = True,
) -> tuple[np.ndarray, ConstellationTruth]:
    """Generate ``duration_s`` of baseband IQ for the scene.

    Stream timestamp r corresponds to GPS system time gps_start_time_sow + r
    (the receiver discovers that mapping itself via handover words). With
    ``receiver_velocity_ecef`` the receiver moves rx(t) = rx0 + v (t - t0):
    the light-time iteration then bakes the motion into every satellite's
    Doppler, code rate and pseudorange (ground truth for the velocity solve).
    Returns (iq complex64, truth). Synthesis proceeds in ~1 s chunks to bound
    float64 temporaries.
    """
    rx = np.asarray(receiver_ecef, dtype=np.float64)
    v_rx = (
        np.zeros(3) if receiver_velocity_ecef is None
        else np.asarray(receiver_velocity_ecef, dtype=np.float64)
    )
    n_samples = int(round(duration_s * sample_rate))
    out = np.zeros(n_samples, dtype=np.complex64)

    # Shared coarse grid (GPS time) covering the capture plus slack.
    grid = gps_start_time_sow + np.arange(
        -_GRID_STEP_S, duration_s + 2 * _GRID_STEP_S, _GRID_STEP_S
    )

    truth_doppler: dict[int, float] = {}
    truth_code_phase: dict[int, float] = {}
    truth_transit: dict[int, float] = {}

    # First subframe begins comfortably before the capture start in SV time.
    first_tow_count = int(np.floor((gps_start_time_sow - 1.0) / 6.0))
    n_subframes = int(np.ceil((duration_s + 2.0) / 6.0)) + 1
    bits_t0_sv = first_tow_count * 6.0  # SV time of the bit stream's first bit

    chunk = int(round(chunk_seconds * sample_rate))
    rng = np.random.default_rng(seed)

    is_glonass_scene = any(isinstance(s, GlonassSatellite) for s in satellites)
    if is_glonass_scene and not all(isinstance(s, GlonassSatellite) for s in satellites):
        raise ValueError(
            "GLONASS (1602 MHz) and GPS/SBAS (1575.42 MHz) cannot share one "
            "baseband capture; synthesize the bands separately"
        )

    for sat in satellites:
        code = ca_code(sat.prn).astype(np.float64) * 2.0 - 1.0
        # Per-satellite signal parameters (GPS defaults; GLONASS overrides).
        chip_rate = CA_CHIP_RATE_HZ
        chip_count = PRN_CHIP_COUNT
        f_car = GPS_L1_FREQUENCY_HZ  # passband carrier
        f_off = 0.0  # FDMA baseband offset (carrier - front-end center)
        sv_time_shift = 0.0  # t_sv timeline = t + shift - tau + dtsv
        iono_scale = 1.0
        if isinstance(sat, GlonassSatellite):
            from gypsum_tpu_torch.core.constants import (
                GLONASS_CHIP_COUNT,
                GLONASS_CHIP_RATE_HZ,
                GLONASS_L1_BASE_HZ,
            )
            from gypsum_tpu_torch.solve.glonass import (
                glonass_clock_ahead_s,
                glonass_day_time_from_gps_sow,
                glonass_satellite_position,
            )

            eph_g = sat.ephemeris
            chip_rate = GLONASS_CHIP_RATE_HZ
            chip_count = GLONASS_CHIP_COUNT
            if glonass_band == "l2":
                from gypsum_tpu_torch.core.constants import (
                    GLONASS_L2_BASE_HZ,
                    GLONASS_L2_CHANNEL_SPACING_HZ,
                )

                k_num = eph_g.frequency_number
                f_car = GLONASS_L2_BASE_HZ + k_num * GLONASS_L2_CHANNEL_SPACING_HZ
                f_off = f_car - GLONASS_L2_BASE_HZ
            elif glonass_band == "l1":
                f_car = eph_g.carrier_frequency_hz
                f_off = f_car - GLONASS_L1_BASE_HZ
            else:
                raise ValueError(f"glonass_band must be 'l1' or 'l2', got {glonass_band!r}")
            # Klobuchar is referenced to GPS L1; group delay scales as f^-2.
            iono_scale = (GPS_L1_FREQUENCY_HZ / f_car) ** 2
            # GLONASS day-time of the scene origin (assumes the capture does
            # not straddle GLONASS midnight — day wrap unsupported here).
            glo0 = (
                glonass_day_time_from_gps_sow(gps_start_time_sow, leap_seconds)
                + glonass_time_offset_s
            )
            sv_time_shift = glo0 - gps_start_time_sow
            data_vals, data_t0_sv = _glonass_symbols(
                sat, glo0, duration_s
            )
            data_dur = 1.0 / 100.0  # 100 sps bi-binary line code

            def pos_at(t, _e=eph_g, _sh=sv_time_shift):
                return glonass_satellite_position(_e, np.asarray(t) + _sh)

            def clk_at(t, _e=eph_g, _sh=sv_time_shift):
                return np.asarray(glonass_clock_ahead_s(_e, np.asarray(t) + _sh))

            tau_guess = 0.075  # MEO at ~19,100 km altitude
        elif isinstance(sat, SbasGeoSatellite):
            # SBAS data channel: 2 ms FEC symbols, edges at integer SNT
            # seconds (SNT modeled as == GPS time).
            data_vals, data_t0_sv = _sbas_symbols(
                sat, gps_start_time_sow, duration_s, seed
            )
            data_dur = 1.0 / SYMBOLS_PER_SECOND
            geo = sat.geo

            def pos_at(t, _g=geo):
                return _g.positions(np.asarray(t) % 86400.0)

            def clk_at(t, _g=geo):
                return _g.clock_corrections(np.asarray(t) % 86400.0)

            tau_guess = 0.12  # GEO: ~36000 km slant
        else:
            eph = sat.ephemeris
            bits = _nav_bits(sat, first_tow_count, n_subframes, subframe_pattern)
            data_vals = bits.astype(np.float64)
            data_t0_sv = bits_t0_sv
            data_dur = _BIT_DURATION_S

            def pos_at(t, _e=eph):
                return satellite_position(_e, t)

            def clk_at(t, _e=eph):
                return clock_correction(_e, t)

            tau_guess = 0.07

        # Light-time solution on the grid: tau = |sat(t - tau) - rx(t)| / c
        # (the signal arrives at the receiver's position at RECEPTION time).
        rx_g = rx[None, :] + v_rx[None, :] * (grid - gps_start_time_sow)[:, None]
        tau_g = np.full(grid.shape, tau_guess)
        for _ in range(3):
            sat_pos = pos_at(grid - tau_g)
            tau_g = np.linalg.norm(sat_pos - rx_g, axis=-1) / C
        dtsv_g = clk_at(grid - tau_g)
        # Unmodeled clock error (SBAS fast-correction fault injection): the
        # SV's clock runs ahead of its broadcast model, shifting the CODE
        # timeline (t_sv below) without touching the broadcast-derived
        # corrections the receiver applies.
        if getattr(sat, "unmodeled_clock_error_m", 0.0):
            dtsv_g = dtsv_g + sat.unmodeled_clock_error_m / C

        # Ionospheric group delay (dispersive): the CODE arrives late by
        # T_iono while the CARRIER phase advances by the same amount — the
        # physical signature a dual-observable receiver could even exploit.
        # Evaluated with the same Klobuchar model the solver applies
        # (solve/iono.py), so an e2e test can verify the correction removes
        # exactly the injected delay.
        if iono is not None:
            from gypsum_tpu_torch.solve.geodesy import ecef_to_lla, elevation_azimuth
            from gypsum_tpu_torch.solve.iono import klobuchar_delay_s

            lat_u, lon_u, _ = ecef_to_lla(rx)
            iono_g = iono_scale * np.array([
                klobuchar_delay_s(
                    iono, lat_u, lon_u,
                    *elevation_azimuth(rx_g[i], sat_pos[i]), float(grid[i]),
                )
                for i in range(len(grid))
            ])
        else:
            iono_g = np.zeros_like(tau_g)
        # Troposphere is non-dispersive: code and carrier delayed equally
        # (solve/tropo.py — the same model the solver removes).
        if tropo:
            from gypsum_tpu_torch.solve.geodesy import ecef_to_lla, elevation_azimuth
            from gypsum_tpu_torch.solve.tropo import tropo_delay_s

            alt_u = ecef_to_lla(rx)[2]
            tropo_g = np.array([
                tropo_delay_s(elevation_azimuth(rx_g[i], sat_pos[i])[0], alt_u)
                for i in range(len(grid))
            ])
        else:
            tropo_g = np.zeros_like(tau_g)
        tau_code_g = tau_g + iono_g + tropo_g
        tau_phase_g = tau_g - iono_g + tropo_g

        # Ground truth at the first sample.
        tau0 = float(np.interp(gps_start_time_sow, grid, tau_g))
        d_step = min(0.1, duration_s / 2.0)
        dtau_dt = float((np.interp(gps_start_time_sow + d_step, grid, tau_g) - tau0) / d_step)
        truth_transit[sat.prn] = tau0
        # Measured baseband Doppler in *stream* time: d/dr of the carrier
        # phase f_off r - f_car tau(t(r)) plus the sampler-rate term (the
        # receiver's fast/slow clock shows up as a common frequency offset).
        # For GPS f_off = 0 and f_car = f_L1; for GLONASS the FDMA offset
        # rides on top and the truth value is the full BASEBAND frequency.
        truth_doppler[sat.prn] = f_off - f_car * (
            dtau_dt * (1.0 - receiver_clock_drift) + receiver_clock_drift
        )
        t_sv0 = (
            gps_start_time_sow + sv_time_shift - tau0
            + float(np.interp(gps_start_time_sow, grid, dtsv_g))
        )
        spp = sample_rate / 1000.0
        truth_code_phase[sat.prn] = float((-t_sv0 * sample_rate) % spp)

        # Propagation rays: the direct path plus (optionally) one multipath
        # reflection with excess delay / attenuation / phase shift.
        rays = [(0.0, 1.0, 0.0)]
        if impairments is not None and impairments.multipath_delay_s is not None:
            rays.append((
                impairments.multipath_delay_s,
                impairments.multipath_amplitude,
                impairments.multipath_phase_rad,
            ))

        for lo in range(0, n_samples, chunk):
          for delay_extra, amp_factor, phase_extra in rays:
            hi = min(lo + chunk, n_samples)
            r = np.arange(lo, hi, dtype=np.float64) / sample_rate  # stream s
            blocked = getattr(sat, "blocked_s", ())
            faded = getattr(sat, "faded_s", ())
            if (
                sat.visible_from_s is not None
                or sat.visible_until_s is not None
                or blocked
                or faded
            ):
                vis = np.ones(hi - lo)
                if sat.visible_from_s is not None:
                    vis *= r >= sat.visible_from_s
                if sat.visible_until_s is not None:
                    vis *= r < sat.visible_until_s
                for b0, b1 in blocked:
                    vis *= ~((r >= b0) & (r < b1))
                for f0, f1, scale in faded:
                    vis = np.where((r >= f0) & (r < f1), vis * scale, vis)
                if not vis.any():
                    continue
            else:
                vis = 1.0
            # receiver_clock_drift d = fractional OSCILLATOR frequency error
            # (fast = positive). A fast oscillator clocks the ADC fast, so
            # stream sample r lands at true time r(1 - d)/fs (first order) —
            # and the SAME oscillator scales the LO to f_L1(1 + d), the
            # -f_L1 d r baseband term below. (Before round 2's time-transfer
            # work these two carried OPPOSITE signs — a sampler slow but LO
            # fast "oscillator" no single crystal can produce — which made
            # carrier-predicted code motion disagree with actual code motion
            # by 2d and silently tripped the Hatch innovation gate on
            # drifting-clock scenarios.)
            t = gps_start_time_sow + r * (1.0 - receiver_clock_drift)
            tau = np.interp(t, grid, tau_code_g) + delay_extra
            tau_ph = np.interp(t, grid, tau_phase_g) + delay_extra
            dtsv = np.interp(t, grid, dtsv_g)
            t_sv = t + sv_time_shift - tau + dtsv

            # Integrate-and-dump chip sampling: each output sample averages
            # the +/-1 chip waveform over its sample period, so a chip
            # boundary falling mid-period contributes proportionally. This is
            # what preserves *sub-sample* code timing in the capture (naive
            # floor-sampling quantizes the delay to whole samples and no
            # receiver could measure better than +/-0.5 sample from it).
            chip_pos0 = t_sv * chip_rate
            step = chip_rate / sample_rate
            chip_pos1 = chip_pos0 + step
            i0 = np.floor(chip_pos0).astype(np.int64)
            i1 = np.floor(chip_pos1).astype(np.int64)
            c0 = code[i0 % chip_count]
            c1 = code[i1 % chip_count]
            w = np.clip((chip_pos1 - i1) / step, 0.0, 1.0)
            chips = np.where(i1 > i0, c0 * (1.0 - w) + c1 * w, c0)
            sym_idx = np.floor((t_sv - data_t0_sv) / data_dur).astype(np.int64)
            data = data_vals[np.clip(sym_idx, 0, len(data_vals) - 1)]

            # Baseband phase: keep only the fractional cycle count in f64.
            # The fast oscillator also scales the downconversion LO to
            # f_center (1+d), leaving a common -f_car d baseband offset on
            # every satellite (consistent with the fast sampler above); a
            # GLONASS satellite additionally rides its FDMA offset f_off.
            cycles = f_off * r - f_car * (tau_ph + receiver_clock_drift * r)
            phase = (
                2.0 * np.pi * (cycles - np.round(cycles))
                + phase_extra
                + getattr(sat, "extra_carrier_phase_rad", 0.0)
            )
            out[lo:hi] += (
                sat.amplitude * amp_factor * vis * chips * data * np.exp(1j * phase)
            ).astype(np.complex64)

    if noise_sigma > 0.0:
        for lo in range(0, n_samples, chunk):
            hi = min(lo + chunk, n_samples)
            n = hi - lo
            noise = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) / np.sqrt(2.0)
            out[lo:hi] += (noise_sigma * noise).astype(np.complex64)

    if impairments is not None:
        # Receiver-chain order: LO phase noise -> front-end filter -> ADC
        # (multipath was applied geometrically per satellite above).
        out = apply_rf_impairments(out, sample_rate, impairments, seed=seed)

    truth = ConstellationTruth(
        receiver_ecef=rx,
        gps_start_time_sow=gps_start_time_sow,
        doppler_hz=truth_doppler,
        code_phase_samples=truth_code_phase,
        transit_time_s=truth_transit,
        receiver_velocity_ecef=None if receiver_velocity_ecef is None else v_rx,
    )
    return out, truth

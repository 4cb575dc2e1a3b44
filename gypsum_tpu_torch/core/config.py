"""Receiver configuration as an immutable dataclass tree.

The reference keeps tunables as module-level globals (reference:
gypsum/config.py:4-50); here they are a frozen dataclass tree so that a
receiver instance is fully parameterized by one value, configs can be
overridden per-run (CLI / tests), and device-side code can treat fields as
static jit constants.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class AcquisitionConfig:
    """One-shot batched acquisition over [sat x Doppler x code phase].

    Replaces the reference's data-dependent coarse-to-fine halving loop
    (reference: gypsum/acquisition.py:77-108) with static grid stages that
    compile to a single device program.
    """

    # Milliseconds of antenna data integrated per attempt
    # (reference: gypsum/config.py:4).
    integration_period_ms: int = 10
    # Detection threshold: peak / mean-of-rest of the non-coherent profile
    # (reference: gypsum/config.py:7).
    detection_threshold: float = 3.0
    # Seconds of signal time between acquisition scans
    # (reference: gypsum/config.py:9).
    scan_period_s: float = 10.0
    # Coarse stage: non-coherent search over +/- doppler_max at coarse_step.
    doppler_max_hz: float = 7000.0
    coarse_step_hz: float = 500.0
    # Fine stage: coherent search around the coarse peak.
    fine_span_hz: float = 400.0
    fine_step_hz: float = 25.0
    # Final refinement: estimate residual Doppler from the phase slope of the
    # per-ms coherent prompts (squared to cancel BPSK flips).
    phase_slope_refinement: bool = True
    # Coarse-sweep correlator: "fft" is the classic FFT -> pointwise -> IFFT
    # path, and what None selects. "matmul" evaluates the circular
    # correlation as bf16 products against +/-1 circulant replica tables
    # (268 MB for 32 PRNs, built on the device once per engine; float32
    # results on the card's tensor cores).
    correlator: str | None = None
    # Use the fused max/argmax/sum kernel (ops/peak_reduce.py) for the
    # coarse-grid peak search instead of argmax + gather + sum. Identical
    # results; None/False keeps the plain path, and the kernel is available
    # and parity-tested (PERF.md has both times on the card).
    use_pallas_peak_reduce: bool | None = None
    # Almanac-aided warm start (solve/almanac.py): once a fix and orbit data
    # (decoded ephemeris or relayed almanac pages) exist, skip scanning SVs
    # predicted below this elevation. The margin below 0 deg absorbs
    # almanac-grade orbit error and receiver drift since the last fix.
    # None disables the mask (every eligible SV is always scanned — the
    # reference's behavior, gypsum/receiver.py:148-174).
    horizon_mask_deg: float | None = -5.0


@dataclass(frozen=True)
class DeepAcquisitionConfig:
    """High-sensitivity acquisition (acquire/deep.py): grouped coherent
    integration x non-coherent accumulation over hundreds of milliseconds,
    with per-Doppler code-drift compensation. Digs out satellites ~7-10 dB
    below the 10 ms engine's floor — at levels where the 1 kHz tracking loop
    cannot hold lock, the code phases still feed snapshot coarse-time fixes
    (solve/snapshot.py). No reference analogue (its acquisition is fixed at
    10 ms non-coherent, gypsum/config.py:4)."""

    # Coherent integration per group (ms). 10 keeps one nav-bit edge per
    # group at worst (~1 dB average straddle loss); the Doppler step is
    # matched to the group main lobe: 1000 / (2 * coherent_ms) Hz.
    coherent_ms: int = 10
    # Total integration (ms); must be a multiple of coherent_ms.
    total_ms: int = 200
    # Doppler search window (Hz around doppler_center_hz).
    doppler_center_hz: float = 0.0
    doppler_span_hz: float = 7000.0
    doppler_step_hz: float | None = None  # None -> 1000 / (2 * coherent_ms)
    # Doppler bins evaluated per device dispatch (bounds the [S, C, L]
    # working set; the host loops over chunks).
    doppler_chunk: int = 8
    # Align each group's profile for the code drift its Doppler implies
    # (f_d / 1540 chips/s smears ~4 samples over 400 ms at 7 kHz).
    compensate_code_doppler: bool = True
    # Normalized peak threshold (peak / mean-of-rest of the accumulated
    # profile). Non-coherent averaging over G groups SHRINKS the noise
    # max/mean ratio ~ 1 + k/sqrt(G) (measured: noise peaks ~3.2 at G=10,
    # ~2.0 at G=40 over the full grid), so a fixed value cannot serve every
    # total_ms. None (default) = 1 + detection_k / sqrt(G).
    detection_threshold: float | None = None
    detection_k: float = 10.0
    # Residual-Doppler refinement from the squared group-to-group phase
    # slope (unambiguous +/- 1/(4 * coherent_ms) — exactly the bin half-width).
    phase_slope_refinement: bool = True


@dataclass(frozen=True)
class TrackingConfig:
    """Scan-based Costas PLL + early/prompt/late DLL (device side).

    Deliberate departures from the reference, documented here because they
    change the numerics (behavior is validated by simulation tests instead of
    bit-compare):

    - *Normalized* discriminators: Costas error I*Q/(I^2+Q^2) and early-late
      power (E^2-L^2)/(E^2+L^2), making loop gains independent of signal
      amplitude. The reference's raw I*Q / (E^2-L^2)/2 discriminators
      (gypsum/tracker.py:249,297) implicitly assume its recordings' sample
      levels.
    - Incremental NCO phase (mod 2*pi per ms) instead of absolute stream time,
      so float32 device math stays exact over arbitrarily long streams.
    - Carrier-aided code tracking: the code phase is advanced by the Doppler-
      implied code rate each ms, leaving the DLL only the residual.
    - A single normalized lock/quality metric EMA[(I^2-Q^2)/(I^2+Q^2)]
      replaces the reference's I-pole-variance + covariance-eigenvalue
      circularity heuristics (gypsum/tracker.py:178-197, utils.py:134-144):
      it approaches 1 for a locked BPSK constellation and 0 for an unlocked /
      circular one.
    """

    # Milliseconds of signal processed per device dispatch. The tracker's
    # sequential loop-filter state is carried through a loop of this length.
    block_size_ms: int = 1000
    # Overlap the host->device sample upload of block k+1 with block k's
    # device compute and block k-1's host processing, via a one-block
    # read-ahead copied from pinned memory on a side stream
    # (runtime/receiver.py). Off by default; the CPU gains nothing.
    async_upload: bool = False
    # Costas loop bandwidths (Hz): wide for pull-in, narrow once locked
    # (reference: gypsum/tracker.py:251-256).
    pll_bandwidth_locked_hz: float = 3.0
    pll_bandwidth_pullin_hz: float = 6.0
    pll_damping_factor: float = 0.7071067811865476  # 1/sqrt(2)
    # DLL gain: code phase (samples) += gain * normalized early-late disc.
    dll_gain_samples: float = 0.05
    # Advance the code phase by -doppler/f_carrier * samples_per_prn each ms.
    carrier_aiding: bool = True
    # Carrier frequency the aiding ratio is computed against. None = GPS L1
    # (1575.42 MHz); a GLONASS L1OF bank sets 1602 MHz (per-channel FDMA
    # differences of +/-0.25% are far below the DLL's authority).
    aiding_carrier_hz: float | None = None
    # Half-width (in samples) of the correlation lag window evaluated around
    # the prompt each millisecond. Replaces the reference's full-length FFT
    # correlation per ms (reference: gypsum/tracker.py:307-313) with a small
    # batched matmul over 2*K+1 lags.
    lag_window_half_width: int = 4
    # Sub-sample code-phase MEASUREMENT estimator (feeds pseudoranges; the
    # DLL loop is unaffected — it only centers the lag window):
    #   "triangle" — vertex interpolation of the |corr| peak from lags
    #       (-1, 0, +1). Lowest noise; multipath pulls the vertex (a 0.5-amp
    #       ray biases it ~0.33 samples worst-case over the ray phase).
    #   "hrc"      — high-resolution (double-delta) correlator zero-crossing
    #       from lags (-2..+2): eps = -W (d1 - d2/2) / r0 with
    #       d1 = |R(-1)|-|R(+1)|, d2 = |R(-2)|-|R(+2)|, W = samples/chip.
    #       Multipath-resistant at >= 4 samples/chip (measured worst-case
    #       bias vs "triangle" at 8 samples/chip, 0.5-amp ray: 0.12 vs 0.33
    #       samples at 0.25-chip delay, 0.06 vs 0.33 at 0.5, 0.02 vs 0.25 at
    #       1.0) at ~2x the thermal noise; at 2 samples/chip the +/-2 lags
    #       sit at the correlation feet and the estimator DEGRADES — keep
    #       "triangle" there. reference: no counterpart (gypsum tracks the
    #       raw FFT argmax, gypsum/tracker.py:307-313).
    code_phase_measurement: str = "triangle"
    # Spreading-code length in chips per 1 ms code period (GPS/SBAS C/A:
    # 1023; GLONASS L1OF: 511 — the band receiver overrides it the same way
    # it overrides aiding_carrier_hz). Only used to convert lag samples to
    # chips where an estimator's formula needs the correlation triangle's
    # half-width (code_phase_measurement="hrc").
    chips_per_code: int = 1023
    # Lock-state heuristics: EMA analogues of the reference's 250 ms sliding
    # windows (reference: gypsum/tracker.py:157-203, gypsum/config.py:25-27),
    # with thresholds in normalized-discriminator units.
    lock_window_ms: int = 250
    max_phase_error_variance_for_lock: float = 0.02
    quality_window_ms: int = 1000
    min_quality_for_lock: float = 0.5
    # Health watchdog (reference: gypsum/tracker.py:370-388): after warmup,
    # quality below the drop threshold flags the channel lost.
    watchdog_warmup_ms: int = 6000
    quality_drop_threshold: float = 0.2
    # Rescue tier (reference: gypsum/tracker.py:380-387): a channel whose
    # quality sits between the drop threshold and this value at a block
    # boundary is rescued in place instead of riding down to a drop +
    # reacquisition. The reference blindly nudges Doppler +/-5 Hz in the
    # constellation-rotation direction; here the host measures the residual
    # Doppler directly from the phase slope of the squared prompts (exact
    # magnitude AND sign up to +/-250 Hz) and applies it, then resets the
    # lock EMAs so the watchdog re-warms (the reference's 6 s cadence).
    rescue_enabled: bool = True
    rescue_quality_threshold: float = 0.45
    rescue_period_s: float = 6.0
    rescue_max_correction_hz: float = 100.0
    # Vector coast (deep-integration tier above rescue; host logic in
    # runtime/receiver.py): when the watchdog declares a channel lost but
    # the world model has its orbit and a recent fix, the channel is driven
    # OPEN-LOOP — each block boundary its code phase / Doppler are set from
    # the predicted geometry's delta since the last healthy block (constant
    # position/clock errors cancel; residual TCXO drift costs ~0.02
    # samples/s) — instead of dropped. Decode restarts on recovery, but the
    # loops are already aligned when the signal returns, so ranging resumes
    # within one block instead of a drop + 10 s-cadence reacquisition +
    # resync. The SV is excluded from fixes while coasting.
    # reference: no counterpart (gypsum drops and reacquires,
    # gypsum/receiver.py:248-267).
    coast_enabled: bool = True
    # Give up and drop after this much open-loop time (prediction error
    # grows with oscillator drift and fix staleness).
    coast_max_s: float = 10.0
    # Block-end quality EMA (reset each boundary, so it measures the last
    # block alone) above which the signal is declared returned.
    coast_recovery_quality: float = 0.45
    # Deep-integration measurement on coasting channels (track/deepmeas.py):
    # each block, re-correlate the raw IQ in a narrow (lag x Doppler) window
    # around the coast prediction with grouped coherent x non-coherent
    # integration (the acquire/deep.py structure, ~7-10 dB below the loops'
    # threshold). A detection re-anchors the coast prediction (bounding
    # open-loop drift) and keeps GENUINE pseudoranges flowing to the fix
    # (solve/world.py admits deep-measured coasting SVs when fewer than four
    # healthy channels remain) — positions continue through a deep fade that
    # blinds every scalar loop. A successful measurement also refreshes the
    # coast_max_s deadline: the signal is demonstrably present, just weak.
    # reference: no counterpart (below the loops gypsum goes dark).
    coast_deep_measurement: bool = True
    coast_meas_coherent_ms: int = 10  # per-group coherent length (data-bit safe)
    coast_meas_min_groups: int = 20  # skip blocks too short to integrate
    coast_meas_doppler_bins: int = 5  # odd; grid centered on the prediction
    coast_meas_doppler_step_hz: float = 25.0  # phase-slope refine covers +/-12.5
    coast_meas_lag_halfwidth: int = 6  # code window (samples) around prediction
    coast_meas_noise_lags: int = 8  # far lags (at +L/2) estimating the floor
    # Detection gate: normalized peak >= 1 + k / sqrt(groups). Noise-only
    # maxima over the small window sit near 1 + 1.5/sqrt(G); k = 5 leaves
    # ~3x margin (false-measurement rate pinned by tests/test_deepcoast.py).
    coast_meas_threshold_k: float = 5.0
    # Cross-correlation veto: the noise gate above is blind to C/A code
    # CROSS-correlation sidelobes (worst case 65/1023 ~ -24 dB) of satellites
    # that are still tracked strongly — a dead PRN's narrow window "detects"
    # a live SV whose Doppler sits within the 10 ms coherent bandwidth of a
    # 1 kHz code line (the C/A spectrum repeats every 1/1ms). A detection is
    # vetoed when BOTH (a) its measured absolute Doppler is within tol of a
    # live channel's Doppler modulo 1 kHz and (b) its absolute peak does not
    # exceed xcorr_margin x that channel's worst-case sidelobe level, so a
    # genuinely strong faded signal still passes. Feeding a sidelobe-born
    # pseudorange to the fix is the one deadly failure mode of this tier
    # (it tripped an EKF-coast regression in round 3's snapshot).
    coast_meas_xcorr_tol_hz: float = 60.0  # 10 ms coherent main lobe ±50 Hz
    coast_meas_xcorr_margin: float = 2.0
    # A single-block detection only becomes a MEASUREMENT (re-anchor, fix
    # admission, deadline refresh) after this many consecutive blocks agree
    # in Doppler to coast_meas_confirm_tol_hz — intermittent sidelobe or
    # noise artifacts do not repeat coherently block over block.
    coast_meas_confirm_blocks: int = 2
    coast_meas_confirm_tol_hz: float = 10.0
    # The JAX package's lax.scan unroll factor for the per-ms loop; the port's
    # scan tracker is a Python loop and does not read it.
    scan_unroll: int = 1
    # Use the fused wipeoff+lag-correlate kernel (ops/wipeoff_lag.py) inside
    # the scan tracker's step instead of the plain trig+einsum correlator.
    # None/False = the plain correlator; True forces the kernel (one launch
    # per ms), overrides hoist_lag_window, and is ignored for a farm.
    use_pallas_correlator: bool | None = None
    # Hoist the per-channel lag-window extraction out of the scan tracker's
    # loop: position a wider static window once per block (code phase drifts
    # <= ~10 samples/s under carrier aiding), evaluate all its lags each ms,
    # and select the E/P/L lags around the current prompt with a cheap
    # gather. Values are identical while the prompt stays within the margin
    # (the host re-centers the window every block).
    hoist_lag_window: bool = True
    # Half-width headroom (samples) added to the block window for in-block
    # code-phase drift. None = auto: Doppler-aiding drift at +/-7 kHz over
    # the block plus 8 samples of DLL slack.
    lag_window_block_margin: int | None = None
    # Run the WHOLE block loop inside one kernel (ops/track_block.py): each
    # channel's replica window stays in shared memory across all B
    # milliseconds. With use_matmul_tracker=False, None = the kernel on a
    # CUDA device and the scan tracker on the CPU. Triangle measurement only,
    # no FDMA carrier offset, no farm. Superseded by the matmul tracker below
    # when that is enabled.
    use_pallas_block_tracker: bool | None = None
    # Two-phase tracker (track/matmul.py): evaluate the whole block's lag
    # correlations as ONE bf16 matmul against a phasor-folded replica matrix,
    # then run the sequential loop-filter updates as a small kernel
    # (ops/fixup.py). Removes the per-ms wipeoff/correlate work entirely.
    # None = on everywhere unless use_pallas_block_tracker=True explicitly
    # selects the block kernel.
    use_matmul_tracker: bool | None = None
    # bf16 matmul inputs for the phase-1 contraction (f32 accumulation).
    # f32 keeps parity tests exact; bf16 feeds the card's tensor cores
    # (replica rows are +/-1, exact in bf16; sample quantization is ~0.4%,
    # far below the noise floor).
    matmul_tracker_bf16: bool = True
    # The JAX package's lax.scan unroll for its phase-2 fixup scan; the port
    # does not read it.
    fixup_unroll: int = 8
    # Phase-2 backend: None or "pallas" = the fixup kernel (ops/fixup.py) on
    # a CUDA device and its plain version on the CPU; "scan" = the plain
    # loop-filter chain on either device, only when set explicitly.
    fixup_backend: str | None = None
    # The JAX package's grouping of loop-filter updates per grid step of its
    # TPU fixup kernel; the port's kernel loops inside one launch and does
    # not read it.
    fixup_group_ms: int = 25
    # Pipeline the host/device boundary: keep the loop-filter carry
    # device-resident across blocks and dispatch block k+1 before the host
    # consumes block k's outputs (depth-1 software pipeline). The receiver
    # then processes observations one block late; device compute and
    # host-side nav decode overlap instead of serializing (the sample
    # upload too, with async_upload). None = on for the card, off on the
    # CPU (CPU tests keep the synchronous order).
    pipeline_tracking: bool | None = None


@dataclass(frozen=True)
class NavConfig:
    """Host-side navigation-bit / subframe decode."""

    # Bit-phase resync triggers (reference: gypsum/config.py:40-45,
    # gypsum/navigation_bit_intergrator.py:210-239).
    resync_bit_phase_period_s: float = 1.0
    resync_bit_health_memory_bits: int = 10
    resync_bit_health_threshold_pct: float = 50.0
    # Pseudosymbols examined when choosing a bit phase (last <=16 bits,
    # reference: gypsum/navigation_bit_intergrator.py:134).
    bit_phase_history_bits: int = 16
    bit_phase_min_history_bits: int = 4
    # A bit whose |sum of 20 pseudosymbols| / 20 <= this is UNKNOWN
    # (reference: gypsum/navigation_bit_intergrator.py:156-158).
    unknown_bit_confidence_pct: float = 50.0
    # Consecutive UNKNOWN bits before the bit phase resets
    # (reference: gypsum/navigation_bit_intergrator.py:164-171).
    max_sequential_unknown_bits: int = 30
    # Stop resyncing bit phase after this much receiver time. The reference
    # ships this as a 40 s stabilization band-aid
    # (gypsum/navigation_bit_intergrator.py:281-282) because late resyncs
    # corrupted its established subframe sync. This framework fixed the two
    # root causes (bit-window offset and sticky tie-break, nav/bits.py:
    # 83-99), and a 28-seed randomized campaign passes with the cutoff
    # disabled (tools/campaign.py --no-resync-cutoff, 2026-08-17: 28/28),
    # so the default is now off. Set to e.g. 40.0 to restore the
    # reference's behavior.
    bit_phase_resync_cutoff_s: float = float("inf")
    # Give up on subframe phase after this many subframes' worth of bits
    # (reference: gypsum/navigation_message_decoder.py:155).
    max_subframes_of_bits_without_phase: int = 12
    # If True, a failed word-parity check rejects the subframe. The reference
    # only logs failures (reference: gypsum/navigation_message_parser.py:384-391),
    # so False preserves its behavior.
    strict_parity: bool = False


@dataclass(frozen=True)
class SolverConfig:
    """Position/time solver (host side)."""

    # Week-number disambiguation base (reference: gypsum/config.py:16).
    gps_epoch_base_week_number: int = 2048
    utc_leap_seconds: int = 27
    # GPS-UTC leap count for the GLONASS time-scale mapping (GLONASS time =
    # UTC + 3 h; GPS = UTC + leap). Distinct from the reference-parity
    # ``utc_leap_seconds`` display knob above: this one enters the
    # GLONASS string-edge time anchoring (solve/world.py).
    leap_seconds: int = 18
    # Iteration counts (reference: gypsum/world_model.py:404,540,606,684).
    kepler_iterations: int = 10
    newton_iterations: int = 20
    outer_rounds: int = 5
    clock_correction_iterations: int = 10
    # A satellite's time base is stale for a fix after this many PRN ticks
    # without a handover word (reference: gypsum/world_model.py:582-587).
    max_prn_ticks_since_handover: int = 6000
    # Deep-measured coasting satellites (TrackingConfig.coast_deep_measurement)
    # get a longer tick-age allowance: the tick counter is an exact integer
    # ms count and the deep measurement re-pins the sub-ms delay against the
    # live signal every block, so the usual staleness risk (unmodeled clock
    # drift walking the predicted TOW) is bounded by the measurement cadence,
    # not the time since the last subframe.
    deep_ranging_max_ticks: int = 60000
    # Carrier-smoothed pseudoranges (Hatch filter): the noisy sub-sample
    # code-phase measurement is blended with the carrier-Doppler-propagated
    # previous value over this many observations (0 disables). Code noise
    # shrinks ~ sqrt(N) while the carrier delta is mm-level per second; the
    # reference uses raw whole-millisecond pseudoranges with no smoothing.
    carrier_smoothing_window: int = 20
    # Per-ms code-phase measurements projected onto the block end (along
    # the code-Doppler drift) and median-combined into the block's
    # pseudorange reading; 1 reproduces the single-final-millisecond
    # behavior.
    pseudorange_projection_ms: int = 250
    # Apply the broadcast Klobuchar ionospheric correction (solve/iono.py)
    # once subframe 4 page 18 has been decoded. The reference never decodes
    # the page, so False reproduces its (uncorrected) behavior.
    apply_iono_correction: bool = True
    # Dual-frequency measured iono (GLONASS L1OF+L2OF): when a satellite's
    # L2 channel is tracked (band="glonass_l2"), the wrapped L2-L1 code
    # delay difference measures the dispersive delay DIRECTLY —
    # I_L1 = (d_L2 - d_L1) * f2^2/(f1^2 - f2^2) — replacing the Klobuchar
    # model for that satellite (a GLONASS-only receiver has no Klobuchar
    # broadcast at all, so this is its ONLY iono correction). The
    # measurement needs no position estimate, so unlike the model it also
    # corrects the very first fix rounds.
    dual_frequency_iono: bool = True
    # An L2 channel outage invalidates the measured correction after this
    # many seconds without an update (falls back to the model, if any).
    l2_iono_max_age_s: float = 5.0
    # Averaging cap (blocks) for the L2-L1 iono difference: the difference
    # is geometry-free and iono moves at cm/s, so it averages far beyond
    # the range-tracking Hatch window — 600 blocks (~10 min at 1 s blocks)
    # spans the timescale over which slant iono actually changes.
    l2_iono_smoothing_window: int = 600
    # Cross-constellation iono: when NO broadcast Klobuchar is available
    # (page 18 recurs only every 12.5 min — a cold GPS receiver waits that
    # long for the model), map the GLONASS dual-frequency measurements into
    # a thin-shell vertical delay estimate and correct every other row by
    # its own obliquity and carrier (iono_vertical_gps_l1_m). A decoded
    # model takes precedence: it is a per-pierce-point fit where the mapped
    # estimate assumes one vertical delay for the whole local sky.
    cross_constellation_iono: bool = True
    # Apply SBAS fast corrections (MT1 mask + MT2-5 PRCs decoded from a
    # tracked GEO, solve/sbas_corrections.py) to GPS pseudoranges, and fold
    # the UDREI variance into the integrity weighting. The reference has no
    # SBAS capability at all.
    apply_sbas_corrections: bool = True
    # Fast corrections older than this are discarded (DO-229's en-route
    # degradation tier; there is no RRC modeling here).
    sbas_fast_timeout_s: float = 30.0
    # Geometry-seeded time bases: a (re)acquired satellite with a known
    # orbit and a recent position fix gets its millisecond tick anchor from
    # the predicted transit (good to microseconds — far inside the 0.5 ms
    # integer rounding margin) instead of waiting ~6 s for its next
    # subframe. The reference must always re-decode
    # (gypsum/world_model.py:314-328 invalidates, :716-718 re-anchors).
    geometry_reseed: bool = True
    geometry_reseed_max_fix_age_s: float = 30.0
    # Assisted/bootstrap fix: when fewer than 4 satellites have decoded time
    # bases but >= 4 tracked channels have KNOWN orbits (assist ephemerides
    # via `replay --assist-nav`, a checkpoint, or early cross-SV decode) and
    # the clock slide is set (first HOW), solve the integer-millisecond
    # snapshot problem (solve/snapshot.py) — seeded by a Doppler-only
    # position solve when no prior fix exists — and geometry-seed every
    # channel from the result. Cuts time-to-first-fix from ~20-30 s (decode
    # subframes 1-3 on four SVs) to just past the first handover word.
    assisted_bootstrap: bool = True
    # Velocity from time-differenced carrier phase (TDCP): the NCO's cycle
    # count over each block integrates the Doppler with millicycle noise —
    # mm/s-class velocity vs ~0.1 m/s from the instantaneous-Doppler solve,
    # which remains the fallback for channels without a continuous locked
    # block (solve/velocity.py:solve_tdcp).
    tdcp_velocity: bool = True
    # Reject bootstrap solutions whose ms-resolved residual RMS exceeds this
    # (a wrong integer is ~300 km of residual; genuine fixes sit at meters).
    assisted_bootstrap_max_residual_m: float = 75.0
    # Apply the Saastamoinen tropospheric model (solve/tropo.py) once a
    # position estimate exists. Needs no broadcast data; False reproduces
    # the reference's (uncorrected) behavior.
    apply_tropo_correction: bool = True
    # 4-SV integer-ms ambiguity tie-break: when several lattice hypotheses
    # are altitude-plausible, commit the unique one within this distance of
    # the last fix (lattice points sit ~300 km apart, so any position
    # history separates them decisively; measured rates in
    # tools/lattice_study.py).
    ambiguity_tiebreak_radius_m: float = 50_000.0
    # Navigation EKF (solve/ekf.py): shadows the least-squares fix on full
    # epochs and bridges < 4-satellite outages with whatever pseudorange /
    # Doppler measurements remain (the reference goes dark there,
    # gypsum/world_model.py:567-589). Coast solutions stop publishing once
    # the filter's position sigma exceeds the gate; the filter snaps back
    # to the least-squares fix if it ever wanders past the reinit distance.
    ekf_enabled: bool = True
    ekf_reinit_distance_m: float = 100.0
    ekf_coast_max_sigma_m: float = 50.0
    # Protection levels (solve/integrity.py, DO-229 App. J covariance
    # formulation): assumed 1-sigma pseudorange error for GPS channels
    # (SBAS GEOs use their broadcast MT9 URA). Deliberately conservative —
    # clean-scene residuals run ~0.3-0.5 m; a real multipath-afflicted
    # urban capture does not.
    pseudorange_sigma_m: float = 2.5


@dataclass(frozen=True)
class ObservabilityConfig:
    dashboard_url: str = "http://127.0.0.1:8080/"
    dashboard_scan_period_s: float = 3.0
    dashboard_update_period_s: float = 1.0
    render_tracker_figures: bool = False


@dataclass(frozen=True)
class SpoofingConfig:
    """Spoofing monitors (solve/spoofing.py). All detection-only: alerts are
    logged and counted, never acted on automatically (a false alarm turned
    into an automatic re-acquire would itself be a denial of service)."""

    enabled: bool = True
    # Vestigial-peak scan: how often to correlate tracked PRNs against a
    # snapshot with the tracked peak excluded, the exclusion radius, and the
    # second-peak strength that raises an alert (same peak/mean-rest
    # statistic as acquisition; its detection threshold is 3.0).
    scan_period_s: float = 4.0
    exclude_chips: float = 2.0
    vestigial_threshold: float = 3.5
    # ... AND it must stand comparison with the tracked peak itself: the
    # authentic signal's own Gold-code sidelobes reach 65/1023 (~0.065) of
    # its peak, while a spoofer must be comparable to capture the loops.
    vestigial_min_ratio: float = 0.2
    # C/N0 step detector: dB over the channel's EMA, sustained for this many
    # blocks (the EMA freezes while hot so a captured channel cannot teach
    # the baseline its new power).
    cn0_jump_db: float = 6.0
    cn0_jump_blocks: int = 2
    cn0_ema_alpha: float = 0.05
    # Clock-slide innovation gate: absolute floor (s) on top of 6 sigma of
    # the robust-fit residuals over the history window.
    clock_innovation_s: float = 3e-7
    clock_history: int = 40
    # Position-jump gate: fixed allowance + per-second motion allowance.
    position_jump_m: float = 50.0
    position_jump_speed_mps: float = 75.0


@dataclass(frozen=True)
class ReceiverConfig:
    """Top-level receiver configuration."""

    acquisition: AcquisitionConfig = field(default_factory=AcquisitionConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    nav: NavConfig = field(default_factory=NavConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)
    obs: ObservabilityConfig = field(default_factory=ObservabilityConfig)
    spoofing: SpoofingConfig = field(default_factory=SpoofingConfig)
    # Maximum number of simultaneously tracked satellite channels. Static so
    # device buffers have fixed shapes; inactive channels are masked.
    max_channels: int = 12

    def replace(self, **kwargs) -> "ReceiverConfig":
        return dataclasses.replace(self, **kwargs)


DEFAULT_CONFIG = ReceiverConfig()

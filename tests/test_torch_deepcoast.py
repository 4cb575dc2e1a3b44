"""The port's deep coast measurement (gypsum_tpu_torch/track/deepmeas.py) and
the coast tier of its default Receiver against the JAX package.

Unit level, the measurer against gypsum_tpu.track.deepmeas.DeepCoastMeasurer
on the same seeded blocks: the detection decision equal; strength,
``peak_abs`` and ``floor_abs`` within 1e-4 relative; ``cp_error_samples``
within 2e-3 samples; Doppler within 0.01 Hz (float32 wipeoff and complex64
products summed in another order; the host tail is the same numpy).

Receiver level, the 38 s deep-fade scene of tests/test_deepcoast.py (PRNs
25/28/31/32/3 faded to 0.03 from 23 to 33 s, clock drift 2e-8, noise 0.35)
runs once through each default Receiver (``coast_deep_measurement=True``;
phase 1 in float32 on both sides) and is held to the parity ladder: equal
acquisitions; equal ``deep_measured_prns``, ``dropped_prns`` and
``coast_recovered_prns`` per block; equal fix epochs and satellite sets;
positions within 1 m of the JAX fix outside the fade and, inside it, the JAX
test's bars (at least 4 lsq fixes in [28, 33] s, each within 50 m of truth,
median within 25 m). Measured on this scene (36 measurer calls): the two
receivers' fixes differ by at most 0.0024 m outside the fade and by up to
0.41 m inside it, on deep-measured pseudoranges (the ``cp_error_samples``
tolerance above, 2e-3 samples, is 0.29 m of range).
"""

from types import SimpleNamespace

import numpy as np
import pytest

import chip_smoke
from gypsum_tpu.core.config import ReceiverConfig as JaxReceiverConfig
from gypsum_tpu.core.config import TrackingConfig as JaxTrackingConfig
from gypsum_tpu.core.constants import GPS_L1_FREQUENCY_HZ
from gypsum_tpu.io.sources import ArraySampleSource as JaxArraySource
from gypsum_tpu.runtime.receiver import Receiver as JaxReceiver
from gypsum_tpu.signal.constellation import synthesize_constellation
from gypsum_tpu.signal.prn import ALL_PRN_IDS
from gypsum_tpu.signal.scenarios import DEMO_GPS_START_SOW, demo_constellation
from gypsum_tpu.solve.geodesy import lla_to_ecef
from gypsum_tpu.track.deepmeas import DeepCoastMeasurer as JaxMeasurer
from gypsum_tpu.track.deepmeas import xcorr_suspect as jax_xcorr_suspect
from gypsum_tpu_torch.core.config import ReceiverConfig, TrackingConfig
from gypsum_tpu_torch.io.sources import ArraySampleSource
from gypsum_tpu_torch.runtime.receiver import Receiver
from gypsum_tpu_torch.track.deepmeas import CA_XCORR_PEAK, DeepCoastMeasurer, xcorr_suspect

FS = 2.046e6
L = 2046
RX = lla_to_ecef(51.5, -0.1, 80.0)
FADE = (23.0, 33.0)
FADE_SCALE = 0.03


def _measurers():
    return (DeepCoastMeasurer(FS, L, ALL_PRN_IDS, TrackingConfig(), device="cpu"),
            JaxMeasurer(FS, L, ALL_PRN_IDS, JaxTrackingConfig()))


def _hold(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    assert a.detected == b.detected and a.groups == b.groups
    assert a.strength == pytest.approx(b.strength, rel=1e-4)
    assert a.peak_abs == pytest.approx(b.peak_abs, rel=1e-4)
    assert a.floor_abs == pytest.approx(b.floor_abs, rel=1e-4)
    assert abs(a.cp_error_samples - b.cp_error_samples) < 2e-3
    assert abs(a.doppler_hz - b.doppler_hz) < 0.01


@pytest.fixture(scope="module")
def weak_block():
    """PRN 25 at -17 dB against the nominal scene amplitude, 1.2 s."""
    sats = demo_constellation([25], amplitude=0.03)
    return synthesize_constellation(sats, RX, DEMO_GPS_START_SOW, 1.2, FS, noise_sigma=0.35,
                                    seed=3)


def test_measurer_matches_jax_below_loop_threshold(weak_block):
    """A deliberately wrong prediction (2.6 samples, 11 Hz off) is measured
    back as the JAX measurer measures it, to ~0.1 sample and ~1 Hz of truth."""
    iq, truth = weak_block
    port, ref = _measurers()
    f_true, cp_true = truth.doppler_hz[25], truth.code_phase_samples[25]
    drift = -(f_true + 11.0) * FS / GPS_L1_FREQUENCY_HZ
    args = (iq[: 1000 * L], 25, (cp_true + 2.6) % L, drift, f_true + 11.0)
    a = port.measure(*args)
    _hold(a, ref.measure(*args))
    assert a.detected and abs(a.cp_error_samples + 2.6) < 0.15
    assert abs(a.doppler_hz - f_true) < 2.0
    # A block already on the device (a tensor) measures the same.
    import torch

    _hold(port.measure(torch.from_numpy(iq[: 1000 * L]), *args[1:]), a)


def test_measurer_matches_jax_on_noise():
    """Noise only: no detection on either side, the same strengths."""
    rng = np.random.default_rng(7)
    n = 600 * L
    iq = ((rng.standard_normal(n) + 1j * rng.standard_normal(n)) / np.sqrt(2.0) * 0.35
          ).astype(np.complex64)
    port, ref = _measurers()
    for prn, cp, f in [(25, 100.0, -1500.0), (28, 900.3, 2200.0)]:
        args = (iq, prn, cp, -f * FS / GPS_L1_FREQUENCY_HZ * 0.6, f)
        a = port.measure(*args)
        _hold(a, ref.measure(*args))
        assert not a.detected


def test_static_offset_is_wiped_in_float64(weak_block):
    """A channel at a GLONASS k = 7 sub-band offset (3.9375 MHz) measures as
    a baseband one does, and as the JAX measurer's host float64 wipe does."""
    iq, truth = weak_block
    off = 3_937_500.0
    n = 1000 * L
    t = np.arange(n, dtype=np.float64) / FS
    shifted = (iq[:n] * np.exp(2j * np.pi * off * t)).astype(np.complex64)
    port, ref = _measurers()
    f_true, cp_true = truth.doppler_hz[25], truth.code_phase_samples[25]
    args = (shifted, 25, cp_true % L, -f_true * FS / GPS_L1_FREQUENCY_HZ, f_true)
    a = port.measure(*args, static_offset_hz=off)
    _hold(a, ref.measure(*args, static_offset_hz=off))
    assert a.detected and abs(a.cp_error_samples) < 0.15 and abs(a.doppler_hz - f_true) < 2.0


def test_short_block_returns_none():
    port, _ = _measurers()
    assert port.measure(np.zeros(50 * L, np.complex64), 25, 0.0, 0.0, 0.0) is None
    assert port.calls == 0
    with pytest.raises(ValueError, match="odd"):
        DeepCoastMeasurer(FS, L, ALL_PRN_IDS, TrackingConfig(coast_meas_doppler_bins=4),
                          device="cpu")


def test_xcorr_suspect_matches_jax():
    live = [(1000.0 - 12.0, 450.0)]
    bound = 450.0 * 10 * 100 * CA_XCORR_PEAK
    cases = [
        (-12.0, bound, live, True),  # folded onto a code line, sidelobe level
        (-12.0, 3.0 * bound, live, False),  # far stronger than a sidelobe
        (400.0, bound, live, False),  # off every code line
        (-12.0, bound, [], False),  # nothing live to veto against
    ]
    for f, peak, channels, expect in cases:
        assert xcorr_suspect(f, peak, 100, 10, channels, 60.0, 2.0) is expect
        assert jax_xcorr_suspect(f, peak, 100, 10, channels, 60.0, 2.0) is expect


def test_crosscorr_artefact_is_measured_and_vetoed_as_in_jax():
    """A strong live PRN 25 and an absent target PRN: scanning dead PRNs x
    code lines x code phases as tests/test_deepcoast.py does, the port's
    first raw detection is a sidelobe artefact that the JAX measurer also
    detects, with the same numbers, and that the veto catches."""
    sats = demo_constellation([25], amplitude=0.22)
    iq, truth = synthesize_constellation(sats, RX, DEMO_GPS_START_SOW, 1.2, FS,
                                         noise_sigma=0.35, seed=11)
    port, ref = _measurers()
    f_live = truth.doppler_hz[25]
    block = iq[: 1000 * L]
    hit = None
    for prn in (1, 7, 13, 21, 29):
        for line in (-2000.0, -1000.0, 0.0, 1000.0, 2000.0):
            f_pred = f_live + line
            for cp in (150.0, 700.0, 1300.0, 1900.0):
                args = (block, prn, cp, -f_pred * FS / GPS_L1_FREQUENCY_HZ, f_pred)
                res = port.measure(*args)
                if res.detected:
                    hit = (args, res)
                    break
            if hit:
                break
        if hit:
            break
    assert hit is not None, "expected at least one sidelobe false detection"
    args, res = hit
    _hold(res, ref.measure(*args))
    assert xcorr_suspect(res.doppler_hz, res.peak_abs, res.groups, 10,
                         [(f_live, 0.22 * L)], 60.0, 2.0)


# ------------------------------------------------------------ the receiver


def _tracking(cls):
    return cls(watchdog_warmup_ms=1500, quality_drop_threshold=0.25, coast_max_s=6.0,
               coast_deep_measurement=True, matmul_tracker_bf16=False)


@pytest.fixture(scope="module")
def fade_runs():
    """The deep-fade scene, synthesized once, through both receivers once,
    and through the JAX receiver pipelined once."""
    sats = demo_constellation([25, 28, 31, 32, 3])
    for s in sats:
        s.faded_s = [(FADE[0], FADE[1], FADE_SCALE)]
    iq, _ = synthesize_constellation(sats, RX, DEMO_GPS_START_SOW, 38.0, FS, noise_sigma=0.35,
                                     receiver_clock_drift=2e-8)
    ref = JaxReceiver(JaxArraySource(iq, FS),
                      JaxReceiverConfig(tracking=_tracking(JaxTrackingConfig)))
    ref.run()
    cfg = ReceiverConfig(tracking=_tracking(TrackingConfig))
    assert cfg.tracking.coast_deep_measurement  # the default tier, made explicit
    port = Receiver(ArraySampleSource(iq, FS), cfg, device="cpu")
    port.run()  # runs to the end of the capture without raising
    # The JAX receiver pipelined (chip_smoke.py's pipelined fade replay).
    piped = JaxReceiver(JaxArraySource(iq, FS), JaxReceiverConfig(
        tracking=JaxTrackingConfig(watchdog_warmup_ms=1500, quality_drop_threshold=0.25,
                                   coast_max_s=6.0, pipeline_tracking=True)))
    piped.run()
    return ref, port, iq[: 1000 * L], chip_smoke.fade_fix_errors(piped)


def test_fade_acquisitions_match(fade_runs):
    ref, port, _, _ = fade_runs

    def acq(recv):
        return [(r.block_start, h.prn, h.code_phase_samples)
                for r in recv.block_reports for h in r.newly_acquired]

    assert acq(port) == acq(ref)
    assert {p for _, p, _ in acq(port)} >= {25, 28, 31, 32, 3}


def test_fade_coast_events_match_per_block(fade_runs):
    ref, port, _, _ = fade_runs

    def events(recv):
        return [(r.block_start, sorted(r.deep_measured_prns), sorted(r.dropped_prns),
                 sorted(r.coast_recovered_prns), sorted(r.coasting_prns))
                for r in recv.block_reports]

    assert events(port) == events(ref)
    measured = {p for r in port.block_reports for p in r.deep_measured_prns}
    assert measured == {25, 28, 31, 32, 3}
    assert not [p for r in port.block_reports for p in r.dropped_prns]
    assert port._coast_measurer is not None and port._coast_measurer.calls > 0


def test_fade_fixes_match(fade_runs):
    ref, port, _, _ = fade_runs
    fa = [r.fix for r in ref.block_reports if r.fix is not None]
    fb = [r.fix for r in port.block_reports if r.fix is not None]
    assert len(fa) == len(fb) and fb
    for sa, sb in zip(fa, fb):
        assert sa.receiver_timestamp == sb.receiver_timestamp
        assert sa.kind == sb.kind
        assert sorted(sa.satellites_used) == sorted(sb.satellites_used)
        if not FADE[0] <= sb.receiver_timestamp <= FADE[1] + 3.0:
            assert np.linalg.norm(sa.ecef - sb.ecef) < 1.0, sb.receiver_timestamp


def test_fade_keeps_fixing_within_the_jax_bars(fade_runs):
    _, port, _, _ = fade_runs
    in_fade, checked, misses = chip_smoke.fade_fix_errors(port)
    errs = list(in_fade.values())
    assert len(errs) >= 4 and max(errs) < 50.0 and float(np.median(errs)) < 25.0, in_fade
    recovered = [(r.block_start, p) for r in port.block_reports for p in r.coast_recovered_prns]
    assert recovered and all(FADE[1] <= t <= FADE[1] + 3.0 for t, _ in recovered), recovered
    post = [f for f in port.world.position_fixes
            if f.receiver_timestamp >= FADE[1] + 3.0 and f.kind == "lsq"]
    assert post and max(float(np.linalg.norm(f.ecef - RX)) for f in post) < 5.0
    assert checked >= 10 and misses == 0


def test_pipelined_fade_reference_of_chip_smoke(fade_runs):
    """The JAX receiver with pipeline_tracking=True (the TPU's default, and
    the card's for the port) on the fade scene: the in-fade fixes and the
    protection levels that miss them, which chip_smoke.py holds the port's
    pipelined replay on the card to. A fault of the reference (ROADMAP.md
    §C): pipelined, the in-fade fixes are 83-192 m off and 6 of the 17
    protection levels do not bound them; unpipelined, within the bars."""
    in_fade, checked, misses = fade_runs[3]
    assert set(in_fade) == set(chip_smoke.FADE_PIPELINED_REFERENCE)
    for t, err in chip_smoke.FADE_PIPELINED_REFERENCE.items():
        assert abs(in_fade[t] - err) < 0.01, (t, in_fade[t], err)
    assert (checked, misses) == (17, chip_smoke.FADE_PIPELINED_PL_MISSES)


def test_coast_uploads_a_retained_block_once():
    """Every coasting channel of one block is measured from one device copy
    of the retained block (runtime/coast.py)."""
    recv = Receiver(ArraySampleSource(np.zeros(2046 * 20, np.complex64), FS), device="cpu")
    raw = np.zeros((1000, 2046), np.complex64)
    recv._coast_raw[0] = raw
    recv._coast_prediction = lambda prn, pipe, t: (1e-4, 100.0)
    pipe = SimpleNamespace(carrier_offset_hz=0.0)
    for prn in (25, 28):
        assert recv._deep_coast_measurement(SimpleNamespace(prn=prn), pipe, 0.0, 1000) is None
    first = recv._coast_raw_dev
    assert first is not None and first[0] == 0
    recv._deep_coast_measurement(SimpleNamespace(prn=31), pipe, 0.0, 1000)
    assert recv._coast_raw_dev is first and recv._coast_measurer.calls == 3


def test_fade_snapshot_reference_of_chip_smoke(fade_runs):
    """chip_smoke.py's snapshot phase, its reference: what the JAX CLI's
    ``acquire --deep --snapshot`` (gypsum_tpu/cli/acquire.py:9-141, the
    default 200 ms search) computes on the fade capture with the orbits of
    the JAX receiver at the end of the fade replay and chip_smoke.py's
    priors, ~40 km and 4 s off. The search runs over the 5 PRNs that have
    orbits (a PRN's result does not depend on the others searched, and only
    those 5 enter the fix). With 5 orbits the solve is exactly determined
    (residual 0) and the fix lands 536 m from truth, outside
    tests/test_snapshot.py's 400 m bar (held there on 8 satellites);
    chip_smoke.py holds the port's CLI on the card to this fix. (The
    port's CLI against the JAX CLI on the CPU:
    tests/test_torch_checkpoint.py::test_cli_deep_snapshot_matches_the_jax_cli.)"""
    from gypsum_tpu.acquire.deep import DeepAcquisitionEngine as JaxDeepEngine
    from gypsum_tpu.solve.geodesy import ecef_to_lla
    from gypsum_tpu.solve.snapshot import (
        SnapshotMeasurement,
        orbit_fn_from_records,
        snapshot_fix,
    )

    ref, _, head, _ = fade_runs
    sats = {p: rec for p, rec in ref.world._sats.items() if rec.has_orbit}
    assert sorted(sats) == sorted(chip_smoke.FADE_PRNS)
    eng = JaxDeepEngine(FS, L, prns=tuple(chip_smoke.FADE_PRNS))
    hits = [h for h in eng.acquire_all(head[: 200 * L]) if h.strength > eng.detection_threshold]
    assert sorted(h.prn for h in hits) == sorted(chip_smoke.FADE_PRNS)
    meas = [SnapshotMeasurement(prn=h.prn, code_phase_fraction_s=h.code_phase_samples / FS,
                                doppler_hz=h.doppler_hz) for h in hits]
    sol = snapshot_fix(meas, orbit_fn_from_records(sats), DEMO_GPS_START_SOW + chip_smoke.SNAPSHOT_DT_S,
                       RX + np.array(chip_smoke.SNAPSHOT_OFFSET_M))
    lat, lon, alt = ecef_to_lla(sol.ecef)
    # The CLI prints 6 decimals of a degree and whole metres.
    assert (round(lat, 6), round(lon, 6), round(alt)) == chip_smoke.SNAPSHOT_REFERENCE
    assert sol.residual_rms_m < 0.05
    assert 400.0 < float(np.linalg.norm(sol.ecef - RX)) < 600.0

"""The coast tier of the port's default Receiver against the JAX package,
on the 38 s deep-fade scene of tests/test_deepcoast.py (PRNs 25/28/31/32/3
faded to 0.03 from 23 to 33 s, clock drift 2e-8, noise 0.35).

The scene runs once through each default Receiver
(``coast_deep_measurement=True``; phase 1 in float32 on both sides) and is
held to the parity ladder: equal acquisitions; equal ``deep_measured_prns``,
``dropped_prns`` and ``coast_recovered_prns`` per block; equal fix epochs and
satellite sets; positions within 1 m of the JAX fix outside the fade and,
inside it, the JAX test's bars (at least 4 lsq fixes in [28, 33] s, each
within 50 m of truth, median within 25 m). Measured on this scene (36
measurer calls): the two receivers' fixes differ by at most 0.0024 m outside
the fade and by up to 0.41 m inside it, on deep-measured pseudoranges (the
measurer's ``cp_error_samples`` tolerance in tests/test_torch_deepcoast_units.py,
2e-3 samples, is 0.29 m of range). The JAX receiver pipelined on the same
scene, and its snapshot fix on the same capture, are the references of
chip_smoke.py's pipelined fade replay and snapshot phase.

The three receivers share one 38 s synthesis (about 80 s of the file's
time), so they stay in one file. The measurer's unit tests and the stubbed
host edits of a pipelined receiver are in tests/test_torch_deepcoast_units.py.
"""

from tests._torch_cpu import concurrently  # isort: skip (first: caps torch's threads)

import numpy as np
import pytest

import chip_smoke
from gypsum_tpu.core.config import ReceiverConfig as JaxReceiverConfig
from gypsum_tpu.core.config import TrackingConfig as JaxTrackingConfig
from gypsum_tpu.io.sources import ArraySampleSource as JaxArraySource
from gypsum_tpu.runtime.receiver import Receiver as JaxReceiver
from gypsum_tpu.signal.constellation import synthesize_constellation
from gypsum_tpu.signal.scenarios import DEMO_GPS_START_SOW, demo_constellation
from gypsum_tpu.solve.geodesy import lla_to_ecef
from gypsum_tpu_torch.core.config import ReceiverConfig, TrackingConfig
from gypsum_tpu_torch.io.sources import ArraySampleSource
from gypsum_tpu_torch.runtime.receiver import Receiver

FS = 2.046e6
L = 2046
RX = lla_to_ecef(51.5, -0.1, 80.0)
FADE = (23.0, 33.0)
FADE_SCALE = 0.03


def _tracking(cls):
    return cls(watchdog_warmup_ms=1500, quality_drop_threshold=0.25, coast_max_s=6.0,
               coast_deep_measurement=True, matmul_tracker_bf16=False)


@pytest.fixture(scope="module")
def fade_runs():
    """The deep-fade scene, synthesized once, through both receivers once,
    and through the JAX receiver pipelined once. The port replays on this
    thread while the two JAX receivers run on two others."""
    sats = demo_constellation([25, 28, 31, 32, 3])
    for s in sats:
        s.faded_s = [(FADE[0], FADE[1], FADE_SCALE)]
    iq, _ = synthesize_constellation(sats, RX, DEMO_GPS_START_SOW, 38.0, FS, noise_sigma=0.35,
                                     receiver_clock_drift=2e-8)
    cfg = ReceiverConfig(tracking=_tracking(TrackingConfig))
    assert cfg.tracking.coast_deep_measurement  # the default tier, made explicit
    port = Receiver(ArraySampleSource(iq, FS), cfg, device="cpu")
    ref = JaxReceiver(JaxArraySource(iq, FS),
                      JaxReceiverConfig(tracking=_tracking(JaxTrackingConfig)))
    # The JAX receiver pipelined (chip_smoke.py's pipelined fade replay).
    piped = JaxReceiver(JaxArraySource(iq, FS), JaxReceiverConfig(
        tracking=JaxTrackingConfig(watchdog_warmup_ms=1500, quality_drop_threshold=0.25,
                                   coast_max_s=6.0, pipeline_tracking=True)))
    concurrently(port.run, ref.run, piped.run)  # the port runs to the end without raising
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

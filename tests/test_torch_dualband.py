"""DualBandReceiver in the port against the JAX package: the GPS + GLONASS
scene of tests/test_glonass_receiver.py:51-83 (4 GPS + 3 GLONASS
satellites, 24 s, an injected GPS-GLONASS time offset of 800 ns) through
both packages' dual-band receivers into one world model each.

Held to the parity ladder of tests/test_multichip_receiver.py, band by
band: equal acquisitions, > 99.9 % pseudosymbol sign agreement per channel,
equal subframe and GLONASS string streams, equal fix epochs and satellite
sets, positions within 1 m; and the inter-system bias within 10 ns of the
JAX package's (its float32 pseudorange inputs differ in the last bits;
the bias is a 5-unknown least-squares output), besides the JAX test's own
bars (the last fix within 5 m on 4 + 3 satellites, the bias within 250 ns
of the injected -800 ns). Both run phase 1 in float32.
"""

from tests._torch_cpu import concurrently  # isort: skip (first: caps torch's threads)

import dataclasses

import numpy as np
import pytest

from gypsum_tpu.core.config import ReceiverConfig as JaxReceiverConfig
from gypsum_tpu.io.sources import ArraySampleSource as JaxArraySource
from gypsum_tpu.runtime.receiver import DualBandReceiver as JaxDualBandReceiver
from gypsum_tpu.signal.constellation import synthesize_constellation
from gypsum_tpu.signal.scenarios import (
    demo_constellation,
    demo_glonass_constellation,
    demo_receiver_ecef,
)
from gypsum_tpu_torch.core.config import ReceiverConfig
from gypsum_tpu_torch.io.sources import ArraySampleSource
from gypsum_tpu_torch.runtime.dualband import DualBandReceiver as PortDualBandFromModule
from gypsum_tpu_torch.runtime.receiver import DualBandReceiver

GPS_FS, GLO_FS = 2.046e6, 4.092e6
START_SOW = 21618.0  # a GLONASS frame boundary at t = 0
GLO_OFFSET_S = 8e-7
RX = demo_receiver_ecef()
GPS_PRNS = [25, 28, 31, 32]
GLO_PRNS = [206, 208, 210]  # k = -2, 0, 2


def _f32(config_cls):
    cfg = config_cls()
    return cfg.replace(tracking=dataclasses.replace(cfg.tracking, matmul_tracker_bf16=False))


@pytest.fixture(scope="module")
def both_receivers():
    """The two bands synthesized at once, then the port's receiver on this
    thread while the JAX receiver runs on another."""
    (gps_iq, _), (glo_iq, _) = concurrently(
        lambda: synthesize_constellation(
            demo_constellation(GPS_PRNS), RX, START_SOW, 24.0, GPS_FS, noise_sigma=0.3),
        lambda: synthesize_constellation(
            demo_glonass_constellation([-2, 0, 2]), RX, START_SOW, 24.0, GLO_FS,
            noise_sigma=0.25, glonass_time_offset_s=GLO_OFFSET_S))
    ref = JaxDualBandReceiver(JaxArraySource(gps_iq, GPS_FS), JaxArraySource(glo_iq, GLO_FS),
                              _f32(JaxReceiverConfig))
    port = DualBandReceiver(ArraySampleSource(gps_iq, GPS_FS), ArraySampleSource(glo_iq, GLO_FS),
                            _f32(ReceiverConfig), device="cpu")
    concurrently(port.run, ref.run)
    return ref, port


def test_dual_band_receiver_is_reexported_and_threads_the_device(both_receivers):
    _, port = both_receivers
    assert DualBandReceiver is PortDualBandFromModule
    assert port.glonass_l2 is None
    assert [band.band for band in port._bands] == ["glonass", "gps"]
    assert all(band.device.type == "cpu" for band in port._bands)
    assert port.world is port.gps.world is port.glonass.world


@pytest.mark.parametrize("band", ["gps", "glonass"])
def test_acquisition_parity(both_receivers, band):
    ref, port = both_receivers

    def acquisitions(recv):
        return [(h.prn, h.code_phase_samples)
                for r in getattr(recv, band).block_reports for h in r.newly_acquired]

    assert acquisitions(port) == acquisitions(ref)
    assert {p for p, _ in acquisitions(port)} >= set(GPS_PRNS if band == "gps" else GLO_PRNS)


@pytest.mark.parametrize("band", ["gps", "glonass"])
def test_pseudosymbol_stream_parity(both_receivers, band):
    ref, port = both_receivers

    def signs(recv):
        out: dict[int, list[np.ndarray]] = {}
        for report in getattr(recv, band).block_reports:
            for obs in report.observations:
                out.setdefault(obs.prn, []).append(np.asarray(obs.pseudosymbol_signs))
        return {p: np.concatenate(v) for p, v in out.items()}

    a, b = signs(ref), signs(port)
    assert set(a) == set(b)
    for prn in GPS_PRNS if band == "gps" else GLO_PRNS:
        assert a[prn].shape == b[prn].shape
        agree = float(np.mean(a[prn] == b[prn]))
        assert agree > 0.999, f"{band} {prn}: sign agreement {agree:.4%}"


def test_navigation_stream_parity(both_receivers):
    ref, port = both_receivers

    def subframes(recv):
        return [(prn, ev.decoded.handover.tow_count, ev.decoded.handover.subframe_id.value)
                for r in recv.gps.block_reports for prn, ev in r.subframes]

    def strings(recv):
        return [(prn, ev.string.m, ev.string.fields)
                for r in recv.glonass.block_reports for prn, ev in r.glonass_strings]

    assert subframes(port) == subframes(ref) and len(subframes(port)) >= 3 * len(GPS_PRNS)
    assert strings(port) == strings(ref) and len(strings(port)) >= 4 * len(GLO_PRNS)


def test_fix_parity(both_receivers):
    ref, port = both_receivers
    fa, fb = ref.world.position_fixes, port.world.position_fixes
    assert fa and len(fa) == len(fb)
    for sa, sb in zip(fa, fb):
        assert sa.receiver_timestamp == sb.receiver_timestamp
        assert sorted(sa.satellites_used) == sorted(sb.satellites_used)
        assert np.linalg.norm(sa.ecef - sb.ecef) < 1.0


def test_inter_system_bias_parity_and_the_jax_bars(both_receivers):
    ref, port = both_receivers
    fa, fb = ref.world.position_fixes, port.world.position_fixes
    isb_a = [f.inter_system_bias_s for f in fa]
    isb_b = [f.inter_system_bias_s for f in fb]
    assert [v is None for v in isb_b] == [v is None for v in isb_a]
    solved = [(a, b) for a, b in zip(isb_a, isb_b) if b is not None]
    assert solved, "no dual-constellation solve ran"
    for a, b in solved:
        assert abs(b - a) < 10e-9
    # tests/test_glonass_receiver.py's own bars.
    last = fb[-1]
    assert np.linalg.norm(last.ecef - RX) < 5.0
    assert len([p for p in last.satellites_used if p <= 32]) == 4
    assert len([p for p in last.satellites_used if p >= 201]) == 3
    assert abs(solved[-1][1] + GLO_OFFSET_S) < 250e-9
    assert np.std([b for _, b in solved][-3:]) < 20e-9
    reports = port.gps.block_reports + port.glonass.block_reports
    assert not any(r.spoofing_alerts for r in reports)

"""The GLONASS L1OF slice in the port against the JAX package: the
GLONASS-only scene of tests/test_glonass_receiver.py:26-48 (k = -2..2, 13 s)
through both receivers (``band="glonass"``, phase 1 in float32 on both
sides), held to the parity ladder of tests/test_multichip_receiver.py with
GLONASS strings in place of subframes, and the port's CLI to a fix on the
same capture. The units, FDMA acquisition and tracking at FDMA offsets are
in tests/test_torch_glonass.py, the L2OF band in
tests/test_torch_glonass_l2.py.
"""

from tests._torch_cpu import concurrently, subprocess_env  # isort: skip (first: caps torch's threads)

import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from gypsum_tpu.core.config import ReceiverConfig as JaxReceiverConfig
from gypsum_tpu.io.sources import ArraySampleSource as JaxArraySource
from gypsum_tpu.runtime.receiver import Receiver as JaxReceiver
from gypsum_tpu.signal import constellation as jcon
from gypsum_tpu.signal import scenarios as jscn
from gypsum_tpu_torch.core.config import ReceiverConfig
from gypsum_tpu_torch.io.sources import ArraySampleSource
from gypsum_tpu_torch.runtime.receiver import Receiver

ROOT = Path(__file__).resolve().parent.parent
FS = 4.092e6
START_SOW = 21618.0  # a GLONASS frame boundary at t = 0 (tests/test_glonass_receiver.py)
GLO_OFFSET_S = 8e-7
KS = [-2, -1, 0, 1, 2]
PRNS = [208 + k for k in KS]
RX = jscn.demo_receiver_ecef()


def _f32(config_cls, **tracking):
    """A ReceiverConfig of either package with phase 1 in float32."""
    cfg = config_cls()
    return cfg.replace(tracking=dataclasses.replace(
        cfg.tracking, matmul_tracker_bf16=False, **tracking))


@pytest.fixture(scope="module")
def scene():
    """The GLONASS-only scene of tests/test_glonass_receiver.py:26-48."""
    iq, _ = jcon.synthesize_constellation(
        jscn.demo_glonass_constellation(KS), RX, START_SOW, 13.0, FS, noise_sigma=0.25,
        glonass_time_offset_s=GLO_OFFSET_S)
    return iq


@pytest.fixture(scope="module")
def both_receivers(scene):
    ref = JaxReceiver(JaxArraySource(scene, FS), _f32(JaxReceiverConfig), band="glonass")
    port = Receiver(ArraySampleSource(scene, FS), _f32(ReceiverConfig), band="glonass",
                    device="cpu")
    concurrently(port.run, ref.run)  # the JAX receiver on a second thread
    return ref, port


def _signs_by_prn(recvs):
    out: dict[int, list[np.ndarray]] = {}
    for recv in recvs:
        for report in recv.block_reports:
            for obs in report.observations:
                out.setdefault(obs.prn, []).append(np.asarray(obs.pseudosymbol_signs))
    return {p: np.concatenate(v) for p, v in out.items()}


def _strings(recvs):
    return [(prn, ev.string.m, ev.string.fields, ev.trailing_edge_receiver_timestamp)
            for recv in recvs for report in recv.block_reports
            for prn, ev in report.glonass_strings]


def _acquisitions(recv):
    return [(h.prn, h.code_phase_samples) for r in recv.block_reports for h in r.newly_acquired]


def test_acquisition_parity(both_receivers):
    ref, port = both_receivers
    assert _acquisitions(port) == _acquisitions(ref)
    assert {p for p, _ in _acquisitions(port)} == set(PRNS)
    for a, b in zip(port.block_reports[0].newly_acquired, ref.block_reports[0].newly_acquired):
        assert abs(a.doppler_hz - b.doppler_hz) < 0.5


def test_pseudosymbol_stream_parity(both_receivers):
    ref, port = both_receivers
    a, b = _signs_by_prn([ref]), _signs_by_prn([port])
    assert set(a) == set(b)
    for prn in PRNS:
        assert a[prn].shape == b[prn].shape
        agree = float(np.mean(a[prn] == b[prn]))
        assert agree > 0.999, f"k={prn - 208}: sign agreement {agree:.4%}"


def test_string_stream_parity(both_receivers):
    ref, port = both_receivers
    a, b = _strings([ref]), _strings([port])
    assert len(b) >= 4 * len(PRNS)
    assert [x[:3] for x in b] == [x[:3] for x in a]
    # The edges are code-phase-corrected receiver times: 10 ns is 0.04 of
    # a sample, well above the float32 code phases' difference.
    np.testing.assert_allclose([x[3] for x in b], [x[3] for x in a], rtol=0, atol=1e-8)


def test_fix_parity_and_the_jax_bars(both_receivers):
    ref, port = both_receivers
    fa, fb = ref.world.position_fixes, port.world.position_fixes
    assert fa and len(fa) == len(fb)
    for sa, sb in zip(fa, fb):
        assert sa.receiver_timestamp == sb.receiver_timestamp
        assert sorted(sa.satellites_used) == sorted(sb.satellites_used)
        assert np.linalg.norm(sa.ecef - sb.ecef) < 1.0
    # tests/test_glonass_receiver.py's own bars.
    assert fb[0].receiver_timestamp <= 11.0
    for fix in fb:
        assert np.linalg.norm(fix.ecef - RX) < 15.0
        assert len(fix.satellites_used) >= 4
        assert all(201 <= p <= 214 for p in fix.satellites_used)
    assert np.linalg.norm(fb[-1].ecef - RX) < 5.0
    assert np.linalg.norm(fb[-1].velocity_ecef_mps) < 0.5


def test_glonass_band_rejects_what_jax_rejects():
    iq = np.zeros(int(FS * 0.01), dtype=np.complex64)
    with pytest.raises(ValueError, match="201"):
        Receiver(ArraySampleSource(iq, FS), eligible_prns=[25], band="glonass", device="cpu")
    with pytest.raises(ValueError, match="band"):
        Receiver(ArraySampleSource(iq, FS), band="galileo", device="cpu")


def test_cli_glonass_replay_prints_a_fix(scene, tmp_path):
    capture = tmp_path / "glonass.npy"
    np.save(capture, scene)
    proc = subprocess.run(
        [sys.executable, "-m", "gypsum_tpu_torch", "--device", "cpu", "replay",
         "--glonass-file", str(capture), "--until-fix"],
        cwd=ROOT, env=subprocess_env(), capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    fixes = re.findall(r"FIX lat=(-?[\d.]+) lon=(-?[\d.]+) alt=(-?\d+)m", proc.stdout)
    assert fixes, proc.stdout[-2000:]
    from gypsum_tpu_torch.solve.geodesy import lla_to_ecef

    lat, lon, alt = (float(v) for v in fixes[-1])
    assert np.linalg.norm(lla_to_ecef(lat, lon, alt) - RX) < 15.0
    assert "GLONASS k=+0 string 1" in proc.stdout

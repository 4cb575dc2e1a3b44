"""The slice as a whole: the port's Receiver(device="cpu") against the JAX
Receiver on the 4-satellite, 23 s cold-start scene of
tests/test_end_to_end.py, held to the parity ladder of
tests/test_multichip_receiver.py (equal acquisitions, > 99.9 % pseudosymbol
sign agreement, equal subframe streams, equal fix epochs and satellite sets,
positions within 1 m), and the port's CLI replay to a fix.

Each level of the ladder holds two port receivers: the single-device one
("single") and ``Receiver(mesh=...)`` on two gloo ranks, sat 2 x time 1
("mesh": tests/_torch_dist_worker.py, started first so that it runs while
this process replays; the scene reaches it as a .npy). Both ranks' reports
must be identical.

Every receiver runs phase 1 in float32 (matmul_tracker_bf16=False): the
comparison is of the algorithm, not of bf16 rounding.
"""

from tests._torch_cpu import concurrently, subprocess_env  # isort: skip (first: caps torch's threads)

import dataclasses
import pickle
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from gypsum_tpu.core.config import ReceiverConfig as JaxReceiverConfig
from gypsum_tpu.io.sources import ArraySampleSource as JaxArraySource
from gypsum_tpu.runtime.receiver import Receiver as JaxReceiver
from gypsum_tpu.signal.constellation import ConstellationSatellite, synthesize_constellation
from gypsum_tpu.solve.geodesy import lla_to_ecef
from gypsum_tpu_torch.core.config import ReceiverConfig
from gypsum_tpu_torch.io.sources import ArraySampleSource
from gypsum_tpu_torch.runtime.receiver import Receiver
from tests._torch_dist_worker import launch
from tests.ephemeris_fixtures import TEST_EPHEMERIDES

ROOT = Path(__file__).resolve().parent.parent
FS = 2.046e6
TRUTH_LLA = (51.5, -0.1, 80.0)
GPS_T0 = 21600.0
PRNS = [25, 28, 31, 32]


@pytest.fixture(scope="module")
def scene():
    rx = lla_to_ecef(*TRUTH_LLA)
    sats = [
        ConstellationSatellite(prn=p, ephemeris=TEST_EPHEMERIDES[i], amplitude=0.22)
        for i, p in enumerate(PRNS)
    ]
    iq, _ = synthesize_constellation(
        sats, rx, gps_start_time_sow=GPS_T0, duration_s=23.0,
        sample_rate=FS, noise_sigma=0.35, subframe_pattern="123",
    )
    return rx, iq


@pytest.fixture(scope="module")
def mesh_ranks(scene, tmp_path_factory):
    """The two-rank mesh replay, started: it runs while this process
    replays the scene through both single-device receivers."""
    directory = tmp_path_factory.mktemp("mesh_receiver")
    np.save(directory / "scene.npy", scene[1])
    ranks = launch("receiver", 2, directory)
    yield ranks
    ranks.close()


@pytest.fixture(scope="module")
def mesh_receiver(mesh_ranks):
    """Both ranks' results (rank 0's first)."""
    rcs, outs, timed_out = mesh_ranks.wait(timeout=300)
    assert not timed_out and rcs == [0, 0], "\n".join(o[-3000:] for o in outs)
    return mesh_ranks.results()


@pytest.fixture(scope="module")
def both_receivers(scene, mesh_ranks):
    rx, iq = scene
    jcfg = JaxReceiverConfig()
    jcfg = jcfg.replace(tracking=dataclasses.replace(jcfg.tracking, matmul_tracker_bf16=False))
    ref = JaxReceiver(JaxArraySource(iq, FS), jcfg)
    cfg = ReceiverConfig()
    cfg = cfg.replace(tracking=dataclasses.replace(cfg.tracking, matmul_tracker_bf16=False))
    port = Receiver(ArraySampleSource(iq, FS), cfg, device="cpu")
    concurrently(port.run, ref.run)  # the JAX receiver on a second thread
    return rx, ref, port


@pytest.fixture(params=["single", "mesh"])
def receivers(request, both_receivers):
    """(truth, JAX reference, port receiver): the single-device receiver or
    rank 0 of the mesh replay."""
    rx, ref, port = both_receivers
    if request.param == "mesh":
        res = request.getfixturevalue("mesh_receiver")[0]
        port = SimpleNamespace(block_reports=res["reports"],
                               world=SimpleNamespace(receiver_clock_slide=res["clock_slide"]))
    return rx, ref, port


def _signs_by_prn(recv):
    out: dict[int, list[np.ndarray]] = {}
    for report in recv.block_reports:
        for obs in report.observations:
            out.setdefault(obs.prn, []).append(np.asarray(obs.pseudosymbol_signs))
    return {p: np.concatenate(v) for p, v in out.items()}


def test_acquisition_parity(receivers):
    _, ref, port = receivers
    a = [(h.prn, h.code_phase_samples) for h in ref.block_reports[0].newly_acquired]
    b = [(h.prn, h.code_phase_samples) for h in port.block_reports[0].newly_acquired]
    assert b == a
    assert {p for p, _ in b} >= set(PRNS)


def test_pseudosymbol_stream_parity(receivers):
    _, ref, port = receivers
    a, b = _signs_by_prn(ref), _signs_by_prn(port)
    assert set(a) == set(b)
    for prn in PRNS:
        assert a[prn].shape == b[prn].shape
        agree = float(np.mean(a[prn] == b[prn]))
        assert agree > 0.999, f"PRN {prn}: sign agreement {agree:.4%}"


def test_subframe_decode_parity(receivers):
    _, ref, port = receivers

    def stream(recv):
        return [
            (prn, ev.decoded.handover.tow_count, ev.decoded.handover.subframe_id.value)
            for report in recv.block_reports
            for prn, ev in report.subframes
        ]

    a, b = stream(ref), stream(port)
    assert b == a and len(b) >= 3 * len(PRNS)


def test_fix_parity(receivers):
    rx, ref, port = receivers
    fa = [r.fix for r in ref.block_reports if r.fix is not None]
    fb = [r.fix for r in port.block_reports if r.fix is not None]
    assert fa and fb, "both replays must fix"
    assert len(fa) == len(fb)
    for sa, sb in zip(fa, fb):
        assert sa.receiver_timestamp == sb.receiver_timestamp
        assert sorted(sa.satellites_used) == sorted(sb.satellites_used)
        assert np.linalg.norm(sa.ecef - sb.ecef) < 1.0
    assert np.linalg.norm(fb[-1].ecef - rx) < 100.0
    assert port.world.receiver_clock_slide == pytest.approx(ref.world.receiver_clock_slide, abs=1e-6)


def test_mesh_ranks_report_alike(mesh_receiver):
    """Every host decision of an SPMD replay rests on identical bytes
    (gathered outputs, acquisitions broadcast from rank 0): both ranks'
    reports are the same, each rank tracked 6 of the 12 channels."""
    first, second = mesh_receiver
    assert first["mesh"] == second["mesh"] == {"sat": 2, "time": 1}
    assert first["local_channels"] == second["local_channels"] == 6
    assert len(first["reports"]) == 23
    assert pickle.dumps(first["reports"]) == pickle.dumps(second["reports"])
    assert first["clock_slide"] == second["clock_slide"]


def test_receiver_is_not_pipelined_on_cpu(both_receivers):
    _, _, port = both_receivers
    assert port.device.type == "cpu"
    assert port._pipeline_depth == 0  # depth 1 is the card's default
    assert port.bank.pending_blocks == 0


def test_cli_replay_prints_a_fix(scene, tmp_path):
    rx, iq = scene
    capture = tmp_path / "scene.npy"
    np.save(capture, iq)
    proc = subprocess.run(
        [sys.executable, "-m", "gypsum_tpu_torch", "--device", "cpu", "replay",
         "--file", str(capture), "--until-fix"],
        cwd=ROOT, env=subprocess_env(), capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    fixes = re.findall(r"FIX lat=(-?[\d.]+) lon=(-?[\d.]+) alt=(-?\d+)m", proc.stdout)
    assert fixes, proc.stdout[-2000:]
    lat, lon, alt = (float(v) for v in fixes[-1])
    assert np.linalg.norm(lla_to_ecef(lat, lon, alt) - rx) < 100.0
    assert "acquired PRN 25" in proc.stdout


def test_deep_coast_measurement_raises_where_it_is_needed():
    """The coast tier's deep measurement (track/deepmeas.py) used to raise
    here while it was unported; the name is kept, and the same set-up now
    measures: a coasting channel with retained raw IQ and a prediction
    returns None on a block of zeros (nothing clears the gate) and the
    measured (delay, Doppler) on a block that holds the signal."""
    from types import SimpleNamespace

    from gypsum_tpu_torch.signal.synth import SyntheticSatellite, synthesize_iq

    recv = Receiver(ArraySampleSource(np.zeros(2046 * 20, np.complex64), FS), device="cpu")
    assert recv.config.tracking.coast_deep_measurement
    obs, pipe = SimpleNamespace(prn=25), SimpleNamespace(carrier_offset_hz=0.0)
    assert recv._deep_coast_measurement(obs, pipe, 0.0, 1000) is None  # no raw block kept
    recv._coast_raw[0] = np.zeros((1000, 2046), np.complex64)
    recv._coast_prediction = lambda prn, pipe, t: (500 / FS, 300.0)
    assert recv._deep_coast_measurement(obs, pipe, 0.0, 1000) is None
    sat = SyntheticSatellite(prn=25, doppler_hz=300.0, delay_samples=500, amplitude=0.05)
    recv._coast_raw[1000] = synthesize_iq([sat], 1000 * 2046, FS, noise_sigma=0.35,
                                          seed=4).reshape(1000, 2046)
    delay_s, doppler = recv._deep_coast_measurement(obs, pipe, 1.0, 1000)
    assert abs(doppler - 300.0) < 2.0
    assert abs((delay_s * FS - 500.0 + 1023.0) % 2046.0 - 1023.0) < 0.5


def test_async_upload_gives_the_same_observations():
    """TrackingConfig.async_upload reads one block ahead and starts its
    upload early (on the card: pinned memory, a side stream); what the
    receiver observes must not change."""
    from gypsum_tpu_torch.core.config import TrackingConfig
    from gypsum_tpu_torch.signal.synth import SyntheticSatellite, synthesize_iq

    sat = SyntheticSatellite(prn=9, doppler_hz=800.0, delay_samples=500, amplitude=0.3)
    iq = synthesize_iq([sat], 600 * 2046, FS, noise_sigma=0.3, seed=12)

    def run(async_upload):
        cfg = ReceiverConfig(tracking=TrackingConfig(block_size_ms=200, async_upload=async_upload))
        recv = Receiver(ArraySampleSource(iq, FS), cfg, eligible_prns=[9], device="cpu")
        recv.run()
        return [(o.prn, o.prompts) for r in recv.block_reports for o in r.observations]

    a, b = run(False), run(True)
    assert len(a) == len(b) == 3
    for (pa, xa), (pb, xb) in zip(a, b):
        assert pa == pb == 9
        np.testing.assert_array_equal(xa, xb)

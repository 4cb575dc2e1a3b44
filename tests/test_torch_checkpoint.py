"""Checkpoints of the port (gypsum_tpu_torch/runtime/checkpoint.py): its own
save/load roundtrips, and checkpoints written by the JAX package loaded into
the port's Receiver without importing the JAX package.

Tolerances: a port roundtrip resumes to the uninterrupted run's
pseudosymbol stream exactly (the same code on the same samples). A JAX
checkpoint resumed by both packages is held to the receiver ladder of
tests/test_torch_receiver.py: the same tracked PRNs, pseudosymbol signs
equal, prompts within 1e-3 of their scale (float32 sums in another order),
equal fix epochs, kinds and satellite sets, positions within 1 m. The CLI's
deep snapshot is held to the JAX CLI's printed output: the same detected
PRNs and code phases, Doppler within 0.6 Hz and strength within 0.02 (the
printed digits, one unit of slack), the SNAPSHOT FIX within 1e-5 degrees
and 1 m of altitude, both within the 400 m bar of tests/test_snapshot.py.
"""

import gzip
import os
import pickle
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from gypsum_tpu.core.config import ReceiverConfig as JaxReceiverConfig
from gypsum_tpu.core.config import TrackingConfig as JaxTrackingConfig
from gypsum_tpu.io.sources import ArraySampleSource as JaxArraySource
from gypsum_tpu.runtime.checkpoint import fast_forward as jax_fast_forward
from gypsum_tpu.runtime.checkpoint import load_checkpoint as jax_load_checkpoint
from gypsum_tpu.runtime.checkpoint import save_checkpoint as jax_save_checkpoint
from gypsum_tpu.runtime.receiver import Receiver as JaxReceiver
from gypsum_tpu.signal.constellation import synthesize_constellation
from gypsum_tpu.signal.scenarios import (
    DEMO_EPHEMERIDES,
    DEMO_GPS_START_SOW,
    DEMO_PRNS_8,
    demo_constellation,
    demo_receiver_ecef,
)
from gypsum_tpu.signal.synth import SyntheticSatellite, nav_bit_schedule, synthesize_iq
from gypsum_tpu.solve.geodesy import ecef_to_lla, lla_to_ecef
from gypsum_tpu_torch.core.config import ReceiverConfig, TrackingConfig
from gypsum_tpu_torch.io.sources import ArraySampleSource
from gypsum_tpu_torch.runtime.checkpoint import (
    CHECKPOINT_VERSION,
    CheckpointFormatError,
    fast_forward,
    load_checkpoint,
    load_dual_checkpoint,
    read_blob,
    save_checkpoint,
    save_dual_checkpoint,
)
from gypsum_tpu_torch.runtime.receiver import DualBandReceiver, Receiver

ROOT = Path(__file__).resolve().parent.parent
FS = 2.046e6
L = 2046
RX = demo_receiver_ecef()
ASSIST_PRNS = list(DEMO_PRNS_8)


def _config():
    return ReceiverConfig(tracking=TrackingConfig(block_size_ms=500))


@pytest.fixture(scope="module")
def capture():
    """PRN 25 alone, 4 s (the capture of tests/test_checkpoint.py, cut from
    6 s)."""
    bits = np.array([1, -1, 1, 1, -1, -1, 1, -1, 1, 1], dtype=np.int8)
    sat = SyntheticSatellite(prn=25, doppler_hz=1100.0, delay_samples=500, amplitude=0.25,
                             nav_bits=bits)
    return synthesize_iq([sat], 4000 * L, FS, noise_sigma=0.55, seed=8), bits


def _symbols(reports):
    return np.concatenate([o.pseudosymbol_signs for r in reports for o in r.observations])


def test_roundtrip_continues_tracking_identically(capture, tmp_path):
    iq, bits = capture
    ref = Receiver(ArraySampleSource(iq, FS), _config(), device="cpu")
    ref.run()
    first = Receiver(ArraySampleSource(iq, FS), _config(), device="cpu")
    first.run(max_seconds=2.0)
    assert first.bank.tracked_prns == [25]
    ckpt = tmp_path / "recv.ckpt.gz"
    save_checkpoint(first, ckpt)

    source = ArraySampleSource(iq, FS)
    resumed = Receiver(source, _config(), device="cpu")
    at = load_checkpoint(resumed, ckpt)
    assert at == pytest.approx(2.0)
    assert resumed.bank._device_state is None  # the carry is uploaded at the next dispatch
    fast_forward(source, at)
    reports = resumed.run()
    assert all(not r.newly_acquired for r in reports)
    assert resumed.bank.tracked_prns == [25]
    tail = _symbols(resumed.block_reports)
    np.testing.assert_array_equal(tail, _symbols(ref.block_reports)[2000:])
    truth = nav_bit_schedule(bits, 4000)
    agree = np.mean(tail == truth[2000:])
    assert max(agree, 1 - agree) > 0.99


def test_checkpoint_preserves_world_model(capture, tmp_path):
    iq, _ = capture
    recv = Receiver(ArraySampleSource(iq, FS), _config(), device="cpu")
    recv.run(max_seconds=1.0)
    recv.world.receiver_clock_slide = 1234.5  # sentinel
    ckpt = tmp_path / "w.ckpt.gz"
    save_checkpoint(recv, ckpt)
    fresh = Receiver(ArraySampleSource(iq, FS), _config(), device="cpu")
    load_checkpoint(fresh, ckpt)
    assert fresh.world.receiver_clock_slide == 1234.5
    assert fresh.subframe_count == recv.subframe_count
    assert sorted(fresh.pipelines) == sorted(recv.pipelines)


def _blob_naming(module, name):
    """Protocol-2 bytes of ``{"version": 13, "x": <module.name>}``: a
    checkpoint that names a class the test process need not hold."""
    key = pickle.BINUNICODE + len(b"x").to_bytes(4, "little") + b"x"
    version = (pickle.BINUNICODE + len(b"version").to_bytes(4, "little") + b"version"
               + pickle.BININT1 + bytes([CHECKPOINT_VERSION]))
    ref = pickle.GLOBAL + f"{module}\n{name}\n".encode()
    return (pickle.PROTO + b"\x02" + pickle.EMPTY_DICT + pickle.MARK + version + key + ref
            + pickle.SETITEMS + pickle.STOP)


@pytest.mark.parametrize("named,error,match", [
    (None, ValueError, "version 999"),
    (("jax._src.array", "ArrayImpl"), CheckpointFormatError, "JAX object"),
    (("gypsum_tpu.core.compile_cache", "enable_persistent_cache"), CheckpointFormatError,
     "no module gypsum_tpu_torch.core.compile_cache"),
    (("gypsum_tpu.solve.world", "NoSuchClass"), CheckpointFormatError, "has no 'NoSuchClass'"),
], ids=["version", "jax", "module", "name"])
def test_version_and_class_guards(capture, tmp_path, named, error, match):
    path = tmp_path / "bad.ckpt.gz"
    with gzip.open(path, "wb") as f:
        if named is None:
            pickle.dump({"version": 999}, f)
        else:
            f.write(_blob_naming(*named))
    iq, _ = capture
    recv = Receiver(ArraySampleSource(iq, FS), _config(), device="cpu")
    with pytest.raises(error, match=match):
        load_checkpoint(recv, path)


def test_checkpoint_roundtrip_sbas_channel(tmp_path):
    """An SBAS channel (frame decoder state, GEO record) survives a port
    checkpoint: the resumed receiver keeps decoding CRC-verified blocks on
    the 1 s cadence, and a receiver whose family lacks the PRN refuses it."""
    from gypsum_tpu.nav.sbas import encode_mt9_data, encode_symbol_stream
    from tests.test_sbas import GEO

    rng = np.random.default_rng(12)
    msgs = [(9, encode_mt9_data(GEO)) if k % 3 == 0 else (63, rng.integers(0, 2, 212).astype(np.int8))
            for k in range(7)]
    sat = SyntheticSatellite(prn=120, doppler_hz=-20.0, delay_samples=800, amplitude=0.25,
                             nav_bits=encode_symbol_stream(msgs), symbol_periods=2)
    iq = synthesize_iq([sat], 6500 * L, FS, noise_sigma=0.4, seed=13)
    first = Receiver(ArraySampleSource(iq, FS), _config(), eligible_prns=[120], device="cpu")
    first.run(max_seconds=3.5)
    assert sum(len(r.sbas_blocks) for r in first.block_reports) >= 1
    ckpt = tmp_path / "sbas.ckpt"
    save_checkpoint(first, ckpt)
    resumed = Receiver(ArraySampleSource(iq, FS), _config(), eligible_prns=[120], device="cpu")
    fast_forward(resumed.source, load_checkpoint(resumed, ckpt))
    resumed.run()
    blocks = [b for r in resumed.block_reports for _, b in r.sbas_blocks]
    assert len(blocks) >= 2
    deltas = np.diff(sorted(b.leading_edge_timestamp for b in blocks))
    np.testing.assert_allclose(deltas, np.round(deltas), atol=2e-3)
    gps_only = Receiver(ArraySampleSource(iq, FS), _config(), device="cpu")
    with pytest.raises(ValueError, match="family"):
        load_checkpoint(gps_only, ckpt)


@pytest.fixture(scope="module")
def dual_scene():
    """GPS (4 satellites) + GLONASS (k = -2, 0, 2), 2 s each."""
    from gypsum_tpu.signal.scenarios import DEMO_GLONASS_SAMPLE_RATE, demo_glonass_constellation

    gps, _ = synthesize_constellation(demo_constellation([25, 28, 31, 32]), RX, 21618.0, 2.0, FS,
                                      noise_sigma=0.3)
    glo, _ = synthesize_constellation(demo_glonass_constellation([-2, 0, 2]), RX, 21618.0, 2.0,
                                      DEMO_GLONASS_SAMPLE_RATE, noise_sigma=0.25,
                                      glonass_time_offset_s=8e-7)
    return gps, glo, DEMO_GLONASS_SAMPLE_RATE


def _dual(dual_scene):
    gps, glo, glo_fs = dual_scene
    return DualBandReceiver(ArraySampleSource(gps, FS), ArraySampleSource(glo, glo_fs),
                            device="cpu")


@pytest.fixture(scope="module")
def dual_checkpoint(dual_scene, tmp_path_factory):
    """The dual receiver run 1 s and checkpointed (both bands, one world)."""
    first = _dual(dual_scene)
    first.run(max_seconds=1.0)
    assert first.gps.bank.tracked_prns and first.glonass.bank.tracked_prns
    path = tmp_path_factory.mktemp("dual") / "dual.ckpt.gz"
    save_dual_checkpoint(first, path)
    return path


def test_dual_band_roundtrip(dual_scene, dual_checkpoint):
    """A fresh DualBandReceiver resumes from the dual checkpoint with no
    re-acquisition and the uninterrupted run's pseudosymbols in both bands,
    its bands tied to one world."""
    ref = _dual(dual_scene)
    ref.run()
    resumed = _dual(dual_scene)
    per_band = load_dual_checkpoint(resumed, dual_checkpoint)
    assert per_band == {"gps": pytest.approx(1.0), "glonass": pytest.approx(1.0)}
    assert resumed.gps.world is resumed.world and resumed.glonass.world is resumed.world
    for name, secs in per_band.items():
        fast_forward(getattr(resumed, name).source, secs)
    resumed.run()
    for band in ("gps", "glonass"):
        got, want = getattr(resumed, band), getattr(ref, band)
        assert all(not r.newly_acquired for r in got.block_reports)
        assert got.bank.tracked_prns == want.bank.tracked_prns
        np.testing.assert_array_equal(_symbols(got.block_reports),
                                      _symbols(want.block_reports[1:]))


def test_dual_and_single_checkpoints_refuse_each_other(dual_scene, dual_checkpoint, capture,
                                                       tmp_path):
    gps, glo, glo_fs = dual_scene
    single = Receiver(ArraySampleSource(gps, FS), _config(), device="cpu")
    with pytest.raises(ValueError, match="dual-band checkpoint"):
        load_checkpoint(single, dual_checkpoint)
    glonass_only = DualBandReceiver(None, ArraySampleSource(glo, glo_fs),
                                    glonass_l2_source=ArraySampleSource(glo, glo_fs),
                                    device="cpu")
    with pytest.raises(ValueError, match="bands"):
        load_dual_checkpoint(glonass_only, dual_checkpoint)
    iq, _ = capture
    recv = Receiver(ArraySampleSource(iq, FS), _config(), device="cpu")
    recv.run(max_seconds=0.5)
    single_ckpt = tmp_path / "single.ckpt.gz"
    save_checkpoint(recv, single_ckpt)
    with pytest.raises(ValueError, match="not a dual-band checkpoint"):
        load_dual_checkpoint(_dual(dual_scene), single_ckpt)


# ------------------------------------------------ a JAX checkpoint in the port


@pytest.fixture(scope="module")
def assisted(tmp_path_factory):
    """A 4 s scene of the eight demo PRNs from the demo start time, without
    tropospheric delay, as tests/test_snapshot.py holds its 400 m bar on; a
    JAX receiver with
    broadcast orbits injected (assist) and a coarse time runs 2 s and writes
    its checkpoint: from then on every block publishes a snapshot fix."""
    iq, _ = synthesize_constellation(demo_constellation(ASSIST_PRNS), RX, DEMO_GPS_START_SOW,
                                     4.0, FS, noise_sigma=0.35, seed=4, tropo=False)
    cfg = JaxReceiverConfig(tracking=JaxTrackingConfig(matmul_tracker_bf16=False))
    jax_recv = JaxReceiver(JaxArraySource(iq, FS), cfg)
    jax_recv.world.assist_ephemerides({p: DEMO_EPHEMERIDES[i] for i, p in enumerate(DEMO_PRNS_8)})
    jax_recv.world.assist_time(DEMO_GPS_START_SOW + 1.5)
    jax_recv.run(max_seconds=2.0)
    path = tmp_path_factory.mktemp("jax_ckpt") / "jax.ckpt.gz"
    jax_save_checkpoint(jax_recv, path)
    return iq, path


def test_jax_checkpoint_resumes_in_the_port_as_in_jax(assisted):
    iq, path = assisted
    src = JaxArraySource(iq, FS)
    ref = JaxReceiver(src, JaxReceiverConfig(tracking=JaxTrackingConfig(matmul_tracker_bf16=False)))
    jax_fast_forward(src, jax_load_checkpoint(ref, path))
    ref.run()
    port_src = ArraySampleSource(iq, FS)
    port = Receiver(port_src, ReceiverConfig(tracking=TrackingConfig(matmul_tracker_bf16=False)),
                    device="cpu")
    at = load_checkpoint(port, path)
    assert at == pytest.approx(2.0)
    fast_forward(port_src, at)
    port.run()
    assert port.bank.tracked_prns == ref.bank.tracked_prns
    assert sorted(port.bank.tracked_prns) == sorted(ASSIST_PRNS)
    assert all(not r.newly_acquired for r in port.block_reports)
    obs_a = [o for r in ref.block_reports for o in r.observations]
    obs_b = [o for r in port.block_reports for o in r.observations]
    assert [o.prn for o in obs_b] == [o.prn for o in obs_a] and obs_b
    for oa, ob in zip(obs_a, obs_b):
        np.testing.assert_array_equal(ob.pseudosymbol_signs, oa.pseudosymbol_signs)
        scale = max(1.0, float(np.abs(oa.prompts).max()))
        assert float(np.abs(ob.prompts - oa.prompts).max()) < 1e-3 * scale
    fa = [r.fix for r in ref.block_reports if r.fix is not None]
    fb = [r.fix for r in port.block_reports if r.fix is not None]
    assert len(fb) == len(fa) >= 2
    for sa, sb in zip(fa, fb):
        assert (sb.receiver_timestamp, sb.kind) == (sa.receiver_timestamp, sa.kind)
        assert sorted(sb.satellites_used) == sorted(sa.satellites_used)
        assert np.linalg.norm(sb.ecef - sa.ecef) < 1.0
        assert np.linalg.norm(sb.ecef - RX) < 100.0


def test_jax_checkpoint_objects_have_the_ports_attributes(assisted):
    """The classes a JAX checkpoint holds load as the port's, with the same
    attribute sets as objects the port builds itself."""
    from gypsum_tpu_torch.runtime.pipeline import _ChannelPipeline
    from gypsum_tpu_torch.solve.world import WorldModel
    from gypsum_tpu_torch.solve.world_records import _SatelliteRecord
    from gypsum_tpu_torch.track.loop import TrackState

    iq, path = assisted
    blob = read_blob(path)
    assert type(blob["world"]) is WorldModel
    assert type(blob["bank_state"]) is TrackState
    pipe = next(iter(blob["pipelines"].values()))
    assert type(pipe) is _ChannelPipeline
    rec = next(iter(blob["world"]._sats.values()))
    assert type(rec) is _SatelliteRecord
    own = Receiver(ArraySampleSource(iq, FS), _config(), device="cpu")
    own.run(max_seconds=1.0)
    assert set(vars(blob["world"])) == set(vars(own.world))
    assert set(vars(pipe)) == set(vars(next(iter(own.pipelines.values()))))
    assert set(vars(rec)) >= set(vars(next(iter(own.world._sats.values()))))


_LOAD_ALONE = """
import sys
import numpy as np
from gypsum_tpu_torch.io.sources import ArraySampleSource
from gypsum_tpu_torch.runtime.checkpoint import load_checkpoint
from gypsum_tpu_torch.runtime.receiver import Receiver
recv = Receiver(ArraySampleSource(np.zeros(2046 * 20, np.complex64), 2.046e6), device="cpu")
at = load_checkpoint(recv, sys.argv[1])
bad = sorted(k for k in sys.modules if k.split(".")[0] in ("gypsum_tpu", "jax", "jaxlib"))
print(at, sorted(recv.bank.tracked_prns), bad)
"""


def test_jax_checkpoint_loads_without_the_jax_package(assisted):
    _, path = assisted
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", _LOAD_ALONE, str(path)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    at, rest = proc.stdout.strip().split(" ", 1)
    assert float(at) == pytest.approx(2.0)
    assert rest.endswith(" []"), rest
    assert rest.startswith(str(sorted(ASSIST_PRNS)))


_HIT = re.compile(r"^\* PRN\s+(\d+): strength\s+([\d.]+)\s+doppler\s+([-+\d.]+) Hz\s+code phase\s+(\d+)",
                  re.MULTILINE)
_FIX = re.compile(r"SNAPSHOT FIX lat=(-?[\d.]+) lon=(-?[\d.]+) alt=(-?\d+)m")


def test_cli_deep_snapshot_matches_the_jax_cli(assisted, tmp_path, capsys):
    """``acquire --deep --snapshot`` on the assisted scene with the JAX
    checkpoint's orbits and priors ~40 km and 4 s off, in both CLIs."""
    from gypsum_tpu.cli.main import main as jax_main
    from gypsum_tpu_torch.cli.main import main as port_main

    iq, path = assisted
    capture = tmp_path / "scene.npy"
    np.save(capture, iq)
    lat, lon, alt = ecef_to_lla(RX + np.array([-30e3, 20e3, 15e3]))
    args = ["acquire", "--file", str(capture), "--deep", "--deep-ms", "40", "--snapshot",
            "--checkpoint", str(path), "--assume-lla", f"{lat},{lon},{alt}",
            "--assume-tow", str(DEMO_GPS_START_SOW + 4.0)]
    assert jax_main(args) == 0
    want = capsys.readouterr().out
    assert port_main(["--device", "cpu"] + args) == 0
    got = capsys.readouterr().out
    hits_a, hits_b = _HIT.findall(want), _HIT.findall(got)
    assert [(p, c) for p, _, _, c in hits_b] == [(p, c) for p, _, _, c in hits_a]
    assert {int(p) for p, *_ in hits_b} >= set(ASSIST_PRNS)
    for (_, sa, da, _), (_, sb, db, _) in zip(hits_a, hits_b):
        assert abs(float(sa) - float(sb)) <= 0.02 and abs(float(da) - float(db)) <= 0.6
    (fa,), (fb,) = _FIX.findall(want), _FIX.findall(got)
    assert abs(float(fa[0]) - float(fb[0])) <= 1e-5 and abs(float(fa[1]) - float(fb[1])) <= 1e-5
    assert abs(int(fa[2]) - int(fb[2])) <= 1
    err = np.linalg.norm(lla_to_ecef(float(fb[0]), float(fb[1]), float(fb[2])) - RX)
    assert err < 400.0, f"snapshot fix error {err:.0f} m"

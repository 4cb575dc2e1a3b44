"""Checkpoints of the port (gypsum_tpu_torch/runtime/checkpoint.py): its own
save/load roundtrips, single-band and dual-band.

Tolerances: a port roundtrip resumes to the uninterrupted run's
pseudosymbol stream exactly (the same code on the same samples). Checkpoints
written by the JAX package, loaded into the port, are in
tests/test_torch_checkpoint.py.
"""

import tests._torch_cpu  # noqa: F401  # isort: skip (first: caps torch's threads)

import gzip
import pickle

import numpy as np
import pytest

from gypsum_tpu.signal.constellation import synthesize_constellation
from gypsum_tpu.signal.scenarios import demo_constellation, demo_receiver_ecef
from gypsum_tpu.signal.synth import SyntheticSatellite, nav_bit_schedule, synthesize_iq
from gypsum_tpu_torch.core.config import ReceiverConfig, TrackingConfig
from gypsum_tpu_torch.io.sources import ArraySampleSource
from gypsum_tpu_torch.runtime.checkpoint import (
    CHECKPOINT_VERSION,
    CheckpointFormatError,
    fast_forward,
    load_checkpoint,
    load_dual_checkpoint,
    save_checkpoint,
    save_dual_checkpoint,
)
from gypsum_tpu_torch.runtime.receiver import DualBandReceiver, Receiver

FS = 2.046e6
L = 2046
RX = demo_receiver_ecef()


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

"""The port's depth-1 pipeline and one-block read-ahead at their edges
(runtime/receiver.py), against the JAX receiver.

- Twins of tests/test_pipeline.py:72-98 on the scan tracker at 500 ms
  blocks: pipelined, each report carries the previous block's observations
  (block 0's equal to the JAX pipelined receiver's: signs exactly, code
  phases and Dopplers within ``CODE_PHASE_SAMPLES`` and ``DOPPLER_HZ``), and
  a checkpoint with a block in flight is refused with the JAX message.
- Twins of tests/test_async_upload.py:48-82 (its one-satellite 4 s and 5 s
  captures, the default two-phase tracker, phase 1 in float32 on both
  sides): ``max_seconds`` counts processed blocks, not the block read ahead,
  and a checkpoint leaves that block out, so a resumed receiver starts
  there.
- What the JAX package holds only on the scan tracker: on the port's
  default two-phase tracker (phase 1 in float32) the pipelined receiver's
  observations equal the unpipelined one's, block by block, to the bit.

The 4-satellite capture is the first 6 s of tests/test_pipeline.py's 26 s
scene: synthesis draws its noise in 1 s chunks from one seeded generator,
so a shorter synthesis is that capture's prefix, sample for sample, and the
3 s and 2 s cuts are the JAX test's own.
"""

from tests._torch_cpu import concurrently  # isort: skip (first: caps torch's threads)

import numpy as np
import pytest

from gypsum_tpu.core.config import ReceiverConfig as JaxReceiverConfig
from gypsum_tpu.core.config import TrackingConfig as JaxTrackingConfig
from gypsum_tpu.io.sources import ArraySampleSource as JaxArraySource
from gypsum_tpu.runtime.checkpoint import load_checkpoint as jax_load_checkpoint
from gypsum_tpu.runtime.checkpoint import save_checkpoint as jax_save_checkpoint
from gypsum_tpu.runtime.receiver import Receiver as JaxReceiver
from gypsum_tpu_torch.core.config import ReceiverConfig, TrackingConfig
from gypsum_tpu_torch.io.sources import ArraySampleSource
from gypsum_tpu_torch.runtime.checkpoint import fast_forward, load_checkpoint, save_checkpoint
from gypsum_tpu_torch.runtime.receiver import Receiver
from gypsum_tpu_torch.signal.constellation import synthesize_constellation
from gypsum_tpu_torch.signal.scenarios import DEMO_GPS_START_SOW, demo_constellation
from gypsum_tpu_torch.solve.geodesy import lla_to_ecef
from tests.test_async_upload import _capture as one_satellite_capture

FS = 2.046e6
# The scan tracker's observations after 500 ms of tracking, port against JAX:
# float32 sums in another order and another library's cos/sin (the 1e-3
# bar of tests/test_torch_scan_tracker.py over 48 ms), carried over a block.
CODE_PHASE_SAMPLES = 1e-3
DOPPLER_HZ = 1e-2

SCAN = {"block_size_ms": 500, "use_pallas_block_tracker": False, "use_matmul_tracker": False,
        "pipeline_tracking": True}


@pytest.fixture(scope="module")
def capture() -> np.ndarray:
    """The first 6 s of tests/test_pipeline.py:27-34's capture."""
    iq, _ = synthesize_constellation(
        demo_constellation([25, 28, 31, 32]), lla_to_ecef(51.5, -0.1, 80.0), DEMO_GPS_START_SOW,
        6.0, FS, noise_sigma=0.3,
    )
    return iq


def _port(iq, **tracking) -> Receiver:
    cfg = ReceiverConfig(tracking=TrackingConfig(**tracking))
    return Receiver(ArraySampleSource(iq, FS), cfg, device="cpu")


def _jax(iq, **tracking) -> JaxReceiver:
    return JaxReceiver(JaxArraySource(iq, FS), JaxReceiverConfig(tracking=JaxTrackingConfig(**tracking)))


@pytest.fixture(scope="module")
def late_runs(capture):
    """tests/test_pipeline.py:72-85: 3 s pipelined on the scan tracker,
    through both receivers."""
    iq = capture[: int(3.0 * FS)]
    port, ref = _port(iq, **SCAN), _jax(iq, **SCAN)
    concurrently(port.run, ref.run)
    return port, ref


def test_pipelined_observations_arrive_one_block_late(late_runs):
    port, ref = late_runs
    reports = port.block_reports
    assert [r.block_start for r in reports] == [r.block_start for r in ref.block_reports]
    assert reports[0].observations == []  # the first step only dispatches
    assert reports[1].observations, "the second step should deliver block 0"
    assert reports[1].observations[0].start_times[0] < reports[1].block_start
    assert port.bank.pending_blocks == 0


def test_block_zero_observations_equal_the_jax_pipelined_receivers(late_runs):
    port, ref = late_runs
    ours, theirs = port.block_reports[1].observations, ref.block_reports[1].observations
    assert [o.prn for o in ours] == [o.prn for o in theirs] and len(ours) >= 4
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.start_times, b.start_times, rtol=0, atol=1e-9)
        np.testing.assert_array_equal(a.pseudosymbol_signs, b.pseudosymbol_signs)
        np.testing.assert_allclose(a.code_phases, b.code_phases, rtol=0, atol=CODE_PHASE_SAMPLES,
                                   err_msg=f"PRN {a.prn}")
        np.testing.assert_allclose(a.dopplers, b.dopplers, rtol=0, atol=DOPPLER_HZ,
                                   err_msg=f"PRN {a.prn}")


def test_checkpoint_refuses_a_block_in_flight(capture, tmp_path):
    """tests/test_pipeline.py:88-98 on 2 s of the capture: one step leaves
    one block in flight, and both packages refuse to checkpoint it."""
    iq = capture[: int(2.0 * FS)]
    port, ref = _port(iq, **SCAN), _jax(iq, **SCAN)
    concurrently(port.step_block, ref.step_block)
    assert port.bank.pending_blocks == ref.bank.pending_blocks == 1
    with pytest.raises(RuntimeError, match="in flight") as ours:
        save_checkpoint(port, tmp_path / "port.ckpt")
    with pytest.raises(RuntimeError) as theirs:
        jax_save_checkpoint(ref, tmp_path / "jax.ckpt")
    assert str(ours.value) == str(theirs.value)


ASYNC = {"block_size_ms": 500, "async_upload": True, "pipeline_tracking": True,
         "matmul_tracker_bf16": False}


def _processed_s(recv) -> float:
    return sum(r.block_end - r.block_start for r in recv.block_reports)


def test_max_seconds_counts_processed_blocks_not_the_read_ahead():
    """tests/test_async_upload.py:48-55: 2.0 s at 500 ms blocks is four
    dispatched blocks; the block read ahead does not shorten the span."""
    iq = one_satellite_capture()
    port, ref = _port(iq, **ASYNC), _jax(iq, **ASYNC)
    concurrently(lambda: port.run(max_seconds=2.0), lambda: ref.run(max_seconds=2.0))
    assert _processed_s(port) >= 2.0 - 1e-9
    assert [(r.block_start, r.block_end) for r in port.block_reports] == [
        (r.block_start, r.block_end) for r in ref.block_reports]
    assert port.stream_position_s == ref.stream_position_s


def test_checkpoint_excludes_the_read_ahead_block(tmp_path):
    """tests/test_async_upload.py:58-82 on the 5 s capture: the checkpoint's
    stream position is the JAX receiver's, short of what the source has
    read (the block read ahead), and a resumed port receiver starts its
    first block there and reads through to the capture's end."""
    iq = one_satellite_capture(n_ms=5000)
    port, ref = _port(iq, **ASYNC), _jax(iq, **ASYNC)
    concurrently(lambda: port.run(max_seconds=2.0), lambda: ref.run(max_seconds=2.0))
    assert port._readahead is not None  # a block was read ahead, undispatched
    save_checkpoint(port, tmp_path / "port.ckpt")
    jax_save_checkpoint(ref, tmp_path / "jax.ckpt")

    resumed = _port(iq, block_size_ms=500, async_upload=True)
    stream_s = load_checkpoint(resumed, tmp_path / "port.ckpt")
    assert stream_s == port.stream_position_s
    assert stream_s == jax_load_checkpoint(_jax(iq, block_size_ms=500), tmp_path / "jax.ckpt")
    assert stream_s < port.source.seconds_consumed
    fast_forward(resumed.source, stream_s)
    resumed.run()
    assert min(r.block_start for r in resumed.block_reports) == stream_s
    assert resumed.source.seconds_consumed >= 5.0 - 1e-9


def _collected(report) -> list:
    """A report's observations as comparable arrays."""
    return [(o.prn, o.slot, *(np.asarray(getattr(o, name)) for name in (
        "start_times", "pseudosymbol_signs", "code_phases", "dopplers", "prompts", "quality")))
        for o in report.observations]


def test_pipelined_default_tracker_equals_unpipelined_block_by_block(capture):
    """The port's default two-phase tracker (phase 1 in float32) over the
    6 s capture at 1000 ms blocks: pipelined, report k + 1 carries what the
    unpipelined report k carries, to the bit, and the pipeline drains."""
    pipe = _port(capture, pipeline_tracking=True, matmul_tracker_bf16=False)
    sync = _port(capture, pipeline_tracking=False, matmul_tracker_bf16=False)
    concurrently(pipe.run, sync.run)
    assert pipe.bank.pending_blocks == 0
    assert [(h.prn, h.code_phase_samples, h.doppler_hz) for h in pipe.block_reports[0].newly_acquired] \
        == [(h.prn, h.code_phase_samples, h.doppler_hz) for h in sync.block_reports[0].newly_acquired]
    assert pipe.block_reports[0].observations == []
    late, now = pipe.block_reports[1:], sync.block_reports
    assert len(late) == len(now) == 6
    for r_late, r_now in zip(late, now):
        a, b = _collected(r_late), _collected(r_now)
        assert [x[:2] for x in a] == [y[:2] for y in b] and len(a) >= 4
        for x, y in zip(a, b):
            for u, v in zip(x[2:], y[2:]):
                np.testing.assert_array_equal(u, v, err_msg=f"PRN {x[0]}, block at {r_now.block_start} s")

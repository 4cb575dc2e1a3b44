"""Checkpoints written by the JAX package, loaded into the port's Receiver
(gypsum_tpu_torch/runtime/checkpoint.py) without importing the JAX package.

A JAX checkpoint resumed by both packages is held to the receiver ladder of
tests/test_torch_receiver.py: the same tracked PRNs, pseudosymbol signs
equal, prompts within 1e-3 of their scale (float32 sums in another order),
equal fix epochs, kinds and satellite sets, positions within 1 m. The CLI's
deep snapshot is held to the JAX CLI's printed output: the same detected
PRNs and code phases, Doppler within 0.6 Hz and strength within 0.02 (the
printed digits, one unit of slack), the SNAPSHOT FIX within 1e-5 degrees
and 1 m of altitude, both within the 400 m bar of tests/test_snapshot.py.
The port's own roundtrips are in tests/test_torch_checkpoint_roundtrip.py.
"""

from tests._torch_cpu import subprocess_env  # isort: skip (first: caps torch's threads)

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
from gypsum_tpu.solve.geodesy import ecef_to_lla, lla_to_ecef
from gypsum_tpu_torch.core.config import ReceiverConfig, TrackingConfig
from gypsum_tpu_torch.io.sources import ArraySampleSource
from gypsum_tpu_torch.runtime.checkpoint import fast_forward, load_checkpoint, read_blob
from gypsum_tpu_torch.runtime.receiver import Receiver

ROOT = Path(__file__).resolve().parent.parent
FS = 2.046e6
RX = demo_receiver_ecef()
ASSIST_PRNS = list(DEMO_PRNS_8)


def _config():
    return ReceiverConfig(tracking=TrackingConfig(block_size_ms=500))



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
    proc = subprocess.run([sys.executable, "-c", _LOAD_ALONE, str(path)], cwd=ROOT,
                          env=subprocess_env(),
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

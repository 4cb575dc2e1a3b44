"""The port (gypsum_tpu_torch), chip_smoke.py and the port's rank worker
(tests/_torch_dist_worker.py and tests/_torch_cpu.py, a source scan) stand alone: no JAX, nothing
of the JAX package, and no quiet fall back to the CPU when CUDA is asked for.

The import check runs in a subprocess: tests/conftest.py imports JAX into
this test process.
"""

from tests._torch_cpu import subprocess_env  # isort: skip (first: caps torch's threads)

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "gypsum_tpu_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import gypsum_tpu_torch
names = [m.name for m in pkgutil.walk_packages(gypsum_tpu_torch.__path__, "gypsum_tpu_torch.")]
for name in names:
    if not name.endswith("__main__"):
        importlib.import_module(name)
import chip_smoke
import tools.campaign_torch
from gypsum_tpu_torch.runtime.checkpoint import read_blob
blob = read_blob(sys.argv[1])  # a checkpoint the JAX package wrote
assert type(blob["world"]).__module__ == "gypsum_tpu_torch.solve.world"
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib") or k == "gypsum_tpu" or k.startswith("gypsum_tpu."))
print(len(names), bad)
"""


def test_port_and_chip_smoke_import_no_jax(tmp_path):
    """Every module of the port and chip_smoke.py import, and a checkpoint
    written by the JAX package loads, without JAX or the JAX package."""
    from gypsum_tpu.io.sources import ArraySampleSource as JaxArraySource
    from gypsum_tpu.runtime.checkpoint import save_checkpoint as jax_save_checkpoint
    from gypsum_tpu.runtime.receiver import Receiver as JaxReceiver

    ckpt = tmp_path / "jax.ckpt.gz"
    jax_save_checkpoint(JaxReceiver(JaxArraySource(np.zeros(2046 * 20, np.complex64), 2.046e6)),
                        ckpt)
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL, str(ckpt)], cwd=ROOT, env=subprocess_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    n_modules, bad = proc.stdout.strip().rsplit("\n", 1)[-1].split(" ", 1)
    assert int(n_modules) >= 40
    assert bad == "[]", f"JAX or the JAX package was loaded: {bad}"


# JAX, the JAX package, and tools/campaign.py (it imports JAX at load).
_FORBIDDEN = re.compile(r"^\s*(?:(?:from|import)\s+(?:jax|jaxlib|gypsum_tpu|tools\.campaign)(?!\w)"
                        r"|from\s+tools\s+import\s+campaign\b)", re.MULTILINE)


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "tests" / "_torch_dist_worker.py",
                                         ROOT / "tests" / "_torch_cpu.py",
                                         ROOT / "tools" / "campaign_torch.py"]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_source_has_no_jax_or_reference_import(path):
    hits = _FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path}: {hits}"


def test_cuda_kernels_are_in_the_repo():
    for name in ("fixup", "peak_reduce", "fir_decimate", "wipeoff_lag", "track_block",
                 "iq_operand"):
        src = (PORT / "csrc" / f"{name}.cu").read_text()
        assert 'extern "C"' in src and "cudaGetLastError" in src
        assert "__global__" in src


def _needs_no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device='cuda' is valid here")


def test_resolve_device_raises_without_a_card():
    from gypsum_tpu_torch.core.device import resolve_device

    _needs_no_card()
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")


def _build_acquisition():
    from gypsum_tpu_torch.acquire.engine import AcquisitionEngine

    return AcquisitionEngine(2.046e6, 2046)


def _build_bank():
    from gypsum_tpu_torch.track.loop import TrackerBank

    return TrackerBank(2.046e6, 2046)


def _build_receiver():
    from gypsum_tpu_torch.io.sources import ArraySampleSource
    from gypsum_tpu_torch.runtime.receiver import Receiver

    return Receiver(ArraySampleSource(np.zeros(2046 * 20, np.complex64), 2.046e6))


def _build_notching_source():
    from gypsum_tpu_torch.io.sources import ArraySampleSource, NotchingSampleSource

    return NotchingSampleSource(ArraySampleSource(np.zeros(2046 * 20, np.complex64), 2.046e6))


def _null_jammers():
    from gypsum_tpu_torch.ops.beamform import null_jammers

    return null_jammers(np.ones((4, 2046), np.complex64))


def _cmd_rtk():
    import argparse

    from gypsum_tpu_torch.cli.rtk import cmd_rtk

    return cmd_rtk(argparse.Namespace(
        device="cuda", prns=None, attitude=None, kinematic=False, base_rinex=None,
        rover_rinex=None, nav=None, base_file="base.npy", rover_file="rover.npy",
        format=None, sample_rate=None, duration=None, base_lla=[51.5, -0.1, 80.0]))


def _campaign_trial():
    from tools.campaign_torch import gps_spec, run_trial

    return run_trial(gps_spec(0))


@pytest.mark.parametrize("build", [_build_acquisition, _build_bank, _build_receiver,
                                   _build_notching_source, _null_jammers, _cmd_rtk,
                                   _campaign_trial])
def test_entry_points_default_to_cuda_and_raise_without_a_card(build):
    _needs_no_card()
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        build()


def test_cli_default_device_raises_without_a_card(tmp_path):
    from gypsum_tpu_torch.cli.main import main

    _needs_no_card()
    capture = tmp_path / "noise.npy"
    np.save(capture, np.zeros(2046 * 20, np.complex64))
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        main(["replay", "--file", str(capture)])


def test_campaign_cli_defaults_to_cuda_and_raises_without_a_card():
    from tools.campaign_torch import main

    _needs_no_card()
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        main(["--trials", "1"])


def test_chip_smoke_fails_without_a_card():
    _needs_no_card()
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, env=subprocess_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.parametrize("name", ["NotchingSampleSource"])
def test_unported_front_ends_raise(name):
    """The front end that used to raise "not ported" now opens and excises:
    a 12-amplitude tone at 257 kHz over noise is found and notched, and the
    block comes back at the noise floor away from its ends (the edge frames
    keep the truncated tone's transient, tests/test_interference.py:55-58)."""
    from gypsum_tpu_torch.io import sources

    rng = np.random.default_rng(2)
    n = 2046 * 20
    noise = ((rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.3).astype(np.complex64)
    tone = 12.0 * np.exp(2j * np.pi * 257e3 * np.arange(n) / 2.046e6)
    src = getattr(sources, name)(sources.ArraySampleSource((noise + tone).astype(np.complex64),
                                                           2.046e6), device="cpu")
    assert src.attributes == sources.StreamAttributes(2.046e6, 2046)
    ts, block = src.read_block(20)
    assert ts == 0.0 and block.shape == (20, 2046) and block.dtype == np.complex64
    assert src.interference_seconds == 1.0 and src.last_report.n_bins > 0
    inner = slice(2 * 4096, n - 2 * 4096)
    assert np.mean(np.abs(block.ravel()[inner]) ** 2) < 1.1 * np.mean(np.abs(noise[inner]) ** 2)


def test_decimating_source_opens_and_reads_a_fast_capture():
    from gypsum_tpu_torch.io import sources

    rng = np.random.default_rng(0)
    iq = (rng.standard_normal(4092 * 8) + 1j * rng.standard_normal(4092 * 8)).astype(np.complex64)
    src = sources.DecimatingSampleSource(sources.ArraySampleSource(iq, 4.092e6), 2.046e6, device="cpu")
    assert (src.up, src.down) == (1, 2)
    assert src.attributes == sources.StreamAttributes(2.046e6, 2046)
    ts, block = src.read_block(5)
    assert ts == 0.0 and block.shape == (5, 2046) and block.dtype == np.complex64
    assert np.isfinite(block).all() and np.abs(block).max() > 0.1
    assert src.seconds_consumed == pytest.approx(5e-3)


def test_decimating_source_defaults_to_cuda_and_raises_without_a_card():
    from gypsum_tpu_torch.io import sources

    _needs_no_card()
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        sources.DecimatingSampleSource(
            sources.ArraySampleSource(np.zeros(4092 * 4, np.complex64), 4.092e6), 2.046e6)


def test_cli_capture_needing_resampling_raises(tmp_path, capsys):
    """A capture at 4.092 Msps used to raise "not ported"; the CLI now opens
    it through the decimating front end and replays it (noise: no fix)."""
    from gypsum_tpu_torch.cli.main import main

    rng = np.random.default_rng(1)
    capture = tmp_path / "fast.npy"
    iq = (rng.standard_normal(4092 * 30) + 1j * rng.standard_normal(4092 * 30)).astype(np.complex64)
    np.save(capture, iq)
    rc = main(["--device", "cpu", "replay", "--file", str(capture), "--sample-rate", "4.092e6",
               "--block-ms", "10"])
    assert rc == 0
    assert "processed 0.0" in capsys.readouterr().out

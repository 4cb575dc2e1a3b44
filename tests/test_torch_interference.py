"""The STFT notch of the port (ops/interference.py, io/sources.py's
NotchingSampleSource, device="cpu") against the JAX package's.

Tolerances, and why:
- against ``stft_notch_np`` (numpy), relative L2 error <= 2e-3, the JAX
  package's own bar between its two versions (tests/test_interference.py:109),
  with the masked bin count equal;
- against ``make_stft_notch_jax`` (float32 against float32), relative L2
  error <= 1e-5 and the stats equal (bins and applied exactly, the
  peak-over-median ratio to 1e-5): the two take the same float32 FFTs,
  means and median in another order, which measures ~1e-6 here;
- a block with nothing to excise comes back bit-identical.
"""

import tests._torch_cpu  # noqa: F401  # isort: skip (first: caps torch's threads)

import dataclasses

import numpy as np
import pytest
import torch

from gypsum_tpu.core.config import ReceiverConfig as JaxReceiverConfig
from gypsum_tpu.io.sources import ArraySampleSource as JaxArraySource
from gypsum_tpu.io.sources import NotchingSampleSource as JaxNotchingSource
from gypsum_tpu.ops.interference import make_stft_notch_jax, stft_notch_np
from gypsum_tpu.runtime.receiver import Receiver as JaxReceiver
from gypsum_tpu_torch.core.config import ReceiverConfig
from gypsum_tpu_torch.io.sources import ArraySampleSource, NotchingSampleSource
from gypsum_tpu_torch.ops.interference import make_stft_notch
from gypsum_tpu_torch.runtime.receiver import Receiver

FS, L = 2.046e6, 2046


def _tone(n, freq, amp, phase=0.3):
    t = np.arange(n) / FS
    return (amp * np.exp(1j * (2 * np.pi * freq * t + phase))).astype(np.complex64)


def _noise(n, sigma, seed):
    rng = np.random.default_rng(seed)
    return (sigma * (rng.standard_normal(n) + 1j * rng.standard_normal(n)) /
            np.sqrt(2)).astype(np.complex64)


def _chirp(n):
    t = np.arange(n) / FS
    return (4.0 * np.exp(1j * 2 * np.pi * (100e3 * t + 0.5 * 20e3 * t * t))).astype(np.complex64)


def _planes(x):
    return np.stack([x.real, x.imag]).astype(np.float32)


def _complex(planes):
    planes = np.asarray(planes)
    return planes[0] + 1j * planes[1]


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# The JAX tests' tone and swept jammer, a length that is not a multiple of
# the 1024-sample hop, and no guard band.
CASES = {
    "tone": (lambda: _noise(40_960, 0.4, 5) + _tone(40_960, 150_000.0, 3.0), 3),
    "swept": (lambda: _noise(204_600, 0.3, 11) + _chirp(204_600), 3),
    "odd_length": (lambda: _noise(40_001, 0.4, 8) + _tone(40_001, -310_000.0, 8.0), 3),
    "no_guard": (lambda: _noise(40_960, 0.4, 5) + _tone(40_960, 150_000.0, 3.0), 0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_notch_matches_numpy_and_jax(case):
    make, guard = CASES[case]
    x = make()
    n = len(x)
    clean_np, rep = stft_notch_np(x, FS, guard_bins=guard)
    assert rep.detected
    jax_out, jax_stats = make_stft_notch_jax(n, FS, guard_bins=guard)(_planes(x))
    jax_stats = np.asarray(jax_stats)
    out, stats = make_stft_notch(n, FS, guard_bins=guard, device="cpu")(torch.from_numpy(_planes(x)))
    stats = stats.numpy()
    assert out.shape == (2, n) and out.dtype == torch.float32
    assert int(stats[0]) == rep.n_bins == int(jax_stats[0])
    assert stats[2] == jax_stats[2] == 1.0
    assert stats[1] == pytest.approx(float(jax_stats[1]), rel=1e-5)
    clean = _complex(out.numpy())
    assert _rel(clean, clean_np) <= 2e-3
    assert _rel(clean, _complex(jax_out)) <= 1e-5


def test_no_detection_passes_the_block_through_bit_identical():
    quiet = _noise(40_960, 0.4, 6)
    planes = torch.from_numpy(_planes(quiet))
    out, stats = make_stft_notch(len(quiet), FS, device="cpu")(planes)
    assert stats[0] == 0 and stats[2] == 0
    assert torch.equal(out, planes)
    _, rep = stft_notch_np(quiet, FS)
    assert not rep.detected


def test_too_wide_mask_passes_the_block_through_bit_identical():
    """A mask wider than max_fraction is reported, not applied, in both
    packages (tests/test_interference.py:112-116's rule)."""
    n = 40_960
    x = _noise(n, 0.4, 5) + sum(_tone(n, f, 3.0) for f in (-400e3, -150e3, 90e3, 300e3))
    _, rep = stft_notch_np(x, FS, max_fraction=0.002)
    assert rep.detected and rep.fraction > 0.002
    planes = torch.from_numpy(_planes(x))
    out, stats = make_stft_notch(n, FS, max_fraction=0.002, device="cpu")(planes)
    assert int(stats[0]) == rep.n_bins and stats[2] == 0
    assert torch.equal(out, planes)


def _jammed_stream(seconds, seed):
    from gypsum_tpu.signal.synth import SyntheticSatellite, synthesize_iq

    sats = [
        SyntheticSatellite(prn=25, doppler_hz=1234.0, delay_samples=701, amplitude=0.3),
        SyntheticSatellite(prn=28, doppler_hz=-2500.0, delay_samples=100, amplitude=0.3),
        SyntheticSatellite(prn=31, doppler_hz=400.0, delay_samples=1500, amplitude=0.3),
        SyntheticSatellite(prn=32, doppler_hz=-3900.0, delay_samples=900, amplitude=0.3),
    ]
    n = int(seconds * 1000) * L
    return sats, synthesize_iq(sats, n, FS, noise_sigma=0.3, seed=seed) + _tone(n, 257_000.0, 12.0)


def test_notching_source_matches_jax_block_by_block():
    """Events, bins, frequencies and peak (within 0.01 dB) over 100 ms
    blocks, the blocks within 2e-3 of the numpy notch; peek_block records
    nothing and returns the block read_block then returns."""
    _, x = _jammed_stream(0.4, seed=4)
    x[L * 200 : L * 300] = _noise(L * 100, 0.3, 9)  # one clean block
    port = NotchingSampleSource(ArraySampleSource(x, FS), device="cpu")
    ref = JaxNotchingSource(JaxArraySource(x, FS))
    _, peeked = port.peek_block(100)
    assert port.events == [] and port.last_report is None
    for k in range(4):
        ts, got = port.read_block(100)
        jts, want = ref.read_block(100)
        assert ts == jts and got.shape == want.shape == (100, L) and got.dtype == np.complex64
        if k == 0:
            assert np.array_equal(got, peeked)
        if k == 2:
            assert np.array_equal(got, x[L * 200 : L * 300].reshape(100, L))
        else:
            assert _rel(got, want) <= 2e-3
        a, b = port.last_report, ref.last_report
        assert (a.detected, a.n_bins, a.fraction, a.freqs_hz) == (
            b.detected, b.n_bins, b.fraction, b.freqs_hz)
        assert a.peak_over_median_db == pytest.approx(b.peak_over_median_db, abs=0.01)
    assert [t for t, _ in port.events] == [t for t, _ in ref.events] == [0.0, 0.1, 0.3]
    assert port.interference_seconds == ref.interference_seconds == 3.0


def test_jammed_acquisition_matches_jax():
    """tests/test_interference.py:118-148's 10 ms jammed block: the port's
    notch and engine find what the JAX package's find."""
    from gypsum_tpu.acquire.engine import AcquisitionEngine as JaxEngine
    from gypsum_tpu_torch.acquire.engine import AcquisitionEngine

    sats, jammed = _jammed_stream(0.01, seed=2)
    prns = {25, 28, 31, 32}
    clean_np, rep = stft_notch_np(jammed, FS)
    out, stats = make_stft_notch(len(jammed), FS, device="cpu")(torch.from_numpy(_planes(jammed)))
    assert int(stats[0]) == rep.n_bins and stats[2] == 1.0
    clean = _complex(out.numpy()).astype(np.complex64)
    port = AcquisitionEngine(FS, L, device="cpu").detect(clean.reshape(10, L), prns)
    ref = JaxEngine(FS, L).detect(clean_np.reshape(10, L), prns)
    assert [(h.prn, h.code_phase_samples) for h in port] == [(h.prn, h.code_phase_samples) for h in ref]
    assert len(port) == 4
    truth = {s.prn: s.doppler_hz for s in sats}
    for a, b in zip(port, ref):
        assert abs(a.doppler_hz - b.doppler_hz) < 2.0
        assert abs(a.doppler_hz - truth[a.prn]) < 20.0


def test_jammed_receiver_matches_jax():
    """Three 1000 ms blocks of a jammed stream through both packages'
    notching source and receiver (phase 1 in float32 in both): equal
    acquisitions and > 99.9 % pseudosymbol sign agreement per PRN."""
    _, jammed = _jammed_stream(3.0, seed=3)
    prns = [25, 28, 31, 32]
    jcfg = JaxReceiverConfig()
    jcfg = jcfg.replace(tracking=dataclasses.replace(jcfg.tracking, matmul_tracker_bf16=False))
    ref = JaxReceiver(JaxNotchingSource(JaxArraySource(jammed, FS)), jcfg, eligible_prns=prns)
    ref.run()
    cfg = ReceiverConfig()
    cfg = cfg.replace(tracking=dataclasses.replace(cfg.tracking, matmul_tracker_bf16=False))
    port = Receiver(NotchingSampleSource(ArraySampleSource(jammed, FS), device="cpu"), cfg,
                    eligible_prns=prns, device="cpu")
    port.run()
    acq = [[(h.prn, h.code_phase_samples) for h in r.newly_acquired] for r in port.block_reports]
    assert acq == [[(h.prn, h.code_phase_samples) for h in r.newly_acquired]
                   for r in ref.block_reports]
    assert {p for p, _ in acq[0]} == set(prns)

    def signs(recv):
        out = {}
        for report in recv.block_reports:
            for obs in report.observations:
                out.setdefault(obs.prn, []).append(np.asarray(obs.pseudosymbol_signs))
        return {p: np.concatenate(v) for p, v in out.items()}

    got, want = signs(port), signs(ref)
    assert set(got) == set(want) == set(prns)
    for prn in prns:
        assert got[prn].shape == want[prn].shape
        assert np.mean(got[prn] == want[prn]) > 0.999
    assert port.source.interference_seconds == ref.source.interference_seconds == 3.0

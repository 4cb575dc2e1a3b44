"""The port's deep acquisition (gypsum_tpu_torch/acquire/deep.py) against the
JAX package's (gypsum_tpu/acquire/deep.py) on the same seeded captures.

Tolerances, on the PRNs or channels that are on the air: code phase equal,
Doppler within 0.5 Hz (the phase-slope refinement resolves a few hundredths
of a hertz; float32 sums in another order move it by ~1e-4 Hz), strength
within 1e-3 relative (the port sums each group's forward FFTs before one
inverse FFT where JAX inverse-transforms every millisecond: the same
function, float32 sums in another order, measured ~1e-7 relative). On rows
that hold noise only, only the detection decision is held: two near-equal
noise peaks may swap under another float32 sum order (ROADMAP.md §C).
The Doppler-chunk gather indices are host numpy in both packages and are
held bit-equal. Configurations are cut (a few PRNs or channels, spans of
0.5-4 kHz, 100-400 ms) so the file stays well under a minute.
"""

import tests._torch_cpu  # noqa: F401  # isort: skip (first: caps torch's threads)

import dataclasses
import re

import numpy as np
import pytest

from gypsum_tpu.acquire.deep import DeepAcquisitionEngine as JaxDeepEngine
from gypsum_tpu.acquire.deep import deep_acquire_glonass as jax_deep_acquire_glonass
from gypsum_tpu.core.config import DeepAcquisitionConfig as JaxDeepConfig
from gypsum_tpu.signal.synth import SyntheticSatellite, synthesize_iq
from gypsum_tpu_torch.acquire.deep import DeepAcquisitionEngine, deep_acquire_glonass
from gypsum_tpu_torch.acquire.engine import AcquisitionEngine
from gypsum_tpu_torch.core.config import AcquisitionConfig, DeepAcquisitionConfig
from gypsum_tpu_torch.ops.peak_reduce import PEAK_REDUCE_KERNEL

FS, L = 2.046e6, 2046


def _capture(sats, n_ms, seed=5, noise=0.3):
    return synthesize_iq(sats, n_samples=n_ms * L, sample_rate=FS, noise_sigma=noise,
                         seed=seed).reshape(n_ms, L)


def _hold(port, ref, on_air, threshold):
    """Port results against the JAX results: the full hold on ``on_air``
    PRNs, the detection decision on every PRN."""
    p = {r.prn: r for r in port}
    j = {r.prn: r for r in ref}
    assert set(p) == set(j)
    for prn in j:
        assert (p[prn].strength > threshold) == (j[prn].strength > threshold), prn
    for prn in on_air:
        assert p[prn].code_phase_samples == j[prn].code_phase_samples, prn
        assert abs(p[prn].doppler_hz - j[prn].doppler_hz) < 0.5, prn
        assert p[prn].strength == pytest.approx(j[prn].strength, rel=1e-3), prn


@pytest.fixture(scope="module")
def weak_scene():
    """PRN 7 at amplitude 0.012 (~ -25 dB below the noise), 400 ms: the
    below-the-floor scene of tests/test_deep_acquire.py."""
    sats = [SyntheticSatellite(prn=7, doppler_hz=1743.0, delay_samples=512, amplitude=0.012)]
    return _capture(sats, 400)


def test_deep_finds_signal_below_the_standard_floor_as_jax_does(weak_scene):
    """The 10 ms engine is blind; the 400 ms deep search finds PRN 7 at code
    phase 512 within 5 Hz, PRN 3 stays below the adaptive threshold, and
    every number matches the JAX engine. The Doppler grid is cut to
    1500 +/- 1000 Hz (41 bins) from the JAX test's +/-4 kHz."""
    std = AcquisitionEngine(FS, L, AcquisitionConfig(correlator="fft"), prns=(7, 3), device="cpu")
    assert {r.prn: r for r in std.acquire_all(weak_scene[:10])}[7].strength < 3.0
    kw = dict(total_ms=400, doppler_center_hz=1500.0, doppler_span_hz=1000.0)
    port = DeepAcquisitionEngine(FS, L, DeepAcquisitionConfig(**kw), prns=(7, 3), device="cpu")
    ref = JaxDeepEngine(FS, L, JaxDeepConfig(**kw), prns=(7, 3))
    before = PEAK_REDUCE_KERNEL.launches
    got = port.acquire_all(weak_scene)
    assert PEAK_REDUCE_KERNEL.launches == before  # CPU tensors run K2's plain version
    _hold(got, ref.acquire_all(weak_scene), on_air=(7,), threshold=ref.detection_threshold)
    assert port.detection_threshold == ref.detection_threshold
    hit = {r.prn: r for r in got}[7]
    assert hit.code_phase_samples == 512 and abs(hit.doppler_hz - 1743.0) < 5.0
    assert hit.strength > 4.0
    assert {r.prn: r for r in got}[3].strength < port.detection_threshold
    assert port.detect(weak_scene) == [hit]
    assert [r.prn for r in port.detect(weak_scene)] == [r.prn for r in ref.detect(weak_scene)]


@pytest.mark.parametrize("compensate", [True, False])
def test_code_doppler_compensation_matches_jax(compensate):
    """At 6.8 kHz the code drifts ~3.6 samples over 400 ms; with and without
    the per-group realignment the port gives the JAX engine's result."""
    sats = [SyntheticSatellite(prn=7, doppler_hz=6800.0, delay_samples=900, amplitude=0.03)]
    samples = _capture(sats, 400, seed=6)
    kw = dict(total_ms=400, doppler_center_hz=6800.0, doppler_span_hz=500.0,
              compensate_code_doppler=compensate)
    port = DeepAcquisitionEngine(FS, L, DeepAcquisitionConfig(**kw), prns=(7,), device="cpu")
    ref = JaxDeepEngine(FS, L, JaxDeepConfig(**kw), prns=(7,))
    got = port.acquire_all(samples)
    _hold(got, ref.acquire_all(samples), on_air=(7,), threshold=ref.detection_threshold)
    if compensate:
        assert got[0].code_phase_samples == 900 and abs(got[0].doppler_hz - 6800.0) < 5.0


def test_deep_agrees_with_the_ports_standard_engine_on_strong_signals():
    sats = [
        SyntheticSatellite(prn=7, doppler_hz=1743.0, delay_samples=512, amplitude=0.22),
        SyntheticSatellite(prn=19, doppler_hz=-3211.0, delay_samples=1777, amplitude=0.22),
    ]
    samples = _capture(sats, 100)
    std = AcquisitionEngine(FS, L, AcquisitionConfig(correlator="fft"), prns=(7, 19), device="cpu")
    deep = DeepAcquisitionEngine(
        FS, L, DeepAcquisitionConfig(total_ms=100, doppler_span_hz=4000.0), prns=(7, 19),
        device="cpu")
    std_hits = {r.prn: r for r in std.acquire_all(samples[:10])}
    deep_hits = {r.prn: r for r in deep.acquire_all(samples)}
    for prn in (7, 19):
        assert deep_hits[prn].code_phase_samples == std_hits[prn].code_phase_samples
        assert abs(deep_hits[prn].doppler_hz - std_hits[prn].doppler_hz) < 5.0
        assert deep_hits[prn].strength > std_hits[prn].strength  # more integration


def test_total_ms_must_divide_into_groups():
    with pytest.raises(ValueError, match="not a multiple"):
        DeepAcquisitionEngine(FS, L, DeepAcquisitionConfig(coherent_ms=10, total_ms=205),
                              prns=(7,), device="cpu")
    eng = DeepAcquisitionEngine(FS, L, DeepAcquisitionConfig(total_ms=40), prns=(7,), device="cpu")
    with pytest.raises(ValueError, match="expected"):
        eng.acquire_all(np.zeros((30, L), np.complex64))


@pytest.mark.parametrize("compensate,carrier_hz", [
    (True, 1575.42e6), (False, 1575.42e6), (True, 1602.0e6),
])
def test_roll_indices_are_bit_equal(compensate, carrier_hz):
    kw = dict(total_ms=400, compensate_code_doppler=compensate)
    port = DeepAcquisitionEngine(FS, L, DeepAcquisitionConfig(**kw), prns=(7,),
                                 carrier_hz=carrier_hz, device="cpu")
    ref = JaxDeepEngine(FS, L, JaxDeepConfig(**kw), prns=(7,), carrier_hz=carrier_hz)
    np.testing.assert_array_equal(port.dopplers, ref.dopplers)
    for start in (0, 136, 280):  # the first, a middle and the padded last chunk
        chunk = port.dopplers[start:start + 8]
        chunk = np.concatenate([chunk, np.repeat(chunk[-1:], 8 - len(chunk))])
        a, b = port._roll_indices(chunk), ref._roll_indices(chunk)
        assert a.dtype == b.dtype == np.int32 and a.shape == (40, 8, L)
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def fdma_scene():
    """Two GLONASS channels on the air (k = -4, +2), 120 ms at 4.092 Msps."""
    from gypsum_tpu.signal.constellation import synthesize_constellation
    from gypsum_tpu.signal.scenarios import (
        DEMO_GLONASS_SAMPLE_RATE,
        demo_glonass_constellation,
        demo_receiver_ecef,
    )

    sats = [dataclasses.replace(s, amplitude=0.05) for s in demo_glonass_constellation([-4, 2])]
    iq, truth = synthesize_constellation(sats, demo_receiver_ecef(), 21618.0, 0.12,
                                         DEMO_GLONASS_SAMPLE_RATE, noise_sigma=0.3, seed=11)
    return iq, truth, [s.prn for s in sats], DEMO_GLONASS_SAMPLE_RATE


def test_deep_acquire_glonass_matches_jax(fdma_scene):
    """The per-channel float64 pre-rotation and the shared single-code engine
    on a short FDMA scene: two channels on the air and a vacant one (k = 0),
    100 ms, the JAX test's +/-4 kHz span."""
    iq, truth, planted, glo_fs = fdma_scene
    glo_l = 4092
    probe = tuple(planted) + (208,)
    kw = dict(total_ms=100, doppler_span_hz=4000.0)
    got = deep_acquire_glonass(iq, glo_fs, glo_l, DeepAcquisitionConfig(**kw), prns=probe,
                               device="cpu")
    ref = jax_deep_acquire_glonass(iq, glo_fs, glo_l, JaxDeepConfig(**kw), prns=probe)
    threshold = 1.0 + 10.0 / np.sqrt(10)
    _hold(got, ref, on_air=planted, threshold=threshold)
    hits = {r.prn: r for r in got}
    for p in planted:
        assert hits[p].strength > threshold
        assert abs(hits[p].code_phase_samples - truth.code_phase_samples[p]) <= 1
    assert hits[208].strength < threshold
    with pytest.raises(ValueError, match="GLONASS channel ids"):
        deep_acquire_glonass(iq, glo_fs, glo_l, DeepAcquisitionConfig(**kw), prns=(7,),
                             device="cpu")


_HIT = re.compile(r"^\* PRN\s+(\d+): strength\s+([\d.]+)\s+doppler\s+([-+\d.]+) Hz\s+"
                  r"code phase\s+(\d+)", re.MULTILINE)


@pytest.mark.parametrize("band", ["gps", "glonass"])
def test_cli_acquire_matches_the_jax_cli(band, fdma_scene, tmp_path, capsys):
    """``acquire`` in both CLIs, the 10 ms report: on the strong GPS scene,
    and over the 14 FDMA channels of the GLONASS scene. The same detected
    PRNs and code phases; Doppler within 0.6 Hz and strength within 0.02
    (the printed digits, one unit of slack). The deep report is held in
    tests/test_torch_checkpoint.py (GPS, with a snapshot fix)."""
    from gypsum_tpu.cli.main import main as jax_main
    from gypsum_tpu_torch.cli.main import main as port_main

    capture = tmp_path / "scene.npy"
    if band == "gps":
        sats = [SyntheticSatellite(prn=7, doppler_hz=1743.0, delay_samples=512, amplitude=0.22),
                SyntheticSatellite(prn=19, doppler_hz=-3211.0, delay_samples=1777, amplitude=0.22)]
        np.save(capture, _capture(sats, 20).reshape(-1))
        args = ["acquire", "--file", str(capture)]
    else:
        np.save(capture, fdma_scene[0])
        args = ["acquire", "--glonass-file", str(capture)]
    assert jax_main(args) == 0
    want = _HIT.findall(capsys.readouterr().out)
    assert port_main(["--device", "cpu"] + args) == 0
    got = _HIT.findall(capsys.readouterr().out)
    assert [(p, c) for p, _, _, c in got] == [(p, c) for p, _, _, c in want] and got
    for (_, sa, da, _), (_, sb, db, _) in zip(want, got):
        assert abs(float(sa) - float(sb)) <= 0.02 and abs(float(da) - float(db)) <= 0.6


def test_engine_defaults_to_the_card():
    """Without a card, the default device raises rather than running on the
    CPU (core/device.py)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        DeepAcquisitionEngine(FS, L, DeepAcquisitionConfig(total_ms=40), prns=(7,))

"""The CRPA beamformer of the port (ops/beamform.py with its contraction on
device="cpu", signal/array.py) against the JAX package's.

Tolerances, and why: the covariance, the solve and the MUSIC grid are the
same float64 numpy code in both packages, so the weights, the suppression's
inputs and the MUSIC peaks are held equal; the stream contraction is
complex64 in both, with the N products summed in another order than
numpy's matmul, so the beamformed stream is held within 1e-6 relative (L2;
it measures ~4e-7) and the suppression within 1e-3 dB. Array captures are
numpy in both and bit-identical.
"""

import tests._torch_cpu  # noqa: F401  # isort: skip (first: caps torch's threads)

import numpy as np
import pytest

from gypsum_tpu.ops import beamform as jax_beamform
from gypsum_tpu.signal import array as jax_array
from gypsum_tpu.signal.scenarios import DEMO_GPS_START_SOW, demo_constellation
from gypsum_tpu.solve.geodesy import lla_to_ecef
from gypsum_tpu_torch.ops import beamform
from gypsum_tpu_torch.signal import array

FS, L = 2.046e6, 2046
RX = lla_to_ecef(51.5, -0.1, 80.0)
PRNS = [25, 28, 31, 32]


def _unit_scene(jammer: bool):
    """tests/test_beamform.py:39-56's 4-element, 60 000-sample scene: noise
    and, with ``jammer``, a 20 dB broadband jammer from (120, 8) deg."""
    rng = np.random.default_rng(5)
    n, t = 4, 60_000
    noise = (rng.standard_normal((n, t)) + 1j * rng.standard_normal((n, t))) / np.sqrt(2)
    if not jammer:
        return noise.astype(np.complex64)
    jam = (rng.standard_normal(t) + 1j * rng.standard_normal(t)) / np.sqrt(2) * 10.0
    u = array.direction_enu(120.0, 8.0)
    steer = np.exp(2j * np.pi * (array.square_array_enu() @ u) / array.L1_WAVELENGTH_M)
    return (noise + steer[:, None] * jam[None, :]).astype(np.complex64)


@pytest.mark.parametrize("jammer", [True, False], ids=["jammed", "no_jammer"])
def test_null_jammers_matches_jax(jammer):
    x = _unit_scene(jammer)
    y, w, supp = beamform.null_jammers(x, device="cpu")
    y_ref, w_ref, supp_ref = jax_beamform.null_jammers(x)
    assert np.array_equal(w, w_ref)
    assert y.dtype == y_ref.dtype == np.complex64 and y.shape == y_ref.shape
    assert np.linalg.norm(y - y_ref) / np.linalg.norm(y_ref) <= 1e-6
    assert supp == pytest.approx(supp_ref, abs=1e-3)
    if jammer:
        assert supp > 18.0
    else:
        # Transparency: diagonal loading keeps the weights a pass-through.
        assert abs(w[0]) > 0.9 and np.abs(w[1:]).max() < 0.15
        assert abs(supp) < 0.5


def test_contraction_matches_numpy_across_chunks():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((4, 50_003)) + 1j * rng.standard_normal((4, 50_003))).astype(np.complex64)
    w = np.array([1.0, 0.3 + 0.1j, -0.2j, 0.25 - 0.5j])
    want = beamform.apply_weights(x, w, chunk=7_000)
    got = beamform.apply_weights_torch(x, w, "cpu", chunk=7_000)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-6
    assert np.array_equal(want, jax_beamform.apply_weights(x, w, chunk=7_000))


@pytest.fixture(scope="module")
def jammed_array_scene():
    """tests/test_beamform.py:96-104's 1 s scene (broadband jammer of
    amplitude 6 from (135, 5) deg), made by the JAX package."""
    jam = jax_array.ArrayJammer(azimuth_deg=135.0, elevation_deg=5.0, amplitude=6.0,
                                kind="noise", bandwidth_hz=1.2e6)
    arr, truth = jax_array.synthesize_array(
        demo_constellation(PRNS), RX, DEMO_GPS_START_SOW, 1.0, FS, noise_sigma=0.3, jammer=jam)
    return arr, truth


def test_music_peaks_equal_jax(jammed_array_scene):
    arr, _ = jammed_array_scene
    r = beamform.spatial_covariance(arr[:, :65536], diagonal_loading=0.0)
    assert np.array_equal(r, jax_beamform.spatial_covariance(arr[:, :65536], diagonal_loading=0.0))
    peaks = beamform.estimate_doa(r, array.square_array_enu())
    assert peaks == jax_beamform.estimate_doa(r, jax_array.square_array_enu())
    assert len(peaks) == 1 and abs((peaks[0][0] - 135.0 + 180.0) % 360.0 - 180.0) <= 4.0


@pytest.mark.parametrize("kind", ["noise", "cw"])
def test_synthesize_array_is_bit_identical(kind):
    from gypsum_tpu_torch.signal.scenarios import demo_constellation as port_constellation

    kw = dict(noise_sigma=0.3, seed=4)
    jam = dict(azimuth_deg=300.0, elevation_deg=12.0, amplitude=6.0, kind=kind, bandwidth_hz=1.4e6)
    port, port_truth = array.synthesize_array(
        port_constellation(PRNS[:2]), RX, DEMO_GPS_START_SOW, 0.05, FS,
        jammer=array.ArrayJammer(**jam), **kw)
    ref, ref_truth = jax_array.synthesize_array(
        demo_constellation(PRNS[:2]), RX, DEMO_GPS_START_SOW, 0.05, FS,
        jammer=jax_array.ArrayJammer(**jam), **kw)
    assert port.dtype == ref.dtype == np.complex64 and port.shape == (4, 102_300)
    assert port.tobytes() == ref.tobytes()
    assert port_truth.code_phase_samples == ref_truth.code_phase_samples


def test_acquisition_on_the_beamformed_stream_matches_jax(jammed_array_scene):
    """tests/test_beamform.py:107-138: a single element is blind; the port's
    engine on the port's beamformed stream finds what the JAX engine finds
    on the JAX package's, at the scene's truth."""
    from gypsum_tpu.acquire.engine import AcquisitionEngine as JaxEngine
    from gypsum_tpu_torch.acquire.engine import AcquisitionEngine

    arr, truth = jammed_array_scene
    n = 10 * L
    y, _, supp = beamform.null_jammers(arr, device="cpu")
    y_ref, _, supp_ref = jax_beamform.null_jammers(arr)
    assert supp > 15.0 and supp == pytest.approx(supp_ref, abs=1e-3)
    port = AcquisitionEngine(FS, L, device="cpu").detect(y[:n].reshape(10, L))
    ref = JaxEngine(FS, L).detect(y_ref[:n].reshape(10, L))
    assert [(h.prn, h.code_phase_samples) for h in port] == [(h.prn, h.code_phase_samples) for h in ref]
    hits = {h.prn: h for h in port}
    for p in PRNS:
        assert abs(hits[p].doppler_hz - truth.doppler_hz[p]) < 10.0
    for a, b in zip(port, ref):
        assert abs(a.doppler_hz - b.doppler_hz) < 0.5
        assert a.strength == pytest.approx(b.strength, rel=1e-3)

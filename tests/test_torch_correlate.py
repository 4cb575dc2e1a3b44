"""ops/correlate.py and core/planes.py of the port against the JAX package.

Inputs are made with seeded numpy and given to both. Tolerances: the FFTs
and sums run in float32 in another order on each side, so correlation
profiles agree to a relative 1e-4 of each profile's maximum; the wipeoff
phasors are built by the same float32 operations and agree to a few ulp.
"""

import tests._torch_cpu  # noqa: F401  # isort: skip (first: caps torch's threads)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gypsum_tpu.core import planes as jplanes
from gypsum_tpu.ops import correlate as jcorr
from gypsum_tpu.signal.prn import replica_table
from gypsum_tpu.signal.synth import SyntheticSatellite, synthesize_iq
from gypsum_tpu_torch.core import planes as tplanes
from gypsum_tpu_torch.ops import correlate as tcorr

FS, L = 2.046e6, 2046
PRNS = (3, 11, 20, 25)


@pytest.fixture(scope="module")
def block():
    sats = [
        SyntheticSatellite(prn=3, doppler_hz=1250.0, delay_samples=100, amplitude=0.3),
        SyntheticSatellite(prn=11, doppler_hz=-2100.0, delay_samples=900, amplitude=0.3),
        SyntheticSatellite(prn=25, doppler_hz=-3400.0, delay_samples=2000, amplitude=0.3),
    ]
    return synthesize_iq(sats, 10 * L, FS, noise_sigma=0.35, seed=21).reshape(10, L)


DOPPLERS = np.arange(-7000.0, 7000.0 + 1e-6, 500.0).astype(np.float32)  # 29 bins


def test_doppler_wipeoff_matches_jax(block):
    a = np.asarray(jcorr.doppler_wipeoff(jnp.asarray(block), jnp.asarray(DOPPLERS), FS))
    b = tcorr.doppler_wipeoff(torch.from_numpy(block), torch.from_numpy(DOPPLERS), FS).numpy()
    assert b.shape == (29, 10, L)
    # Same float32 phase arithmetic on both sides; cos/sin differ by ulps.
    np.testing.assert_allclose(b, a, atol=1e-5 * np.abs(a).max())


def test_noncoherent_sweep_matches_jax(block):
    reps = replica_table(L, PRNS)
    fft_conj = jcorr.replica_fft_conj_table(reps)
    np.testing.assert_array_equal(tcorr.replica_fft_conj_table(reps), fft_conj)
    a = np.asarray(jcorr.noncoherent_acquisition_sweep(
        jnp.asarray(block), jnp.asarray(DOPPLERS), jnp.asarray(fft_conj), FS))
    b = tcorr.noncoherent_acquisition_sweep(
        torch.from_numpy(block), torch.from_numpy(DOPPLERS), torch.from_numpy(fft_conj), FS
    ).numpy()
    assert b.shape == (len(PRNS), 29, L)
    scale = a.max(axis=-1, keepdims=True)
    assert np.all(np.abs(b - a) <= 1e-4 * scale)
    # The detected peaks (satellites present) land on the same grid cells.
    for s in (0, 1, 3):
        assert np.argmax(a[s]) == np.argmax(b[s])


def test_peak_strength_matches_jax(rng):
    x = rng.random((4, 29, L)).astype(np.float32)
    a = np.asarray(jcorr.peak_strength(jnp.asarray(x)))
    b = tcorr.peak_strength(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-5)  # float32 sums, other order


@pytest.mark.parametrize("code_phase", [0, 7, 1023, 2045])
def test_lag_window_correlate_matches_jax(rng, code_phase):
    rep = replica_table(L, (9,))[0]
    tiled = np.concatenate([rep, rep]).astype(np.float32)
    x = (rng.standard_normal(L) + 1j * rng.standard_normal(L)).astype(np.complex64)
    wa = np.asarray(jcorr.rolled_lag_window(jnp.asarray(tiled), jnp.int32(code_phase), 4, L))
    wb = tcorr.rolled_lag_window(torch.from_numpy(tiled), code_phase, 4, L).numpy()
    np.testing.assert_array_equal(wb, wa)
    a = np.asarray(jcorr.lag_window_correlate(jnp.asarray(x), jnp.asarray(tiled), jnp.int32(code_phase), 4))
    b = tcorr.lag_window_correlate(torch.from_numpy(x), torch.from_numpy(tiled), code_phase, 4).numpy()
    np.testing.assert_allclose(b, a, atol=1e-4 * np.abs(a).max())  # 2046-term sums


def test_circular_correlate_matches_jax(rng):
    reps = replica_table(L, PRNS)
    fft_conj = jcorr.replica_fft_conj_table(reps)
    x = (rng.standard_normal((3, L)) + 1j * rng.standard_normal((3, L))).astype(np.complex64)
    a = np.asarray(jcorr.circular_correlate(jnp.asarray(x)[:, None, :], jnp.asarray(fft_conj)))
    b = tcorr.circular_correlate(torch.from_numpy(x)[:, None, :], torch.from_numpy(fft_conj)).numpy()
    np.testing.assert_allclose(b, a, atol=1e-4 * np.abs(a).max())


def test_planes_match_jax(rng):
    z = (rng.standard_normal((5, 7)) + 1j * rng.standard_normal((5, 7))).astype(np.complex64)
    np.testing.assert_array_equal(tplanes.to_planes(z), jplanes.to_planes(z))
    planes = tplanes.to_planes(z)
    np.testing.assert_array_equal(
        tplanes.to_complex(torch.from_numpy(planes)).numpy(),
        np.asarray(jplanes.to_complex(jnp.asarray(planes))),
    )
    np.testing.assert_array_equal(tplanes.to_planes(torch.from_numpy(z)).numpy(), planes)
    words = rng.integers(0, 256, (4, 6, 2)).astype(np.uint8)
    np.testing.assert_array_equal(
        tplanes.dequantize_planes(torch.from_numpy(words), 127.5).numpy(),
        np.asarray(jplanes.dequantize_planes(jnp.asarray(words), 127.5)),
    )

"""The port's decimating front end against the JAX package.

ops/decimate.py (filters, strided convolution, polyphase resampler),
ops/fir_decimate.py (K5: on the CPU its plain version) and
io/sources.py:DecimatingSampleSource, fed the same numpy inputs made from a
seed. Tolerances: rtol 1e-4 / atol 1e-5 for integer decimation (the bar of
tests/test_decimate.py; float32 sums of 33..97 terms in another order), and
rtol 1e-3 / atol 1e-4 for rational ratios (that file's bar for them: the
filter's gain is ``up``, so the terms are larger).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gypsum_tpu.core.planes import to_planes
from gypsum_tpu.io.sources import ArraySampleSource as JaxArraySource
from gypsum_tpu.io.sources import DecimatingSampleSource as JaxDecimatingSource
from gypsum_tpu.ops import decimate as jdec
from gypsum_tpu.ops.pallas_kernels import fir_decimate_pallas
from gypsum_tpu.signal.synth import SyntheticSatellite, synthesize_iq
from gypsum_tpu_torch.io.sources import ArraySampleSource, DecimatingSampleSource
from gypsum_tpu_torch.ops import decimate as tdec
from gypsum_tpu_torch.ops.fir_decimate import (
    FIR_DECIMATE_KERNEL,
    fir_decimate,
    fir_decimate_cuda,
    fir_decimate_reference,
)


def _noise(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)


def test_filters_equal_the_jax_package():
    for factor in (2, 4, 8, 5):
        np.testing.assert_array_equal(tdec.decimation_filter(factor), jdec.decimation_filter(factor))
    np.testing.assert_array_equal(tdec.rational_filter(1023, 5000), jdec.rational_filter(1023, 5000))
    np.testing.assert_array_equal(tdec.rational_filter(3, 7, 6), jdec.rational_filter(3, 7, 6))
    np.testing.assert_array_equal(tdec.design_lowpass(120, 0.25), jdec.design_lowpass(120, 0.25))


@pytest.mark.parametrize("factor,n", [(2, 9_001), (4, 40_000), (8, 16_384), (5, 12_345)])
def test_fir_decimate_matches_jax_and_the_tpu_kernel(factor, n):
    taps = tdec.decimation_filter(factor)
    x = _noise(n, factor)
    planes = to_planes(x)
    before = FIR_DECIMATE_KERNEL.launches
    want = np.asarray(jdec.fir_decimate_planes(jnp.asarray(planes), jnp.asarray(taps), factor))
    got = tdec.fir_decimate_planes(torch.from_numpy(planes), torch.from_numpy(taps), factor).numpy()
    assert got.shape == want.shape == ((n - len(taps)) // factor + 1, 2)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # K5's wrapper (its plain version on a CPU tensor), planes and complex in,
    # against the TPU kernel in interpret mode.
    pallas = np.asarray(fir_decimate_pallas(x, taps, factor))
    for arg in (torch.from_numpy(planes), torch.from_numpy(x)):
        k5 = fir_decimate(arg, torch.from_numpy(taps), factor).numpy()
        np.testing.assert_allclose(k5, pallas, rtol=1e-4, atol=1e-5)
    assert FIR_DECIMATE_KERNEL.launches == before  # a CPU tensor launches no kernel


def test_taps_run_as_the_convolution_oracle_says():
    """An asymmetric filter shows the direction: a correlation with the taps
    as given (tests/test_decimate.py:_upfirdn_oracle), as in the JAX package."""
    x = _noise(500, 1)
    taps = np.linspace(0.1, 1.0, 13).astype(np.float32)
    got = fir_decimate_reference(torch.from_numpy(to_planes(x)), torch.from_numpy(taps), 3).numpy()
    want = np.array([np.dot(taps, x[m * 3 : m * 3 + 13]) for m in range(got.shape[0])])
    np.testing.assert_allclose(got[:, 0] + 1j * got[:, 1], want, rtol=1e-4, atol=1e-5)
    jax_out = np.asarray(jdec.fir_decimate_planes(jnp.asarray(to_planes(x)), jnp.asarray(taps), 3))
    np.testing.assert_allclose(got, jax_out, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("up,down,n,tpp", [(3, 7, 800, 6), (1023, 5000, 30_000, 10), (2, 3, 1001, 4)])
def test_resample_rational_matches_jax(up, down, n, tpp):
    taps = tdec.rational_filter(up, down, taps_per_phase=tpp)
    planes = to_planes(_noise(n, up))
    want = np.asarray(jdec.resample_rational_planes(jnp.asarray(planes), jnp.asarray(taps), up, down))
    got = tdec.resample_rational_planes(torch.from_numpy(planes), torch.from_numpy(taps), up, down).numpy()
    assert got.shape == want.shape == (tdec.valid_length(n, len(taps), up, down), 2)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_short_signal_and_bad_arguments_raise():
    taps = torch.from_numpy(tdec.decimation_filter(4))
    with pytest.raises(ValueError, match="shorter than filter"):
        fir_decimate(torch.zeros((len(taps) - 1, 2)), taps, 4)
    with pytest.raises(ValueError, match="shorter than filter"):
        tdec.resample_rational_planes(torch.zeros((3, 2)), taps, 3, 7)
    with pytest.raises(ValueError, match=r"\[N, 2\]"):
        tdec.fir_decimate_planes(torch.zeros((100, 3)), taps, 4)
    # N == T is the shortest signal: one output.
    assert fir_decimate(torch.ones((len(taps), 2)), taps, 4).shape == (1, 2)
    # The kernel's own entry takes CUDA tensors only.
    with pytest.raises(ValueError, match="CUDA tensor"):
        fir_decimate_cuda(torch.zeros((100, 2)), taps, 4)


@pytest.mark.parametrize("fs_in,ratio,block_ms", [(8.184e6, (1, 4), 3), (10e6, (1023, 5000), 2)])
def test_streaming_source_matches_jax_block_by_block(fs_in, ratio, block_ms):
    """The JAX source's taps are passed across; three blocks each."""
    n_ms = 3 * block_ms + 2
    x = _noise(int(n_ms * fs_in / 1000), 12)
    jsrc = JaxDecimatingSource(JaxArraySource(x, fs_in), 2.046e6)
    tsrc = DecimatingSampleSource(ArraySampleSource(x, fs_in), 2.046e6, taps=jsrc.taps, device="cpu")
    assert (tsrc.up, tsrc.down) == (jsrc.up, jsrc.down) == ratio
    assert tsrc.attributes.samples_per_prn == 2046
    rtol, atol = (1e-4, 1e-5) if ratio[0] == 1 else (1e-3, 1e-4)
    for _ in range(3):
        ts_j, want = jsrc.read_block(block_ms)
        peeked = tsrc.peek_block(block_ms)[1]
        ts_t, got = tsrc.read_block(block_ms)
        assert ts_t == ts_j and got.shape == want.shape == (block_ms, 2046)
        assert got.dtype == np.complex64
        np.testing.assert_array_equal(peeked, got)
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    assert tsrc.seconds_consumed == jsrc.seconds_consumed
    # Default taps are the JAX source's too.
    np.testing.assert_array_equal(
        DecimatingSampleSource(ArraySampleSource(x, fs_in), 2.046e6, device="cpu").taps, jsrc.taps)


@pytest.mark.parametrize("fs_in,prn,doppler,delay,seed", [
    (8.184e6, 13, 2100.0, 1600.0, 6),
    (10e6, 21, -1500.0, 5000.0, 7),
])
def test_acquisition_after_decimation(fs_in, prn, doppler, delay, seed):
    """tests/test_decimate.py's acquisition scenes through the port's source
    and engine: the planted satellite dominates, and for the integer ratio
    the code phase shifts by the filter's group delay."""
    from gypsum_tpu_torch.acquire.engine import AcquisitionEngine

    spp = int(fs_in / 1000)
    truth = SyntheticSatellite(prn=prn, doppler_hz=doppler, delay_samples=delay, amplitude=0.25)
    iq = synthesize_iq([truth], 11 * spp, fs_in, noise_sigma=0.3 if prn == 13 else 0.25, seed=seed)
    src = DecimatingSampleSource(ArraySampleSource(iq, fs_in), 2.046e6, device="cpu")
    _, block = src.read_block(10)
    assert block.shape == (10, 2046)
    results = AcquisitionEngine(2.046e6, 2046, device="cpu").acquire_all(block)
    assert results[0].prn == prn
    assert results[0].strength > 2.0 * results[1].strength
    assert abs(results[0].doppler_hz - doppler) < 10.0
    if src.up == 1:
        expected_cp = (delay - (len(src.taps) - 1) / 2) / 4 % 2046
        cp_err = abs(results[0].code_phase_samples - expected_cp)
        assert min(cp_err, 2046 - cp_err) <= 1.5


def test_decimated_scene_through_both_receivers():
    """The slice as a whole: a 2 s, two-satellite capture at 4.092 Msps
    through each package's DecimatingSampleSource and Receiver (200 ms
    blocks, float32 phase 1): equal acquisitions and > 99.9 % pseudosymbol
    sign agreement per PRN."""
    import dataclasses

    from gypsum_tpu.core.config import ReceiverConfig as JaxReceiverConfig
    from gypsum_tpu.runtime.receiver import Receiver as JaxReceiver
    from gypsum_tpu_torch.core.config import ReceiverConfig
    from gypsum_tpu_torch.runtime.receiver import Receiver

    fs_in = 4.092e6
    sats = [SyntheticSatellite(prn=9, doppler_hz=800.0, delay_samples=1000.0, amplitude=0.3),
            SyntheticSatellite(prn=21, doppler_hz=-2300.0, delay_samples=3100.0, amplitude=0.3)]
    iq = synthesize_iq(sats, 2001 * 4092, fs_in, noise_sigma=0.3, seed=12)

    def run(receiver_cls, config_cls, source, **kw):
        cfg = config_cls()
        cfg = cfg.replace(tracking=dataclasses.replace(
            cfg.tracking, block_size_ms=200, matmul_tracker_bf16=False))
        recv = receiver_cls(source, cfg, eligible_prns=[9, 21], **kw)
        recv.run()
        acq = [(h.prn, h.code_phase_samples) for r in recv.block_reports for h in r.newly_acquired]
        signs: dict[int, list] = {}
        for r in recv.block_reports:
            for o in r.observations:
                signs.setdefault(o.prn, []).append(np.asarray(o.pseudosymbol_signs))
        return acq, {p: np.concatenate(v) for p, v in signs.items()}

    acq_j, signs_j = run(JaxReceiver, JaxReceiverConfig,
                         JaxDecimatingSource(JaxArraySource(iq, fs_in), 2.046e6))
    acq_t, signs_t = run(Receiver, ReceiverConfig,
                         DecimatingSampleSource(ArraySampleSource(iq, fs_in), 2.046e6, device="cpu"),
                         device="cpu")
    assert acq_t == acq_j and {p for p, _ in acq_t} == {9, 21}
    for prn in (9, 21):
        assert signs_t[prn].shape == signs_j[prn].shape and len(signs_t[prn]) >= 1800
        agree = float(np.mean(signs_t[prn] == signs_j[prn]))
        assert agree > 0.999, f"PRN {prn}: sign agreement {agree:.4%}"

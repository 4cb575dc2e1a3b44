"""The port's decimating front end against the JAX package.

ops/decimate.py (filters, strided convolution, polyphase resampler),
ops/fir_decimate.py (K5: on the CPU its plain version) and
io/sources.py:DecimatingSampleSource, fed the same numpy inputs made from a
seed. Tolerances: rtol 1e-4 / atol 1e-5 for integer decimation (the bar of
tests/test_decimate.py; float32 sums of 33..97 terms in another order), and
rtol 1e-3 / atol 1e-4 for rational ratios (that file's bar for them: the
filter's gain is ``up``, so the terms are larger).
"""

import tests._torch_cpu  # noqa: F401  # isort: skip (first: caps torch's threads)

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
    MAX_SMEM_BYTES,
    OUTPUTS_PER_BLOCK,
    OUTPUTS_PER_THREAD,
    THREADS,
    fir_decimate,
    fir_decimate_cuda,
    fir_decimate_reference,
    launch_plan,
    swizzle,
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
    """An asymmetric filter shows the direction. The source correlates with
    the taps as given (tests/test_decimate.py:_upfirdn_oracle), as the JAX
    package's source does; its plain strided convolution does the same; K5
    convolves (the taps reversed, as the TPU kernel does), so the source
    hands it the taps reversed."""
    x = _noise(3 * 1000 + 40, 1)
    taps = np.linspace(0.1, 1.0, 13).astype(np.float32)
    src = DecimatingSampleSource(ArraySampleSource(x, 3000.0), 1000.0, taps=taps, device="cpu")
    assert (src.up, src.down) == (1, 3)
    got = src.read_block(1000)[1].ravel()  # one output per ms
    # Output k of the first block reads x[3 k + t], t < 13.
    want = np.array([np.dot(taps, x[k * 3 : k * 3 + 13]) for k in range(1000)])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    planes = torch.from_numpy(to_planes(x))
    corr = tdec.fir_decimate_planes(planes, torch.from_numpy(taps), 3).numpy()
    np.testing.assert_allclose(corr[:1000, 0] + 1j * corr[:1000, 1], want, rtol=1e-4, atol=1e-5)
    conv = fir_decimate(planes, torch.from_numpy(taps[::-1].copy()), 3).numpy()
    np.testing.assert_allclose(conv, corr, rtol=1e-4, atol=1e-5)


def test_fir_decimate_matches_the_tpu_kernel_on_asymmetric_taps():
    """K5 computes what fir_decimate_pallas computes, the taps reversed: on
    asymmetric taps a correlation with the taps as given differs by up to
    7.2 on outputs of magnitude up to 8.1."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(5_000) + 1j * rng.standard_normal(5_000)).astype(np.complex64)
    taps = np.linspace(0.1, 1.0, 13).astype(np.float32)
    want = np.asarray(fir_decimate_pallas(x, taps, 3, interpret=True))
    for arg in (torch.from_numpy(to_planes(x)), torch.from_numpy(x)):
        got = fir_decimate(arg, torch.from_numpy(taps), 3).numpy()
        assert got.shape == want.shape == ((5_000 - 13) // 3 + 1, 2)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        fir_decimate_reference(torch.from_numpy(to_planes(x)), torch.from_numpy(taps), 3).numpy(),
        want, rtol=1e-4, atol=1e-5)


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


def test_streaming_source_matches_jax_with_asymmetric_taps():
    """Both packages' sources on an asymmetric filter, block by block: the
    port's source hands K5 the taps reversed, so it still correlates as the
    JAX source does."""
    fs_in, block_ms = 8.184e6, 2
    x = _noise(int((3 * block_ms + 2) * fs_in / 1000), 13)
    taps = np.linspace(0.1, 1.0, 41).astype(np.float32) * np.float32(0.05)
    jsrc = JaxDecimatingSource(JaxArraySource(x, fs_in), 2.046e6, taps=taps)
    tsrc = DecimatingSampleSource(ArraySampleSource(x, fs_in), 2.046e6, taps=taps, device="cpu")
    np.testing.assert_array_equal(tsrc.taps, taps)  # the public taps stay as given
    for _ in range(3):
        ts_j, want = jsrc.read_block(block_ms)
        ts_t, got = tsrc.read_block(block_ms)
        assert ts_t == ts_j and got.shape == want.shape == (block_ms, 2046)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def _emulate_kernel(planes: np.ndarray, taps: np.ndarray, factor: int, width=None) -> np.ndarray:
    """csrc/fir_decimate.cu in numpy, block by block, from its launch plan:
    the taps staged reversed by phase, each row element copied to the word
    the kernel computes (its stepping of (m, k) included), each thread's
    window read through the swizzle, and every word it reads written first
    (shared memory starts as NaN). Sums in float64: this checks the layout
    and the indices, not the rounding. Also checks the banks the kernel's
    design claims: its window loads are conflict-free, and so are the
    staging stores of factors 2, 4 and 8."""
    plan = launch_plan(len(taps), factor, width)
    w_, n_taps, pitch, group = plan.width, plan.taps_per_phase, plan.pitch, plan.group
    n_in, t_len = len(planes), len(taps)
    n_out = (n_in - t_len) // factor + 1
    cols = OUTPUTS_PER_BLOCK + n_taps - 1
    lanes = 8 if w_ == 2 else 16  # elements of one 128-byte wavefront
    phys = np.array([swizzle(m, w_) for m in range(cols)])
    assert len(np.unique(phys)) == cols and phys.max() < pitch
    tid = np.arange(THREADS)
    for j in range(n_taps + OUTPUTS_PER_THREAD - 1):  # element 8 i + j of each lane
        banks = (phys[OUTPUTS_PER_THREAD * tid + j] % lanes).reshape(-1, lanes)
        assert all(len(set(b)) == lanes for b in banks)
    tap_words = -(-(group * n_taps) // 4) * 4
    assert plan.smem_bytes == 4 * tap_words + group // w_ * pitch * 8 * w_
    y = np.full((n_out, 2), np.nan)
    for n0 in range(0, n_out, OUTPUTS_PER_BLOCK):
        n = n0 + tid[:, None] * OUTPUTS_PER_THREAD + np.arange(OUTPUTS_PER_THREAD)
        keep = n < n_out
        acc = np.zeros((2, THREADS, OUTPUTS_PER_THREAD))
        for q0 in range(0, factor, group):
            kw = min(group, factor - q0) // w_
            smem = np.full(plan.smem_bytes // 4, np.nan)
            e = np.arange(kw * n_taps * w_)
            kp = e // w_
            k = kp // n_taps
            s = (kp - k * n_taps) * factor + q0 + w_ * k + (e - kp * w_)
            smem[e] = np.where(s < t_len, taps[np.clip(t_len - 1 - s, 0, None)], 0.0)
            # The kernel's stepping: thread t starts at divmod(t, kw) and adds
            # divmod(THREADS, kw) with a carry.
            dm, dk = divmod(THREADS, kw)
            m, k = tid // kw, tid % kw
            for e0 in range(0, cols * kw, THREADS):
                live = e0 + tid < cols * kw
                assert np.array_equal((m * kw + k)[live], (e0 + tid)[live])
                elem = k[live] * pitch + phys[m[live]]  # in elements of 8 w_ bytes
                if factor in (2, 4, 8) and live.all():
                    assert all(len(set(b)) == lanes for b in (elem % lanes).reshape(-1, lanes))
                for j in range(w_):
                    idx = (n0 + m[live]) * factor + q0 + w_ * k[live] + j
                    val = np.where((idx < n_in)[:, None], planes[np.minimum(idx, n_in - 1)], 0.0)
                    smem[tap_words + elem * 2 * w_ + 2 * j] = val[:, 0]
                    smem[tap_words + elem * 2 * w_ + 2 * j + 1] = val[:, 1]
                m, k = m + dm, k + dk
                m, k = np.where(k >= kw, m + 1, m), np.where(k >= kw, k - kw, k)
            for r in range(kw):
                h = smem[r * n_taps * w_ : (r + 1) * n_taps * w_].reshape(n_taps, w_)
                row = smem[tap_words + r * pitch * 2 * w_ :][: pitch * 2 * w_].reshape(pitch, 2 * w_)
                # Output o of thread i reads element 8 i + o + p at tap p.
                mm = (OUTPUTS_PER_THREAD * tid[:, None, None]
                      + np.arange(OUTPUTS_PER_THREAD)[None, :, None] + np.arange(n_taps))
                window = row[phys[mm]]  # [THREADS, 8, P, 2 w_]
                assert not np.isnan(window).any()
                acc[0] += np.einsum("iopj,pj->io", window[..., 0::2], h)
                acc[1] += np.einsum("iopj,pj->io", window[..., 1::2], h)
        assert np.isnan(y[n[keep]]).all()  # every output is stored once
        y[n[keep], 0] = acc[0][keep]
        y[n[keep], 1] = acc[1][keep]
    return y


@pytest.mark.parametrize("n,factor,taps,width", [
    (5_000, 3, "asymmetric", None),
    (20_003, 8, "default", None),
    (12_345, 4, "default", None),
    (12_345, 4, "default", 2),  # two-phase rows at factor 4
    (4_099, 8, "default", 1),  # the one-phase rows a view off 16-byte alignment gets
    (9_001, 1, "short", None),
    (3_000, 5, "default", None),
    (1441 + 120 * 1100, 120, "default", None),  # 15 groups of 8 phases
    (8383 + 66 * 1030, 66, "tpp127", None),  # 128 taps per phase: 11 groups of 6
])
def test_the_kernels_layout_computes_the_function(n, factor, taps, width):
    """The kernel's plan and shared-memory layout, emulated in numpy, against
    the plain version, over ragged last blocks and groups of phases."""
    h = {"asymmetric": np.linspace(0.1, 1.0, 13),
         "default": tdec.decimation_filter(factor),
         "short": np.array([0.5, -0.25, 1.0, 0.125, 0.3]),
         "tpp127": tdec.decimation_filter(factor, taps_per_phase=127)}[taps].astype(np.float32)
    planes = to_planes(_noise(n, factor))
    want = fir_decimate_reference(torch.from_numpy(planes), torch.from_numpy(h), factor).numpy()
    got = _emulate_kernel(planes.astype(np.float64), h.astype(np.float64), factor, width)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * max(1.0, scale))


def test_launch_plan_takes_every_filter_the_tpu_kernel_takes():
    """Factors 1-160 against 1-128 taps per phase (the shortest and longest
    filter of each): every plan fits the shared memory of a Hopper block and
    keeps the kernel's layout rules; 129 taps per phase raise, as in the TPU
    kernel (gypsum_tpu/ops/pallas_kernels.py:160)."""
    for factor in range(1, 161):
        for tpp in range(1, 129):
            for t_len in {(tpp - 1) * factor + 1, tpp * factor}:
                for width in {1, 2 if factor % 2 == 0 else 1}:
                    plan = launch_plan(t_len, factor, width)
                    cols = OUTPUTS_PER_BLOCK + tpp - 1
                    assert plan.taps_per_phase == tpp and plan.width == width
                    assert plan.smem_bytes <= MAX_SMEM_BYTES
                    assert plan.smem_bytes == (4 * -(-(plan.group * tpp) // 4) * 4
                                               + plan.group // width * plan.pitch * 8 * width)
                    assert width <= plan.group <= factor and plan.group % width == 0
                    # Every swizzled element of a row lies within its pitch.
                    assert plan.pitch >= -(-cols // 8) * 8
        with pytest.raises(ValueError, match="taps per phase"):
            launch_plan(128 * factor + 1, factor)
    # The plain version holds the kernel's limit too.
    with pytest.raises(ValueError, match="taps per phase"):
        fir_decimate(torch.zeros((2_000, 2)), torch.ones(129 * 3), 3)
    assert fir_decimate(torch.zeros((2_000, 2)), torch.ones(128 * 3), 3).shape == (
        (2_000 - 384) // 3 + 1, 2)


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

"""The port's per-ms scan tracker (track/scan.py) and K4's plain version
(ops/wipeoff_lag.py) against the JAX package.

The scan is held against gypsum_tpu.track.loop.make_track_block_fn with
``use_matmul_tracker=False, use_pallas_block_tracker=False`` on the same
seeded block. Tolerance: 1e-3 of each field's scale (the bar of
tests/test_torch_tracker.py: float32 sums of 2046 terms in another order and
another library's cos/sin, integrated over a 48 ms pull-in);
locked/lost/step_count exact. K4's plain version is held against the TPU
kernel in interpret mode at 1e-4 of the correlation scale (same float32
phase arithmetic on both sides, another sum order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gypsum_tpu.core.config import TrackingConfig as JaxTrackingConfig
from gypsum_tpu.core.planes import to_planes
from gypsum_tpu.ops.pallas_kernels import wipeoff_lag_correlate_pallas
from gypsum_tpu.signal.prn import replica_table
from gypsum_tpu.signal.synth import SyntheticSatellite, synthesize_iq
from gypsum_tpu.track.loop import fresh_state
from gypsum_tpu.track.loop import make_track_block_fn as jax_track_block_fn
from gypsum_tpu_torch.core.config import TrackingConfig
from gypsum_tpu_torch.ops.wipeoff_lag import (
    WIPEOFF_LAG_KERNEL,
    lag_segments,
    lag_split,
    wipeoff_lag_correlate,
    wipeoff_lag_cuda,
    wipeoff_lag_reference,
    wipeoff_lag_segmented,
)
from gypsum_tpu_torch.track.loop import make_track_block_fn

FS, L = 2.046e6, 2046
SCAN = dict(use_matmul_tracker=False, use_pallas_block_tracker=False)


def _wide(k_half=4):
    reps = replica_table(L)
    return np.concatenate([reps, reps, reps[:, : 2 * k_half]], axis=1).astype(np.float32)


def _close(b, a, what, rel=1e-3):
    np.testing.assert_allclose(b, a, atol=rel * max(1.0, float(np.abs(a).max())), err_msg=what)


def _compare(ts, to, js, jo):
    for name in ("code_phase", "carrier_phase", "doppler", "carrier_offset", "ema_err",
                 "ema_err_sq", "ema_quality"):
        _close(np.asarray(getattr(ts, name)).ravel(), np.asarray(getattr(js, name)).ravel(), name)
    np.testing.assert_array_equal(np.asarray(ts.step_count).ravel(), np.asarray(js.step_count).ravel())
    np.testing.assert_array_equal(np.asarray(ts.lost).ravel(), np.asarray(js.lost).ravel())
    for name in ("prompt_i", "prompt_q", "code_phase", "code_phase_measured", "doppler",
                 "carrier_phase", "pll_error", "dll_error", "quality"):
        _close(np.asarray(getattr(to, name)), np.asarray(getattr(jo, name)), name)
    np.testing.assert_array_equal(np.asarray(to.locked), np.asarray(jo.locked))
    np.testing.assert_array_equal(np.asarray(to.lost), np.asarray(jo.lost))


@pytest.mark.parametrize("name,kw,offset_hz", [
    ("hoisted", {}, 0.0),
    ("per_ms", {"hoist_lag_window": False}, 0.0),
    ("hoisted_hrc", {"code_phase_measurement": "hrc"}, 0.0),
    ("per_ms_hrc", {"hoist_lag_window": False, "code_phase_measurement": "hrc"}, 0.0),
    ("hoisted_carrier_offset", {}, 12000.0),
    ("per_ms_carrier_offset", {"hoist_lag_window": False}, 12000.0),
    ("hoisted_margin_3", {"lag_window_block_margin": 3}, 0.0),
])
def test_scan_matches_jax_scan(name, kw, offset_hz):
    S, B = 4, 48
    sat = SyntheticSatellite(prn=9, doppler_hz=700.0 + offset_hz, delay_samples=100, amplitude=0.3)
    iq = synthesize_iq([sat], B * L, FS, noise_sigma=0.2, seed=9).reshape(B, L)
    replicas = np.tile(_wide()[8][None, :], (S, 1))
    st = fresh_state(S)
    st = st._replace(doppler=st.doppler + 700.0, code_phase=st.code_phase + 100.0,
                     carrier_offset=st.carrier_offset + np.float32(offset_hz))
    js, jo = jax_track_block_fn(JaxTrackingConfig(block_size_ms=B, **SCAN, **kw), L, FS, S)(
        st, jnp.asarray(to_planes(iq)), jnp.asarray(replicas))
    f = make_track_block_fn(TrackingConfig(block_size_ms=B, **SCAN, **kw), L, FS, S, device="cpu")
    # Complex blocks and float planes are the same input.
    ts, to = f(st, torch.from_numpy(iq), torch.from_numpy(replicas))
    _compare(ts, to, js, jo)
    ts2, outs = f.packed(st, torch.from_numpy(to_planes(iq)), torch.from_numpy(replicas))
    assert outs.shape == (B, 11, S) and outs.dtype == torch.float32
    np.testing.assert_array_equal(outs[:, 0].numpy(), to.prompt_i.numpy())
    # The returned carry feeds straight back in ([S] tensors).
    assert ts.code_phase.shape == (S,) and ts.step_count.dtype == torch.int32
    assert float(np.abs(to.prompt_i.numpy()[-10:]).mean()) > 100.0  # it does track


def test_scan_with_kernel_correlator_matches_jax_per_ms_scan():
    """use_pallas_correlator=True routes each ms through K4's wrapper (its
    plain version on the CPU) and overrides hoist_lag_window; the JAX side
    runs its per-ms XLA correlator, the same function."""
    S, B = 4, 48
    sat = SyntheticSatellite(prn=9, doppler_hz=700.0, delay_samples=100, amplitude=0.3)
    iq = synthesize_iq([sat], B * L, FS, noise_sigma=0.2, seed=9).reshape(B, L)
    replicas = np.tile(_wide()[8][None, :], (S, 1))
    st = fresh_state(S)
    st = st._replace(doppler=st.doppler + 700.0, code_phase=st.code_phase + 100.0)
    js, jo = jax_track_block_fn(
        JaxTrackingConfig(block_size_ms=B, hoist_lag_window=False, **SCAN), L, FS, S)(
        st, jnp.asarray(to_planes(iq)), jnp.asarray(replicas))
    before = WIPEOFF_LAG_KERNEL.launches
    ts, to = make_track_block_fn(
        TrackingConfig(block_size_ms=B, use_pallas_correlator=True, **SCAN), L, FS, S, device="cpu")(
        st, torch.from_numpy(iq), torch.from_numpy(replicas))
    _compare(ts, to, js, jo)
    assert WIPEOFF_LAG_KERNEL.launches == before  # CPU tensors launch no kernel


def test_scan_farm_matches_jax():
    n_streams, ch_per_stream, B = 2, 2, 48
    s_total = n_streams * ch_per_stream
    stream_of_channel = np.repeat(np.arange(n_streams), ch_per_stream).astype(np.int32)
    sats = [SyntheticSatellite(prn=7, doppler_hz=800.0, delay_samples=50, amplitude=0.3),
            SyntheticSatellite(prn=7, doppler_hz=-450.0, delay_samples=900, amplitude=0.3)]
    streams = [synthesize_iq([s], B * L, FS, noise_sigma=0.2, seed=10 + i).reshape(B, L)
               for i, s in enumerate(sats)]
    planes = np.stack([to_planes(s) for s in streams], axis=1)  # [B, N, L, 2]
    replicas = np.tile(_wide()[6][None, :], (s_total, 1))
    st = fresh_state(s_total)._replace(
        doppler=np.array([800.0, 800.0, -450.0, -450.0], dtype=np.float32),
        code_phase=np.array([50.0, 50.0, 900.0, 900.0], dtype=np.float32),
    )
    # A farm ignores use_pallas_correlator and never takes the block kernel.
    kw = dict(block_size_ms=B, use_matmul_tracker=False, use_pallas_correlator=True)
    js, jo = jax_track_block_fn(JaxTrackingConfig(use_pallas_block_tracker=False, **kw), L, FS,
                                s_total, stream_of_channel)(
        st, jnp.asarray(planes), jnp.asarray(replicas))
    ts, to = make_track_block_fn(TrackingConfig(use_pallas_block_tracker=True, **kw), L, FS, s_total,
                                 stream_of_channel, device="cpu")(
        st, torch.from_numpy(planes), torch.from_numpy(replicas))
    _compare(ts, to, js, jo)


def _k4_inputs(seed, s_count, k_half, zero_doppler=False):
    rng = np.random.default_rng(seed)
    replicas = _wide(k_half)[:s_count]
    chunk = (rng.standard_normal(L) + 1j * rng.standard_normal(L)).astype(np.complex64)
    theta = rng.uniform(0, 2 * np.pi, s_count).astype(np.float32)
    doppler = rng.uniform(-5000, 5000, s_count).astype(np.float32)
    cp_int = rng.integers(0, L, s_count).astype(np.int32)
    cp_int[:4] = [0, 1, 1000, 2045]
    if zero_doppler:
        theta[:], doppler[:] = 0.0, 0.0
    base = np.mod(L - cp_int - k_half, L).astype(np.float32)
    params = np.stack([theta, doppler, base], axis=-1).astype(np.float32)
    return np.stack([chunk.real, chunk.imag]), replicas, params, chunk, cp_int


@pytest.mark.parametrize("s_count,k_half,zero_doppler", [(8, 4, False), (4, 2, True), (12, 4, False)])
def test_k4_plain_version_matches_the_tpu_kernel(s_count, k_half, zero_doppler):
    n_lags = 2 * k_half + 1
    chunk_iq, replicas, params, chunk, cp_int = _k4_inputs(3, s_count, k_half, zero_doppler)
    want = np.asarray(wipeoff_lag_correlate_pallas(
        jnp.asarray(chunk_iq), jnp.asarray(replicas), jnp.asarray(params),
        length=L, n_lags=n_lags, inv_fs=1.0 / FS))
    args = (torch.from_numpy(chunk_iq), torch.from_numpy(replicas), torch.from_numpy(params),
            L, n_lags, 1.0 / FS)
    got = wipeoff_lag_reference(*args).numpy()
    assert got.shape == want.shape == (s_count, 2, n_lags)
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())
    np.testing.assert_array_equal(wipeoff_lag_correlate(*args).numpy(), got)
    if zero_doppler:
        # No wipeoff: entry j is the plain correlation at lag cp - K + j.
        for s in range(s_count):
            rep = replicas[s][:L]
            corr = np.array([np.roll(rep, cp_int[s] - k_half + j) @ chunk for j in range(n_lags)])
            np.testing.assert_allclose(got[s, 0], corr.real, rtol=1e-4, atol=1e-3)
            np.testing.assert_allclose(got[s, 1], corr.imag, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("n_split", [1, 8, 16])
@pytest.mark.parametrize("length", [1, 7, 2046, 2047, 4092])
def test_k4_segments_cover_the_ms_exactly_once(length, n_split):
    segments = lag_segments(length, n_split)
    assert len(segments) == n_split
    covered = np.zeros(length, np.int64)
    for start, stop in segments:
        assert 0 <= start <= stop <= length
        covered[start:stop] += 1
    np.testing.assert_array_equal(covered, 1)
    # In block order: each segment begins where the one before it ended.
    assert [a for a, _ in segments[1:]] == [b for _, b in segments[:-1]]


@pytest.mark.parametrize("s_count,want", [(1, 8), (12, 8), (16, 8), (17, 4), (64, 2), (67, 1), (500, 1)])
def test_k4_split_keeps_the_grid_within_one_wave(s_count, want):
    assert lag_split(s_count, 132) == want
    assert lag_split(s_count, 132) * s_count <= max(132, s_count)


@pytest.mark.parametrize("n_split", [1, 2, 8])
@pytest.mark.parametrize("s_count,k_half", [(8, 4), (12, 16), (4, 0)])
def test_k4_plain_version_summed_by_segments(s_count, k_half, n_split):
    """The kernel's sum order (one partial sum per block, added in block
    order) on the plain version's terms: within 1e-6 of scale of the unsplit
    plain version, and within the file's bar of the TPU kernel."""
    n_lags = 2 * k_half + 1
    chunk_iq, replicas, params, _, _ = _k4_inputs(5, s_count, k_half)
    args = (torch.from_numpy(chunk_iq), torch.from_numpy(replicas), torch.from_numpy(params),
            L, n_lags, 1.0 / FS)
    whole = wipeoff_lag_reference(*args).numpy()
    split = wipeoff_lag_segmented(*args, n_split).numpy()
    assert split.shape == whole.shape == (s_count, 2, n_lags)
    np.testing.assert_allclose(split, whole, atol=1e-6 * np.abs(whole).max())
    want = np.asarray(wipeoff_lag_correlate_pallas(
        jnp.asarray(chunk_iq), jnp.asarray(replicas), jnp.asarray(params),
        length=L, n_lags=n_lags, inv_fs=1.0 / FS))
    np.testing.assert_allclose(split, want, atol=1e-4 * np.abs(want).max())


def test_scan_with_kernel_correlator_takes_planes_once_per_block(monkeypatch):
    """On the kernel route the scan lays the block's planes out once and
    hands the wrapper a contiguous [2, L] view per ms, for complex blocks and
    for [B, L, 2] planes alike."""
    from gypsum_tpu_torch.track import scan

    S, B = 2, 3
    rng = np.random.default_rng(2)
    iq = (rng.standard_normal((B, L)) + 1j * rng.standard_normal((B, L))).astype(np.complex64)
    replicas = np.tile(_wide()[8][None, :], (S, 1))
    seen = []

    def spy(chunk, *args):
        seen.append(chunk)
        return wipeoff_lag_correlate(chunk, *args)

    monkeypatch.setattr(scan, "wipeoff_lag_correlate", spy)
    f = make_track_block_fn(
        TrackingConfig(block_size_ms=B, use_pallas_correlator=True, **SCAN), L, FS, S, device="cpu")
    outs = []
    for block in (torch.from_numpy(iq), torch.from_numpy(to_planes(iq))):
        seen.clear()
        outs.append(f.packed(fresh_state(S), block, torch.from_numpy(replicas))[1])
        assert len(seen) == B
        for b, chunk in enumerate(seen):
            assert chunk.shape == (2, L) and chunk.is_contiguous()
            np.testing.assert_array_equal(chunk[0].numpy(), iq[b].real)
            np.testing.assert_array_equal(chunk[1].numpy(), iq[b].imag)
        # One [B, 2, L] buffer: the views share their storage.
        assert len({chunk.untyped_storage().data_ptr() for chunk in seen}) == 1
    assert torch.equal(outs[0], outs[1])


def test_k4_rejects_bad_shapes():
    chunk_iq, replicas, params, _, _ = _k4_inputs(1, 4, 4)
    t = lambda a: torch.from_numpy(a)
    with pytest.raises(ValueError, match="chunk_iq"):
        wipeoff_lag_reference(t(chunk_iq[:, :100]), t(replicas), t(params), L, 9, 1.0 / FS)
    with pytest.raises(ValueError, match="2L \\+ 2K"):
        wipeoff_lag_reference(t(chunk_iq), t(replicas[:, : 2 * L]), t(params), L, 9, 1.0 / FS)
    with pytest.raises(ValueError, match="odd"):
        wipeoff_lag_reference(t(chunk_iq), t(replicas), t(params), L, 8, 1.0 / FS)
    with pytest.raises(ValueError, match="CUDA tensor"):
        wipeoff_lag_cuda(t(chunk_iq), t(replicas), t(params), L, 9, 1.0 / FS)
    # The kernel route's one combined check raises the single checks' errors.
    with pytest.raises(ValueError, match="chunk_iq"):
        wipeoff_lag_cuda(t(chunk_iq[:, :100]), t(replicas), t(params), L, 9, 1.0 / FS)
    with pytest.raises(ValueError, match="odd"):
        wipeoff_lag_cuda(t(chunk_iq), t(replicas), t(params), L, 8, 1.0 / FS)
    with pytest.raises(ValueError, match="params \\[S, 3\\]"):
        wipeoff_lag_cuda(t(chunk_iq), t(replicas), t(params[:, :2]), L, 9, 1.0 / FS)

"""K3's plain version (ops/track_block.py) and its wrapper in track/loop.py
against the JAX package's whole-block Pallas tracker in interpret mode.

Tolerances are the JAX package's own for this kernel against its scan
(tests/test_pallas_block_tracker.py): 2e-3 of scale on the carry, 5e-3 of
scale on the per-ms outputs (the multiply-reduce over 2046 samples sums in
another order, and the pull-in integrates the difference);
locked/lost/step_count exact.
"""

import tests._torch_cpu  # noqa: F401  # isort: skip (first: caps torch's threads)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gypsum_tpu.core.config import TrackingConfig as JaxTrackingConfig
from gypsum_tpu.core.planes import to_planes
from gypsum_tpu.ops import pallas_track as pt
from gypsum_tpu.signal.prn import replica_table
from gypsum_tpu.signal.synth import SyntheticSatellite, synthesize_iq
from gypsum_tpu.track.loop import TrackerBank as JaxBank
from gypsum_tpu.track.loop import fresh_state
from gypsum_tpu.track.loop import make_track_block_fn as jax_track_block_fn
from gypsum_tpu_torch.core.config import TrackingConfig
from gypsum_tpu_torch.ops import fixup as fx
from gypsum_tpu_torch.ops import track_block as tb
from gypsum_tpu_torch.track.loop import TrackerBank, make_track_block_fn

FS, L = 2.046e6, 2046


def _replicas(prn, n_channels):
    reps = replica_table(L)
    k = TrackingConfig().lag_window_half_width
    wide = np.concatenate([reps, reps, reps[:, : 2 * k]], axis=1).astype(np.float32)
    return np.tile(wide[prn - 1][None, :], (n_channels, 1))


def _state_rows(s_count, doppler, code_phase, step=0.0):
    rows = np.zeros((tb.N_CARRY, s_count), dtype=np.float32)
    rows[fx.CP] = code_phase + 0.25 * np.arange(s_count)
    rows[fx.TH] = 0.3 * np.arange(s_count)
    rows[fx.FD] = doppler + 2.0 * np.arange(s_count)
    rows[fx.STEP] = step
    rows[fx.EQ] = 0.95 if step else 0.0  # a warmed-up carry has a quality EMA
    return rows


@pytest.mark.parametrize("s_count,b_ms,prn,doppler,delay,margin,seed,noise,step", [
    (8, 48, 9, 700.0, 100, 10, 9, 0.2, 0.0),
    (4, 120, 3, 6800.0, 900, None, 21, 0.15, 0.0),
    # A carry that starts warmed up, so lock decisions are exercised.
    (4, 48, 9, 700.0, 100, 10, 9, 0.2, 400.0),
])
def test_plain_version_matches_the_tpu_kernel(s_count, b_ms, prn, doppler, delay, margin, seed, noise, step):
    sat = SyntheticSatellite(prn=prn, doppler_hz=doppler, delay_samples=delay, amplitude=0.3)
    planes = to_planes(synthesize_iq([sat], b_ms * L, FS, noise_sigma=noise, seed=seed).reshape(b_ms, L))
    replicas = _replicas(prn, s_count)
    rows = _state_rows(s_count, doppler, float(delay), step)
    kw = dict(block_size_ms=b_ms, lag_window_block_margin=margin)

    fin_j, outs_j = pt.make_pallas_track_block_fn(JaxTrackingConfig(**kw), L, FS, s_count)(
        jnp.asarray(rows), jnp.asarray(planes), jnp.asarray(replicas))
    fin_j, outs_j = np.asarray(fin_j), np.asarray(outs_j)[:, : fx.N_OUT]

    params = tb.TrackBlockParams.from_config(TrackingConfig(**kw), L, FS)
    args = (torch.from_numpy(rows), torch.from_numpy(planes), torch.from_numpy(replicas), params)
    fin_t, outs_t = tb.track_block_reference(*args)
    assert fin_t.shape == (tb.N_CARRY, s_count) and outs_t.shape == (b_ms, fx.N_OUT, s_count)
    fin_t, outs_t = fin_t.numpy(), outs_t.numpy()

    for row in (fx.STEP, fx.LOST, fx.CPI0):
        np.testing.assert_array_equal(fin_t[row], fin_j[row])
    for row in (fx.CP, fx.TH, fx.FD, fx.EERR, fx.EERR2, fx.EQ):
        scale = max(1.0, float(np.abs(fin_j[row]).max()))
        np.testing.assert_allclose(fin_t[row], fin_j[row], atol=2e-3 * scale, err_msg=f"carry row {row}")
    for row in (fx.O_LOCKED, fx.O_LOST):
        np.testing.assert_array_equal(outs_t[:, row], outs_j[:, row])
    for row in range(fx.N_OUT):
        scale = max(1.0, float(np.abs(outs_j[:, row]).max()))
        np.testing.assert_allclose(outs_t[:, row], outs_j[:, row], atol=5e-3 * scale,
                                   err_msg=f"output row {row}")
    assert np.abs(outs_t[-10:, fx.O_PI]).mean() > 100.0  # the prompt is held to block end
    if step:
        assert outs_t[:, fx.O_LOCKED].any()
    # The wrapper runs the plain version on CPU tensors and launches nothing.
    before = tb.TRACK_BLOCK_KERNEL.launches
    fin_w, outs_w = tb.track_block(*args)
    np.testing.assert_allclose(outs_w.numpy(), outs_t, rtol=1e-4, atol=1e-2)
    assert tb.TRACK_BLOCK_KERNEL.launches == before


def test_block_tracker_through_make_track_block_fn_matches_jax():
    """TrackState in and out, as track/loop.py adapts the kernel; the block
    length comes from the samples (40 ms here), not from block_size_ms."""
    S, B = 4, 40
    sat = SyntheticSatellite(prn=9, doppler_hz=700.0, delay_samples=100, amplitude=0.3)
    iq = synthesize_iq([sat], B * L, FS, noise_sigma=0.2, seed=9).reshape(B, L)
    replicas = _replicas(9, S)
    st = fresh_state(S)
    st = st._replace(doppler=st.doppler + 700.0, code_phase=st.code_phase + 100.0)
    kw = dict(block_size_ms=48, use_pallas_block_tracker=True, lag_window_block_margin=10)
    js, jo = jax_track_block_fn(JaxTrackingConfig(**kw), L, FS, S)(
        st, jnp.asarray(to_planes(iq)), jnp.asarray(replicas))
    f = make_track_block_fn(TrackingConfig(**kw), L, FS, S, device="cpu")
    ts, to = f(st, torch.from_numpy(iq), torch.from_numpy(replicas))
    for name in ("code_phase", "carrier_phase", "doppler", "ema_err", "ema_quality"):
        a = np.asarray(getattr(js, name)).ravel()
        np.testing.assert_allclose(getattr(ts, name).numpy(), a,
                                   atol=2e-3 * max(1.0, float(np.abs(a).max())), err_msg=name)
    np.testing.assert_array_equal(ts.step_count.numpy(), np.asarray(js.step_count).ravel())
    for name in ("prompt_i", "prompt_q", "code_phase_measured", "doppler", "quality"):
        a = np.asarray(getattr(jo, name))
        np.testing.assert_allclose(getattr(to, name).numpy(), a,
                                   atol=5e-3 * max(1.0, float(np.abs(a).max())), err_msg=name)
    np.testing.assert_array_equal(to.locked.numpy(), np.asarray(jo.locked))
    _, packed = f.packed(st, torch.from_numpy(to_planes(iq)), torch.from_numpy(replicas))
    assert packed.shape == (B, fx.N_OUT, S)
    np.testing.assert_array_equal(packed[:, fx.O_PI].numpy(), to.prompt_i.numpy())


def test_block_tracker_through_tracker_bank_matches_jax_bank():
    B = 64
    sat = SyntheticSatellite(prn=25, doppler_hz=-1200.0, delay_samples=777, amplitude=0.3)
    iq = synthesize_iq([sat], B * L, FS, noise_sigma=0.25, seed=4).reshape(B, L)
    kw = dict(block_size_ms=B, use_pallas_block_tracker=True, lag_window_block_margin=10)
    jbank = JaxBank(FS, L, JaxTrackingConfig(**kw), n_channels=4)
    tbank = TrackerBank(FS, L, TrackingConfig(**kw), n_channels=4, device="cpu")
    for bank in (jbank, tbank):
        bank.assign(prn=25, doppler_hz=-1200.0, code_phase_samples=777, carrier_phase_rad=0.2)
    a = jbank.process_block(iq, block_start_time=0.0)[0]
    b = tbank.process_block(iq, block_start_time=0.0)[0]
    np.testing.assert_array_equal(b.pseudosymbol_signs, a.pseudosymbol_signs)
    np.testing.assert_allclose(b.dopplers, a.dopplers, atol=0.05)
    np.testing.assert_allclose(b.code_phases, a.code_phases, atol=1e-3)
    assert b.lost == a.lost
    # A second block chains from the carry the first left behind.
    tbank.process_block(iq, block_start_time=B * 1e-3)
    tbank.sync_host_state()
    assert int(tbank.state.step_count[0]) == 2 * B


def test_limits_raise_as_in_the_jax_package():
    with pytest.raises(ValueError, match="triangle"):
        make_track_block_fn(
            TrackingConfig(use_pallas_block_tracker=True, code_phase_measurement="hrc"),
            L, FS, 4, device="cpu")
    with pytest.raises(ValueError, match="triangle"):
        tb.TrackBlockParams.from_config(TrackingConfig(code_phase_measurement="hrc"), L, FS)
    bank = TrackerBank(FS, L, TrackingConfig(use_pallas_block_tracker=True), n_channels=2, device="cpu")
    with pytest.raises(ValueError, match="carrier offsets"):
        bank.assign(prn=3, doppler_hz=0.0, code_phase_samples=0.0, carrier_phase_rad=0.0,
                    carrier_offset_hz=562500.0)
    params = tb.TrackBlockParams.from_config(TrackingConfig(), L, FS)
    rows = torch.zeros((tb.N_CARRY, 2))
    with pytest.raises(ValueError, match="samples_block"):
        tb.track_block_reference(rows, torch.zeros((4, L)), torch.zeros((2, 2 * L + 8)), params)
    with pytest.raises(ValueError, match="replicas_wide"):
        tb.track_block_reference(rows, torch.zeros((4, L, 2)), torch.zeros((2, 2 * L)), params)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tb.track_block_cuda(rows, torch.zeros((4, L, 2)), torch.zeros((2, 2 * L + 8)), params)


def test_aiding_carrier_is_gps_l1_whatever_the_config_says():
    cfg = TrackingConfig(aiding_carrier_hz=1.602e9)
    assert tb.TrackBlockParams.from_config(cfg, L, FS).loop.aiding_scale == pytest.approx(L / 1.57542e9)
    assert fx.FixupParams.from_config(cfg, L, FS).aiding_scale == pytest.approx(L / 1.602e9)


@pytest.mark.parametrize("kw", [
    {"lag_window_block_margin": 33},
    {"block_size_ms": 1000},
    {"block_size_ms": 4000},
    {"block_size_ms": 120},
])
def test_block_margin_equals_the_jax_package(kw):
    assert tb.block_margin(TrackingConfig(**kw), L) == pt.block_margin(JaxTrackingConfig(**kw), L)
    params = tb.TrackBlockParams.from_config(TrackingConfig(**kw), L, FS)
    assert params.k_eff == 4 + pt.block_margin(JaxTrackingConfig(**kw), L)

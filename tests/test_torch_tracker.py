"""track/matmul.py and track/loop.py of the port against the JAX package.

The port's two-phase block (matmul_tracker_bf16=False) is held against the
JAX matmul tracker with the scan fixup, set up as
tests/test_matmul_tracker.py sets it up. Tolerance: 1e-3 of each field's
scale (the phase-1 sums of 2046 float32 terms run in another order, and a
48 ms pull-in integrates the difference); locked/lost/step_count exact.
"""

import tests._torch_cpu  # noqa: F401  # isort: skip (first: caps torch's threads)

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gypsum_tpu.core.config import TrackingConfig as JaxTrackingConfig
from gypsum_tpu.core.planes import to_planes
from gypsum_tpu.signal.prn import replica_table
from gypsum_tpu.signal.synth import SyntheticSatellite, synthesize_iq
from gypsum_tpu.track.loop import TrackerBank as JaxBank
from gypsum_tpu.track.loop import fresh_state
from gypsum_tpu.track.matmul import make_matmul_track_block_fn as jax_matmul_fn
from gypsum_tpu_torch.convert import bank_from_numpy, track_state_from_numpy
from gypsum_tpu_torch.core.config import TrackingConfig
from gypsum_tpu_torch.track.loop import TrackerBank, make_track_block_fn
from gypsum_tpu_torch.track.matmul import make_matmul_track_block_fn

FS, L = 2.046e6, 2046


def _jax_cfg(block_ms, **kw):
    return JaxTrackingConfig(block_size_ms=block_ms, matmul_tracker_bf16=False,
                             fixup_backend="scan", **kw)


def _cfg(block_ms, **kw):
    return TrackingConfig(block_size_ms=block_ms, matmul_tracker_bf16=False, **kw)


def _replicas(prn, n_channels):
    reps = replica_table(L)
    k = TrackingConfig().lag_window_half_width
    wide = np.concatenate([reps, reps, reps[:, : 2 * k]], axis=1).astype(np.float32)
    return np.tile(wide[prn - 1][None, :], (n_channels, 1))


def _close(b, a, what, rel=1e-3):
    np.testing.assert_allclose(b, a, atol=rel * max(1.0, float(np.abs(a).max())), err_msg=what)


def _compare(ts, to, js, jo):
    for name in ("code_phase", "carrier_phase", "doppler", "ema_err", "ema_quality"):
        _close(np.asarray(getattr(ts, name)).ravel(), np.asarray(getattr(js, name)).ravel(), name)
    np.testing.assert_array_equal(np.asarray(ts.step_count).ravel(), np.asarray(js.step_count).ravel())
    for name in ("prompt_i", "prompt_q", "code_phase", "code_phase_measured",
                 "doppler", "pll_error", "dll_error", "quality"):
        _close(np.asarray(getattr(to, name)), np.asarray(getattr(jo, name)), name)
    np.testing.assert_array_equal(np.asarray(to.locked), np.asarray(jo.locked))
    np.testing.assert_array_equal(np.asarray(to.lost), np.asarray(jo.lost))


def test_block_matches_jax_matmul_tracker():
    S, B = 8, 48
    sat = SyntheticSatellite(prn=9, doppler_hz=700.0, delay_samples=100, amplitude=0.3)
    iq = synthesize_iq([sat], B * L, FS, noise_sigma=0.2, seed=9).reshape(B, L)
    replicas = _replicas(9, S)
    st = fresh_state(S)
    st = st._replace(doppler=st.doppler + 700.0, code_phase=st.code_phase + 100.0)

    js, jo = jax_matmul_fn(_jax_cfg(B), L, FS, S)(st, jnp.asarray(to_planes(iq)), jnp.asarray(replicas))
    # The port takes planes as well as complex blocks: feed planes here.
    ts, to = make_track_block_fn(_cfg(B), L, FS, S, device="cpu")(
        st, torch.from_numpy(to_planes(iq)), torch.from_numpy(replicas))
    _compare(ts, to, js, jo)


def test_bf16_phase1_stays_close_to_float32():
    """matmul_tracker_bf16=True rounds the phase-1 operands to bf16 with a
    float32 result (on the CPU: bf16-rounded operands, float32 product);
    the loop must track the same way as float32 within the rounding."""
    S, B = 4, 48
    sat = SyntheticSatellite(prn=9, doppler_hz=700.0, delay_samples=100, amplitude=0.3)
    iq = torch.from_numpy(synthesize_iq([sat], B * L, FS, noise_sigma=0.2, seed=9).reshape(B, L))
    replicas = torch.from_numpy(_replicas(9, S))
    st = fresh_state(S)
    st = st._replace(doppler=st.doppler + 700.0, code_phase=st.code_phase + 100.0)
    s32, o32 = make_track_block_fn(_cfg(B), L, FS, S, device="cpu")(st, iq, replicas)
    s16, o16 = make_track_block_fn(
        dataclasses.replace(_cfg(B), matmul_tracker_bf16=True), L, FS, S, device="cpu"
    )(st, iq, replicas)
    assert torch.equal(torch.sign(o16.prompt_i), torch.sign(o32.prompt_i))
    # bf16 keeps 8 bits of mantissa: correlations agree to ~1 %.
    _close(o16.prompt_i.numpy(), o32.prompt_i.numpy(), "prompt_i", rel=2e-2)
    assert abs(float(s16.doppler[0]) - float(s32.doppler[0])) < 0.5


def test_tracker_bank_gives_identical_pseudosymbols():
    B = 64
    sat = SyntheticSatellite(prn=25, doppler_hz=-1200.0, delay_samples=777, amplitude=0.3)
    iq = synthesize_iq([sat], B * L, FS, noise_sigma=0.25, seed=4).reshape(B, L)

    jbank = JaxBank(FS, L, _jax_cfg(B), n_channels=4)
    tbank = TrackerBank(FS, L, _cfg(B), n_channels=4, device="cpu")
    for bank in (jbank, tbank):
        bank.assign(prn=25, doppler_hz=-1200.0, code_phase_samples=777, carrier_phase_rad=0.2)
    a = jbank.process_block(iq, block_start_time=0.0)[0]
    b = tbank.process_block(iq, block_start_time=0.0)[0]
    np.testing.assert_array_equal(b.pseudosymbol_signs, a.pseudosymbol_signs)
    np.testing.assert_allclose(b.start_times, a.start_times, rtol=0, atol=1e-9)
    np.testing.assert_allclose(b.dopplers, a.dopplers, atol=0.05)
    np.testing.assert_allclose(b.code_phases, a.code_phases, atol=1e-3)
    assert b.lost == a.lost


def test_state_carried_across_from_jax_bank():
    """One block in the JAX bank, its carry and slot binding carried across
    with bank_from_numpy, the next block in both packages."""
    B = 40
    sats = [SyntheticSatellite(prn=25, doppler_hz=-1200.0, delay_samples=777, amplitude=0.3),
            SyntheticSatellite(prn=7, doppler_hz=2300.0, delay_samples=150, amplitude=0.3)]
    iq = synthesize_iq(sats, 2 * B * L, FS, noise_sigma=0.25, seed=8).reshape(2 * B, L)
    jbank = JaxBank(FS, L, _jax_cfg(B), n_channels=4)
    jbank.assign(prn=25, doppler_hz=-1200.0, code_phase_samples=777, carrier_phase_rad=0.0)
    jbank.assign(prn=7, doppler_hz=2300.0, code_phase_samples=150, carrier_phase_rad=0.0)
    jbank.process_block(iq[:B], block_start_time=0.0)
    jbank.sync_host_state()

    tbank = bank_from_numpy(TrackerBank(FS, L, _cfg(B), n_channels=4, device="cpu"),
                            jbank.slot_prn, jbank.state)
    assert tbank.slot_prn == [25, 7, None, None]
    dev_state = track_state_from_numpy(jbank.state, device="cpu")
    np.testing.assert_array_equal(dev_state.code_phase.numpy(), np.asarray(jbank.state.code_phase).ravel())
    assert dev_state.step_count.dtype == torch.int32 and dev_state.lost.dtype == torch.bool

    a = jbank.process_block(iq[B:], block_start_time=B * 1e-3)
    b = tbank.process_block(iq[B:], block_start_time=B * 1e-3)
    assert [o.prn for o in b] == [o.prn for o in a] == [25, 7]
    for oa, ob in zip(a, b):
        np.testing.assert_array_equal(ob.pseudosymbol_signs, oa.pseudosymbol_signs)
        np.testing.assert_allclose(ob.code_phases_measured, oa.code_phases_measured, atol=1e-2)
        np.testing.assert_allclose(ob.dopplers, oa.dopplers, atol=0.05)
    tbank.sync_host_state()
    jbank.sync_host_state()
    np.testing.assert_array_equal(tbank.state.step_count, np.asarray(jbank.state.step_count).ravel())


def test_bank_from_numpy_rejects_mismatched_carry():
    tbank = TrackerBank(FS, L, _cfg(40), n_channels=4, device="cpu")
    with pytest.raises(ValueError, match="channels"):
        bank_from_numpy(tbank, [25, None, None], fresh_state(4))
    with pytest.raises(ValueError, match="family"):
        bank_from_numpy(tbank, [999, None, None, None], fresh_state(4))


def test_farm_mode_matches_jax():
    from gypsum_tpu.track.matmul import make_matmul_track_block_fn as jfarm

    n_streams, ch_per_stream, B = 2, 2, 48
    s_total = n_streams * ch_per_stream
    stream_of_channel = np.repeat(np.arange(n_streams), ch_per_stream).astype(np.int32)
    sats = [SyntheticSatellite(prn=7, doppler_hz=800.0, delay_samples=50, amplitude=0.3),
            SyntheticSatellite(prn=7, doppler_hz=-450.0, delay_samples=900, amplitude=0.3)]
    streams = [synthesize_iq([s], B * L, FS, noise_sigma=0.2, seed=10 + i).reshape(B, L)
               for i, s in enumerate(sats)]
    planes = np.stack([to_planes(s) for s in streams], axis=1)  # [B, N, L, 2]
    replicas = _replicas(7, s_total)
    st = fresh_state(s_total)._replace(
        doppler=np.array([800.0, 800.0, -450.0, -450.0], dtype=np.float32),
        code_phase=np.array([50.0, 50.0, 900.0, 900.0], dtype=np.float32),
    )
    js, jo = jfarm(_jax_cfg(B), L, FS, s_total, stream_of_channel)(
        st, jnp.asarray(planes), jnp.asarray(replicas))
    ts, to = make_matmul_track_block_fn(_cfg(B), L, FS, s_total, stream_of_channel, device="cpu")(
        st, torch.from_numpy(planes), torch.from_numpy(replicas))
    _compare(ts, to, js, jo)


@pytest.mark.parametrize("kw", [
    {"use_pallas_block_tracker": True},
    {"use_matmul_tracker": False},
])
def test_unported_trackers_raise(kw):
    """The two configurations that used to raise "not ported": the
    whole-block tracker and the per-ms scan now build and run, and track
    the same block as the default two-phase tracker (tests/
    test_torch_block_tracker.py and test_torch_scan_tracker.py hold them
    against the JAX package)."""
    S, B = 4, 48
    sat = SyntheticSatellite(prn=9, doppler_hz=700.0, delay_samples=100, amplitude=0.3)
    iq = torch.from_numpy(synthesize_iq([sat], B * L, FS, noise_sigma=0.2, seed=9).reshape(B, L))
    replicas = torch.from_numpy(_replicas(9, S))
    st = fresh_state(S)
    st = st._replace(doppler=st.doppler + 700.0, code_phase=st.code_phase + 100.0)
    s_ref, o_ref = make_track_block_fn(_cfg(B), L, FS, S, device="cpu")(st, iq, replicas)
    s_new, o_new = make_track_block_fn(_cfg(B, **kw), L, FS, S, device="cpu")(st, iq, replicas)
    assert torch.equal(torch.sign(o_new.prompt_i), torch.sign(o_ref.prompt_i))
    assert torch.equal(s_new.step_count, s_ref.step_count)
    # The trackers differ by the within-ms residual-Doppler ramp that the
    # two-phase tracker leaves in (amplitude >= 0.992): 2 % of scale.
    _close(o_new.prompt_i.numpy(), o_ref.prompt_i.numpy(), "prompt_i", rel=2e-2)
    _close(s_new.doppler.numpy(), s_ref.doppler.numpy(), "doppler", rel=2e-3)


def test_scan_fixup_on_the_card_raises_and_runs_plain_on_cpu():
    """fixup_backend="scan" is a named configuration on either device: the
    plain loop-filter chain. On the CPU it is what None runs too, so the two
    agree exactly; an unknown backend raises."""
    S, B = 4, 48
    sat = SyntheticSatellite(prn=9, doppler_hz=700.0, delay_samples=100, amplitude=0.3)
    iq = torch.from_numpy(synthesize_iq([sat], B * L, FS, noise_sigma=0.2, seed=9).reshape(B, L))
    replicas = torch.from_numpy(_replicas(9, S))
    st = fresh_state(S)
    st = st._replace(doppler=st.doppler + 700.0, code_phase=st.code_phase + 100.0)
    _, o_scan = make_matmul_track_block_fn(_cfg(B, fixup_backend="scan"), L, FS, S, device="cpu")(st, iq, replicas)
    _, o_none = make_matmul_track_block_fn(_cfg(B), L, FS, S, device="cpu")(st, iq, replicas)
    assert torch.equal(o_scan.prompt_i, o_none.prompt_i)
    assert torch.equal(o_scan.locked, o_none.locked)
    with pytest.raises(ValueError, match="fixup_backend"):
        make_matmul_track_block_fn(_cfg(48, fixup_backend="mosaic"), L, FS, 4, device="cpu")


def test_raw_uint8_planes_dequantize_on_the_device():
    """An rtl_sdr-style capture (interleaved uint8 biased at 127.5) crosses
    as raw words and is dequantized on the device: the block tracks exactly
    as the same samples handed over as complex64."""
    B = 40
    sat = SyntheticSatellite(prn=25, doppler_hz=-1200.0, delay_samples=777, amplitude=0.3)
    iq = synthesize_iq([sat], B * L, FS, noise_sigma=0.25, seed=4).reshape(B, L)
    words = np.stack([np.clip(np.round(iq.real * 46 + 127.5), 0, 255),
                      np.clip(np.round(iq.imag * 46 + 127.5), 0, 255)], axis=-1).astype(np.uint8)
    deq = (words[..., 0].astype(np.float32) - 127.5) + 1j * (words[..., 1].astype(np.float32) - 127.5)

    def run(block, offset):
        bank = TrackerBank(FS, L, _cfg(B), n_channels=2, input_offset=offset, device="cpu")
        bank.assign(prn=25, doppler_hz=-1200.0, code_phase_samples=777, carrier_phase_rad=0.0)
        return bank.process_block(block, block_start_time=0.0)[0]

    a = run(words, 127.5)
    b = run(deq.astype(np.complex64), 0.0)
    np.testing.assert_array_equal(a.prompts, b.prompts)
    np.testing.assert_array_equal(a.code_phases_measured, b.code_phases_measured)


def _builder(name):
    if name == "matmul":
        return make_matmul_track_block_fn
    from gypsum_tpu_torch.track.scan import make_scan_track_block_fn

    return make_scan_track_block_fn


@pytest.mark.parametrize("name", ["matmul", "scan"])
def test_builders_default_to_the_card(name):
    """Both builders resolve their device as every other entry point does:
    CUDA unless the caller asks for the CPU, and a RuntimeError, not a quiet
    CPU run, where there is no card."""
    build = _builder(name)
    if torch.cuda.is_available():
        fn = build(_cfg(48), L, FS, 4)
        assert callable(fn) and callable(fn.packed)
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            build(_cfg(48), L, FS, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        build(_cfg(48), L, FS, 4, device="mps")


@pytest.mark.parametrize("name", ["matmul", "scan"])
def test_builders_on_the_cpu_match_jax(name):
    """With device="cpu" each builder, called directly, tracks a block as the
    JAX package's own tracker of the same kind does."""
    S, B = 4, 48
    sat = SyntheticSatellite(prn=9, doppler_hz=700.0, delay_samples=100, amplitude=0.3)
    iq = synthesize_iq([sat], B * L, FS, noise_sigma=0.2, seed=9).reshape(B, L)
    replicas = _replicas(9, S)
    st = fresh_state(S)
    st = st._replace(doppler=st.doppler + 700.0, code_phase=st.code_phase + 100.0)
    if name == "matmul":
        js, jo = jax_matmul_fn(_jax_cfg(B), L, FS, S)(st, jnp.asarray(to_planes(iq)), jnp.asarray(replicas))
        cfg = _cfg(B)
    else:
        from gypsum_tpu.track.loop import make_track_block_fn as jax_track_block_fn

        scan = dict(use_matmul_tracker=False, use_pallas_block_tracker=False)
        js, jo = jax_track_block_fn(JaxTrackingConfig(block_size_ms=B, **scan), L, FS, S)(
            st, jnp.asarray(to_planes(iq)), jnp.asarray(replicas))
        cfg = _cfg(B, **scan)
    ts, to = _builder(name)(cfg, L, FS, S, device="cpu")(
        st, torch.from_numpy(iq), torch.from_numpy(replicas))
    _compare(ts, to, js, jo)

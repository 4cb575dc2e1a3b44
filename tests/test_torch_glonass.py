"""GLONASS L1OF/L2OF in the port against the JAX package.

The same seeded inputs go through the JAX function and its counterpart in
``gypsum_tpu_torch`` (``device="cpu"``: every kernel wrapper runs its plain
version); the JAX Pallas kernels run in interpret mode, as
tests/test_pallas_kernels.py runs them. Both trackers run phase 1 in
float32 (``matmul_tracker_bf16=False``), as tests/test_torch_receiver.py
does.

- Units: the string codec and KX check (nav/glonass), PZ-90 propagation,
  time scales and ephemeris <-> strings (solve/glonass), synthesis of both
  sub-bands: the port's copies compute what the JAX package computes, to
  the bit (the same numpy code), and the synthesized bands within float32
  rounding.
- FDMA acquisition: equal detections; on the on-air channels equal code
  phases, Doppler within one fine step (25 Hz) and strengths within rtol
  1e-3 (float32 FFTs summed in another order), with and without the
  peak-reduce kernel; the same errors for what the JAX engine refuses.
- The tracker with FDMA offsets at 4092 samples per ms, NLE 43: the port's
  two-phase tracker against the JAX tracker with its Pallas fixup, and the
  port's per-ms scan tracker with the plain K4 against the JAX scan with
  its Pallas correlator, at 1e-3 of each field's scale (sums of 4092
  float32 terms in another order, integrated by the loop); pseudosymbols,
  lock and loss exact. K4's plain version against the Pallas kernel at MHz
  wipe frequencies within 1e-4 of the correlation scale.

The slice, both receivers on whole scenes, is in
tests/test_torch_glonass_receiver.py (L1OF, and the port's CLI) and
tests/test_torch_glonass_l2.py (L2OF).
"""

import tests._torch_cpu  # noqa: F401  # isort: skip (first: caps torch's threads)

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gypsum_tpu.acquire.engine import AcquisitionEngine as JaxEngine
from gypsum_tpu.core.config import AcquisitionConfig as JaxAcqConfig
from gypsum_tpu.core.config import TrackingConfig as JaxTrackingConfig
from gypsum_tpu.nav import glonass as jnav
from gypsum_tpu.ops.pallas_kernels import wipeoff_lag_correlate_pallas
from gypsum_tpu.signal import constellation as jcon
from gypsum_tpu.signal import scenarios as jscn
from gypsum_tpu.solve import glonass as jsol
from gypsum_tpu.track.loop import TrackerBank as JaxBank
from gypsum_tpu_torch.acquire.engine import AcquisitionEngine
from gypsum_tpu_torch.core.config import AcquisitionConfig, TrackingConfig
from gypsum_tpu_torch.core.constants import GLONASS_L1_BASE_HZ, GLONASS_L1_CHANNEL_SPACING_HZ
from gypsum_tpu_torch.nav import glonass as tnav
from gypsum_tpu_torch.ops.wipeoff_lag import wipeoff_lag_reference
from gypsum_tpu_torch.signal import constellation as tcon
from gypsum_tpu_torch.signal import scenarios as tscn
from gypsum_tpu_torch.signal.prn import GLONASS_PRN_IDS, glonass_frequency_number
from gypsum_tpu_torch.solve import glonass as tsol
from gypsum_tpu_torch.track.loop import TrackerBank
from gypsum_tpu_torch.track.matmul import lag_window_size

FS, L = 4.092e6, 4092
START_SOW = 21618.0  # a GLONASS frame boundary at t = 0 (tests/test_glonass_receiver.py)
GLO_OFFSET_S = 8e-7
KS = [-2, -1, 0, 1, 2]
PRNS = [208 + k for k in KS]
RX = jscn.demo_receiver_ecef()
OFFSETS = tuple(glonass_frequency_number(p) * GLONASS_L1_CHANNEL_SPACING_HZ for p in GLONASS_PRN_IDS)


# ------------------------------------------------------------------ units


def test_string_codec_and_kx_match_jax():
    rng = np.random.default_rng(3)
    for _ in range(20):
        data = rng.integers(0, 2, 85).astype(np.int8)  # an 85-bit string, check bits filled below
        np.testing.assert_array_equal(tnav.kx_encode(data), jnav.kx_encode(data))
        bits = tnav.kx_encode(data)
        flipped = bits.copy()
        flipped[rng.integers(0, len(bits))] ^= 1
        a, b = tnav.kx_verify(flipped), jnav.kx_verify(flipped)
        assert a[0] == b[0] and a[2] == b[2]
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(tnav.relative_encode(bits), jnav.relative_encode(bits))
        np.testing.assert_array_equal(tnav.string_symbols(bits), jnav.string_symbols(bits))
    eph = jscn.demo_glonass_constellation([1])[0].ephemeris
    strings_j = jsol.strings_from_glonass_ephemeris(eph)
    strings_t = tsol.strings_from_glonass_ephemeris(tscn.demo_glonass_constellation([1])[0].ephemeris)
    for m in strings_j:
        bits = jnav.encode_string(strings_j[m])
        np.testing.assert_array_equal(tnav.encode_string(strings_t[m]), bits)
        assert tnav.parse_string(bits).fields == jnav.parse_string(bits).fields
    frame_j = jnav.encode_frame_symbols(jnav.frame_strings_for_ephemeris(strings_j, 32400.0))
    frame_t = tnav.encode_frame_symbols(tnav.frame_strings_for_ephemeris(strings_t, 32400.0))
    np.testing.assert_array_equal(frame_t, frame_j)


def test_string_decoder_matches_jax():
    """Both decoders on one noisy, inverted pseudosymbol stream with an
    offset start: the same events at the same edges."""
    eph = jscn.demo_glonass_constellation([0])[0].ephemeris
    strings = jsol.strings_from_glonass_ephemeris(eph)
    sym = jnav.encode_frame_symbols(jnav.frame_strings_for_ephemeris(strings, 32400.0))
    pseudo = -np.repeat(sym.astype(np.float64), jnav.GLONASS_PSEUDOSYMBOLS_PER_SYMBOL)[3333:]
    rng = np.random.default_rng(5)
    pseudo = np.where(rng.random(len(pseudo)) < 0.02, -pseudo, pseudo)
    times = np.arange(len(pseudo)) * 1e-3
    events = {}
    for name, mod in (("jax", jnav), ("port", tnav)):
        dec, out = mod.GlonassStringDecoder(), []
        for lo in range(0, len(pseudo), 1000):  # block by block, as the receiver feeds it
            out += dec.process_block(pseudo[lo:lo + 1000], times[lo:lo + 1000])
        events[name] = [(e.string.m, e.string.fields, e.trailing_edge_receiver_timestamp,
                         e.corrected_bits) for e in out]
    assert len(events["jax"]) >= 4
    assert events["port"] == events["jax"]


@pytest.mark.parametrize("k", [-7, -1, 0, 6])
def test_orbit_time_scales_and_strings_match_jax(k):
    look = dict(frequency_number=k, tb_day_s=45 * 900.0, tau_n_s=2.5e-5, gamma_n=1.8e-11,
                slot=9, heading_deg=40.0)
    ej = jsol.glonass_ephemeris_from_look(RX, 55.0, 120.0, **look)
    et = tsol.glonass_ephemeris_from_look(RX, 55.0, 120.0, **look)
    assert dataclasses.asdict(et).keys() == dataclasses.asdict(ej).keys()
    t = 45 * 900.0 + np.array([-1700.0, -3.5, 0.0, 12.25, 900.0])
    np.testing.assert_array_equal(tsol.glonass_satellite_position(et, t),
                                  jsol.glonass_satellite_position(ej, t))
    for tt in t:  # the velocity takes one instant
        np.testing.assert_array_equal(tsol.glonass_satellite_velocity(et, tt),
                                      jsol.glonass_satellite_velocity(ej, tt))
    np.testing.assert_array_equal(tsol.glonass_clock_ahead_s(et, t), jsol.glonass_clock_ahead_s(ej, t))
    assert et.carrier_frequency_hz == ej.carrier_frequency_hz
    for sow in (21618.0, 100_000.5, 604_790.0):
        day = tsol.glonass_day_time_from_gps_sow(sow, 18)
        assert day == jsol.glonass_day_time_from_gps_sow(sow, 18)
        assert (tsol.gps_sow_from_glonass_day_time(day, sow + 0.3, 18)
                == jsol.gps_sow_from_glonass_day_time(day, sow + 0.3, 18))
    st, sj = tsol.strings_from_glonass_ephemeris(et), jsol.strings_from_glonass_ephemeris(ej)
    assert {m: s.fields for m, s in st.items()} == {m: s.fields for m, s in sj.items()}
    back = tsol.glonass_ephemeris_from_strings(st[1], st[2], st[3], st[4], frequency_number=k)
    assert dataclasses.asdict(back) == dataclasses.asdict(
        jsol.glonass_ephemeris_from_strings(sj[1], sj[2], sj[3], sj[4], frequency_number=k))


@pytest.mark.parametrize("band", ["l1", "l2"])
def test_synthesis_matches_jax(band):
    kw = dict(noise_sigma=0.25, glonass_time_offset_s=GLO_OFFSET_S, glonass_band=band, seed=2)
    iq_j, truth_j = jcon.synthesize_constellation(
        jscn.demo_glonass_constellation(KS), RX, START_SOW, 0.2, FS, **kw)
    iq_t, truth_t = tcon.synthesize_constellation(
        tscn.demo_glonass_constellation(KS), RX, START_SOW, 0.2, FS, **kw)
    # Float tolerance: the same float64 numpy arithmetic rounded to
    # complex64 (1e-6 of the unit noise scale).
    np.testing.assert_allclose(iq_t, iq_j, rtol=0, atol=1e-6)
    assert truth_t.doppler_hz == truth_j.doppler_hz
    assert truth_t.code_phase_samples == truth_j.code_phase_samples


def test_mixed_band_scene_raises_as_in_jax():
    for con, scn in ((jcon, jscn), (tcon, tscn)):
        sats = scn.demo_constellation([25]) + scn.demo_glonass_constellation([0])
        with pytest.raises(ValueError, match="cannot share one"):
            con.synthesize_constellation(sats, RX, START_SOW, 0.01, FS)


# ------------------------------------------------------- FDMA acquisition


@pytest.fixture(scope="module")
def short_scene():
    """One second of the 5-channel L1OF scene (k = -2..2) and its truth."""
    return jcon.synthesize_constellation(
        jscn.demo_glonass_constellation(KS), RX, START_SOW, 1.0, FS, noise_sigma=0.25,
        glonass_time_offset_s=GLO_OFFSET_S)


@pytest.mark.parametrize("peak_kernel", [False, True])
def test_fdma_acquisition_matches_jax(short_scene, peak_kernel):
    iq, truth = short_scene
    block = iq[: 10 * L].reshape(10, L)
    jax_hits = {h.prn: h for h in JaxEngine(
        FS, L, JaxAcqConfig(use_pallas_peak_reduce=peak_kernel), prns=GLONASS_PRN_IDS,
        center_offsets_hz=OFFSETS).acquire_all(block)}
    port = AcquisitionEngine(FS, L, AcquisitionConfig(use_pallas_peak_reduce=peak_kernel),
                             prns=GLONASS_PRN_IDS, center_offsets_hz=OFFSETS, device="cpu")
    assert port.sweep_dopplers.shape == (14 * 29,)
    thr = AcquisitionConfig().detection_threshold
    hits = port.acquire_all(block)
    assert {h.prn for h in hits if h.strength > thr} == {
        h.prn for h in jax_hits.values() if h.strength > thr} == set(PRNS)
    # The off-air channels' grids are noise (and, beyond k = +/-2, aliases of
    # the on-air channels): their peaks are near-ties that a sum in another
    # order can move, so only their detection decision is held above.
    for h in (h for h in hits if h.prn in PRNS):
        j = jax_hits[h.prn]
        assert h.code_phase_samples == j.code_phase_samples, h.prn
        assert h.strength == pytest.approx(j.strength, rel=1e-3)
        # Absolute baseband Doppler (offset included) within one fine step.
        assert abs(h.doppler_hz - j.doppler_hz) < AcquisitionConfig().fine_step_hz, (h, j)
        assert abs(h.doppler_hz - truth.doppler_hz[h.prn]) < 30.0


@pytest.mark.parametrize("prns,offsets,match", [
    (GLONASS_PRN_IDS, (0.0,), "align"),
    ((25, 28), (0.0, 562.5e3), "one code"),
])
def test_fdma_acquisition_refuses_what_jax_refuses(prns, offsets, match):
    with pytest.raises(ValueError, match=match):
        JaxEngine(FS, L, prns=prns, center_offsets_hz=offsets)
    with pytest.raises(ValueError, match=match):
        AcquisitionEngine(FS, L, prns=prns, center_offsets_hz=offsets, device="cpu")


# -------------------------------------------------- tracking with offsets


def _assign_from_truth(bank, truth):
    for prn in PRNS:
        off = glonass_frequency_number(prn) * GLONASS_L1_CHANNEL_SPACING_HZ
        bank.assign(prn=prn, doppler_hz=truth.doppler_hz[prn] - off,
                    code_phase_samples=truth.code_phase_samples[prn], carrier_phase_rad=0.0,
                    carrier_offset_hz=off)


def _glonass_tracking(config_cls, block_ms, **kw):
    return config_cls(block_size_ms=block_ms, aiding_carrier_hz=GLONASS_L1_BASE_HZ,
                      chips_per_code=511, matmul_tracker_bf16=False, **kw)


def _hold_observations(port_obs, jax_obs, rel=1e-3):
    """Per channel: equal pseudosymbols, lock and loss; every per-ms field
    within ``rel`` of its scale."""
    assert [o.prn for o in port_obs] == [o.prn for o in jax_obs] == PRNS
    for a, b in zip(port_obs, jax_obs):
        np.testing.assert_array_equal(a.pseudosymbol_signs, b.pseudosymbol_signs)
        np.testing.assert_array_equal(np.asarray(a.locked), np.asarray(b.locked))
        assert bool(a.lost) == bool(b.lost)
        for name in ("prompts", "dopplers", "code_phases", "code_phases_measured", "quality"):
            x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
            np.testing.assert_allclose(x, y, atol=rel * max(1.0, float(np.abs(y).max())),
                                       err_msg=f"PRN {a.prn} {name}")
        assert np.asarray(a.locked)[-1], f"PRN {a.prn} not locked at block end"


def test_matmul_tracker_with_offsets_matches_jax_fixup_kernel(short_scene):
    """One 1000 ms block at NLE 43, k = -2..2 (odd k: the offset's advance
    per ms is exactly +/-0.5 cycle, a tie both sides round to even)."""
    iq, truth = short_scene
    # fixup_group_ms: how many ms one Pallas grid step unrolls; it changes
    # nothing of the result, and one ms a step interprets fastest.
    jbank = JaxBank(FS, L, _glonass_tracking(JaxTrackingConfig, 1000, fixup_backend="pallas",
                                             fixup_group_ms=1),
                    n_channels=len(PRNS), prns=GLONASS_PRN_IDS)
    tbank = TrackerBank(FS, L, _glonass_tracking(TrackingConfig, 1000),
                        n_channels=len(PRNS), prns=GLONASS_PRN_IDS, device="cpu")
    for bank in (jbank, tbank):
        _assign_from_truth(bank, truth)
    assert lag_window_size(tbank.config, L) == 43
    block = iq.reshape(1000, L)
    _hold_observations(tbank.process_block(block, 0.0), jbank.process_block(block, 0.0))


def test_scan_tracker_with_plain_k4_matches_jax_scan_at_mhz(short_scene):
    """The per-ms scan with the correlator of K4 (its plain version here;
    the JAX scan runs the Pallas correlator in interpret mode) over 100 ms:
    wipe frequencies of k x 562.5 kHz + Doppler."""
    iq, truth = short_scene
    scan = dict(use_matmul_tracker=False, use_pallas_block_tracker=False,
                use_pallas_correlator=True)
    jbank = JaxBank(FS, L, _glonass_tracking(JaxTrackingConfig, 100, **scan),
                    n_channels=len(PRNS), prns=GLONASS_PRN_IDS)
    tbank = TrackerBank(FS, L, _glonass_tracking(TrackingConfig, 100, **scan),
                        n_channels=len(PRNS), prns=GLONASS_PRN_IDS, device="cpu")
    for bank in (jbank, tbank):
        _assign_from_truth(bank, truth)
    block = iq[: 100 * L].reshape(100, L)
    port_obs, jax_obs = tbank.process_block(block, 0.0), jbank.process_block(block, 0.0)
    for a, b in zip(port_obs, jax_obs):  # a 100 ms pull-in: not yet locked
        np.testing.assert_array_equal(a.pseudosymbol_signs, b.pseudosymbol_signs)
        for name in ("prompts", "dopplers", "code_phases"):
            y = np.asarray(getattr(b, name))
            np.testing.assert_allclose(np.asarray(getattr(a, name)), y,
                                       atol=1e-3 * max(1.0, float(np.abs(y).max())))


@pytest.mark.parametrize("ms", [0, 517])
def test_plain_k4_matches_the_pallas_kernel_at_mhz(short_scene, ms):
    iq, truth = short_scene
    bank = TrackerBank(FS, L, _glonass_tracking(TrackingConfig, 1000), n_channels=len(PRNS),
                       prns=GLONASS_PRN_IDS, device="cpu")
    _assign_from_truth(bank, truth)
    st = bank.state
    k_half = TrackingConfig().lag_window_half_width
    base = np.mod(L - np.floor(st.code_phase).astype(np.int64) - k_half, L).astype(np.float32)
    params = np.stack([st.carrier_phase + 0.3 * ms, st.doppler + st.carrier_offset, base],
                      axis=-1).astype(np.float32)
    assert np.abs(params[:, 1]).max() > 1.1e6
    replicas = bank._device_replicas(np.array([bank._prn_row[p] for p in PRNS])).numpy()
    chunk = iq[ms * L:(ms + 1) * L]
    planes = np.stack([chunk.real, chunk.imag]).astype(np.float32)
    want = np.asarray(wipeoff_lag_correlate_pallas(
        jnp.asarray(planes), jnp.asarray(replicas), jnp.asarray(params),
        length=L, n_lags=2 * k_half + 1, inv_fs=1.0 / FS))
    got = wipeoff_lag_reference(torch.from_numpy(planes), torch.from_numpy(replicas),
                                torch.from_numpy(params), L, 2 * k_half + 1, 1.0 / FS).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4 * float(np.abs(want).max()))


def test_block_kernel_refuses_offsets_as_jax_does():
    cfg = dict(use_pallas_block_tracker=True, use_matmul_tracker=False)
    for bank in (JaxBank(FS, L, JaxTrackingConfig(**cfg), n_channels=1, prns=GLONASS_PRN_IDS),
                 TrackerBank(FS, L, TrackingConfig(**cfg), n_channels=1, prns=GLONASS_PRN_IDS,
                             device="cpu")):
        with pytest.raises(ValueError, match="FDMA"):
            bank.assign(prn=GLONASS_PRN_IDS[0], doppler_hz=0.0, code_phase_samples=0.0,
                        carrier_phase_rad=0.0, carrier_offset_hz=562.5e3)

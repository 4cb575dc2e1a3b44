"""acquire/engine.py of the port (device="cpu") against the JAX engine.

Tolerances: the coarse grid decides the PRN set and the code phase, which
must be identical; the fine Doppler and the strength come from float32 FFTs
and sums taken in another order, so |dDoppler| < 0.5 Hz and strength within
rtol 1e-3.

The circulant-matmul sweep (``correlator="matmul"``) is held two ways. To
the JAX package's matmul sweep, [S, D, L] within 1e-4 of the grid's largest
value: both round the Doppler-wiped rows to bf16 and sum in float32, and a
wipeoff phasor a float32 ulp apart can move a sample's bf16 rounding by
2^-8 of that sample (it measures 3.3e-6 on the GPS block; the card against
the CPU, 4e-5). To the FFT sweep, with the JAX
test's bars (tests/test_acquisition.py:160-185): code phase equal, Doppler
within 2 Hz, strength within 5 % of max(1, strength). Noise rows hold only
their detection decision where the peaks are near-ties (ROADMAP.md §C).
"""

import tests._torch_cpu  # noqa: F401  # isort: skip (first: caps torch's threads)

import dataclasses

import numpy as np
import pytest
import torch

from gypsum_tpu.acquire.engine import AcquisitionEngine as JaxEngine
from gypsum_tpu.core.config import AcquisitionConfig as JaxAcqConfig
from gypsum_tpu.signal.synth import SyntheticSatellite, synthesize_iq
from gypsum_tpu_torch.acquire.engine import AcquisitionEngine, coarse_peak
from gypsum_tpu_torch.core.config import AcquisitionConfig

FS, L = 2.046e6, 2046
TRUTH = {3: (1250.0, 100), 11: (-2100.0, 900), 20: (310.0, 1500), 25: (-3400.0, 2000)}


@pytest.fixture(scope="module")
def block():
    sats = [SyntheticSatellite(prn=p, doppler_hz=d, delay_samples=c, amplitude=0.3)
            for p, (d, c) in TRUTH.items()]
    return synthesize_iq(sats, 10 * L, FS, noise_sigma=0.35, seed=17).reshape(10, L)


@pytest.fixture(scope="module")
def port_hits(block):
    return AcquisitionEngine(FS, L, device="cpu").acquire_all(block)


def test_matches_jax_engine(block, port_hits):
    jax_hits = JaxEngine(FS, L).acquire_all(block)
    thr = AcquisitionConfig().detection_threshold
    assert {h.prn for h in port_hits if h.strength > thr} == {
        h.prn for h in jax_hits if h.strength > thr
    } == set(TRUTH)
    jax_by_prn = {h.prn: h for h in jax_hits}
    for h in port_hits:
        j = jax_by_prn[h.prn]
        assert h.code_phase_samples == j.code_phase_samples, h.prn
        if h.prn in TRUTH:
            assert abs(h.doppler_hz - j.doppler_hz) < 0.5, (h, j)
            assert h.strength == pytest.approx(j.strength, rel=1e-3)
            assert abs(h.doppler_hz - TRUTH[h.prn][0]) < 10.0
            assert h.code_phase_samples == TRUTH[h.prn][1]


def test_peak_reduce_route_matches_default_route(block, port_hits):
    cfg = AcquisitionConfig(use_pallas_peak_reduce=True)
    hits = AcquisitionEngine(FS, L, cfg, device="cpu").acquire_all(block)
    assert [(h.prn, h.code_phase_samples, h.doppler_hz, h.carrier_phase_rad) for h in hits] == [
        (h.prn, h.code_phase_samples, h.doppler_hz, h.carrier_phase_rad) for h in port_hits
    ]
    np.testing.assert_allclose([h.strength for h in hits], [h.strength for h in port_hits], rtol=1e-6)


def test_detect_filters_like_jax(block):
    eligible = {3, 25, 7}
    port = AcquisitionEngine(FS, L, device="cpu").detect(block, eligible_prns=eligible)
    jax = JaxEngine(FS, L, JaxAcqConfig()).detect(block, eligible_prns=eligible)
    assert [h.prn for h in port] == [h.prn for h in jax]
    assert {h.prn for h in port} == {3, 25}


def test_torch_argmax_returns_the_first_maximum():
    # The flat-argmax tie order of the coarse search rests on this.
    x = torch.tensor([[0.0, 2.0, 1.0, 2.0, 2.0]])
    assert int(torch.argmax(x, dim=-1)) == 1


@pytest.mark.parametrize("use_kernel", [False, True])
def test_coarse_peak_ties_pick_lowest_doppler_then_code_phase(use_kernel):
    noncoh = torch.ones((2, 5, 16))
    noncoh[0, 3, 9] = noncoh[0, 1, 12] = noncoh[0, 1, 4] = 5.0  # bin 1 wins, then phase 4
    noncoh[1, 2, 7] = noncoh[1, 4, 0] = 6.0  # bin 2 wins
    d_idx, cp, strength = coarse_peak(noncoh, use_kernel)
    assert d_idx.tolist() == [1, 2]
    assert cp.tolist() == [4, 7]
    ref = coarse_peak(noncoh, not use_kernel)
    torch.testing.assert_close(strength, ref[2], rtol=1e-6, atol=0.0)


def test_matches_jax_at_4x_rate():
    fs4, l4 = 4.092e6, 4092
    sat = SyntheticSatellite(prn=11, doppler_hz=-2100.0, delay_samples=3000, amplitude=0.3)
    iq = synthesize_iq([sat], 10 * l4, fs4, noise_sigma=0.3, seed=31).reshape(10, l4)
    cfg = AcquisitionConfig()
    port = AcquisitionEngine(fs4, l4, cfg, device="cpu").detect(iq)
    jax = JaxEngine(fs4, l4, JaxAcqConfig(**dataclasses.asdict(cfg))).detect(iq)
    assert [(h.prn, h.code_phase_samples) for h in port] == [(h.prn, h.code_phase_samples) for h in jax]
    assert abs(port[0].doppler_hz - jax[0].doppler_hz) < 0.5


@pytest.mark.parametrize("kwargs", [
    {"config": AcquisitionConfig(correlator="matmul")},
    {"center_offsets_hz": tuple([0.0] * 32)},
])
def test_unported_options_raise(kwargs, block):
    """The two options that used to raise "not ported". The circulant sweep
    now builds its table and finds what the JAX engine's circulant sweep
    finds on all 32 PRNs. FDMA centers are ported: on the 32 GPS PRNs, whose
    codes differ, they raise the JAX engine's ValueError
    (gypsum_tpu/acquire/engine.py:125-131)."""
    if "center_offsets_hz" in kwargs:
        with pytest.raises(ValueError, match="one code"):
            AcquisitionEngine(FS, L, device="cpu", **kwargs)
        return
    eng = AcquisitionEngine(FS, L, device="cpu", **kwargs)
    assert eng.circulant.shape == (32, L, L) and eng.circulant.dtype == torch.bfloat16
    assert eng.prn_fft_conj is None
    port = eng.acquire_all(block)
    jax = {h.prn: h for h in JaxEngine(FS, L, JaxAcqConfig(correlator="matmul")).acquire_all(block)}
    for h in port:
        assert h.code_phase_samples == jax[h.prn].code_phase_samples, h.prn
        assert h.strength == pytest.approx(jax[h.prn].strength, rel=1e-3)
    assert {h.prn for h in port if h.detected} == {p for p, h in jax.items() if h.detected} == set(TRUTH)


# --------------------------------------------------- the circulant sweep

GLO_FS, GLO_L = 4.092e6, 4092


@pytest.fixture(scope="module")
def glonass_block():
    """10 ms of the 5-channel L1OF scene (k = -2..2), made by the JAX package."""
    from gypsum_tpu.signal.constellation import synthesize_constellation
    from gypsum_tpu.signal.scenarios import demo_glonass_constellation, demo_receiver_ecef

    iq, truth = synthesize_constellation(
        demo_glonass_constellation([-2, -1, 0, 1, 2]), demo_receiver_ecef(), 21618.0, 0.011,
        GLO_FS, noise_sigma=0.25, glonass_time_offset_s=8e-7)
    return iq[: 10 * GLO_L].reshape(10, GLO_L), truth


def _glonass_engine_args():
    from gypsum_tpu_torch.core.constants import GLONASS_L1_CHANNEL_SPACING_HZ
    from gypsum_tpu_torch.signal.prn import GLONASS_PRN_IDS, glonass_frequency_number

    return dict(prns=GLONASS_PRN_IDS, center_offsets_hz=tuple(
        glonass_frequency_number(p) * GLONASS_L1_CHANNEL_SPACING_HZ for p in GLONASS_PRN_IDS))


@pytest.mark.parametrize("family", ["gps", "fdma"])
def test_matmul_sweep_matches_the_jax_matmul_sweep(family, block, glonass_block):
    import jax.numpy as jnp

    from gypsum_tpu.ops.correlate import (
        build_circulant_table_device,
        noncoherent_acquisition_sweep_matmul as jax_sweep,
    )
    from gypsum_tpu_torch.ops.correlate import (
        build_circulant_table,
        noncoherent_acquisition_sweep_matmul,
    )
    from gypsum_tpu_torch.signal.prn import replica_table

    if family == "gps":
        fs, length, x, prns = FS, L, block, (3, 11, 20, 25, 7)
        dopplers = np.arange(-7000.0, 7001.0, 500.0, dtype=np.float32)
    else:
        fs, length, (x, _), prns = GLO_FS, GLO_L, glonass_block, (208,)
        args = _glonass_engine_args()
        coarse = np.arange(-7000.0, 7001.0, 500.0, dtype=np.float32)
        dopplers = (np.asarray(args["center_offsets_hz"], np.float32)[:, None]
                    + coarse[None, :]).reshape(-1)[::5]  # every 5th of the 406
    reps = replica_table(length, prns)
    table = build_circulant_table(reps, "cpu")
    got = noncoherent_acquisition_sweep_matmul(
        torch.from_numpy(x), torch.from_numpy(dopplers), table, fs).numpy()
    want = np.asarray(jax_sweep(jnp.asarray(x), jnp.asarray(dopplers),
                                build_circulant_table_device(jnp.asarray(reps)), fs))
    assert got.shape == want.shape == (len(prns), len(dopplers), length)
    assert np.array_equal(table.to(torch.float32).numpy(),
                          np.asarray(build_circulant_table_device(jnp.asarray(reps)), np.float32))
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("family", ["gps", "fdma"])
def test_matmul_engine_matches_the_fft_engine(family, block, glonass_block):
    if family == "gps":
        fs, length, x, kw, on_air = FS, L, block, {}, set(TRUTH)
    else:
        (x, truth), kw = glonass_block, _glonass_engine_args()
        fs, length, on_air = GLO_FS, GLO_L, set(truth.doppler_hz)
    fft = {h.prn: h for h in AcquisitionEngine(fs, length, device="cpu", **kw).acquire_all(x)}
    mat = AcquisitionEngine(fs, length, AcquisitionConfig(correlator="matmul"), device="cpu", **kw)
    if family == "fdma":
        assert mat.circulant.shape == (1, length, length)
    hits = mat.acquire_all(x)
    assert {h.prn for h in hits if h.detected} == {p for p, h in fft.items() if h.detected} == on_air
    for h in hits:
        f = fft[h.prn]
        if family == "gps" or h.prn in on_air:
            assert h.code_phase_samples == f.code_phase_samples, h.prn
            assert abs(h.doppler_hz - f.doppler_hz) < 2.0, (h, f)
        assert abs(h.strength - f.strength) < 0.05 * max(1.0, f.strength), (h, f)

"""acquire/engine.py of the port (device="cpu") against the JAX engine.

Tolerances: the coarse grid decides the PRN set and the code phase, which
must be identical; the fine Doppler and the strength come from float32 FFTs
and sums taken in another order, so |dDoppler| < 0.5 Hz and strength within
rtol 1e-3.
"""

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
def test_unported_options_raise(kwargs):
    """The circulant sweep is not ported and raises. FDMA centers are: on
    the 32 GPS PRNs, whose codes differ, they raise the JAX engine's
    ValueError (gypsum_tpu/acquire/engine.py:125-131)."""
    if "center_offsets_hz" in kwargs:
        with pytest.raises(ValueError, match="one code"):
            AcquisitionEngine(FS, L, device="cpu", **kwargs)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        AcquisitionEngine(FS, L, device="cpu", **kwargs)

"""HRC (the high-resolution, double-delta code-phase measurement) under
multipath through the port's TrackerBank, against the JAX package.

Twins of tests/test_multipath.py at 8.184 Msps (8 samples a chip,
L = 8184), every capture synthesized once and fed to both packages'
TrackerBank (the default two-phase tracker, phase 1 in float32):

- ``_track_bias``'s captures, a static PRN 25 with and without a reflected
  ray 4 samples late at half amplitude (1100 ms at ray carrier phases 0,
  2.1 and pi; 700 ms clean): each median code-phase error of the settled
  tail agrees with the JAX bank's within ``MEDIAN_SAMPLES``, and the JAX
  test's bars hold on the port (HRC's worst bias under 0.15 samples and
  under 0.6 of the triangle estimator's, which is above 0.15; clean, both
  within 0.05 and 0.08 samples);
- the scan-vs-matmul HRC parity of :88-128 on the port's plain twins: the
  scan tracker, the two-phase tracker through the fixup kernel's wrapper
  (its plain version on CPU tensors) and through the named plain chain
  (``fixup_backend="scan"``) give the same measurement stream as the JAX
  scan tracker, within that test's 5e-3 samples;
- ``test_hrc_validation``'s refusals, with the JAX messages.
"""

from tests._torch_cpu import concurrently  # isort: skip (first: caps torch's threads)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gypsum_tpu.core.config import TrackingConfig as JaxTrackingConfig
from gypsum_tpu.core.planes import to_planes
from gypsum_tpu.signal.prn import replica_table
from gypsum_tpu.track.loop import TrackerBank as JaxTrackerBank
from gypsum_tpu.track.loop import fresh_state as jax_fresh_state
from gypsum_tpu.track.loop import make_track_block_fn as jax_track_block_fn
from gypsum_tpu_torch.core.config import TrackingConfig
from gypsum_tpu_torch.signal.synth import SyntheticSatellite, synthesize_iq
from gypsum_tpu_torch.track.loop import TrackerBank, fresh_state, make_track_block_fn
from tests.test_multipath import FS, L, PRN, TRUE_DELAY

# Two float32 trackers over the same 1100 ms, summing in other orders: the
# medians of their settled tails, in samples (a sample is ~37 m here).
MEDIAN_SAMPLES = 2e-3
PHASES = (0.0, 2.1, np.pi)


def _cfg(cls, block_ms, measurement):
    """tests/test_multipath.py:_cfg for either package's TrackingConfig."""
    return cls(block_size_ms=block_ms, use_pallas_block_tracker=False, use_matmul_tracker=True,
               matmul_tracker_bf16=False, code_phase_measurement=measurement)


def _capture(ray_phase, ray_rel_amp=0.5, block_ms=1100, ray_delay_samples=4.0, seed=1):
    """tests/test_multipath.py:_track_bias's capture, [block_ms, L]."""
    sats = [SyntheticSatellite(prn=PRN, delay_samples=TRUE_DELAY, amplitude=0.2)]
    if ray_rel_amp:
        sats.append(SyntheticSatellite(prn=PRN, delay_samples=TRUE_DELAY + ray_delay_samples,
                                       amplitude=0.2 * ray_rel_amp, carrier_phase_rad=ray_phase))
    return synthesize_iq(sats, block_ms * L, FS, noise_sigma=0.05, seed=seed).reshape(block_ms, L)


def _bias(bank, block) -> float:
    """The median code-phase error (samples) of the settled tail
    (tests/test_multipath.py:57-61)."""
    bank.assign(prn=PRN, doppler_hz=0.0, code_phase_samples=TRUE_DELAY, carrier_phase_rad=0.0)
    obs = bank.process_block(block, block_start_time=0.0)[0]
    assert not obs.lost
    tail = np.asarray(obs.code_phases_measured)[-400:].astype(np.float64)
    return float(np.median((tail - TRUE_DELAY + L / 2.0) % L - L / 2.0))


def _both(block, measurement) -> tuple[float, float]:
    """(port, JAX) median bias on one capture."""
    block_ms = block.shape[0]
    port = TrackerBank(FS, L, _cfg(TrackingConfig, block_ms, measurement), n_channels=1,
                       device="cpu")
    ref = JaxTrackerBank(FS, L, _cfg(JaxTrackingConfig, block_ms, measurement), n_channels=1)
    return tuple(concurrently(lambda: _bias(port, block), lambda: _bias(ref, block)))


@pytest.fixture(scope="module")
def biases():
    """{(measurement, ray phase or None for the clean capture): (port, JAX)}."""
    out = {}
    for phase in PHASES:
        block = _capture(phase)
        for measurement in ("triangle", "hrc"):
            out[(measurement, phase)] = _both(block, measurement)
    clean = _capture(0.0, ray_rel_amp=0.0, block_ms=700)
    for measurement in ("triangle", "hrc"):
        out[(measurement, None)] = _both(clean, measurement)
    return out


@pytest.mark.parametrize("phase", PHASES + (None,), ids=["ray0", "ray2.1", "ray_pi", "clean"])
@pytest.mark.parametrize("measurement", ["triangle", "hrc"])
def test_median_bias_matches_jax(biases, measurement, phase):
    port, ref = biases[(measurement, phase)]
    assert abs(port - ref) < MEDIAN_SAMPLES, (port, ref)


def test_hrc_reduces_multipath_pseudorange_bias_on_the_port(biases):
    """tests/test_multipath.py:64-77's bars on the port's biases."""
    tri = max(abs(biases[("triangle", p)][0]) for p in PHASES)
    hrc = max(abs(biases[("hrc", p)][0]) for p in PHASES)
    assert tri > 0.15, f"scenario too benign to discriminate (tri {tri:.3f})"
    assert hrc < 0.15, f"HRC bias {hrc:.3f} samples"
    assert hrc < 0.6 * tri, f"HRC {hrc:.3f} not better than triangle {tri:.3f}"


@pytest.mark.parametrize("measurement, tol", [("triangle", 0.05), ("hrc", 0.08)])
def test_clean_signal_unbiased_on_the_port(biases, measurement, tol):
    """tests/test_multipath.py:80-85's bars on the port's clean capture."""
    assert abs(biases[(measurement, None)][0]) < tol


def test_hrc_parity_scan_vs_matmul_on_the_plain_twins():
    """tests/test_multipath.py:88-128: 48 ms of PRN 9 at 2.046 Msps, HRC,
    through the port's scan tracker and its two-phase tracker with the fixup
    kernel's wrapper (the plain version on the CPU) and with the plain chain
    by name, each against the JAX scan tracker within 5e-3 samples."""
    B, S, L0, FS0 = 48, 4, 2046, 2.046e6
    sat = SyntheticSatellite(prn=9, doppler_hz=700.0, delay_samples=100, amplitude=0.3)
    iq = synthesize_iq([sat], B * L0, FS0, noise_sigma=0.2, seed=9).reshape(B, L0)
    base = dict(block_size_ms=B, use_pallas_block_tracker=False, use_matmul_tracker=False,
                code_phase_measurement="hrc")
    reps = replica_table(L0)
    k = JaxTrackingConfig(**base).lag_window_half_width
    wide = np.concatenate([reps, reps, reps[:, : 2 * k]], axis=1).astype(np.float32)
    replicas = np.tile(wide[8][None, :], (S, 1))

    jst = jax_fresh_state(S)
    jst = jst._replace(doppler=jst.doppler + 700.0, code_phase=jst.code_phase + 100.0)
    jfn = jax_track_block_fn(JaxTrackingConfig(**base), L0, FS0, S)
    ref = np.asarray(jax.device_get(
        jfn(jst, jnp.asarray(to_planes(iq)), jnp.asarray(replicas)))[1].code_phase_measured)

    st = fresh_state(S)
    st = st._replace(doppler=st.doppler + 700.0, code_phase=st.code_phase + 100.0)
    scan = TrackingConfig(**base)
    mm = dataclasses.replace(scan, use_matmul_tracker=True, matmul_tracker_bf16=False)
    for cfg in (scan, mm, dataclasses.replace(mm, fixup_backend="scan")):
        fn = make_track_block_fn(cfg, L0, FS0, S, device="cpu")
        _, outs = fn(st, torch.from_numpy(iq), torch.from_numpy(replicas))
        np.testing.assert_allclose(np.asarray(outs.code_phase_measured), ref, atol=5e-3)


@pytest.mark.parametrize("change, match", [
    ({"code_phase_measurement": "hrc", "lag_window_half_width": 2}, "lag_window_half_width"),
    ({"code_phase_measurement": "parabola"}, "code_phase_measurement"),
], ids=["narrow_window", "unknown_measurement"])
def test_hrc_validation_refuses_as_jax_does(change, match):
    """tests/test_multipath.py:130-138: the same refusals, the same words."""
    with pytest.raises(ValueError, match=match) as ours:
        TrackerBank(FS, L, dataclasses.replace(_cfg(TrackingConfig, 10, "triangle"), **change),
                    n_channels=1, device="cpu")
    with pytest.raises(ValueError) as theirs:
        JaxTrackerBank(FS, L, dataclasses.replace(_cfg(JaxTrackingConfig, 10, "triangle"),
                                                  **change), n_channels=1)
    assert str(ours.value) == str(theirs.value)

"""The GLONASS L2OF band in the port against the JAX package: the L2OF
scene of tests/test_dualfreq.py:109-137 (k = -2..2, 3 s) through both
measurement-only band receivers (``band="glonass_l2"``, phase 1 in float32
on both sides): equal acquisitions, the L2 delays within 1 ns and their
smoothing depths and carriers equal, no strings decoded. The L1OF slice is
in tests/test_torch_glonass_receiver.py.
"""

import tests._torch_cpu  # noqa: F401  # isort: skip (first: caps torch's threads)

import dataclasses

import numpy as np
import pytest

from gypsum_tpu.core.config import ReceiverConfig as JaxReceiverConfig
from gypsum_tpu.io.sources import ArraySampleSource as JaxArraySource
from gypsum_tpu.runtime.receiver import Receiver as JaxReceiver
from gypsum_tpu.signal import constellation as jcon
from gypsum_tpu.signal import scenarios as jscn
from gypsum_tpu_torch.core.config import ReceiverConfig
from gypsum_tpu_torch.core.constants import GLONASS_L2_CHANNEL_SPACING_HZ
from gypsum_tpu_torch.io.sources import ArraySampleSource
from gypsum_tpu_torch.runtime.receiver import Receiver
from gypsum_tpu_torch.signal.prn import glonass_frequency_number

FS = 4.092e6
START_SOW = 21618.0  # a GLONASS frame boundary at t = 0 (tests/test_glonass_receiver.py)
KS = [-2, -1, 0, 1, 2]
PRNS = [208 + k for k in KS]
RX = jscn.demo_receiver_ecef()


def _f32(config_cls, **tracking):
    """A ReceiverConfig of either package with phase 1 in float32."""
    cfg = config_cls()
    return cfg.replace(tracking=dataclasses.replace(
        cfg.tracking, matmul_tracker_bf16=False, **tracking))


def _signs_by_prn(recvs):
    out: dict[int, list[np.ndarray]] = {}
    for recv in recvs:
        for report in recv.block_reports:
            for obs in report.observations:
                out.setdefault(obs.prn, []).append(np.asarray(obs.pseudosymbol_signs))
    return {p: np.concatenate(v) for p, v in out.items()}


def _acquisitions(recv):
    return [(h.prn, h.code_phase_samples) for r in recv.block_reports for h in r.newly_acquired]


@pytest.fixture(scope="module")
def l2_receivers():
    """The L2OF scene of tests/test_dualfreq.py:109-137 through both
    measurement-only band receivers."""
    iq, _ = jcon.synthesize_constellation(
        jscn.demo_glonass_constellation(KS), RX, START_SOW, 3.0, FS, noise_sigma=0.25,
        glonass_band="l2")
    ref = JaxReceiver(JaxArraySource(iq, FS), _f32(JaxReceiverConfig), band="glonass_l2",
                      attempt_fixes=False)
    ref.run()
    port = Receiver(ArraySampleSource(iq, FS), _f32(ReceiverConfig), band="glonass_l2",
                    attempt_fixes=False, device="cpu")
    port.run()
    return ref, port


def test_l2_band_acquisitions_match_jax(l2_receivers):
    ref, port = l2_receivers
    assert _acquisitions(port) == _acquisitions(ref)
    assert {p for p, _ in _acquisitions(port)} >= set(PRNS)
    spacing = GLONASS_L2_CHANNEL_SPACING_HZ
    for h in port.block_reports[0].newly_acquired:
        assert abs(h.doppler_hz - glonass_frequency_number(h.prn) * spacing) < 7000.0


def test_l2_band_delays_match_jax(l2_receivers):
    ref, port = l2_receivers
    for prn in PRNS:
        a, b = port.world._sats[prn], ref.world._sats[prn]
        assert a.l2_delay_s is not None and a.l2_smoothing_depth == b.l2_smoothing_depth >= 2
        assert a.l2_delay_s == pytest.approx(b.l2_delay_s, abs=1e-9)
        assert a.l2_carrier_hz == b.l2_carrier_hz
        assert a.tow_at_last_subframe is None  # measurement only: no decode
    assert not any(r.glonass_strings for r in port.block_reports)
    assert _signs_by_prn([port]).keys() == _signs_by_prn([ref]).keys()

"""The port's deep coast measurement (gypsum_tpu_torch/track/deepmeas.py) and
the coast tier of its default Receiver against the JAX package.

Unit level, the measurer against gypsum_tpu.track.deepmeas.DeepCoastMeasurer
on the same seeded blocks: the detection decision equal; strength,
``peak_abs`` and ``floor_abs`` within 1e-4 relative; ``cp_error_samples``
within 2e-3 samples; Doppler within 0.01 Hz (float32 wipeoff and complex64
products summed in another order; the host tail is the same numpy).

Receiver level, on stubbed worlds and banks: one device copy of a retained
block, and the host edits of a pipelined receiver, each held at both of its
epochs (ROADMAP.md §C: C1, C4-C6). The 38 s deep-fade scene through the
port and the JAX receiver is in tests/test_torch_deepcoast.py.
"""

import tests._torch_cpu  # noqa: F401  # isort: skip (first: caps torch's threads)

from types import SimpleNamespace

import numpy as np
import pytest

from gypsum_tpu.core.config import TrackingConfig as JaxTrackingConfig
from gypsum_tpu.core.constants import GPS_L1_FREQUENCY_HZ
from gypsum_tpu.signal.constellation import synthesize_constellation
from gypsum_tpu.signal.prn import ALL_PRN_IDS
from gypsum_tpu.signal.scenarios import DEMO_GPS_START_SOW, demo_constellation
from gypsum_tpu.solve.geodesy import lla_to_ecef
from gypsum_tpu.track.deepmeas import DeepCoastMeasurer as JaxMeasurer
from gypsum_tpu.track.deepmeas import xcorr_suspect as jax_xcorr_suspect
from gypsum_tpu_torch.core.config import ReceiverConfig, TrackingConfig
from gypsum_tpu_torch.io.sources import ArraySampleSource
from gypsum_tpu_torch.runtime.receiver import Receiver
from gypsum_tpu_torch.track.deepmeas import CA_XCORR_PEAK, DeepCoastMeasurer, xcorr_suspect

FS = 2.046e6
L = 2046
RX = lla_to_ecef(51.5, -0.1, 80.0)


def _measurers():
    return (DeepCoastMeasurer(FS, L, ALL_PRN_IDS, TrackingConfig(), device="cpu"),
            JaxMeasurer(FS, L, ALL_PRN_IDS, JaxTrackingConfig()))


def _hold(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    assert a.detected == b.detected and a.groups == b.groups
    assert a.strength == pytest.approx(b.strength, rel=1e-4)
    assert a.peak_abs == pytest.approx(b.peak_abs, rel=1e-4)
    assert a.floor_abs == pytest.approx(b.floor_abs, rel=1e-4)
    assert abs(a.cp_error_samples - b.cp_error_samples) < 2e-3
    assert abs(a.doppler_hz - b.doppler_hz) < 0.01


@pytest.fixture(scope="module")
def weak_block():
    """PRN 25 at -17 dB against the nominal scene amplitude, 1.2 s."""
    sats = demo_constellation([25], amplitude=0.03)
    return synthesize_constellation(sats, RX, DEMO_GPS_START_SOW, 1.2, FS, noise_sigma=0.35,
                                    seed=3)


def test_measurer_matches_jax_below_loop_threshold(weak_block):
    """A deliberately wrong prediction (2.6 samples, 11 Hz off) is measured
    back as the JAX measurer measures it, to ~0.1 sample and ~1 Hz of truth."""
    iq, truth = weak_block
    port, ref = _measurers()
    f_true, cp_true = truth.doppler_hz[25], truth.code_phase_samples[25]
    drift = -(f_true + 11.0) * FS / GPS_L1_FREQUENCY_HZ
    args = (iq[: 1000 * L], 25, (cp_true + 2.6) % L, drift, f_true + 11.0)
    a = port.measure(*args)
    _hold(a, ref.measure(*args))
    assert a.detected and abs(a.cp_error_samples + 2.6) < 0.15
    assert abs(a.doppler_hz - f_true) < 2.0
    # A block already on the device (a tensor) measures the same.
    import torch

    _hold(port.measure(torch.from_numpy(iq[: 1000 * L]), *args[1:]), a)


def test_measurer_matches_jax_on_noise():
    """Noise only: no detection on either side, the same strengths."""
    rng = np.random.default_rng(7)
    n = 600 * L
    iq = ((rng.standard_normal(n) + 1j * rng.standard_normal(n)) / np.sqrt(2.0) * 0.35
          ).astype(np.complex64)
    port, ref = _measurers()
    for prn, cp, f in [(25, 100.0, -1500.0), (28, 900.3, 2200.0)]:
        args = (iq, prn, cp, -f * FS / GPS_L1_FREQUENCY_HZ * 0.6, f)
        a = port.measure(*args)
        _hold(a, ref.measure(*args))
        assert not a.detected


def test_static_offset_is_wiped_in_float64(weak_block):
    """A channel at a GLONASS k = 7 sub-band offset (3.9375 MHz) measures as
    a baseband one does, and as the JAX measurer's host float64 wipe does."""
    iq, truth = weak_block
    off = 3_937_500.0
    n = 1000 * L
    t = np.arange(n, dtype=np.float64) / FS
    shifted = (iq[:n] * np.exp(2j * np.pi * off * t)).astype(np.complex64)
    port, ref = _measurers()
    f_true, cp_true = truth.doppler_hz[25], truth.code_phase_samples[25]
    args = (shifted, 25, cp_true % L, -f_true * FS / GPS_L1_FREQUENCY_HZ, f_true)
    a = port.measure(*args, static_offset_hz=off)
    _hold(a, ref.measure(*args, static_offset_hz=off))
    assert a.detected and abs(a.cp_error_samples) < 0.15 and abs(a.doppler_hz - f_true) < 2.0


def test_short_block_returns_none():
    port, _ = _measurers()
    assert port.measure(np.zeros(50 * L, np.complex64), 25, 0.0, 0.0, 0.0) is None
    assert port.calls == 0
    with pytest.raises(ValueError, match="odd"):
        DeepCoastMeasurer(FS, L, ALL_PRN_IDS, TrackingConfig(coast_meas_doppler_bins=4),
                          device="cpu")


def test_xcorr_suspect_matches_jax():
    live = [(1000.0 - 12.0, 450.0)]
    bound = 450.0 * 10 * 100 * CA_XCORR_PEAK
    cases = [
        (-12.0, bound, live, True),  # folded onto a code line, sidelobe level
        (-12.0, 3.0 * bound, live, False),  # far stronger than a sidelobe
        (400.0, bound, live, False),  # off every code line
        (-12.0, bound, [], False),  # nothing live to veto against
    ]
    for f, peak, channels, expect in cases:
        assert xcorr_suspect(f, peak, 100, 10, channels, 60.0, 2.0) is expect
        assert jax_xcorr_suspect(f, peak, 100, 10, channels, 60.0, 2.0) is expect


def test_crosscorr_artefact_is_measured_and_vetoed_as_in_jax():
    """A strong live PRN 25 and an absent target PRN: scanning dead PRNs x
    code lines x code phases as tests/test_deepcoast.py does, the port's
    first raw detection is a sidelobe artefact that the JAX measurer also
    detects, with the same numbers, and that the veto catches."""
    sats = demo_constellation([25], amplitude=0.22)
    iq, truth = synthesize_constellation(sats, RX, DEMO_GPS_START_SOW, 1.2, FS,
                                         noise_sigma=0.35, seed=11)
    port, ref = _measurers()
    f_live = truth.doppler_hz[25]
    block = iq[: 1000 * L]
    hit = None
    for prn in (1, 7, 13, 21, 29):
        for line in (-2000.0, -1000.0, 0.0, 1000.0, 2000.0):
            f_pred = f_live + line
            for cp in (150.0, 700.0, 1300.0, 1900.0):
                args = (block, prn, cp, -f_pred * FS / GPS_L1_FREQUENCY_HZ, f_pred)
                res = port.measure(*args)
                if res.detected:
                    hit = (args, res)
                    break
            if hit:
                break
        if hit:
            break
    assert hit is not None, "expected at least one sidelobe false detection"
    args, res = hit
    _hold(res, ref.measure(*args))
    assert xcorr_suspect(res.doppler_hz, res.peak_abs, res.groups, 10,
                         [(f_live, 0.22 * L)], 60.0, 2.0)


# ------------------------------------------------- the receiver, stubbed


def test_coast_uploads_a_retained_block_once():
    """Every coasting channel of one block is measured from one device copy
    of the retained block (runtime/coast.py)."""
    recv = Receiver(ArraySampleSource(np.zeros(2046 * 20, np.complex64), FS), device="cpu")
    raw = np.zeros((1000, 2046), np.complex64)
    recv._coast_raw[0] = raw
    recv._coast_prediction = lambda prn, pipe, t: (1e-4, 100.0)
    pipe = SimpleNamespace(carrier_offset_hz=0.0)
    for prn in (25, 28):
        assert recv._deep_coast_measurement(SimpleNamespace(prn=prn), pipe, 0.0, 1000) is None
    first = recv._coast_raw_dev
    assert first is not None and first[0] == 0
    recv._deep_coast_measurement(SimpleNamespace(prn=31), pipe, 0.0, 1000)
    assert recv._coast_raw_dev is first and recv._coast_measurer.calls == 3


# ------------------------------------------- host edits of a pipelined bank
# Pipelined, the host edits the carry while one block is in flight: each edit
# is evaluated at the COLLECTED block's end and takes effect when the next
# dispatch starts, one block later. Each case holds both epochs.


def _prediction(prn, pipe, t):
    """A coast prediction that moves with ``t``: a delay walking 1 us/s and a
    Doppler 1 Hz/s (any epoch mix-up shows as a different value)."""
    return (1e-4 + 1e-6 * t) % 1e-3, 100.0 + t


@pytest.mark.parametrize("pending_ms", [1000, 0], ids=["pipelined", "unpipelined"])
def test_coast_entry_anchors_the_world_model_at_the_processed_block(pending_ms):
    """Coast entry on the block that ends at 24 s: the NCO override is the
    prediction for the next dispatch's start (24 s + what is in flight), the
    world model's Hatch anchor the prediction at 24 s, where the world model
    stands (runtime/coast.py:_enter_coast)."""
    recv = Receiver(ArraySampleSource(np.zeros(2046 * 20, np.complex64), FS), device="cpu")
    t_end, begun, overrides = 24.0, [], []
    recv.world = SimpleNamespace(
        predicted_range_and_rate=lambda prn, t: (2.0e7, 0.0),
        position_fixes=[SimpleNamespace(receiver_timestamp=t_end - 1.0)],
        begin_coast=lambda prn, delay: begun.append((prn, delay)))
    recv.bank = SimpleNamespace(pending_ms=pending_ms,
                                coast_override=lambda slot, cp, f: overrides.append((slot, cp, f)))
    recv._coast_prediction = _prediction
    pipe = SimpleNamespace(last_good=(22.0, 1e-4, 100.0), glonass=None, sbas=None, slot=3)
    obs = SimpleNamespace(prn=25, quality=np.array([0.1]))
    assert recv._enter_coast(obs, pipe, t_end)
    t_apply = t_end + pending_ms * 1e-3
    assert begun == [(25, _prediction(25, pipe, t_end)[0])]
    d, f = _prediction(25, pipe, t_apply)
    assert overrides == [(3, d * FS, f)]
    assert pipe.coast_started == t_end and pipe.coast_anchor == (22.0, 1e-4, 100.0)


@pytest.mark.parametrize("anchor_s, blocks_off", [(0.0, 0.0), (1.0, 0.5)],
                         ids=["processed_block_end", "next_dispatch"])
def test_hatch_anchor_epoch_sets_the_coast_offset(anchor_s, blocks_off):
    """The world model after begin_coast and one 1000 ms update with the
    prediction as its measurement (solve/world_measurements.py): anchored at
    its own epoch it carries no offset; anchored one block later (the slip)
    it is off by half a block of range rate (depth 2), and the offset decays
    only as 1/depth over the coast."""
    from gypsum_tpu_torch.core.config import SolverConfig
    from gypsum_tpu_torch.solve.world import WorldModel

    doppler = 2724.0
    rate_s = doppler / GPS_L1_FREQUENCY_HZ  # delay change per second of signal

    def delay(t):
        return 3e-4 - rate_s * t

    world = WorldModel(SolverConfig())
    world.begin_coast(25, delay(anchor_s))
    rec = world._record(25)
    world._update_carrier_smoothing(rec, delay(1.0), 1000, doppler)
    off_m = (rec.smoothed_delay_s - delay(1.0)) * 299792458.0
    assert rec.smoothing_depth == 2
    assert off_m == pytest.approx(-blocks_off * rate_s * 299792458.0, abs=1e-6)


@pytest.mark.parametrize("pipelined", [True, False], ids=["pipelined", "unpipelined"])
def test_in_flight_block_is_retained_for_a_coast_decided_later(pipelined):
    """Pipelined, a channel that enters coast on the collected block is deep
    measured on the block in flight, dispatched before that decision: every
    in-flight block is retained (runtime/receiver.py:step_block), so the
    first measurement comes on the same block as unpipelined. Unpipelined,
    nothing is retained while no channel coasts."""
    iq = np.zeros(2046 * 400, np.complex64)
    cfg = ReceiverConfig(tracking=TrackingConfig(block_size_ms=100, pipeline_tracking=pipelined,
                                                 matmul_tracker_bf16=False))
    recv = Receiver(ArraySampleSource(iq, FS), cfg, device="cpu")
    recv.step_block()
    recv.step_block()
    assert sorted(recv._coast_raw) == ([100] if pipelined else [])
    if pipelined:
        assert recv._coast_raw[100] is not None and recv._retained_block(100).shape == (100, L)


def test_retained_integer_planes_convert_when_measured():
    """Integer planes are retained as read and dequantized once, when a
    coasting channel measures them (runtime/coast.py:_retained_block)."""
    recv = Receiver(ArraySampleSource(np.zeros(2046 * 20, np.complex64), FS), device="cpu")
    planes = np.random.default_rng(2).integers(0, 256, (3, L, 2), dtype=np.uint8)
    recv._coast_raw[7] = (planes, 127.5)
    got = recv._retained_block(7)
    want = (planes[..., 0] - 127.5) + 1j * (planes[..., 1] - 127.5)
    assert got.dtype == np.complex64 and np.array_equal(got, want.astype(np.complex64))
    assert recv._retained_block(7) is got and recv._retained_block(8) is None


def test_pipelined_rescue_lands_where_unpipelined_does():
    """A marginal channel's rescue (track/loop.py:maybe_rescue) measures its
    Doppler residual on the collected block. Pipelined, the carry has run one
    more block on its own loop by then: the new Doppler must be the collected
    block's NCO plus the residual, as unpipelined, not the wandered carry's."""
    from gypsum_tpu_torch.track.loop import TrackerBank

    cfg = TrackingConfig(matmul_tracker_bf16=False, quality_window_ms=100)
    rng = np.random.default_rng(5)
    blocks = [((rng.standard_normal((200, L)) + 1j * rng.standard_normal((200, L))) * 0.35
               ).astype(np.complex64) for _ in range(2)]
    res_hz, t_ms = 7.0, 1e-3
    n = np.arange(250)
    marginal = SimpleNamespace(slot=0, lost=False, quality=np.array([0.3]),
                               prompts=np.exp(2j * np.pi * res_hz * n * t_ms).astype(np.complex64))
    banks = []
    for pipelined in (True, False):
        bank = TrackerBank(FS, L, cfg, n_channels=1, device="cpu")
        bank.assign(prn=25, doppler_hz=1500.0, code_phase_samples=100.0, carrier_phase_rad=0.0)
        bank.dispatch_block(blocks[0], 0.0)
        if pipelined:
            bank.dispatch_block(blocks[1], 0.2)
        bank.collect_block()
        bank.sync_host_state()
        carry = float(bank.state.doppler[0])
        assert bank.maybe_rescue(marginal, 0.2)
        banks.append((carry, float(bank.state.doppler[0])))
    (piped_carry, piped), (collected, unpiped) = banks
    assert abs(piped_carry - collected) > 0.01  # the loop wandered over the in-flight block
    assert unpiped == pytest.approx(collected + res_hz, abs=1e-3)
    assert piped == unpiped


def test_dual_band_refuses_mixed_pipelining():
    """Every band writes its processed block into the shared world model:
    one band a block deeper in flight would feed it observables a block
    older than the owner's fix epoch (runtime/dualband.py)."""
    from gypsum_tpu_torch.runtime.dualband import DualBandReceiver

    src = ArraySampleSource(np.zeros(2046 * 20, np.complex64), FS)
    glo = ArraySampleSource(np.zeros(4092 * 20, np.complex64), 4.092e6)
    cfg = ReceiverConfig(tracking=TrackingConfig(pipeline_tracking=True))
    with pytest.raises(ValueError, match="pipeline_tracking"):
        DualBandReceiver(gps_source=src, glonass_source=glo, config=cfg,
                         glonass_config=ReceiverConfig(), device="cpu")

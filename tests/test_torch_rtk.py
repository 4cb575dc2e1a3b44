"""The rtk slice of the port against the JAX package: solve/rtk.py,
solve/attitude.py and the receivers that feed them.

- **The copies, unit by unit** (milliseconds each): ``_ltdl``,
  ``_decorrelate``, ``integer_least_squares``, ``bootstrap_success_rate``,
  ``solve_baseline``, ``solve_kinematic``, ``solve_attitude`` and
  ``heading_pitch_of`` on the model-level inputs of tests/test_rtk.py and
  tests/test_attitude.py, and ``estimate_stream_alignment``,
  ``time_transfer`` and ``form_double_differences`` on the JAX receivers'
  phase logs below, through both packages: equal integers and every float
  equal to the bit.
- **The phase log cross-fed**: the port's ``CarrierPhaseLog`` fed the JAX
  receiver's observations gives the JAX log's arcs to the bit, and the JAX
  log fed the port receiver's observations gives the port log's; the
  port's receiver pipelined (as it runs on the card: each block's
  observations one block late, the last drained at the end) gives its
  unpipelined arcs to the bit.
- **The slice as a whole**: a base and rover pair of the static scene of
  tests/test_rtk.py:223-270 (the six demo PRNs, noise 0.25, the rover at
  ENU (11, -7.5, 2) m from the base at 51.5 deg, -0.1 deg, 80 m), cut to
  5 s, through the JAX ``Receiver`` and the port's ``Receiver(device="cpu")``
  with the default config, each with a ``CarrierPhaseLog``, a
  ``RinexObsWriter`` and an ``NmeaWriter`` attached. Held: the same PRNs and
  arc counts, ``max_pin_residual_rad < 0.5`` on both, DD phases within 0.02
  half-cycles of each other at every epoch, the same fixed/float decision
  and integers, fixed baselines within 1 mm of each other (and of the truth
  within 10 mm, the JAX test's bar).

  Why 5 s: the solve weights the phase at the tracker's measured noise,
  ``sigma_phase_half_cycles=0.006`` (as tests/test_rtk.py's kinematic test
  and tests/test_attitude.py's end-to-end test do), with the static test's 200 ms
  epochs after a 2 s settle. There the JAX package fixes from 5 s (ratio
  8.35, bootstrap success 0.998); at 4 s it does not (bootstrap 0.980 under
  the 0.99 gate). At the static test's default weight of 0.02 it does not
  fix at 8, 9 or 10 s either (bootstrap 0.946-0.976), and the pair's
  synthesis costs ~2.5 s of host per second of signal. No handover word is
  decoded within 5 s (the first comes at ~12 s on this scene,
  tests/test_assist.py), so both writers stay empty here, equally;
  tests/test_torch_exports.py holds the exports.
"""

from __future__ import annotations

import tests._torch_cpu  # noqa: F401  # isort: skip (first: caps torch's threads)

import dataclasses
import itertools

import numpy as np
import pytest

import gypsum_tpu.solve.attitude as jax_attitude
import gypsum_tpu.solve.rtk as jax_rtk
import gypsum_tpu_torch.solve.attitude as port_attitude
import gypsum_tpu_torch.solve.rtk as port_rtk
from gypsum_tpu.core.constants import GPS_L1_FREQUENCY_HZ, SPEED_OF_LIGHT_M_PER_S
from gypsum_tpu.signal.scenarios import DEMO_EPHEMERIDES, DEMO_GPS_START_SOW, DEMO_PRNS_8
from gypsum_tpu.solve.geodesy import enu_basis, lla_to_ecef

FS = 2.046e6
PRNS = DEMO_PRNS_8[:6]
BASE = lla_to_ecef(51.5, -0.1, 80.0)
EAST, NORTH, UP = enu_basis(BASE)
TRUTH = 11.0 * EAST - 7.5 * NORTH + 2.0 * UP
SECONDS = 5.0
SOLVE = dict(sigma_phase_half_cycles=0.006)
DD_ARGS = dict(prns=PRNS, epoch_every_ms=200, settle_ms=2000)
SCALE = 2.0 * GPS_L1_FREQUENCY_HZ / SPEED_OF_LIGHT_M_PER_S


def assert_same(a, b, where="value"):
    """Equal to the bit: dataclasses field by field, arrays elementwise
    (NaN equal to NaN), containers item by item."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, where
        assert np.array_equal(a, b, equal_nan=a.dtype.kind in "fc"), where
    elif isinstance(a, float) and np.isnan(a):
        assert isinstance(b, float) and np.isnan(b), where
    else:
        assert a == b, f"{where}: {a!r} != {b!r}"


def sv_fn(rtk, prns=PRNS):
    eph = {p: DEMO_EPHEMERIDES[DEMO_PRNS_8.index(p)] for p in prns}
    return rtk.sv_position_fn_from_ephemerides(eph, DEMO_GPS_START_SOW)


def _random_spd(n, rng):
    a = rng.normal(size=(n, n))
    return a @ a.T + 0.05 * np.eye(n)


def _model_dd(rtk):
    """tests/test_rtk.py::test_solver_recovers_synthetic_baseline's DDs."""
    base = lla_to_ecef(51.5, -0.1, 80.0)
    truth = 14.0 * EAST + 6.0 * NORTH + 1.5 * UP
    fn = sv_fn(rtk)
    ref, others = PRNS[-1], PRNS[:-1]
    epochs = np.arange(2.0, 60.0, 1.0)
    sv_s = np.stack([[fn(p, t) for p in others] for t in epochs])
    sv_r = np.stack([[fn(ref, t)] for t in epochs])
    rho = rtk._dd_rho((base + truth)[None, None, :], base, sv_s, sv_r)
    rng = np.random.default_rng(11)
    a_true = rng.integers(-40, 40, size=len(others)).astype(float)
    return rtk.DDObservations(
        prns=others, ref_prn=ref, epochs_s=epochs,
        phase_half_cycles=-SCALE * rho + a_true + rng.normal(0, 0.02, rho.shape),
        code_m=rho + rng.normal(0, 0.6, rho.shape),
    ), fn, base


def _platform_dd(rtk, prns, separation, headings, pitch, epochs, seed=7):
    """tests/test_attitude.py::_rotating_platform_dd."""
    hz, pz = np.radians(np.asarray(headings)), np.radians(pitch)
    arm = (np.cos(pz) * (np.sin(hz)[:, None] * EAST + np.cos(hz)[:, None] * NORTH)
           + np.sin(pz) * UP)
    rover_t = BASE + separation * arm
    fn = sv_fn(rtk, prns)
    ref, others = prns[-1], prns[:-1]
    sv_s = np.stack([[fn(p, t) for p in others] for t in epochs])
    sv_r = np.stack([[fn(ref, t)] for t in epochs])
    rho = np.stack([
        rtk._dd_rho(rover_t[t][None, None, :], BASE, sv_s[t:t + 1], sv_r[t:t + 1, 0:1, :])[0]
        for t in range(len(epochs))
    ])
    rng = np.random.default_rng(seed)
    a_true = rng.integers(-30, 30, size=len(others)).astype(float)
    return rtk.DDObservations(
        prns=others, ref_prn=ref, epochs_s=np.asarray(epochs, float),
        phase_half_cycles=-SCALE * rho + a_true + rng.normal(0, 0.01, rho.shape),
        code_m=rho + rng.normal(0, 0.5, rho.shape),
    ), fn


def _case_ltdl(rtk, attitude):
    rng = np.random.default_rng(7)
    return [rtk._ltdl(_random_spd(6, rng)) for _ in range(20)]


def _case_decorrelate(rtk, attitude):
    rng = np.random.default_rng(7)
    return [rtk._decorrelate(_random_spd(6, rng)) for _ in range(20)]


def _case_ils(rtk, attitude):
    out = []
    for trial in range(15):
        rng = np.random.default_rng(100 + trial)
        q = _random_spd(4, rng)
        out.append(rtk.integer_least_squares(rng.uniform(-3, 3, size=4), q, n_cand=2))
    return out


def _case_bootstrap(rtk, attitude):
    rng = np.random.default_rng(5)
    return [rtk.bootstrap_success_rate(0.01 * _random_spd(5, rng)) for _ in range(10)]


def _case_solve_baseline(rtk, attitude):
    dd, fn, base = _model_dd(rtk)
    return rtk.solve_baseline(dd, fn, base), rtk.solve_baseline(dd, fn, base, fix=False)


def _case_solve_kinematic(rtk, attitude):
    dd, fn, base = _model_dd(rtk)
    return rtk.solve_kinematic(dd, fn, base, sigma_phase_half_cycles=0.006)


def _case_attitude_ratio(rtk, attitude):
    epochs = np.arange(2.0, 32.0, 1.0)
    dd, fn = _platform_dd(rtk, PRNS, 2.0, np.linspace(40.0, 100.0, len(epochs)), 5.0, epochs)
    return attitude.solve_attitude(dd, fn, BASE, separation_m=2.0, sigma_phase_half_cycles=0.01)


def _case_attitude_length(rtk, attitude):
    prns = PRNS[:5]
    epochs = np.arange(2.0, 14.0, 1.0)
    dd, fn = _platform_dd(rtk, prns, 1.5, np.linspace(310.0, 335.0, len(epochs)), -3.0,
                          epochs, seed=3)
    return attitude.solve_attitude(dd, fn, BASE, separation_m=1.5, sigma_phase_half_cycles=0.01,
                                   ratio_threshold=1e9)


def _case_attitude_wrong_separation(rtk, attitude):
    epochs = np.arange(2.0, 22.0, 1.0)
    dd, fn = _platform_dd(rtk, PRNS, 2.0, np.linspace(40.0, 80.0, len(epochs)), 5.0, epochs)
    return attitude.solve_attitude(dd, fn, BASE, separation_m=2.5, sigma_phase_half_cycles=0.01)


def _case_heading_pitch(rtk, attitude):
    b = np.stack([2.0 * NORTH, 3.0 * EAST, NORTH + EAST + np.sqrt(2.0) * UP, -NORTH])
    return attitude.heading_pitch_of(b, BASE), attitude.heading_pitch_of(b[2], BASE)


MODEL_CASES = {name[6:]: fn for name, fn in globals().items() if name.startswith("_case_")}


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_copies_agree_to_the_bit(case):
    want = MODEL_CASES[case](jax_rtk, jax_attitude)
    got = MODEL_CASES[case](port_rtk, port_attitude)
    assert_same(want, got, case)


# --------------------------------------------------------------------------
# The slice: two receivers of each package over the same pair
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    from gypsum_tpu.signal.constellation import synthesize_constellation
    from gypsum_tpu.signal.scenarios import demo_constellation

    sats = demo_constellation(PRNS)
    return [
        synthesize_constellation(sats, rx, DEMO_GPS_START_SOW, SECONDS, FS, noise_sigma=0.25)[0]
        for rx in (BASE, BASE + TRUTH)
    ]


def _run(pkg, iq, **tracking):
    """One receiver of package ``pkg`` over ``iq`` with the three listeners
    attached (``tracking`` fields set on the port's default config);
    returns (receiver, phase log, RINEX writer, NMEA writer)."""
    if pkg == "jax":
        from gypsum_tpu.core.config import ReceiverConfig
        from gypsum_tpu.io.sources import ArraySampleSource
        from gypsum_tpu.obs.nmea import NmeaWriter
        from gypsum_tpu.obs.rinex import RinexObsWriter
        from gypsum_tpu.runtime.receiver import Receiver

        recv = Receiver(ArraySampleSource(iq, FS), ReceiverConfig(), eligible_prns=PRNS)
        rtk = jax_rtk
    else:
        from gypsum_tpu_torch.core.config import ReceiverConfig
        from gypsum_tpu_torch.io.sources import ArraySampleSource
        from gypsum_tpu_torch.obs.nmea import NmeaWriter
        from gypsum_tpu_torch.obs.rinex import RinexObsWriter
        from gypsum_tpu_torch.runtime.receiver import Receiver

        cfg = ReceiverConfig()
        cfg = cfg.replace(tracking=dataclasses.replace(cfg.tracking, **tracking))
        recv = Receiver(ArraySampleSource(iq, FS), cfg, eligible_prns=PRNS, device="cpu")
        rtk = port_rtk
    log = rtk.CarrierPhaseLog(recv.sample_rate, recv.samples_per_prn, recv.config.tracking)
    rinex, nmea = RinexObsWriter(recv), NmeaWriter()
    for listener in (log.listener(), rinex.on_block, nmea.on_block):
        recv.add_block_listener(listener)
    recv.run()
    return recv, log, rinex, nmea


@pytest.fixture(scope="module")
def runs(pair):
    return {pkg: [_run(pkg, iq) for iq in pair] for pkg in ("jax", "port")}


def _observations(recv):
    return [obs for report in recv.block_reports for obs in report.observations]


@pytest.mark.parametrize("source", ["jax", "port"])
def test_phase_logs_cross_fed_give_the_same_arcs(runs, source):
    """Each package's CarrierPhaseLog over one package's observations, in
    block order per PRN: the arcs and the pin residual equal to the bit."""
    for recv, own_log, _, _ in runs[source]:
        logs = [rtk.CarrierPhaseLog(recv.sample_rate, recv.samples_per_prn, recv.config.tracking)
                for rtk in (jax_rtk, port_rtk)]
        for obs in _observations(recv):
            for log in logs:
                log.ingest(obs)
        for log in logs:
            assert_same(own_log.arcs, log.arcs, "arcs")
            assert log.max_pin_residual_rad == own_log.max_pin_residual_rad


def test_pipelined_receiver_gives_the_same_arcs(pair, runs):
    """The card's receiver pipelines (each block's observations reach the
    listeners one block late, the last drained at the end of ``run()``):
    pipelined on the CPU, the port's base receiver gives its unpipelined
    run's arcs to the bit."""
    _, log, _, _ = _run("port", pair[0], pipeline_tracking=True)
    assert_same(runs["port"][0][1].arcs, log.arcs, "arcs")


def test_slice_same_satellites_and_arcs(runs):
    for (_, jlog, _, _), (_, plog, _, _) in zip(runs["jax"], runs["port"]):
        assert sorted(jlog.arcs) == sorted(plog.arcs) == sorted(PRNS)
        assert {p: len(a) for p, a in plog.arcs.items()} == {p: len(a) for p, a in jlog.arcs.items()}
        assert jlog.max_pin_residual_rad < 0.5 and plog.max_pin_residual_rad < 0.5


def _dd(runs, pkg):
    rtk = jax_rtk if pkg == "jax" else port_rtk
    return rtk.form_double_differences(runs[pkg][0][1], runs[pkg][1][1], **DD_ARGS)


def test_slice_double_differences_agree(runs):
    """The same epochs and satellites; DD phases within 0.02 half-cycles of
    each other at every epoch (0.0022 measured), DD codes within 0.5 m
    (0.089 measured)."""
    want, got = _dd(runs, "jax"), _dd(runs, "port")
    assert (got.prns, got.ref_prn) == (want.prns, want.ref_prn)
    assert np.array_equal(got.epochs_s, want.epochs_s)
    d = got.phase_half_cycles - want.phase_half_cycles
    assert np.max(np.abs(d)) < 0.02, np.max(np.abs(d))
    assert np.max(np.abs(got.code_m - want.code_m)) < 0.5


def test_slice_same_fix(runs):
    want = jax_rtk.solve_baseline(_dd(runs, "jax"), sv_fn(jax_rtk), BASE, **SOLVE)
    got = port_rtk.solve_baseline(_dd(runs, "port"), sv_fn(port_rtk), BASE, **SOLVE)
    assert want.fixed, f"the JAX package does not fix the {SECONDS} s pair (ratio {want.ratio})"
    assert got.fixed == want.fixed
    assert np.array_equal(got.ambiguities, want.ambiguities)
    assert np.linalg.norm(got.baseline_fixed_m - want.baseline_fixed_m) < 1e-3
    assert np.linalg.norm(got.baseline_fixed_m - TRUTH) < 0.010


@pytest.mark.parametrize("fn", ["estimate_stream_alignment", "time_transfer",
                                "form_double_differences"])
def test_log_functions_agree_to_the_bit(runs, fn):
    """The functions that read phase logs, on the JAX receivers' logs."""
    logs = [r[1] for r in runs["jax"]]

    def call(rtk):
        if fn == "estimate_stream_alignment":
            return rtk.estimate_stream_alignment(*logs, prns=PRNS, coarse_offset_s=0.0)
        if fn == "time_transfer":
            return rtk.time_transfer(*logs, BASE, BASE + TRUTH, sv_fn(rtk))
        return rtk.form_double_differences(*logs, **DD_ARGS)

    assert_same(call(jax_rtk), call(port_rtk), fn)


def test_slice_writers_agree(runs):
    """The RINEX and NMEA writers of both packages hold the same epochs and
    sentences (none within 5 s: no handover word yet)."""
    for (_, _, jr, jn), (_, _, pr, pn) in zip(runs["jax"], runs["port"]):
        assert len(pr.epochs) == len(jr.epochs)
        assert pn.lines == jn.lines and pn.n_fixes == jn.n_fixes


def test_ils_matches_brute_force_in_the_port():
    """The port's search finds the exact minimizer and runner-up over the
    integer lattice (tests/test_rtk.py's brute-force check)."""
    rng = np.random.default_rng(100)
    q = _random_spd(4, rng)
    a = rng.uniform(-3, 3, size=4)
    cands, costs = port_rtk.integer_least_squares(a, q, n_cand=2)
    qi = np.linalg.inv(q)
    brute = sorted(
        (float((a - z) @ qi @ (a - z)), tuple(z))
        for z in (np.round(a) + np.array(off) for off in itertools.product(range(-5, 6), repeat=4))
    )
    assert tuple(cands[0]) == brute[0][1]
    assert costs[0] == pytest.approx(brute[0][0], rel=1e-9)
    assert costs[1] == pytest.approx(brute[1][0], rel=1e-9)

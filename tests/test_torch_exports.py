"""The exports and the assisted start of the port against the JAX package:
obs/rinex.py, obs/nmea.py, replay's --rinex-obs/--rinex-nav/--nmea-out and
--assist-nav/--assist-time, and rtk's RINEX mode.

- **Round trips, byte for byte**: ``render_nav`` of the six demo
  ephemerides, ``render_nav_glonass`` of three GLONASS satellites and the
  MIXED file of both, ``render_obs_merged`` of hand-built GPS, SBAS and
  GLONASS rows (tests/test_rinex.py:43-89) and of the model observation
  files below, and the NMEA burst of one fix (GGA, GSA, RMC, VTG, GSV in
  chunks of four, ZDA): identical text from both packages; each parses
  back through the other package's parser to equal values, and every
  NMEA checksum is valid.
- **The CLIs side by side**: both packages' ``rtk`` in RINEX mode on two
  model observation files (full pseudoranges, RINEX-sign carrier with
  known half-cycle ambiguities; tests/test_rinex.py:92-140) and a NAV file
  of their six orbits, static and ``--attitude``: the same printed lines.
  Both packages' ``replay --assist-nav --assist-time --rinex-obs
  --rinex-nav --nmea-out --duration 4`` on 4 s of the six demo satellites
  (noise 0.25) with a NAV file rendered from ``DEMO_EPHEMERIDES`` and an
  assist time 7.5 s late: the same SNAPSHOT lines within 1 m, NMEA files
  with the same sentence types and count, positions within 1 m, every
  checksum valid, and NAV files that parse to the same ephemerides. In 4 s
  no handover word is decoded (the first comes at ~12 s), so neither
  package writes an OBS file or an NMEA sentence: that is held too.
"""

from __future__ import annotations

import tests._torch_cpu  # noqa: F401  # isort: skip (first: caps torch's threads)

import contextlib
import io
import re

import numpy as np
import pytest

import gypsum_tpu.obs.nmea as jax_nmea
import gypsum_tpu.obs.rinex as jax_rinex
import gypsum_tpu_torch.obs.nmea as port_nmea
import gypsum_tpu_torch.obs.rinex as port_rinex
from gypsum_tpu.cli.main import main as jax_main
from gypsum_tpu.core.constants import GPS_L1_FREQUENCY_HZ, SPEED_OF_LIGHT_M_PER_S as C
from gypsum_tpu.signal.scenarios import DEMO_EPHEMERIDES, DEMO_GPS_START_SOW, DEMO_PRNS_8
from gypsum_tpu.solve.geodesy import enu_basis, lla_to_ecef
from gypsum_tpu_torch.cli.main import main as port_main
from tests.test_torch_rtk import assert_same

FS = 2.046e6
PRNS = DEMO_PRNS_8[:6]
EPH = {p: DEMO_EPHEMERIDES[DEMO_PRNS_8.index(p)] for p in PRNS}
BASE_LLA = ("51.5", "-0.1", "80")
BASE = lla_to_ecef(51.5, -0.1, 80.0)
LAMBDA_L1 = C / GPS_L1_FREQUENCY_HZ


def both(fn):
    """``fn(rinex, nmea)`` through the JAX modules, then the port's."""
    return fn(jax_rinex, jax_nmea), fn(port_rinex, port_nmea)


# --------------------------------------------------------------------------
# RINEX round trips
# --------------------------------------------------------------------------


def _glonass_ephemerides():
    from gypsum_tpu.signal.scenarios import demo_glonass_constellation

    return {s.prn: s.ephemeris for s in demo_glonass_constellation([-2, 0, 2])}


def _writer(rinex, marker, week, epochs, slot_to_freq=None):
    w = rinex.RinexObsWriter.__new__(rinex.RinexObsWriter)
    w.marker, w.week, w.epochs = marker, week, epochs
    w.slot_to_freq = dict(slot_to_freq or {})
    return w


def _hand_built(rinex):
    """tests/test_rinex.py::test_obs_structure_and_round_trip's rows, and a
    GLONASS band's rows merged by epoch."""
    row = rinex._EpochRow
    gps = _writer(rinex, "TEST", 2298, [
        (21601.0, [row(prn=25, c1c=21234567.891, l1c=111222333.444, d1c=1234.567, s1c=44.5,
                       new_arc=True),
                   row(prn=122, c1c=38012345.678, l1c=-222333444.555, d1c=-87.125, s1c=38.25,
                       new_arc=False)]),
        (21602.0, [row(prn=25, c1c=21234077.123, l1c=111221101.987, d1c=1230.001, s1c=None,
                       new_arc=False)]),
    ])
    glo = _writer(rinex, "TEST", None, [
        (21602.0, [row(prn=206, c1c=20123456.789, l1c=None, d1c=-512.25, s1c=41.0,
                       new_arc=False, sys="R", num=3, c2c=20123461.5)]),
    ], slot_to_freq={3: -2})
    return gps, glo


@pytest.mark.parametrize("case", ["gps_nav", "glonass_nav", "mixed_nav", "obs", "obs_merged"])
def test_rinex_text_is_byte_identical(case):
    def render(rinex, _nmea):
        if case == "gps_nav":
            return rinex.render_nav(EPH, base_week=2048)
        if case == "glonass_nav":
            return rinex.render_nav_glonass(_glonass_ephemerides())
        if case == "mixed_nav":
            return rinex.render_nav(EPH, base_week=2048, glonass=_glonass_ephemerides())
        gps, glo = _hand_built(rinex)
        approx = np.array([3980000.0, -7000.0, 4970000.0])
        if case == "obs":
            return gps.render(approx_ecef=approx)
        return rinex.render_obs_merged([gps, glo], approx_ecef=approx)

    want, got = both(render)
    assert got == want
    # Each package parses the other's text to the same values.
    if case.endswith("nav"):
        if case != "glonass_nav":
            assert_same(jax_rinex.parse_nav(got), port_rinex.parse_nav(want), "parse_nav")
            assert sorted(port_rinex.parse_nav(want)) == sorted(EPH)
        if case != "gps_nav":
            assert_same(jax_rinex.parse_nav_glonass(got), port_rinex.parse_nav_glonass(want),
                        "parse_nav_glonass")
    else:
        assert_same(jax_rinex.parse_obs(got), port_rinex.parse_obs(want), "parse_obs")


# --------------------------------------------------------------------------
# NMEA
# --------------------------------------------------------------------------


def _burst(_rinex, nmea):
    """One lsq fix's burst from a world model holding the eight demo orbits
    and a clock slide (GSV: the satellites up, four per sentence)."""
    if nmea is jax_nmea:
        from gypsum_tpu.core.config import SolverConfig
        from gypsum_tpu.solve.world import ReceiverSolution, WorldModel
    else:
        from gypsum_tpu_torch.core.config import SolverConfig
        from gypsum_tpu_torch.solve.world import ReceiverSolution, WorldModel
    world = WorldModel(SolverConfig())
    world.assist_ephemerides(dict(zip(DEMO_PRNS_8, DEMO_EPHEMERIDES)))
    world.receiver_clock_slide = DEMO_GPS_START_SOW
    for i, p in enumerate(PRNS):
        world._sats[p].cn0_dbhz = 40.0 + i
    fix = ReceiverSolution(
        clock_bias_s=1.2e-6, ecef=BASE + np.array([0.4, -0.3, 0.2]), lat_deg=51.5000031,
        lon_deg=-0.1000047, alt_m=80.4, satellites_used=tuple(PRNS), receiver_timestamp=20.0,
        velocity_ecef_mps=np.array([0.3, -0.2, 0.1]), clock_drift_s_per_s=1e-9,
        dop={"gdop": 2.1, "pdop": 1.8, "hdop": 1.1, "vdop": 1.4, "tdop": 0.9},
    )
    return nmea.sentences_for_fix(world, fix)


def test_nmea_burst_is_byte_identical_with_valid_checksums():
    want, got = both(_burst)
    assert got == want
    kinds = [s[3:6] for s in got]
    assert kinds[:4] == ["GGA", "GSA", "RMC", "VTG"] and kinds[-1] == "ZDA"
    gsv = [s for s in got if s[3:6] == "GSV"]
    n_up = int(gsv[0].split(",")[3])
    assert n_up > 4 and len(gsv) == (n_up + 3) // 4
    assert [s.split(",")[2] for s in gsv] == [str(i + 1) for i in range(len(gsv))]
    for s in got:
        body, cs = s[1:].rsplit("*", 1)
        assert jax_nmea.checksum(body) == port_nmea.checksum(body) == cs
    gga = port_nmea.parse_gga(got[0])
    assert (gga.lat_deg, gga.lon_deg) == pytest.approx((51.5000031, -0.1000047), abs=1e-7)
    assert_same(jax_nmea.parse_rmc(got[2]), port_nmea.parse_rmc(got[2]), "rmc")


@pytest.mark.parametrize("n_visible", [0, 1, 4, 5, 9])
def test_nmea_gsv_chunks_of_four(n_visible):
    class Sky:
        def __init__(self, el, az):
            self.elevation_deg, self.azimuth_deg = el, az

    sky = {p: Sky(10.0 + 5 * p if p < n_visible + 1 else -5.0, 37.0 * p) for p in range(1, 12)}
    cn0 = {p: 30.0 + p for p in range(1, 12, 2)}
    want, got = jax_nmea.gsv(sky, cn0), port_nmea.gsv(sky, cn0)
    assert got == want and len(got) == (n_visible + 3) // 4


# --------------------------------------------------------------------------
# rtk in RINEX mode, both CLIs
# --------------------------------------------------------------------------


def _obs_text(rinex, rx, clock_bias_s, rng, n_half):
    """tests/test_rinex.py::test_rtk_from_rinex_files's observation file."""
    epochs = []
    for sow in np.arange(DEMO_GPS_START_SOW + 20.0, DEMO_GPS_START_SOW + 60.0, 1.0):
        rows = []
        for p in PRNS:
            rho = float(np.linalg.norm(_sv(p, sow) - rx))
            pr = rho + C * clock_bias_s + rng.normal(0, 0.4)
            l1 = (rho + C * clock_bias_s) / LAMBDA_L1 + n_half[p] / 2.0 + rng.normal(0, 0.01)
            rows.append(rinex._EpochRow(prn=p, c1c=pr, l1c=l1, d1c=0.0, s1c=45.0, new_arc=False))
        epochs.append((sow, rows))
    return _writer(rinex, "SYN", 2298, epochs).render()


def _sv(prn, t):
    from gypsum_tpu.solve.ephemeris import satellite_position

    return satellite_position(EPH[prn], t - 0.072)


@pytest.fixture(scope="module")
def rinex_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("rinex")
    east, north, up = enu_basis(BASE)
    rover = BASE + 9.0 * east + 4.0 * north - 1.0 * up
    texts = {}
    for pkg, rinex in (("jax", jax_rinex), ("port", port_rinex)):
        rng = np.random.default_rng(5)
        n_half = {p: int(rng.integers(-50, 50)) for p in PRNS}
        texts[pkg] = (_obs_text(rinex, BASE, 1.7e-4, rng, n_half),
                      _obs_text(rinex, rover, -0.9e-4, rng, n_half))
    assert texts["port"] == texts["jax"]
    for name, text in zip(("base.obs", "rover.obs"), texts["port"]):
        (d / name).write_text(text)
    (d / "orbits.nav").write_text(port_rinex.render_nav(EPH, base_week=2048))
    return d


def _cli(main, argv, device=()):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main([*device, *argv])
    return rc, out.getvalue()


@pytest.mark.parametrize("mode", [(), ("--attitude", "9.899")])
def test_rtk_rinex_mode_prints_what_the_jax_cli_prints(rinex_files, mode):
    d = rinex_files
    argv = ["rtk", "--base-rinex", str(d / "base.obs"), "--rover-rinex", str(d / "rover.obs"),
            "--nav", str(d / "orbits.nav"), "--base-lla", *BASE_LLA, *mode]
    want = _cli(jax_main, argv)
    got = _cli(port_main, argv, device=("--device", "cpu"))
    assert got == want
    assert got[0] == 0 and "FIXED" in got[1]
    if not mode:
        # tests/test_rinex.py's bar: the fixed baseline within 10 mm.
        enu = re.search(r"fixed baseline ENU: \(([-+.\d]+), ([-+.\d]+), ([-+.\d]+)\)", got[1])
        assert np.linalg.norm(np.array(enu.groups(), float) - [9.0, 4.0, -1.0]) < 0.010


def test_rtk_default_device_raises_without_a_card(rinex_files):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device='cuda' is valid here")
    d = rinex_files
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        port_main(["rtk", "--base-rinex", str(d / "base.obs"), "--rover-rinex",
                   str(d / "rover.obs"), "--nav", str(d / "orbits.nav"), "--base-lla", *BASE_LLA])


# --------------------------------------------------------------------------
# replay: assisted start and exports, both CLIs
# --------------------------------------------------------------------------

SNAPSHOT = re.compile(r"\[\s*([\d.]+)s\] SNAPSHOT lat=(-?[\d.]+) lon=(-?[\d.]+) alt=(-?\d+)m")


@pytest.fixture(scope="module")
def assisted(tmp_path_factory):
    from gypsum_tpu.signal.constellation import synthesize_constellation
    from gypsum_tpu.signal.scenarios import demo_constellation

    d = tmp_path_factory.mktemp("assist")
    iq, _ = synthesize_constellation(demo_constellation(PRNS), BASE, DEMO_GPS_START_SOW, 4.0, FS,
                                     noise_sigma=0.25)
    np.save(d / "capture.npy", iq)
    (d / "assist.nav").write_text(port_rinex.render_nav(EPH))
    out = {}
    for pkg, main, device in (("jax", jax_main, ()), ("port", port_main, ("--device", "cpu"))):
        files = {k: d / f"{pkg}.{k}" for k in ("obs", "nav", "nmea")}
        rc, text = _cli(main, [
            "replay", "--file", str(d / "capture.npy"), "--assist-nav", str(d / "assist.nav"),
            "--assist-time", str(DEMO_GPS_START_SOW + 7.5), "--rinex-obs", str(files["obs"]),
            "--rinex-nav", str(files["nav"]), "--nmea-out", str(files["nmea"]),
            "--duration", "4"], device)
        assert rc == 0
        out[pkg] = (text, files)
    return out


def test_assisted_replay_prints_the_jax_snapshot_fixes(assisted):
    want = SNAPSHOT.findall(assisted["jax"][0])
    got = SNAPSHOT.findall(assisted["port"][0])
    assert want and len(got) == len(want)
    for (tw, *w), (tg, *g) in zip(want, got):
        assert tg == tw
        dist = np.linalg.norm(lla_to_ecef(*map(float, g)) - lla_to_ecef(*map(float, w)))
        assert dist < 1.0, dist
        # tests/test_assist.py's bars: a coarse fix before 5 s within 150 m.
        assert float(tg) < 5.0
        assert np.linalg.norm(lla_to_ecef(*map(float, g)) - BASE) < 150.0


def test_assisted_replay_exports_what_the_jax_cli_exports(assisted):
    (jtext, jf), (ptext, pf) = assisted["jax"], assisted["port"]
    # No handover word in 4 s: no OBS file from either package.
    assert jf["obs"].exists() == pf["obs"].exists()
    if pf["obs"].exists():
        assert_same(jax_rinex.parse_obs(jf["obs"].read_text()),
                    port_rinex.parse_obs(pf["obs"].read_text()), "obs")
    # The NAV files hold the six assisted orbits, the same in both.
    assert_same(jax_rinex.parse_nav(jf["nav"].read_text()),
                port_rinex.parse_nav(pf["nav"].read_text()), "nav")
    assert sorted(port_rinex.parse_nav(pf["nav"].read_text())) == sorted(PRNS)
    jl, pl = jf["nmea"].read_text().splitlines(), pf["nmea"].read_text().splitlines()
    assert [s[3:6] for s in pl] == [s[3:6] for s in jl]
    for s in pl:
        body, cs = s[1:].rsplit("*", 1)
        assert port_nmea.checksum(body) == cs
    for js, ps in zip(jl, pl):
        if ps[3:6] == "GGA":
            a, b = jax_nmea.parse_gga(js), port_nmea.parse_gga(ps)
            assert np.linalg.norm(lla_to_ecef(a.lat_deg, a.lon_deg, a.alt_m)
                                  - lla_to_ecef(b.lat_deg, b.lon_deg, b.alt_m)) < 1.0
    summary = re.compile(r"^(wrote .*|processed .*)$", re.MULTILINE)
    assert summary.findall(ptext) == [
        line.replace(str(jf["nav"]), str(pf["nav"])).replace(str(jf["nmea"]), str(pf["nmea"]))
        for line in summary.findall(jtext)
    ]

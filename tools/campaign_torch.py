"""Randomized end-to-end campaign through the port (``gypsum_tpu_torch``),
and the named scenes of nine receiver tests, each judged by its own bars and
compared trial by trial with the JAX receiver's records.

The twin of tools/campaign.py: the same seeds draw the same scenarios (its
``Scenario``, ``make_scenario``, the GLONASS dual-frequency draw and the
impairment levels are copied here, so that this file imports numpy and the
port only), and each first fix is judged the same way (the 15 m and 2 m/s
gates, the error against HPL and VPL, ``degraded_honest`` above GDOP 15,
``df_not_applied``). Besides that tool's fields, a record holds the first
scan's acquisitions, every fix (epoch, ECEF, satellites) and its kind, the
first and last fix in full, the PRNs dropped, reacquired, rescued,
reseeded, coasting, recovered from a coast and deep-measured by block, the
spoofing alerts, and the wall split into synthesis and replay.

Named scenes (``--scene NAME``) rebuild the scenes of receiver tests of the
JAX package exactly and judge them by those tests' asserts:

- ``sbas_ranging``: tests/test_sbas.py:187-256 (a GEO acquired, MT9
  decoded, a 5-SV fix within 5 m);
- ``fast_corrections_on``, ``fast_corrections_off``:
  tests/test_sbas_corrections.py:93-150 (MT1 + MT2 on and off);
- ``rescue_on``, ``rescue_off``: the Doppler step of
  tests/test_rescue.py:24-82 at 500 ms blocks through ``TrackerBank`` on
  the default two-phase tracker (K1 on the card);
- ``outage_reseed``: tests/test_reseed.py:71-130;
- ``meaconing``: tests/test_spoofing.py:105-150;
- ``tdcp_on``, ``tdcp_off``: tests/test_tdcp.py:60-100;
- ``coast_obstruction``: tests/test_coast.py:28-98,147-161 (PRN 3 blocked
  for 6 s coasts, leaves the fix, and recovers in place);
- ``coast_glonass``: tests/test_coast.py:100-145 (the same on an FDMA
  channel, ``band="glonass"``);
- ``ekf_outage``: tests/test_ekf.py:188-227 (two of five satellites gone
  at 22 s; the navigation EKF's ``"ekf"`` fixes carry on);
- ``pipeline_nav``: tests/test_pipeline.py:27-69 (the scan tracker at
  500 ms blocks; its pair bar holds the pipelined run to the unpipelined
  one).

Synthesis runs in worker processes started with ``spawn``. On the card the
replays run in this process, on its one CUDA context, one after another; on
the CPU each worker replays what it synthesized.

``--against FILE`` compares each trial with the record of the same trial in
FILE (tools/campaign_reference.jsonl holds the JAX receiver's, made by
tools/campaign_reference.py). On the CPU with phase 1 in float32 it holds
the parity ladder: equal status, acquisitions, fix epochs and satellite
sets, positions within 1 m, equal drop, reacquisition, reseed and alert
events. On the card it requires equal status and satellite sets, and
reports the epoch and position differences beside the ladder's bars.

Usage:
    python tools/campaign_torch.py --trials 28 --jobs 4
    python tools/campaign_torch.py --device cpu --reference-set \\
        --against tools/campaign_reference.jsonl
    python tools/campaign_torch.py --scene rescue_on --scene rescue_off
    python tools/campaign_torch.py --replay-seed 11   # one trial, with logs
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import os
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor
from dataclasses import asdict, dataclass
from pathlib import Path
from types import SimpleNamespace

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

POSITION_TOLERANCE_M = 15.0
VELOCITY_TOLERANCE_MPS = 2.0
HONEST_GDOP = 15.0  # above it an error inside the protection levels is degraded_honest
FS, L = 2.046e6, 2046

# The parity ladder's bars (ROADMAP.md, "How parity is judged"), and those
# of the bank-level rescue scenes.
LADDER_POSITION_M = 1.0
LADDER_DOPPLER_HZ = 1e-3
RESCUE_DOPPLER_HZ = 0.05
RESCUE_QUALITY = 1e-3


@dataclass(frozen=True)
class Scenario:
    """Everything needed to reproduce one trial bit-for-bit (a copy of
    tools/campaign.py's)."""

    seed: int
    prns: tuple[int, ...]
    lat_deg: float
    lon_deg: float
    alt_m: float
    velocity_ecef: tuple[float, float, float]
    clock_drift: float  # s/s
    noise_sigma: float
    duration_s: float
    block_size_ms: int
    impairment: str = "none"  # key into IMPAIRMENT_LEVELS
    # An SBAS GEO (PRN 120-138) broadcasting MT9, and fast-correction faults
    # ((gps_prn, bias_m), ...) its MT1 + MT2 broadcast corrects.
    sbas_prn: int | None = None
    sbas_fast_bias_m: tuple[tuple[int, float], ...] = ()


IMPAIRMENT_LEVELS = ("none", "bandlimit", "phase_noise", "multipath", "adc2", "full",
                     "cw", "cw_swept")


def impairment_levels(rf_impairments) -> dict:
    """The gauntlet's levels, built with ``rf_impairments`` (the package's
    ``RfImpairments``). The cw levels run through the notch front end."""
    return {
        "none": None,
        "bandlimit": rf_impairments(frontend_bandwidth_hz=700e3),
        "phase_noise": rf_impairments(phase_noise_rad_per_sqrt_s=0.5),
        "multipath": rf_impairments(multipath_delay_s=0.4e-6, multipath_amplitude=0.5),
        "adc2": rf_impairments(adc_bits=2),
        "full": rf_impairments(
            frontend_bandwidth_hz=700e3,
            phase_noise_rad_per_sqrt_s=0.3,
            multipath_delay_s=0.4e-6,
            multipath_amplitude=0.4,
            adc_bits=8,
        ),
        "cw": rf_impairments(cw_amplitude=10.0, cw_freq_hz=-151e3),
        "cw_swept": rf_impairments(cw_amplitude=8.0, cw_freq_hz=120e3, cw_chirp_hz_per_s=500.0),
    }


def make_scenario(seed: int, impairment: str = "none") -> Scenario:
    """A random but plausible scenario from a seed: 4-8 satellites, within
    ~3 deg of the demo site, up to 40 m/s, drift up to 0.2 ppm, noise
    0.25-0.45, 200 or 500 ms blocks, an SBAS GEO in a third of the trials."""
    rng = np.random.default_rng(seed)
    n_sats = int(rng.integers(4, 9))
    prns = tuple(int(p) for p in rng.choice(np.arange(1, 33), size=n_sats, replace=False))
    lat = 51.5 + float(rng.uniform(-3.0, 3.0))
    lon = -0.1 + float(rng.uniform(-3.0, 3.0))
    alt = float(rng.uniform(0.0, 500.0))
    if rng.random() < 0.5:
        speed = float(rng.uniform(0.0, 40.0))
        direction = rng.normal(size=3)
        direction /= np.linalg.norm(direction)
        vel = tuple(float(v) for v in speed * direction)
    else:
        vel = (0.0, 0.0, 0.0)
    drift = float(rng.uniform(-2e-7, 2e-7)) if rng.random() < 0.5 else 0.0
    noise = float(rng.uniform(0.25, 0.45))
    duration = float(rng.uniform(26.0, 32.0))
    block_ms = int(rng.choice([200, 500]))
    sbas_prn = int(rng.integers(120, 139)) if rng.random() < 0.33 else None
    fast_bias: tuple[tuple[int, float], ...] = ()
    if sbas_prn is not None and rng.random() < 0.7:
        k = min(2, len(prns))
        biased = rng.choice(np.array(prns), size=k, replace=False)
        fast_bias = tuple(
            (int(p), float(rng.uniform(5.0, 15.0) * rng.choice([-1.0, 1.0])))
            for p in biased
        )
    return Scenario(
        seed, prns, lat, lon, alt, vel, drift, noise, duration, block_ms,
        impairment=impairment, sbas_prn=sbas_prn, sbas_fast_bias_m=fast_bias,
    )


def glonass_df_draw(seed: int) -> dict:
    """The GLONASS-only dual-frequency trial's draw (tools/campaign.py's
    run_glonass_df_trial): 4-6 FDMA channels, geometry, noise, duration and
    the Klobuchar amplitude scaled 0.4-2x."""
    rng = np.random.default_rng(seed + 7_000_000)
    n_ch = int(rng.integers(4, 7))
    ks = sorted(int(k) for k in rng.choice(np.arange(-7, 7), size=n_ch, replace=False))
    lat = 51.5 + float(rng.uniform(-3.0, 3.0))
    lon = -0.1 + float(rng.uniform(-3.0, 3.0))
    alt = float(rng.uniform(0.0, 500.0))
    noise = float(rng.uniform(0.25, 0.4))
    duration = float(rng.uniform(14.0, 18.0))
    iono_scale = float(rng.uniform(0.4, 2.0))
    return {"ks": ks, "lat": lat, "lon": lon, "alt": alt, "noise": noise,
            "duration_s": duration, "iono_scale": iono_scale}


# ------------------------------------------------------------------ trials

SCENES = ("sbas_ranging", "fast_corrections_on", "fast_corrections_off", "rescue_on",
          "rescue_off", "outage_reseed", "meaconing", "tdcp_on", "tdcp_off",
          "coast_obstruction", "coast_glonass", "ekf_outage", "pipeline_nav")


def capture_of(scene: str) -> str:
    """The capture a scene replays (on and off pairs share one)."""
    return scene.rsplit("_", 1)[0] if scene.endswith(("_on", "_off")) else scene


def gps_spec(seed: int, impairment: str = "none") -> dict:
    return {"kind": "gps", "seed": seed, "impairment": impairment}


def glonass_df_spec(seed: int) -> dict:
    return {"kind": "glonass_df", "seed": seed, "impairment": "none"}


def scene_spec(name: str) -> dict:
    if name not in SCENES:
        raise ValueError(f"no scene {name!r} (one of {', '.join(SCENES)})")
    return {"kind": "scene", "scene": name}


def reference_set() -> list[dict]:
    """The trials tools/campaign_reference.jsonl records: GPS seeds 0-27,
    gauntlet seeds 0-1 at each level, GLONASS-DF seeds 0-3, the scenes."""
    specs = [gps_spec(s) for s in range(28)]
    specs += [gps_spec(s, lvl) for lvl in IMPAIRMENT_LEVELS if lvl != "none" for s in (0, 1)]
    specs += [glonass_df_spec(s) for s in range(4)]
    specs += [scene_spec(name) for name in SCENES]
    return specs


def reference_runs() -> list[tuple[dict, bool]]:
    """(spec, pipelined) of every record of the reference set, the minimum
    set first: the scenes and GPS seeds 0-27 pipelined, the scenes
    unpipelined, then the gauntlet and GLONASS-DF trials."""
    specs = reference_set()
    scenes = [s for s in specs if s["kind"] == "scene"]
    gps = [s for s in specs if s["kind"] == "gps" and s["impairment"] == "none"]
    rest = [s for s in specs if s not in scenes and s not in gps]
    return ([(s, True) for s in scenes + gps] + [(s, False) for s in scenes]
            + [(s, True) for s in rest])


def spec_label(spec: dict) -> str:
    if spec["kind"] == "scene":
        return spec["scene"]
    label = f"{spec['kind']} seed={spec['seed']}"
    return label if spec.get("impairment", "none") == "none" else f"{label} @{spec['impairment']}"


def spec_key(rec: dict) -> tuple:
    """A record's or spec's identity within a set (``pipelined`` apart)."""
    return (rec["kind"], rec.get("seed"), rec.get("impairment", "none"), rec.get("scene"))


def port_api(device: str = "cuda") -> SimpleNamespace:
    """What a trial needs of the port, with every device entry point bound
    to ``device``. tools/campaign_reference.py builds the same namespace
    from the JAX package."""
    import torch

    from gypsum_tpu_torch.core.config import (
        AcquisitionConfig,
        NavConfig,
        ReceiverConfig,
        SolverConfig,
        TrackingConfig,
    )
    from gypsum_tpu_torch.core.constants import GPS_L1_FREQUENCY_HZ
    from gypsum_tpu_torch.io.sources import ArraySampleSource, NotchingSampleSource
    from gypsum_tpu_torch.nav.sbas import GeoNavigationMessage
    from gypsum_tpu_torch.runtime.receiver import DualBandReceiver, Receiver
    from gypsum_tpu_torch.signal import constellation, scenarios
    from gypsum_tpu_torch.signal.prn import ALL_PRN_IDS
    from gypsum_tpu_torch.signal.synth import SyntheticSatellite, synthesize_iq
    from gypsum_tpu_torch.solve.geodesy import lla_to_ecef
    from gypsum_tpu_torch.solve.iono import IonoUtcParams
    from gypsum_tpu_torch.track.loop import TrackerBank

    return SimpleNamespace(
        name="gypsum_tpu_torch",
        # runtime/receiver.py's rule: pipelined on a CUDA device.
        default_pipelined=torch.device(device).type == "cuda",
        make_scenario=make_scenario,
        impairment_levels=lambda: impairment_levels(constellation.RfImpairments),
        AcquisitionConfig=AcquisitionConfig, NavConfig=NavConfig, ReceiverConfig=ReceiverConfig,
        SolverConfig=SolverConfig, TrackingConfig=TrackingConfig,
        GPS_L1_FREQUENCY_HZ=GPS_L1_FREQUENCY_HZ, ArraySampleSource=ArraySampleSource,
        GeoNavigationMessage=GeoNavigationMessage, constellation=constellation,
        scenarios=scenarios, ALL_PRN_IDS=ALL_PRN_IDS, SyntheticSatellite=SyntheticSatellite,
        synthesize_iq=synthesize_iq, lla_to_ecef=lla_to_ecef, IonoUtcParams=IonoUtcParams,
        receiver=lambda source, cfg=None, eligible=None, band="gps": Receiver(
            source, cfg, eligible_prns=eligible, band=band, device=device),
        dual_receiver=lambda l1, l2, cfg: DualBandReceiver(
            None, l1, config=cfg, glonass_l2_source=l2, device=device),
        bank=lambda cfg, n: TrackerBank(FS, L, cfg, n_channels=n, device=device),
        notch=lambda source: NotchingSampleSource(source, device=device),
    )


# The scenes of the nine tests. Each function returns (arrays, facts): the
# capture and the scalars of its synthesis a bar needs.

SBAS_GPS_PRNS = [25, 28, 31, 32]
FAST_PRNS, FAST_BIASES = [25, 28, 31, 32, 3], {28: 12.0, 32: -9.0}
RESCUE_BLOCK_MS, RESCUE_STEP = 500, (1000.0, 1012.0, 6.5, 6.0)  # f0, f1 Hz; s before, after
OUTAGE_WINDOW = (21.0, 27.0)
MEACON_DELAY_S, MEACON_GAIN, MEACON_ONSET_S = 0.37e-3, 1.7, 12.0
TDCP_VELOCITY = (25.0, -15.0, 8.0)
COAST_PRNS, COAST_BLOCKED = [25, 28, 31, 32, 3], (20.0, 26.0)
GLONASS_COAST_KS, GLONASS_COAST_BLOCKED = [-2, -1, 0, 1, 2], (14.0, 19.0)
EKF_OUTAGE_S = 22.0
# The tracking settings of tests/test_coast.py and tests/test_ekf.py, and the
# scan tracker of tests/test_pipeline.py at 500 ms blocks.
COAST_TRACKING = {"watchdog_warmup_ms": 1500, "quality_drop_threshold": 0.25}
PIPELINE_NAV_TRACKING = {"block_size_ms": 500, "use_pallas_block_tracker": False,
                         "use_matmul_tracker": False}

# The port's pipelined tdcp scenes rescue both PRNs every 6 s, one 1000 ms
# block after the unpipelined runs do: the JAX unpipelined records
# (tools/campaign_reference.jsonl lines 45-46: both at 0, 6, 12, 18, 24 s)
# shifted by the block a pipelined report lags, as the JAX pipelined record's
# first rescue at 1.0 s shows (lines 8-9). Those two records pin the
# reference's pipelined rescue fault (ROADMAP.md C5: the rescue re-centred
# on the in-flight block's NCO, gypsum_tpu/track/loop.py:968), so the two
# pipelined tdcp runs hold ``rescued`` to this list instead (C8).
PIPELINED_TDCP_RESCUED = [[t, [27, 29]] for t in (1.0, 7.0, 13.0, 19.0, 25.0)]

# The pipelined coast_glonass record (tools/campaign_reference.jsonl line 66)
# fails its test's last-fix bar, 72.31 m against 15 m: the reference anchors
# a coasting channel's Hatch filter at the next dispatch's prediction, a
# block of range rate from the world model's epoch (ROADMAP.md C1,
# gypsum_tpu/runtime/coast.py:93; the port anchors at the collected end), so
# each fix that uses the recovered channel is off (316.89 m at 20 s, then
# 127.90 m decaying to 72.31 m) and the spoofing monitors raise clock and
# position alerts on the jump. The unpipelined record (line 70) passes. So
# that run is held to the unpipelined record's status, and its fixes with
# the recovered channel and its clock and position alerts from the recovery
# on are left to the test's bars (ROADMAP.md C9; tools/coast_anchor_check.py
# replays the reference with the port's anchor: 1.95-2.35 m).
PIPELINED_COAST_GLONASS_STATUS = "pass"


def _sbas_ranging_capture(api, duration_s: float = 25.0):
    """tests/test_sbas.py:199-228: four GPS SVs of the fixture ephemerides
    (signal/scenarios.py's first four are the same orbits) and the EGNOS-like
    GEO of that test, its GeoNavigationMessage copied here."""
    rx = api.lla_to_ecef(51.5, -0.1, 80.0)
    sats = api.scenarios.demo_constellation(SBAS_GPS_PRNS)
    lon = np.deg2rad(-15.5)
    geo = api.GeoNavigationMessage(
        prn=120,
        t0_sec_of_day=21600.0,
        ura=2,
        xyz_m=(42164e3 * np.cos(lon), 42164e3 * np.sin(lon), 11000.0),
        vel_mps=(0.8, -1.6, 2.4),
        acc_mps2=(-1.25e-4, 5.0e-5, 1.25e-4),
        a_gf0_s=3.1e-8,
        a_gf1_ss=0.0,
    )
    sats.append(api.constellation.SbasGeoSatellite(prn=120, geo=geo, amplitude=0.22, mt9_every=4))
    iq, truth = api.constellation.synthesize_constellation(
        sats, rx, gps_start_time_sow=21600.0, duration_s=duration_s,
        sample_rate=FS, noise_sigma=0.35, subframe_pattern="123",
    )
    return {"iq": iq}, {"doppler_120": float(truth.doppler_hz[120]), "geo_xyz": list(geo.xyz_m)}


def _fast_corrections_capture(api):
    """tests/test_sbas_corrections.py:106-124: two GPS SVs with unmodeled
    clock errors (+12 m, -9 m) that the GEO's MT1 + MT2 correct."""
    sats = [dataclasses.replace(s, unmodeled_clock_error_m=FAST_BIASES.get(s.prn, 0.0))
            for s in api.scenarios.demo_constellation(FAST_PRNS)]
    geo = dataclasses.replace(api.scenarios.demo_sbas_geo(120), fast_corrections=FAST_BIASES,
                              correction_udrei=4)
    iq, _ = api.constellation.synthesize_constellation(
        sats + [geo], api.lla_to_ecef(51.5, -0.1, 80.0), api.scenarios.DEMO_GPS_START_SOW,
        32.0, FS, noise_sigma=0.25,
    )
    return {"iq": iq}, {}


def _rescue_capture(api):
    """tests/test_rescue.py:27-52: PRN 7 with a carrier-Doppler step from
    1000 to 1012 Hz at 6.5 s, the code phase continuous across the seam."""
    f0, f1, t_pre, t_post = RESCUE_STEP
    d1 = 200.0
    r1 = 1.0 + f0 / api.GPS_L1_FREQUENCY_HZ
    r2 = 1.0 + f1 / api.GPS_L1_FREQUENCY_HZ
    d2 = FS * (t_pre * (1.0 - r1 / r2) + (d1 / FS) * (r1 / r2))
    n_pre, n_post = int(t_pre * 1000), int(t_post * 1000)
    sat = api.SyntheticSatellite
    seg1 = api.synthesize_iq([sat(prn=7, doppler_hz=f0, delay_samples=d1, amplitude=0.3)],
                             n_pre * L, FS, noise_sigma=0.2, seed=5)
    seg2 = api.synthesize_iq([sat(prn=7, doppler_hz=f1, delay_samples=d2, amplitude=0.3)],
                             n_post * L, FS, noise_sigma=0.2, seed=6, t0=t_pre)
    return {"iq": np.concatenate([seg1, seg2]).reshape(n_pre + n_post, L)}, {}


def _outage_reseed_capture(api):
    """tests/test_reseed.py:80-99: five demo SVs, the fifth gone over
    21-27 s (two entries with complementary windows), 36 s."""
    prns = api.scenarios.DEMO_PRNS_8[:5]
    sats = api.scenarios.demo_constellation(prns)
    vis_a = dataclasses.replace(sats[4], visible_until_s=OUTAGE_WINDOW[0])
    vis_b = dataclasses.replace(sats[4], visible_from_s=OUTAGE_WINDOW[1])
    iq, _ = api.constellation.synthesize_constellation(
        sats[:4] + [vis_a, vis_b], api.lla_to_ecef(51.5, -0.1, 80.0),
        api.scenarios.DEMO_GPS_START_SOW, 36.0, FS, noise_sigma=0.25,
    )
    return {"iq": iq}, {}


def _meaconing_capture(api):
    """tests/test_spoofing.py:121-133: the authentic 26 s scene plus its
    copy 0.37 ms late at 1.7x gain from 12 s."""
    iq, _ = api.constellation.synthesize_constellation(
        api.scenarios.demo_constellation(api.scenarios.DEMO_PRNS_8[:5]),
        api.lla_to_ecef(51.5, -0.1, 80.0), api.scenarios.DEMO_GPS_START_SOW, 26.0, FS,
        noise_sigma=0.25,
    )
    delay = int(round(MEACON_DELAY_S * FS))
    spoof = np.concatenate([np.zeros(delay, np.complex64), iq[:-delay]])
    spoof[: int(MEACON_ONSET_S * FS)] = 0.0
    return {"iq": (iq + MEACON_GAIN * spoof).astype(np.complex64)}, {}


def _tdcp_capture(api):
    """tests/test_tdcp.py:70-75: the demo scene, 26 s, moving at
    (25, -15, 8) m/s."""
    iq, _ = api.constellation.synthesize_constellation(
        api.scenarios.demo_constellation(), api.lla_to_ecef(51.5, -0.1, 80.0),
        api.scenarios.DEMO_GPS_START_SOW, 26.0, FS, noise_sigma=0.3,
        receiver_velocity_ecef=np.array(TDCP_VELOCITY),
    )
    return {"iq": iq}, {}


def _coast_obstruction_capture(api):
    """tests/test_coast.py:28-36: five demo SVs, PRN 3 blocked over 20-26 s,
    34 s at noise 0.35."""
    sats = api.scenarios.demo_constellation(COAST_PRNS)
    sats[-1] = dataclasses.replace(sats[-1], blocked_s=[COAST_BLOCKED])
    iq, _ = api.constellation.synthesize_constellation(
        sats, api.lla_to_ecef(51.5, -0.1, 80.0), api.scenarios.DEMO_GPS_START_SOW, 34.0, FS,
        noise_sigma=0.35,
    )
    return {"iq": iq}, {}


def _coast_glonass_capture(api):
    """tests/test_coast.py:106-124: five FDMA channels (k = -2..2), the last
    blocked over 14-19 s, 27 s at the demo GLONASS rate from SOW 21618 (a
    frame boundary), noise 0.25, an 800 ns GLONASS time offset."""
    sats = api.scenarios.demo_glonass_constellation(GLONASS_COAST_KS)
    sats[-1] = dataclasses.replace(sats[-1], blocked_s=[GLONASS_COAST_BLOCKED])
    iq, _ = api.constellation.synthesize_constellation(
        sats, api.scenarios.demo_receiver_ecef(), 21618.0, 27.0,
        api.scenarios.DEMO_GLONASS_SAMPLE_RATE, noise_sigma=0.25, glonass_time_offset_s=8e-7,
    )
    return {"iq": iq}, {"victim": int(sats[-1].prn)}


def _ekf_outage_capture(api):
    """tests/test_ekf.py:205-212: five demo SVs, the last two gone from
    22 s, 34 s at noise 0.35."""
    sats = api.scenarios.demo_constellation(COAST_PRNS)
    sats[3:] = [dataclasses.replace(s, visible_until_s=EKF_OUTAGE_S) for s in sats[3:]]
    iq, _ = api.constellation.synthesize_constellation(
        sats, api.lla_to_ecef(51.5, -0.1, 80.0), api.scenarios.DEMO_GPS_START_SOW, 34.0, FS,
        noise_sigma=0.35,
    )
    return {"iq": iq}, {}


def _pipeline_nav_capture(api):
    """tests/test_pipeline.py:27-34: four demo SVs, 26 s at noise 0.3."""
    iq, _ = api.constellation.synthesize_constellation(
        api.scenarios.demo_constellation([25, 28, 31, 32]), api.lla_to_ecef(51.5, -0.1, 80.0),
        api.scenarios.DEMO_GPS_START_SOW, 26.0, FS, noise_sigma=0.3,
    )
    return {"iq": iq}, {}


SCENE_CAPTURES = {
    "sbas_ranging": _sbas_ranging_capture,
    "fast_corrections": _fast_corrections_capture,
    "rescue": _rescue_capture,
    "outage_reseed": _outage_reseed_capture,
    "meaconing": _meaconing_capture,
    "tdcp": _tdcp_capture,
    "coast_obstruction": _coast_obstruction_capture,
    "coast_glonass": _coast_glonass_capture,
    "ekf_outage": _ekf_outage_capture,
    "pipeline_nav": _pipeline_nav_capture,
}


def _gps_satellites(api, sc: Scenario):
    """The trial's satellites and eligible PRNs (tools/campaign.py:146-171)."""
    sats = api.scenarios.demo_constellation(list(sc.prns))
    if sc.sbas_prn is None:
        return sats, None
    geo = api.scenarios.demo_sbas_geo(sc.sbas_prn)
    if sc.sbas_fast_bias_m:
        biases = dict(sc.sbas_fast_bias_m)
        sats = [dataclasses.replace(s, unmodeled_clock_error_m=biases.get(s.prn, 0.0))
                for s in sats]
        geo = dataclasses.replace(geo, fast_corrections=biases)
    return sats + [geo], list(api.ALL_PRN_IDS) + [sc.sbas_prn]


def synthesize(spec: dict, api) -> tuple[dict, dict]:
    """(arrays, facts) of one trial or scene: numpy on the host, no device."""
    if spec["kind"] == "scene":
        return SCENE_CAPTURES[capture_of(spec["scene"])](api)
    if spec["kind"] == "gps":
        sc = api.make_scenario(spec["seed"], spec["impairment"])
        sats, _ = _gps_satellites(api, sc)
        vel = np.array(sc.velocity_ecef)
        iq, _ = api.constellation.synthesize_constellation(
            sats, api.lla_to_ecef(sc.lat_deg, sc.lon_deg, sc.alt_m),
            api.scenarios.DEMO_GPS_START_SOW, sc.duration_s, FS,
            noise_sigma=sc.noise_sigma, seed=sc.seed,
            receiver_velocity_ecef=vel if np.any(vel) else None,
            receiver_clock_drift=sc.clock_drift,
            impairments=api.impairment_levels()[sc.impairment],
        )
        return {"iq": iq}, {}
    d = glonass_df_draw(spec["seed"])
    page = api.scenarios.demo_iono_page18()
    s = d["iono_scale"]
    page = dataclasses.replace(page, alpha0=page.alpha0 * s, alpha1=page.alpha1 * s,
                               alpha2=page.alpha2 * s, alpha3=page.alpha3 * s)
    params = api.IonoUtcParams.from_page(page)
    rx = api.lla_to_ecef(d["lat"], d["lon"], d["alt"])
    sats = api.scenarios.demo_glonass_constellation(d["ks"])
    fs = api.scenarios.DEMO_GLONASS_SAMPLE_RATE
    arrays = {}
    for band, seed in (("l1", spec["seed"]), ("l2", spec["seed"] + 1)):
        arrays[band], _ = api.constellation.synthesize_constellation(
            sats, rx, 21618.0, d["duration_s"], fs, noise_sigma=d["noise"], seed=seed,
            iono=params, glonass_band=band,
        )
    return arrays, {}


def _mode(pipelined: bool | None, bf16: bool | None) -> dict:
    """TrackingConfig fields of a run's mode (None keeps the default)."""
    out = {}
    if pipelined is not None:
        out["pipeline_tracking"] = pipelined
    if bf16 is not None:
        out["matmul_tracker_bf16"] = bf16
    return out


def _config(api, mode: dict, tracking: dict | None = None, **sections):
    return api.ReceiverConfig(tracking=api.TrackingConfig(**{**(tracking or {}), **mode}),
                              **sections)


def _fix_summary(fix) -> dict:
    prot = fix.protection or {}
    iono = fix.iono_measured_m
    return {
        "epoch": float(fix.receiver_timestamp),
        "ecef": [float(v) for v in fix.ecef],
        "velocity": (None if fix.velocity_ecef_mps is None
                     else [float(v) for v in fix.velocity_ecef_mps]),
        "satellites": sorted(int(p) for p in fix.satellites_used),
        "hpl_m": prot.get("hpl_m"),
        "vpl_m": prot.get("vpl_m"),
        "gdop": (fix.dop or {}).get("gdop"),
        "kind": fix.kind,
        "sbas_corrected": sorted(int(p) for p in fix.sbas_corrected),
        "iono_measured_m": (None if iono is None
                            else {str(int(p)): float(m) for p, m in sorted(iono.items())}),
    }


def events(recv, reports) -> dict:
    """What a replay did, block by block, as a record stores it."""
    def by_block(field):
        return [[float(r.block_start), sorted(int(p) for p in getattr(r, field))]
                for r in reports if getattr(r, field)]

    fixes = [r.fix for r in reports if r.fix is not None]
    spoofing = getattr(recv, "spoofing", None)
    return {
        "blocks": len(reports),
        "acquisitions": ([[int(h.prn), float(h.doppler_hz), float(h.code_phase_samples)]
                          for h in reports[0].newly_acquired] if reports else []),
        "reacquired": [[float(r.block_start), sorted(int(h.prn) for h in r.newly_acquired)]
                       for r in reports[1:] if r.newly_acquired],
        "dropped": by_block("dropped_prns"),
        "rescued": by_block("rescued_prns"),
        "reseeded": by_block("reseeded_prns"),
        "coasting": by_block("coasting_prns"),
        "coast_recovered": by_block("coast_recovered_prns"),
        "deep_measured": by_block("deep_measured_prns"),
        "alerts": ([[float(a.t), a.kind, None if a.prn is None else int(a.prn)]
                    for a in spoofing.alerts] if spoofing is not None else []),
        "fixes": [[float(f.receiver_timestamp), *(float(v) for v in f.ecef),
                   sorted(int(p) for p in f.satellites_used)] for f in fixes],
        "fix_kinds": [f.kind for f in fixes],
        "first_fix": _fix_summary(fixes[0]) if fixes else None,
        "last_fix": _fix_summary(fixes[-1]) if fixes else None,
    }


def judge_gps(fix, rx: np.ndarray, vel: np.ndarray, sbas_prn: int | None) -> dict:
    """tools/campaign.py:196-241: the last fix within 15 m (and 2 m/s when
    it has a velocity), its error inside HPL and VPL."""
    expected = rx + vel * fix.receiver_timestamp
    pos_err = float(np.linalg.norm(fix.ecef - expected))
    vel_err = (float(np.linalg.norm(fix.velocity_ecef_mps - vel))
               if fix.velocity_ecef_mps is not None else None)
    ok = pos_err < POSITION_TOLERANCE_M and (vel_err is None or vel_err < VELOCITY_TOLERANCE_MPS)
    status = "pass" if ok else "bad_fix"
    hpl = fix.protection["hpl_m"] if fix.protection else None
    if hpl is not None and _outside_protection(fix, expected):
        status = "integrity_violation"
    return {
        "status": status,
        "hpl_m": hpl,
        "sbas_used": sbas_prn in fix.satellites_used if sbas_prn is not None else None,
        "fix_time_s": float(fix.receiver_timestamp),
        "position_error_m": pos_err,
        "velocity_error_mps": vel_err,
        "satellites_used": list(fix.satellites_used),
        "gdop": fix.dop["gdop"] if fix.dop else None,
    }


def _outside_protection(fix, truth: np.ndarray) -> bool:
    """Horizontal error above HPL or vertical error above VPL (DO-229)."""
    up = truth / np.linalg.norm(truth)
    err_vec = fix.ecef - truth
    v_err = abs(float(err_vec @ up))
    h_err = float(np.linalg.norm(err_vec - (err_vec @ up) * up))
    return h_err > fix.protection["hpl_m"] or v_err > fix.protection["vpl_m"]


def judge_glonass_df(fix, rx: np.ndarray, n_ch: int) -> dict:
    """tools/campaign.py:245-268: 15 m, the protection levels,
    ``degraded_honest`` above GDOP 15 inside them, ``df_not_applied`` when
    the measured iono corrected fewer than max(2, n - 1) channels."""
    pos_err = float(np.linalg.norm(fix.ecef - rx))
    status = "pass" if pos_err < POSITION_TOLERANCE_M else "bad_fix"
    hpl = fix.protection["hpl_m"] if fix.protection else None
    if hpl is not None:
        if _outside_protection(fix, rx):
            status = "integrity_violation"
        elif status == "bad_fix" and (fix.dop or {}).get("gdop", 0.0) > HONEST_GDOP:
            status = "degraded_honest"
    n_df = len(fix.iono_measured_m or {})
    if status == "pass" and n_df < max(2, n_ch - 1):
        status = "df_not_applied"
    return {
        "status": status,
        "position_error_m": pos_err,
        "hpl_m": hpl,
        "fix_time_s": float(fix.receiver_timestamp),
        "df_corrected": n_df,
        "satellites_used": list(fix.satellites_used),
    }


def _bars(out: dict, bars: dict) -> dict:
    """Set a scene's status from its test's bars (name -> held)."""
    out["bars"] = {k: bool(v) for k, v in bars.items()}
    failed = [k for k, v in bars.items() if not v]
    out["status"] = "pass" if not failed else "bars_failed"
    if failed:
        out["failed_bars"] = failed
    return out


def _run_rescue(api, iq: np.ndarray, mode: dict, enabled: bool) -> dict:
    """tests/test_rescue.py:55-82 at 500 ms blocks on the default tracker."""
    tracking = {k: v for k, v in mode.items() if k != "pipeline_tracking"}
    cfg = api.TrackingConfig(block_size_ms=RESCUE_BLOCK_MS, rescue_enabled=enabled, **tracking)
    bank = api.bank(cfg, 2)
    bank.assign(prn=7, doppler_hz=RESCUE_STEP[0], code_phase_samples=200.0, carrier_phase_rad=0.0)
    ev = {"dropped_at": None, "rescued_at": [], "final_quality": None, "final_doppler": None,
          "blocks": 0}
    for b in range(iq.shape[0] // RESCUE_BLOCK_MS):
        t0 = b * RESCUE_BLOCK_MS * 1e-3
        obs = bank.process_block(iq[b * RESCUE_BLOCK_MS:(b + 1) * RESCUE_BLOCK_MS], t0)[0]
        ev["blocks"] += 1
        if obs.lost:
            ev["dropped_at"] = t0
            break
        if bank.maybe_rescue(obs, t0 + RESCUE_BLOCK_MS * 1e-3):
            ev["rescued_at"].append(t0 + RESCUE_BLOCK_MS * 1e-3)
        ev["final_quality"] = float(obs.quality[-1])
        ev["final_doppler"] = float(obs.dopplers[-1])
    step = RESCUE_STEP[2]
    if enabled:
        bars = {
            "kept": ev["dropped_at"] is None,
            "rescue fired after the step": bool(ev["rescued_at"]) and ev["rescued_at"][0] > step,
            "final quality > 0.5": (ev["final_quality"] or 0.0) > 0.5,
            "final Doppler within 2 Hz of 1012": ev["final_doppler"] is not None
            and abs(ev["final_doppler"] - RESCUE_STEP[1]) < 2.0,
        }
    else:
        bars = {"dropped after the step": ev["dropped_at"] is not None and ev["dropped_at"] > step}
    return _bars(ev, bars)


def _scene_bars(scene: str, recv, reports, facts: dict, rx: np.ndarray) -> dict:
    """The asserts of the scene's JAX test, each by name."""
    fixes = [r.fix for r in reports if r.fix is not None]
    vel = np.array(TDCP_VELOCITY) if scene.startswith("tdcp") else np.zeros(3)
    last_err = (float(np.linalg.norm(fixes[-1].ecef - rx - vel * fixes[-1].receiver_timestamp))
                if fixes else None)
    out = {"position_error_m": last_err}
    if scene == "sbas_ranging":
        hits = {h.prn: h for h in reports[0].newly_acquired} if reports else {}
        mt9 = [b for r in reports for _, b in r.sbas_blocks if b.message_type == 9]
        geo = recv.world._sats[120].geo if 120 in recv.world._sats else None
        with5 = [f for f in fixes if 120 in f.satellites_used]
        err5 = float(np.linalg.norm(with5[-1].ecef - rx)) if with5 else None
        out.update(mt9_blocks=len(mt9), five_sv_error_m=err5)
        return _bars(out, {
            "GEO and the 4 GPS SVs acquired at t=0":
                120 in hits and set(SBAS_GPS_PRNS) <= set(hits),
            "GEO Doppler within 10 Hz": 120 in hits
                and abs(hits[120].doppler_hz - facts["doppler_120"]) < 10.0,
            "MT9 decoded": bool(mt9),
            "GEO orbit within 0.5 m": geo is not None
                and bool(np.all(np.abs(np.asarray(geo.xyz_m) - facts["geo_xyz"]) <= 0.5)),
            "a fix": bool(fixes),
            "SBAS in a fix": bool(with5),
            "5-SV fix within 5 m": err5 is not None and err5 < 5.0,
        })
    if scene.startswith("fast_corrections"):
        bars = {"a fix": bool(fixes)}
        if scene.endswith("_on") and fixes:
            store = recv.world.sbas_corrections
            t = fixes[-1].receiver_timestamp
            bars["mask holds the biased SVs"] = (store.mask is not None
                                                 and set(store.mask.slots) == set(FAST_BIASES))
            bars["corrections current at the last fix"] = all(
                store.correction_for(p, t) is not None for p in FAST_BIASES)
            bars["last fix corrected the biased SVs"] = (
                set(fixes[-1].sbas_corrected) == set(FAST_BIASES))
            bars["corrected fix within 2 m"] = last_err < 2.0
        elif fixes:
            bars["uncorrected fix more than 3 m off"] = last_err > 3.0
        return _bars(out, bars)
    if scene == "outage_reseed":
        prn = 3  # signal/scenarios.py:DEMO_PRNS_8[4]
        lo, hi = OUTAGE_WINDOW
        dropped = [r.block_start for r in reports if prn in r.dropped_prns]
        reacq = [r.block_start for r in reports if r.block_start > hi - 1.0
                 and any(h.prn == prn for h in r.newly_acquired)]
        reseeded = [r.block_start for r in reports if r.block_start > hi - 1.0
                    and prn in r.reseeded_prns]
        back = [r.block_end for r in reports if reacq and r.fix is not None
                and prn in r.fix.satellites_used and r.block_end > reacq[0]]
        errs = [float(np.linalg.norm(r.fix.ecef - rx)) for r in reports
                if back and r.fix is not None and r.block_end >= back[0]]
        out.update(dropped_at=dropped[:1], reacquired_at=reacq[:1], reseeded_at=reseeded[:1],
                   back_at=back[:1], worst_error_after_m=max(errs) if errs else None)
        return _bars(out, {
            "dropped in the outage": bool(dropped) and lo <= dropped[0] <= hi + 2.0,
            "reacquired after it": bool(reacq),
            "time base reseeded": bool(reseeded),
            "back in the fix within 2.5 s": bool(back) and back[0] - reacq[0] <= 2.5,
            "fixes after within 15 m": bool(errs) and max(errs) < 15.0,
        })
    if scene == "meaconing":
        alerts = recv.spoofing.alerts
        early = [a for a in alerts if a.t < MEACON_ONSET_S]
        vest = [a for a in alerts if a.kind == "vestigial" and a.t >= MEACON_ONSET_S]
        limit = MEACON_ONSET_S + 2 * recv.config.spoofing.scan_period_s + 1.5
        out.update(first_vestigial_s=min(a.t for a in vest) if vest else None,
                   vestigial_prns=sorted({a.prn for a in vest}))
        return _bars(out, {
            "no alert before onset": not early,
            "meacon detected": bool(vest),
            "detected within two scan periods + 1.5 s": bool(vest)
                and min(a.t for a in vest) < limit,
            "vestigial alerts on >= 3 PRNs": len({a.prn for a in vest}) >= 3,
        })
    if scene.startswith("tdcp"):
        v = fixes[-1].velocity_ecef_mps if fixes else None
        v_err = float(np.linalg.norm(v - np.array(TDCP_VELOCITY))) if v is not None else None
        out["velocity_error_mps"] = v_err
        bar = 0.02 if scene.endswith("_on") else 1.5
        return _bars(out, {"a fix with a velocity": v_err is not None,
                           f"velocity within {bar} m/s": v_err is not None and v_err < bar})
    if scene.startswith("coast"):
        return _coast_bars(scene, recv, reports, facts, rx, out)
    if scene == "ekf_outage":
        coast = [f for f in recv.world.position_fixes if f.kind == "ekf"]
        err = float(np.linalg.norm(coast[-1].ecef - rx)) if coast else None
        out.update(ekf_fixes=len(coast), last_ekf_error_m=err,
                   first_ekf_s=float(coast[0].receiver_timestamp) if coast else None)
        return _bars(out, {
            "least-squares fixes": any(f.kind == "lsq" for f in recv.world.position_fixes),
            "EKF coast fixes": bool(coast),
            "EKF fixes only after the outage": bool(coast)
                and min(f.receiver_timestamp for f in coast) > EKF_OUTAGE_S,
            "EKF fixes on fewer than 4 SVs": all(len(f.satellites_used) < 4 for f in coast),
            "last EKF fix after 30 s": bool(coast) and coast[-1].receiver_timestamp > 30.0,
            "last EKF fix within 50 m": err is not None and err < 50.0,
        })
    if scene == "pipeline_nav":
        out.update(subframe_tows=[[int(prn), float(ev.decoded.handover.time_of_week_seconds)]
                                  for r in reports for prn, ev in r.subframes],
                   pending_blocks=int(recv.bank.pending_blocks))
        return _bars(out, {"a fix": bool(fixes),
                           "nothing in flight at the end": out["pending_blocks"] == 0})
    raise ValueError(scene)


def _coast_bars(scene: str, recv, reports, facts: dict, rx: np.ndarray, out: dict) -> dict:
    """tests/test_coast.py's asserts: the obstructed channel coasts instead
    of dropping, is acquired once, recovers and is back in a fix (GPS
    :47-79 and :147-161: within 2.5 s of the obstruction's end, in a fix
    within 3 s of that, the fixes while it coasts without it and within
    30 m, nothing lost after the recovery; GLONASS :126-145: in a fix
    within 4 s of recovering), the last fix within 15 m."""
    glonass = scene == "coast_glonass"
    prn = facts["victim"] if glonass else COAST_PRNS[-1]
    lo, hi = GLONASS_COAST_BLOCKED if glonass else COAST_BLOCKED
    fixes = recv.world.position_fixes
    coasting = [r.block_start for r in reports if prn in r.coasting_prns]
    recovered = [r.block_start for r in reports if prn in r.coast_recovered_prns]
    t_coast = min(coasting) if coasting else None
    t_rec = min(recovered) if recovered else None
    since = t_rec if glonass else hi  # "back" counts from here
    back = [f.receiver_timestamp for f in fixes if prn in f.satellites_used
            and since is not None and f.receiver_timestamp > since]
    last_err = float(np.linalg.norm(fixes[-1].ecef - rx)) if fixes else None
    latest_coast, back_within = (hi + 1.0, 4.0) if glonass else (hi, 3.0)
    out.update(victim=prn, first_coast_s=t_coast, recovered_s=t_rec,
               back_in_fix_s=min(back) if back else None)
    bars = {
        "never dropped": not any(prn in r.dropped_prns for r in reports),
        f"first coast within {lo:g}-{latest_coast:g} s": t_coast is not None
            and lo <= t_coast <= latest_coast,
        "acquired once": [h.prn for r in reports for h in r.newly_acquired].count(prn) == 1,
        "coast recovered": t_rec is not None,
        f"back in a fix within {back_within:g} s of recovery": t_rec is not None and bool(back)
            and min(back) <= t_rec + back_within,
        "last fix within 15 m": last_err is not None and last_err < 15.0,
    }
    if not glonass:
        during = [f for f in fixes if t_coast is not None
                  and t_coast + 1.0 < f.receiver_timestamp < hi]
        post = [o for r in reports if t_rec is not None and r.block_start >= t_rec
                for o in r.observations if o.prn == prn]
        out["fixes_while_coasting"] = len(during)
        bars.update({
            f"recovered within {hi:g}-{hi + 2.5:g} s": t_rec is not None
                and hi <= t_rec <= hi + 2.5,
            "fixes while coasting": bool(during),
            "no fix while coasting uses it": all(prn not in f.satellites_used for f in during),
            "fixes while coasting within 30 m": all(
                float(np.linalg.norm(f.ecef - rx)) < 30.0 for f in during),
            "not coasting at the end": prn in recv.world._sats
                and not recv.world._sats[prn].coasting,
            "no observation lost after recovery": bool(post) and not any(o.lost for o in post),
        })
    return _bars(out, bars)


def _run_scene(api, scene: str, arrays: dict, facts: dict, mode: dict) -> tuple[dict, object]:
    if capture_of(scene) == "rescue":
        return _run_rescue(api, arrays["iq"], mode, scene.endswith("_on")), None
    rx = api.lla_to_ecef(51.5, -0.1, 80.0)
    eligible, kwargs = None, {}
    cfg = _config(api, mode)
    if scene == "sbas_ranging":
        eligible = SBAS_GPS_PRNS + [120]
    elif scene.startswith("fast_corrections"):
        eligible = FAST_PRNS + [120]
        cfg = _config(api, mode, solver=api.SolverConfig(
            apply_sbas_corrections=scene.endswith("_on")))
    elif scene == "outage_reseed":
        eligible = api.scenarios.DEMO_PRNS_8[:5]
        cfg = _config(api, mode, {"watchdog_warmup_ms": 1500, "quality_drop_threshold": 0.25,
                                  "coast_enabled": False},
                      acquisition=api.AcquisitionConfig(scan_period_s=2.0))
    elif scene == "meaconing":
        eligible = api.scenarios.DEMO_PRNS_8[:5]
        kwargs = {"max_seconds": 22.0}
    elif scene.startswith("tdcp"):
        kwargs = {"until_fix": True}
        if scene.endswith("_off"):
            cfg = _config(api, mode, solver=api.SolverConfig(tdcp_velocity=False))
    elif scene.startswith("coast") or scene == "ekf_outage":
        cfg = _config(api, mode, COAST_TRACKING)
    elif scene == "pipeline_nav":
        cfg = _config(api, mode, PIPELINE_NAV_TRACKING)
    if scene == "coast_glonass":
        source = api.ArraySampleSource(arrays["iq"], api.scenarios.DEMO_GLONASS_SAMPLE_RATE)
        recv = api.receiver(source, cfg, eligible, band="glonass")
    else:
        recv = api.receiver(api.ArraySampleSource(arrays["iq"], FS), cfg, eligible)
    reports = recv.run(**kwargs)
    return _scene_bars(scene, recv, reports, facts, rx), recv


def replay(spec: dict, arrays: dict, facts: dict, api, pipelined: bool | None = None,
           bf16: bool | None = None, no_resync_cutoff: bool = False) -> dict:
    """Run one trial's receiver over its synthesized arrays and judge it.
    ``pipelined``/``bf16`` set TrackingConfig.pipeline_tracking and
    .matmul_tracker_bf16 (None keeps each default). A crash is a finding,
    recorded with status ``error``, not raised."""
    mode = _mode(pipelined, bf16)
    rec = {**spec, "package": api.name, "mode": dict(mode)}
    t0 = time.perf_counter()
    try:
        if spec["kind"] == "scene":
            out, recv = _run_scene(api, spec["scene"], arrays, facts, mode)
            rec.update(out)
            if recv is not None:
                rec.update(events(recv, recv.block_reports))
                rec["pipelined"] = recv._pipeline_depth > 0
            else:  # a bank has no pipeline: the record carries the run's mode
                rec["pipelined"] = mode.get("pipeline_tracking", api.default_pipelined)
        elif spec["kind"] == "gps":
            sc = api.make_scenario(spec["seed"], spec["impairment"])
            rec["scenario"] = asdict(sc)
            _, eligible = _gps_satellites(api, sc)
            nav = {}
            if no_resync_cutoff:
                nav = {"nav": api.NavConfig(bit_phase_resync_cutoff_s=float("inf"))}
            cfg = _config(api, mode, {"block_size_ms": sc.block_size_ms}, **nav)
            source = api.ArraySampleSource(arrays["iq"], FS)
            if sc.impairment.startswith("cw"):
                source = api.notch(source)
            recv = api.receiver(source, cfg, eligible)
            reports = recv.run(until_fix=True)
            rec.update(events(recv, reports))
            rec["pipelined"] = recv._pipeline_depth > 0
            fixes = recv.world.position_fixes
            if not fixes:
                rec["status"] = "no_fix"
            else:
                rx = api.lla_to_ecef(sc.lat_deg, sc.lon_deg, sc.alt_m)
                rec.update(judge_gps(fixes[-1], rx, np.array(sc.velocity_ecef), sc.sbas_prn))
        else:
            d = glonass_df_draw(spec["seed"])
            rec.update(d)
            fs = api.scenarios.DEMO_GLONASS_SAMPLE_RATE
            cfg = _config(api, mode) if mode else None
            dual = api.dual_receiver(api.ArraySampleSource(arrays["l1"], fs),
                                     api.ArraySampleSource(arrays["l2"], fs), cfg)
            reports = dual.run()
            rec.update(events(dual._owner, reports))
            rec["pipelined"] = dual._owner._pipeline_depth > 0
            fixes = dual.world.position_fixes
            if not fixes:
                rec["status"] = "no_fix"
            else:
                rx = api.lla_to_ecef(d["lat"], d["lon"], d["alt"])
                rec.update(judge_glonass_df(fixes[-1], rx, len(d["ks"])))
    except Exception as exc:  # a crash is a campaign finding, not an abort
        rec.update(status="error", error=f"{type(exc).__name__}: {exc}")
    rec["replay_s"] = time.perf_counter() - t0
    return rec


def pair_bars(records: list[dict]) -> list[str]:
    """The bars that hold across a scene's two runs
    (tests/test_sbas_corrections.py:150, tests/test_tdcp.py:100,
    tests/test_pipeline.py:51-69)."""
    by = {r.get("scene"): r for r in records if r["kind"] == "scene"}
    out = []
    on, off = by.get("fast_corrections_on"), by.get("fast_corrections_off")
    if on and off and on.get("position_error_m") is not None \
            and off.get("position_error_m") is not None \
            and not on["position_error_m"] < off["position_error_m"] / 2.5:
        out.append(f"fast corrections: corrected {on['position_error_m']:.3f} m not under "
                   f"uncorrected {off['position_error_m']:.3f} m / 2.5")
    on, off = by.get("tdcp_on"), by.get("tdcp_off")
    if on and off and on.get("velocity_error_mps") is not None \
            and off.get("velocity_error_mps") is not None \
            and not on["velocity_error_mps"] < off["velocity_error_mps"]:
        out.append(f"tdcp: {on['velocity_error_mps']:.4f} m/s not under the Doppler "
                   f"solve's {off['velocity_error_mps']:.4f} m/s")
    nav = {r["pipelined"]: r for r in records if r.get("scene") == "pipeline_nav"}
    pipe, sync = nav.get(True), nav.get(False)
    if pipe and sync and pipe.get("last_fix") and sync.get("last_fix"):
        if pipe.get("subframe_tows") != sync.get("subframe_tows"):
            out.append(f"pipeline_nav: pipelined subframe TOWs {pipe.get('subframe_tows')} "
                       f"differ from unpipelined {sync.get('subframe_tows')}")
        apart = float(np.linalg.norm(np.subtract(pipe["last_fix"]["ecef"],
                                                 sync["last_fix"]["ecef"])))
        if not apart < 1.0:
            out.append(f"pipeline_nav: last fixes {apart:.3f} m apart (bar 1 m)")
        if not pipe["position_error_m"] < 60.0:
            out.append(f"pipeline_nav: pipelined last fix {pipe['position_error_m']:.3f} m "
                       "off (bar 60 m)")
    return out


# -------------------------------------------------------------- comparison


def _fix_sets(rec: dict) -> list:
    return [f[4] for f in rec.get("fixes") or []]


# Events that only the records of the coast, EKF and pipeline scenes hold;
# compared wherever the reference record has them.
LATER_EVENTS = ("coasting", "coast_recovered", "deep_measured", "fix_kinds", "subframe_tows")


def reference_fault(rec: dict) -> str | None:
    """The ROADMAP.md section C entry of a fault of the reference that the
    JAX record of ``rec``'s run pins beyond its test's bars, or None."""
    return "C9" if rec.get("scene") == "coast_glonass" and rec.get("pipelined") else None


def _biased_from(rec: dict, ref: dict) -> tuple[float, int] | None:
    """(epoch, PRN) from which C9's record is biased: its first coast
    recovery, or None for any other run."""
    recovered = ref.get("coast_recovered") or []
    if reference_fault(rec) is None or not recovered:
        return None
    return recovered[0][0], recovered[0][1][0]


def expected_rescued(rec: dict, ref: dict):
    """The ``rescued`` list a record is held to: the reference record's,
    but ``PIPELINED_TDCP_RESCUED`` for the two pipelined tdcp runs."""
    if rec.get("pipelined") and rec.get("scene") in ("tdcp_on", "tdcp_off"):
        return PIPELINED_TDCP_RESCUED
    return ref.get("rescued") or []


def compare(rec: dict, ref: dict, ladder: bool) -> list[str]:
    """The divergences of a trial's record from its reference record.

    Always: equal status and equal satellite sets of every fix. With
    ``ladder`` (the CPU, phase 1 in float32) also the parity ladder: equal
    acquisitions (PRNs and code phases in order, Dopplers within 1e-3 Hz),
    equal fix epochs, positions within 1 m, and equal drop, reacquisition,
    rescue (``expected_rescued``), reseed and alert events, and the
    ``LATER_EVENTS`` the reference holds (the rescue scenes: equal drop and
    rescue times, final Doppler within 0.05 Hz, quality within 1e-3). Where
    ``reference_fault`` names a fault of the record, the status is the one
    the other mode's record has, and the fixes and alerts that fault biased
    are not compared (``PIPELINED_COAST_GLONASS_STATUS``)."""
    out = []

    def differ(what, a, b):
        out.append(f"{what}: port {a!r} vs reference {b!r}")

    status = PIPELINED_COAST_GLONASS_STATUS if reference_fault(rec) else ref.get("status")
    if rec.get("status") != status:
        differ("status", rec.get("status"), status)
    if _fix_sets(rec) != _fix_sets(ref):
        differ("fix satellite sets", _fix_sets(rec), _fix_sets(ref))
    if not ladder:
        return out
    if rec.get("scene", "").startswith("rescue"):
        for key in ("dropped_at", "rescued_at"):
            if rec.get(key) != ref.get(key):
                differ(key, rec.get(key), ref.get(key))
        for key, tol in (("final_doppler", RESCUE_DOPPLER_HZ), ("final_quality", RESCUE_QUALITY)):
            a, b = rec.get(key), ref.get(key)
            if (a is None) != (b is None) or (a is not None and abs(a - b) > tol):
                differ(key, a, b)
        return out
    a, b = rec.get("acquisitions") or [], ref.get("acquisitions") or []
    if [(p, c) for p, _, c in a] != [(p, c) for p, _, c in b] or any(
            abs(x[1] - y[1]) > LADDER_DOPPLER_HZ for x, y in zip(a, b)):
        differ("first scan (prn, doppler, code phase)", a, b)
    fa, fb = rec.get("fixes") or [], ref.get("fixes") or []
    biased = _biased_from(rec, ref)
    if [f[0] for f in fa] != [f[0] for f in fb]:
        differ("fix epochs", [f[0] for f in fa], [f[0] for f in fb])
    else:
        for x, y in zip(fa, fb):
            if biased and y[0] >= biased[0] and biased[1] in y[4]:
                continue
            d = float(np.linalg.norm(np.subtract(x[1:4], y[1:4])))
            if d >= LADDER_POSITION_M:
                differ(f"fix at {x[0]} s: positions {d:.3f} m apart", x[1:4], y[1:4])

    def alerts(r):
        return [a for a in r.get("alerts") or [] if not (
            biased and a[0] >= biased[0] and a[1] in ("clock", "position"))]

    if alerts(rec) != alerts(ref):
        differ("alerts", rec.get("alerts"), ref.get("alerts"))
    for key in ("dropped", "reacquired", "reseeded"):
        if (rec.get(key) or []) != (ref.get(key) or []):
            differ(key, rec.get(key), ref.get(key))
    if (rec.get("rescued") or []) != expected_rescued(rec, ref):
        differ("rescued", rec.get("rescued"), expected_rescued(rec, ref))
    for key in LATER_EVENTS:
        if key in ref and rec.get(key) != ref[key]:
            differ(key, rec.get(key), ref[key])
    return out


def differences(rec: dict, ref: dict) -> dict:
    """Epoch and position differences from the reference, for the report:
    the first fix's epoch difference (s) and the largest distance between
    fixes of equal epoch (m) that ``compare`` holds, beside the ladder's
    bars (0 s, 1 m)."""
    fa, fb = rec.get("fixes") or [], ref.get("fixes") or []
    biased = _biased_from(rec, ref)
    by_epoch = {f[0]: f for f in fb
                if not (biased and f[0] >= biased[0] and biased[1] in f[4])}
    dists = [float(np.linalg.norm(np.subtract(f[1:4], by_epoch[f[0]][1:4])))
             for f in fa if f[0] in by_epoch]
    return {
        "first_fix_epoch_diff_s": fa[0][0] - fb[0][0] if fa and fb else None,
        "fix_epochs_equal": [f[0] for f in fa] == [f[0] for f in fb],
        "max_position_diff_m": max(dists) if dists else None,
        "error_diff_m": (rec["position_error_m"] - ref["position_error_m"]
                         if rec.get("position_error_m") is not None
                         and ref.get("position_error_m") is not None else None),
    }


def load_records(path: str | Path) -> list[dict]:
    return [json.loads(line) for line in Path(path).read_text().splitlines() if line.strip()]


def reference_for(records: list[dict], spec: dict, pipelined: bool) -> dict | None:
    for r in records:
        if spec_key(r) == spec_key(spec) and r.get("pipelined") == pipelined:
            return r
    return None


# --------------------------------------------------------------- execution


def synthesize_to(spec: dict, path: str) -> float:
    """Worker process: synthesize ``spec`` into ``path`` (.npz, its facts in
    a JSON entry); returns the seconds it took."""
    t0 = time.perf_counter()
    arrays, facts = synthesize(spec, port_api("cpu"))
    with open(path, "wb") as f:
        np.savez(f, _facts=np.array(json.dumps(facts)), **arrays)
    return time.perf_counter() - t0


def load_synthesized(path: str | Path) -> tuple[dict, dict]:
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files if k != "_facts"}
        facts = json.loads(str(z["_facts"]))
    return arrays, facts


def run_trial(spec: dict, device: str = "cuda", pipelined: bool | None = None,
              bf16: bool | None = None, no_resync_cutoff: bool = False) -> dict:
    """Synthesize and replay one trial in this process (``device`` "cuda"
    by default: without a card the port raises; "cpu" on request)."""
    from gypsum_tpu_torch.core.device import resolve_device

    resolve_device(device)
    api = port_api(device)
    t0 = time.perf_counter()
    arrays, facts = synthesize(spec, api)
    synth_s = time.perf_counter() - t0
    rec = replay(spec, arrays, facts, api, pipelined, bf16, no_resync_cutoff)
    rec["synthesis_s"] = synth_s
    return rec


def _cpu_trial(args) -> dict:
    spec, pipelined, bf16, no_resync, threads = args
    import torch

    torch.set_num_threads(threads)
    return run_trial(spec, "cpu", pipelined, bf16, no_resync)


def run_specs(specs: list[dict], device: str, jobs: int, pipelined: bool | None = None,
              bf16: bool | None = None, no_resync_cutoff: bool = False, modes=None):
    """Yield each trial's record in the order of ``specs``. ``modes``, when
    given, is one ``pipelined`` value per spec (the recorded set's). On the
    CPU every worker synthesizes and replays its trial; on the card workers
    synthesize (at most ``jobs`` + 2 ahead) and this process replays."""
    modes = modes or [pipelined] * len(specs)
    ctx = multiprocessing.get_context("spawn")
    if device == "cpu":
        threads = max(1, (os.cpu_count() or 2) // max(1, jobs))
        with ProcessPoolExecutor(max_workers=jobs, mp_context=ctx) as pool:
            yield from pool.map(_cpu_trial, [(s, m, bf16, no_resync_cutoff, threads)
                                             for s, m in zip(specs, modes)])
        return
    from gypsum_tpu_torch.core.device import resolve_device

    resolve_device(device)
    api = port_api(device)
    captures = {}  # a scene pair shares one synthesis
    with tempfile.TemporaryDirectory() as tmp, \
            ProcessPoolExecutor(max_workers=jobs, mp_context=ctx) as pool:
        def capture_key(spec):
            return capture_of(spec["scene"]) if spec["kind"] == "scene" else spec_label(spec)

        def submit(i):
            key = capture_key(specs[i])
            if key not in captures:
                path = str(Path(tmp) / f"{len(captures)}.npz")
                captures[key] = (pool.submit(synthesize_to, specs[i], path), path)

        ahead = 0
        for i, spec in enumerate(specs):
            while ahead < len(specs) and ahead <= i + jobs + 2:
                submit(ahead)
                ahead += 1
            future, path = captures[capture_key(spec)]
            synth_s = future.result()
            arrays, facts = load_synthesized(path)
            rec = replay(spec, arrays, facts, api, modes[i], bf16, no_resync_cutoff)
            rec["synthesis_s"] = synth_s
            del arrays
            if not any(capture_key(s) == capture_key(spec) for s in specs[i + 1:]):
                os.remove(path)
            yield rec


def summary_line(rec: dict) -> str:
    line = f"{spec_label(rec):28s} {rec['status']:19s}"
    if rec.get("position_error_m") is not None:
        line += f" err={rec['position_error_m']:.2f}m"
    if rec.get("fix_time_s") is not None:
        line += f" fix@{rec['fix_time_s']:.1f}s"
    if rec.get("velocity_error_mps") is not None:
        line += f" verr={rec['velocity_error_mps']:.3f}m/s"
    if rec.get("df_corrected") is not None:
        line += f" df={rec['df_corrected']}sv"
    if rec.get("failed_bars"):
        line += f" failed: {rec['failed_bars']}"
    if rec["status"] == "error":
        line += f" {rec['error']}"
    line += f" synth {rec.get('synthesis_s', 0.0):.1f}s replay {rec['replay_s']:.2f}s"
    return line


ACCEPTED = ("pass", "degraded_honest")


def report(records: list[dict], against: list[dict] | None, ladder: bool) -> int:
    """Print the pass counts per level and every divergence from
    ``against``; returns the number of failures (a trial's status outside
    ``pass``/``degraded_honest`` with no equal reference status, an error,
    a divergence, a pair bar)."""
    failures = 0
    levels: dict[str, list] = {}
    for rec in records:
        group = rec["kind"] if rec["kind"] != "gps" else f"gps @{rec.get('impairment', 'none')}"
        levels.setdefault(group, []).append(rec)
    for group, recs in levels.items():
        errs = [r["position_error_m"] for r in recs if r.get("position_error_m") is not None]
        n_pass = sum(r["status"] in ACCEPTED for r in recs)
        print(f"{group:18s}: {n_pass}/{len(recs)} passed"
              + (f", median err {float(np.median(errs)):.3f} m" if errs else ""), flush=True)
    for bar in pair_bars(records):
        print(f"PAIR BAR FAILED: {bar}", flush=True)
        failures += 1
    for rec in records:
        ref = reference_for(against, rec, rec["pipelined"]) if against is not None else None
        if rec["status"] == "error":
            failures += 1
        elif rec["status"] not in ACCEPTED and (ref is None or ref["status"] != rec["status"]):
            failures += 1
        if against is None:
            continue
        label = f"{spec_label(rec)} (pipelined={rec['pipelined']})"
        if ref is None:
            print(f"NO RECORD for {label}", flush=True)
            failures += 1
            continue
        diffs = compare(rec, ref, ladder)
        d = differences(rec, ref)
        print(f"{label}: " + ("same" if not diffs else f"{len(diffs)} divergence(s)")
              + f"; first fix epoch {d['first_fix_epoch_diff_s']} s apart (bar 0), fix epochs "
              f"equal {d['fix_epochs_equal']}, positions up to {d['max_position_diff_m']} m "
              f"apart (bar {LADDER_POSITION_M}), error diff {d['error_diff_m']} m", flush=True)
        for msg in diffs:
            print(f"  DIVERGENCE seed={rec.get('seed')} {label}: {msg}", flush=True)
        failures += bool(diffs)
    return failures


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trials", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0, help="first trial seed")
    ap.add_argument("--jobs", type=int, default=max(1, (os.cpu_count() or 2) // 2))
    ap.add_argument("--out", default=None, help="JSONL results path (appended)")
    ap.add_argument("--replay-seed", type=int, default=None,
                    help="run exactly one trial with this seed and full logs")
    ap.add_argument("--impairment", default="none", choices=IMPAIRMENT_LEVELS,
                    help="RF-impairment level applied to every trial")
    ap.add_argument("--gauntlet", action="store_true",
                    help="run --trials seeds at EVERY impairment level")
    ap.add_argument("--no-resync-cutoff", action="store_true",
                    help="disable the 40 s bit-phase resync cutoff for every trial")
    ap.add_argument("--glonass-df", action="store_true",
                    help="GLONASS-only dual-frequency (L1OF+L2OF) trials instead of GPS ones")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the port acquires and tracks (cuda raises without a card)")
    ap.add_argument("--pipelined", default="default", choices=("default", "on", "off"),
                    help="TrackingConfig.pipeline_tracking (default: on for cuda, off for cpu)")
    ap.add_argument("--against", default=None,
                    help="JSONL of reference records (tools/campaign_reference.jsonl)")
    ap.add_argument("--scene", action="append", default=[], choices=SCENES + ("all",),
                    help="run a named scene (repeatable; 'all' for every one)")
    ap.add_argument("--reference-set", action="store_true",
                    help="run the set tools/campaign_reference.py records, each in its mode")
    ap.add_argument("--records", default=None,
                    help="compare the records of an earlier run (JSONL) instead of running")
    args = ap.parse_args(argv)

    pipelined = {"default": None, "on": True, "off": False}[args.pipelined]
    # Phase 1 of the tracker in float32 on the CPU, where the parity ladder
    # holds (the records' mode); the config's bf16 on the card.
    ladder = args.device == "cpu"
    phase1, bf16 = ("float32", False) if ladder else ("bf16", None)
    against = load_records(args.against) if args.against else None

    if args.replay_seed is not None:
        import logging

        logging.basicConfig(level=logging.INFO)
        spec = (glonass_df_spec(args.replay_seed) if args.glonass_df
                else gps_spec(args.replay_seed, args.impairment))
        rec = run_trial(spec, args.device, pipelined, bf16, args.no_resync_cutoff)
        print(json.dumps(rec, indent=2))
        return 0 if report([rec], against, ladder) == 0 else 1

    if args.records:
        records = load_records(args.records)
        failures = report(records, against, ladder and records[0].get("phase1") == "float32")
        print(f"{sum(r['status'] in ACCEPTED for r in records)}/{len(records)} passed; "
              f"{failures} failure(s)", flush=True)
        return 1 if failures else 0

    modes = None
    if args.reference_set:
        runs = reference_runs()
        specs, modes = [s for s, _ in runs], [m for _, m in runs]
    elif args.scene:
        names = SCENES if "all" in args.scene else tuple(dict.fromkeys(args.scene))
        specs = [scene_spec(n) for n in names]
    else:
        seeds = range(args.seed, args.seed + args.trials)
        if args.glonass_df:
            specs = [glonass_df_spec(s) for s in seeds]
        elif args.gauntlet:
            specs = [gps_spec(s, lvl) for lvl in IMPAIRMENT_LEVELS for s in seeds]
        else:
            specs = [gps_spec(s, args.impairment) for s in seeds]

    out_f = open(args.out, "a") if args.out else None
    records = []
    t0 = time.perf_counter()
    for rec in run_specs(specs, args.device, args.jobs, pipelined, bf16,
                         args.no_resync_cutoff, modes):
        rec["phase1"] = phase1
        records.append(rec)
        print(f"[{len(records)}/{len(specs)}] {summary_line(rec)}", flush=True)
        if out_f:
            out_f.write(json.dumps(rec) + "\n")
            out_f.flush()
    if out_f:
        out_f.close()
    wall = time.perf_counter() - t0
    print(f"\nwall {wall:.1f} s: synthesis {sum(r.get('synthesis_s', 0.0) for r in records):.1f} s "
          f"(worker processes), replay {sum(r['replay_s'] for r in records):.1f} s", flush=True)
    failures = report(records, against, ladder)
    n_ok = sum(r["status"] in ACCEPTED for r in records)
    print(f"{n_ok}/{len(records)} passed; {failures} failure(s)", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

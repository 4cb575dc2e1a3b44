"""The campaign twin (tools/campaign_torch.py) and the receiver paths it
drives, against the JAX package.

- The twin's scenario draws, GLONASS dual-frequency draws and impairment
  levels equal tools/campaign.py's, and every record of
  tools/campaign_reference.jsonl (the JAX receiver's, tools/campaign_reference.py)
  holds the scenario its seed draws, so a stale file fails.
- The comparison flags crafted divergences, and holds the two pipelined
  tdcp runs' ``rescued`` to the expected list (the unpipelined records a
  block later), not to the reference's pipelined rescue fault.
- Live seams of the paths the records hold in full: the rescue tier on
  tests/test_rescue.py's Doppler step through both packages' TrackerBank at
  500 ms blocks on the default two-phase tracker (phase 1 in float32), the
  SBAS family-widened acquisition on 10 ms of tests/test_sbas.py's scene,
  and one vestigial scan of the meaconed composite of
  tests/test_spoofing.py.
"""

from __future__ import annotations

import tests._torch_cpu  # noqa: F401  # isort: skip (first: caps torch's threads)

import copy
import dataclasses
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from tools import campaign as jax_campaign
from tools import campaign_torch as twin

ROOT = Path(__file__).resolve().parent.parent
REFERENCE = ROOT / "tools" / "campaign_reference.jsonl"
FS, L = 2.046e6, 2046


def _plain(obj):
    """A dataclass or dict as JSON would hold it (tuples as lists)."""
    if dataclasses.is_dataclass(obj):
        obj = dataclasses.asdict(obj)
    return json.loads(json.dumps(obj))


@pytest.mark.parametrize("impairment", ["none", "cw"])
def test_scenarios_equal_the_jax_campaign(impairment):
    for seed in range(64):
        assert _plain(twin.make_scenario(seed, impairment)) == _plain(
            jax_campaign.make_scenario(seed, impairment)), seed


def test_impairment_levels_equal_the_jax_campaign():
    from gypsum_tpu_torch.signal.constellation import RfImpairments

    ours = twin.impairment_levels(RfImpairments)
    theirs = jax_campaign._impairment_levels()
    assert twin.IMPAIRMENT_LEVELS == jax_campaign.IMPAIRMENT_LEVELS
    assert list(ours) == list(theirs)
    for level in twin.IMPAIRMENT_LEVELS:
        assert _plain(ours[level]) == _plain(theirs[level]), level


def test_glonass_df_draw_equals_the_jax_campaign(monkeypatch):
    """tools/campaign.py draws inline in run_glonass_df_trial: stop it at
    its synthesis, and its result holds the draw."""
    import gypsum_tpu.signal.constellation as jax_constellation

    def stop(*args, **kwargs):
        raise RuntimeError("draw only")

    monkeypatch.setattr(jax_constellation, "synthesize_constellation", stop)
    for seed in range(16):
        res = jax_campaign.run_glonass_df_trial(seed)
        assert res["status"] == "error" and "draw only" in res["error"]
        assert twin.glonass_df_draw(seed) == {k: res[k] for k in twin.glonass_df_draw(seed)}


@pytest.fixture(scope="module")
def reference():
    return twin.load_records(REFERENCE)


def test_reference_records_hold_their_seeds_draws(reference):
    for rec in reference:
        if rec["kind"] == "gps":
            sc = jax_campaign.make_scenario(rec["seed"], rec["impairment"])
            assert rec["scenario"] == _plain(sc), twin.spec_label(rec)
        elif rec["kind"] == "glonass_df":
            draw = twin.glonass_df_draw(rec["seed"])
            assert {k: rec[k] for k in draw} == draw, twin.spec_label(rec)
        assert rec["package"] == "gypsum_tpu" and rec["phase1"] == "float32"
        assert rec["status"] != "error", (twin.spec_label(rec), rec.get("error"))


def test_reference_holds_the_minimum_set(reference):
    """GPS seeds 0-27 and every scene run, pipelined (the card's default);
    the scenes also unpipelined, as their tests run."""
    have = {(twin.spec_key(r), r["pipelined"]) for r in reference}
    for seed in range(28):
        assert (twin.spec_key(twin.gps_spec(seed)), True) in have, seed
    for scene in twin.SCENES:
        for pipelined in (True, False):
            assert (twin.spec_key(twin.scene_spec(scene)), pipelined) in have, scene


def test_reference_scenes_meet_their_bars(reference):
    """Every JAX scene record meets its test's bars, but the one whose
    fault the comparison names (``twin.reference_fault``), and the records
    meet the pair bars."""
    for rec in reference:
        if rec["kind"] == "scene" and twin.reference_fault(rec) is None:
            assert rec["status"] == "pass", (twin.spec_label(rec), rec["pipelined"],
                                             rec.get("failed_bars"))
    for pipelined in (True, False):
        assert twin.pair_bars([r for r in reference if r["pipelined"] == pipelined
                               or r.get("scene") == "pipeline_nav"]) == [], pipelined


@pytest.mark.parametrize("scene", ["tdcp_on", "tdcp_off"])
def test_expected_pipelined_rescues_are_the_unpipelined_records_a_block_later(reference, scene):
    """C8: the expected list is the JAX unpipelined record's rescues one
    1000 ms block later; the JAX pipelined record starts there too, then
    alternates its PRNs (the reference's rescue fault, ROADMAP.md C5)."""
    sync = twin.reference_for(reference, twin.scene_spec(scene), False)
    pipe = twin.reference_for(reference, twin.scene_spec(scene), True)
    assert twin.PIPELINED_TDCP_RESCUED == [[t + 1.0, prns] for t, prns in sync["rescued"]]
    assert pipe["rescued"][0] == twin.PIPELINED_TDCP_RESCUED[0]
    assert pipe["rescued"] != twin.PIPELINED_TDCP_RESCUED


def _moved(rec, metres):
    out = copy.deepcopy(rec)
    out["fixes"][0][1] += metres
    return out


def _new_epoch(rec):
    out = copy.deepcopy(rec)
    out["fixes"][0][0] += 1.0
    return out


def _new_status(rec):
    return {**copy.deepcopy(rec), "status": "bad_fix"}


def _new_set(rec):
    out = copy.deepcopy(rec)
    out["fixes"][0][4] = out["fixes"][0][4][:-1]
    return out


def _gps(reference):
    return next(r for r in reference if r["kind"] == "gps" and r.get("fixes"))


def _pipelined_tdcp(reference):
    return twin.reference_for(reference, twin.scene_spec("tdcp_on"), True)


def _rescued(rescues):
    def craft(rec):
        return {**copy.deepcopy(rec), "rescued": copy.deepcopy(rescues)}
    return craft


def _rescue_moved_a_block(rec):
    out = _rescued(twin.PIPELINED_TDCP_RESCUED)(rec)
    out["rescued"][2][0] += 1.0
    return out


@pytest.mark.parametrize("pick, craft, ladder_flags, card_flags", [
    (_gps, lambda r: copy.deepcopy(r), False, False),
    (_gps, _new_status, True, True),
    (_gps, _new_set, True, True),
    (_gps, lambda r: _moved(r, 1.0), True, False),
    (_gps, lambda r: _moved(r, 0.5), False, False),
    (_gps, _new_epoch, True, False),
    (_pipelined_tdcp, _rescued(twin.PIPELINED_TDCP_RESCUED), False, False),
    (_pipelined_tdcp, _rescue_moved_a_block, True, False),
    (_pipelined_tdcp, lambda r: copy.deepcopy(r), True, False),
    (_gps, _rescued([[1.0, [25]]]), True, False),
], ids=["same", "status", "satellite_set", "1m", "half_metre", "epoch",
        "tdcp_expected_rescues", "tdcp_rescue_moved_a_block", "tdcp_reference_alternation",
        "gps_rescued"])
def test_comparison_flags_crafted_divergences(reference, pick, craft, ladder_flags, card_flags):
    ref = pick(reference)
    rec = craft(ref)
    assert bool(twin.compare(rec, ref, ladder=True)) == ladder_flags
    assert bool(twin.compare(rec, ref, ladder=False)) == card_flags


@pytest.mark.parametrize("device, pipelined", [("cuda", True), ("cuda:0", True),
                                               ("cpu", False)])
def test_port_api_mode_follows_the_receivers_rule(device, pipelined):
    """A bank-level scene records the mode a Receiver on ``device`` would
    run in (runtime/receiver.py: pipelined on any CUDA device); building
    the namespace touches no device."""
    assert twin.port_api(device).default_pipelined is pipelined


# The rescue twin: 6.5 s before the step as tests/test_rescue.py, 2 s after
# it (that test has 6 s): the channel drops at 7.5 s without the rescue and
# is re-centred at 7.5 s with it, then back at quality > 0.5 by 8.5 s.
RESCUE_POST_S = 2.0


@pytest.fixture(scope="module")
def rescue_runs():
    from gypsum_tpu.core.config import TrackingConfig as JaxTrackingConfig
    from gypsum_tpu.track.loop import TrackerBank as JaxTrackerBank
    from gypsum_tpu_torch.core.config import TrackingConfig
    from gypsum_tpu_torch.track.loop import TrackerBank
    from tests.test_rescue import _doppler_step_capture

    f0, f1, t_pre, _ = twin.RESCUE_STEP
    iq = _doppler_step_capture(f0, f1, t_pre_s=t_pre, t_post_s=RESCUE_POST_S)
    jax_api = SimpleNamespace(TrackingConfig=JaxTrackingConfig,
                              bank=lambda cfg, n: JaxTrackerBank(FS, L, cfg, n_channels=n))
    port_api = SimpleNamespace(
        TrackingConfig=TrackingConfig,
        bank=lambda cfg, n: TrackerBank(FS, L, cfg, n_channels=n, device="cpu"))
    mode = {"matmul_tracker_bf16": False}
    return {(pkg, on): twin._run_rescue(api, iq, mode, on)
            for pkg, api in (("jax", jax_api), ("port", port_api)) for on in (True, False)}


@pytest.mark.parametrize("enabled", [True, False], ids=["rescue_on", "rescue_off"])
def test_rescue_matches_jax_at_500_ms_blocks(rescue_runs, enabled):
    ref, port = rescue_runs[("jax", enabled)], rescue_runs[("port", enabled)]
    assert ref["status"] == "pass", ref  # both outcomes still show
    assert port["dropped_at"] == ref["dropped_at"]
    assert port["rescued_at"] == ref["rescued_at"]
    assert port["blocks"] == ref["blocks"]
    assert abs(port["final_doppler"] - ref["final_doppler"]) < twin.RESCUE_DOPPLER_HZ
    assert abs(port["final_quality"] - ref["final_quality"]) < twin.RESCUE_QUALITY
    assert port["status"] == "pass", port
    if enabled:
        assert ref["dropped_at"] is None and ref["rescued_at"][0] > twin.RESCUE_STEP[2]
    else:
        assert ref["dropped_at"] > twin.RESCUE_STEP[2]


def test_sbas_family_acquisition_matches_jax():
    """10 ms of tests/test_sbas.py:199-228's constellation (four GPS SVs
    and the GEO at PRN 120) through both engines on the family-widened PRN
    set the receivers build (runtime/receiver.py: the 32 GPS PRNs and 120)."""
    from gypsum_tpu.acquire.engine import AcquisitionEngine as JaxEngine
    from gypsum_tpu.core.config import AcquisitionConfig as JaxAcqConfig
    from gypsum_tpu.signal.prn import ALL_PRN_IDS
    from gypsum_tpu_torch.acquire.engine import AcquisitionEngine

    arrays, facts = twin._sbas_ranging_capture(twin.port_api("cpu"), duration_s=0.01)
    block = arrays["iq"].reshape(10, L)
    family = tuple(sorted(set(ALL_PRN_IDS) | {120}))
    eligible = twin.SBAS_GPS_PRNS + [120]
    port = AcquisitionEngine(FS, L, prns=family, device="cpu").detect(block, eligible_prns=eligible)
    ref = JaxEngine(FS, L, JaxAcqConfig(), prns=family).detect(block, eligible_prns=eligible)
    assert [(h.prn, h.code_phase_samples) for h in port] == [
        (h.prn, h.code_phase_samples) for h in ref]
    np.testing.assert_allclose([h.doppler_hz for h in port], [h.doppler_hz for h in ref],
                               atol=twin.LADDER_DOPPLER_HZ)
    hits = {h.prn: h for h in port}
    assert set(eligible) <= set(hits)
    assert abs(hits[120].doppler_hz - facts["doppler_120"]) < 10.0


def test_vestigial_scan_matches_jax():
    """One vestigial scan over 10 ms of the meaconed composite of
    tests/test_spoofing.py:121-133 after its onset (the scene synthesized
    from 12 s on, its copy 0.37 ms late at 1.7x gain throughout), the
    tracked peaks at the authentic code phases: both packages' monitors
    raise the same alerts, on at least three PRNs."""
    from gypsum_tpu.core.config import SpoofingConfig as JaxSpoofingConfig
    from gypsum_tpu.solve.spoofing import SpoofingMonitor as JaxMonitor
    from gypsum_tpu_torch.core.config import SpoofingConfig
    from gypsum_tpu_torch.solve.spoofing import SpoofingMonitor

    api = twin.port_api("cpu")
    prns = api.scenarios.DEMO_PRNS_8[:5]
    iq, truth = api.constellation.synthesize_constellation(
        api.scenarios.demo_constellation(prns), api.lla_to_ecef(51.5, -0.1, 80.0),
        api.scenarios.DEMO_GPS_START_SOW + twin.MEACON_ONSET_S, 0.011, FS, noise_sigma=0.25)
    delay = int(round(twin.MEACON_DELAY_S * FS))
    composite = (iq[delay:] + twin.MEACON_GAIN * iq[:-delay])[: 10 * L].reshape(10, L)
    tracked = {p: ((truth.code_phase_samples[p] - delay) % L, truth.doppler_hz[p]) for p in prns}
    t = twin.MEACON_ONSET_S
    port = SpoofingMonitor(SpoofingConfig()).vestigial_scan(composite, FS, tracked, t)
    ref = JaxMonitor(JaxSpoofingConfig()).vestigial_scan(composite, FS, tracked, t)
    assert [(a.prn, a.kind, a.detail, a.severity) for a in port] == [
        (a.prn, a.kind, a.detail, a.severity) for a in ref]
    assert len({a.prn for a in port}) >= 3

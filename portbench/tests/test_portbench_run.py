"""A tiny farm on the CPU through the whole run: the port against the
reference, the control and the faults that must come out as not correct,
and a configuration added as a file."""

import math
import time

import pytest
import torch

from portbench import cells, control, generator, run
from portbench.tests._tiny import tiny_root

torch.set_num_threads(2)
SEED = 2**31 + 4321


def _run(root, seed=SEED, wrap=None, seconds=0.3):
    cell = cells.load(root, "tiny-farm")
    return run.execute(cell, seed, seconds, False, device="cpu", t_start=time.perf_counter(),
                       wrap=wrap)


@pytest.mark.parametrize("band", ["gps", "glonass"])
def test_tiny_farm_agrees_with_reference(tmp_path, band):
    root = tiny_root(tmp_path, band)
    res = _run(root)
    assert res["correct"] is True
    assert res["attempted"] >= 2 and res["failed"] == 0
    # The cell's end-to-end metrics, but those read from the device trace:
    # the CPU has none.
    e2e = cells.load(root, "tiny-farm").end_to_end
    assert set(res["metrics"]) == {m["name"] for m in e2e if m["source"] != "device_trace"}
    assert "setup_s" in res["metrics"] and len(e2e) >= 2
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_control_is_not_correct(tmp_path, seed):
    """The reference at fp8 operands in the program's place."""
    from gypsum_tpu_torch.track.loop import TrackState

    root = tiny_root(tmp_path)
    cell = cells.load(root, "tiny-farm")
    caps = generator.make_captures(cell.config, cell.traffic, seed)
    res = _run(root, seed, control.fp8_entry(cell.config, caps, TrackState))
    assert res["correct"] is False


def _state_unchanged(packed):
    def entry(state, samples, replicas):
        return state, packed(state, samples, replicas)[1]
    return entry


def _half_the_streams(packed):
    def entry(state, samples, replicas):
        cut = samples.clone()
        cut[:, samples.shape[1] // 2:] = 0
        return packed(state, cut, replicas)
    return entry


def _answer_altered(packed):
    def entry(state, samples, replicas):
        new, outs = packed(state, samples, replicas)
        outs = outs.clone()
        locked = torch.nonzero(outs[:, 8].amin(dim=0) > 0.5).flatten()
        s = int(locked[0]) if locked.numel() else 0
        outs[outs.shape[0] // 2, 0:2, s] *= -1.0  # one prompt of a locked channel
        return new, outs
    return entry


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_streams])
def test_faults_are_not_correct(tmp_path, fault):
    """The run with the entry broken underneath (one card: no exchange
    between chips to leave out)."""
    assert _run(tiny_root(tmp_path), wrap=fault)["correct"] is False


def test_altered_answer_is_not_correct(tmp_path):
    """One prompt of a channel in lock, altered where it is produced: the
    held channels' gap catches it whatever the number of channels."""
    root = tiny_root(tmp_path, block_ms=300, capture_s=0.9, cn0_dbhz=[46.0, 48.0])
    res = _run(root, wrap=_answer_altered, seconds=1.0)
    assert res["correct"] is False
    assert res["checks"]["held_prompt_gap"]["value"] > res["checks"]["held_prompt_gap"]["limit"]


def test_added_configuration_runs_without_edit(tmp_path):
    """A configuration, its cell and its limits added as files in another
    root are found by name and run."""
    root = tiny_root(tmp_path, "glonass", name="addedcfg")
    cell = cells.load(root, "addedcfg-farm")
    assert cell.config["name"] == "addedcfg" and cell.config["streams"] == 2
    res = run.execute(cell, 5, 0.2, False, device="cpu", t_start=time.perf_counter())
    assert res["correct"] is True and res["attempted"] >= 1 and res["metrics"]["setup_s"]["value"] > 0


@pytest.mark.parametrize("field", ["lost", "step_count"])
def test_a_held_channels_wrong_count_or_lost_flag_is_not_correct(tmp_path, field):
    """One held channel-block whose ending carry hands on a wrong lock flag
    or ms count: the carry's count and flag are held at the widest, so the
    one fault reads a whole unit whatever the number of channel-blocks."""
    from portbench import compare

    root = tiny_root(tmp_path, block_ms=300, capture_s=0.9, cn0_dbhz=[46.0, 48.0])
    cell = cells.load(root, "tiny-farm")
    dev = torch.device("cpu")
    system = cell.kind.setup(cell, SEED, dev, None, lambda _name: None)
    system.warm(run.WARM_BLOCKS)
    system.run(0.5, None, (0, 0))
    system.release()
    assert system.numbers()["held_carry_gap"] < cell.limits["held_carry_gap"]
    blocks = compare.reference_blocks(cell.config, cell.traffic, system.caps, system.pool,
                                      system.kept, system.restart_mask, dev)
    results = compare.reference_module(cell.config).track_blocks(cell.config, blocks, "bf16")
    blk, s = next((blk, int(s)) for blk, (_, r) in zip(system.kept, results)
                  for s in torch.nonzero((r[:, compare.O_LOCKED] > 0.5).all(dim=0)).flatten())
    value = getattr(blk.carry_out, field).clone()
    value[s] = ~value[s] if field == "lost" else value[s] + 1
    blk.carry_out = blk.carry_out._replace(**{field: value})
    assert system.numbers()["held_carry_gap"] == 1.0 > cell.limits["held_carry_gap"]


def test_carry_gap_takes_the_phase_percentile_and_the_widest_count():
    from portbench import compare

    loop = torch.full((1000,), 1e-5)
    loop[7] = 0.01  # one channel-block past a discontinuity: under the 99th percentile
    none = torch.zeros(1000)
    assert compare.carry_gap(loop, none) == pytest.approx(1e-5)
    one = none.clone()
    one[3] = 1.0  # one ms count or lock flag apart
    assert compare.carry_gap(loop, one) == 1.0
    one[5] = float("nan")
    assert math.isnan(compare.carry_gap(loop, one))
    assert math.isnan(compare.carry_gap(torch.full((4,), float("nan")), none))


def test_a_held_channels_code_phase_at_a_central_ms_is_not_correct(tmp_path):
    """A measured code phase a fifth of a sample off at one clear ms of one
    held channel, where the reference's peak sits in the middle of its
    lags: the code gap is the widest over such ms, so the one fault fails."""
    from portbench import compare

    root = tiny_root(tmp_path, block_ms=300, capture_s=0.9, cn0_dbhz=[46.0, 48.0])
    cell = cells.load(root, "tiny-farm")
    dev = torch.device("cpu")
    system = cell.kind.setup(cell, SEED, dev, None, lambda _name: None)
    system.warm(run.WARM_BLOCKS)
    system.run(0.5, None, (0, 0))
    system.release()
    assert system.numbers()["held_code_gap_samples"] < cell.limits["held_code_gap_samples"]
    blocks = compare.reference_blocks(cell.config, cell.traffic, system.caps, system.pool,
                                      system.kept, system.restart_mask, dev)
    results = compare.reference_module(cell.config).track_blocks(cell.config, blocks, "bf16")
    reach, length = compare.central_reach(cell.config), float(system.caps.samples_per_ms)
    for blk, (_, r) in zip(system.kept, results):
        pr = torch.complex(r[:, compare.O_PI], r[:, compare.O_PQ])
        clear = pr.abs() >= compare.CLEAR * torch.sqrt(torch.mean(pr.abs() ** 2, dim=0))
        central = compare._wrapped(r[:, compare.O_CPM] - torch.floor(r[:, compare.O_CP]),
                                   length).abs() < reach
        held = (r[:, compare.O_LOCKED] > 0.5).all(dim=0)
        spots = torch.nonzero(clear & central & held[None, :])
        if len(spots):
            m, s = (int(x) for x in spots[0])
            break
    else:
        pytest.fail("no clear, central ms on a held channel")
    outs = blk.outs.clone()
    outs[m, compare.O_CPM, s] += 0.2
    blk.outs = outs
    assert system.numbers()["held_code_gap_samples"] == pytest.approx(0.2, abs=1e-3)


def test_code_gap_leaves_out_ms_whose_peak_sits_near_a_window_end():
    """The measured code phase is compared where the reference's lies within
    K - 1 - 0.5 samples of floor(its loop's code phase) (triangle, K = 4:
    2.5): there a window one lag to either side reads the same lags. GLONASS
    seed 2147530002 on the card: loops 0.009 apart around 747.000, windows
    one lag apart, the reference's peak 2.67 samples out at a meander edge,
    measured code phases 749.67 and 750.5."""
    from collections import namedtuple

    from portbench import compare

    assert compare.central_reach({"tracking": {"code_phase_measurement": "triangle",
                                               "lag_window_half_width": 4}}) == 2.5
    assert compare.central_reach({"tracking": {"code_phase_measurement": "hrc",
                                               "lag_window_half_width": 4}}) == 0.5
    b_count, s_count, length = 4, 2, 4092.0
    r = torch.zeros((b_count, 11, s_count))
    r[:, compare.O_PI] = 8000.0
    r[:, compare.O_CP] = 747.007
    r[:, compare.O_CPM] = torch.tensor([747.2, 749.67, 746.4, 747.5])[:, None]
    r[:, compare.O_LOCKED] = 1.0
    p = r.clone()
    p[:, compare.O_CP] = 746.998
    p[1, compare.O_CPM, 0] = 750.5  # the bent ms: left out
    p[2, compare.O_CPM, 1] = 746.45  # a central ms 0.05 apart: counted
    state = generator.STATE_FIELDS
    Carry = namedtuple("Carry", state)
    fin = {f: torch.zeros(s_count) for f in state}
    fin["lost"] = torch.zeros(s_count, dtype=torch.bool)
    carry_out = Carry(**{f: v.clone() for f, v in fin.items()})
    g = compare.channel_gaps(p, r, carry_out, fin, length, 2.5)
    assert g["code_samples"][0] == pytest.approx(0.83, abs=1e-3)  # every ms: still departs
    assert g["clear_code_samples"].tolist() == pytest.approx([0.0, 0.05], abs=1e-3)

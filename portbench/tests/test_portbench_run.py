"""A tiny farm on the CPU through the whole run: the port against the
reference, the control and the faults that must come out as not correct,
and a configuration added as a file."""

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

"""The port's host spans (obs/spans.py) in the block tracker, on the CPU.

A tiny farm block (2 streams x 3 channels, 50 ms, the shapes of
portbench/tests/_tiny.py) through ``make_farm_track_block_fn``: with spans
off it records nothing; on, one ``track.block`` holds the five spans of
phase 1's inputs, wipe and products, K1 and the carry, under one block id,
and counts the products it issued. The bank's dispatch and collect are
spans of their own around the tracker's.
"""

import tests._torch_cpu  # noqa: F401  # isort: skip (first: caps torch's threads)

import numpy as np
import pytest
import torch

from gypsum_tpu_torch.core.config import TrackingConfig
from gypsum_tpu_torch.obs import spans
from gypsum_tpu_torch.signal.prn import ALL_PRN_IDS, replica_table
from gypsum_tpu_torch.track.loop import TrackerBank, fresh_state, make_farm_track_block_fn

L = 2046
FS = 2.046e6
B = 50
STREAMS, PER = 2, 3
CHILDREN = ["phase1.inputs", "phase1.wipe", "phase1.products", "k1", "track.carry"]


@pytest.fixture(scope="module")
def farm():
    """(packed entry, state, samples, replicas) of the tiny farm."""
    cfg = TrackingConfig(block_size_ms=B)
    n = STREAMS * PER
    soc = np.repeat(np.arange(STREAMS), PER).astype(np.int32)
    fn = make_farm_track_block_fn(cfg, L, FS, n, soc, device="cpu")
    reps = replica_table(L, ALL_PRN_IDS)[:n]
    k = cfg.lag_window_half_width
    wide = torch.from_numpy(np.concatenate([reps, reps, reps[:, : 2 * k]], axis=1).astype(np.float32))
    rng = np.random.default_rng(19)
    samples = torch.from_numpy(rng.integers(-16, 17, (B, STREAMS, L, 2), dtype=np.int8))
    return fn.packed, fresh_state(n), samples, wide


@pytest.fixture
def recorder():
    """Spans off and empty before and after the test."""
    spans.disable()
    spans.drain()
    yield spans
    spans.disable()
    spans.drain()


def test_spans_off_record_nothing(farm, recorder):
    packed, state, samples, wide = farm
    packed(state, samples, wide)
    assert recorder.drain() == ([], {})
    assert recorder.span("a") is recorder.span("b") is spans.OFF


def test_a_farm_block_gives_six_spans_under_one_block(farm, recorder):
    packed, state, samples, wide = farm
    recorder.enable()
    packed(state, samples, wide)
    records, counters = recorder.drain()
    assert [r[0] for r in records] == ["track.block", *CHILDREN]
    (_, start, end, parent, block), children = records[0], records[1:]
    assert parent == -1
    for name, c_start, c_end, c_parent, c_block in children:
        assert (c_parent, c_block) == (0, block), name
        assert start <= c_start <= c_end <= end, name
    # The children follow one another: no two of them overlap.
    assert all(a[2] <= b[1] for a, b in zip(children, children[1:]))
    assert counters == {"track.blocks": 1, "phase1.products": STREAMS}


def test_two_blocks_get_two_ids_and_drain_clears(farm, recorder):
    packed, state, samples, wide = farm
    recorder.enable()
    packed(state, samples, wide)
    packed(state, samples, wide)
    records, counters = recorder.drain()
    roots = [r for r in records if r[3] == -1]
    assert len(records) == 12 and len(roots) == 2
    assert roots[0][4] != roots[1][4]
    for root_index, root in ((0, roots[0]), (6, roots[1])):
        assert all(r[4] == root[4] and r[3] == root_index for r in records[root_index + 1:root_index + 6])
    assert counters == {"track.blocks": 2, "phase1.products": 2 * STREAMS}
    assert recorder.drain() == ([], {})
    with recorder.span("open"):
        with pytest.raises(RuntimeError):
            recorder.drain()


def test_bank_dispatch_and_collect_hold_the_tracker(recorder):
    bank = TrackerBank(FS, L, TrackingConfig(block_size_ms=B), n_channels=2, device="cpu")
    bank.assign(25, 900.0, 400.0, 0.0)
    iq = np.random.default_rng(3).standard_normal((B, L, 2)).astype(np.float32)
    recorder.enable()
    bank.process_block(iq, 0.0)
    records, counters = recorder.drain()
    names = [r[0] for r in records]
    assert names == ["bank.dispatch", "track.block", *CHILDREN, "bank.collect"]
    assert [r[3] for r in records] == [-1, 0, 1, 1, 1, 1, 1, -1]
    assert records[0][4] != records[-1][4]
    assert counters == {"track.blocks": 1, "phase1.products": 1}

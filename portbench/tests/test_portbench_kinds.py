"""Traffic kinds resolved by name: the farm's kind runs the farm exactly as
the harness's own composition of the farm's modules did, a kind added as a
file in another root runs through ``run.execute``, and unknown names fail
at load."""

import itertools
import json
import math
import time
import types

import numpy as np
import pytest
import torch

from portbench import cells, codes, compare, farm, generator, run
from portbench.tests._tiny import BENCH, tiny_root

torch.set_num_threads(2)
SEED = 2**31 + 9876
WINDOW_TICKS = 0.04  # of the clock below: 10-11 blocks, two passes of the ring


def _block_clock(monkeypatch):
    """The farm's clock advances 1 ms a reading, so a window holds as many
    blocks whatever the host's speed."""
    ticks = itertools.count()
    monkeypatch.setattr(farm, "time", types.SimpleNamespace(perf_counter=lambda: next(ticks) * 1e-3))


def _old_composition(cell, monkeypatch):
    """The farm as ``run.execute`` composed it before traffic kinds: the
    generator, ``farm.Farm`` and ``farm.Window``, then ``compare.numbers``."""
    dev = torch.device("cpu")
    caps = generator.make_captures(cell.config, cell.traffic, SEED)
    pool = generator.make_pool(caps, dev)
    system = farm.Farm(cell.config, cell.traffic, caps, pool, dev, None)
    window = farm.Window(system, 8, SEED)
    window.warm(run.WARM_BLOCKS)
    _block_clock(monkeypatch)
    stats = window.run(WINDOW_TICKS, None, (0, 0))
    kept, restart_mask = window.kept, system.restart_mask
    system.release()
    return stats, kept, compare.numbers(cell.config, cell.traffic, caps, pool, kept, restart_mask, dev)


def _through_the_kind(cell, monkeypatch):
    marks = []
    system = cell.kind.setup(cell, SEED, torch.device("cpu"), None, marks.append)
    assert marks == ["cuda", "pool", "entry"]  # run.py's set-up split keeps its names
    system.warm(run.WARM_BLOCKS)
    _block_clock(monkeypatch)
    stats = system.run(WINDOW_TICKS, None, (0, 0))
    system.release()
    return stats, system.kept, system.numbers()


@pytest.mark.parametrize("band", ["gps", "glonass"])
def test_farm_kind_equals_the_old_composition_to_the_bit(tmp_path, monkeypatch, band):
    cell = cells.load(tiny_root(tmp_path, band), "tiny-farm")
    old_stats, old_kept, old_values = _old_composition(cell, monkeypatch)
    new_stats, new_kept, new_values = _through_the_kind(cell, monkeypatch)
    assert new_stats["blocks"] == old_stats["blocks"] >= 8
    assert [b.k for b in new_kept] == [b.k for b in old_kept]
    for new, old in zip(new_kept, old_kept):
        assert torch.equal(new.outs, old.outs)
        for f in generator.STATE_FIELDS:
            assert torch.equal(getattr(new.carry_in, f), getattr(old.carry_in, f)), f
            assert torch.equal(getattr(new.carry_out, f), getattr(old.carry_out, f)), f
    assert all(math.isfinite(v) for v in old_values.values())
    assert new_values == old_values
    assert set(compare.NAMES) <= set(new_values)


# A second kind, as a later change would add it: a module, a traffic file,
# a configuration's cell and its limits, none of them in the package.
SUMS_KIND = '''
"""Traffic kind ``block_sums``: each block of int8 words summed over its
ms on the device, judged against numpy."""
import time

import numpy as np
import torch


def check(config, traffic):
    if traffic["width"] < 1:
        raise ValueError("width must be at least 1")


class Sums:
    names = ("sum_gap",)
    block_kernel = None

    def __init__(self, cell, seed, device, wrap, mark):
        t = cell.traffic
        self.words = np.random.default_rng(seed).integers(
            -127, 128, (t["ring"], t["block_ms"], t["width"]), dtype=np.int8)
        mark("cuda")
        self.pool = torch.from_numpy(self.words).to(device)
        mark("pool")
        entry = lambda block: block.to(torch.int32).sum(dim=0)
        self.entry = wrap(entry) if wrap else entry
        mark("entry")
        self.trace_span = t["ring"]
        self.shape = {"block_ms": t["block_ms"], "channels": t["width"]}
        self.kept, self.next_k = [], 0

    def _block(self):
        j = self.next_k % len(self.words)
        self.next_k += 1
        return j, self.entry(self.pool[j]).cpu()

    def warm(self, n):
        for _ in range(n):
            self._block()

    def run(self, seconds, session, traced):
        latency, t0 = [], time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            t_in = time.perf_counter()
            self.kept.append(self._block())
            latency.append(time.perf_counter() - t_in)
        return {"blocks": len(latency), "wall_s": time.perf_counter() - t0,
                "latency_s": latency, "issue_s": latency, "traced_blocks": 0}

    def release(self):
        self.entry = None

    def numbers(self, raw=None):
        gaps = [int(np.abs(out.numpy() - self.words[j].astype(np.int64).sum(axis=0)).max())
                for j, out in self.kept]
        return {"sum_gap": float(max(gaps)) if gaps else float("nan")}


setup = Sums
'''


def _sums_root(tmp_path):
    root = tiny_root(tmp_path)
    pb = root / "portbench"
    (pb / "kinds" / "block_sums.py").write_text(SUMS_KIND)
    (pb / "traffic" / "sums.json").write_text(json.dumps(
        {"kind": "block_sums", "ring": 3, "block_ms": 20, "width": 64}))
    (pb / "limits" / "tiny-sums.json").write_text(json.dumps({"sum_gap": 0}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny-sums", "config": "tiny", "traffic": "sums",
                               "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _plus_one(entry):
    return lambda block: entry(block) + 1


def test_a_kind_added_as_files_runs_without_edit(tmp_path):
    root = _sums_root(tmp_path)
    assert not (BENCH / "kinds" / "block_sums.py").exists()
    cell = cells.load(root, "tiny-sums")
    res = run.execute(cell, SEED, 0.2, False, device="cpu", t_start=time.perf_counter())
    assert res["correct"] is True and res["attempted"] >= 1
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert res["checks"] == {"sum_gap": {"value": 0.0, "limit": 0}}
    assert res["metrics"]["setup_s"]["value"] > 0
    # Its comparison is the kind's own, and it can fail.
    bad = run.execute(cell, SEED, 0.2, False, device="cpu", t_start=time.perf_counter(),
                      wrap=_plus_one)
    assert bad["correct"] is False and bad["checks"]["sum_gap"]["value"] == 1.0
    # The farm's cell in the same root still runs through its own kind.
    assert cells.load(root, "tiny-farm").kind.setup.__name__ == "Replay"


def test_an_unknown_kind_fails_at_load_naming_the_known(tmp_path):
    root = tiny_root(tmp_path)
    path = root / "portbench" / "traffic" / "farm.json"
    traffic = json.loads(path.read_text())
    path.write_text(json.dumps({**traffic, "kind": "no_such_kind"}))
    with pytest.raises(KeyError, match="no_such_kind.*known: farm_replay"):
        cells.load(root, "tiny-farm")


@pytest.mark.parametrize("change, match", [
    ({"band": "gps_l5"}, r"unknown band 'gps_l5' \(known: glonass_l1of, gps_l1ca\)"),
    ({"signals": [1, 2, 40]}, r"signal 40 is not one of the band's"),
])
def test_an_unknown_band_fails_at_load_naming_the_known(tmp_path, change, match):
    root = tiny_root(tmp_path)
    path = root / "portbench" / "configs" / "tiny.json"
    path.write_text(json.dumps({**json.loads(path.read_text()), **change}))
    with pytest.raises(ValueError, match=match):
        cells.load(root, "tiny-farm")


@pytest.mark.parametrize("name", ["gps_l1ca", "glonass_l1of"])
def test_the_band_table_keeps_the_ports_ids_and_the_old_rows(name):
    """``codes.BANDS`` against the port's own id mapping and the rows the
    generator and the farm used before the table: a GPS PRN n is id n and
    row n - 1, a GLONASS frequency number k is ``prn.glonass_prn_id(k)``
    and row 0 (one code); the replicas the farm picks by id are the rows
    that the old family (``ALL_PRN_IDS``, ``GLONASS_PRN_IDS``) gave."""
    from gypsum_tpu_torch.signal import prn

    b = codes.band(name)
    sig = np.asarray(b.signals)
    if name == "gps_l1ca":
        ids, rows, family = list(sig), sig - 1, prn.ALL_PRN_IDS
        assert np.array_equal(b.table(), codes.gps_codes())
    else:
        ids, rows, family = [prn.glonass_prn_id(int(k)) for k in sig], np.zeros_like(sig), prn.GLONASS_PRN_IDS
        assert np.array_equal(b.table(), codes.glonass_code()[None, :])
        assert sorted(sig) == list(range(-7, 7))
    assert b.port_id(sig).tolist() == ids
    assert b.code_rows(sig).tolist() == rows.tolist()
    assert np.array_equal(codes.signal_codes(name, list(sig)), b.table()[rows])
    row = {p: i for i, p in enumerate(family)}
    for spm in (2046, 4092):
        new, old = prn.replica_table(spm, b.port_ids), prn.replica_table(spm, family)
        assert np.array_equal(new, old[[row[p] for p in b.port_ids]])

"""One cell's farm with the program's spans on: the readings of
``hosttrace.py`` and what the spans cost.

    python3 -m portbench.spanrun --workload gps-farm64 --seed 7 --seconds 10 --cost-pairs 4

Set-up as ``run.py``'s, through the farm's traffic kind
(``kinds/farm_replay.py``: the pool from the seed, the farm entry), and
three warm blocks; a cell of another kind does not run here. Then
``--cost-pairs`` pairs of windows of ``--cost-seconds`` each, spans off and
on in turns (off first in even pairs, on first in odd ones),
before the profiler first starts: ``farm.issue_ms`` of each; and one window
twice as long with spans off and on in turns block by block. Then the
profiler's first start, and one window of ``--seconds`` with spans on and
``run.py``'s traced stretch under a ``hosttrace.HostSession``: the cell's
per-layer metrics and ``hosttrace.READINGS``. The stretch's idle time and
device time by host span go to standard error; the last line of standard
output is one JSON object. No correctness check: ``run.py`` makes it.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

from portbench.run import CACHES, ROOT, TRACE_FROM, WARM_BLOCKS, log  # noqa: E402


def spread(values: list[float]) -> float:
    """The quartile distance over the median."""
    if len(values) < 2:
        return 0.0
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else 0.0


def alternating(entry, spans):
    """``entry`` with spans off for the first call, on for the next, and so
    on."""
    calls = [0]

    def call(state, samples, replicas):
        if calls[0] % 2:
            spans.enable()
        else:
            spans.disable()
        calls[0] += 1
        return entry(state, samples, replicas)

    return call


def execute(cell, seed: int, seconds: float, cost_pairs: int, cost_seconds: float,
            device: str = "cuda") -> dict:
    import torch

    from gypsum_tpu_torch.obs import spans
    from gypsum_tpu_torch.ops.fixup import FIXUP_KERNEL
    from portbench import hosttrace

    dev = torch.device(device)
    replay = cell.kind.setup(cell, seed, dev, None, lambda _name: None)
    system, window = replay.system, replay.window  # the farm's own objects (``Replay``)
    window.warm(WARM_BLOCKS)

    cost = {"off": [], "on": []}
    for pair in range(cost_pairs):
        for side in (("off", "on") if pair % 2 == 0 else ("on", "off")):
            if side == "on":
                spans.enable()
            stats = window.run(cost_seconds)
            spans.disable()
            spans.drain()
            cost[side].append(1e3 * statistics.fmean(stats["issue_s"]))
    interleaved = None
    if cost_pairs:
        # One more window, spans off and on in turns block by block: the
        # host's drift over seconds, which the windows' means carry, falls
        # on both sides alike.
        entry = system.packed
        system.packed = alternating(entry, spans)
        stats = window.run(cost_seconds * 2)
        system.packed = entry
        spans.disable()
        spans.drain()
        ms = [1e3 * s for s in stats["issue_s"][: len(stats["issue_s"]) // 2 * 2]]
        off, on = ms[0::2], ms[1::2]
        interleaved = {"blocks_each": len(off),
                       "median_off": statistics.median(off), "median_on": statistics.median(on),
                       "spread_off": spread(off), "spread_on": spread(on),
                       "median_on_minus_off": statistics.median(b - a for a, b in zip(off, on))}

    session = None
    if dev.type == "cuda":  # the profiler's first start, outside the window
        session = hosttrace.HostSession()
        session.start()
        window.warm(1)
        session.stop()
        session.read()
        session = hosttrace.HostSession()
        torch.cuda.synchronize(dev)
    spans.enable()
    stats = window.run(seconds, session, (TRACE_FROM, TRACE_FROM + replay.trace_span))
    spans.disable()
    records, counters = spans.drain()
    if session is not None:
        session.read()

    ctx = {
        "setup_s": 0.0, "stats": stats, "session": session,
        "spans": {"records": records, "counters": counters},
        "shape": replay.shape, "block_kernel": replay.block_kernel,
    }
    metrics = {m["name"]: cell.reader(m["name"])(ctx) for m in cell.per_layer}
    metrics.update({name: read(ctx) for name, read in hosttrace.READINGS.items()})
    for line in hosttrace.report_lines(ctx):
        log(line)
    blocks = counters.get("track.blocks", 0)
    result = {
        "metrics": metrics,
        "counters": counters,
        "products_a_block": counters.get("phase1.products", 0) / blocks if blocks else None,
        "spans_a_block": len(records) / blocks if blocks else None,
        "k1_launches": FIXUP_KERNEL.launches,
        "blocks": stats["blocks"], "traced_blocks": stats["traced_blocks"],
        "host_records": len(session.launches) if session is not None else 0,
        "cost": {
            "farm.issue_ms": cost,
            "median_off": statistics.median(cost["off"]) if cost_pairs else None,
            "median_on": statistics.median(cost["on"]) if cost_pairs else None,
            "spread_off": spread(cost["off"]), "spread_on": spread(cost["on"]),
            "windows_each": cost_pairs,
            "interleaved": interleaved,
        },
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }
    system.release()
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.spanrun", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--cost-pairs", type=int, default=4)
    ap.add_argument("--cost-seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    for var, rel in CACHES.items():
        os.environ[var] = str(ROOT / rel)

    from portbench import cells

    cell = cells.load(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available():
        log(f"{args.workload} needs a CUDA device")
        return 2
    result = execute(cell, args.seed, args.seconds, args.cost_pairs, args.cost_seconds)
    result["setup_to_end_s"] = time.perf_counter() - T_START
    print(json.dumps(result, allow_nan=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())

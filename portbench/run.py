"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m portbench --workload gps-farm64 --seed 7 --seconds 10 --trace 0

Set-up (``setup_s``, from the first line of this module): import torch and
the port, make the cell's pool of captures on the card from the seed, build
the farm entry, warm it on the run's first blocks. Then the window: blocks
for ``--seconds`` of host time at depth 1, every block's outputs copied to
the host. With ``--trace 1`` a stretch of the window runs under the
device profiler and the per-layer metrics are read from it; with
``--trace 0`` the whole window does, where the cell has an end-to-end
metric read from the device trace. After the
window: the peak of device memory, the program's state freed, and the kept
blocks judged against the plain reference (``compare.py``).

The last line of standard output is one JSON object (README.md); the last
lines of standard error are the compared numbers beside their limits.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# The program's build caches live in the checkout, at fixed paths.
CACHES = {"TRITON_CACHE_DIR": "build/triton", "TORCH_EXTENSIONS_DIR": "build/torch_extensions"}
FORBIDDEN = {"jax", "jaxlib", "flax", "gypsum_tpu"}
WARM_BLOCKS = 3
KEEP_BLOCKS = 8  # blocks of each window judged against the reference
TRACE_FROM = 5  # the traced stretch: window blocks TRACE_FROM .. TRACE_FROM + ring - 1


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


def execute(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
            t_start: float = T_START, wrap=None, raw: dict | None = None) -> dict:
    """One run of ``cell`` (cells.Cell). ``wrap`` replaces the entry (the
    tests' faults and the control); ``raw`` gets the compared gaps of each
    held channel-block. Returns the result line's object."""
    import numpy as np
    import torch

    from portbench import compare, farm, generator
    from portbench import trace as tracing

    dev = torch.device(device)
    split = {"imports": time.perf_counter() - t_start}

    def mark(name):
        split[name] = time.perf_counter() - t_start - sum(split.values())

    caps = generator.make_captures(cell.config, cell.traffic, seed)
    if dev.type == "cuda":
        torch.cuda.init()
    mark("cuda")
    pool = generator.make_pool(caps, dev)
    mark("pool")
    system = farm.Farm(cell.config, cell.traffic, caps, pool, dev, wrap)
    window = farm.Window(system, KEEP_BLOCKS, seed)
    mark("entry")
    window.warm(WARM_BLOCKS)
    mark("warm")
    # A device-trace end-to-end metric is read over the whole window.
    whole = (not trace and dev.type == "cuda"
             and any(m["source"] == "device_trace" for m in cell.end_to_end))
    session = tracing.Session() if trace or whole else None
    if session is not None:  # the profiler's first start, outside the window
        session.start()
        window.warm(1)
        session.stop()
        session.read()
        session = tracing.Session()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start
    mark("profiler")
    log("setup split (s): " + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    traced = (0, math.inf) if whole else (TRACE_FROM, TRACE_FROM + caps.ring)
    t_window = time.perf_counter()
    stats = window.run(seconds, session, traced)
    after = {"profiler stop": time.perf_counter() - t_window - stats["wall_s"]}
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    t_read = time.perf_counter()
    if session is not None:
        session.read()
    after["trace read"] = time.perf_counter() - t_read
    kept, restart_mask = window.kept, system.restart_mask
    system.release()
    del window
    t_ref = time.perf_counter()
    values = compare.numbers(cell.config, cell.traffic, caps, pool, kept, restart_mask, dev, raw)
    correct = compare.judge(values, cell.limits)
    after["reference"] = time.perf_counter() - t_ref
    log("after the window (s): " + ", ".join(f"{k} {v:.3f}" for k, v in after.items()))

    n_streams, per = caps.signals.shape
    ctx = {
        "setup_s": setup_s, "stats": stats, "session": session,
        "shape": {"block_ms": caps.block_ms, "channels": n_streams * per, "streams": n_streams,
                  "samples_per_ms": caps.samples_per_ms,
                  "k_half": cell.config["tracking"]["lag_window_half_width"]},
    }
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": stats["blocks"], "failed": 0, "metrics": metrics}
    result["device"] = {
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": 1,
        "memory_peak_bytes": peak,
    }
    if whole:
        per_block = 1e3 / max(stats["traced_blocks"], 1)
        copies = [e for e in session.events if tracing.is_host_copy(e)]
        log(f"profiler check: {stats['traced_blocks']} blocks traced, {tracing.k1_count(session.events)} "
            f"K1 records, device busy by the trace {tracing.busy_s(session.events) * per_block} ms a "
            f"block, of which copies to and from the host {tracing.busy_s(copies) * per_block} ms")
    if trace and session.events:
        blocks = max(stats["traced_blocks"], 1)
        per_block = tracing.busy_s(session.events) * 1e3 / blocks
        spans = session.event_block_ms()
        log(f"profiler check: {stats['traced_blocks']} traced blocks, device busy by the trace "
            f"{per_block} ms a block, block spans by CUDA events {float(np.mean(spans))} ms "
            f"(min {min(spans)}, max {max(spans)})")
        result["device"]["busy_s"] = tracing.busy_s(session.events)
        result["device"]["window_s"] = session.window_s()
        result["breakdown"] = {"device_ops": tracing.device_ops(session.events),
                               "idle_gaps": tracing.idle_gaps(session.events)}
    result["held_share"] = values["held_share"]
    # Last key: every compared number beside its limit (null: not finite).
    result["checks"] = {n: {"value": values[n] if math.isfinite(values[n]) else None,
                            "limit": cell.limits[n]} for n in compare.NAMES}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, rel in CACHES.items():
        os.environ[var] = str(ROOT / rel)

    from portbench import cells

    cell = cells.load(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = execute(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        log(f"modules of JAX or the JAX package are loaded: {', '.join(found)}")
        return 3
    for name, check in result["checks"].items():
        log(f"{name} {check['value']} limit {check['limit']}")
    print(json.dumps(result, allow_nan=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())

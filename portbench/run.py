"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m portbench --workload gps-farm64 --seed 7 --seconds 10 --trace 0

The cell's traffic kind (``kinds/<kind>.py``, which ``cells.load`` resolves
from the mix's ``"kind"``) builds and drives the system under test and says
what is compared; this module keeps what every cell shares. Set-up
(``setup_s``, from the first line of this module): import torch and the
port, the kind's set-up from the seed (for the farm: the cell's pool of
captures made on the card, the farm entry built), then the kind's warm
blocks. Then the window: the kind's blocks for ``--seconds`` of host time.
With ``--trace 1`` a stretch of the window runs under the device profiler
and the per-layer metrics are read from it; with ``--trace 0`` the whole
window does, where the cell has an end-to-end metric read from the device
trace. After the window: the peak of device memory, the program's state
freed, and the kind's compared numbers judged against the cell's limits.

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
TRACE_FROM = 5  # the traced stretch: window blocks TRACE_FROM .. TRACE_FROM + trace_span - 1


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

    from portbench import trace as tracing

    dev = torch.device(device)
    split = {"imports": time.perf_counter() - t_start}

    def mark(name):
        split[name] = time.perf_counter() - t_start - sum(split.values())

    system = cell.kind.setup(cell, seed, dev, wrap, mark)
    system.warm(WARM_BLOCKS)
    mark("warm")
    # A device-trace end-to-end metric is read over the whole window.
    whole = (not trace and dev.type == "cuda"
             and any(m["source"] == "device_trace" for m in cell.end_to_end))
    session = tracing.Session() if trace or whole else None
    if session is not None:  # the profiler's first start, outside the window
        session.start()
        system.warm(1)
        session.stop()
        session.read()
        session = tracing.Session()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start
    mark("profiler")
    log("setup split (s): " + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    traced = (0, math.inf) if whole else (TRACE_FROM, TRACE_FROM + system.trace_span)
    t_window = time.perf_counter()
    stats = system.run(seconds, session, traced)
    after = {"profiler stop": time.perf_counter() - t_window - stats["wall_s"]}
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    t_read = time.perf_counter()
    if session is not None:
        session.read()
    after["trace read"] = time.perf_counter() - t_read
    system.release()
    t_ref = time.perf_counter()
    values = system.numbers(raw)
    correct = all(math.isfinite(values[n]) and values[n] <= cell.limits[n] for n in system.names)
    after["reference"] = time.perf_counter() - t_ref
    log("after the window (s): " + ", ".join(f"{k} {v:.3f}" for k, v in after.items()))

    ctx = {"setup_s": setup_s, "stats": stats, "session": session, "shape": system.shape,
           "block_kernel": system.block_kernel}
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
        once = system.block_kernel
        counted = (f"{tracing.kernel_count(session.events, once)} records of {once} (once a block)"
                   if once else "no kernel that runs once a block")
        log(f"profiler check: {stats['traced_blocks']} blocks traced, {counted}, device busy by the "
            f"trace {tracing.busy_s(session.events) * per_block} ms a block, of which copies to and "
            f"from the host {tracing.busy_s(copies) * per_block} ms")
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
    # Values the kind reports but does not judge (the farm: held_share).
    result.update({k: v for k, v in values.items() if k not in system.names})
    # Last key: every compared number beside its limit (null: not finite).
    result["checks"] = {n: {"value": values[n] if math.isfinite(values[n]) else None,
                            "limit": cell.limits[n]} for n in system.names}
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

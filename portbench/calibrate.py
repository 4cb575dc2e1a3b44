"""Readings for the limits of the correctness check, on the card.

    python3 -m portbench.calibrate --workload gps-farm64 --seeds 201-212 \
        --control-seeds 301-303 --seconds 4 --out chiprun_out/cal.jsonl

In one process: for each seed, a run of the cell (a short window at the
cell's own load, the same kept blocks and comparison as a benchmark run)
gives the program's numbers; for each control seed, the same run with the
control (``control.py``: the reference at fp8 operands) in the program's
place. Each run's numbers are one JSON line, and the held channel-blocks'
gaps go to ``<out stem>_<side>_<seed>.npz`` beside it. The lower reading of a number
is the largest of the program's, the upper the smallest of the control's;
``PERF.md`` keeps both beside each limit. Benchmark runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

from portbench import cells, control, generator, run


def seeds(text: str) -> list[int]:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    cell = cells.load(run.ROOT, args.workload)
    from gypsum_tpu_torch.track.loop import TrackState

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    todo = [("program", s) for s in seeds(args.seeds) if args.seeds]
    todo += [("control", s) for s in seeds(args.control_seeds) if args.control_seeds]
    with out.open("a") as f:
        for side, seed in todo:
            wrap = None
            if side == "control":
                caps = generator.make_captures(cell.config, cell.traffic, seed)
                wrap = control.fp8_entry(cell.config, caps, TrackState)
            t0 = time.perf_counter()
            raw: dict = {}
            res = run.execute(cell, seed, args.seconds, False, t_start=t0, wrap=wrap, raw=raw)
            np.savez_compressed(out.with_name(f"{out.stem}_{side}_{seed}.npz"), **raw)
            line = {"workload": cell.name, "side": side, "seed": seed,
                    "correct": res["correct"], "blocks": res["attempted"],
                    "seconds": time.perf_counter() - t0,
                    **{k: v["value"] for k, v in res["checks"].items()},
                    "held_share": res["held_share"]}
            f.write(json.dumps(line) + "\n")
            f.flush()
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

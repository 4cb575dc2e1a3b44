"""One CPU thread budget for the port's test processes.

Every ``tests/test_torch_*.py`` imports this module before it imports torch
or the port. pytest-xdist imports every test module in every worker when it
collects, so the first port module a worker imports caps that worker's torch
for its whole life, before any test runs. JAX keeps its own thread pool and
is not affected.

Without the cap each of the tier-1 run's six workers starts torch with as
many OpenMP and MKL threads as the box has cores, and the spinning threads
of small FFTs and matmuls take the cores from one another and from the JAX
files that run beside them. ``THREADS`` was chosen by timing whole tier-1
runs at 1 and 2 threads (ROADMAP.md, C7).

``subprocess_env()`` gives every process a port test spawns (CLI replays,
import checks, gloo ranks) the same budget. ``concurrently()`` runs a
fixture's independent steps at once, where they release the GIL.

    python -m tests._torch_cpu /tmp/_t1.xml [more.xml ...]

prints each test file's worker seconds in the runs whose junit XML is given
(the ``time`` of its cases, fixtures included), longest first, and the
totals of the port's files and of all.
"""

from __future__ import annotations

import os
import sys
import xml.etree.ElementTree as ET
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

THREADS = 2
ROOT = Path(__file__).resolve().parent.parent

torch.set_num_threads(THREADS)
try:
    torch.set_num_interop_threads(THREADS)
except RuntimeError:  # already set, or inter-op work has started in this process
    pass


def subprocess_env(**extra: str) -> dict[str, str]:
    """``os.environ`` for a child process of a port test: torch's thread
    budget, the repo on ``PYTHONPATH``, and ``extra`` on top."""
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = str(THREADS)
    env["MKL_NUM_THREADS"] = str(THREADS)
    env["PYTHONPATH"] = str(ROOT)
    env.update(extra)
    return env


def concurrently(*calls):
    """Run ``calls`` at once and return their results in order: the first
    on this thread, each other on a thread of its own. For a fixture's
    independent steps whose work releases the GIL (numpy synthesis, a JAX
    receiver); put the port's torch work first, on the thread whose budget
    this module set."""
    with ThreadPoolExecutor(max(1, len(calls) - 1)) as pool:
        others = [pool.submit(call) for call in calls[1:]]
        first = calls[0]()
        return [first] + [f.result() for f in others]


def file_seconds(junit_xml: str) -> dict[str, float]:
    """Worker seconds of each test file in one run: the summed ``time`` of
    its cases (pytest counts a module fixture in its first case's)."""
    seconds: dict[str, float] = defaultdict(float)
    for case in ET.parse(junit_xml).getroot().iter("testcase"):
        seconds[case.get("classname").split(".")[-1]] += float(case.get("time") or 0.0)
    return dict(seconds)


if __name__ == "__main__":
    runs = [file_seconds(path) for path in sys.argv[1:]]
    names = sorted(set().union(*runs), key=lambda n: -runs[0].get(n, 0.0))
    for name in names:
        print(f"{name:40s}" + "".join(f"{run.get(name, 0.0):10.1f}" for run in runs))
    for label, keep in (("port files", lambda n: n.startswith("test_torch_")), ("all", bool)):
        print(f"{'TOTAL ' + label:40s}"
              + "".join(f"{sum(v for n, v in run.items() if keep(n)):10.1f}" for run in runs))

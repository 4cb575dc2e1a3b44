"""Resolve a cell of ``BENCHMARK.json`` to its files, by name.

A cell (``workloads[]``) names a configuration and a traffic mix. Its files:

- the configuration: the ``file`` its ``configs[]`` entry gives;
- the traffic mix: ``<bench dir>/traffic/<traffic>.json``;
- the traffic kind that runs the mix: ``<bench dir>/kinds/<kind>.py``, where
  ``<kind>`` is the mix's ``"kind"``. It builds the system under test from
  the cell's files and the seed, drives it, and says what is compared
  (``README.md``, "Adding a traffic kind"). An unknown kind fails here,
  naming the kinds found, and so does a configuration that the kind's
  ``check(config, traffic)`` refuses (an unknown band, say);
- the limits of its correctness check: ``<bench dir>/limits/<cell>.json``;
- each metric it reports: a reader ``<bench dir>/metrics/<metric>.py``
  holding ``read(ctx) -> float | None``.

``<bench dir>`` is the directory of this file's package under the root that
holds ``BENCHMARK.json``. Adding a cell, a mix, a kind or a metric is adding
files and entries: nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.name


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]  # BENCHMARK.json entries this cell reports
    per_layer: list[dict]
    bench_dir: Path
    kind: object  # the module kinds/<traffic kind>.py

    def reader(self, metric: str):
        """The ``read`` function of ``metrics/<metric>.py``."""
        return _module(self.bench_dir / "metrics" / f"{metric}.py", "metric", metric).read


def _module(path: Path, what: str, name: str):
    spec = importlib.util.spec_from_file_location(f"{PACKAGE}_{what}_{name}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no {what} {name!r} at {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _kind(bench_dir: Path, name: str):
    """The module ``kinds/<name>.py``; an unknown kind raises, naming the
    kinds found."""
    path = bench_dir / "kinds" / f"{name}.py"
    if not path.exists():
        found = sorted(p.stem for p in (bench_dir / "kinds").glob("*.py"))
        raise KeyError(f"no traffic kind {name!r} at {path} (known: {', '.join(found)})")
    return _module(path, "kind", name)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``."""
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {root / 'BENCHMARK.json'} "
                       f"(known: {', '.join(sorted(cells))})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    bench_dir = root / PACKAGE
    traffic = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((bench_dir / "limits" / f"{workload}.json").read_text())
    kind = _kind(bench_dir, traffic["kind"])
    kind.check(config, traffic)
    return Cell(
        name=workload, chips=int(w["chips"]), config=config, traffic=traffic, limits=limits,
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, workload)],
        bench_dir=bench_dir, kind=kind,
    )

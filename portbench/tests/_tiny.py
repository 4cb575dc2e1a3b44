"""A tiny cell laid out as a checkout: 2 streams x 3 channels, 50 ms blocks
and 0.2 s captures unless asked otherwise, from the committed configuration
and traffic files."""

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "portbench"
CONFIGS = {"gps": "gps_l1ca_2046k", "glonass": "glonass_l1of_4092k"}


def tiny_root(tmp: Path, band: str = "gps", name: str = "tiny", block_ms: int = 50,
              capture_s: float = 0.2, cn0_dbhz=None) -> Path:
    """A root holding BENCHMARK.json with one cell ``<name>-farm`` of a new
    configuration ``<name>``: data files only, the code is the package's."""
    pb = Path(tmp) / "portbench"
    for d in ("configs", "traffic", "limits"):
        (pb / d).mkdir(parents=True, exist_ok=True)
    for d in ("metrics", "kinds"):
        shutil.copytree(BENCH / d, pb / d, dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("__pycache__"))
    cfg = json.loads((BENCH / "configs" / f"{CONFIGS[band]}.json").read_text())
    cfg.update(name=name, streams=2, channels_per_stream=3)
    cfg["tracking"]["block_size_ms"] = block_ms
    (pb / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    traffic = json.loads((BENCH / "traffic" / "farm.json").read_text())
    traffic["capture_s"] = capture_s
    if cn0_dbhz is not None:
        traffic["cn0_dbhz"] = cn0_dbhz
    (pb / "traffic" / "farm.json").write_text(json.dumps(traffic))
    limits = json.loads((BENCH / "limits" / "gps-farm64.json").read_text())
    (pb / "limits" / f"{name}-farm.json").write_text(json.dumps(limits))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": name, "source": "test", "file": f"portbench/configs/{name}.json",
                         "reduced": [], "why": "test"}]
    bench["workloads"] = [{"name": f"{name}-farm", "config": name, "traffic": "farm", "chips": 1,
                           "why": "test"}]
    (Path(tmp) / "BENCHMARK.json").write_text(json.dumps(bench))
    return Path(tmp)

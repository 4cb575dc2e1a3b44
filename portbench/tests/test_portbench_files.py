"""Every cell resolves to its files; the generator's conventions are the
tracker's; nothing loads JAX or the JAX package, and the reference nothing
of the program."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import cells, codes, compare, generator
from portbench.tests._tiny import BENCH, REPO

BENCHMARK = json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("workload", [w["name"] for w in BENCHMARK["workloads"]])
def test_every_cell_resolves(workload):
    cell = cells.load(REPO, workload)
    assert cell.config["name"] == next(w["config"] for w in BENCHMARK["workloads"]
                                       if w["name"] == workload)
    assert cell.traffic["kind"] == "farm_replay"
    assert set(cell.limits) == set(compare.NAMES)
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cell.reader(m["name"]))
    assert (BENCH / "reference" / f"{cell.config['reference']}.py").exists()


def test_configs_match_benchmark_entries():
    for c in BENCHMARK["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]


@pytest.mark.parametrize("band", ["gps", "glonass"])
def test_synthesis_puts_the_signal_where_the_handoff_says(band):
    """One noise-free satellite: wiped with the hand-off's truth phase and
    correlated at its truth code phase, ms 0 and ms 700 give the whole
    amplitude, and one chip off gives nearly nothing."""
    from portbench.tests._tiny import CONFIGS

    cfg = json.loads((BENCH / "configs" / f"{CONFIGS[band]}.json").read_text())
    cfg.update(streams=1, channels_per_stream=4)
    traffic = json.loads((BENCH / "traffic" / "farm.json").read_text())
    traffic.update(capture_s=1, handoff={"doppler_hz": 0.0, "code_phase_samples": 0.0})
    caps = generator.make_captures(cfg, traffic, 3)
    caps.noise_lsb = 0.0
    caps.amplitude[:] = 0.0
    caps.amplitude[0, 1] = 60.0
    length, fs = caps.samples_per_ms, caps.sample_rate
    rep = codes.replicas(codes.signal_codes(caps.band, [int(caps.signals[0, 1])]), length)[0]
    for t in (0, 700):
        x = generator.synth_plain(caps, 0, t, 1).numpy()[0].astype(np.float64)
        x = x[:, 0] + 1j * x[:, 1]
        truth = generator.handoff(caps, np.array([t]), traffic)
        cp, th = truth["code_phase"][1], truth["carrier_phase"][1]
        f = caps.freq_hz[0, 1]
        wiped = x * np.exp(-1j * (th + 2 * np.pi * f * np.arange(length) / fs))
        spc = length / caps.chips

        def corr(shift):
            # The code is sampled at whole samples: the replica that lines up
            # with a code phase cp is the one rolled by ceil(cp).
            return abs(np.sum(wiped * np.roll(rep, int(np.ceil(cp + shift)))))

        assert corr(0) > 0.9 * 60 * length, (t, corr(0))
        assert corr(2 * spc) < 0.2 * corr(0)


def test_same_seed_same_pool():
    cfg = json.loads((BENCH / "configs" / "gps_l1ca_2046k.json").read_text())
    cfg.update(streams=2, channels_per_stream=2)
    cfg["tracking"]["block_size_ms"] = 20
    traffic = json.loads((BENCH / "traffic" / "farm.json").read_text())
    traffic["capture_s"] = 0.04
    a = generator.make_pool(generator.make_captures(cfg, traffic, 2**33 + 1), "cpu")
    b = generator.make_pool(generator.make_captures(cfg, traffic, 2**33 + 1), "cpu")
    c = generator.make_pool(generator.make_captures(cfg, traffic, 2**33 + 2), "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (2, 20, 2, 2046, 2) and a.dtype == torch.int8


_PROBE = """
import sys, time, torch
sys.path.insert(0, {repo!r})
torch.set_num_threads(2)
{body}
top = {{n.split(".")[0] for n in sys.modules}}
print(sorted(top & {{"jax", "jaxlib", "flax", "gypsum_tpu", "gypsum_tpu_torch"}}))
"""


def _loaded(body: str, tmp_path) -> list:
    code = _PROBE.format(repo=str(REPO), body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    return eval(out.stdout.strip().splitlines()[-1])


def test_harness_loads_no_jax(tmp_path):
    from portbench.tests._tiny import tiny_root

    root = tiny_root(tmp_path / "root")
    body = (f"from portbench import cells, run\n"
            f"run.execute(cells.load({str(root)!r}, 'tiny-farm'), 3, 0.1, True and False, "
            f"device='cpu', t_start=time.perf_counter())")
    assert _loaded(body, tmp_path) == ["gypsum_tpu_torch"]


def test_reference_loads_nothing_of_the_program(tmp_path):
    body = """
import json, numpy as np
from portbench import generator
from portbench.reference import farm_tracker as ref
cfg = json.load(open({cfg!r}))
cfg.update(streams=1, channels_per_stream=2); cfg["tracking"]["block_size_ms"] = 10
traffic = json.load(open({traffic!r})); traffic["capture_s"] = 0.01
caps = generator.make_captures(cfg, traffic, 1)
pool = generator.make_pool(caps, "cpu")
rows = generator.handoff(caps, np.zeros(1), traffic)
carry = {{k: torch.tensor(np.asarray(v, dtype=np.float32)) for k, v in rows.items()}}
reps = ref.channel_replicas(cfg, caps.signals, "cpu")
ref.track_blocks(cfg, [{{"samples": pool[0], "carry": carry, "replicas": reps}}])
""".format(cfg=str(BENCH / "configs" / "gps_l1ca_2046k.json"),
           traffic=str(BENCH / "traffic" / "farm.json"))
    assert _loaded(body, tmp_path) == []

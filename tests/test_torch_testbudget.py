"""The port's test processes keep to one CPU thread budget (tests/_torch_cpu.py).

A source scan, like tests/test_torch_imports.py's: every port test file
imports the helper before torch or the port, and every process a port test
spawns gets the helper's environment. Then the budget itself, in this
process and in a child.
"""

import tests._torch_cpu  # noqa: F401  # isort: skip (first: caps torch's threads)

import ast
import re
import subprocess
import sys

import pytest
import torch

from tests._torch_cpu import ROOT, THREADS, subprocess_env

TESTS = ROOT / "tests"
_HELPER = re.compile(r"^(?:import tests\._torch_cpu\b|from tests\._torch_cpu import )")
# torch, the port, and the modules of the repo that import torch when loaded.
_TORCH = re.compile(r"^\s*(?:from|import)\s+(?:torch|gypsum_tpu_torch|chip_smoke|tools\.campaign_torch)\b"
                    r"|^\s*from\s+tools\s+import\s+campaign_torch\b")
_SPAWN = {"run", "Popen", "call", "check_call", "check_output"}


def _port_tests():
    return sorted(TESTS.glob("test_torch_*.py"))


def _spawners():
    return _port_tests() + [TESTS / "_torch_dist_worker.py"]


@pytest.mark.parametrize("path", _port_tests(), ids=lambda p: p.name)
def test_port_test_imports_the_thread_helper_before_torch(path):
    lines = path.read_text().splitlines()
    helper = next((i for i, line in enumerate(lines) if _HELPER.match(line)), None)
    first_torch = next((i for i, line in enumerate(lines) if _TORCH.match(line)), len(lines))
    assert helper is not None, f"{path.name} does not import tests._torch_cpu"
    assert helper < first_torch, f"{path.name}:{first_torch + 1} imports torch before the helper"


def _env_of(call: ast.Call, assigned: dict) -> str:
    """How a spawn call sets ``env``: 'budget' for subprocess_env(...),
    directly or through a name assigned from it, else what it passes."""
    env = next((k.value for k in call.keywords if k.arg == "env"), None)
    if isinstance(env, ast.Name):
        env = assigned.get(env.id, env)
    if isinstance(env, ast.Call) and isinstance(env.func, ast.Name) and env.func.id == "subprocess_env":
        return "budget"
    return ast.dump(env) if env is not None else "inherited"


@pytest.mark.parametrize("path", _spawners(), ids=lambda p: p.name)
def test_every_spawned_process_takes_the_budget(path):
    tree = ast.parse(path.read_text())
    assigned = {t.id: node.value for node in ast.walk(tree) if isinstance(node, ast.Assign)
                for t in node.targets if isinstance(t, ast.Name)}
    spawns = [node for node in ast.walk(tree) if isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute) and node.func.attr in _SPAWN
              and isinstance(node.func.value, ast.Name) and node.func.value.id == "subprocess"]
    bad = [(c.lineno, _env_of(c, assigned)) for c in spawns if _env_of(c, assigned) != "budget"]
    assert not bad, f"{path.name}: spawned without subprocess_env(): {bad}"


def test_this_process_runs_torch_at_the_budget():
    assert torch.get_num_threads() == THREADS


def test_a_spawned_process_runs_torch_at_the_budget():
    proc = subprocess.run(
        [sys.executable, "-c", "import torch; print(torch.get_num_threads())"], cwd=ROOT,
        env=subprocess_env(), capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert int(proc.stdout.split()[-1]) == THREADS

"""One rank of a gloo group on the CPU, for tests/test_torch_parallel.py and
tests/test_torch_receiver.py. It imports the port only (no JAX, nothing of
the JAX package): the tests compute the JAX references in their own
process.

    python tests/_torch_dist_worker.py TASK RANK WORLD DIR THREADS TIMEOUT_S

The ranks meet through a ``FileStore`` in DIR, read their inputs from
DIR/inputs.npz (DIR/scene.npy for the receiver) and write their results to
DIR/rank<RANK>.pkl. Tasks:

- ``parallel`` (4 ranks, sat 2 x time 2): the sharded sweep (and a
  planted tie across shards), the halo sweep, the sharded fast tracker, the
  channel-sharded block of the default tracker and the farm;
- ``receiver`` (2 ranks, sat 2 x time 1): ``Receiver(mesh=...)`` replays
  the scene;
- ``fail`` (2 ranks): rank 1 raises before the first collective; rank 0
  must fail too, within the group's timeout, instead of waiting forever.

``launch`` starts the ranks from a test and ``Launch.wait`` collects them,
killing every rank still running at the time limit.
"""

from __future__ import annotations

import datetime
import pickle
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FS, L = 2.046e6, 2046


class Launch:
    """The ranks of one launch, running."""

    def __init__(self, procs: list, directory: Path) -> None:
        self.procs = procs
        self.directory = directory

    def wait(self, timeout: float) -> tuple[list, list[str], bool]:
        """(return codes, outputs, whether the time limit killed a rank)."""
        deadline = time.monotonic() + timeout
        outs, timed_out = [], False
        try:
            for p in self.procs:
                try:
                    out, _ = p.communicate(timeout=max(0.1, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    timed_out = True
                    p.kill()
                    out, _ = p.communicate()
                outs.append(out)
        finally:
            self.close()
        return [p.returncode for p in self.procs], outs, timed_out

    def close(self) -> None:
        """Kill every rank still running."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def results(self) -> list:
        return [pickle.loads((self.directory / f"rank{r}.pkl").read_bytes())
                for r in range(len(self.procs))]


def launch(task: str, world: int, directory: Path, threads: int | None = None,
           timeout_s: float = 120.0) -> Launch:
    """Start ``world`` ranks of ``task`` in ``directory``, each with the
    port tests' thread budget (tests/_torch_cpu.py)."""
    from tests._torch_cpu import THREADS, subprocess_env

    threads = threads or THREADS
    env = subprocess_env(GLOO_SOCKET_IFNAME="lo")  # the ranks talk over the loopback only
    procs = [
        subprocess.Popen(
            [sys.executable, str(Path(__file__)), task, str(rank), str(world),
             str(directory), str(threads), str(timeout_s)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=str(ROOT), env=env,
        )
        for rank in range(world)
    ]
    return Launch(procs, Path(directory))


# ------------------------------------------------------------------ ranks


def _t(a):
    import torch

    return torch.from_numpy(a)


def _numpy(nt) -> dict:
    return {k: v.numpy() for k, v in nt._asdict().items()}


def _task_parallel(mesh, inp: dict) -> dict:
    import numpy as np
    import torch

    from gypsum_tpu_torch.core.config import TrackingConfig
    from gypsum_tpu_torch.parallel.mesh import all_gather_cat
    from gypsum_tpu_torch.parallel.sharded import (
        make_sharded_track_block_fn,
        shard_tracking_inputs,
        sharded_acquisition_sweep,
    )
    from gypsum_tpu_torch.parallel.streaming import time_sharded_correlation_power
    from gypsum_tpu_torch.track.loop import (
        carry_rows,
        fresh_state,
        make_farm_track_block_fn,
        make_track_block_fn,
    )

    out = {}
    for name in ("sweep", "tie"):
        res = sharded_acquisition_sweep(mesh, _t(inp["sweep_samples"]), _t(inp["dopplers"]),
                                        _t(inp[f"{name}_pfc"]), FS)
        out[name] = [r.numpy() for r in res]
    out["stream"] = time_sharded_correlation_power(
        mesh, _t(inp["stream_iq"]), inp["stream_rep"]).numpy()

    def track_state(n):
        st = fresh_state(n)
        return st._replace(doppler=st.doppler + 700.0, code_phase=st.code_phase + 100.0)

    # The fast tracker (phase 1 + the fixup, which is K1 on the card).
    cfg = TrackingConfig(block_size_ms=12, use_matmul_tracker=True, matmul_tracker_bf16=False,
                         fixup_backend="pallas", fixup_group_ms=6)
    fn = make_sharded_track_block_fn(mesh, cfg, L, FS, 8, device="cpu")
    st, outs = fn(track_state(8), _t(inp["fast_iq"]), _t(inp["fast_replicas"]))
    out["fast"] = (_numpy(st), _numpy(outs))

    # The default tracker's block on this rank's channels, gathered.
    local = make_track_block_fn(TrackingConfig(block_size_ms=8), L, FS, 4, device="cpu")
    st, smp, rep = shard_tracking_inputs(mesh, track_state(8), _t(inp["scan_iq"]),
                                         _t(inp["scan_replicas"]))
    st, outs = local.packed(st, smp, rep)
    group = mesh.get_group("sat")
    out["scan"] = (all_gather_cat(torch.stack(carry_rows(st)), group, 1).numpy(),
                   all_gather_cat(outs, group, 2).numpy())

    # The farm, and each of its streams tracked alone.
    cfg_farm = TrackingConfig(block_size_ms=40, lag_window_block_margin=10)
    farm_state = fresh_state(4)._replace(
        doppler=np.array([900.0, 900.0, -2500.0, -2500.0], np.float32),
        code_phase=np.array([300.0, 300.0, 1500.0, 1500.0], np.float32),
    )
    farm = make_farm_track_block_fn(cfg_farm, L, FS, 4, inp["farm_streams"], device="cpu")
    st, outs = farm(farm_state, _t(inp["farm_samples"]), _t(inp["farm_replicas"]))
    out["farm"] = (_numpy(st), _numpy(outs))
    alone = []
    single = make_track_block_fn(cfg_farm, L, FS, 2, device="cpu")
    for n, cols in enumerate((slice(0, 2), slice(2, 4))):
        st1 = fresh_state(2)._replace(doppler=farm_state.doppler[cols],
                                      code_phase=farm_state.code_phase[cols])
        s1, o1 = single(st1, _t(np.ascontiguousarray(inp["farm_samples"][:, n])),
                        _t(inp["farm_replicas"][cols]))
        alone.append((_numpy(s1), _numpy(o1)))
    out["farm_alone"] = alone

    # What the JAX package refuses, refused alike (before any collective).
    refused = []
    for call in (
        lambda: sharded_acquisition_sweep(mesh, _t(inp["sweep_samples"]), _t(inp["dopplers"]),
                                          _t(inp["sweep_pfc"][:31]), FS),
        lambda: make_sharded_track_block_fn(mesh, cfg, L, FS, 7, device="cpu"),
        lambda: time_sharded_correlation_power(mesh, _t(inp["stream_iq"][:5 * L]),
                                               inp["stream_rep"]),
        lambda: time_sharded_correlation_power(mesh, _t(inp["stream_iq"][:6 * L]),
                                               inp["stream_rep"]),
    ):
        try:
            call()
        except ValueError as exc:
            refused.append(str(exc))
    out["refused"] = refused
    return out


def _task_receiver(mesh, directory: Path) -> dict:
    import dataclasses

    import numpy as np

    from gypsum_tpu_torch.core.config import ReceiverConfig
    from gypsum_tpu_torch.io.sources import ArraySampleSource
    from gypsum_tpu_torch.parallel.mesh import mesh_shape
    from gypsum_tpu_torch.runtime.receiver import Receiver

    iq = np.load(directory / "scene.npy")
    cfg = ReceiverConfig()
    cfg = cfg.replace(tracking=dataclasses.replace(cfg.tracking, matmul_tracker_bf16=False))
    recv = Receiver(ArraySampleSource(iq, FS), cfg, device="cpu", mesh=mesh)
    recv.run()
    return {
        "reports": recv.block_reports,
        "clock_slide": recv.world.receiver_clock_slide,
        "mesh": mesh_shape(recv.bank.mesh),
        "local_channels": recv.bank._fn.local_channels,
    }


def main(argv: list[str]) -> int:
    task, rank, world, directory, threads, timeout_s = argv
    rank, world, directory = int(rank), int(world), Path(directory)
    sys.path.insert(0, str(ROOT))

    import numpy as np
    import torch
    import torch.distributed as dist

    from gypsum_tpu_torch.parallel.mesh import make_receiver_mesh

    torch.set_num_threads(int(threads))
    store = dist.FileStore(str(directory / "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=float(timeout_s)))
    try:
        if task == "parallel":
            mesh = make_receiver_mesh("cpu", 2, 2)
            inp = dict(np.load(directory / "inputs.npz"))
            result = _task_parallel(mesh, inp)
        elif task == "receiver":
            mesh = make_receiver_mesh("cpu", 2, 1)
            result = _task_receiver(mesh, directory)
        elif task == "fail":
            from gypsum_tpu_torch.parallel.sharded import sharded_acquisition_sweep

            mesh = make_receiver_mesh("cpu", world, 1)
            if rank == 1:
                raise RuntimeError("rank 1 fails before its first collective")
            x = torch.zeros(1, L, 2)
            sharded_acquisition_sweep(mesh, x, torch.zeros(1), torch.zeros(world, L, 2), FS)
            result = {}
        else:
            raise ValueError(f"unknown task {task!r}")
        (directory / f"rank{rank}.pkl").write_bytes(pickle.dumps(result))
        print(f"rank {rank}: OK", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

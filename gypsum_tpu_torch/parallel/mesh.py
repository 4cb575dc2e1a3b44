"""Device mesh for the receiver's parallel axes, on torch.distributed.

Torch port of gypsum_tpu/parallel/mesh.py. The workload's parallel
structure maps to two named mesh axes:

- ``sat``  — satellites / tracking channels / PRN search rows: each rank
             takes a contiguous block of rows; the only collectives are the
             peak reduce and the gather of each block's outputs.
- ``time`` — signal-time blocks for streaming correlation sweeps: each rank
             takes a contiguous run of 1 ms chunks and needs one code period
             of its right neighbour's samples (the overlap-save halo).

JAX runs one controller over every device of a ``jax.sharding.Mesh``. The
port is SPMD: one process per rank, each running the receiver's host logic
on identical data and computing its shard on its own device, with
collectives where JAX has ``pmax`` and ``ppermute``. Only ``all_reduce``,
``all_gather`` and ``broadcast`` are used: NCCL and gloo both take them on
CUDA tensors. A collective that a backend refuses raises; nothing is copied
to the host in its place.

The caller initializes the default process group (its backend, store,
timeout, rank and world size) and, for CUDA, sets the rank's device before
building the mesh.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch
import torch.distributed as dist


def factor_devices(n: int) -> tuple[int, int]:
    """Split n devices into (sat, time) axis sizes: prefer the largest
    time axis <= sat axis so both parallel styles are exercised."""
    best = (n, 1)
    for t in range(1, int(np.sqrt(n)) + 1):
        if n % t == 0:
            best = (n // t, t)
    return best


def make_receiver_mesh(device_type: str = "cuda", sat: int | None = None,
                       time: int | None = None):
    """A 2-D ('sat', 'time') ``DeviceMesh`` over the default process
    group's world. Raises when no process group is initialized (a one-rank
    mesh made in its place would hide a launch that never joined) and
    ``ValueError`` when ``sat * time`` is not the world size."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_receiver_mesh needs an initialized default process group "
            "(torch.distributed.init_process_group)"
        )
    n = dist.get_world_size()
    if sat is None or time is None:
        sat, time = factor_devices(n)
    if sat * time != n:
        raise ValueError(f"mesh {sat}x{time} != {n} devices")
    return init_device_mesh(device_type, (sat, time), mesh_dim_names=("sat", "time"))


def mesh_shape(mesh) -> dict[str, int]:
    """{'sat': n, 'time': m}, as ``jax.sharding.Mesh.shape`` reads."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def all_gather_cat(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every group rank's ``t``, concatenated along ``dim`` in group-rank
    order."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def replicate_over_time(mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` as the rank at 'time' coordinate 0 of this rank's 'sat' row
    holds it. JAX's shard_map body is replicated over 'time' and keeps one
    copy; here each 'time' rank computes its own, so the copies are made
    identical before any host decision reads them."""
    n_time = mesh_shape(mesh)["time"]
    if n_time == 1:
        return t
    sat = mesh.get_local_rank("sat")
    src = int(mesh.mesh[sat, 0])
    t = t.contiguous()
    dist.broadcast(t, src=src, group=mesh.get_group("time"))
    return t


def broadcast_from_rank0(compute, device: torch.device):
    """``compute()`` run on global rank 0 only, its (picklable) result sent
    to every rank through two broadcasts of tensors on ``device``: a
    decision every rank must take alike rests on the same bytes."""
    if dist.get_rank() == 0:
        payload = torch.frombuffer(bytearray(pickle.dumps(compute())), dtype=torch.uint8)
        payload = payload.to(device)
        size = torch.tensor([payload.numel()], dtype=torch.int64, device=device)
    else:
        size = torch.zeros(1, dtype=torch.int64, device=device)
    dist.broadcast(size, src=0)
    if dist.get_rank() != 0:
        payload = torch.empty(int(size.item()), dtype=torch.uint8, device=device)
    dist.broadcast(payload, src=0)
    return pickle.loads(payload.cpu().numpy().tobytes())

"""Time-sharded streaming correlation with an overlap-save halo.

Torch port of gypsum_tpu/parallel/streaming.py. Long-capture sweeps (find
every PRN appearance over minutes of signal) shard *signal time* over the
ranks: each rank takes a contiguous run of 1 ms chunks. A correlation window
anchored in a rank's last chunk extends one code period into the next
rank's samples, so each rank needs its right neighbour's first
``samples_per_prn`` samples before computing (the overlap-save boundary).
JAX sends them with ``ppermute``; here every rank all-gathers every rank's
first L samples (16 KB a rank at L = 2046) and takes its neighbour's, since
gloo's point-to-point ops on CUDA tensors are not to be relied on.

The correlation itself is *linear* (aperiodic) over a 2L window per chunk,
evaluated as a circular correlation of the zero-padded replica: exact for
every lag in [0, L), unlike a per-chunk circular correlation, which wraps
the chunk's edge into itself.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from gypsum_tpu_torch.core.planes import to_complex
from gypsum_tpu_torch.parallel.mesh import all_gather_cat, mesh_shape


def linear_replica_fft_conj(replica: np.ndarray) -> np.ndarray:
    """conj(FFT) of the replica zero-padded to 2L — the constant for
    overlap-save linear correlation."""
    padded = np.concatenate([replica, np.zeros_like(replica)], axis=-1)
    return np.conj(np.fft.fft(padded)).astype(np.complex64)


def _chunk_linear_power(iq_ext: torch.Tensor, pfc2: torch.Tensor, length: int) -> torch.Tensor:
    """|linear correlation| for every chunk of a shard.

    iq_ext: [n_chunks * L + L] complex — the shard plus one code period of
    halo. Returns [n_chunks, L] float32: chunk i, lag s ->
    |sum_l iq[i*L + s + l] * replica[l]|."""
    windows = iq_ext.unfold(0, 2 * length, length)  # [n_chunks, 2L], a view
    corr = torch.fft.ifft(torch.fft.fft(windows, dim=-1) * pfc2[None, :], dim=-1)
    return corr[:, :length].abs()


def time_sharded_correlation_power(
    mesh,
    iq_planes: torch.Tensor,  # [n_chunks_total * L, 2] float32 I/Q planes (every rank)
    replica: np.ndarray,  # [L] float32
) -> torch.Tensor:
    """[n_chunks_total, L] linear-correlation power on every rank, signal
    time sharded over all ranks (the flattened ('sat', 'time') axis, as
    JAX's shard_map splits it). Rank r takes the r-th contiguous run of
    chunks; its halo is the first L samples of rank (r + 1) mod n, so the
    last rank's last chunk correlates into the stream's wrap (callers
    ignore it or pad the stream)."""
    length = replica.shape[-1]
    shape = mesh_shape(mesh)
    n_time = shape["time"]
    total = iq_planes.shape[0]
    if total % (length * n_time):
        raise ValueError(
            f"stream of {total} samples must split into whole chunks across "
            f"{n_time} time shards"
        )
    n_shards = shape["sat"] * n_time
    if total % (length * n_shards):
        raise ValueError(
            f"stream of {total} samples must split into whole chunks across "
            f"{n_shards} ranks"
        )
    ranks = [int(r) for r in mesh.mesh.flatten()]  # flattened index -> global rank
    me = ranks.index(dist.get_rank())
    per = total // n_shards
    local = iq_planes[me * per:(me + 1) * per]
    # Every rank's head, in flattened-mesh order; the halo is the right
    # neighbour's.
    heads = all_gather_cat(local[:length][None], None, dim=0)  # [n_ranks (global order), L, 2]
    halo = heads[ranks[(me + 1) % n_shards]]
    ext = to_complex(torch.cat([local, halo]))
    pfc2 = torch.from_numpy(linear_replica_fft_conj(replica)).to(iq_planes.device)
    power = _chunk_linear_power(ext, pfc2, length)  # [per / L, L]
    whole = all_gather_cat(power[None], None, dim=0)  # [n_ranks (global order), per / L, L]
    return whole[torch.tensor(ranks, device=whole.device)].reshape(-1, length)

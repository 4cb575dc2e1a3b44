"""Sharded acquisition and tracking over a ('sat', 'time') device mesh.

Torch port of gypsum_tpu/parallel/sharded.py, SPMD (parallel/mesh.py): each
rank holds every input, computes the block of rows at its 'sat' coordinate
on its own device, and the collectives make the results whole on every
rank.

Acquisition: the [sat x Doppler x code-phase] grid is partitioned over
'sat'; each rank sweeps its PRN rows against the replicated sample block,
and the strongest satellite comes from an all-reduce argmax (an all-reduce
MAX of the strength, then of the masked row index), as JAX's pmax.

Tracking: channels are sharded over 'sat'; the loop carry is per channel,
so each rank runs the whole single-device tracker (phase 1 and kernel K1)
on its slice, and one all-gather per block makes the new state and the
outputs whole, the contract ``TrackerBank`` uses unchanged.
"""

from __future__ import annotations

import torch

from gypsum_tpu_torch.core.planes import to_complex
from gypsum_tpu_torch.ops.correlate import noncoherent_acquisition_sweep, peak_strength
from gypsum_tpu_torch.parallel.mesh import all_gather_cat, mesh_shape, replicate_over_time


def _sat_block(mesh, n_rows: int, what: str) -> slice:
    """The rows at this rank's 'sat' coordinate; ValueError when the 'sat'
    axis does not divide them."""
    n_sat = mesh_shape(mesh)["sat"]
    if n_rows % n_sat:
        raise ValueError(f"{n_rows} {what} not divisible by sat axis {n_sat}")
    per = n_rows // n_sat
    c = mesh.get_local_rank("sat")
    return slice(c * per, (c + 1) * per)


def _gather_rows(mesh, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's block of a sharded axis, gathered over 'sat' (and made
    identical over 'time')."""
    return replicate_over_time(mesh, all_gather_cat(t, mesh.get_group("sat"), dim))


def sharded_acquisition_sweep(
    mesh,
    samples_planes: torch.Tensor,  # [M, L, 2] float32 I/Q planes (replicated)
    dopplers: torch.Tensor,  # [D] float32 (replicated)
    prn_fft_planes: torch.Tensor,  # [S, L, 2] float32 planes (every rank holds all)
    sample_rate: float,
):
    """Per-satellite peak results with the PRN axis sharded over 'sat'.

    Returns (strength [S], doppler_idx [S], code_phase [S], best_row,
    best_strength) on every rank. The best row follows JAX's tie rule: the
    lowest row within a shard wins, and across shards that tie the highest
    row wins."""
    rows = _sat_block(mesh, prn_fft_planes.shape[0], "PRN rows")
    pfc_local = to_complex(prn_fft_planes[rows])
    noncoh = noncoherent_acquisition_sweep(
        to_complex(samples_planes), dopplers, pfc_local, sample_rate
    )
    s_local, _, length = noncoh.shape
    flat = torch.argmax(noncoh.reshape(s_local, -1), dim=-1)
    d_idx = (flat // length).to(torch.int32)
    code_phase = (flat % length).to(torch.int32)
    profiles = noncoh[torch.arange(s_local, device=noncoh.device), d_idx.long()]
    strength = peak_strength(profiles)

    # The all-reduce argmax: MAX of the strength over 'sat', then MAX of the
    # row index of the shards that hold it (0 elsewhere); both over 'time'
    # too, as JAX replicates them.
    local_best = torch.argmax(strength)
    local_max = strength[local_best].clone()
    global_max = local_max.clone()
    for axis in ("sat", "time"):
        torch.distributed.all_reduce(global_max, torch.distributed.ReduceOp.MAX,
                                     group=mesh.get_group(axis))
    shard_row = rows.start + local_best.to(torch.int32)
    global_row = torch.where(local_max == global_max, shard_row, torch.zeros_like(shard_row))
    for axis in ("sat", "time"):
        torch.distributed.all_reduce(global_row, torch.distributed.ReduceOp.MAX,
                                     group=mesh.get_group(axis))
    return (
        _gather_rows(mesh, strength),
        _gather_rows(mesh, d_idx),
        _gather_rows(mesh, code_phase),
        global_row,
        global_max,
    )


def shard_tracking_inputs(mesh, state, samples_block, replicas_wide):
    """This rank's slice of a channel-sharded block step: the channel-major
    state leaves and replica rows at its 'sat' coordinate, the sample block
    whole (replicated)."""
    from gypsum_tpu_torch.track.loop import TrackState

    rows = _sat_block(mesh, replicas_wide.shape[0], "channels")
    return TrackState(*(a[rows] for a in state)), samples_block, replicas_wide[rows]


def make_sharded_track_block_fn(
    mesh, config, samples_per_prn, sample_rate, n_channels,
    input_offset: float = 0.0, device: str | torch.device = "cuda",
):
    """Channel-sharded tracking on the fast path.

    Each rank builds the single-device block tracker
    (track/loop.py:make_track_block_fn: phase 1 with ``torch.mm``, then K1
    on the card) for its ``n_channels / n_sat`` channels, runs it on its
    slice, and one all-gather over 'sat' makes the new state and the packed
    outputs whole.

    Returns ``f(state [S], samples_block [B, L(, 2)] replicated,
    replicas_wide [S, W]) -> (state' [S], TrackBlockOutputs [B, S])`` on
    every rank, with ``f.packed`` (outputs as one [B, N_OUT, S] tensor) for
    ``TrackerBank``.
    """
    from gypsum_tpu_torch.ops import fixup as fx
    from gypsum_tpu_torch.track.loop import (
        block_fn_from_packed,
        carry_rows,
        make_track_block_fn,
        state_from_carry,
    )

    _sat_block(mesh, n_channels, "channels")
    n_sat = mesh_shape(mesh)["sat"]
    local_fn = make_track_block_fn(
        config, samples_per_prn, sample_rate, n_channels // n_sat,
        input_offset=input_offset, device=device,
    )

    def packed(state, samples_block: torch.Tensor, replicas_wide: torch.Tensor):
        state, samples_block, replicas = shard_tracking_inputs(
            mesh, state, samples_block, replicas_wide)
        new_state, outs = local_fn.packed(state, samples_block, replicas)
        b_count, _, s_local = outs.shape
        # One collective a block: the outputs [B * N_OUT, S_local] and the
        # carry as float32 rows (what the kernels carry; the step count is
        # exact to 2^24 ms), with the FDMA offset last.
        rows = torch.cat([
            outs.reshape(b_count * fx.N_OUT, s_local),
            torch.stack([*carry_rows(new_state), new_state.carrier_offset.to(torch.float32)]),
        ])
        whole = _gather_rows(mesh, rows, dim=1)
        n = b_count * fx.N_OUT
        carry = whole[n:]
        return state_from_carry(carry, carry[8]), whole[:n].reshape(b_count, fx.N_OUT, -1)

    fn = block_fn_from_packed(packed)
    fn.local_channels = n_channels // n_sat
    return fn

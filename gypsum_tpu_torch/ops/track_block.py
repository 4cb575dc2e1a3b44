"""K3: the whole-block tracker, the entire 1 kHz loop of a block in one
launch.

Replaces gypsum_tpu/ops/pallas_track.py:make_pallas_track_block_fn. Contract:

    track_block(state_rows [9, S], samples_block [B, L, 2], replicas_wide
    [S, >= 2L + 2K], params) -> (final [9, S], outs [B, 11, S])

all float32. ``state_rows`` are the loop carry (rows CP .. LOST of
``ops/fixup.py``) and a ninth row, the lag-window center, which the function
fills. ``outs`` holds the 11 per-ms observables in the fixup kernel's
layout (``ops/fixup.py``'s ``O_*`` rows); the TPU kernel pads them to 16
rows for its sublanes.

The prologue is part of the function: the window of L + 2 K_eff replica
samples per channel is centered on the predicted MID-block code phase (the
carrier-aided drift over half of this block's milliseconds), which halves the
margin the drift consumes: ``block_margin`` is half the worst-case drift + 8.
On CUDA tensors the loop then runs in the hand-written kernel
(``csrc/track_block.cu``), on CPU tensors in ``track_block_reference``, the
plain PyTorch version, which repeats the kernel's arithmetic in its order.

The kernel's limits are the TPU kernel's and stay limits: triangle
measurement only, the GPS L1 aiding carrier whatever
``TrackingConfig.aiding_carrier_hz`` says, no FDMA carrier offset, one shared
stream. Its chain differs from the scan tracker's step in two roundings that
the plain version copies: the wipeoff phase is ((2 pi / fs) f) l + theta and
the NCO advance (2 pi f) t_ms with no offset term.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from gypsum_tpu_torch.core.config import TrackingConfig
from gypsum_tpu_torch.core.constants import GPS_L1_FREQUENCY_HZ
from gypsum_tpu_torch.ops import fixup as fx
from gypsum_tpu_torch.ops.correlate import ascending_lag_rows, lag_window
from gypsum_tpu_torch.ops.kernels import CudaKernel, check_cuda_tensor

N_CARRY = 9  # the loop carry's eight rows + the lag-window center (fx.CPI0)

TRACK_BLOCK_KERNEL = CudaKernel(
    "track_block",
    "track_block_f32",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
    + [ctypes.c_float, ctypes.POINTER(fx._FixupParams), ctypes.c_void_p],
)


def block_margin(cfg: TrackingConfig, length: int) -> int:
    """Lag-window headroom for one block. Honors an explicit
    cfg.lag_window_block_margin; otherwise half the worst-case Doppler-aided
    drift over the block (the window is centered on the *predicted* mid-block
    code phase, so only half the drift plus DLL slack must fit) + 8 samples."""
    if cfg.lag_window_block_margin is not None:
        return cfg.lag_window_block_margin
    drift = 7000.0 / GPS_L1_FREQUENCY_HZ * length * cfg.block_size_ms
    return int(np.ceil(drift / 2.0)) + 8


@dataclass(frozen=True)
class TrackBlockParams:
    """Constants of the block tracker, derived from a TrackingConfig."""

    loop: fx.FixupParams
    k_eff: int  # K + block margin: the window holds 2 k_eff + 1 lags
    inv_fs: float

    @classmethod
    def from_config(cls, cfg: TrackingConfig, samples_per_prn: int, sample_rate: float):
        if cfg.code_phase_measurement != "triangle":
            raise ValueError(
                "the block tracker only implements the 'triangle' code-phase "
                f"measurement, got {cfg.code_phase_measurement!r}"
            )
        length = int(samples_per_prn)
        loop = dataclasses.replace(
            fx.FixupParams.from_config(cfg, length, sample_rate),
            aiding_scale=(length / GPS_L1_FREQUENCY_HZ) if cfg.carrier_aiding else 0.0,
        )
        return cls(loop=loop, k_eff=loop.k_half + block_margin(cfg, length),
                   inv_fs=1.0 / float(sample_rate))


def _check(state_rows, samples_block, replicas_wide, p: TrackBlockParams) -> None:
    length = p.loop.length
    if state_rows.dim() != 2 or state_rows.shape[0] != N_CARRY:
        raise ValueError(f"state_rows must be [{N_CARRY}, S], got {tuple(state_rows.shape)}")
    if samples_block.dim() != 3 or samples_block.shape[1:] != (length, 2):
        raise ValueError(f"samples_block must be [B, {length}, 2], got {tuple(samples_block.shape)}")
    need = 2 * length + 2 * p.loop.k_half
    if replicas_wide.shape[0] != state_rows.shape[1] or replicas_wide.shape[1] < need:
        raise ValueError(
            f"replicas_wide must be [{state_rows.shape[1]}, >= {need}], got {tuple(replicas_wide.shape)}"
        )


def block_prologue(
    state_rows: torch.Tensor, n_ms: int, replicas_wide: torch.Tensor, p: TrackBlockParams
) -> tuple[torch.Tensor, torch.Tensor]:
    """The initial carry with its lag-window center filled in, and the
    block-static windows [S, L + 2 K_eff]: slice k of a window is the replica
    rolled by (cp0 + K_eff - k)."""
    length, k_eff = p.loop.length, p.k_eff
    predicted_mid_drift = -p.loop.aiding_scale * state_rows[fx.FD] * (n_ms / 2.0)
    cpi0 = torch.remainder(
        torch.floor(state_rows[fx.CP] + predicted_mid_drift).to(torch.int64), length)
    windows = lag_window(replicas_wide, cpi0, length, k_eff).contiguous()
    init = state_rows.clone()
    init[fx.CPI0] = cpi0.to(torch.float32)
    return init, windows


def track_block_reference(
    state_rows: torch.Tensor, samples_block: torch.Tensor, replicas_wide: torch.Tensor,
    p: TrackBlockParams,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the prologue, then a loop over the block's milliseconds
    with the kernel's arithmetic."""
    _check(state_rows, samples_block, replicas_wide, p)
    loop = p.loop
    length = loop.length
    b_count, s_count = samples_block.shape[0], state_rows.shape[1]
    dev = state_rows.device
    init, windows = block_prologue(state_rows, b_count, replicas_wide, p)
    cpi0 = init[fx.CPI0].to(torch.int64)
    rows = ascending_lag_rows(windows, length)  # [S, NLE, L]
    l_idx = torch.arange(length, device=dev, dtype=torch.float32)
    two_pi = 2.0 * math.pi

    carry = fx.LoopCarry.from_rows(init)
    outs = torch.empty((b_count, fx.N_OUT, s_count), dtype=torch.float32, device=dev)
    for b in range(b_count):
        rate = (two_pi * p.inv_fs) * carry.fd
        phase = carry.th[:, None] + rate[:, None] * l_idx[None, :]  # [S, L]
        c, s = torch.cos(phase), torch.sin(phase)
        ci, cq = samples_block[b, :, 0][None, :], samples_block[b, :, 1][None, :]
        xr = ci * c + cq * s
        xi = cq * c - ci * s
        all_r = torch.einsum("skl,sl->sk", rows, xr)
        all_i = torch.einsum("skl,sl->sk", rows, xi)
        cp_int, sel_r, sel_i = fx.select_lags(all_r, all_i, carry.cp, cpi0, length, loop.k_half)
        advance = two_pi * carry.fd * loop.t_ms
        carry, outs[b] = fx.loop_filter_step(carry, sel_r, sel_i, cp_int, advance, loop)
    return torch.stack([*carry.rows(), init[fx.CPI0]]), outs


def track_block_cuda(
    state_rows: torch.Tensor, samples_block: torch.Tensor, replicas_wide: torch.Tensor,
    p: TrackBlockParams,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The prologue in PyTorch, then the kernel, on contiguous float32 CUDA
    tensors."""
    _check(state_rows, samples_block, replicas_wide, p)
    b_count, s_count = samples_block.shape[0], state_rows.shape[1]
    length = p.loop.length
    check_cuda_tensor(state_rows, "state_rows", torch.float32, (N_CARRY, s_count))
    check_cuda_tensor(samples_block, "samples_block", torch.float32, (b_count, length, 2))
    check_cuda_tensor(replicas_wide, "replicas_wide", torch.float32, tuple(replicas_wide.shape))
    if samples_block.data_ptr() % 8:
        raise ValueError("samples_block must be 8-byte aligned (I/Q pairs are loaded as one word)")
    init, windows = block_prologue(state_rows, b_count, replicas_wide, p)
    nle = 2 * p.k_eff + 1
    outs = torch.empty((b_count, fx.N_OUT, s_count), dtype=torch.float32, device=state_rows.device)
    fin = torch.empty((N_CARRY, s_count), dtype=torch.float32, device=state_rows.device)
    cp = fx.c_params(p.loop)
    TRACK_BLOCK_KERNEL.launch(
        ctypes.c_void_p(init.data_ptr()), ctypes.c_void_p(samples_block.data_ptr()),
        ctypes.c_void_p(windows.data_ptr()), ctypes.c_void_p(outs.data_ptr()),
        ctypes.c_void_p(fin.data_ptr()), b_count, s_count, nle,
        2.0 * math.pi * p.inv_fs, ctypes.byref(cp),
    )
    return fin, outs


def track_block(
    state_rows: torch.Tensor, samples_block: torch.Tensor, replicas_wide: torch.Tensor,
    p: TrackBlockParams,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The block tracker: the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if samples_block.device.type == "cpu":
        return track_block_reference(state_rows, samples_block, replicas_wide, p)
    return track_block_cuda(
        state_rows.contiguous(), samples_block.contiguous(), replicas_wide.contiguous(), p)

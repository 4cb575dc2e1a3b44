"""K4: one millisecond of carrier wipeoff fused with the lag-window
correlation, for every channel (the scan tracker's per-ms correlator).

Replaces gypsum_tpu/ops/pallas_kernels.py:wipeoff_lag_correlate_pallas. On
CUDA tensors ``wipeoff_lag_correlate`` launches the hand-written kernel
(``csrc/wipeoff_lag.cu``); on CPU tensors it runs
``wipeoff_lag_reference``, the plain PyTorch version: the wipeoff, window
gather and einsum of the scan step's plain correlator (track/scan.py).

Contract (the TPU kernel's): ``chunk_iq`` [2, L] float32 I/Q planes of one
millisecond shared by all channels, ``replicas_wide`` [S, W >= 2L + 2K]
tiled replicas, ``params`` [S, 3] float32 rows (carrier phase, wipeoff
frequency in Hz, window base as a float) -> [S, 2, n_lags] float32: planes
(I, Q) of the correlation at lags prompt-K .. prompt+K in ascending order,
with window base = (L - cp_int - K) mod L.
"""

from __future__ import annotations

import ctypes
import math

import torch

from gypsum_tpu_torch.ops.correlate import ascending_lag_rows
from gypsum_tpu_torch.ops.kernels import CudaKernel, check_cuda_tensor

_MAX_LAGS = 33  # csrc/wipeoff_lag.cu:kMaxLags

WIPEOFF_LAG_KERNEL = CudaKernel(
    "wipeoff_lag",
    "wipeoff_lag_f32",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p],
)


def _check(chunk_iq, replicas_wide, params, length: int, n_lags: int) -> None:
    if chunk_iq.shape != (2, length):
        raise ValueError(f"chunk_iq must be [2, {length}], got {tuple(chunk_iq.shape)}")
    if replicas_wide.dim() != 2 or params.shape != (replicas_wide.shape[0], 3):
        raise ValueError(
            f"replicas_wide must be [S, W] and params [S, 3], got "
            f"{tuple(replicas_wide.shape)} and {tuple(params.shape)}"
        )
    if n_lags < 1 or n_lags % 2 == 0:
        raise ValueError(f"n_lags ({n_lags}) must be odd and >= 1")
    if replicas_wide.shape[1] < 2 * length + n_lags - 1:
        raise ValueError(
            f"replicas_wide rows must hold 2L + 2K = {2 * length + n_lags - 1} samples, "
            f"got {replicas_wide.shape[1]}"
        )


def wipeoff_lag_reference(
    chunk_iq: torch.Tensor, replicas_wide: torch.Tensor, params: torch.Tensor,
    length: int, n_lags: int, inv_fs: float,
) -> torch.Tensor:
    """Plain version: [S, 2, n_lags] float32."""
    _check(chunk_iq, replicas_wide, params, length, n_lags)
    dev = chunk_iq.device
    theta, freq = params[:, 0], params[:, 1]
    base = params[:, 2].to(torch.int64)
    l_idx = torch.arange(length, device=dev, dtype=torch.float32)
    # The kernel's phase arithmetic: ((2 pi / fs as float32) * f) * l + theta.
    rate = (2.0 * math.pi * inv_fs) * freq
    phase = theta[:, None] + rate[:, None] * l_idx[None, :]  # [S, L]
    c, s = torch.cos(phase), torch.sin(phase)
    ci, cq = chunk_iq[0][None, :], chunk_iq[1][None, :]
    a = ci * c + cq * s
    b = cq * c - ci * s
    span = torch.arange(length + n_lags - 1, device=dev)
    win = torch.gather(replicas_wide, 1, base[:, None] + span[None, :])  # [S, L + 2K]
    # Slice k starts at base + k (descending lag); flip to ascending.
    rows = ascending_lag_rows(win, length)  # [S, n_lags, L]
    return torch.stack(
        [torch.einsum("skl,sl->sk", rows, a), torch.einsum("skl,sl->sk", rows, b)], dim=1
    )


def wipeoff_lag_cuda(
    chunk_iq: torch.Tensor, replicas_wide: torch.Tensor, params: torch.Tensor,
    length: int, n_lags: int, inv_fs: float,
) -> torch.Tensor:
    """The kernel on contiguous float32 CUDA tensors."""
    _check(chunk_iq, replicas_wide, params, length, n_lags)
    s_count, w_len = replicas_wide.shape
    check_cuda_tensor(chunk_iq, "chunk_iq", torch.float32, (2, length))
    check_cuda_tensor(replicas_wide, "replicas_wide", torch.float32, (s_count, w_len))
    check_cuda_tensor(params, "params", torch.float32, (s_count, 3))
    if n_lags > _MAX_LAGS:
        raise ValueError(f"the kernel holds at most {_MAX_LAGS} lags in registers, got {n_lags}")
    out = torch.empty((s_count, 2, n_lags), dtype=torch.float32, device=chunk_iq.device)
    WIPEOFF_LAG_KERNEL.launch(
        ctypes.c_void_p(chunk_iq.data_ptr()), ctypes.c_void_p(replicas_wide.data_ptr()),
        ctypes.c_void_p(params.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        s_count, length, w_len, n_lags, 2.0 * math.pi * inv_fs,
    )
    return out


def wipeoff_lag_correlate(
    chunk_iq: torch.Tensor, replicas_wide: torch.Tensor, params: torch.Tensor,
    length: int, n_lags: int, inv_fs: float,
) -> torch.Tensor:
    """Fused per-ms tracking correlations for all channels: the kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if chunk_iq.device.type == "cpu":
        return wipeoff_lag_reference(chunk_iq, replicas_wide, params, length, n_lags, inv_fs)
    return wipeoff_lag_cuda(
        chunk_iq.contiguous(), replicas_wide.contiguous(), params.contiguous(),
        length, n_lags, inv_fs,
    )

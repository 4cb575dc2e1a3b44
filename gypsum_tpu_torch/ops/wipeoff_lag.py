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

The kernel spreads each channel over ``n_split`` thread blocks
(``lag_split``), block r taking the samples of ``lag_segments(L, n_split)[r]``,
and adds the blocks' partial sums in block order: two runs on the same inputs
give the same bits. ``wipeoff_lag_segmented`` is the plain version summed the
same way.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from gypsum_tpu_torch.ops.correlate import ascending_lag_rows
from gypsum_tpu_torch.ops.kernels import CudaKernel, check_cuda_tensor

_MAX_LAGS = 33  # csrc/wipeoff_lag.cu:kMaxLags
_MAX_SPLIT = 8  # csrc/wipeoff_lag.cu:kMaxSplit, the portable cluster size

WIPEOFF_LAG_KERNEL = CudaKernel(
    "wipeoff_lag",
    "wipeoff_lag_f32",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p],
)


def lag_split(s_count: int, sm_count: int) -> int:
    """Blocks per channel: the largest power of two, at most ``_MAX_SPLIT``,
    that keeps ``s_count`` channels within one wave of ``sm_count`` SMs (8
    for 12 channels on 132 SMs); 1 when the channels alone fill the card."""
    n_split = 1
    while 2 * n_split <= _MAX_SPLIT and 2 * n_split * s_count <= sm_count:
        n_split *= 2
    return n_split


def segment_length(length: int, n_split: int) -> int:
    """Samples per block: ``length / n_split`` rounded up to whole warps."""
    return 32 * -(-length // (32 * n_split))


def lag_segments(length: int, n_split: int) -> list[tuple[int, int]]:
    """``[start, stop)`` of each of the ``n_split`` blocks' samples: equal
    segments of ``segment_length`` cut at ``length``, so they cover
    ``[0, length)`` exactly once for any length (odd, prime, shorter than
    ``n_split``: trailing segments are then empty). The kernel is handed
    ``segment_length`` and applies the same cut."""
    seg = segment_length(length, n_split)
    return [(min(r * seg, length), min((r + 1) * seg, length)) for r in range(n_split)]


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


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


def _wiped_and_rows(chunk_iq, replicas_wide, params, length: int, n_lags: int, inv_fs: float):
    """The plain version's terms: the wiped chunk's planes a, b [S, L] and
    the lag rows [S, n_lags, L] in ascending lag order."""
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
    return a, b, ascending_lag_rows(win, length)


def _lag_dots(rows: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack(
        [torch.einsum("skl,sl->sk", rows, a), torch.einsum("skl,sl->sk", rows, b)], dim=1
    )


def wipeoff_lag_reference(
    chunk_iq: torch.Tensor, replicas_wide: torch.Tensor, params: torch.Tensor,
    length: int, n_lags: int, inv_fs: float,
) -> torch.Tensor:
    """Plain version: [S, 2, n_lags] float32."""
    a, b, rows = _wiped_and_rows(chunk_iq, replicas_wide, params, length, n_lags, inv_fs)
    return _lag_dots(rows, a, b)


def wipeoff_lag_segmented(
    chunk_iq: torch.Tensor, replicas_wide: torch.Tensor, params: torch.Tensor,
    length: int, n_lags: int, inv_fs: float, n_split: int,
) -> torch.Tensor:
    """The plain version's terms summed as the kernel sums them: one partial
    result per segment of ``lag_segments(length, n_split)``, added in
    segment order."""
    a, b, rows = _wiped_and_rows(chunk_iq, replicas_wide, params, length, n_lags, inv_fs)
    out = torch.zeros((params.shape[0], 2, n_lags), dtype=torch.float32, device=chunk_iq.device)
    for start, stop in lag_segments(length, n_split):
        out = out + _lag_dots(rows[:, :, start:stop], a[:, start:stop], b[:, start:stop])
    return out


def _check_cuda(chunk_iq, replicas_wide, params, length: int, n_lags: int) -> None:
    """Everything the kernel needs of its arguments, in one pass; on a miss
    the single checks run again and raise their own errors."""
    s_count = replicas_wide.shape[0] if replicas_wide.dim() == 2 else -1
    if (
        chunk_iq.is_cuda and replicas_wide.is_cuda and params.is_cuda
        and chunk_iq.dtype == replicas_wide.dtype == params.dtype == torch.float32
        and chunk_iq.shape == (2, length) and params.shape == (s_count, 3)
        and 1 <= n_lags <= _MAX_LAGS and n_lags % 2 == 1
        and replicas_wide.shape[1] >= 2 * length + n_lags - 1
        and chunk_iq.is_contiguous() and replicas_wide.is_contiguous() and params.is_contiguous()
    ):
        return
    _check(chunk_iq, replicas_wide, params, length, n_lags)
    check_cuda_tensor(chunk_iq, "chunk_iq", torch.float32, (2, length))
    check_cuda_tensor(replicas_wide, "replicas_wide", torch.float32, tuple(replicas_wide.shape))
    check_cuda_tensor(params, "params", torch.float32, (s_count, 3))
    raise ValueError(f"the kernel takes at most {_MAX_LAGS} lags, got {n_lags}")


def wipeoff_lag_cuda(
    chunk_iq: torch.Tensor, replicas_wide: torch.Tensor, params: torch.Tensor,
    length: int, n_lags: int, inv_fs: float, n_split: int | None = None,
) -> torch.Tensor:
    """The kernel on contiguous float32 CUDA tensors, ``n_split`` blocks per
    channel: by default what ``lag_split`` gives for this card."""
    _check_cuda(chunk_iq, replicas_wide, params, length, n_lags)
    s_count, w_len = replicas_wide.shape
    dev = chunk_iq.device
    if n_split is None:
        n_split = lag_split(s_count, _sm_count(dev.index))
    elif not 1 <= n_split <= _MAX_SPLIT:
        raise ValueError(f"n_split must be 1..{_MAX_SPLIT} (one cluster per channel), got {n_split}")
    out = torch.empty((s_count, 2, n_lags), dtype=torch.float32, device=dev)
    WIPEOFF_LAG_KERNEL.launch(
        chunk_iq.data_ptr(), replicas_wide.data_ptr(), params.data_ptr(), out.data_ptr(),
        s_count, length, w_len, n_lags, n_split, segment_length(length, n_split),
        2.0 * math.pi * inv_fs,
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
        chunk_iq if chunk_iq.is_contiguous() else chunk_iq.contiguous(),
        replicas_wide if replicas_wide.is_contiguous() else replicas_wide.contiguous(),
        params if params.is_contiguous() else params.contiguous(),
        length, n_lags, inv_fs,
    )

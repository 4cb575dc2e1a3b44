"""K2: per-row (max, first-index argmax, sum) for the acquisition peak search.

Replaces gypsum_tpu/ops/pallas_kernels.py:peak_reduce_pallas. On a CUDA
tensor ``peak_reduce`` launches the hand-written kernel
(``csrc/peak_reduce.cu``); on a CPU tensor it runs ``peak_reduce_reference``,
the plain PyTorch version of the same function.
"""

from __future__ import annotations

import ctypes

import torch

from gypsum_tpu_torch.ops.kernels import CudaKernel, check_cuda_tensor

PEAK_REDUCE_KERNEL = CudaKernel(
    "peak_reduce",
    "peak_reduce_f32",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
)


def peak_reduce_reference(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: ([rows] max, [rows] int32 argmax with ties to the lowest
    index, [rows] sum) of a [rows, n] float32 tensor."""
    return x.amax(dim=1), torch.argmax(x, dim=1).to(torch.int32), x.sum(dim=1)


def split_results(buf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's one [3, rows] buffer of 4-byte words as (max, int32
    argmax, sum): three views, no copy."""
    return buf[0], buf[1].view(torch.int32), buf[2]


def peak_reduce_cuda(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel on a contiguous [rows, n] float32 CUDA tensor (any 4-byte
    aligned storage offset). The three results are views of one buffer."""
    if x.dim() != 2:
        raise ValueError(f"peak_reduce expects [rows, n], got {tuple(x.shape)}")
    rows, n = x.shape
    check_cuda_tensor(x, "x", torch.float32, (rows, n))
    if n == 0:
        raise ValueError("peak_reduce needs n >= 1")
    buf = torch.empty((3, rows), dtype=torch.float32, device=x.device)
    PEAK_REDUCE_KERNEL.launch(x.data_ptr(), buf.data_ptr(), rows, n)
    return split_results(buf)


def peak_reduce(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(max, argmax, sum) per row: the kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    if x.device.type == "cpu":
        return peak_reduce_reference(x)
    return peak_reduce_cuda(x.contiguous())

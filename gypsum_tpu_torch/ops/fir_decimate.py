"""K5: anti-alias FIR + integer decimation of an I/Q stream.

Replaces gypsum_tpu/ops/pallas_kernels.py:fir_decimate_pallas. On a CUDA
tensor ``fir_decimate`` launches the hand-written kernel
(``csrc/fir_decimate.cu``); on a CPU tensor it runs
``fir_decimate_reference``, the plain PyTorch version (the strided
convolution of ``ops/decimate.py``).

Both compute the 'VALID' correlation with the taps as given,
``y[n] = sum_t taps[t] * x[n * factor + t]`` of length ``(N - T) // factor + 1``,
as the JAX package's streaming front end does (``lax.conv_general_dilated``).
The TPU kernel runs the taps the other way round
(``taps[t] * x[n * factor + T - 1 - t]``); for the symmetric Kaiser-sinc
filters of ``ops/decimate.py`` the two are the same function.
"""

from __future__ import annotations

import ctypes

import torch

from gypsum_tpu_torch.core.planes import to_planes
from gypsum_tpu_torch.ops.decimate import fir_decimate_planes, valid_length
from gypsum_tpu_torch.ops.kernels import CudaKernel, check_cuda_tensor

# One block's tile and taps must fit the shared memory a block may use on
# Hopper (227 KB); csrc/fir_decimate.cu stages 256 outputs per block.
_MAX_SMEM_BYTES = 232448
_OUTPUTS_PER_BLOCK = 256

FIR_DECIMATE_KERNEL = CudaKernel(
    "fir_decimate",
    "fir_decimate_f32",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
     ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
)


def fir_decimate_reference(planes: torch.Tensor, taps: torch.Tensor, factor: int) -> torch.Tensor:
    """Plain version: [N, 2] float32 planes -> [(N - T) // factor + 1, 2]."""
    return fir_decimate_planes(planes, taps, factor)


def fir_decimate_cuda(planes: torch.Tensor, taps: torch.Tensor, factor: int) -> torch.Tensor:
    """The kernel on contiguous float32 CUDA tensors: ``planes`` [N, 2],
    ``taps`` [T]."""
    if planes.dim() != 2 or taps.dim() != 1:
        raise ValueError(
            f"fir_decimate expects planes [N, 2] and taps [T], got "
            f"{tuple(planes.shape)} and {tuple(taps.shape)}"
        )
    n, t_len = planes.shape[0], taps.shape[0]
    check_cuda_tensor(planes, "planes", torch.float32, (n, 2))
    check_cuda_tensor(taps, "taps", torch.float32, (t_len,))
    if factor < 1 or t_len < 1:
        raise ValueError(f"factor ({factor}) and the filter length ({t_len}) must be >= 1")
    n_out = valid_length(n, t_len, 1, factor)
    if n_out <= 0:
        raise ValueError(f"signal ({n}) shorter than filter ({t_len})")
    smem = 4 * ((t_len + 1) & ~1) + 8 * ((_OUTPUTS_PER_BLOCK - 1) * factor + t_len)
    if smem > _MAX_SMEM_BYTES:
        raise ValueError(
            f"filter too long for the kernel's shared-memory tile: {t_len} taps at "
            f"factor {factor} need {smem} bytes of {_MAX_SMEM_BYTES}"
        )
    if planes.data_ptr() % 8:
        raise ValueError("planes must be 8-byte aligned (I/Q pairs are loaded as one word)")
    out = torch.empty((n_out, 2), dtype=torch.float32, device=planes.device)
    FIR_DECIMATE_KERNEL.launch(
        planes.data_ptr(), taps.data_ptr(), out.data_ptr(), n_out, t_len, factor,
    )
    return out


def fir_decimate(x: torch.Tensor, taps: torch.Tensor, factor: int) -> torch.Tensor:
    """Anti-alias filter + decimate by ``factor``: complex [N] or float
    planes [N, 2] in, float planes [n_out, 2] out. The kernel for CUDA
    tensors, the plain version for CPU tensors."""
    planes = to_planes(x) if x.is_complex() else x.to(torch.float32)
    taps = taps.to(device=planes.device, dtype=torch.float32)
    if planes.device.type == "cpu":
        return fir_decimate_reference(planes, taps, factor)
    return fir_decimate_cuda(planes.contiguous(), taps.contiguous(), factor)

"""Phase 1's sample operand: a block's I/Q words as each stream's [cr; ci]
rows, in the precision of the two-phase tracker's product.

The two-phase tracker (track/matmul.py) multiplies, for each stream, the
rows [cr; ci] [2B, L] (the block's real plane above its imaginary plane) by
the wiped lag rows. ``iq_operand`` makes those rows for every stream of the
block at once, as one [N, 2B, L] tensor: stream n's rows are ``out[n]``,
rows 0..B-1 the real plane, B..2B-1 the imaginary one. Every stream's rows
start a multiple of 256 bytes from the base, as a fresh allocation of their
own would, so the product sees the alignment it would see for a
concatenation.

On a CUDA tensor ``iq_operand`` launches the hand-written kernel
(``csrc/iq_operand.cu``, one pass from the words to the operand); on a CPU
tensor it runs ``iq_operand_reference``, the plain PyTorch version. It
replaces no TPU kernel: the JAX package leaves these passes to XLA.
"""

from __future__ import annotations

import ctypes

import torch

from gypsum_tpu_torch.core.planes import dequantize_planes
from gypsum_tpu_torch.ops.kernels import CudaKernel, check_cuda_tensor

IQ_OPERAND_KERNEL = CudaKernel(
    "iq_operand",
    "iq_operand",
    [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5
    + [ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p],
)

# The kernel's codes for the word types it reads.
_WORD_CODES = {torch.int8: 0, torch.uint8: 1, torch.int16: 2, torch.float32: 3}
_ALIGN_BYTES = 256


def block_planes(samples_block: torch.Tensor) -> torch.Tensor:
    """The block as [B, N, L, 2] planes (a view where it can be): complex
    samples as their float32 planes, a single stream ([B, L, 2] or [B, L]
    complex) as N = 1."""
    x = samples_block
    if x.is_complex():
        x = torch.view_as_real(x.to(torch.complex64))
    if x.dim() == 3:
        x = x.unsqueeze(1)
    if x.dim() != 4 or x.shape[-1] != 2:
        raise ValueError(f"samples_block must be [B, (N,) L, 2] planes or [B, (N,) L] complex, "
                         f"got {tuple(samples_block.shape)} {samples_block.dtype}")
    return x


def operand_buffer(n_streams: int, b_count: int, length: int, dtype: torch.dtype,
                   device) -> torch.Tensor:
    """An uninitialized [N, 2B, L] operand whose streams' rows start a
    multiple of 256 bytes apart (the stride between streams is padded)."""
    per = _ALIGN_BYTES // dtype.itemsize
    stride = -(-2 * b_count * length // per) * per
    buf = torch.empty(n_streams * stride, dtype=dtype, device=device)
    return buf.as_strided((n_streams, 2 * b_count, length), (stride, length, 1))


def iq_operand_reference(samples_block: torch.Tensor, input_offset: float,
                         dtype: torch.dtype) -> torch.Tensor:
    """Plain version: the [N, 2B, L] operand of ``dtype`` (bf16 or float32)
    from [B, (N,) L, 2] planes of any dtype or [B, (N,) L] complex. Each
    word becomes float32, less ``input_offset`` for integer words
    (``core/planes.py:dequantize_planes``), then ``dtype``."""
    planes = dequantize_planes(block_planes(samples_block), input_offset)
    b_count, n_streams, length, _ = planes.shape
    out = operand_buffer(n_streams, b_count, length, dtype, planes.device)
    out.view(n_streams, 2, b_count, length).copy_(planes.permute(1, 3, 0, 2))
    return out


def iq_operand_cuda(samples_block: torch.Tensor, input_offset: float,
                    dtype: torch.dtype) -> torch.Tensor:
    """The kernel on a contiguous CUDA block (same contract as
    ``iq_operand_reference``): int8, uint8, int16 or float32 planes, or
    complex64."""
    planes = block_planes(samples_block)
    if planes.dtype not in _WORD_CODES:
        raise ValueError(f"iq_operand takes int8, uint8, int16 or float32 planes or complex64, "
                         f"got {samples_block.dtype}")
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the operand is bf16 or float32, not {dtype}")
    check_cuda_tensor(planes, "samples_block", planes.dtype, tuple(planes.shape))
    b_count, n_streams, length, _ = planes.shape
    if b_count * n_streams >= 2**31:
        raise ValueError(f"{b_count} x {n_streams} rows exceed the kernel's grid")
    out = operand_buffer(n_streams, b_count, length, dtype, planes.device)
    # float32 words are not offset (dequantize_planes passes them through).
    offset = 0.0 if planes.dtype == torch.float32 else float(input_offset)
    IQ_OPERAND_KERNEL.launch(
        planes.data_ptr(), out.data_ptr(), _WORD_CODES[planes.dtype],
        int(dtype == torch.bfloat16), n_streams, b_count, length, out.stride(0), offset,
    )
    return out


def iq_operand(samples_block: torch.Tensor, input_offset: float = 0.0,
               bf16: bool = True) -> torch.Tensor:
    """The [N, 2B, L] operand in the product's precision: the kernel for a
    CUDA tensor (bf16, or float32 without ``bf16``), the plain version for
    a CPU tensor. The CPU multiplies in float32, so there the bf16-rounded
    values come back widened to float32, as the tracker's W side does."""
    dtype = torch.bfloat16 if bf16 else torch.float32
    if samples_block.device.type != "cpu":
        return iq_operand_cuda(samples_block.contiguous(), input_offset, dtype)
    out = iq_operand_reference(samples_block, input_offset, dtype)
    if not bf16:
        return out
    n_streams, rows, length = out.shape
    return operand_buffer(n_streams, rows // 2, length, torch.float32, out.device).copy_(out)

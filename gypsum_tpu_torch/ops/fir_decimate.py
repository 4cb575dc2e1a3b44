"""K5: anti-alias FIR + integer decimation of an I/Q stream.

Replaces gypsum_tpu/ops/pallas_kernels.py:fir_decimate_pallas. On a CUDA
tensor ``fir_decimate`` launches the hand-written kernel
(``csrc/fir_decimate.cu``); on a CPU tensor it runs
``fir_decimate_reference``, the plain PyTorch version.

Both compute what the TPU kernel computes: the 'VALID' convolution
``y[n] = sum_t taps[t] * x[n * factor + T - 1 - t]`` of length
``(N - T) // factor + 1``, the taps run reversed. The streaming front end's
strided convolution (``ops/decimate.py:fir_decimate_planes``, as
``lax.conv_general_dilated`` in the JAX package) is a correlation with the
taps as given; ``io/sources.py:DecimatingSampleSource`` keeps that result by
handing this kernel its taps reversed.

``launch_plan`` is the kernel's shared-memory plan in plain Python: the
kernel takes its numbers as they are, so the CPU tests can prove that every
filter the TPU kernel accepts (at most 128 taps per phase) fits.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from gypsum_tpu_torch.core.planes import to_planes
from gypsum_tpu_torch.ops.decimate import fir_decimate_planes, valid_length
from gypsum_tpu_torch.ops.kernels import CudaKernel, check_cuda_tensor

# The kernel's fixed shape (csrc/fir_decimate.cu): 128 threads, 8 outputs each.
THREADS = 128
OUTPUTS_PER_THREAD = 8
OUTPUTS_PER_BLOCK = THREADS * OUTPUTS_PER_THREAD
# Shared memory one block may use on Hopper, and the share the plan aims a
# block's tile at, so that several blocks reside on each SM.
MAX_SMEM_BYTES = 232448
TILE_BYTES = 73728
# The TPU kernel's limit: taps per phase within one 128-lane halo.
MAX_TAPS_PER_PHASE = 128

FIR_DECIMATE_KERNEL = CudaKernel(
    "fir_decimate",
    "fir_decimate_f32",
    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_void_p],
)


@dataclass(frozen=True)
class LaunchPlan:
    """How the kernel lays one block's tile out in shared memory. Each row
    holds ``width`` phases (2: one 16-byte element per branch sample; 1:
    8 bytes): ``OUTPUTS_PER_BLOCK + taps_per_phase - 1``
    elements, element ``m`` at ``swizzle(m, width)``, rows ``pitch`` elements
    apart. ``group`` phases are staged at a time, after their taps (4 bytes
    per phase and tap, rounded up to 16 bytes)."""

    taps_per_phase: int
    width: int
    group: int
    pitch: int
    smem_bytes: int


def swizzle(m: int, width: int) -> int:
    """Where element ``m`` of a row lies (``csrc/fir_decimate.cu:swizzle``)."""
    return m ^ ((m >> (3 if width == 2 else 4)) & 7)


def _pow2_floor(n: int) -> int:
    return 1 << (n.bit_length() - 1)


def launch_plan(t_len: int, factor: int, width: int | None = None) -> LaunchPlan:
    """The kernel's plan for a filter of ``t_len`` taps at ``factor``; raises
    for a filter the TPU kernel refuses (more than 128 taps per phase).
    ``width`` 2 (two phases per 16-byte element) needs an even factor and
    16-byte aligned samples. It is the default for even factors from 8 up;
    at factor 4 rows of one phase ran 3-4 % faster on the H100 (PERF.md)."""
    if factor < 1 or t_len < 1:
        raise ValueError(f"factor ({factor}) and the filter length ({t_len}) must be >= 1")
    taps_per_phase = -(-t_len // factor)
    if taps_per_phase > MAX_TAPS_PER_PHASE:
        raise ValueError(
            f"filter too long: {t_len} taps at factor {factor} are {taps_per_phase} taps per "
            f"phase, more than {MAX_TAPS_PER_PHASE} (the TPU kernel's limit)"
        )
    if width is None:
        width = 2 if factor % 2 == 0 and factor >= 8 else 1
    if width not in (1, 2) or factor % width:
        raise ValueError(f"width {width} does not divide factor {factor}")
    cols = OUTPUTS_PER_BLOCK + taps_per_phase - 1
    lanes = 8 if width == 2 else 16  # elements of one 128-byte wavefront
    per_phase = 8 * -(-cols // lanes) * lanes + 4 * taps_per_phase
    group = min(factor, max(width, TILE_BYTES // per_phase // width * width))
    groups = -(-factor // group)
    group = -(-factor // groups)  # the same number of groups, as even as they go
    group += -group % width
    # Stagger the rows so that the staging stores of a wavefront, which
    # cover group / width rows of one or a few elements, fall on distinct
    # banks where that is a power of two.
    pitch = -(-cols // lanes) * lanes + lanes // _pow2_floor(min(group // width, lanes)) % lanes
    smem = 4 * -(-(group * taps_per_phase) // 4) * 4 + group // width * pitch * 8 * width
    if smem > MAX_SMEM_BYTES:  # cannot happen for taps_per_phase <= 128
        raise ValueError(f"plan needs {smem} bytes of shared memory per block")
    return LaunchPlan(taps_per_phase, width, group, pitch, smem)


def fir_decimate_reference(planes: torch.Tensor, taps: torch.Tensor, factor: int) -> torch.Tensor:
    """Plain version: [N, 2] float32 planes -> [(N - T) // factor + 1, 2], the
    strided convolution with the taps reversed."""
    return fir_decimate_planes(planes, taps.flip(0), factor)


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
    if planes.data_ptr() % 8:
        raise ValueError("planes must be 8-byte aligned (an I/Q pair is copied as one word)")
    # Two phases per 16-byte copy need 16-byte aligned samples.
    plan = launch_plan(t_len, factor, None if planes.data_ptr() % 16 == 0 else 1)
    n_out = valid_length(n, t_len, 1, factor)
    if n_out <= 0:
        raise ValueError(f"signal ({n}) shorter than filter ({t_len})")
    out = torch.empty((n_out, 2), dtype=torch.float32, device=planes.device)
    FIR_DECIMATE_KERNEL.launch(
        planes.data_ptr(), n, taps.data_ptr(), out.data_ptr(), n_out, t_len, factor,
        plan.width, plan.taps_per_phase, plan.group, plan.pitch, plan.smem_bytes,
    )
    return out


def fir_decimate(x: torch.Tensor, taps: torch.Tensor, factor: int) -> torch.Tensor:
    """Anti-alias filter + decimate by ``factor``: complex [N] or float
    planes [N, 2] in, float planes [n_out, 2] out. The kernel for CUDA
    tensors, the plain version for CPU tensors."""
    planes = to_planes(x) if x.is_complex() else x.to(torch.float32)
    taps = taps.to(device=planes.device, dtype=torch.float32)
    if planes.device.type == "cpu":
        launch_plan(taps.shape[0], factor)  # the kernel's limits hold here too
        return fir_decimate_reference(planes, taps, factor)
    return fir_decimate_cuda(planes.contiguous(), taps.contiguous(), factor)

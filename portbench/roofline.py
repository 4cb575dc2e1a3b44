"""Peaks of the card and the least time the tracker's work could take.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, 700 W):
3.35 TB/s of HBM, 67 TFLOP/s float32 outside the tensor cores, 989 TFLOP/s
bf16 on them. A bound counts each input byte read once and each output
byte written once, and the operations the outputs need.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
N_OUT = 11  # output rows a ms and channel
N_CARRY = 12  # carry rows a channel, read and written once a block


def bound_ms(n_bytes: float, n_ops: float = 0.0, n_bf16_ops: float = 0.0) -> float:
    """The larger of the bytes over the memory rate and the operations over
    the peak rate of their type, in ms."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / FP32_OPS_PER_S + n_bf16_ops / BF16_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops)


def k1_bound_ms(b: int, s: int, k_half: int) -> float:
    """K1, the loop-filter fixup: per ms and channel the 2K+1 lags around
    the prompt of the real and imaginary correlations (not the whole lag
    window), the outputs, and the carry in and out; ~110 float operations of
    discriminators, EMAs and NCO updates besides the 2K+1 powers (3 each)
    and the argmax compares (1 each)."""
    lags = 2 * k_half + 1
    n_bytes = 4 * (2 * b * s * lags + b * N_OUT * s + 2 * N_CARRY * s)
    return bound_ms(n_bytes, n_ops=b * s * (4 * lags + 110))


def step_flops(b: int, length: int, s: int, k_half: int) -> float:
    """The tracking step's operations: the complex products its outputs
    need, 2K+1 lags a ms and channel over the ms's samples, 8 real
    operations (4 products, 4 sums) a sample. Not the wider lag window the
    port computes: a later implementation reads the same work."""
    return 8.0 * b * length * s * (2 * k_half + 1)

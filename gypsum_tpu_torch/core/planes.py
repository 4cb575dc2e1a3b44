"""I/Q planes and dequantization.

Sample blocks arrive from the host as complex64 or as float/integer planes
with a trailing I/Q axis of size 2 (``[..., 2]``, the layout integer
captures have on disk). Raw uint8/int8/int16 words cross to the device as
they are and are dequantized there, which moves a quarter of the bytes of
float32 planes.
"""

from __future__ import annotations

import numpy as np
import torch


def to_planes(x):
    """Complex [...] -> float32 [..., 2] (numpy in, numpy out; tensor in,
    tensor out)."""
    if isinstance(x, torch.Tensor):
        return torch.view_as_real(x.to(torch.complex64)).clone()
    x = np.asarray(x)
    return np.stack([x.real, x.imag], axis=-1).astype(np.float32)


def to_complex(planes: torch.Tensor) -> torch.Tensor:
    """Float32 [..., 2] -> complex64 [...]."""
    return torch.complex(planes[..., 0], planes[..., 1])


def dequantize_planes(planes: torch.Tensor, offset: float = 0.0) -> torch.Tensor:
    """[..., 2] planes of any dtype -> float32, minus the ADC bias.

    float32 input passes through untouched."""
    if planes.dtype == torch.float32:
        return planes
    out = planes.to(torch.float32)
    if offset:
        out = out - offset
    return out

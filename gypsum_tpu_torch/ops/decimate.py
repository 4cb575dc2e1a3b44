"""FIR decimation / rational resampling front end.

Torch port of gypsum_tpu/ops/decimate.py. Brings arbitrary SDR rates down to
the processing rate:

- integer-factor decimation (8.184 / 16.368 -> 2.046 Msps) as a strided
  convolution (``torch.nn.functional.conv1d`` with ``stride = factor``);
- rational resampling (e.g. 10 Msps -> 2.046 Msps = x1023/5000) as the
  classic polyphase upfirdn: zero-stuff by ``up``, filter, keep every
  ``down``-th output. The zero-stuffed signal is never built (at x1023 it
  would be a thousand times the input): each output gathers the
  ``ceil(T / up)`` taps of its own polyphase branch.

Both are 'VALID' correlations with the taps as given,
``y[m] = sum_t taps[t] * u[m * down + t]`` over the zero-stuffed ``u``
(what ``lax.conv_general_dilated`` computes in the JAX package), of length
``(N * up - (up - 1) - T) // down + 1``.

Filters are Kaiser-windowed sincs designed host-side at setup. These are
plain PyTorch functions; the hand-written decimation kernel that the
streaming source runs on the card is ``ops/fir_decimate.py``, and
``fir_decimate_planes`` is its plain version.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# Outputs gathered at a time by the rational resampler (bounds the
# [chunk, taps-per-branch] gather buffers).
_RESAMPLE_CHUNK = 1 << 18


def design_lowpass(n_taps: int, cutoff: float, beta: float = 8.6) -> np.ndarray:
    """Kaiser-windowed sinc, cutoff as a fraction of Nyquist (0..1)."""
    if n_taps % 2 == 0:
        n_taps += 1
    m = np.arange(n_taps) - (n_taps - 1) / 2
    h = np.sinc(cutoff * m) * cutoff
    h *= np.kaiser(n_taps, beta)
    return (h / h.sum()).astype(np.float32)


def decimation_filter(factor: int, taps_per_phase: int = 12) -> np.ndarray:
    """Anti-alias filter for integer decimation by ``factor``."""
    return design_lowpass(factor * taps_per_phase + 1, cutoff=0.8 / factor)


def rational_filter(up: int, down: int, taps_per_phase: int = 10) -> np.ndarray:
    """Anti-alias/interpolation filter for up/down resampling. The gain is
    ``up`` so a constant input maps to a constant output."""
    n = max(up, down) * taps_per_phase + 1
    h = design_lowpass(n, cutoff=0.8 / max(up, down) * 1.0)
    return (h * up).astype(np.float32)


def valid_length(n: int, n_taps: int, up: int, down: int) -> int:
    """Output length of the 'VALID' upfirdn of ``n`` samples."""
    return (n * up - (up - 1) - n_taps) // down + 1


def _check(planes: torch.Tensor, taps: torch.Tensor, up: int, down: int) -> int:
    if planes.dim() != 2 or planes.shape[1] != 2:
        raise ValueError(f"planes must be [N, 2], got {tuple(planes.shape)}")
    n_out = valid_length(planes.shape[0], taps.shape[0], up, down)
    if n_out <= 0:
        raise ValueError(f"signal ({planes.shape[0]}) shorter than filter ({taps.shape[0]})")
    return n_out


def fir_decimate_planes(planes: torch.Tensor, taps: torch.Tensor, factor: int) -> torch.Tensor:
    """Filter + keep every ``factor``-th sample ('VALID': the first output
    corresponds to input index T-1). [N, 2] f32 -> [(N-T)//factor + 1, 2].
    The two planes ride the batch axis of one float32 convolution."""
    _check(planes, taps, 1, factor)
    v = planes.to(torch.float32).T[:, None, :]  # [2, 1, N]
    y = F.conv1d(v, taps.to(torch.float32)[None, None, :], stride=factor)[:, 0]  # [2, M]
    return y.T.contiguous()


def resample_rational_planes(
    planes: torch.Tensor, taps: torch.Tensor, up: int, down: int
) -> torch.Tensor:
    """Polyphase rational resampler (upfirdn): zero-stuff by ``up``, filter,
    keep every ``down``-th output. [N, 2] f32 in/out."""
    if up == 1:
        return fir_decimate_planes(planes, taps, down)
    n_out = _check(planes, taps, up, down)
    dev = planes.device
    planes = planes.to(torch.float32)
    n, t_len = planes.shape[0], taps.shape[0]
    # Branch-major taps H[phase, q] = taps[phase + up * q], zero past T.
    q_count = -(-t_len // up)
    h = torch.zeros(q_count * up, dtype=torch.float32, device=dev)
    h[:t_len] = taps.to(torch.float32)
    h = h.reshape(q_count, up).T.contiguous()  # [up, Q]
    q = torch.arange(q_count, device=dev)
    out = torch.empty((n_out, 2), dtype=torch.float32, device=dev)
    for lo in range(0, n_out, _RESAMPLE_CHUNK):
        m = torch.arange(lo, min(lo + _RESAMPLE_CHUNK, n_out), device=dev, dtype=torch.int64)
        start = m * down  # position in the zero-stuffed signal
        phase = torch.remainder(-start, up)  # first tap that meets an input sample
        first = (start + phase) // up
        # Indices past N only meet the zero padding of the branch.
        idx = torch.clamp(first[:, None] + q[None, :], max=n - 1)  # [chunk, Q]
        hq = h[phase]  # [chunk, Q]
        out[lo : lo + m.shape[0], 0] = (planes[:, 0][idx] * hq).sum(dim=1)
        out[lo : lo + m.shape[0], 1] = (planes[:, 1][idx] * hq).sum(dim=1)
    return out

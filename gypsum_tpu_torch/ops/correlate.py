"""Circular-correlation building blocks for acquisition and tracking.

Torch counterpart of the JAX package's ops/correlate.py (the analogue of
reference: gypsum/utils.py:59-108):

- The acquisition sweep evaluates the whole [satellite x Doppler x code
  phase] grid as batched FFTs. The sample FFT of each (Doppler, ms) is shared
  by every satellite and the replica FFTs are precomputed constants.
- The sweep loops over the M milliseconds and accumulates |correlation| in
  place, so peak memory stays at [S, D, L] instead of [S, D, M, L].
- Phases stay exact in float32: the wipeoff phasor is built from per-ms
  phase offsets reduced mod one cycle, never from absolute stream time.
- The circulant-matmul sweep evaluates the same grid as bf16 products
  against [L, L] circulant replica tables (268 MB for 32 PRNs at L = 2046),
  built on the device; on the card the products run on the tensor cores
  with a float32 result.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def replica_fft_conj_table(replica_table: np.ndarray) -> np.ndarray:
    """conj(FFT) of each replica row: the constant multiplied into sample FFTs."""
    return np.conj(np.fft.fft(replica_table, axis=-1)).astype(np.complex64)


def circular_correlate(samples: torch.Tensor, replica_fft_conj: torch.Tensor) -> torch.Tensor:
    """corr[s] = sum_l samples[l] * replica[(l - s) mod L], batched over any
    leading dims (broadcasting). ``replica_fft_conj`` is conj(fft(replica))."""
    return torch.fft.ifft(torch.fft.fft(samples) * replica_fft_conj)


def doppler_wipeoff(
    samples_ms: torch.Tensor,  # [M, L] complex64
    dopplers: torch.Tensor,  # [D] float32 Hz
    sample_rate: float,
) -> torch.Tensor:
    """Multiply each 1 ms chunk by e^{-j 2 pi f (t_ms + l/fs)} for every Doppler.

    Returns [D, M, L]. The phase is continuous across the M chunks, with the
    phase at each chunk start reduced mod one cycle so float32 never sees a
    large absolute phase.
    """
    m_count, length = samples_ms.shape
    dev = samples_ms.device
    # Same float32 operation order as the reference: l / fs, then * f.
    l_over_fs = torch.arange(length, dtype=torch.float32, device=dev) / sample_rate
    intra = dopplers[:, None, None] * l_over_fs[None, None, :]  # [D, 1, L]
    ms_per_chunk = length / sample_rate
    t_chunk = torch.arange(m_count, dtype=torch.float32, device=dev) * ms_per_chunk
    chunk_cycles = dopplers[:, None, None] * t_chunk[None, :, None]  # [D, M, 1]
    chunk_cycles = chunk_cycles - torch.round(chunk_cycles)
    phase = -2.0 * math.pi * (intra + chunk_cycles)
    return samples_ms[None, :, :] * torch.complex(torch.cos(phase), torch.sin(phase))


def noncoherent_acquisition_sweep(
    samples_ms: torch.Tensor,  # [M, L] complex64
    dopplers: torch.Tensor,  # [D] float32
    prn_fft_conj: torch.Tensor,  # [S, L] complex64
    sample_rate: float,
) -> torch.Tensor:
    """Non-coherently integrated correlation power over the full grid.

    Returns [S, D, L] float32: for each satellite and Doppler bin, the sum
    over the M millisecond chunks of |circular correlation| at every code
    phase."""
    shifted = doppler_wipeoff(samples_ms, dopplers, sample_rate)  # [D, M, L]
    sample_ffts = torch.fft.fft(shifted, dim=-1)  # [D, M, L]
    s_count, length = prn_fft_conj.shape
    total = torch.zeros(
        (s_count, dopplers.shape[0], length), dtype=torch.float32, device=samples_ms.device
    )
    for m in range(samples_ms.shape[0]):
        corr = torch.fft.ifft(sample_ffts[None, :, m, :] * prn_fft_conj[:, None, :], dim=-1)
        total += corr.abs()
    return total


def peak_strength(profile: torch.Tensor) -> torch.Tensor:
    """Normalized peak strength of a correlation profile: peak / mean-of-rest
    (reference: gypsum/utils.py:111-116). Batched over leading dims."""
    peak = profile.amax(dim=-1)
    n = profile.shape[-1]
    mean_rest = (profile.sum(dim=-1) - peak) / (n - 1)
    return peak / mean_rest


def rolled_lag_window(
    replica_tiled: torch.Tensor,  # [2L] — the replica concatenated with itself
    code_phase: int,  # prompt roll, in samples
    half_width: int,
    length: int,
) -> torch.Tensor:
    """The [2K+1, L] matrix whose row k is the replica circularly rolled by
    (code_phase + k - K) samples, i.e. lags prompt-K .. prompt+K.

    roll(r, s)[l] = r[(l - s) mod L] = tiled[((L - s) mod L) + l], so each row
    is a slice of the tiled replica (one gather, no FFT)."""
    dev = replica_tiled.device
    k = torch.arange(-half_width, half_width + 1, device=dev)
    starts = torch.remainder(length - int(code_phase) - k, length)  # [2K+1]
    idx = starts[:, None] + torch.arange(length, device=dev)[None, :]
    return replica_tiled[idx]


def lag_window(
    replicas_wide: torch.Tensor,  # [S, >= 2L + 2K] tiled replicas, one row per channel
    cp_int: torch.Tensor,  # [S] int64 — the code phase the window is centered on
    length: int,
    half_width: int,
) -> torch.Tensor:
    """Per channel, the L + 2K tiled-replica samples from
    ``(L - cp_int - K) mod L``: [S, L + 2K]. Sub-slice k (samples k .. k + L)
    is the replica rolled by (cp_int + K - k), so the slices run through
    lags cp_int - K .. cp_int + K in DESCENDING order. Rows shorter than
    2L + 2K (a window wider than the bank's per-ms one) are re-tiled first."""
    need = 2 * length + 2 * half_width
    if replicas_wide.shape[1] < need:
        replicas_wide = torch.cat(
            [replicas_wide[:, : 2 * length], replicas_wide[:, : 2 * half_width]], dim=1)
    base = torch.remainder(length - cp_int - half_width, length)
    span = torch.arange(length + 2 * half_width, device=replicas_wide.device)
    return torch.gather(replicas_wide, 1, base[:, None] + span[None, :])


def ascending_lag_rows(window: torch.Tensor, length: int) -> torch.Tensor:
    """The sub-slices of ``lag_window``'s [S, L + 2K] as a [S, 2K+1, L] view
    in ASCENDING lag order: row j is lag cp_int - K + j."""
    return window.unfold(1, length, 1).flip(1)


def lag_window_correlate(
    samples: torch.Tensor,  # [L] complex64 — one ms, carrier already wiped off
    replica_tiled: torch.Tensor,  # [2L] float32
    code_phase: int,
    half_width: int,
) -> torch.Tensor:
    """Correlations at the 2K+1 integer lags around the prompt code phase:
    [2K+1] complex64 where index K is the prompt, K-1 early, K+1 late."""
    length = samples.shape[-1]
    window = rolled_lag_window(replica_tiled, code_phase, half_width, length)
    return window.to(samples.dtype) @ samples


def build_circulant_table(
    replica_rows: np.ndarray | torch.Tensor,  # [S, L] float32 +/-1
    device: str | torch.device,
) -> torch.Tensor:
    """[S, L, L] bfloat16 circulant tables C_s[l, tau] = r_s[(l - tau) mod L]
    built on ``device`` from the replica rows (+/-1 chips are bf16-exact).

    Row j of ``tiled.unfold(0, L, 1)`` is tiled[j : j + L]; its element l is
    r[(j + l) mod L], so row L - tau is column tau of C. One satellite's
    table is the flipped view's first L rows, transposed: no [S, L, L] index
    is ever formed."""
    if not isinstance(replica_rows, torch.Tensor):  # numpy tables may be read-only
        replica_rows = torch.tensor(np.asarray(replica_rows, dtype=np.float32))
    rows = replica_rows.to(device=device, dtype=torch.float32)
    s_count, length = rows.shape
    table = torch.empty((s_count, length, length), dtype=torch.bfloat16, device=rows.device)
    for s in range(s_count):
        tiled = torch.cat([rows[s], rows[s]]).to(torch.bfloat16)  # [2L]
        windows = tiled.unfold(0, length, 1)  # [L + 1, L], row j = tiled[j : j + L]
        table[s] = windows.flip(0)[:length].transpose(0, 1)  # [l, tau] = windows[L - tau, l]
    return table


def noncoherent_acquisition_sweep_matmul(
    samples_ms: torch.Tensor,  # [M, L] complex64
    dopplers: torch.Tensor,  # [D] float32
    table: torch.Tensor,  # [S, L, L] bfloat16 (build_circulant_table)
    sample_rate: float,
) -> torch.Tensor:
    """Same contract as :func:`noncoherent_acquisition_sweep` (returns
    [S, D, L] summed |correlation|), evaluated as products of the
    Doppler-wiped rows [D*M, L] with each satellite's circulant.

    The real and imaginary planes are rounded to bf16 and stacked into one
    [2*D*M, L] operand. On the card one batched product over the satellites
    (the operand broadcast, not copied) runs on the tensor cores with a
    float32 result, 2 x S x D*M x L x 4 bytes (152 MB at the GPS grid). On
    the CPU, whose bf16 product returns bf16, each satellite's table is
    widened to float32 in turn and multiplied in float32: the same
    bf16-in / float32-out product."""
    m_count, length = samples_ms.shape
    d_count = dopplers.shape[0]
    shifted = doppler_wipeoff(samples_ms, dopplers, sample_rate).reshape(-1, length)
    z = torch.cat([shifted.real, shifted.imag]).to(torch.bfloat16)  # [2*D*M, L]
    rows = d_count * m_count

    def magnitude(c: torch.Tensor) -> torch.Tensor:  # [..., 2*D*M, L] -> [..., D, L]
        cr, ci = c[..., :rows, :], c[..., rows:, :]
        mag = torch.sqrt(cr * cr + ci * ci)
        return mag.reshape(*mag.shape[:-2], d_count, m_count, length).sum(dim=-2)

    if table.is_cuda:
        s_count = table.shape[0]
        c = torch.bmm(z.expand(s_count, -1, -1), table, out_dtype=torch.float32)
        return magnitude(c)
    z = z.to(torch.float32)
    return torch.stack([magnitude(z @ t.to(torch.float32)) for t in table])

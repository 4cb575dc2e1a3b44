"""The per-millisecond scan tracker: the package's slow reference tracker.

Torch port of the scan path of gypsum_tpu/track/loop.py
(``_build_track_block_fn``: ``window_slices``, ``correlate_xla``,
``correlate_pallas``, ``make_hoisted_correlate``, ``make_per_ms_correlate``
and ``step``), selected by ``TrackingConfig.use_matmul_tracker=False``
without the block kernel (track/loop.py:make_track_block_fn).

Each millisecond, in order: wipe the chunk with the channel's current NCO
state, correlate at the 2K+1 lags around the prompt, and run the loop filter
(``ops/fixup.py:loop_filter_step``, the chain the fixup kernel's plain
version runs too). ``lax.scan`` becomes a Python loop over the block's
milliseconds on tensors: this path is plain PyTorch and stays so, except for
the correlator, which comes in three forms as in the JAX package:

- hoisted (``hoist_lag_window=True``, the default): one window of
  L + 2 K_eff replica samples per channel per block, centered on the
  block-start code phase, with a margin of the full Doppler-aided drift over
  the block + 8 samples; every ms evaluates all NLE = 2 K_eff + 1 lags and
  selects the 2K+1 around the current prompt;
- per-ms plain (``hoist_lag_window=False``): a fresh 2K+1 window per ms;
- per-ms through kernel K4 (``use_pallas_correlator=True``,
  ``ops/wipeoff_lag.py``), which overrides ``hoist_lag_window`` and is not
  used for a farm (the kernel takes one shared stream). The block's I/Q
  planes ``[B, 2, L]`` are laid out once per block and the kernel is handed
  ``planes[b]``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gypsum_tpu_torch.core.config import TrackingConfig
from gypsum_tpu_torch.core.constants import GPS_L1_FREQUENCY_HZ
from gypsum_tpu_torch.core.planes import dequantize_planes, to_complex, to_planes
from gypsum_tpu_torch.ops import fixup as fx
from gypsum_tpu_torch.ops.correlate import ascending_lag_rows, lag_window
from gypsum_tpu_torch.ops.wipeoff_lag import wipeoff_lag_correlate


def make_scan_track_block_fn(
    config: TrackingConfig,
    samples_per_prn: int,
    sample_rate: float,
    n_channels: int,
    stream_of_channel: np.ndarray | None = None,
    input_offset: float = 0.0,
    device: torch.device = torch.device("cpu"),
):
    """Build the scan tracker on ``device``; the contract of
    track/matmul.py:make_matmul_track_block_fn (``f.packed`` included)."""
    from gypsum_tpu_torch.track.loop import (
        block_fn_from_packed,
        carry_rows,
        device_state,
        state_from_carry,
    )

    cfg = config
    length = int(samples_per_prn)
    fs = float(sample_rate)
    k_half = cfg.lag_window_half_width
    n_lags = 2 * k_half + 1
    params = fx.FixupParams.from_config(cfg, length, fs)
    two_pi = 2.0 * math.pi

    farm_idx = None
    if stream_of_channel is not None:
        farm_idx = torch.as_tensor(np.asarray(stream_of_channel, dtype=np.int64), device=device)
        if farm_idx.shape != (n_channels,):
            raise ValueError(f"stream_of_channel must have shape ({n_channels},)")

    use_kernel = bool(cfg.use_pallas_correlator) and farm_idx is None
    hoist = cfg.hoist_lag_window and not use_kernel
    if cfg.lag_window_block_margin is not None:
        margin = cfg.lag_window_block_margin
    else:
        # Doppler-aided code drift at +/-7 kHz over one block + DLL slack.
        f_aid = cfg.aiding_carrier_hz or GPS_L1_FREQUENCY_HZ
        margin = int(np.ceil(7000.0 / f_aid * length * cfg.block_size_ms)) + 8
    k_eff = k_half + margin

    l_over_fs = torch.from_numpy((np.arange(length) / fs).astype(np.float32)).to(device)

    def wipe(carry: fx.LoopCarry, off: torch.Tensor, chunk: torch.Tensor):
        """chunk * e^{-j(theta + 2 pi (f + f_off) l / fs)} as real planes
        [S, L]; ``chunk`` [1, L] (shared stream) or [S, L] (farm) complex."""
        phase = carry.th[:, None] + (two_pi * (carry.fd + off)[:, None] * l_over_fs[None, :])
        c, s = torch.cos(phase), torch.sin(phase)
        cr, ci = chunk.real, chunk.imag
        return cr * c + ci * s, ci * c - cr * s

    def make_hoisted(replicas_wide: torch.Tensor, carry0: fx.LoopCarry, off: torch.Tensor):
        cpi0 = torch.remainder(torch.floor(carry0.cp).to(torch.int64), length)
        rows = ascending_lag_rows(lag_window(replicas_wide, cpi0, length, k_eff), length)  # [S, NLE, L]

        def correlate(carry, chunk):
            xr, xi = wipe(carry, off, chunk)
            all_r = torch.einsum("skl,sl->sk", rows, xr)
            all_i = torch.einsum("skl,sl->sk", rows, xi)
            # The clamp in select_lags keeps the window in range if the
            # drift outruns the margin (the host re-centers next block).
            return fx.select_lags(all_r, all_i, carry.cp, cpi0, length, k_half)

        return correlate

    def make_per_ms(replicas_wide: torch.Tensor, off: torch.Tensor):
        def correlate(carry, chunk):
            """``chunk``: the ms as complex [1, L] or [S, L]; on the kernel
            route as its I/Q planes [2, L]."""
            cp_int = torch.remainder(torch.floor(carry.cp).to(torch.int64), length)
            if use_kernel:
                base = torch.remainder(length - cp_int - k_half, length)
                kernel_params = torch.stack(
                    [carry.th, carry.fd + off, base.to(torch.float32)], dim=-1
                )  # [S, 3]
                planes = wipeoff_lag_correlate(
                    chunk, replicas_wide, kernel_params, length, n_lags, 1.0 / fs,
                )  # [S, 2, n_lags]
                return cp_int, planes[:, 0], planes[:, 1]
            xr, xi = wipe(carry, off, chunk)
            rows = ascending_lag_rows(lag_window(replicas_wide, cp_int, length, k_half), length)
            return (cp_int, torch.einsum("skl,sl->sk", rows, xr),
                    torch.einsum("skl,sl->sk", rows, xi))

        return correlate

    def track_block_packed(state, samples_block: torch.Tensor, replicas_wide: torch.Tensor):
        state = device_state(state, device)
        if use_kernel:
            # The kernel's [2, L] planes of every ms, laid out once per block.
            planes = (to_planes(samples_block) if samples_block.is_complex()
                      else dequantize_planes(samples_block, input_offset))
            chunks = planes.permute(0, 2, 1).contiguous()  # [B, 2, L]
        elif samples_block.is_complex():
            chunks = samples_block.to(torch.complex64)
        else:
            chunks = to_complex(dequantize_planes(samples_block, input_offset))
        carry = fx.LoopCarry.from_rows(torch.stack(carry_rows(state)))
        off = state.carrier_offset.to(torch.float32)
        off_frac = fx.offset_cycle_fraction(off, params.t_ms)
        correlate = (
            make_hoisted(replicas_wide, carry, off) if hoist else make_per_ms(replicas_wide, off)
        )
        b_count = chunks.shape[0]
        outs = torch.empty((b_count, fx.N_OUT, n_channels), dtype=torch.float32, device=device)
        for b in range(b_count):
            if use_kernel:
                chunk = chunks[b]
            else:
                chunk = chunks[b][None, :] if farm_idx is None else chunks[b][farm_idx]
            cp_int, sel_r, sel_i = correlate(carry, chunk)
            # NCO advance for the elapsed chunk, with the frequency the chunk
            # was wiped with.
            advance = two_pi * (carry.fd * params.t_ms + off_frac)
            carry, outs[b] = fx.loop_filter_step(carry, sel_r, sel_i, cp_int, advance, params)
        return state_from_carry(torch.stack(carry.rows()), state.carrier_offset), outs

    return block_fn_from_packed(track_block_packed)

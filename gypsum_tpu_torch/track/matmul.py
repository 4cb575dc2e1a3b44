"""Two-phase block tracker: the block's correlations as one matmul, then the
sequential loop-filter fixup.

Torch port of gypsum_tpu/track/matmul.py.

Phase 1 (one matrix product, no sequential dependence):
    Wiping every millisecond with the BLOCK-START loop state (theta0, f0) and
    rotating the result by the phase difference later is exact up to the
    within-ms residual-Doppler ramp (amplitude factor >= 0.992 even at a
    70 Hz pull-in excursion). So the wipeoff phasor folds into the replica
    side and the sample block C [B, L] is shared by every channel:

        W[s, l, j]     = rows[s, j, l] * e^{-j(theta0_s + 2 pi f0_s l / fs)}
        corr0[b, s, j] = sum_l C[b, l] * W[s, l, j]

    a dense [B, L] x [L, S * NLE] product with float32 output. It is a plain
    matrix product, left to ``torch.mm`` as the JAX package left it to XLA.

Phase 2 (sequential, tiny): kernel K1 (``ops/fixup.py``) walks the B
milliseconds per channel, selecting the 2K+1 lags around the current prompt
from the precomputed rows, rotating the prompt by
alpha = (theta - theta0) + pi (f - f0) t_ms and running the discriminator
and EMA updates.

Reference analogue: the 1 kHz per-satellite loop of gypsum/tracker.py:264-389.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gypsum_tpu_torch.core import aot
from gypsum_tpu_torch.core.config import TrackingConfig
from gypsum_tpu_torch.core.constants import GPS_L1_FREQUENCY_HZ
from gypsum_tpu_torch.core.device import resolve_device
from gypsum_tpu_torch.obs import spans
from gypsum_tpu_torch.ops import fixup as fx
from gypsum_tpu_torch.ops.correlate import ascending_lag_rows, lag_window
from gypsum_tpu_torch.ops.iq_operand import iq_operand


def lag_window_size(config: TrackingConfig, samples_per_prn: int) -> int:
    """NLE = 2 (K + margin) + 1: the block's lag-window rows per channel.
    The margin is half the worst-case Doppler-aided code drift over the
    block plus 8 samples of DLL slack (the window is centered on the
    predicted mid-block code phase)."""
    cfg = config
    if cfg.lag_window_block_margin is not None:
        margin = cfg.lag_window_block_margin
    else:
        f_aid = cfg.aiding_carrier_hz or GPS_L1_FREQUENCY_HZ
        drift = 7000.0 / f_aid * samples_per_prn * cfg.block_size_ms
        margin = int(np.ceil(drift / 2.0)) + 8
    return 2 * (cfg.lag_window_half_width + margin) + 1


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with float32 output: bf16 operands on the card keep a float32
    result (``out_dtype``), as ``preferred_element_type`` does in JAX."""
    if a.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a, b)


def make_matmul_track_block_fn(
    config: TrackingConfig,
    samples_per_prn: int,
    sample_rate: float,
    n_channels: int,
    stream_of_channel: np.ndarray | None = None,
    input_offset: float = 0.0,
    device: str | torch.device = "cuda",
):
    """Build the two-phase block tracker on ``device`` (resolved by
    ``core.device.resolve_device``: CUDA unless the caller asks for the CPU).

    Returns ``f(state, samples_block, replicas_wide) -> (state', outputs)``:
    ``state`` is a TrackState of [S] leaves (numpy or tensors),
    ``samples_block`` [B, L, 2] planes or [B, L] complex (farm:
    [B, N, L, 2] / [B, N, L]) on ``device`` (on a CUDA device int8, uint8,
    int16 or float32 planes, or complex64), ``replicas_wide`` [S, >= 2L + 2K]
    float32 on ``device``; the new state has [S] tensor leaves and the
    outputs are a TrackBlockOutputs of [B, S] tensors. ``f.packed`` returns
    the outputs as one [B, N_OUT, S] float32 tensor instead. ``f.libraries``
    names the kernels it launches on a CUDA device (the samples' operand
    kernel, and K1's unless ``fixup_backend="scan"``), which
    ``track/loop.py:make_track_block_fn`` preloads.
    """
    from gypsum_tpu_torch.track.loop import (
        TrackState,
        block_fn_from_packed,
        carry_rows,
        device_state,
        state_from_carry,
    )

    device = resolve_device(device)
    cfg = config
    length = int(samples_per_prn)
    fs = float(sample_rate)
    k_half = cfg.lag_window_half_width
    f_aid = cfg.aiding_carrier_hz or GPS_L1_FREQUENCY_HZ
    aiding_scale = (length / f_aid) if cfg.carrier_aiding else 0.0
    n_lags_eff = lag_window_size(cfg, length)
    k_eff = (n_lags_eff - 1) // 2
    params = fx.FixupParams.from_config(cfg, length, fs)

    backend = cfg.fixup_backend
    if backend not in (None, "pallas", "scan"):
        raise ValueError(f"unknown fixup_backend {backend!r} (pallas | scan | None)")
    # fixup_backend="scan" is a named configuration, not a fallback: only a
    # caller that sets it explicitly gets the plain loop-filter chain on the
    # card's tensors (the JAX package allows its scan fixup on any backend).
    # None and "pallas" launch the fixup kernel on a CUDA device, or raise.
    run_fixup = fx.fixup_reference if backend == "scan" else fx.fixup

    # bf16 operands keep phase 1 on the card's tensor cores; on the CPU they
    # are rounded to bf16 and multiplied in float32, which is the same
    # bf16-in / float32-out product.
    bf16 = cfg.matmul_tracker_bf16

    def to_mm(x: torch.Tensor) -> torch.Tensor:
        if not bf16:
            return x
        x = x.to(torch.bfloat16)
        return x if x.is_cuda else x.to(torch.float32)

    l_over_fs = torch.from_numpy((np.arange(length) / fs).astype(np.float32)).to(device)

    farm_groups = None
    if stream_of_channel is not None:
        soc = np.asarray(stream_of_channel, dtype=np.int64)
        if soc.shape != (n_channels,):
            raise ValueError(f"stream_of_channel must have shape ({n_channels},)")
        # (stream, its channels in order): each stream's channels are
        # correlated as one product, as the single-stream tracker does.
        farm_groups = [(int(n), torch.as_tensor(np.flatnonzero(soc == n), device=device))
                       for n in np.unique(soc)]

    def build_rows(replicas_wide: torch.Tensor, state: TrackState):
        """Block-static lag window [S, NLE, L] in ascending lag order,
        centered on the predicted mid-block code phase; also cpi0 [S]."""
        predicted_mid = -aiding_scale * state.doppler * (cfg.block_size_ms / 2.0)
        cpi0 = torch.remainder(torch.floor(state.code_phase + predicted_mid).to(torch.int64), length)
        rows = ascending_lag_rows(lag_window(replicas_wide, cpi0, length, k_eff), length)
        return rows, cpi0  # [S, NLE, L]

    def wipe(rows: torch.Tensor, state: TrackState):
        """Phase 1's W operands: the block-start wipeoff folded into the lag
        rows, w_r, w_i [S, L, NLE], in the product's precision."""
        phase0 = state.carrier_phase[:, None] + (
            2.0 * math.pi * (state.doppler + state.carrier_offset)[:, None] * l_over_fs[None, :]
        )  # [S, L]
        c0, s0 = torch.cos(phase0), torch.sin(phase0)
        rows_lj = rows.transpose(1, 2)  # [S, L, NLE]
        w_r = to_mm(rows_lj * c0[:, :, None])
        w_i = to_mm(-rows_lj * s0[:, :, None])
        return w_r, w_i

    def product(c, w_r, w_i):
        """corr = c . W with complex c and W: re = cr.wr - ci.wi,
        im = cr.wi + ci.wr; all four products as ONE matmul
        [2B, L] x [L, 2 S NLE], c = [cr; ci] the stream's operand rows."""
        b_count, s_count = c.shape[0] // 2, w_r.shape[0]
        w = torch.stack([w_r, w_i]).permute(2, 0, 1, 3).reshape(length, -1)
        prod = _mm_f32(c, w).reshape(2, b_count, 2, s_count, n_lags_eff)
        return prod[0, :, 0] - prod[1, :, 1], prod[0, :, 1] + prod[1, :, 0]

    def products(operand, w_r, w_i):
        """Phase 1's correlations for every millisecond at once: corr_r,
        corr_i [B, S, NLE] float32, from the samples' operand [N, 2B, L]
        (``ops/iq_operand.py``; N = 1 for a single stream)."""
        if farm_groups is None:
            spans.count("phase1.products")
            corr_r, corr_i = product(operand[0], w_r, w_i)
        else:
            # One product a stream, its channels laid out as the
            # single-stream tracker lays them out: a stream's channels get
            # the sums they would get tracked alone (the same product
            # shapes), whatever the other streams hold.
            spans.count("phase1.products", len(farm_groups))
            shape = (operand.shape[1] // 2, w_r.shape[0], n_lags_eff)
            corr_r = torch.empty(shape, dtype=torch.float32, device=operand.device)
            corr_i = torch.empty_like(corr_r)
            for n, idx in farm_groups:
                corr_r[:, idx], corr_i[:, idx] = product(operand[n], w_r[idx], w_i[idx])
        return corr_r.contiguous(), corr_i.contiguous()

    def phase1(state, samples_block: torch.Tensor, replicas_wide: torch.Tensor):
        """The state as [S] device tensors, the fixup's initial carry
        [N_CARRY, S] and the block's correlations corr_r, corr_i
        [B, S, NLE]."""
        with spans.span("phase1.inputs"):
            state = device_state(state, device)
            operand = iq_operand(samples_block, input_offset, bf16)  # [N, 2B, L]
        with spans.span("phase1.wipe"):
            rows, cpi0 = build_rows(replicas_wide, state)
            w_r, w_i = wipe(rows, state)
        with spans.span("phase1.products"):
            corr_r, corr_i = products(operand, w_r, w_i)  # [B, S, NLE]

        # The phase-1 wipeoff reference is the block-start state.
        f32 = torch.float32
        init = torch.stack([
            *carry_rows(state), cpi0.to(f32),
            state.carrier_phase.to(f32), state.doppler.to(f32), state.carrier_offset.to(f32),
        ])  # [N_CARRY, S]
        return state, init, corr_r, corr_i

    def track_block_packed(state, samples_block: torch.Tensor, replicas_wide: torch.Tensor):
        """(state', outs [B, N_OUT, S] float32): the fixup's outputs as it
        wrote them, rows in ``fx.O_*`` order."""
        with spans.span("track.block"):
            spans.count("track.blocks")
            state, init, corr_r, corr_i = phase1(state, samples_block, replicas_wide)
            fin, outs = run_fixup(init, corr_r, corr_i, params)
            with spans.span("track.carry"):
                return state_from_carry(fin, state.carrier_offset), outs

    track_block = block_fn_from_packed(track_block_packed)
    # Phase 1 and the fixup's constants on their own hold the fixup kernel
    # against its plain version on real correlations.
    track_block.phase1 = phase1
    track_block.fixup_params = params
    track_block.libraries = tuple(
        name for name in aot.TRACKER_LIBRARIES
        if not (backend == "scan" and name == fx.FIXUP_KERNEL.source))
    return track_block

"""K1: phase 2 of the two-phase block tracker, the loop-filter fixup.

Replaces gypsum_tpu/ops/pallas_fixup.py:make_fixup_fn. Phase 1
(track/matmul.py) evaluates every lag of the block's lag window for every
millisecond at once; what remains is the sequential loop-filter update for
each millisecond and channel, from the 2K+1 lags around the current prompt:
early/late power and argmax, triangle or HRC sub-sample measurement, the
prompt rotated to the loop phase, DLL, Costas PLL, bias-corrected lock and
quality EMAs, the PLL gain switch, the FDMA offset advance and the sticky
watchdog.

The carry is a [12, S] float32 array (rows below, the layout of
gypsum_tpu/ops/pallas_fixup.py:46-55); the per-ms outputs are [B, 11, S].
On a CUDA tensor ``fixup`` launches the hand-written kernel
(``csrc/fixup.cu``); on a CPU tensor it runs ``fixup_reference``, the plain
PyTorch version (the reference's ``fixup_step``, gypsum_tpu/track/matmul.py:204-322,
looped over the block).
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from gypsum_tpu_torch.core.config import TrackingConfig
from gypsum_tpu_torch.core.constants import GPS_L1_FREQUENCY_HZ
from gypsum_tpu_torch.obs import spans
from gypsum_tpu_torch.ops.kernels import CudaKernel, check_cuda_tensor

_EPS = 1e-12

# Carry rows of the [N_CARRY, S] init/final arrays. The last four are block
# constants: the lag-window center, the phase-1 wipeoff reference state and
# the FDMA carrier offset.
(CP, TH, FD, EERR, EERR2, EQ, STEP, LOST, CPI0, TH0, FD0, OFF) = range(12)
N_CARRY = 12

# Output rows of the per-ms [B, N_OUT, S] array (track/loop.py's
# TrackBlockOutputs field order).
(O_PI, O_PQ, O_CP, O_CPM, O_FD, O_TH, O_PLL, O_DLL, O_LOCKED, O_QUAL, O_LOST) = range(11)
N_OUT = 11


@dataclass(frozen=True)
class FixupParams:
    """Loop constants of the fixup, derived from a TrackingConfig."""

    kp_locked: float
    ki_locked: float
    kp_pullin: float
    ki_pullin: float
    lam_err: float
    lam_q: float
    aiding_scale: float
    dll_gain: float
    t_ms: float
    max_err_var: float
    min_quality: float
    quality_drop: float
    w_chip: float
    lock_window_ms: int
    watchdog_warmup_ms: int
    length: int
    k_half: int
    use_hrc: bool

    @classmethod
    def from_config(cls, cfg: TrackingConfig, samples_per_prn: int, sample_rate: float) -> "FixupParams":
        length = int(samples_per_prn)
        t_ms = length / float(sample_rate)
        zeta = cfg.pll_damping_factor

        def gains(bw):
            return 4.0 * zeta * bw * t_ms, 4.0 * (bw**2) * t_ms

        kp_l, ki_l = gains(cfg.pll_bandwidth_locked_hz)
        kp_p, ki_p = gains(cfg.pll_bandwidth_pullin_hz)
        f_aid = cfg.aiding_carrier_hz or GPS_L1_FREQUENCY_HZ
        if cfg.code_phase_measurement not in ("triangle", "hrc"):
            raise ValueError(f"unknown code_phase_measurement {cfg.code_phase_measurement!r}")
        use_hrc = cfg.code_phase_measurement == "hrc"
        if use_hrc and cfg.lag_window_half_width < 3:
            raise ValueError(
                "code_phase_measurement='hrc' needs lag_window_half_width >= 3 "
                "(lags at peak +/- 2 with one sample of peak drift)"
            )
        return cls(
            kp_locked=kp_l, ki_locked=ki_l, kp_pullin=kp_p, ki_pullin=ki_p,
            lam_err=1.0 / cfg.lock_window_ms, lam_q=1.0 / cfg.quality_window_ms,
            aiding_scale=(length / f_aid) if cfg.carrier_aiding else 0.0,
            dll_gain=cfg.dll_gain_samples, t_ms=t_ms,
            max_err_var=cfg.max_phase_error_variance_for_lock,
            min_quality=cfg.min_quality_for_lock,
            quality_drop=cfg.quality_drop_threshold,
            w_chip=float(length) / float(cfg.chips_per_code),
            lock_window_ms=int(cfg.lock_window_ms),
            watchdog_warmup_ms=int(cfg.watchdog_warmup_ms),
            length=length, k_half=int(cfg.lag_window_half_width), use_hrc=use_hrc,
        )


class _FixupParams(ctypes.Structure):
    """C layout of csrc/loop_filter.cuh's FixupParams."""

    _fields_ = [
        *((name, ctypes.c_float) for name in (
            "kp_locked", "ki_locked", "kp_pullin", "ki_pullin", "lam_err", "lam_q",
            "log1m_lam_err", "log1m_lam_q", "aiding_scale", "dll_gain", "t_ms",
            "max_err_var", "min_quality", "quality_drop", "w_chip",
        )),
        *((name, ctypes.c_int) for name in (
            "lock_window_ms", "watchdog_warmup_ms", "length", "k_half", "use_hrc",
        )),
    ]


def c_params(p: FixupParams) -> _FixupParams:
    """``p`` in the kernels' C layout."""
    return _FixupParams(
        kp_locked=p.kp_locked, ki_locked=p.ki_locked, kp_pullin=p.kp_pullin,
        ki_pullin=p.ki_pullin, lam_err=p.lam_err, lam_q=p.lam_q,
        # log1p(-lambda) in double, rounded once to float (as the reference).
        log1m_lam_err=math.log1p(-p.lam_err), log1m_lam_q=math.log1p(-p.lam_q),
        aiding_scale=p.aiding_scale, dll_gain=p.dll_gain, t_ms=p.t_ms,
        max_err_var=p.max_err_var, min_quality=p.min_quality,
        quality_drop=p.quality_drop, w_chip=p.w_chip,
        lock_window_ms=p.lock_window_ms, watchdog_warmup_ms=p.watchdog_warmup_ms,
        length=p.length, k_half=p.k_half, use_hrc=int(p.use_hrc),
    )


FIXUP_KERNEL = CudaKernel(
    "fixup",
    "fixup_f32",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.POINTER(_FixupParams), ctypes.c_void_p],
)


class LoopCarry(NamedTuple):
    """The loop filter's per-channel carry, [S] float32 tensors (``lost``
    bool)."""

    cp: torch.Tensor
    th: torch.Tensor
    fd: torch.Tensor
    eerr: torch.Tensor
    eerr2: torch.Tensor
    eq: torch.Tensor
    step: torch.Tensor
    lost: torch.Tensor

    @classmethod
    def from_rows(cls, rows: torch.Tensor) -> "LoopCarry":
        """From the first eight rows of a [N_CARRY, S] carry array."""
        return cls(rows[CP], rows[TH], rows[FD], rows[EERR], rows[EERR2], rows[EQ],
                   rows[STEP], rows[LOST] > 0.5)

    def rows(self) -> list[torch.Tensor]:
        """The eight carry rows, ``lost`` as float32."""
        return [*self[:7], self.lost.to(torch.float32)]


def select_lags(
    all_r: torch.Tensor, all_i: torch.Tensor, cp: torch.Tensor, cpi0: torch.Tensor,
    length: int, k_half: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The 2K+1 lags around the current prompt out of one millisecond's
    all-lag correlations ``all_r``/``all_i`` [S, NLE] (ascending lag, window
    centered on ``cpi0`` [S] int64), clipped to the window. Returns
    ``(cp_int [S] int64, sel_r, sel_i [S, 2K+1])``."""
    nle = all_r.shape[1]
    k_eff = (nle - 1) // 2
    half = length // 2
    cp_int = torch.remainder(torch.floor(cp).to(torch.int64), length)
    delta = torch.remainder(cp_int - cpi0 + half, length) - half
    j = torch.clamp(delta + k_eff, k_half, nle - 1 - k_half)
    idx = j[:, None] + torch.arange(-k_half, k_half + 1, device=all_r.device)[None, :]
    return cp_int, torch.gather(all_r, 1, idx), torch.gather(all_i, 1, idx)


def loop_filter_step(
    carry: LoopCarry, sel_r: torch.Tensor, sel_i: torch.Tensor, cp_int: torch.Tensor,
    nco_advance: torch.Tensor, p: FixupParams, alpha: torch.Tensor | None = None,
) -> tuple[LoopCarry, torch.Tensor]:
    """One millisecond of the loop filter for every channel, shared by the
    fixup's plain version, the per-ms scan tracker (track/scan.py) and the
    block kernel's plain version (ops/track_block.py).

    ``sel_r``/``sel_i`` [S, 2K+1]: the correlations at lags prompt-K ..
    prompt+K; ``cp_int`` [S]: the integer code phase they are centered on;
    ``nco_advance`` [S]: the carrier NCO's advance over this ms in radians
    (computed by the caller from the pre-update Doppler); ``alpha`` [S]: the
    rotation from the wipeoff reference to the loop phase, or None when the
    correlations were wiped with the loop phase itself. Returns the new
    carry and this ms's outputs [N_OUT, S] (pre-update loop state)."""
    k_half = p.k_half
    n_lags = 2 * k_half + 1
    length = p.length
    two_pi = 2.0 * math.pi
    cp, th, fd, eerr, eerr2, eq, step, lost = carry

    power = sel_r * sel_r + sel_i * sel_i
    early = power[:, k_half - 1]
    late = power[:, k_half + 1]
    peak_idx = torch.argmax(power, dim=-1)  # first index on ties
    p0_r = torch.gather(sel_r, 1, peak_idx[:, None])[:, 0]
    p0_i = torch.gather(sel_i, 1, peak_idx[:, None])[:, 0]

    mag = torch.sqrt(power)

    def take(o):
        return torch.gather(mag, 1, torch.clamp(peak_idx + o, 0, n_lags - 1)[:, None])[:, 0]

    r0, rp, rm = take(0), take(1), take(-1)
    if p.use_hrc:
        d1 = rm - rp
        d2 = take(-2) - take(2)
        frac = -p.w_chip * (d1 - 0.5 * d2) / (r0 + _EPS)
        frac = torch.clamp(frac, -1.5, 1.5)
    else:
        frac = (rp - rm) / (2.0 * (r0 - torch.minimum(rp, rm)) + _EPS)
        frac = torch.clamp(frac, -0.5, 0.5)
    cp_meas = torch.remainder(
        cp_int.to(torch.float32) + (peak_idx - k_half).to(torch.float32) + frac,
        float(length),
    )

    if alpha is None:
        i, q = p0_r, p0_i
    else:
        ca, sa = torch.cos(alpha), torch.sin(alpha)
        i = p0_r * ca + p0_i * sa
        q = p0_i * ca - p0_r * sa

    dll_err = (early - late) / (early + late + _EPS)
    new_cp = cp - p.dll_gain * dll_err
    new_cp = new_cp - p.aiding_scale * fd
    new_cp = torch.remainder(new_cp, float(length))

    pll_err = (i * q) / (i * i + q * q + _EPS)
    n = step + 1.0
    corr_err = 1.0 - torch.exp(n * math.log1p(-p.lam_err))
    corr_q = 1.0 - torch.exp(n * math.log1p(-p.lam_q))
    ema_err = eerr + p.lam_err * (pll_err - eerr)
    ema_err_sq = eerr2 + p.lam_err * (pll_err * pll_err - eerr2)
    m_err = ema_err / corr_err
    err_var = ema_err_sq / corr_err - m_err * m_err
    quality_inst = (i * i - q * q) / (i * i + q * q + _EPS)
    ema_q_raw = eq + p.lam_q * (quality_inst - eq)
    ema_q = ema_q_raw / corr_q

    warmed = step >= p.lock_window_ms
    locked = warmed & (err_var < p.max_err_var) & (ema_q > p.min_quality)
    kp = torch.where(locked, p.kp_locked, p.kp_pullin)
    ki = torch.where(locked, p.ki_locked, p.ki_pullin)
    new_th = torch.remainder(th + nco_advance + kp * pll_err, two_pi)
    new_fd = fd + ki * pll_err

    armed = step >= p.watchdog_warmup_ms
    lost = lost | (armed & (ema_q < p.quality_drop))

    out = torch.stack([
        i, q, cp, cp_meas, fd, th, pll_err, dll_err,
        locked.to(torch.float32), ema_q, lost.to(torch.float32),
    ])
    return LoopCarry(new_cp, new_th, new_fd, ema_err, ema_err_sq, ema_q_raw, n, lost), out


def offset_cycle_fraction(off: torch.Tensor, t_ms: float) -> torch.Tensor:
    """The FDMA offset's advance per ms, reduced mod one cycle before the
    radian conversion (offset * t_ms is exactly representable; 2 pi times it
    is not)."""
    off_cycles = off * t_ms
    return off_cycles - torch.round(off_cycles)


def fixup_reference(
    init: torch.Tensor, corr_r: torch.Tensor, corr_i: torch.Tensor, p: FixupParams
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: ``(final [N_CARRY, S], outs [B, N_OUT, S])`` from the
    carry ``init`` [N_CARRY, S] and the block's correlations
    ``corr_r``/``corr_i`` [B, S, NLE], all float32."""
    b_count, s_count, _ = corr_r.shape
    two_pi = 2.0 * math.pi
    carry = LoopCarry.from_rows(init)
    cpi0 = init[CPI0].to(torch.int64)
    th0, fd0, off = init[TH0], init[FD0], init[OFF]
    off_frac = offset_cycle_fraction(off, p.t_ms)

    outs = torch.empty((b_count, N_OUT, s_count), dtype=torch.float32, device=corr_r.device)
    for b in range(b_count):
        cp_int, sel_r, sel_i = select_lags(corr_r[b], corr_i[b], carry.cp, cpi0, p.length, p.k_half)
        # Rotate the prompt from the block-start wipeoff reference to the
        # loop phase: alpha = (theta - theta0) + pi (f - f0) t_ms.
        alpha = (carry.th - th0) + math.pi * (carry.fd - fd0) * p.t_ms
        advance = two_pi * (carry.fd * p.t_ms + off_frac)
        carry, outs[b] = loop_filter_step(carry, sel_r, sel_i, cp_int, advance, p, alpha)

    fin = torch.stack([*carry.rows(), init[CPI0], th0, fd0, off])
    return fin, outs


def fixup_cuda(
    init: torch.Tensor, corr_r: torch.Tensor, corr_i: torch.Tensor, p: FixupParams
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel on contiguous float32 CUDA tensors (same contract as
    ``fixup_reference``)."""
    if corr_r.dim() != 3:
        raise ValueError(f"corr_r must be [B, S, NLE], got {tuple(corr_r.shape)}")
    b_count, s_count, nle = corr_r.shape
    check_cuda_tensor(init, "init", torch.float32, (N_CARRY, s_count))
    check_cuda_tensor(corr_r, "corr_r", torch.float32, (b_count, s_count, nle))
    check_cuda_tensor(corr_i, "corr_i", torch.float32, (b_count, s_count, nle))
    if nle < 2 * p.k_half + 1 or nle % 2 == 0:
        raise ValueError(f"NLE ({nle}) must be odd and >= 2K+1 ({2 * p.k_half + 1})")
    outs = torch.empty((b_count, N_OUT, s_count), dtype=torch.float32, device=corr_r.device)
    fin = torch.empty((N_CARRY, s_count), dtype=torch.float32, device=corr_r.device)
    cp = c_params(p)
    FIXUP_KERNEL.launch(
        init.data_ptr(), corr_r.data_ptr(), corr_i.data_ptr(), outs.data_ptr(),
        fin.data_ptr(), b_count, s_count, nle, ctypes.byref(cp),
    )
    return fin, outs


def fixup(
    init: torch.Tensor, corr_r: torch.Tensor, corr_i: torch.Tensor, p: FixupParams
) -> tuple[torch.Tensor, torch.Tensor]:
    """The fixup: the kernel for CUDA tensors, the plain version for CPU
    tensors; the host time of either is the ``k1`` span."""
    with spans.span("k1"):
        if corr_r.device.type == "cpu":
            return fixup_reference(init, corr_r, corr_i, p)
        return fixup_cuda(init.contiguous(), corr_r.contiguous(), corr_i.contiguous(), p)

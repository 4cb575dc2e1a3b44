"""Plain reference of the two-phase block tracker that the farm runs.

PyTorch only, from the inputs the benchmark hands both sides (the captures'
int8 words, the carry a block starts from, the channels' signals) and the
configuration's loop constants. It works out its own replicas
(``portbench/codes.py``), lag windows, wipe and correlations, and runs the
loop-filter chain millisecond by millisecond.

The tracker it follows (the design of the configuration's tracking loop):

- phase 1: each channel's lag window, NLE = 2 (K + margin) + 1 code lags
  centred on the code phase predicted for mid-block, is correlated with
  every millisecond of its stream after a wipe with the block-start NCO
  (phase theta0 + 2 pi (f0 + offset) l / fs, in float32 as the NCO keeps
  it). The operands are rounded to the configuration's precision (bf16, or
  fp8 e4m3 for the control) and multiplied in float32 with TF32 off: the
  products of such operands are exact, the sums float32;
- phase 2: for every ms, the 2K+1 lags around the current prompt, early
  and late power, the argmax, the triangle (or HRC) sub-sample measurement,
  the prompt rotated from the block-start wipe to the loop phase, the DLL,
  the Costas PLL with its lock-dependent gains, the bias-corrected EMAs of
  the lock test, the FDMA offset's NCO advance and the sticky watchdog.

The fixup's arithmetic is a frozen copy of the port's plain fixup as of
this benchmark (the loop filter of gypsum_tpu_torch/ops/fixup.py), in
float32 operation for operation.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np
import torch

from portbench import codes

EPS = 1e-12
GPS_L1_HZ = 1575.42e6
N_OUT = 11
ROUNDING = {"bf16": torch.bfloat16, "fp8": torch.float8_e4m3fn}


@dataclass(frozen=True)
class Loop:
    """The loop constants of a tracking configuration (the configuration
    file's ``tracking`` object)."""

    length: int
    fs: float
    block_ms: int
    k_half: int
    n_lags: int  # NLE
    aiding_scale: float
    kp_locked: float
    ki_locked: float
    kp_pullin: float
    ki_pullin: float
    lam_err: float
    lam_q: float
    dll_gain: float
    t_ms: float
    max_err_var: float
    min_quality: float
    quality_drop: float
    w_chip: float
    lock_window_ms: int
    watchdog_warmup_ms: int
    use_hrc: bool

    @classmethod
    def from_config(cls, config: dict) -> "Loop":
        tr = config["tracking"]
        length, fs = int(config["samples_per_ms"]), float(config["sample_rate_hz"])
        block = int(tr["block_size_ms"])
        t_ms = length / fs
        zeta = tr["pll_damping_factor"]
        f_aid = tr["aiding_carrier_hz"] or GPS_L1_HZ
        k_half = int(tr["lag_window_half_width"])
        # Half the worst-case (7 kHz) Doppler-aided code drift over the
        # block, plus 8 samples of DLL slack.
        drift = 7000.0 / f_aid * length * block
        margin = int(np.ceil(drift / 2.0)) + 8
        if tr["code_phase_measurement"] not in ("triangle", "hrc"):
            raise ValueError(f"unknown code_phase_measurement {tr['code_phase_measurement']!r}")

        def gains(bw):
            return 4.0 * zeta * bw * t_ms, 4.0 * (bw**2) * t_ms

        kp_l, ki_l = gains(tr["pll_bandwidth_locked_hz"])
        kp_p, ki_p = gains(tr["pll_bandwidth_pullin_hz"])
        return cls(
            length=length, fs=fs, block_ms=block, k_half=k_half,
            n_lags=2 * (k_half + margin) + 1,
            aiding_scale=(length / f_aid) if tr["carrier_aiding"] else 0.0,
            kp_locked=kp_l, ki_locked=ki_l, kp_pullin=kp_p, ki_pullin=ki_p,
            lam_err=1.0 / tr["lock_window_ms"], lam_q=1.0 / tr["quality_window_ms"],
            dll_gain=tr["dll_gain_samples"], t_ms=t_ms,
            max_err_var=tr["max_phase_error_variance_for_lock"],
            min_quality=tr["min_quality_for_lock"], quality_drop=tr["quality_drop_threshold"],
            w_chip=float(length) / float(tr["chips_per_code"]),
            lock_window_ms=int(tr["lock_window_ms"]),
            watchdog_warmup_ms=int(tr["watchdog_warmup_ms"]),
            use_hrc=tr["code_phase_measurement"] == "hrc",
        )


@contextmanager
def _no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def channel_replicas(config: dict, signals: np.ndarray, device) -> torch.Tensor:
    """[S, L] float32 +/-1: each channel's code at the stream's rate."""
    table = codes.signal_codes(config["band"], list(np.asarray(signals).reshape(-1)))
    return torch.from_numpy(codes.replicas(table, int(config["samples_per_ms"]))).to(device)


def correlate(samples: torch.Tensor, carry: dict, reps: torch.Tensor, loop: Loop,
              precision: str) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Phase 1 of one block: (cpi0 [S] int64, corr_r, corr_i [B, S, NLE]).

    ``samples`` [B, N, L, 2] int8, stream n's channels n C .. n C + C - 1
    (C = S / N); ``carry`` the block-start carry ([S] tensors)."""
    length, nle = loop.length, loop.n_lags
    k_eff = (nle - 1) // 2
    dev = samples.device
    b_count, n_streams = samples.shape[0], samples.shape[1]
    s_count = reps.shape[0]
    per = s_count // n_streams
    cp = carry["code_phase"].to(torch.float32)
    th = carry["carrier_phase"].to(torch.float32)
    fd = carry["doppler"].to(torch.float32)
    off = carry["carrier_offset"].to(torch.float32)
    predicted_mid = -loop.aiding_scale * fd * (loop.block_ms / 2.0)
    cpi0 = torch.remainder(torch.floor(cp + predicted_mid).to(torch.int64), length)
    rnd = ROUNDING[precision]

    def rounded(x):
        return x.to(rnd).to(torch.float32)

    l_over_fs = torch.from_numpy((np.arange(length) / loop.fs).astype(np.float32)).to(dev)
    l_idx = torch.arange(length, device=dev)
    j_idx = torch.arange(nle, device=dev)
    x = rounded(samples.to(torch.float32))  # [B, N, L, 2]
    corr_r = torch.empty((b_count, s_count, nle), dtype=torch.float32, device=dev)
    corr_i = torch.empty_like(corr_r)
    with _no_tf32():
        for n in range(n_streams):
            ch = slice(n * per, (n + 1) * per)
            lags = cpi0[ch, None] - k_eff + j_idx[None, :]  # ascending lags
            idx = torch.remainder(l_idx[None, None, :] - lags[:, :, None], length)
            rows = torch.gather(reps[ch, None, :].expand(per, nle, length), 2, idx)
            phase0 = th[ch, None] + (2.0 * math.pi * (fd[ch] + off[ch])[:, None] * l_over_fs[None, :])
            rows_lj = rows.transpose(1, 2)  # [C, L, NLE]
            w_r = rounded(rows_lj * torch.cos(phase0)[:, :, None]).permute(1, 0, 2).reshape(length, -1)
            w_i = rounded(-rows_lj * torch.sin(phase0)[:, :, None]).permute(1, 0, 2).reshape(length, -1)
            xr, xi = x[:, n, :, 0], x[:, n, :, 1]
            re = xr @ w_r - xi @ w_i
            im = xr @ w_i + xi @ w_r
            corr_r[:, ch] = re.reshape(b_count, per, nle)
            corr_i[:, ch] = im.reshape(b_count, per, nle)
    return cpi0, corr_r, corr_i


def _step(carry, sel_r, sel_i, cp_int, advance, alpha, p: Loop):
    """One millisecond of the loop filter for every channel: the new carry
    and this ms's outputs [N_OUT, S] (pre-update loop state)."""
    k_half, length = p.k_half, p.length
    n_sel = 2 * k_half + 1
    cp, th, fd, eerr, eerr2, eq, step, lost = carry
    power = sel_r * sel_r + sel_i * sel_i
    early, late = power[:, k_half - 1], power[:, k_half + 1]
    peak = torch.argmax(power, dim=-1)
    p0_r = torch.gather(sel_r, 1, peak[:, None])[:, 0]
    p0_i = torch.gather(sel_i, 1, peak[:, None])[:, 0]
    mag = torch.sqrt(power)

    def take(o):
        return torch.gather(mag, 1, torch.clamp(peak + o, 0, n_sel - 1)[:, None])[:, 0]

    r0, rp, rm = take(0), take(1), take(-1)
    if p.use_hrc:
        frac = -p.w_chip * ((rm - rp) - 0.5 * (take(-2) - take(2))) / (r0 + EPS)
        frac = torch.clamp(frac, -1.5, 1.5)
    else:
        frac = (rp - rm) / (2.0 * (r0 - torch.minimum(rp, rm)) + EPS)
        frac = torch.clamp(frac, -0.5, 0.5)
    cp_meas = torch.remainder(
        cp_int.to(torch.float32) + (peak - k_half).to(torch.float32) + frac, float(length))
    ca, sa = torch.cos(alpha), torch.sin(alpha)
    i = p0_r * ca + p0_i * sa
    q = p0_i * ca - p0_r * sa
    dll_err = (early - late) / (early + late + EPS)
    new_cp = cp - p.dll_gain * dll_err
    new_cp = new_cp - p.aiding_scale * fd
    new_cp = torch.remainder(new_cp, float(length))
    pll_err = (i * q) / (i * i + q * q + EPS)
    n = step + 1.0
    corr_err = 1.0 - torch.exp(n * math.log1p(-p.lam_err))
    corr_q = 1.0 - torch.exp(n * math.log1p(-p.lam_q))
    ema_err = eerr + p.lam_err * (pll_err - eerr)
    ema_err_sq = eerr2 + p.lam_err * (pll_err * pll_err - eerr2)
    m_err = ema_err / corr_err
    err_var = ema_err_sq / corr_err - m_err * m_err
    quality_inst = (i * i - q * q) / (i * i + q * q + EPS)
    ema_q_raw = eq + p.lam_q * (quality_inst - eq)
    ema_q = ema_q_raw / corr_q
    locked = (step >= p.lock_window_ms) & (err_var < p.max_err_var) & (ema_q > p.min_quality)
    kp = torch.where(locked, p.kp_locked, p.kp_pullin)
    ki = torch.where(locked, p.ki_locked, p.ki_pullin)
    new_th = torch.remainder(th + advance + kp * pll_err, 2.0 * math.pi)
    new_fd = fd + ki * pll_err
    lost = lost | ((step >= p.watchdog_warmup_ms) & (ema_q < p.quality_drop))
    out = torch.stack([i, q, cp, cp_meas, fd, th, pll_err, dll_err,
                       locked.to(torch.float32), ema_q, lost.to(torch.float32)])
    return (new_cp, new_th, new_fd, ema_err, ema_err_sq, ema_q_raw, n, lost), out


def loop_filter(carry: dict, cpi0: torch.Tensor, corr_r: torch.Tensor, corr_i: torch.Tensor,
                p: Loop) -> tuple[dict, torch.Tensor]:
    """Phase 2: walk the block's milliseconds from ``carry``. Returns the
    carry after the block ([S] float32 tensors, ``lost`` bool) and the
    outputs [B, N_OUT, S]."""
    b_count, s_count, nle = corr_r.shape
    k_eff = (nle - 1) // 2
    half, length = p.length // 2, p.length
    f32 = torch.float32
    state = (carry["code_phase"].to(f32), carry["carrier_phase"].to(f32),
             carry["doppler"].to(f32), carry["ema_err"].to(f32), carry["ema_err_sq"].to(f32),
             carry["ema_quality"].to(f32), carry["step_count"].to(f32),
             carry["lost"].to(f32) > 0.5)
    th0, fd0 = state[1], state[2]
    off = carry["carrier_offset"].to(f32)
    off_cycles = off * p.t_ms
    off_frac = off_cycles - torch.round(off_cycles)
    offsets = torch.arange(-p.k_half, p.k_half + 1, device=corr_r.device)
    outs = torch.empty((b_count, N_OUT, s_count), dtype=f32, device=corr_r.device)
    for b in range(b_count):
        cp, th, fd = state[0], state[1], state[2]
        cp_int = torch.remainder(torch.floor(cp).to(torch.int64), length)
        delta = torch.remainder(cp_int - cpi0 + half, length) - half
        j = torch.clamp(delta + k_eff, p.k_half, nle - 1 - p.k_half)
        idx = j[:, None] + offsets[None, :]
        sel_r = torch.gather(corr_r[b], 1, idx)
        sel_i = torch.gather(corr_i[b], 1, idx)
        alpha = (th - th0) + math.pi * (fd - fd0) * p.t_ms
        advance = 2.0 * math.pi * (fd * p.t_ms + off_frac)
        state, outs[b] = _step(state, sel_r, sel_i, cp_int, advance, alpha, p)
    names = ("code_phase", "carrier_phase", "doppler", "ema_err", "ema_err_sq", "ema_quality",
             "step_count", "lost")
    fin = dict(zip(names, state))
    fin["carrier_offset"] = off
    return fin, outs


def track_blocks(config: dict, blocks: list[dict], precision: str = "bf16"):
    """Track each block from its own starting carry. ``blocks``: dicts of
    ``samples`` [B, N, L, 2] int8, ``carry`` ({field: [S] tensor}) and
    ``replicas`` [S, L]. Phase 1 runs block by block; the loop filter runs
    once over the blocks' channels side by side. Returns [(carry after,
    outputs [B, N_OUT, S])] in the order given."""
    loop = Loop.from_config(config)
    parts = [correlate(b["samples"], b["carry"], b["replicas"], loop, precision) for b in blocks]
    sizes = [c.shape[0] for c, _, _ in parts]
    carry = {k: torch.cat([b["carry"][k].to(torch.float32) for b in blocks])
             for k in blocks[0]["carry"]}
    fin, outs = loop_filter(carry, torch.cat([c for c, _, _ in parts]),
                            torch.cat([r for _, r, _ in parts], dim=1),
                            torch.cat([i for _, _, i in parts], dim=1), loop)
    result, start = [], 0
    for n in sizes:
        part = slice(start, start + n)
        result.append(({k: v[part] for k, v in fin.items()}, outs[:, :, part]))
        start += n
    return result

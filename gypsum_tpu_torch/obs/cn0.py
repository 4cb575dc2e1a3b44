"""Carrier-to-noise-density (C/N0) estimation from prompt correlations.

The reference's only signal-quality notion is its lock heuristics
(reference: gypsum/tracker.py:157-203); it never estimates C/N0 — the
standard receiver figure of merit (dB-Hz) that drives cross-receiver
comparability, mask decisions, and measurement weighting. Here C/N0 is
estimated host-side from each block's 1 ms prompt stream with the
moment-method (M2M4) estimator, which needs no data wipeoff (BPSK nav bits
cancel in even moments):

    M2 = E[|p|^2],  M4 = E[|p|^4]
    Pd = sqrt(2 M2^2 - M4)     (signal power)
    Pn = M2 - Pd               (noise power in the 1 kHz prompt bandwidth)
    C/N0 = (Pd / Pn) / T_coh   with T_coh = 1 ms  ->  dB-Hz

The estimate feeds the per-satellite sigma used by the protection levels
(solve/integrity.py): sigma scales as 1 / sqrt(C/N0 * T) in the
code-tracking regime, anchored to the configured sigma at a nominal C/N0.
"""

from __future__ import annotations

import numpy as np


def cn0_m2m4_dbhz(prompts: np.ndarray, t_coh_s: float = 1e-3) -> float | None:
    """M2M4 C/N0 estimate over a block's complex prompt correlations.

    Returns None when the estimator is outside its validity region (signal
    indistinguishable from noise — M4 > 2 M2^2)."""
    p = np.asarray(prompts)
    if p.size < 50:
        return None
    m2 = float(np.mean(np.abs(p) ** 2))
    m4 = float(np.mean(np.abs(p) ** 4))
    pd_sq = 2.0 * m2 * m2 - m4
    if pd_sq <= 0.0 or m2 <= 0.0:
        return None
    pd = float(np.sqrt(pd_sq))
    pn = m2 - pd
    if pn <= 0.0:
        # Effectively noise-free (synthetic captures): report a ceiling
        # rather than +inf.
        return 60.0
    ratio = pd / pn / t_coh_s
    if ratio <= 0.0:
        return None
    return float(10.0 * np.log10(ratio))


# Nominal anchor for C/N0-driven measurement weighting: at 45 dB-Hz a
# modern receiver's code noise is roughly the solver's configured
# pseudorange sigma; thermal code noise scales as 1/sqrt(C/N0).
NOMINAL_CN0_DBHZ = 45.0
# Clamp: below ~25 dB-Hz tracking is about to drop anyway; above ~55 the
# sigma is floored by multipath/quantization, not thermal noise.
_CN0_CLAMP = (25.0, 55.0)


def sigma_from_cn0(
    cn0_dbhz: float | None, nominal_sigma_m: float
) -> float:
    """Scale the configured pseudorange sigma by measured signal quality."""
    if cn0_dbhz is None:
        return 4.0 * nominal_sigma_m  # unknown quality: be conservative
    c = float(np.clip(cn0_dbhz, *_CN0_CLAMP))
    return nominal_sigma_m * 10.0 ** ((NOMINAL_CN0_DBHZ - c) / 20.0)

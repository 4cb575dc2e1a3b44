"""Blind power-inversion CRPA beamforming (spatial jammer nulling).

Port of gypsum_tpu/ops/beamform.py. GPS signals sit ~20 dB below the
thermal floor, so an antenna array's spatial covariance R = E[x x^H] is
noise + jammer only. Minimizing the array output power subject to a unit
response on the reference element,

    w = R^{-1} e_0 / (e_0^H R^{-1} e_0),

steers nulls onto every above-the-floor interferer while leaving the
sub-floor satellites essentially untouched: no steering vectors, no
calibration, no knowledge of the jammer. An N-element array nulls up to
N-1 simultaneous jammers, including the broadband kind the STFT notch
(ops/interference.py) cannot touch without erasing the GPS band.

Where the work runs: the N x N covariance over a 65 536-sample snapshot,
the solve and the MUSIC grid are small and stay float64 on the host, as in
the JAX package. The stream contraction y = conj(w) . x ([N] x [N, T]
complex64, 1.5 GB for a 23 s 4-element capture) runs on the device
(``apply_weights_torch``): chunks uploaded, contracted, downloaded, so no
more than one chunk of the input and its output is on the card at a time.
``apply_weights`` is the numpy contraction, the plain version the tests
hold it to.
"""

from __future__ import annotations

import numpy as np
import torch

from gypsum_tpu_torch.core.device import resolve_device

_EPS = 1e-12


def spatial_covariance(x: np.ndarray, diagonal_loading: float = 0.02) -> np.ndarray:
    """R = x x^H / T over an [N, T] snapshot, with diagonal loading
    ``diagonal_loading * tr(R)/N``.

    The loading does two jobs: invertibility at short snapshots, and a
    null-depth floor — sources below ~the loading level relative to the
    total power are NOT worth a degree of freedom, so the minimizer leaves
    them (and w stays ~e_0, a transparent pass-through). Real GPS signals
    sit ~20 dB under the thermal floor and are untouchable at any loading;
    the 2% default also protects the hotter-than-life synthetic fixtures
    while costing a 26 dB jammer under 1 dB of null depth."""
    x = np.asarray(x)
    n, t = x.shape
    r = (x @ x.conj().T) / max(t, 1)
    return r + (diagonal_loading * np.trace(r).real / n) * np.eye(n)


def power_inversion_weights(
    r: np.ndarray, reference_element: int = 0
) -> np.ndarray:
    """Minimum-power weights with a distortionless constraint on the
    reference element. Returns w [N] complex128; output = w^H x."""
    n = r.shape[0]
    e0 = np.zeros(n, dtype=np.complex128)
    e0[reference_element] = 1.0
    ri = np.linalg.solve(np.asarray(r, np.complex128), e0)
    return ri / (e0.conj() @ ri + _EPS)


def apply_weights(x: np.ndarray, w: np.ndarray, chunk: int = 2_000_000) -> np.ndarray:
    """y[t] = sum_e conj(w[e]) x[e, t], chunked (x can be hundreds of MB)."""
    x = np.asarray(x)
    wc = np.conj(np.asarray(w, np.complex128)).astype(x.dtype)
    out = np.empty(x.shape[1], dtype=x.dtype)
    for lo in range(0, x.shape[1], chunk):
        hi = min(lo + chunk, x.shape[1])
        out[lo:hi] = wc @ x[:, lo:hi]
    return out


def contract(w_conj: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y[t] = sum_e w_conj[e] x[e, t] for [N] and [N, T] complex64 tensors,
    the N products summed in element order."""
    y = w_conj[0] * x[0]
    for e in range(1, x.shape[0]):
        y = y + w_conj[e] * x[e]
    return y


def apply_weights_torch(
    x: np.ndarray, w: np.ndarray, device: str | torch.device = "cuda",
    chunk: int = 2_000_000,
) -> np.ndarray:
    """``apply_weights`` on ``device``: y[t] = sum_e conj(w[e]) x[e, t],
    contracted in complex64 by :func:`contract`.

    On the card the [N, chunk] slabs go up and their outputs come down
    through two pinned staging buffers in turn: the host copies slab i + 1
    into one while the card uploads, contracts and downloads slab i from the
    other, so no more than two slabs are on the card at a time. The host's
    copies into and out of the staging buffers are torch copies, which run
    on the host's threads: they, not the card, bound the call."""
    x = np.asarray(x, dtype=np.complex64)
    dev = resolve_device(device)
    n_el, n_t = x.shape
    wc = torch.from_numpy(np.conj(np.asarray(w, np.complex128)).astype(np.complex64)).to(dev)
    out = np.empty(n_t, dtype=np.complex64)
    if dev.type == "cpu":
        for lo in range(0, n_t, chunk):
            out[lo : lo + chunk] = contract(wc, torch.from_numpy(x[:, lo : lo + chunk])).numpy()
        return out
    width = min(chunk, n_t)
    stage = [torch.empty((n_el, width), dtype=torch.complex64, pin_memory=True) for _ in range(2)]
    back = [torch.empty(width, dtype=torch.complex64, pin_memory=True) for _ in range(2)]
    pending: list = [None, None]  # per buffer: (event after its download, lo, hi)

    def drain(k: int) -> None:
        event, lo, hi = pending[k]
        event.synchronize()
        torch.from_numpy(out[lo:hi]).copy_(back[k][: hi - lo])
        pending[k] = None

    for i, lo in enumerate(range(0, n_t, chunk)):
        k = i % 2
        hi = min(lo + chunk, n_t)
        if pending[k] is not None:  # the buffer's last slab is done with
            drain(k)
        stage[k][:, : hi - lo].copy_(torch.from_numpy(x[:, lo:hi]))
        y = contract(wc, stage[k][:, : hi - lo].to(dev, non_blocking=True))
        back[k][: hi - lo].copy_(y, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        pending[k] = (event, lo, hi)
    for k in (0, 1):
        if pending[k] is not None:
            drain(k)
    return out


def estimate_doa(
    r: np.ndarray,
    elements_enu: np.ndarray,
    n_sources: int | None = None,
    az_step_deg: float = 2.0,
    el_step_deg: float = 2.0,
    el_max_deg: float = 80.0,
    wavelength_m: float | None = None,
) -> list[tuple[float, float, float]]:
    """MUSIC direction-of-arrival of the above-floor interferers.

    Eigendecompose the (unloaded) spatial covariance; eigenvalues well above
    the noise cluster count the sources, their orthogonal complement is the
    noise subspace E_n, and the MUSIC pseudospectrum
    ``P(az, el) = 1 / |E_n^H a(az, el)|^2`` peaks where a steering vector is
    orthogonal to it. Returns up to ``n_sources`` (auto from the eigen-gap
    when None) peaks as (azimuth_deg, elevation_deg, power_db), strongest
    first — so an interference/spoofing alert can carry a BEARING, not just
    a detection (reference: no counterpart at any level).

    A planar (horizontal) array cannot resolve the sign of elevation and
    blurs elevation near zenith; azimuth is the robust coordinate."""
    from gypsum_tpu_torch.signal.array import L1_WAVELENGTH_M, direction_enu

    lam = wavelength_m or L1_WAVELENGTH_M
    elements = np.asarray(elements_enu, np.float64)
    n = r.shape[0]
    vals, vecs = np.linalg.eigh(np.asarray(r, np.complex128))
    floor = np.median(vals.real)
    k = int(np.sum(vals.real > 10.0 * floor)) if n_sources is None else n_sources
    k = max(0, min(k, n - 1))
    if k == 0:
        return []
    e_noise = vecs[:, : n - k]  # eigh sorts ascending

    azs = np.arange(0.0, 360.0, az_step_deg)
    els = np.arange(0.0, el_max_deg + 1e-9, el_step_deg)
    spec = np.empty((len(azs), len(els)))
    for i, az in enumerate(azs):
        for j, el in enumerate(els):
            a = np.exp(2j * np.pi * (elements @ direction_enu(az, el)) / lam)
            a /= np.sqrt(n)
            denom = np.sum(np.abs(e_noise.conj().T @ a) ** 2)
            spec[i, j] = 1.0 / max(denom, _EPS)

    peaks: list[tuple[float, float, float]] = []
    flat = spec.copy()
    for _ in range(k):
        i, j = np.unravel_index(np.argmax(flat), flat.shape)
        peaks.append((float(azs[i]), float(els[j]), float(10 * np.log10(spec[i, j]))))
        # Exclude a neighborhood around the taken peak (wraparound az).
        d_az = np.abs((azs[:, None] - azs[i] + 180.0) % 360.0 - 180.0)
        d_el = np.abs(els[None, :] - els[j])
        flat[(d_az < 20.0) & (d_el < 20.0)] = 0.0
    return peaks


def null_jammers(
    x: np.ndarray,
    snapshot_samples: int = 65536,
    diagonal_loading: float = 0.02,
    reference_element: int = 0,
    device: str | torch.device = "cuda",
) -> tuple[np.ndarray, np.ndarray, float]:
    """One-call CRPA front end: estimate R from the stream's head (host),
    form the power-inversion weights (host), apply them to the whole stream
    on ``device``.

    Returns (y [T], w [N], suppression_db) — suppression is the output vs
    reference-element excess-power ratio over the snapshot (0 dB means no
    above-floor interferer was present)."""
    dev = resolve_device(device)
    x = np.asarray(x)
    snap = x[:, : min(snapshot_samples, x.shape[1])]
    r = spatial_covariance(snap, diagonal_loading)
    w = power_inversion_weights(r, reference_element)
    y = apply_weights_torch(x, w, dev)
    p_ref = float(np.mean(np.abs(snap[reference_element]) ** 2))
    p_out = float(np.mean(np.abs(y[: snap.shape[1]]) ** 2))
    suppression_db = 10.0 * np.log10(max(p_ref, _EPS) / max(p_out, _EPS))
    return y, w, suppression_db

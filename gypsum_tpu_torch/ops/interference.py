"""Narrowband interference detection and excision (STFT notch).

Port of gypsum_tpu/ops/interference.py. GPS L1 C/A rides ~20 dB below the
thermal floor, so any spectral line visible above the noise is hostile (a
CW or narrowband jammer, a harmonic, a DC offset). Detection averages the
power spectrum over the frames of a block and flags bins above a multiple
of the median bin; excision zeroes the flagged bins (dilated by a guard
band) frame by frame: cos^4 (Hann-squared) windowed frames at 75 % overlap,
FFT, mask, inverse FFT, overlap-add, divide by 3/2 (the periodic Hann^2
window overlap-adds to exactly 3/2 at a quarter-frame hop, so unmasked
content reconstructs identically).

Two implementations of the same math:
- ``stft_notch_np``: numpy, the JAX package's host version, kept as the
  reference the tests hold the device version to;
- ``make_stft_notch``: torch on float32 I/Q planes on a device, the
  counterpart of ``make_stft_notch_jax``. ``io.sources.NotchingSampleSource``
  runs it on the card: a block is 2007 frames x 4096 points at 2.046 Msps,
  a 66 MB complex64 working set with a forward and an inverse FFT.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from gypsum_tpu_torch.core.device import resolve_device

__all__ = [
    "NotchReport",
    "StftNotch",
    "detect_mask",
    "make_stft_notch",
    "stft_notch_np",
]


@dataclass(frozen=True)
class NotchReport:
    detected: bool
    n_bins: int  # masked bins (after guard dilation)
    fraction: float  # n_bins / nfft — the broadband SNR cost of excision
    peak_over_median_db: float  # detection statistic
    freqs_hz: tuple[float, ...] = field(default_factory=tuple)  # masked centers


#: Overlap-add constant of the cos^4 window at hop = nfft/4.
_COLA_SUM = 1.5


def _window(nfft: int) -> np.ndarray:
    # Periodic Hann^2 (cos^4): at hop = nfft/4 the four phase shifts cancel
    # both its cosine terms, so it overlap-adds to exactly 3/2.
    h = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(nfft) / nfft))
    return h * h


def _frame_starts(n_padded: int, nfft: int, hop: int) -> np.ndarray:
    return np.arange(0, n_padded - nfft + 1, hop)


def detect_mask(
    power_mean: np.ndarray, threshold: float, guard_bins: int
) -> tuple[np.ndarray, float]:
    """Flag bins whose frame-averaged power exceeds ``threshold`` x the
    median bin, dilated by ``guard_bins`` on each side (windowing leakage
    shoulders of a strong line). Returns (bool mask [nfft], peak/median)."""
    med = float(np.median(power_mean))
    ratio = power_mean / max(med, 1e-30)
    mask = ratio > threshold
    if guard_bins > 0 and mask.any():
        k = np.ones(2 * guard_bins + 1)
        mask = np.convolve(mask.astype(np.float64), k, mode="same") > 0.5
    return mask, float(ratio.max())


def stft_notch_np(
    iq: np.ndarray,
    sample_rate: float,
    nfft: int = 4096,
    threshold: float = 8.0,
    guard_bins: int = 3,
    max_fraction: float = 0.05,
) -> tuple[np.ndarray, NotchReport]:
    """Detect + excise narrowband interference from one block of IQ.

    Returns ``(clean_iq, report)``; the input comes back untouched when
    nothing is detected, or when the mask would cover more than
    ``max_fraction`` of the band (a "notch" that wide is wideband
    interference — excision would cost more signal than it saves, so it is
    reported but not applied)."""
    x = np.asarray(iq)
    n = len(x)
    hop = nfft // 4
    w = _window(nfft).astype(np.float32)

    pad = nfft
    xp = np.concatenate([np.zeros(pad, x.dtype), x, np.zeros(pad + nfft, x.dtype)])
    starts = _frame_starts(len(xp), nfft, hop)
    frames = xp[starts[:, None] + np.arange(nfft)[None, :]] * w[None, :]
    spec = np.fft.fft(frames, axis=1)
    # Detection averages only frames fully inside the block: frames that
    # straddle the zero-padded edges see the interferer truncated (broadband
    # splatter) and would smear the mask several bins wider than the true
    # line. (The edge frames are still cleaned through the same mask; the
    # residual edge transient is ~1 frame per block end.)
    interior = (starts >= pad) & (starts + nfft <= pad + n)
    power = np.mean(np.abs(spec[interior]) ** 2, axis=0)

    mask, peak = detect_mask(power, threshold, guard_bins)
    n_bins = int(mask.sum())
    freqs = np.fft.fftfreq(nfft, 1.0 / sample_rate)
    report = NotchReport(
        detected=bool(n_bins),
        n_bins=n_bins,
        fraction=n_bins / nfft,
        peak_over_median_db=10.0 * np.log10(max(peak, 1e-30)),
        freqs_hz=tuple(float(f) for f in freqs[mask][:16]),
    )
    if not report.detected or report.fraction > max_fraction:
        return x, report

    spec[:, mask] = 0.0
    clean_frames = np.fft.ifft(spec, axis=1)
    y = np.zeros(len(xp), dtype=np.complex128)
    np.add.at(y, starts[:, None] + np.arange(nfft)[None, :], clean_frames)
    return (y[pad : pad + n] / _COLA_SUM).astype(x.dtype), report


def _median(x: torch.Tensor) -> torch.Tensor:
    """The median as numpy and JAX take it: the mean of the two middle
    values of an even count (``torch.median`` returns the lower one, which
    would raise every ratio and flag bins the reference does not)."""
    s = torch.sort(x).values
    n = s.shape[0]
    if n % 2:
        return s[n // 2]
    return (s[n // 2 - 1] + s[n // 2]) * 0.5


class StftNotch:
    """The STFT notch for blocks of ``n_samples`` on ``device`` (build it
    with :func:`make_stft_notch`).

    ``notch(planes [2, n]) -> (planes [2, n], stats [3])`` is the
    counterpart of ``make_stft_notch_jax``'s function: stats = (masked bins,
    peak-over-median ratio, applied 0/1), and a block that is not excised
    comes back bit-identical, chosen on the device without a host sync.
    ``detect`` and ``excise`` are its two halves for a caller that reads the
    decision on the host first and skips the inverse FFT when it is no.

    Overlap-add without atomics: frame f starts at f * hop and its four
    quarter-frame chunks land on output chunks f .. f + 3, so the output is
    the sum of four shifted [F, hop] slabs, added in the order numpy's
    ``np.add.at`` adds them (frame order). Two runs are equal to the bit."""

    def __init__(self, n_samples: int, sample_rate: float, nfft: int, threshold: float,
                 guard_bins: int, max_fraction: float, device: torch.device) -> None:
        if nfft % 4:
            raise ValueError(f"nfft must be a multiple of 4 (hop = nfft / 4), got {nfft}")
        self.n_samples = int(n_samples)
        self.nfft = int(nfft)
        self.hop = self.nfft // 4
        self.pad = self.nfft
        self.threshold = float(threshold)
        self.guard_bins = int(guard_bins)
        self.max_fraction = float(max_fraction)
        self.device = device
        n_padded = self.n_samples + 2 * self.pad + self.nfft
        starts = _frame_starts(n_padded, self.nfft, self.hop)
        self.n_frames = len(starts)
        interior = np.flatnonzero(
            (starts >= self.pad) & (starts + self.nfft <= self.pad + self.n_samples))
        # Interior frames are consecutive: a slice of the frame axis.
        self.interior = (slice(int(interior[0]), int(interior[-1]) + 1) if len(interior)
                         else slice(0, 0))
        self.window = torch.from_numpy(_window(self.nfft).astype(np.float32)).to(device)
        self.freqs_hz = np.fft.fftfreq(self.nfft, 1.0 / sample_rate)

    def detect(self, x: torch.Tensor):
        """x [n] complex64 -> (spectra [F, nfft], mask [nfft] float32, stats [3])."""
        padded = F.pad(x, (self.pad, self.pad + self.nfft))
        frames = padded.unfold(0, self.nfft, self.hop) * self.window  # [F, nfft]
        spec = torch.fft.fft(frames, dim=1)
        power = torch.mean(torch.abs(spec[self.interior]) ** 2, dim=0)
        ratio = power / torch.clamp(_median(power), min=1e-30)
        mask = (ratio > self.threshold).to(torch.float32)
        if self.guard_bins > 0:
            g = self.guard_bins
            mask = F.max_pool1d(mask[None, None], 2 * g + 1, stride=1, padding=g)[0, 0]
        n_bins = mask.sum()
        apply = (n_bins > 0) & (n_bins <= self.max_fraction * self.nfft)
        return spec, mask, torch.stack([n_bins, ratio.max(), apply.to(torch.float32)])

    def excise(self, spec: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """The masked spectra back to the [n] complex64 block."""
        clean = torch.fft.ifft(spec * (1.0 - mask), dim=1)  # [F, nfft]
        chunks = clean.reshape(self.n_frames, 4, self.hop)
        y = torch.zeros((self.n_frames + 3, self.hop), dtype=clean.dtype, device=clean.device)
        for j in (3, 2, 1, 0):  # chunk c sums frames c-3 .. c, in frame order
            y[j : j + self.n_frames] += chunks[:, j]
        return y.reshape(-1)[self.pad : self.pad + self.n_samples] / _COLA_SUM

    def __call__(self, planes: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = torch.complex(planes[0], planes[1])
        spec, mask, stats = self.detect(x)
        out = torch.where(stats[2] > 0, self.excise(spec, mask), x)
        return torch.stack([out.real, out.imag]), stats

    def report(self, mask: np.ndarray, stats: np.ndarray) -> NotchReport:
        """The host report (``stft_notch_np``'s) of one block from its mask
        and stats, both read back from the device."""
        mask = mask > 0.5
        n_bins = int(stats[0])
        return NotchReport(
            detected=bool(n_bins),
            n_bins=n_bins,
            fraction=n_bins / self.nfft,
            peak_over_median_db=10.0 * np.log10(max(float(stats[1]), 1e-30)),
            freqs_hz=tuple(float(f) for f in self.freqs_hz[mask][:16]),
        )


def make_stft_notch(
    n_samples: int,
    sample_rate: float,
    nfft: int = 4096,
    threshold: float = 8.0,
    guard_bins: int = 3,
    max_fraction: float = 0.05,
    device: str | torch.device = "cuda",
) -> StftNotch:
    """The torch counterpart of ``make_stft_notch_jax`` on ``device``:
    ``fn(planes [2, n_samples] float32) -> (planes_clean, stats [3])`` with
    stats = (n_masked_bins, peak_over_median_ratio, applied 0/1)."""
    return StftNotch(n_samples, sample_rate, nfft, threshold, guard_bins, max_fraction,
                     resolve_device(device))

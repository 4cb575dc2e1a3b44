"""Streaming IQ sample sources.

Reference parity: gypsum/antenna_sample_provider.py + gypsum/radio_input.py,
re-designed for block-based device dispatch:

- sources deliver whole [n_ms, samples_per_prn] blocks (one tracker dispatch),
  not 1 ms python ticks;
- recordings are described by a JSON sidecar (``<capture>.json``) instead of a
  hard-coded in-code registry (the reference requires editing
  radio_input.py:101-111 to add an input);
- the file reader deinterleaves I/Q per block through the native C++
  reader (io/native.py, native/iqreader.cpp), which converts the next block
  on a worker thread while the device works on this one; the plain numpy
  conversion (``convert_numpy``) is the reference it is held to;
- the decimating front end (DecimatingSampleSource) filters on the device:
  integer ratios through the hand-written decimation kernel
  (ops/fir_decimate.py), rational ratios through the plain polyphase
  resampler (ops/decimate.py);
- the notching front end (NotchingSampleSource) runs the STFT notch on the
  device (ops/interference.py), numpy blocks in and out.
"""

from __future__ import annotations

import json
import logging
from abc import ABC, abstractmethod
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from gypsum_tpu_torch.core.constants import PRN_REPETITIONS_PER_SECOND
from gypsum_tpu_torch.core.events import NoMoreSamplesError
from gypsum_tpu_torch.io.native import NativeIqReader

_logger = logging.getLogger(__name__)

_DTYPE_NAMES = {
    "float32": np.float32,
    "int16": np.int16,
    "int8": np.int8,
    "uint8": np.uint8,
}


@dataclass(frozen=True)
class StreamAttributes:
    """reference: gypsum/antenna_sample_provider.py:24-28."""

    sample_rate: float
    samples_per_prn: int


@dataclass(frozen=True)
class RecordingInfo:
    """Metadata describing a raw interleaved-IQ capture."""

    path: Path
    sample_rate: float
    component_dtype: type = np.float32  # per I/Q component
    # DC offset applied to integer formats (e.g. 127.5 for rtl-sdr uint8).
    component_offset: float = 0.0
    utc_start_time: float = 0.0

    @classmethod
    def from_sidecar(cls, capture_path: str | Path) -> "RecordingInfo":
        """Load ``<capture>.json`` written next to the capture file:
        {"sample_rate": 2046000.0, "dtype": "float32", "offset": 0.0}."""
        capture_path = Path(capture_path)
        sidecar = capture_path.with_suffix(capture_path.suffix + ".json")
        if not sidecar.exists():
            raise FileNotFoundError(
                f"no metadata sidecar {sidecar}; describe the capture with "
                '{"sample_rate": ..., "dtype": "float32|int16|int8|uint8"}'
            )
        meta = json.loads(sidecar.read_text())
        return cls(
            path=capture_path,
            sample_rate=float(meta["sample_rate"]),
            component_dtype=_DTYPE_NAMES[meta.get("dtype", "float32")],
            component_offset=float(meta.get("offset", 0.0)),
            utc_start_time=float(meta.get("utc_start_time", 0.0)),
        )

    @classmethod
    def gnu_radio_2x(cls, path: str | Path) -> "RecordingInfo":
        """GNU Radio float32 recording at 2.046 Msps (the reference's primary
        format, gypsum/radio_input.py:45-60)."""
        return cls(path=Path(path), sample_rate=2.046e6)

    @classmethod
    def gnu_radio_8x(cls, path: str | Path) -> "RecordingInfo":
        """GNU Radio float32 at 8.184 Msps (HackRF capture rate the reference
        declares but cannot process, gypsum/radio_input.py:62-76; here the
        decimating front end makes it usable)."""
        return cls(path=Path(path), sample_rate=8.184e6)

    @classmethod
    def gnu_radio_16x(cls, path: str | Path) -> "RecordingInfo":
        """GNU Radio float32 at 16.368 Msps (gypsum/radio_input.py:78-92)."""
        return cls(path=Path(path), sample_rate=16.368e6)

    @classmethod
    def rtl_sdr(cls, path: str | Path, sample_rate: float = 2.046e6) -> "RecordingInfo":
        """Raw rtl_sdr capture: interleaved uint8 I/Q biased at 127.5."""
        return cls(
            path=Path(path),
            sample_rate=sample_rate,
            component_dtype=np.uint8,
            component_offset=127.5,
        )

    @classmethod
    def hackrf(cls, path: str | Path, sample_rate: float = 8.184e6) -> "RecordingInfo":
        """hackrf_transfer capture: interleaved signed int8 I/Q."""
        return cls(path=Path(path), sample_rate=sample_rate, component_dtype=np.int8)


# Named-format registry (the analogue of the reference's INPUT_SOURCES list +
# get_input_source_by_file_name, gypsum/radio_input.py:101-125 — but keyed by
# *format*, with the capture path free, instead of hard-coding vendored file
# names in code).
RECORDING_FORMATS = {
    "gnu_radio_2x": RecordingInfo.gnu_radio_2x,
    "gnu_radio_8x": RecordingInfo.gnu_radio_8x,
    "gnu_radio_16x": RecordingInfo.gnu_radio_16x,
    "rtl_sdr": RecordingInfo.rtl_sdr,
    "hackrf": RecordingInfo.hackrf,
}


def recording_info_for(format_name: str, path: str | Path) -> "RecordingInfo":
    """Look up a capture format by name (gypsum/radio_input.py:114-125)."""
    try:
        factory = RECORDING_FORMATS[format_name]
    except KeyError:
        raise KeyError(
            f"unknown recording format {format_name!r}; known: "
            f"{sorted(RECORDING_FORMATS)}"
        ) from None
    return factory(path)


class SampleSource(ABC):
    """Block-oriented IQ stream (reference ABC:
    gypsum/antenna_sample_provider.py:38-53)."""

    @property
    @abstractmethod
    def attributes(self) -> StreamAttributes: ...

    @abstractmethod
    def read_block(self, n_ms: int) -> tuple[float, np.ndarray]:
        """Consume ``n_ms`` milliseconds; returns (start_timestamp_s,
        [n_ms, samples_per_prn] complex64). Raises NoMoreSamplesError when
        the stream cannot fill a whole block."""

    @abstractmethod
    def peek_block(self, n_ms: int) -> tuple[float, np.ndarray]:
        """Like read_block without consuming."""

    @property
    @abstractmethod
    def seconds_consumed(self) -> float: ...

    def read_block_quantized(self, n_ms: int):
        """Consume ``n_ms`` milliseconds WITHOUT dequantizing: returns
        (start_timestamp_s, planes [n_ms, samples_per_prn, 2] in the
        capture's integer dtype, component_offset) when the underlying
        format is integer-quantized, else None (caller falls back to
        read_block).

        Rationale: shipping rtl-sdr uint8 / hackrf int8 words raw and
        dequantizing on the device moves 4x less across the host->device
        boundary than float32 planes."""
        return None


class ArraySampleSource(SampleSource):
    """In-memory IQ (synthetic captures, tests)."""

    def __init__(self, iq: np.ndarray, sample_rate: float) -> None:
        self._iq = np.ascontiguousarray(iq, dtype=np.complex64)
        self._rate = float(sample_rate)
        self._spp = int(round(sample_rate / PRN_REPETITIONS_PER_SECOND))
        self._cursor = 0

    @property
    def attributes(self) -> StreamAttributes:
        return StreamAttributes(self._rate, self._spp)

    @property
    def seconds_consumed(self) -> float:
        return self._cursor / self._rate

    def peek_block(self, n_ms: int) -> tuple[float, np.ndarray]:
        n = n_ms * self._spp
        if self._cursor + n > len(self._iq):
            raise NoMoreSamplesError(
                f"exhausted at {self.seconds_consumed:.3f}s"
            )
        ts = self._cursor / self._rate
        return ts, self._iq[self._cursor : self._cursor + n].reshape(n_ms, self._spp)

    def read_block(self, n_ms: int) -> tuple[float, np.ndarray]:
        ts, block = self.peek_block(n_ms)
        self._cursor += n_ms * self._spp
        return ts, block


def convert_numpy(words: np.ndarray, start: int, count: int, offset: float) -> np.ndarray:
    """The plain version of the native reader's conversion: ``count`` complex
    samples from ``start`` of the interleaved I/Q ``words``, as float32 less
    ``offset``, in complex64. The tests and chip_smoke.py hold the reader to
    it, to the bit."""
    f = words[2 * start : 2 * (start + count)].astype(np.float32)
    if offset:
        f = f - np.float32(offset)
    out = np.empty(count, dtype=np.complex64)
    out.real = f[0::2]
    out.imag = f[1::2]
    return out


class FileSampleSource(SampleSource):
    """Memory-mapped interleaved-IQ capture file.

    The capture holds interleaved I/Q components (2 words per complex sample,
    reference: gypsum/antenna_sample_provider.py:100-119). Deinterleaving and
    dtype conversion happen per block in the native reader (io/native.py);
    after each ``read_block`` the reader converts the next block of the same
    length on its worker thread. A read of any other (start, count), as a
    ``peek_block``, a decimating front end's first read or a moved cursor
    makes, is converted on the spot.
    """

    def __init__(self, info: RecordingInfo) -> None:
        self.info = info
        self._rate = float(info.sample_rate)
        self._spp = int(round(self._rate / PRN_REPETITIONS_PER_SECOND))
        self._words = np.memmap(info.path, dtype=info.component_dtype, mode="r")
        self._n_samples = len(self._words) // 2
        self._cursor = 0
        self._native = NativeIqReader(info)

    @property
    def attributes(self) -> StreamAttributes:
        return StreamAttributes(self._rate, self._spp)

    @property
    def seconds_consumed(self) -> float:
        return self._cursor / self._rate

    def _convert(self, start: int, count: int) -> np.ndarray:
        return self._native.read(start, count)

    def peek_block(self, n_ms: int) -> tuple[float, np.ndarray]:
        n = n_ms * self._spp
        if self._cursor + n > self._n_samples:
            raise NoMoreSamplesError(
                f"capture exhausted at {self.seconds_consumed:.2f}s "
                f"({self._n_samples / self._rate:.2f}s total)"
            )
        ts = self._cursor / self._rate
        return ts, self._convert(self._cursor, n).reshape(n_ms, self._spp)

    def read_block(self, n_ms: int) -> tuple[float, np.ndarray]:
        ts, block = self.peek_block(n_ms)
        self._cursor += n_ms * self._spp
        # Streaming reads are sequential and their length is stable: convert
        # the next block on the C++ worker thread while the device computes.
        self._native.prefetch(self._cursor, n_ms * self._spp)
        return ts, block

    def read_block_quantized(self, n_ms: int):
        if self.info.component_dtype not in (np.int8, np.uint8, np.int16):
            return None
        n = n_ms * self._spp
        if self._cursor + n > self._n_samples:
            raise NoMoreSamplesError(
                f"capture exhausted at {self.seconds_consumed:.2f}s "
                f"({self._n_samples / self._rate:.2f}s total)"
            )
        ts = self._cursor / self._rate
        # Interleaved words -> [n_ms, L, 2] is a pure reshape (zero copy of
        # the memmap window aside from the materializing np.array).
        words = np.array(self._words[2 * self._cursor : 2 * (self._cursor + n)])
        planes = words.reshape(n_ms, self._spp, 2)
        self._cursor += n
        return ts, planes, float(self.info.component_offset)


def resampling_ratio(in_rate: float, out_rate: float) -> tuple[int, int]:
    """(up, down), coprime: out_rate = in_rate * up / down. ``up == 1`` is an
    integer decimation, which runs through the decimation kernel (K5)."""
    from fractions import Fraction

    ratio = Fraction(int(round(out_rate)), int(round(in_rate)))
    return ratio.numerator, ratio.denominator


class DecimatingSampleSource(SampleSource):
    """Resampling front end: wraps a raw-rate source and delivers blocks at
    the processing rate (rational ratio up/down, e.g. 10 Msps -> 2.046 Msps =
    x 1023/5000; integer decimation is up=1).

    Streaming continuity across blocks is exact: each output block k covers
    raw samples [k*B_raw, (k+1)*B_raw) plus a filter-history prefix whose
    length is chosen so the polyphase phase alignment of the resampler
    (ops/decimate.py) is identical every block.

    The filter runs on ``device``. With ``up == 1`` it goes through
    ``ops/fir_decimate.py:fir_decimate``, which launches the hand-written
    decimation kernel on a CUDA device (with the taps reversed: the kernel
    convolves, as the TPU kernel does, and this source correlates, as the
    JAX package's source does); a rational ratio runs the plain
    polyphase resampler there; an integer decimation on a CUDA device starts
    the kernel's preload when the source opens (``core/aot.py``). The
    ``SampleSource`` contract hands numpy blocks to the receiver (which reads
    them on the host for acquisition and uploads them for tracking), so each
    block's raw samples cross to the device and its decimated samples come
    back.
    """

    def __init__(
        self,
        inner: SampleSource,
        out_rate: float,
        taps: np.ndarray | None = None,
        device: str = "cuda",
    ) -> None:
        from gypsum_tpu_torch.core import aot
        from gypsum_tpu_torch.core.device import resolve_device
        from gypsum_tpu_torch.ops.decimate import decimation_filter, rational_filter
        from gypsum_tpu_torch.ops.fir_decimate import FIR_DECIMATE_KERNEL

        self.device = resolve_device(device)
        self.inner = inner
        self._out_rate = float(out_rate)
        self.up, self.down = resampling_ratio(inner.attributes.sample_rate, out_rate)
        self.libraries = (FIR_DECIMATE_KERNEL.source,) if self.up == 1 else ()
        aot.preload(self.libraries, self.device)
        if taps is None:
            taps = (
                decimation_filter(self.down)
                if self.up == 1
                else rational_filter(self.up, self.down)
            )
        self.taps = np.asarray(taps, dtype=np.float32)
        t = len(self.taps)
        # History length (raw samples): multiple of down/gcd so the local
        # conv's output grid aligns with the global one (see module notes).
        down_red = self.down  # after Fraction() up/down are already coprime
        need = -(-(t - 1) // self.up)  # ceil((T-1)/up)
        self._hist = -(-need // down_red) * down_red
        self._m_offset = self._hist * self.up // self.down
        self._tail_raw = -(-t // self.up) + 1

        self._spp_out = int(round(self._out_rate / PRN_REPETITIONS_PER_SECOND))
        self._raw_per_ms = int(round(inner.attributes.sample_rate / PRN_REPETITIONS_PER_SECOND))
        if inner.attributes.sample_rate / PRN_REPETITIONS_PER_SECOND % 1:
            raise ValueError("raw rate must be an integer number of samples per ms")
        self._buffer = np.zeros(0, dtype=np.complex64)
        self._buffer_start_raw = 0  # raw index of buffer[0]
        self._out_cursor = 0  # output samples consumed
        self._taps_device = None

    @property
    def attributes(self) -> StreamAttributes:
        return StreamAttributes(self._out_rate, self._spp_out)

    @property
    def seconds_consumed(self) -> float:
        return self._out_cursor / self._out_rate

    def _ensure_raw(self, upto_raw: int) -> None:
        missing = upto_raw - (self._buffer_start_raw + len(self._buffer))
        if missing > 0:
            # One read for all the whole milliseconds still missing (appending
            # 1 ms at a time copies the buffer once per millisecond).
            _, block = self.inner.read_block(-(-missing // self._raw_per_ms))
            self._buffer = np.concatenate([self._buffer, block.ravel()])
        # Trim history we no longer need.
        keep_from = max(0, self._out_cursor * self.down // self.up - self._hist)
        drop = keep_from - self._buffer_start_raw
        if drop > 4 * self._raw_per_ms:
            self._buffer = self._buffer[drop:]
            self._buffer_start_raw = keep_from

    def _resample(self, chunk: np.ndarray) -> np.ndarray:
        """The filter on ``self.device``: complex64 numpy in and out."""
        import torch

        from gypsum_tpu_torch.ops.decimate import resample_rational_planes
        from gypsum_tpu_torch.ops.fir_decimate import fir_decimate

        if self._taps_device is None:
            # K5 runs its taps reversed, as the TPU kernel does; the JAX
            # source's strided convolution runs them as given. Reversed once
            # here, the two compute the same.
            taps = self.taps[::-1] if self.up == 1 else self.taps
            self._taps_device = torch.from_numpy(np.ascontiguousarray(taps)).to(self.device)
        planes = torch.view_as_real(torch.from_numpy(np.ascontiguousarray(chunk))).to(self.device)
        if self.up == 1:
            y = fir_decimate(planes, self._taps_device, self.down)
        else:
            y = resample_rational_planes(planes, self._taps_device, self.up, self.down)
        return torch.view_as_complex(y.contiguous()).cpu().numpy()

    def peek_block(self, n_ms: int) -> tuple[float, np.ndarray]:
        n_out = n_ms * self._spp_out
        b_raw = n_out * self.down // self.up
        r_start = self._out_cursor * self.down // self.up
        r_end = r_start + b_raw + self._tail_raw
        self._ensure_raw(r_end)
        lo = r_start - self._hist - self._buffer_start_raw
        pad_left = max(0, -lo)
        chunk = self._buffer[max(0, lo) : r_end - self._buffer_start_raw]
        if pad_left:
            chunk = np.concatenate([np.zeros(pad_left, dtype=np.complex64), chunk])
        y = self._resample(chunk)
        out = y[self._m_offset : self._m_offset + n_out]
        ts = self._out_cursor / self._out_rate
        return ts, out.reshape(n_ms, self._spp_out)

    def read_block(self, n_ms: int) -> tuple[float, np.ndarray]:
        ts, block = self.peek_block(n_ms)
        self._out_cursor += n_ms * self._spp_out
        return ts, block


class NotchingSampleSource(SampleSource):
    """Interference-excision front end: wraps any source and removes
    narrowband interference (CW jammers, harmonics, DC ridges) from each
    block with the STFT spectral mask in ops/interference.py. Detection
    events are kept in ``events`` (stream time, NotchReport) and summarized
    by ``interference_seconds``.

    The notch runs on ``device``: each block is uploaded, transformed, and
    its mask and statistics read back; only a block that is excised goes
    through the inverse FFT and comes back down. A block with nothing to
    excise (nothing detected, or a mask wider than ``max_fraction``) is
    returned untouched. The JAX package runs the same math in numpy on the
    host (``stft_notch_np``), which the tests hold this source to.
    """

    def __init__(
        self,
        inner: SampleSource,
        nfft: int = 4096,
        threshold: float = 8.0,
        guard_bins: int = 2,
        max_fraction: float = 0.05,
        device: str = "cuda",
    ) -> None:
        from gypsum_tpu_torch.core.device import resolve_device

        self.device = resolve_device(device)
        self.inner = inner
        self.nfft = int(nfft)
        self.threshold = float(threshold)
        self.guard_bins = int(guard_bins)
        self.max_fraction = float(max_fraction)
        self.events: list[tuple[float, "object"]] = []  # (t, NotchReport)
        self.last_report = None
        self._notches: dict = {}  # block length -> StftNotch

    @property
    def attributes(self) -> StreamAttributes:
        return self.inner.attributes

    @property
    def seconds_consumed(self) -> float:
        return self.inner.seconds_consumed

    def _notch(self, n: int):
        from gypsum_tpu_torch.ops.interference import make_stft_notch

        if n not in self._notches:
            self._notches[n] = make_stft_notch(
                n, self.attributes.sample_rate, nfft=self.nfft, threshold=self.threshold,
                guard_bins=self.guard_bins, max_fraction=self.max_fraction, device=self.device)
        return self._notches[n]

    def _process(self, ts: float, block: np.ndarray, record: bool) -> np.ndarray:
        import torch

        notch = self._notch(block.size)
        x = torch.from_numpy(np.ascontiguousarray(block, dtype=np.complex64).ravel())
        spec, mask, stats = notch.detect(x.to(self.device))
        host = torch.cat([mask, stats]).cpu().numpy()  # one read-back
        stats_h = host[self.nfft :]
        report = notch.report(host[: self.nfft], stats_h)
        clean = block
        if stats_h[2] > 0:
            clean = notch.excise(spec, mask).cpu().numpy().reshape(block.shape)
        if record:
            self.last_report = report
            if report.detected:
                self.events.append((ts, report))
                _logger.info(
                    "[%7.1fs] interference: %d/%d bins %.1f dB over the "
                    "floor at %s Hz — %s",
                    ts, report.n_bins, self.nfft, report.peak_over_median_db,
                    [f"{f:.0f}" for f in report.freqs_hz[:4]],
                    "excised" if report.fraction <= self.max_fraction
                    else "TOO WIDE, passed through",
                )
        return clean

    @property
    def interference_seconds(self) -> float:
        """Stream seconds on which interference was detected (1 block ~ 1 s)."""
        return float(len(self.events))

    def peek_block(self, n_ms: int) -> tuple[float, np.ndarray]:
        ts, block = self.inner.peek_block(n_ms)
        return ts, self._process(ts, block, record=False)

    def read_block(self, n_ms: int) -> tuple[float, np.ndarray]:
        ts, block = self.inner.read_block(n_ms)
        return ts, self._process(ts, block, record=True)


class StreamBuffer:
    """Thread-safe sample buffer between an asynchronous producer (e.g. the
    RTL-SDR USB callback) and the receiver's blocking block reads, with a
    peek/read contract that holds for mixed sizes: ``peek_block`` never
    consumes, a following ``read_block`` of any size returns the peeked data
    first. Bounded: on overflow the OLDEST samples drop and the overflow
    counter records the loss (the stream is no longer gapless and trackers
    should be re-acquired)."""

    def __init__(self, capacity_samples: int) -> None:
        import threading

        self._capacity = int(capacity_samples)
        self._chunks: list[np.ndarray] = []
        self._buffered = 0
        self._pending = np.zeros(0, dtype=np.complex64)  # peeked-but-unread
        self._cond = threading.Condition()
        self.overflow_samples = 0

    def push(self, samples: np.ndarray) -> None:
        samples = np.asarray(samples, dtype=np.complex64)
        with self._cond:
            self._chunks.append(samples)
            self._buffered += len(samples)
            while self._buffered > self._capacity and self._chunks:
                dropped = self._chunks.pop(0)
                self._buffered -= len(dropped)
                self.overflow_samples += len(dropped)
            self._cond.notify_all()

    def _take(self, n: int, timeout: float) -> np.ndarray:
        out = np.empty(n, dtype=np.complex64)
        got = 0
        with self._cond:
            while got < n:
                while not self._chunks:
                    if not self._cond.wait(timeout):
                        raise TimeoutError(
                            f"no samples from the radio within {timeout}s"
                        )
                head = self._chunks[0]
                take = min(len(head), n - got)
                out[got : got + take] = head[:take]
                got += take
                if take == len(head):
                    self._chunks.pop(0)
                else:
                    self._chunks[0] = head[take:]
                self._buffered -= take
        return out

    def peek(self, n: int, timeout: float = 5.0) -> np.ndarray:
        if len(self._pending) < n:
            more = self._take(n - len(self._pending), timeout)
            self._pending = np.concatenate([self._pending, more])
        return self._pending[:n].copy()

    def read(self, n: int, timeout: float = 5.0) -> np.ndarray:
        out = self.peek(n, timeout)
        self._pending = self._pending[n:]
        return out


class RtlSdrSampleSource(SampleSource):
    """Live RTL-SDR front end (requires the optional ``pyrtlsdr`` package —
    the reference ships the dependency commented out and never implemented a
    live path, reference: requirements.in:8-10).

    librtlsdr streams continuously through the async-callback API into a
    bounded StreamBuffer on a reader thread, so consecutive blocks are
    gapless as long as the receiver keeps up (callback chunks are multiples
    of 512 bytes as USB bulk transfers require). On overflow the oldest
    samples drop and ``overflow_samples`` records the loss. Pair with
    DecimatingSampleSource for dongle rates other than 2.046 Msps.
    """

    _CALLBACK_CHUNK = 65536  # samples per async callback (131072 bytes)

    def __init__(
        self,
        sample_rate: float = 2.046e6,
        center_freq: float = 1575.42e6,
        gain: str | float = "auto",
        buffer_seconds: float = 4.0,
    ) -> None:
        try:
            from rtlsdr import RtlSdr  # type: ignore[import-not-found]
        except ImportError as exc:  # pragma: no cover - optional hardware dep
            raise RuntimeError(
                "live SDR input needs the optional 'pyrtlsdr' package "
                "(pip install pyrtlsdr) and an RTL-SDR dongle"
            ) from exc
        import threading

        self._sdr = RtlSdr()
        self._sdr.sample_rate = sample_rate
        self._sdr.center_freq = center_freq
        self._sdr.gain = gain
        self._rate = float(sample_rate)
        self._spp = int(round(self._rate / PRN_REPETITIONS_PER_SECOND))
        self._consumed = 0
        self.buffer = StreamBuffer(int(buffer_seconds * self._rate))
        self._thread = threading.Thread(
            target=self._stream, name="rtlsdr-reader", daemon=True
        )
        self._thread.start()

    def _stream(self) -> None:  # pragma: no cover - hardware
        # read_samples_async keeps the USB transfer queue running between
        # callbacks (unlike per-call sync reads, which drop samples while
        # the host computes).
        self._sdr.read_samples_async(
            lambda samples, ctx: self.buffer.push(samples), self._CALLBACK_CHUNK
        )

    @property
    def attributes(self) -> StreamAttributes:
        return StreamAttributes(self._rate, self._spp)

    @property
    def seconds_consumed(self) -> float:
        return self._consumed / self._rate

    def peek_block(self, n_ms: int) -> tuple[float, np.ndarray]:
        n = n_ms * self._spp
        return self.seconds_consumed, self.buffer.peek(n).reshape(n_ms, self._spp)

    def read_block(self, n_ms: int) -> tuple[float, np.ndarray]:
        n = n_ms * self._spp
        block = self.buffer.read(n).reshape(n_ms, self._spp)
        ts = self.seconds_consumed
        self._consumed += n
        return ts, block

    def close(self) -> None:  # pragma: no cover - hardware
        self._sdr.cancel_read_async()
        self._thread.join(timeout=2.0)
        self._sdr.close()

"""Opening a capture for the CLI (file formats and sidecars).

Port of gypsum_tpu/cli/sources.py: ``.npy`` captures and raw interleaved
captures described by a ``.json`` sidecar or a named ``--format`` (GPS L1),
and the GLONASS band front end (``_open_glonass_source``). A capture at
another rate than the band's processing rate (2.046 Msps for GPS, 4.092
Msps for GLONASS) goes through the decimating front end on the chosen
device. ``--beamform`` nulls jammers in an [elements, samples] array
capture (ops/beamform.py, the contraction on the device) and ``--notch``
excises narrowband interference after decimation (ops/interference.py, on
the device).
"""

from __future__ import annotations

import argparse
import json
import logging
import pathlib

import numpy as np

_logger = logging.getLogger("gypsum_tpu_torch")

PROCESSING_RATE = 2.046e6  # all signal processing runs at 2x the chip rate
# GLONASS L1OF band processing rate: 4092 samples per 1 ms code period keeps
# FDMA channels out to k = +/-2 inside Nyquist (signal/scenarios.py).
GLONASS_PROCESSING_RATE = 4.092e6


def _add_file_source_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--file", default=None, help="capture path (with .json sidecar) or .npy IQ")
    p.add_argument("--rtlsdr", action="store_true",
                   help="read live from an RTL-SDR dongle (needs pyrtlsdr; "
                   "tunes L1, streams via the async USB callback)")
    p.add_argument("--sample-rate", type=float, default=None,
                   help="override sample rate (else from sidecar; 2.046e6 for .npy)")
    p.add_argument("--format", default=None,
                   help="named capture format (gnu_radio_2x/8x/16x, rtl_sdr, hackrf) "
                   "instead of a sidecar (reference: radio_input.py INPUT_SOURCES)")
    p.add_argument("--notch", action="store_true",
                   help="excise narrowband interference (CW jammers, "
                        "harmonics) from each block with the STFT spectral "
                        "mask before processing (ops/interference.py)")
    p.add_argument("--beamform", action="store_true",
                   help="input is an [elements, samples] .npy antenna-array "
                        "capture (synth --array-out): null jammers — "
                        "including BROADBAND ones --notch cannot touch — "
                        "with the blind power-inversion CRPA beamformer "
                        "(ops/beamform.py), then process the single "
                        "beamformed stream normally")


def _capture_rate(path: str, sample_rate: float | None, fmt: str | None,
                  default: float) -> float | None:
    """The capture's sample rate as its source takes it: the flag, the named
    format's, the sidecar's, or ``default`` for a ``.npy`` without a sidecar
    (None for a raw capture with none of these: opening it raises)."""
    if sample_rate is not None:
        return float(sample_rate)
    if fmt and not path.endswith(".npy"):
        from gypsum_tpu_torch.io.sources import recording_info_for

        return recording_info_for(fmt, path).sample_rate
    sidecar = pathlib.Path(path + ".json")
    if sidecar.exists():
        return float(json.loads(sidecar.read_text())["sample_rate"])
    return default if path.endswith(".npy") else None


def capture_libraries(path: str, sample_rate: float | None, fmt: str | None,
                      processing_rate: float) -> list[str]:
    """The libraries that opening the capture at ``path`` loads, told from
    its name, flags and sidecar without reading it (``core/aot.py``): the
    native reader for a raw capture, K5 for an integer decimation. A rate
    that cannot be told selects no K5 here; opening the capture raises."""
    from gypsum_tpu_torch.core.aot import NATIVE_READER
    from gypsum_tpu_torch.io.sources import resampling_ratio

    names = [] if path.endswith(".npy") else [NATIVE_READER]
    try:
        rate = _capture_rate(path, sample_rate, fmt, processing_rate)
    except (OSError, ValueError, KeyError, TypeError):
        return names
    if rate and abs(rate - processing_rate) > 1e-6 and resampling_ratio(
            rate, processing_rate)[0] == 1:
        names.append("fir_decimate")
    return names


def _open_source(args):
    from gypsum_tpu_torch.io.sources import (
        ArraySampleSource,
        DecimatingSampleSource,
        FileSampleSource,
        RecordingInfo,
        recording_info_for,
    )

    if getattr(args, "rtlsdr", False):
        from gypsum_tpu_torch.io.sources import RtlSdrSampleSource

        return RtlSdrSampleSource(sample_rate=args.sample_rate or 2.046e6)
    if not args.file:
        raise SystemExit("provide --file CAPTURE or --rtlsdr")
    if args.file.endswith(".npy"):
        if getattr(args, "format", None):
            raise SystemExit(
                "--format describes raw interleaved captures; .npy files carry "
                "their own dtype (use --sample-rate or a .json sidecar for the rate)"
            )
        iq = np.load(args.file)
        rate = _capture_rate(args.file, args.sample_rate, None, PROCESSING_RATE)
        if iq.ndim == 2:
            # [N_elements, T] antenna-array capture (synth --array-out).
            if not getattr(args, "beamform", False):
                raise SystemExit(
                    f"{args.file} is an {iq.shape[0]}-element array capture; "
                    "process it with --beamform (blind power-inversion CRPA, "
                    "ops/beamform.py) or index one element out yourself"
                )
            from gypsum_tpu_torch.ops.beamform import (
                estimate_doa,
                null_jammers,
                spatial_covariance,
            )

            raw = iq
            iq, w, supp = null_jammers(raw, device=args.device)
            _logger.info(
                "beamform: power-inversion weights over %d elements, "
                "%.1f dB interference suppression (|w| = %s)",
                len(w), supp, np.round(np.abs(w), 3).tolist(),
            )
            sidecar = pathlib.Path(args.file + ".json")
            if supp > 3.0 and sidecar.exists():
                meta = json.loads(sidecar.read_text())
                if "elements_enu" in meta:
                    # Locate what was just nulled (MUSIC over the unloaded
                    # covariance): alerts with a bearing.
                    r = spatial_covariance(raw[:, :65536], diagonal_loading=0.0)
                    for az, el, p_db in estimate_doa(r, np.asarray(meta["elements_enu"])):
                        _logger.warning(
                            "interference bearing: azimuth %.0f deg, "
                            "elevation %.0f deg (MUSIC peak %.0f dB)",
                            az, el, p_db,
                        )
        elif getattr(args, "beamform", False):
            raise SystemExit("--beamform needs a 2-D [elements, samples] .npy capture")
        source = ArraySampleSource(iq, rate)
    else:
        if getattr(args, "format", None):
            info = recording_info_for(args.format, args.file)
            if args.sample_rate:
                import dataclasses

                info = dataclasses.replace(info, sample_rate=args.sample_rate)
        elif args.sample_rate:
            info = RecordingInfo(path=pathlib.Path(args.file), sample_rate=args.sample_rate)
        else:
            info = RecordingInfo.from_sidecar(args.file)
        source = FileSampleSource(info)
    # Non-native rates go through the decimating/resampling front end.
    if abs(source.attributes.sample_rate - PROCESSING_RATE) > 1e-6:
        source = DecimatingSampleSource(source, PROCESSING_RATE, device=args.device)
    if getattr(args, "notch", False):
        from gypsum_tpu_torch.io.sources import NotchingSampleSource

        source = NotchingSampleSource(source, device=args.device)
    return source


def _open_glonass_source(path: str, sample_rate: float | None, device: str):
    """The GLONASS band front end: .npy (or sidecar-described raw) capture
    at the GLONASS processing rate (decimated down to it on ``device`` if
    higher)."""
    from gypsum_tpu_torch.io.sources import (
        ArraySampleSource,
        DecimatingSampleSource,
        FileSampleSource,
        RecordingInfo,
    )

    if path.endswith(".npy"):
        rate = _capture_rate(path, sample_rate, None, GLONASS_PROCESSING_RATE)
        source = ArraySampleSource(np.load(path), rate)
    else:
        info = (
            RecordingInfo(path=pathlib.Path(path), sample_rate=sample_rate)
            if sample_rate
            else RecordingInfo.from_sidecar(path)
        )
        source = FileSampleSource(info)
    if abs(source.attributes.sample_rate - GLONASS_PROCESSING_RATE) > 1e-6:
        _logger.info(
            "decimating %.0f Hz GLONASS capture to %.0f Hz",
            source.attributes.sample_rate, GLONASS_PROCESSING_RATE,
        )
        source = DecimatingSampleSource(source, GLONASS_PROCESSING_RATE, device=device)
    return source

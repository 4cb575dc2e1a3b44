"""``acquire`` subcommand: one-shot acquisition report over 10 ms, or the
deep search over ``--deep-ms`` (acquire/deep.py), with an optional snapshot
(coarse-time) fix from the orbits in a checkpoint.

Port of gypsum_tpu/cli/acquire.py: the same flags and report lines. The
``--snapshot`` orbits come from a checkpoint of either package
(runtime/checkpoint.py:read_blob maps a JAX checkpoint's classes to the
port's without importing the JAX package).
"""

from __future__ import annotations

import numpy as np

from gypsum_tpu_torch.cli.sources import _open_glonass_source, _open_source


def _engine(args, attrs, glonass: bool):
    """(the search: IQ block -> results, its detection threshold, ms it reads)."""
    if args.deep:
        # High-sensitivity mode: grouped coherent x non-coherent integration
        # over --deep-ms of signal, ~7-10 dB below the 10 ms engine's floor.
        from gypsum_tpu_torch.acquire.deep import DeepAcquisitionEngine, deep_acquire_glonass
        from gypsum_tpu_torch.core.config import DeepAcquisitionConfig

        cfg = DeepAcquisitionConfig(total_ms=args.deep_ms)
        threshold = 1.0 + cfg.detection_k / np.sqrt(cfg.total_ms // cfg.coherent_ms)
        if glonass:
            # FDMA family: per-channel f64 pre-rotation over one shared
            # single-code engine.
            def search(block):
                return deep_acquire_glonass(block, attrs.sample_rate, attrs.samples_per_prn, cfg,
                                            device=args.device)

            return search, threshold, cfg.total_ms
        eng = DeepAcquisitionEngine(attrs.sample_rate, attrs.samples_per_prn, cfg,
                                    device=args.device)
        return eng.acquire_all, eng.detection_threshold, cfg.total_ms
    from gypsum_tpu_torch.acquire.engine import shared_acquisition_engine

    if glonass:
        from gypsum_tpu_torch.core.constants import GLONASS_L1_CHANNEL_SPACING_HZ
        from gypsum_tpu_torch.signal.prn import GLONASS_PRN_IDS, glonass_frequency_number

        eng = shared_acquisition_engine(
            attrs.sample_rate, attrs.samples_per_prn, prns=GLONASS_PRN_IDS,
            center_offsets_hz=tuple(glonass_frequency_number(p) * GLONASS_L1_CHANNEL_SPACING_HZ
                                    for p in GLONASS_PRN_IDS),
            device=args.device,
        )
    else:
        eng = shared_acquisition_engine(attrs.sample_rate, attrs.samples_per_prn,
                                        device=args.device)
    return eng.acquire_all, eng.config.detection_threshold, eng.config.integration_period_ms


def _snapshot(args, hits, sample_rate: float) -> int:
    """Coarse-time fix from this single acquisition: orbits from a
    checkpoint, coarse priors from flags (solve/snapshot.py; the reference
    must decode for ~18-30 s first)."""
    if not args.checkpoint:
        raise SystemExit("--snapshot needs --checkpoint for the orbits")
    from gypsum_tpu_torch.runtime.checkpoint import read_blob
    from gypsum_tpu_torch.solve.geodesy import ecef_to_lla, lla_to_ecef
    from gypsum_tpu_torch.solve.snapshot import (
        SnapshotMeasurement,
        orbit_fn_from_records,
        snapshot_fix,
    )

    try:
        lat, lon, alt = (float(x) for x in args.assume_lla.split(","))
    except (AttributeError, ValueError):
        raise SystemExit('--snapshot needs --assume-lla "lat,lon,alt"')
    if args.assume_tow is None:
        raise SystemExit("--snapshot needs --assume-tow (seconds of week)")
    try:
        blob = read_blob(args.checkpoint)
    except ValueError as exc:
        raise SystemExit(str(exc))
    sats = {p: rec for p, rec in blob["world"]._sats.items() if rec.has_orbit}
    meas = [
        SnapshotMeasurement(
            prn=h.prn,
            code_phase_fraction_s=h.code_phase_samples / sample_rate,
            doppler_hz=h.doppler_hz,
        )
        for h in hits
        if h.prn in sats
    ]
    print(f"snapshot: {len(meas)} usable satellites "
          f"({len(hits) - len(meas)} acquired without stored orbit)")
    sol = snapshot_fix(
        meas, orbit_fn_from_records(sats), args.assume_tow,
        lla_to_ecef(lat, lon, alt),
    )
    if sol is None:
        print("snapshot fix FAILED (need >= 5 usable satellites in basin)")
        return 1
    slat, slon, salt = ecef_to_lla(sol.ecef)
    print(f"SNAPSHOT FIX lat={slat:.6f} lon={slon:.6f} alt={salt:.0f}m "
          f"time_correction={sol.time_correction_s:+.3f}s "
          f"residual={sol.residual_rms_m:.1f}m sats={sol.prns}")
    return 0


def cmd_acquire(args) -> int:
    glo_file = args.glonass_file
    source = (
        _open_glonass_source(glo_file, args.glonass_rate, args.device)
        if glo_file
        else _open_source(args)
    )
    attrs = source.attributes
    search, threshold, n_ms = _engine(args, attrs, bool(glo_file))
    _, block = source.read_block(n_ms)
    hits = []
    for r in search(block):
        detected = r.strength > threshold
        if detected:
            hits.append(r)
        marker = "*" if detected else " "
        print(f"{marker} PRN {r.prn:2d}: strength {r.strength:6.2f}  "
              f"doppler {r.doppler_hz:+8.1f} Hz  code phase {r.code_phase_samples:4d}")
    if args.snapshot:
        return _snapshot(args, hits, attrs.sample_rate)
    return 0

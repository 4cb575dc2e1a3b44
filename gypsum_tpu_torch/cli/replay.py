"""``replay`` subcommand: the full receiver over a capture (reference
parity: gypsum-cli.py's only mode), plus the GLONASS and multi-band replays
and the assisted start, checkpoints and exports the reference lacks.

Port of gypsum_tpu/cli/replay.py: GPS L1 C/A (``--file``), GLONASS only
(``--glonass-file``), GPS + GLONASS (both: the fix solves the inter-system
bias) and GLONASS L1OF + L2OF (``--glonass-file --glonass-l2-file``: the
measured ionosphere); ``--checkpoint`` resumes from the file if it exists
(written by either package) and writes it on exit, single- and dual-band.
``--assist-nav``/``--assist-time`` load orbits from a RINEX NAV file and a
coarse start time into the fix-owning band before the run;
``--rinex-obs`` (one writer per tracked band, merged by epoch),
``--rinex-nav`` and ``--nmea-out`` (on the fix-owning band) write their
files after it. ``--web-ui`` pushes the receiver's state to the dashboard
server (obs/dashboard_server.py); ``--render-figures`` renders the
20-panel tracker figures (pushed with ``--web-ui``, else saved to
``tracker_figures/`` in the working directory) and ``--show-tracker`` shows
them in live matplotlib windows.
Its narration lines (acquisitions, drops, coasting, deep-integration ranging,
subframes, SBAS MT9, GLONASS strings 1-4 and the ``FIX lat=... lon=...``
lines) are the JAX CLI's.
"""

from __future__ import annotations

import dataclasses
import logging
import pathlib

import numpy as np

from gypsum_tpu_torch.cli.sources import _open_glonass_source, _open_source

_logger = logging.getLogger("gypsum_tpu_torch")


def narrate(recv, report) -> None:
    """Print one block's events in the JAX CLI's format."""
    for hit in report.newly_acquired:
        print(f"[{report.block_start:8.1f}s] acquired PRN {hit.prn}: "
              f"doppler {hit.doppler_hz:+.1f} Hz, code phase {hit.code_phase_samples}, "
              f"strength {hit.strength:.1f}")
    for prn in report.dropped_prns:
        print(f"[{report.block_start:8.1f}s] dropped PRN {prn} (lost lock)")
    for prn in report.coasting_prns:
        if prn in report.deep_measured_prns:
            print(f"[{report.block_start:8.1f}s] PRN {prn} deep-integration "
                  f"ranging (signal below loop threshold; measured by "
                  f"block-coherent correlation)")
        else:
            print(f"[{report.block_start:8.1f}s] PRN {prn} coasting open-loop "
                  f"(signal lost; NCOs held by predicted geometry)")
    for prn in report.coast_recovered_prns:
        print(f"[{report.block_start:8.1f}s] PRN {prn} signal returned: "
              f"ranging resumed in place (vector coast)")
    for prn, ev in report.subframes:
        how = ev.decoded.handover
        print(f"[{report.block_start:8.1f}s] PRN {prn} subframe "
              f"{how.subframe_id.value} TOW {how.time_of_week_seconds:.0f}s")
    for prn, blk in report.sbas_blocks:
        if blk.message_type == 9:  # GEO navigation (1-line/s otherwise)
            print(f"[{report.block_start:8.1f}s] SBAS PRN {prn} MT9 "
                  f"GEO navigation @ {blk.leading_edge_timestamp:.3f}s")
    for prn, ev in report.glonass_strings:
        if ev.string.m <= 4:  # the ephemeris strings (2 s cadence otherwise)
            print(f"[{report.block_start:8.1f}s] GLONASS k={prn - 208:+d} "
                  f"string {ev.string.m} @ "
                  f"{ev.trailing_edge_receiver_timestamp:.3f}s")
    if report.fix is not None:
        f = report.fix
        vel = ""
        if f.velocity_ecef_mps is not None:
            speed = float(np.linalg.norm(f.velocity_ecef_mps))
            vel = f" |v|={speed:.2f}m/s drift={f.clock_drift_s_per_s * 1e9:.2f}ns/s"
        # EKF coast fixes (< 4 satellites) are labeled so logs distinguish
        # them from least-squares fixes.
        tag = {"lsq": "FIX", "ekf": "COAST", "snapshot": "SNAPSHOT"}.get(f.kind, f.kind.upper())
        pl = ""
        if f.protection is not None:
            pl = (f" hpl={f.protection['hpl_m']:.0f}m"
                  f" vpl={f.protection['vpl_m']:.0f}m")
        dgps = f" sbas-corrected={list(f.sbas_corrected)}" if f.sbas_corrected else ""
        dfi = ""
        if f.iono_measured_m:
            vals = list(f.iono_measured_m.values())
            dfi = f" iono-measured={np.mean(vals):.1f}m@{len(vals)}sv"
        isb = (
            f" isb={f.inter_system_bias_s * 1e9:+.1f}ns"
            if f.inter_system_bias_s is not None
            else ""
        )
        print(f"[{report.block_end:8.1f}s] {tag} lat={f.lat_deg:.6f} lon={f.lon_deg:.6f} "
              f"alt={f.alt_m:.0f}m bias={f.clock_bias_s * 1e6:.2f}us{vel}{pl}{isb} "
              f"sats={f.satellites_used}{dgps}{dfi}")


def cmd_replay(args) -> int:
    from gypsum_tpu_torch.core.config import DEFAULT_CONFIG
    from gypsum_tpu_torch.runtime.receiver import DualBandReceiver, Receiver

    glonass_file = args.glonass_file
    l2_file = args.glonass_l2_file
    if l2_file and not glonass_file:
        raise SystemExit("--glonass-l2-file requires --glonass-file (the L2 "
                         "band only contributes the iono difference against "
                         "tracked L1 channels)")
    if not args.file and not args.rtlsdr and glonass_file:
        source = None  # GLONASS-only replay
    else:
        source = _open_source(args)
    config = DEFAULT_CONFIG
    if args.block_ms:
        config = config.replace(tracking=config.tracking.__class__(block_size_ms=args.block_ms))
    if args.hrc:
        config = config.replace(
            tracking=dataclasses.replace(config.tracking, code_phase_measurement="hrc")
        )
    prns = [int(p) for p in args.prns] if args.prns else None
    if args.sbas:
        from gypsum_tpu_torch.signal.prn import ALL_PRN_IDS, SBAS_PRN_IDS

        prns = sorted(set(prns or ALL_PRN_IDS) | set(SBAS_PRN_IDS))

    def open_glonass(path):
        return _open_glonass_source(path, args.glonass_rate, args.device)

    dual = None
    l2_source = open_glonass(l2_file) if l2_file else None
    if glonass_file and (source is not None or l2_source is not None):
        # GPS + GLONASS (the fix solves the inter-system bias), or GLONASS
        # L1OF + L2OF (no GPS: L1OF owns the fix and L2OF contributes the
        # measured-iono difference, the only iono correction there).
        dual = DualBandReceiver(
            source, open_glonass(glonass_file), config, eligible_prns=prns,
            glonass_l2_source=l2_source, device=args.device,
        )
        if dual.gps is not None:
            receiver = dual.gps  # listeners ride the fix-owning band
            _logger.info("dual-band replay: GPS %s + GLONASS %s%s", args.file,
                         glonass_file, f" + L2 {l2_file}" if l2_file else "")
        else:
            receiver = dual.glonass
            _logger.info("GLONASS dual-frequency replay: L1 %s + L2 %s",
                         glonass_file, l2_file)
        source = receiver.source
    elif glonass_file:
        receiver = Receiver(open_glonass(glonass_file), config, band="glonass",
                            device=args.device)
        source = receiver.source
        _logger.info("GLONASS-only replay: %s", glonass_file)
    else:
        receiver = Receiver(source, config, eligible_prns=prns, device=args.device)
    if args.assist_nav:
        # Assisted start: broadcast ephemerides from a RINEX NAV file (ours
        # or any IGS/receiver product). Orbits are known before any decode,
        # so the first fix needs only the first handover word
        # (solve/world.py:_assisted_bootstrap).
        from gypsum_tpu_torch.obs.rinex import parse_nav, parse_nav_glonass

        with open(args.assist_nav) as f:
            nav_text = f.read()
        n = receiver.world.assist_ephemerides(parse_nav(nav_text))
        n_glo = receiver.world.assist_glonass_ephemerides(parse_nav_glonass(nav_text))
        _logger.info("assist-nav %s: %d GPS + %d GLONASS ephemerides loaded",
                     args.assist_nav, n, n_glo)
    if args.assist_time is not None:
        # Coarse time (network-time grade, ~minute accuracy is enough):
        # with assist-nav this publishes coarse snapshot fixes before any
        # nav bit is decoded (solve/world.py:_coarse_time_snapshot).
        receiver.world.assist_time(args.assist_time)
        _logger.info("assist-time: stream t=0 is SOW %.1f (coarse)", args.assist_time)

    if args.checkpoint and pathlib.Path(args.checkpoint).exists():
        from gypsum_tpu_torch.runtime.checkpoint import (
            fast_forward,
            load_checkpoint,
            load_dual_checkpoint,
        )

        if dual is not None:
            per_band = load_dual_checkpoint(dual, args.checkpoint)
            for name, secs in per_band.items():
                fast_forward(getattr(dual, name).source, secs)
            stream_s = per_band["gps" if dual.gps is not None else "glonass"]
        else:
            stream_s = load_checkpoint(receiver, args.checkpoint)
            fast_forward(source, stream_s)
        _logger.info("resumed from %s at stream t=%.1fs", args.checkpoint, stream_s)

    visualizer = None
    if args.render_figures or args.show_tracker:
        from gypsum_tpu_torch.obs.visualizer import TrackerVisualizer

        visualizer = TrackerVisualizer(live_window=args.show_tracker)
    if args.web_ui:
        from gypsum_tpu_torch.obs.dashboard_client import DashboardClient

        receiver.add_block_listener(DashboardClient(config.obs, visualizer=visualizer).on_block)
    elif visualizer is not None:
        # No dashboard: drive the renderer directly and save PNGs locally.
        import base64

        figure_dir = pathlib.Path("tracker_figures")
        figure_dir.mkdir(exist_ok=True)

        def save_figures(recv, report):
            visualizer.on_block(recv, report)
            for prn, png in visualizer.rendered_png_base64.items():
                (figure_dir / f"prn{prn:02d}.png").write_bytes(base64.b64decode(png))

        receiver.add_block_listener(save_figures)
        _logger.info("writing tracker figures to %s/", figure_dir)

    rinex_writers = []
    if args.rinex_obs:
        from gypsum_tpu_torch.obs.rinex import RinexObsWriter

        rinex_writers = [RinexObsWriter(receiver)]
        receiver.add_block_listener(rinex_writers[0].on_block)
        if dual is not None and dual.glonass is not receiver:
            # Dual-band replay: the GLONASS band exports its own rows
            # (R<slot>, incl. C2C when an L2 band rides along); bands merge
            # by epoch at write time. The L2 band itself never gets a
            # writer: its delay surfaces as the L1 rows' C2C.
            w2 = RinexObsWriter(dual.glonass)
            dual.glonass.add_block_listener(w2.on_block)
            rinex_writers.append(w2)

    nmea_writer = None
    if args.nmea_out:
        from gypsum_tpu_torch.obs.nmea import NmeaWriter

        nmea_writer = NmeaWriter(path=args.nmea_out)
        receiver.add_block_listener(nmea_writer.on_block)

    receiver.add_block_listener(narrate)
    if dual is not None and dual.glonass is not receiver:
        dual.glonass.add_block_listener(narrate)
    try:
        (dual or receiver).run(max_seconds=args.duration, until_fix=args.until_fix)
    finally:
        if args.checkpoint:
            from gypsum_tpu_torch.runtime.checkpoint import (
                save_checkpoint,
                save_dual_checkpoint,
            )

            if dual is not None:
                save_dual_checkpoint(dual, args.checkpoint)
            else:
                save_checkpoint(receiver, args.checkpoint)
            _logger.info("checkpointed to %s at stream t=%.1fs",
                         args.checkpoint, source.seconds_consumed)

    if any(w.epochs for w in rinex_writers):
        from gypsum_tpu_torch.obs.rinex import write_obs_merged

        approx = (receiver.world.position_fixes[-1].ecef
                  if receiver.world.position_fixes else None)
        n_epochs = write_obs_merged(
            args.rinex_obs, [w for w in rinex_writers if w.epochs], approx_ecef=approx,
        )
        print(f"wrote RINEX observations: {args.rinex_obs} ({n_epochs} epochs)")
    if args.rinex_nav:
        from gypsum_tpu_torch.obs.rinex import render_nav

        eph = {p: r.ephemeris for p, r in receiver.world._sats.items()
               if r.ephemeris is not None}
        glo = {p: r.glonass for p, r in receiver.world._sats.items()
               if r.glonass is not None and r.glonass.slot >= 1}
        if eph or glo:
            with open(args.rinex_nav, "w") as f:
                f.write(render_nav(
                    eph, base_week=config.solver.gps_epoch_base_week_number,
                    glonass=glo or None))
            print(f"wrote RINEX navigation: {args.rinex_nav} "
                  f"({len(eph)} GPS + {len(glo)} GLONASS ephemerides)")
    if nmea_writer is not None:
        nmea_writer.close()
        print(f"wrote NMEA log: {args.nmea_out} "
              f"({nmea_writer.n_fixes} fixes, {len(nmea_writer.lines)} sentences)")
    print(f"processed {source.seconds_consumed:.1f}s; "
          f"{receiver.subframe_count} subframes; "
          f"{len(receiver.world.position_fixes)} fixes")
    if receiver.spoofing is not None and receiver.spoofing.alerts:
        kinds: dict[str, int] = {}
        for a in receiver.spoofing.alerts:
            kinds[a.kind] = kinds.get(a.kind, 0) + 1
        print(f"SPOOFING ALERTS: {len(receiver.spoofing.alerts)} "
              f"({', '.join(f'{k}: {v}' for k, v in sorted(kinds.items()))}) "
              f"— first at t={receiver.spoofing.alerts[0].t:.1f}s")
    # Predicted sky view from everything learned this run (decoded
    # ephemerides + almanac pages relayed off the air, solve/almanac.py).
    sky = receiver.world.predicted_sky(source.seconds_consumed)
    if sky:
        print("predicted sky (el/az/doppler; a=almanac-grade orbit):")
        for prn in sorted(sky, key=lambda p: -sky[p].elevation_deg):
            s = sky[prn]
            vis = "up  " if s.visible else "DOWN"
            print(f"  PRN {prn:2d} {vis} el {s.elevation_deg:6.1f}  "
                  f"az {s.azimuth_deg:5.1f}  doppler {s.doppler_hz:+7.1f} Hz"
                  f"{'  a' if s.from_almanac else ''}")
    return 0

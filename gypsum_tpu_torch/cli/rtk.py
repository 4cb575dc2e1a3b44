"""``rtk`` subcommand: dual-receiver carrier-phase baseline / attitude.

Port of gypsum_tpu/cli/rtk.py: the same modes (static, ``--kinematic``,
``--attitude``, ``--independent-clocks``, RINEX files) and the same printed
lines. Both receivers run on ``--device``; each capture opens through the
port's ``_open_source`` with that device, so a capture at another rate is
decimated there too. The solve (solve/rtk.py, solve/attitude.py) is numpy on
the host.
"""

from __future__ import annotations

import argparse
import logging

import numpy as np

from gypsum_tpu_torch.cli.sources import _open_source

_logger = logging.getLogger("gypsum_tpu_torch")


def cmd_rtk(args) -> int:
    """Dual-receiver carrier-phase baseline (RTK, solve/rtk.py): run the full
    receiver over the base and rover captures, double-difference the carrier,
    fix the integer ambiguities, print the centimeter-level baseline."""
    from gypsum_tpu_torch.core.config import DEFAULT_CONFIG
    from gypsum_tpu_torch.core.device import resolve_device
    from gypsum_tpu_torch.runtime.receiver import Receiver
    from gypsum_tpu_torch.solve.geodesy import enu_basis, lla_to_ecef
    from gypsum_tpu_torch.solve.rtk import (
        CarrierPhaseLog,
        dd_from_rinex,
        form_double_differences,
        solve_baseline,
        solve_kinematic,
        sv_position_fn_from_ephemerides,
    )

    resolve_device(args.device)
    prns = [int(p) for p in args.prns] if args.prns else None
    if args.attitude is not None and args.kinematic:
        # --attitude IS a per-epoch (kinematic) solve of the antenna axis,
        # so the flags are exclusive.
        raise SystemExit("--attitude and --kinematic are exclusive modes "
                         "(attitude already solves per-epoch); drop one")

    def print_attitude(dd, sv_fn, base_ecef) -> int:
        """--attitude: per-epoch heading/pitch of the base->rover antenna
        axis, the known separation validating/arbitrating the fix."""
        from gypsum_tpu_torch.solve.attitude import solve_attitude

        sol = solve_attitude(dd, sv_fn, base_ecef, separation_m=args.attitude,
                             ratio_threshold=args.ratio)
        for t, h, pch, ln in zip(sol.epochs_s, sol.heading_deg,
                                 sol.pitch_deg, sol.length_m):
            print(f"[{t:8.2f}s] heading {h:7.3f} deg  pitch {pch:+7.3f} deg"
                  f"  |b| {ln:.3f} m")
        print(f"attitude {'FIXED' if sol.fixed else 'FLOAT'}"
              f" (by {sol.fixed_by}, ratio {sol.ratio:.1f}, "
              f"length RMS {sol.length_rms_m*1e3:.1f} mm vs "
              f"{args.attitude:.3f} m separation, "
              f"{sol.n_length_consistent} length-consistent candidate(s), "
              f"ref PRN {sol.ref_prn})")
        print(f"attitude formal sigma (per-epoch mean): heading "
              f"{np.mean(sol.sigma_heading_deg):.3f} deg, pitch "
              f"{np.mean(sol.sigma_pitch_deg):.3f} deg, length "
              f"{sol.sigma_length_m*1e3:.1f} mm")
        if sol.mount_alarm:
            print("attitude MOUNT ALARM: phases fixed decisively but the "
                  "implied baseline length contradicts the claimed "
                  "separation — check --attitude SEP_M and mount rigidity")
        return 0 if sol.fixed else 3

    if args.base_rinex or args.rover_rinex:
        # Interop path: standard RINEX observation files (any receiver that
        # logs C1C+L1C) + a RINEX NAV for the orbits.
        if not (args.base_rinex and args.rover_rinex and args.nav):
            raise SystemExit("RINEX mode needs --base-rinex, --rover-rinex "
                             "and --nav together")
        from gypsum_tpu_torch.obs.rinex import parse_nav

        with open(args.nav) as f:
            eph = parse_nav(f.read())
        sv_fn = sv_position_fn_from_ephemerides(eph, 0.0)  # epochs are SOW
        with open(args.base_rinex) as fb, open(args.rover_rinex) as fr:
            dd = dd_from_rinex(fb.read(), fr.read(), prns=prns)
        base_ecef = lla_to_ecef(*args.base_lla)
        if args.attitude is not None:
            return print_attitude(dd, sv_fn, base_ecef)
        east, north, up = enu_basis(base_ecef)
        sol = solve_baseline(dd, sv_fn, base_ecef, ratio_threshold=args.ratio)
        for label, b in (("float", sol.baseline_float_m),
                         ("fixed", sol.baseline_fixed_m)):
            if b is None:
                continue
            print(f"{label} baseline ENU: ({b @ east:+.3f}, {b @ north:+.3f}, "
                  f"{b @ up:+.3f}) m  |b| = {np.linalg.norm(b):.3f} m")
        print(f"ambiguities {'FIXED' if sol.fixed else 'FLOAT'} "
              f"(ratio {sol.ratio:.1f}, bootstrap {sol.bootstrap_success:.4f}, "
              f"{sol.n_epochs} epochs, ref PRN {sol.ref_prn})")
        return 0 if sol.fixed else 3

    if not (args.base_file and args.rover_file):
        raise SystemExit("provide --base-file/--rover-file captures, or the "
                         "RINEX trio --base-rinex/--rover-rinex/--nav")
    logs, receivers = [], []
    for name, path in (("base", args.base_file), ("rover", args.rover_file)):
        # Every attribute the port's _open_source reads: the capture on the
        # rtk command's device (a decimated capture too), no front-end filter.
        source = _open_source(argparse.Namespace(
            file=path, format=args.format, sample_rate=args.sample_rate, rtlsdr=False,
            device=args.device, notch=False, beamform=False))
        recv = Receiver(source, DEFAULT_CONFIG, eligible_prns=prns, device=args.device)
        log = CarrierPhaseLog(recv.sample_rate, recv.samples_per_prn,
                              recv.config.tracking)
        recv.add_block_listener(log.listener())
        _logger.info("processing %s capture %s ...", name, path)
        recv.run(max_seconds=args.duration)
        logs.append(log)
        receivers.append(recv)

    # Satellite positions from the base receiver's decoded ephemerides; its
    # clock slide maps stream time to GPS seconds-of-week.
    world = receivers[0].world
    eph = {p: r.ephemeris for p, r in world._sats.items() if r.ephemeris is not None}
    if world.receiver_clock_slide is None or len(eph) < 4:
        raise SystemExit(
            f"base capture decoded {len(eph)} ephemerides and "
            f"{'no' if world.receiver_clock_slide is None else 'a'} time base; "
            "need >=4 ephemerides (longer capture?)"
        )
    sv_fn = sv_position_fn_from_ephemerides(eph, world.receiver_clock_slide)
    base_ecef = lla_to_ecef(*args.base_lla)

    alignment = None
    if args.independent_clocks:
        # Whole-ms part of the stream offset from each receiver's own decoded
        # time base (GPS = stream + slide  =>  r_b = r_v + slide_v - slide_b);
        # the estimator refines the sub-ms offset and the relative drift from
        # the observables. The rover's own code fix (meter-level) removes the
        # SD geometry term, keeping long baselines unbiased.
        from gypsum_tpu_torch.solve.rtk import estimate_stream_alignment

        world_v = receivers[1].world
        if world_v.receiver_clock_slide is None:
            raise SystemExit("--independent-clocks needs the rover to decode "
                             "a time base too (longer capture?)")
        coarse = world_v.receiver_clock_slide - world.receiver_clock_slide
        sd_range_fn = None
        if world_v.position_fixes:
            rover_hint = np.asarray(world_v.position_fixes[-1].ecef)

            def sd_range_fn(p, t):
                sv = sv_fn(p, t)
                return float(np.linalg.norm(sv - rover_hint)
                             - np.linalg.norm(sv - base_ecef))

        alignment = estimate_stream_alignment(
            logs[0], logs[1], prns=sorted(eph), coarse_offset_s=coarse,
            sd_range_fn=sd_range_fn,
        )
        print(f"stream alignment: rover starts {alignment.offset_s*1e3:+.4f} ms "
              f"into the base stream, relative drift {alignment.drift:+.3g} "
              f"(sigma {alignment.sigma_offset_s*1e9:.0f} ns, "
              f"{alignment.n_satellites} SVs)")

    dd = form_double_differences(
        logs[0], logs[1], prns=sorted(eph),
        epoch_every_ms=args.epoch_every_ms,
        alignment=alignment,
    )
    if args.attitude is not None:
        return print_attitude(dd, sv_fn, base_ecef)
    east, north, up = enu_basis(base_ecef)
    if args.kinematic:
        sol = solve_kinematic(dd, sv_fn, base_ecef, ratio_threshold=args.ratio)
        for t, b in zip(sol.epochs_s, sol.baselines_fixed_m):
            print(f"[{t:8.2f}s] baseline ENU ({b @ east:+.3f}, "
                  f"{b @ north:+.3f}, {b @ up:+.3f}) m")
        print(f"ambiguities {'FIXED' if sol.fixed else 'FLOAT'} "
              f"(ratio {sol.ratio:.1f}, {len(sol.epochs_s)} epochs, "
              f"ref PRN {sol.ref_prn}, DD PRNs {sol.prns})")
        return 0 if sol.fixed else 3

    sol = solve_baseline(dd, sv_fn, base_ecef, ratio_threshold=args.ratio)
    for label, b in (("float", sol.baseline_float_m), ("fixed", sol.baseline_fixed_m)):
        if b is None:
            continue
        enu = (float(b @ east), float(b @ north), float(b @ up))
        print(f"{label} baseline ENU: ({enu[0]:+.3f}, {enu[1]:+.3f}, "
              f"{enu[2]:+.3f}) m  |b| = {np.linalg.norm(b):.3f} m")
    print(f"ambiguities {'FIXED' if sol.fixed else 'FLOAT'} "
          f"(ratio {sol.ratio:.1f}, {sol.n_epochs} epochs, "
          f"ref PRN {sol.ref_prn}, DD PRNs {sol.prns}, "
          f"phase RMS {sol.phase_rms_half_cycles:.3f} half-cycles)")
    return 0 if sol.fixed else 3

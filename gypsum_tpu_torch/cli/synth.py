"""``synth`` subcommand: synthetic multi-SV capture generation (replaces
the reference's dependence on vendored recordings).

Copy of gypsum_tpu/cli/synth.py: numpy on the host, every flag of the JAX
CLI, and files byte-identical to the ones it writes (the single-antenna
capture, ``--rover-out``, ``--array-out`` with its jammer, the GLONASS
bands, and their ``.json`` sidecars)."""

from __future__ import annotations

import json

import numpy as np

def cmd_synth(args) -> int:
    from gypsum_tpu_torch.signal.constellation import synthesize_constellation
    from gypsum_tpu_torch.signal.scenarios import (
        DEMO_GPS_START_SOW,
        demo_constellation,
    )
    from gypsum_tpu_torch.solve.geodesy import lla_to_ecef

    prns = [int(p) for p in args.prns] if args.prns else None
    rx = lla_to_ecef(args.lat, args.lon, args.alt)
    velocity = None
    if args.vel:
        try:
            velocity = np.array([float(x) for x in args.vel.split(",")])
            if velocity.shape != (3,):
                raise ValueError
        except ValueError:
            raise SystemExit(f'--vel expects "vx,vy,vz" in m/s, got {args.vel!r}')
    impairments = None
    if (args.bandwidth or args.phase_noise or args.multipath or args.adc_bits
            or args.cw):
        from gypsum_tpu_torch.signal.constellation import RfImpairments

        impairments = RfImpairments(
            frontend_bandwidth_hz=args.bandwidth,
            phase_noise_rad_per_sqrt_s=args.phase_noise or 0.0,
            multipath_delay_s=args.multipath,
            adc_bits=args.adc_bits,
            cw_amplitude=args.cw,
            cw_freq_hz=args.cw_freq,
            cw_chirp_hz_per_s=args.cw_chirp,
        )
    start_sow = args.start_sow if args.start_sow is not None else DEMO_GPS_START_SOW
    if args.glonass_out and args.start_sow is None:
        # A GLONASS frame boundary at t=0 (strings 1-4 in the first 8 s):
        # GPS SOW 21618 maps to GLONASS day time 32400, a 30 s multiple.
        start_sow = 21618.0
    sats = demo_constellation(prns)
    if args.sbas:
        from gypsum_tpu_torch.signal.scenarios import demo_sbas_geo

        sats.append(demo_sbas_geo(args.sbas))
    iono_params = None
    if getattr(args, "iono", False):
        import dataclasses

        from gypsum_tpu_torch.signal.scenarios import demo_iono_page18
        from gypsum_tpu_torch.solve.iono import IonoUtcParams

        page = demo_iono_page18()
        iono_params = IonoUtcParams.from_page(page)
        # GPS satellites broadcast the page so a GPS receiver can decode
        # the model correction; GLONASS has no Klobuchar broadcast — its
        # correction must be MEASURED (synth --glonass-l2-out + replay
        # --glonass-l2-file) or inherited from a GPS band.
        sats = [
            s if not hasattr(s, "sf4") else dataclasses.replace(s, sf4=page)
            for s in sats
        ]
    iq, truth = synthesize_constellation(
        sats, rx, start_sow, args.duration,
        args.rate, noise_sigma=args.noise, receiver_velocity_ecef=velocity,
        tropo=not args.no_tropo, impairments=impairments, iono=iono_params,
    )

    def _write(path, samples):
        if path.endswith(".npy"):
            np.save(path, samples)
        else:
            # Interleaved float32 IQ + JSON sidecar (GNU-Radio-compatible
            # layout, reference: gypsum/radio_input.py:40-43).
            inter = np.empty(2 * len(samples), dtype=np.float32)
            inter[0::2] = samples.real
            inter[1::2] = samples.imag
            inter.tofile(path)
        with open(path + ".json", "w") as f:
            json.dump({"sample_rate": args.rate, "dtype": "float32"}, f)

    _write(args.out, iq)
    if args.rover_out:
        # Second receiver of the SAME scene, offset by --rover-enu: the
        # input pair for the `rtk` subcommand (solve/rtk.py).
        from gypsum_tpu_torch.solve.geodesy import enu_basis

        try:
            de, dn, du = (float(x) for x in args.rover_enu.split(","))
        except (AttributeError, ValueError):
            raise SystemExit('--rover-out needs --rover-enu "east,north,up" (m)')
        east, north, up = enu_basis(rx)
        iq2, _ = synthesize_constellation(
            sats, rx + de * east + dn * north + du * up,
            start_sow + args.rover_clock_offset,
            args.duration, args.rate, noise_sigma=args.noise,
            receiver_velocity_ecef=velocity, tropo=not args.no_tropo,
            impairments=impairments,
            receiver_clock_drift=args.rover_clock_drift,
        )
        _write(args.rover_out, iq2)
        clk = ""
        if args.rover_clock_offset or args.rover_clock_drift:
            clk = (f", independent clock (start {args.rover_clock_offset*1e3:+.3f} ms,"
                   f" drift {args.rover_clock_drift:g})")
        print(f"wrote rover capture {args.rover_out} at ENU offset "
              f"({de}, {dn}, {du}) m{clk}")
    if args.array_out:
        # [N_elements, T] CRPA capture of the same scene, optionally with an
        # arrayed (direction-bearing) jammer (signal/array.py).
        from gypsum_tpu_torch.signal.array import (
            ArrayJammer,
            square_array_enu,
            synthesize_array,
        )

        if args.sbas:
            raise SystemExit("--array-out models the GPS constellation only "
                             "(GEO direction synthesis not wired); drop --sbas")
        jam = None
        if args.jam:
            try:
                az, el = (float(x) for x in args.jam_azel.split(","))
            except ValueError:
                raise SystemExit(f'--jam-azel expects "az,el" deg, got {args.jam_azel!r}')
            jam = ArrayJammer(azimuth_deg=az, elevation_deg=el,
                              amplitude=args.jam, kind=args.jam_kind)
        elements = square_array_enu(
            *( [args.array_spacing] if args.array_spacing else [] )
        )
        arr, _ = synthesize_array(
            sats, rx, start_sow, args.duration, args.rate,
            elements_enu=elements, noise_sigma=args.noise, jammer=jam,
            tropo=not args.no_tropo,
        )
        if not args.array_out.endswith(".npy"):
            raise SystemExit("--array-out must be a .npy path (2-D capture)")
        np.save(args.array_out, arr)
        with open(args.array_out + ".json", "w") as f:
            json.dump({"sample_rate": args.rate, "dtype": "complex64",
                       "elements": len(elements),
                       "elements_enu": elements.tolist()}, f)
        jam_note = (f", {args.jam_kind} jammer amp {args.jam} from "
                    f"({args.jam_azel}) deg" if jam else "")
        print(f"wrote {len(elements)}-element array capture {args.array_out}"
              f"{jam_note}")

    if args.glonass_out:
        # The same scene's GLONASS L1OF band (a second front end at
        # 1602 MHz): FDMA channels from the demo look set, plus a residual
        # inter-system time offset the receiver must SOLVE (the dual-band
        # fix's isb output).
        from gypsum_tpu_torch.signal.scenarios import demo_glonass_constellation

        ks = (
            [int(k) for k in args.glonass_ks]
            if args.glonass_ks
            else [-2, -1, 0, 1, 2]
        )
        glo_sats = demo_glonass_constellation(ks)
        glo_iq, glo_truth = synthesize_constellation(
            glo_sats, rx, start_sow, args.duration,
            args.glonass_rate, noise_sigma=args.noise,
            receiver_velocity_ecef=velocity, tropo=not args.no_tropo,
            glonass_time_offset_s=args.glonass_time_offset, iono=iono_params,
        )
        if args.glonass_out.endswith(".npy"):
            np.save(args.glonass_out, glo_iq)
        else:
            inter = np.empty(2 * len(glo_iq), dtype=np.float32)
            inter[0::2] = glo_iq.real
            inter[1::2] = glo_iq.imag
            inter.tofile(args.glonass_out)
        with open(args.glonass_out + ".json", "w") as f:
            json.dump({"sample_rate": args.glonass_rate, "dtype": "float32"}, f)
        print(f"wrote GLONASS band {args.glonass_out}: {args.duration}s @ "
              f"{args.glonass_rate:.0f} Hz, channels k={ks}, inter-system "
              f"offset {args.glonass_time_offset * 1e9:.0f} ns")
        if getattr(args, "glonass_l2_out", None):
            # The SAME scene's L2OF band (1246 MHz front end): identical
            # geometry/clocks, iono group delay scaled by (f_l1/f_l2)^2 —
            # the coherent capture pair the dual-frequency measured-iono
            # path (replay --glonass-l2-file) differences.
            l2_iq, _ = synthesize_constellation(
                glo_sats, rx, start_sow, args.duration,
                args.glonass_rate, noise_sigma=args.noise,
                receiver_velocity_ecef=velocity, tropo=not args.no_tropo,
                glonass_time_offset_s=args.glonass_time_offset,
                iono=iono_params, glonass_band="l2",
            )
            np.save(args.glonass_l2_out, l2_iq)
            with open(args.glonass_l2_out + ".json", "w") as f:
                json.dump(
                    {"sample_rate": args.glonass_rate, "dtype": "complex64"}, f
                )
            print(f"wrote GLONASS L2 band {args.glonass_l2_out}: "
                  f"{args.duration}s @ {args.glonass_rate:.0f} Hz")
    print(f"wrote {args.out}: {args.duration}s @ {args.rate:.0f} Hz, "
          f"PRNs {[s for s in truth.doppler_hz]}")
    for prn in truth.doppler_hz:
        print(f"  PRN {prn}: doppler {truth.doppler_hz[prn]:+.1f} Hz, "
              f"code phase {truth.code_phase_samples[prn]:.1f}, "
              f"transit {truth.transit_time_s[prn] * 1e3:.3f} ms")
    return 0



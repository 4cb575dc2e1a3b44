"""Argument parser and entry point of the port's CLI.

Usage:
    python -m gypsum_tpu_torch [--device cuda|cpu] replay --file capture.npy --until-fix
    python -m gypsum_tpu_torch replay --glonass-file r.npy --until-fix
    python -m gypsum_tpu_torch replay --file g.npy --glonass-file r.npy
    python -m gypsum_tpu_torch replay --glonass-file l1.npy --glonass-l2-file l2.npy
    python -m gypsum_tpu_torch replay --file capture.npy --duration 12 --checkpoint run.ckpt
    python -m gypsum_tpu_torch acquire --file capture.npy [--deep [--deep-ms 200]]
    python -m gypsum_tpu_torch acquire --file capture.npy --deep --snapshot \
        --checkpoint run.ckpt --assume-lla 51.5,-0.1,80 --assume-tow 21604
    python -m gypsum_tpu_torch synth --out jammed.npy --duration 25 --cw 12
    python -m gypsum_tpu_torch replay --file jammed.npy --notch --until-fix
    python -m gypsum_tpu_torch synth --out c.npy --array-out arr.npy --jam 6
    python -m gypsum_tpu_torch replay --file arr.npy --beamform --until-fix

    python -m gypsum_tpu_torch replay --file capture.npy --rinex-obs run.obs \
        --rinex-nav run.nav --nmea-out run.nmea
    python -m gypsum_tpu_torch replay --file capture.npy --assist-nav run.nav \
        --assist-time 21608 --until-fix
    python -m gypsum_tpu_torch synth --out b.npy --duration 30 --prns 25 28 31 32 3 7 \
        --rover-out r.npy --rover-enu 11,-7.5,2
    python -m gypsum_tpu_torch rtk --base-file b.npy --rover-file r.npy \
        --base-lla 51.5 -0.1 80 [--kinematic | --attitude 13.46] [--independent-clocks]
    python -m gypsum_tpu_torch rtk --base-rinex b.obs --rover-rinex r.obs --nav run.nav \
        --base-lla 51.5 -0.1 80

    python -m gypsum_tpu_torch.obs.dashboard_server --port 8080 &
    python -m gypsum_tpu_torch replay --file capture.npy --web-ui --render-figures
    python -m gypsum_tpu_torch --profile-dir prof replay --file capture.npy --duration 3

The JAX CLI's ``bench`` sub-command is not ported: it runs the JAX
package's benchmark (``bench.py``), and the port's benchmark is work of its
own (ROADMAP.md). Every other sub-command and flag is (``--device`` stands
for the JAX CLI's ``--platform``). Captures at other rates than the band's
processing rate (2.046 Msps GPS, 4.092 Msps GLONASS) go through the
decimating front end (``--sample-rate``, ``--glonass-rate``, ``--format`` or
the sidecar), then through the notch when ``--notch`` asks for it.
``synth`` runs on the host (numpy) and needs no card.

Before a command runs, and before it imports torch, the CLI starts building
the kernels and the native reader that its command and flags select on
background threads (``core/aot.py``; not for ``synth``, ``--device cpu`` or
``GYPSUM_AOT=0``), so that a fresh checkout's first replay compiles while
it imports, reads and acquires. ``python -m gypsum_tpu_torch.ops.kernels``
builds them all ahead of time.
"""

from __future__ import annotations

import argparse
import logging
import sys

from gypsum_tpu_torch.cli.acquire import cmd_acquire
from gypsum_tpu_torch.cli.replay import cmd_replay
from gypsum_tpu_torch.cli.rtk import cmd_rtk
from gypsum_tpu_torch.cli.sources import (
    GLONASS_PROCESSING_RATE,
    PROCESSING_RATE,
    _add_file_source_args,
    capture_libraries,
)
from gypsum_tpu_torch.cli.synth import cmd_synth
from gypsum_tpu_torch.core import aot


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="gypsum_tpu_torch")
    parser.add_argument(
        "--device",
        choices=["cuda", "cpu"],
        default="cuda",
        help="where acquisition and tracking run (default cuda; fails when "
        "no card is present)",
    )
    parser.add_argument(
        "--profile-dir",
        default=None,
        help="run the command under torch.profiler and write a Chrome trace "
        "into this directory (open with Perfetto or chrome://tracing)",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("replay", help="run the full receiver over a capture")
    _add_file_source_args(p)
    p.add_argument("--prns", nargs="*", help="restrict acquisition to these PRNs "
                   "(reference: --only_acquire_satellite_ids)")
    p.add_argument("--sbas", action="store_true",
                   help="also search the SBAS GEO family (PRNs 120-138)")
    p.add_argument("--duration", type=float, default=None, help="seconds of signal to process")
    p.add_argument("--until-fix", action="store_true", help="stop at the first position fix")
    p.add_argument("--block-ms", type=int, default=None, help="tracking block size")
    p.add_argument("--hrc", action="store_true",
                   help="multipath-resistant pseudoranges: double-delta (HRC) "
                        "code-phase measurement instead of triangle vertex "
                        "interpolation (needs >= 4 samples/chip to help)")
    p.add_argument("--glonass-file", default=None, metavar="PATH",
                   help="GLONASS L1OF band capture (second front end at "
                   "1602 MHz): with --file, a dual-constellation replay "
                   "whose fix solves the GPS-GLONASS inter-system bias; "
                   "alone, a GLONASS-only replay")
    p.add_argument("--glonass-rate", type=float, default=None,
                   help="GLONASS capture sample rate (else sidecar; 4.092e6 for .npy)")
    p.add_argument("--glonass-l2-file", default=None, metavar="PATH",
                   help="GLONASS L2OF band capture (third front end at "
                   "1246 MHz, same 511-chip code): tracked but never "
                   "decoded; the per-SV L2-L1 code-delay difference is the "
                   "MEASURED ionospheric correction (requires "
                   "--glonass-file)")
    p.add_argument("--assist-nav", default=None, metavar="PATH",
                   help="assisted start: load broadcast ephemerides from a "
                        "RINEX 3 NAV file (e.g. a previous run's --rinex-nav "
                        "export) — first fix right after the first handover "
                        "word instead of after full subframe 1-3 decode")
    p.add_argument("--assist-time", type=float, default=None, metavar="SOW",
                   help="coarse GPS seconds-of-week of the stream start "
                        "(±1 min is fine): with --assist-nav, snapshot fixes "
                        "are published before any nav bit is decoded")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file: resumed from if it exists, written on exit "
                   "(either package's checkpoints load; the reference always "
                   "cold-starts)")
    p.add_argument("--rinex-obs", default=None, metavar="PATH",
                   help="export observables (C1C/L1C/D1C/S1C) as RINEX 3.04")
    p.add_argument("--nmea-out", default=None, metavar="PATH",
                   help="stream NMEA 0183 sentences (GGA/GSA/RMC/VTG/GSV/ZDA"
                        " per fix) to PATH, line-buffered (obs/nmea.py)")
    p.add_argument("--rinex-nav", default=None, metavar="PATH",
                   help="export decoded broadcast ephemerides as RINEX 3.04 NAV")
    p.add_argument("--web-ui", action="store_true", help="push state to the web dashboard")
    p.add_argument("--render-figures", action="store_true",
                   help="render the 20-panel per-satellite tracker figures (pushed to the "
                   "web dashboard with --web-ui, else saved to tracker_figures/)")
    p.add_argument("--show-tracker", action="store_true",
                   help="live matplotlib tracker window per satellite "
                   "(reference: --present_matplotlib_sat_tracker)")
    p.set_defaults(fn=cmd_replay)

    p = sub.add_parser("acquire", help="one-shot acquisition report over 10 ms")
    p.add_argument("--glonass-file", default=None, metavar="PATH",
                   help="acquire over a GLONASS L1OF band capture instead "
                   "(FDMA sub-band sweep; with --deep, the per-channel "
                   "f64-rotated deep search)")
    p.add_argument("--glonass-rate", type=float, default=None,
                   help="GLONASS capture sample rate (else sidecar; 4.092e6 for .npy)")
    p.add_argument("--deep", action="store_true",
                   help="high-sensitivity search: grouped coherent x "
                        "non-coherent integration over --deep-ms (~7-10 dB "
                        "below the 10 ms engine; pairs well with --snapshot)")
    p.add_argument("--deep-ms", type=int, default=200,
                   help="milliseconds integrated in --deep mode")
    p.add_argument("--snapshot", action="store_true",
                   help="coarse-time fix from this acquisition alone "
                        "(orbits from --checkpoint, priors from --assume-*)")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file holding decoded orbits (for --snapshot); "
                   "written by either package")
    p.add_argument("--assume-lla", default=None, metavar="LAT,LON,ALT",
                   help="coarse position prior, ~100 km basin")
    p.add_argument("--assume-tow", type=float, default=None,
                   help="coarse GPS time prior (seconds of week, ~1 min basin)")
    _add_file_source_args(p)
    p.set_defaults(fn=cmd_acquire)

    p = sub.add_parser("synth", help="generate a synthetic multi-SV capture")
    p.add_argument("--out", required=True, help=".npy or raw interleaved f32 (+.json sidecar)")
    p.add_argument("--duration", type=float, default=40.0)
    p.add_argument("--rate", type=float, default=2.046e6)
    p.add_argument("--noise", type=float, default=0.35)
    p.add_argument("--prns", nargs="*")
    p.add_argument("--lat", type=float, default=51.5)
    p.add_argument("--lon", type=float, default=-0.1)
    p.add_argument("--alt", type=float, default=80.0)
    p.add_argument("--vel", default=None,
                   help='receiver ECEF velocity "vx,vy,vz" in m/s (default static)')
    p.add_argument("--no-tropo", action="store_true",
                   help="omit the (default) Saastamoinen tropospheric delay")
    p.add_argument("--bandwidth", type=float, default=None,
                   help="front-end low-pass cutoff in Hz (RF impairment)")
    p.add_argument("--phase-noise", type=float, default=None,
                   help="TCXO phase-noise random walk in rad/sqrt(s)")
    p.add_argument("--multipath", type=float, default=None,
                   help="one multipath ray at this excess delay (seconds)")
    p.add_argument("--adc-bits", type=int, default=None,
                   help="quantize the capture to this many ADC bits per component")
    p.add_argument("--cw", type=float, default=None, metavar="AMPLITUDE",
                   help="inject a CW jammer of this amplitude (satellites are "
                        "~1, noise sigma ~0.3; try 10-30 — then replay with "
                        "--notch)")
    p.add_argument("--cw-freq", type=float, default=257e3,
                   help="jammer baseband offset in Hz")
    p.add_argument("--cw-chirp", type=float, default=0.0,
                   help="jammer sweep rate in Hz/s (swept interference)")
    p.add_argument("--sbas", type=int, nargs="?", const=120, default=None,
                   metavar="PRN",
                   help="add an SBAS GEO (PRN 120-138; replay it with "
                        "--prns <gps...> <PRN> to widen the search family)")
    p.add_argument("--rover-out", default=None,
                   help="also write a second capture of the same scene from "
                        "an offset receiver (the `rtk` subcommand's input)")
    p.add_argument("--rover-enu", default=None, metavar="E,N,U",
                   help='rover offset from the base in meters, e.g. "12,-5,0"')
    p.add_argument("--rover-clock-offset", type=float, default=0.0,
                   help="rover sampling starts this many seconds later in GPS "
                        "time (independent clock; pair with `rtk "
                        "--independent-clocks`)")
    p.add_argument("--start-sow", type=float, default=None,
                   help="GPS seconds-of-week of the scene start (default "
                   "21600; --glonass-out defaults to 21618 so a GLONASS "
                   "frame boundary lands at t=0)")
    p.add_argument("--array-out", default=None, metavar="PATH",
                   help="also write an [elements, samples] .npy antenna-array "
                        "capture of the scene (signal/array.py) — the input "
                        "for `acquire/replay --beamform` CRPA jammer nulling")
    p.add_argument("--array-spacing", type=float, default=None, metavar="M",
                   help="array element spacing in meters (default L1 "
                        "half-wavelength, ~0.095 m; 4-element square)")
    p.add_argument("--jam", type=float, default=None, metavar="AMPLITUDE",
                   help="arrayed interferer amplitude entering --array-out "
                        "(kind/direction below); unlike --cw this one has a "
                        "DIRECTION, so the CRPA can null it")
    p.add_argument("--jam-kind", default="noise", choices=("noise", "cw"),
                   help="arrayed interferer kind: broadband noise (the kind "
                        "--notch cannot excise) or a CW tone")
    p.add_argument("--jam-azel", default="135,5", metavar="AZ,EL",
                   help="arrayed interferer direction (deg az clockwise from "
                        "north, deg elevation; default a terrestrial 135,5)")
    p.add_argument("--glonass-out", default=None, metavar="PATH",
                   help="also write the scene's GLONASS L1OF band (a second "
                   "front end at 1602 MHz) to this path")
    p.add_argument("--glonass-ks", nargs="*", default=None,
                   help="GLONASS FDMA frequency numbers to put on air "
                   "(default -2 -1 0 1 2)")
    p.add_argument("--glonass-rate", type=float, default=4.092e6)
    p.add_argument("--glonass-l2-out", default=None, metavar="PATH",
                   help="also write the GLONASS scene's L2OF band (1246 MHz "
                   "front end, .npy) — the dual-frequency capture pair for "
                   "replay --glonass-l2-file (requires --glonass-out)")
    p.add_argument("--iono", action="store_true",
                   help="inject a daytime Klobuchar ionosphere into every "
                   "band (GPS satellites broadcast the page-18 parameters; "
                   "GLONASS bands carry the (f_l1/f)^2-scaled group delay)")
    p.add_argument("--glonass-time-offset", type=float, default=8e-7,
                   help="residual GPS->GLONASS time offset (s) the dual-band "
                   "receiver must solve (default 800 ns)")
    p.add_argument("--rover-clock-drift", type=float, default=0.0,
                   help="rover fractional oscillator frequency error "
                        "(e.g. 2e-8)")
    p.set_defaults(fn=cmd_synth)

    p = sub.add_parser(
        "rtk",
        help="centimeter-level baseline between two simultaneous captures "
             "(double-differenced carrier phase, integer ambiguity fixing)",
    )
    p.add_argument("--base-file", default=None, help="base receiver capture")
    p.add_argument("--rover-file", default=None, help="rover receiver capture")
    p.add_argument("--base-rinex", default=None,
                   help="base RINEX 3 observation file (instead of a capture)")
    p.add_argument("--rover-rinex", default=None,
                   help="rover RINEX 3 observation file")
    p.add_argument("--nav", default=None,
                   help="RINEX 3 navigation file for the orbits (RINEX mode)")
    p.add_argument("--base-lla", type=float, nargs=3, required=True,
                   metavar=("LAT", "LON", "ALT"),
                   help="known base position (deg, deg, m)")
    p.add_argument("--format", default=None,
                   help="named capture format for both files (see replay)")
    p.add_argument("--sample-rate", type=float, default=None)
    p.add_argument("--prns", nargs="*", default=None)
    p.add_argument("--duration", type=float, default=None,
                   help="process at most this many seconds of each capture")
    p.add_argument("--epoch-every-ms", type=int, default=250)
    p.add_argument("--ratio", type=float, default=2.0,
                   help="integer-fix acceptance ratio (2nd-best/best cost)")
    p.add_argument("--kinematic", action="store_true",
                   help="moving rover: per-epoch baselines (shared ambiguities)")
    p.add_argument("--attitude", type=float, default=None, metavar="SEP_M",
                   help="dual-antenna attitude: known antenna separation in "
                        "meters; prints per-epoch heading/pitch of the "
                        "base->rover axis (solve/attitude.py)")
    p.add_argument("--independent-clocks", action="store_true",
                   help="receivers sample on their own oscillators: estimate "
                        "the stream offset/drift from the observables and "
                        "interpolate the rover onto the base epochs")
    p.set_defaults(fn=cmd_rtk)
    return parser


def libraries(args) -> list[str]:
    """The compiled libraries the command will load, told from its command,
    flags and capture sidecars alone (``core/aot.py``): the tracker's
    (``aot.TRACKER_LIBRARIES``) for every receiver (``replay``, ``rtk`` on
    captures), K2 for ``acquire --deep``,
    and what each capture's source loads (``cli/sources.py:capture_libraries``).
    ``synth`` and ``rtk`` on RINEX files load none; ``acquire`` tracks
    nothing, so it loads neither."""
    if args.command == "synth":
        return []
    if args.command == "rtk":
        if args.base_rinex or args.rover_rinex or not (args.base_file and args.rover_file):
            return []
        names = list(aot.TRACKER_LIBRARIES)
        for path in (args.base_file, args.rover_file):
            names += capture_libraries(path, args.sample_rate, args.format, PROCESSING_RATE)
        return list(dict.fromkeys(names))
    if args.command == "replay":
        names = list(aot.TRACKER_LIBRARIES)
    else:
        names = ["peak_reduce"] if args.deep else []
    for path in filter(None, (args.glonass_file, getattr(args, "glonass_l2_file", None))):
        names += capture_libraries(path, args.glonass_rate, None, GLONASS_PROCESSING_RATE)
    # acquire reads the GLONASS capture instead of --file when it has one.
    if args.file and not args.rtlsdr and not (args.command == "acquire" and args.glonass_file):
        names += capture_libraries(args.file, args.sample_rate, args.format, PROCESSING_RATE)
    return list(dict.fromkeys(names))


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(levelname).1s %(name)s: %(message)s")
    args = build_parser().parse_args(argv)
    # Before the command imports torch or reads its capture: the kernels
    # build while that happens (a no-op on --device cpu or GYPSUM_AOT=0).
    aot.preload(libraries(args), args.device)
    if args.profile_dir:
        return run_profiled(args)
    return args.fn(args)


def run_profiled(args) -> int:
    """Run the command under ``torch.profiler`` (host activity, and the
    card's with ``--device cuda``) and write its Chrome trace as
    ``<command>.<pid>.pt.trace.json`` into ``args.profile_dir``. The
    tracker's spans (``obs/spans.py``) show in it as ``user_annotation``
    ranges."""
    import os
    import pathlib

    from torch.profiler import ProfilerActivity, profile

    from gypsum_tpu_torch.obs import spans

    activities = [ProfilerActivity.CPU]
    if args.device == "cuda":
        activities.append(ProfilerActivity.CUDA)
    out = pathlib.Path(args.profile_dir)
    out.mkdir(parents=True, exist_ok=True)
    spans.enable(annotate=True)
    try:
        with profile(activities=activities) as prof:
            rc = args.fn(args)
    finally:
        spans.disable()
        spans.drain()
    path = out / f"{args.command}.{os.getpid()}.pt.trace.json"
    prof.export_chrome_trace(str(path))
    logging.getLogger("gypsum_tpu_torch").info("profile trace written to %s", path)
    return rc


if __name__ == "__main__":
    sys.exit(main())

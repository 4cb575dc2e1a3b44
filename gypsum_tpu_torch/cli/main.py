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

The JAX CLI's other sub-commands (synth, rtk, bench) and the replay flags
for RINEX/NMEA export, the web UI, assisted start, notch and beamform are
not ported yet (ROADMAP.md). Captures at
other rates than the band's processing rate (2.046 Msps GPS, 4.092 Msps
GLONASS) go through the decimating front end (``--sample-rate``,
``--glonass-rate``, ``--format`` or the sidecar).
"""

from __future__ import annotations

import argparse
import logging
import sys

from gypsum_tpu_torch.cli.acquire import cmd_acquire
from gypsum_tpu_torch.cli.replay import cmd_replay
from gypsum_tpu_torch.cli.sources import _add_file_source_args


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(levelname).1s %(name)s: %(message)s")
    parser = argparse.ArgumentParser(prog="gypsum_tpu_torch")
    parser.add_argument(
        "--device",
        choices=["cuda", "cpu"],
        default="cuda",
        help="where acquisition and tracking run (default cuda; fails when "
        "no card is present)",
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
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file: resumed from if it exists, written on exit "
                   "(either package's checkpoints load; the reference always "
                   "cold-starts)")
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

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

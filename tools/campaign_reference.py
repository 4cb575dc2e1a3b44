"""The JAX receiver's side of the campaign twin: run ``gypsum_tpu`` (on the
CPU) over the trials and named scenes of tools/campaign_torch.py and write
its records to tools/campaign_reference.jsonl, which the twin and
chip_smoke.py compare the port with (neither imports JAX).

The scenarios come from tools/campaign.py (its ``make_scenario`` and
impairment levels, unchanged); synthesis, the receivers and the judging run
the twin's trial code over a namespace of the JAX package's modules, so the
two sides differ only in the package under test. Phase 1 of the tracker
runs in float32 (``matmul_tracker_bf16=False``): the records hold the
algorithm, not bf16 rounding.

The set (``campaign_torch.reference_set``): GPS seeds 0-27, gauntlet seeds
0-1 at each of the eight levels, GLONASS-DF seeds 0-3 and the thirteen
scene runs, each pipelined (``pipeline_tracking=True``, the card's default); the
scenes also unpipelined, as their tests run. Each trial runs in a worker
process of its own (spawn); records already in ``--out`` are kept as they
are and not run again (new ones are appended), so an interrupted run
resumes.

Usage (about 4 min a GPS trial on one worker; ~1.5-2 h at --jobs 4):
    python tools/campaign_reference.py --jobs 4
    python tools/campaign_reference.py --only gps --jobs 4   # a part of the set
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor, as_completed
from pathlib import Path
from types import SimpleNamespace

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools import campaign_torch as twin  # noqa: E402

DEFAULT_OUT = Path(__file__).resolve().parent / "campaign_reference.jsonl"


def jax_api() -> SimpleNamespace:
    """The namespace of ``campaign_torch.port_api``, from the JAX package."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from gypsum_tpu.core.config import (
        AcquisitionConfig,
        NavConfig,
        ReceiverConfig,
        SolverConfig,
        TrackingConfig,
    )
    from gypsum_tpu.core.constants import GPS_L1_FREQUENCY_HZ
    from gypsum_tpu.io.sources import ArraySampleSource, NotchingSampleSource
    from gypsum_tpu.nav.sbas import GeoNavigationMessage
    from gypsum_tpu.runtime.receiver import DualBandReceiver, Receiver
    from gypsum_tpu.signal import constellation, scenarios
    from gypsum_tpu.signal.prn import ALL_PRN_IDS
    from gypsum_tpu.signal.synth import SyntheticSatellite, synthesize_iq
    from gypsum_tpu.solve.geodesy import lla_to_ecef
    from gypsum_tpu.solve.iono import IonoUtcParams
    from gypsum_tpu.track.loop import TrackerBank
    from tools.campaign import _impairment_levels, make_scenario

    return SimpleNamespace(
        name="gypsum_tpu",
        default_pipelined=False,
        make_scenario=make_scenario,
        impairment_levels=_impairment_levels,
        AcquisitionConfig=AcquisitionConfig, NavConfig=NavConfig, ReceiverConfig=ReceiverConfig,
        SolverConfig=SolverConfig, TrackingConfig=TrackingConfig,
        GPS_L1_FREQUENCY_HZ=GPS_L1_FREQUENCY_HZ, ArraySampleSource=ArraySampleSource,
        GeoNavigationMessage=GeoNavigationMessage, constellation=constellation,
        scenarios=scenarios, ALL_PRN_IDS=ALL_PRN_IDS, SyntheticSatellite=SyntheticSatellite,
        synthesize_iq=synthesize_iq, lla_to_ecef=lla_to_ecef, IonoUtcParams=IonoUtcParams,
        receiver=lambda source, cfg=None, eligible=None, band="gps": Receiver(
            source, cfg, eligible_prns=eligible, band=band),
        dual_receiver=lambda l1, l2, cfg: DualBandReceiver(
            None, l1, config=cfg, glonass_l2_source=l2),
        bank=lambda cfg, n: TrackerBank(twin.FS, twin.L, cfg, n_channels=n),
        notch=NotchingSampleSource,
    )


def reference_trial(args) -> dict:
    spec, pipelined, threads = args
    os.environ.setdefault("XLA_FLAGS", f"--xla_cpu_multi_thread_eigen=true "
                                       f"intra_op_parallelism_threads={threads}")
    api = jax_api()
    t0 = time.perf_counter()
    arrays, facts = twin.synthesize(spec, api)
    synth_s = time.perf_counter() - t0
    rec = twin.replay(spec, arrays, facts, api, pipelined=pipelined, bf16=False)
    rec["synthesis_s"] = synth_s
    rec["phase1"] = "float32"
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--only", default=None, choices=("gps", "gauntlet", "glonass_df", "scene"),
                    help="record only this part of the set")
    args = ap.parse_args()

    out = Path(args.out)
    kept = twin.load_records(out) if out.exists() else []
    done = {(twin.spec_key(r), r["pipelined"]) for r in kept}
    runs = [(s, p) for s, p in twin.reference_runs() if (twin.spec_key(s), p) not in done]
    if args.only:
        part = {"gps": lambda s: s["kind"] == "gps" and s["impairment"] == "none",
                "gauntlet": lambda s: s["kind"] == "gps" and s["impairment"] != "none",
                "glonass_df": lambda s: s["kind"] == "glonass_df",
                "scene": lambda s: s["kind"] == "scene"}[args.only]
        runs = [(s, p) for s, p in runs if part(s)]
    print(f"{len(done)} records kept, {len(runs)} to run at --jobs {args.jobs}", flush=True)
    threads = max(1, (os.cpu_count() or 2) // args.jobs)
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=args.jobs, mp_context=ctx) as pool, \
            open(out, "a") as f:
        futures = {pool.submit(reference_trial, (s, p, threads)): (s, p) for s, p in runs}
        for n, fut in enumerate(as_completed(futures), 1):
            rec = fut.result()
            f.write(json.dumps(rec) + "\n")
            f.flush()
            print(f"[{n}/{len(runs)}] pipelined={rec['pipelined']} {twin.summary_line(rec)}",
                  flush=True)
    # The records kept stay where they were, byte for byte; the new ones
    # follow them in the set's order, whatever order the workers finished in.
    lines = [line for line in out.read_text().splitlines() if line.strip()]
    new = lines[len(kept):]
    order = {(twin.spec_key(s), p): i for i, (s, p) in enumerate(twin.reference_runs())}

    def rank(line):
        r = json.loads(line)
        return order.get((twin.spec_key(r), r["pipelined"]), len(order))

    out.write_text("".join(line + "\n" for line in lines[:len(kept)] + sorted(new, key=rank)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

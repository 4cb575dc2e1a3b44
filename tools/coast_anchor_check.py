"""Why the JAX receiver's pipelined ``coast_glonass`` record fails its test's
last-fix bar (ROADMAP.md C9): replay that scene (tools/campaign_torch.py)
pipelined through the JAX receiver as it is, and again with one line of its
coast entry changed to the port's Hatch anchor (the prediction at the
collected block's end, not at the next dispatch: gypsum_tpu/runtime/
coast.py:93 against gypsum_tpu_torch/runtime/coast.py:95-100). The change is
made to the class in this process only; no file of the JAX package changes.

Prints each run's status and every fix's (epoch, error m, satellites).

Usage (CPU, ~3 min synthesis then ~20 s a replay; the capture is kept):
    python tools/coast_anchor_check.py [--capture build/coast_glonass.npz]
"""

from __future__ import annotations

import argparse
import inspect
import os
import sys
import textwrap
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from tools import campaign_reference as reference  # noqa: E402
from tools import campaign_torch as twin  # noqa: E402

REFERENCE_ANCHOR = "self.world.begin_coast(obs.prn, vals[0])"
PORT_ANCHOR = "self.world.begin_coast(obs.prn, self._coast_prediction(obs.prn, pipe, t_end)[0])"


def anchor_at_collected_end() -> None:
    """Rebuild the JAX receiver's ``_enter_coast`` with the port's anchor."""
    import gypsum_tpu.runtime.coast as coast

    cls = next(v for v in vars(coast).values()
               if isinstance(v, type) and "_enter_coast" in vars(v))
    src = textwrap.dedent(inspect.getsource(cls._enter_coast))
    if src.count(REFERENCE_ANCHOR) != 1:
        raise RuntimeError("the JAX coast entry no longer has the anchor this check replaces")
    namespace = dict(vars(coast))
    exec(src.replace(REFERENCE_ANCHOR, PORT_ANCHOR), namespace)
    cls._enter_coast = namespace["_enter_coast"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--capture", default=str(ROOT / "build" / "coast_glonass.npz"))
    args = ap.parse_args()
    spec = twin.scene_spec("coast_glonass")
    if not Path(args.capture).exists():
        Path(args.capture).parent.mkdir(parents=True, exist_ok=True)
        twin.synthesize_to(spec, args.capture)
    arrays, facts = twin.load_synthesized(args.capture)
    api = reference.jax_api()
    rx = api.scenarios.demo_receiver_ecef()
    for label in ("reference anchor", "port anchor"):
        if label == "port anchor":
            anchor_at_collected_end()
        rec = twin.replay(spec, arrays, facts, api, pipelined=True, bf16=False)
        fixes = [(f[0], round(float(np.linalg.norm(np.subtract(f[1:4], rx))), 2), len(f[4]))
                 for f in rec["fixes"]]
        print(f"{label}: {rec['status']} {rec.get('failed_bars') or ''} fixes {fixes}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

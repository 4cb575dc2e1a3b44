"""host_block_p95_ms (ms, host clock): the 95th percentile over the window's
blocks of the time from handing a block to the farm entry until its outputs
are on the host: what a hub of live streams feels. A per-layer metric: at
depth 1 it follows the host's speed wherever the host's issue of a block
takes about as long as the card's work on it, as in both farm cells. Read
in the traced run, whose window holds the profiled stretch."""

import numpy as np


def read(ctx):
    lat = ctx["stats"]["latency_s"]
    return float(np.percentile(np.asarray(lat) * 1e3, 95)) if lat else None

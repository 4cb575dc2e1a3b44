"""host_track_rate (ch-s/s, host clock): channel-seconds of signal whose
outputs reached the host, all channels of all streams, over the window's
wall seconds (the last block drained): what a farm host replays a second.
A per-layer metric: at depth 1 it follows the host's speed, which swings
from run to run on a shared host, wherever the host's issue of a block takes
about as long as the card's work on it, as in both farm cells. Read in the
traced run, whose window holds the profiled stretch."""


def read(ctx):
    st, sh = ctx["stats"], ctx["shape"]
    if not st["blocks"]:
        return None
    return st["blocks"] * sh["channels"] * sh["block_ms"] / 1e3 / st["wall_s"]

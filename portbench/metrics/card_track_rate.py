"""card_track_rate (ch-s/s, device trace): channel-seconds of signal whose
outputs reached the host, all channels of all streams, over the seconds in
which the card computed (the union of the device trace's kernels, memsets
and copies within the card), both over the whole window: the rate one card
sustains when its host keeps it fed.

The copies between the card and the host (the outputs' copy) are left out:
they run on a copy engine, at the pace of the host's memory, which a shared
host varies (the outputs' copy read 0.31-0.43 ms a GLONASS block on one
card across hosts, against under 1 % for the kernels).

The profiler now and then loses a record (one K1 record of 734 blocks in
one run on the card), which leaves a block's kernel out of the busy time.
The kernel that the cell's traffic kind runs once a block (``block_kernel``:
K1 in the farm) has its count of records measure the loss: more than
``LOST`` of the blocks without one, or more records than blocks, and the
reading is None; so it is where the kind names no such kernel."""

from portbench import trace

LOST = 0.005


def read(ctx):
    session, st, sh = ctx["session"], ctx["stats"], ctx["shape"]
    blocks = st["traced_blocks"]
    once = ctx.get("block_kernel")
    if session is None or not session.events or not blocks or blocks != st["blocks"] or not once:
        return None
    if not (1.0 - LOST) * blocks <= trace.kernel_count(session.events, once) <= blocks:
        return None
    computing = [e for e in session.events if not trace.is_host_copy(e)]
    return blocks * sh["channels"] * sh["block_ms"] / 1e3 / trace.busy_s(computing)

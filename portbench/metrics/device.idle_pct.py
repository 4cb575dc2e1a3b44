"""device.idle_pct (%, device trace): the share of the traced stretch (its
span on the card's clock, CUDA events) in which no kernel, copy or memset
ran (the union of the trace's device intervals)."""

from portbench import trace


def read(ctx):
    session = ctx["session"]
    if session is None or not session.events:
        return None
    window = session.window_s()
    return 100.0 * (1.0 - trace.busy_s(session.events) / window) if window > 0 else None

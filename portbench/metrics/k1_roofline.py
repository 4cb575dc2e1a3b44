"""k1_roofline (%, device trace): K1's share of its roofline: its least time
(roofline.k1_bound_ms: the 2K+1 lags a ms and channel read once, the
outputs written once, against the float32 operations) over its traced time
a block."""

from portbench import roofline, trace


def read(ctx):
    k1 = trace.k1_ms(ctx)
    if not k1:
        return None
    sh = ctx["shape"]
    return 100.0 * roofline.k1_bound_ms(sh["block_ms"], sh["channels"], sh["k_half"]) / k1

"""step_mfu (%, device trace): the tracking step's share of the card's bf16
peak: the complex products its outputs need (roofline.step_flops: 2K+1 lags
a ms and channel, 8 operations a sample) over 989 TFLOP/s, against phase
1's and K1's traced time a block. It counts the work the outputs need, not
the wider lag window an implementation computes, so a later implementation
reads the same work."""

from portbench import roofline, trace


def read(ctx):
    k1, p1 = trace.k1_ms(ctx), trace.phase1_ms(ctx)
    if not k1 or not p1:
        return None
    sh = ctx["shape"]
    flops = roofline.step_flops(sh["block_ms"], sh["samples_per_ms"], sh["channels"], sh["k_half"])
    return 100.0 * 1e3 * flops / roofline.BF16_OPS_PER_S / (k1 + p1)

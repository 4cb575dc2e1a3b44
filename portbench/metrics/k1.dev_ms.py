"""k1.dev_ms (ms, device trace): device time a traced block of K1, the
loop-filter fixup kernel (``fixup_kernel``)."""

from portbench import trace


def read(ctx):
    return trace.k1_ms(ctx)

"""phase1.dev_ms (ms, device trace): device time a traced block of every
kernel, copy and memset but K1's and the outputs' copy to the host: phase 1
of the tracker (dequantize, lag rows, wipe, per-stream products) and the
restart edits (a few microseconds)."""

from portbench import trace


def read(ctx):
    return trace.phase1_ms(ctx)

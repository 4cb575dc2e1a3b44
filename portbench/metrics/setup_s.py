"""setup_s (s, host clock): from the run module's first line to the first
timed block: import torch and the port, the pool's synthesis, the entry's
build and its warm blocks."""


def read(ctx):
    return ctx["setup_s"]

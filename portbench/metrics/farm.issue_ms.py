"""farm.issue_ms (ms, host clock): mean host time inside the farm entry's
call (``packed``), from the call to its return, over the window's blocks
outside the traced stretch (the profiler adds to the host's time)."""


def read(ctx):
    issue = ctx["stats"]["issue_s"]
    return 1e3 * sum(issue) / len(issue) if issue else None

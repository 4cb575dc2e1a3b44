"""The host side of a device trace: the program's spans beside the card.

``HostSession`` is a ``trace.Session`` whose ``read`` also keeps what the
profiler records on the host side of the card's activity and ``Session``
drops: the CUDA runtime and driver records (``cudaLaunchKernel``,
``cuLaunchKernel``, ``cudaMemcpyAsync``, ...: name, host start and end ns,
correlation id), each device record's correlation id, and the absolute base
``base_ns`` that ``events`` are rebased to. ``events`` are those of
``Session``, unchanged. The program's spans (``gypsum_tpu_torch/obs/
spans.py``) are stamped with ``time.time_ns()``, the clock of the profiler's
host records, so a span, a launch and (through the launch's correlation id)
a device record can be set side by side.

What is read from them, each a traced block's mean unless named otherwise:

- ``track_issue_ms``, ``loop_issue_ms``: host ms inside the ``track.block``
  and ``phase1.products`` spans, over the window's blocks outside the traced
  stretch (the blocks ``farm.issue_ms`` reads);
- ``loop_dev_ms``: device ms of the operations whose launch record falls
  inside a ``phase1.products`` span, matched to their launches by
  correlation id (an operation is charged to the span it was launched from,
  whatever span its execution overlaps);
- ``idle_loop_ms``, ``idle_caller_ms``: the card's idle time (the gaps
  between the union of its records, the set ``trace.idle_gaps`` sums) while
  the host's innermost open span is ``phase1.products``, or while no span of
  the program is open (the caller's own code: the restart edit, the
  outputs' copy and its event, the wait on the previous block). Gaps are
  split by time against the spans.

Each returns None where it finds nothing to read: no spans in ``ctx``, no
trace, or (device readers) no launch records.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field

from portbench import trace

CALLER = "caller"  # no span of the program open
UNMATCHED = "unmatched"  # a device record with no launch record in the trace


@dataclass
class HostRecord:
    """A CUDA runtime or driver call on the host (absolute ns)."""

    name: str
    start_ns: int
    end_ns: int
    correlation: int


@dataclass
class HostSession(trace.Session):
    """``trace.Session`` keeping the host side of the card's records, and
    the host clock's ns at the stretch's start and stop (``host_ns``)."""

    base_ns: int = 0
    correlations: list[int] = field(default_factory=list)  # one per ``events`` entry
    launches: list[HostRecord] = field(default_factory=list)
    host_ns: tuple = (0, 0)

    def start(self) -> None:
        self.host_ns = (time.time_ns(), 0)
        super().start()

    def stop(self) -> None:
        super().stop()
        self.host_ns = (self.host_ns[0], time.time_ns())

    def read(self) -> None:
        from torch.autograd import DeviceType

        self.keep([(e.device_type() == DeviceType.CUDA, e.name(), e.start_ns(), e.duration_ns(),
                    e.correlation_id()) for e in self._prof.profiler.kineto_results.events()])

    def keep(self, rows) -> None:
        """From the profiler's records, (on the device, name, start ns,
        duration ns, correlation id) each: ``Session``'s events and the rest
        above."""
        self.events = trace.device_events(r[:4] for r in rows)
        device = sorted((r for r in rows if r[0]), key=lambda r: r[2])  # the order of ``events``
        self.base_ns = device[0][2] if device else 0
        self.correlations = [r[4] for r in device]
        self.launches = [HostRecord(str(n), t, t + d, c) for on, n, t, d, c in rows if not on and c]
        self._prof = None

    def device_ns(self) -> list[tuple[int, int, int]]:
        """(start ns, end ns, correlation id) of each device record, on the
        host's clock."""
        return [(self.base_ns + round(e.start_us * 1e3), self.base_ns + round(e.end_us * 1e3), c)
                for e, c in zip(self.events, self.correlations)]


def timeline(records: list[tuple]) -> list[tuple[int, int, str]]:
    """[(start ns, end ns, name)]: the time of every root span cut into
    pieces, each named by the innermost span open over it, in time order.
    ``records`` as ``spans.drain`` gives them (parents before children)."""
    children = defaultdict(list)
    for i, r in enumerate(records):
        children[r[3]].append(i)
    pieces = []

    def fill(i):
        name, t, end = records[i][0], records[i][1], records[i][2]
        for c in children[i]:
            if records[c][1] > t:
                pieces.append((t, records[c][1], name))
            fill(c)
            t = max(t, records[c][2])
        if end > t:
            pieces.append((t, end, name))

    for root in children[-1]:
        fill(root)
    return pieces


class SpanIndex:
    """The innermost open span at a host time (``CALLER`` outside all)."""

    def __init__(self, records: list[tuple]) -> None:
        self.pieces = timeline(records)
        self.starts = [p[0] for p in self.pieces]

    def at(self, t_ns: int) -> str:
        i = bisect.bisect_right(self.starts, t_ns) - 1
        if i >= 0 and t_ns < self.pieces[i][1]:
            return self.pieces[i][2]
        return CALLER

    def split(self, t0: int, t1: int) -> dict[str, int]:
        """ns of [t0, t1) under each innermost span (``CALLER`` for the
        rest)."""
        out: dict[str, int] = defaultdict(int)
        covered = 0
        i = max(bisect.bisect_right(self.starts, t0) - 1, 0)
        while i < len(self.pieces) and self.pieces[i][0] < t1:
            a, b = max(self.pieces[i][0], t0), min(self.pieces[i][1], t1)
            if b > a:
                out[self.pieces[i][2]] += b - a
                covered += b - a
            i += 1
        if t1 - t0 > covered:
            out[CALLER] += t1 - t0 - covered
        return out


def gaps_ns(device: list[tuple[int, int, int]]) -> list[tuple[int, int]]:
    """The card's idle gaps between the union of its records' intervals
    (``device`` by start, as ``HostSession.device_ns`` gives it)."""
    out, end = [], None
    for start, stop, _ in device:
        if end is not None and start > end:
            out.append((end, start))
        end = stop if end is None else max(end, stop)
    return out


def idle_by_span(session: HostSession, records: list[tuple]) -> dict[str, float]:
    """Seconds of the card's idle gaps under each innermost host span."""
    index, out = SpanIndex(records), defaultdict(float)
    for t0, t1 in gaps_ns(session.device_ns()):
        for name, ns in index.split(t0, t1).items():
            out[name] += ns / 1e9
    return dict(out)


def device_by_span(session: HostSession, records: list[tuple]) -> dict[str, float]:
    """Seconds of device records by the innermost span open at their launch
    record's start (``UNMATCHED`` without one)."""
    index, out = SpanIndex(records), defaultdict(float)
    launched = {h.correlation: h.start_ns for h in session.launches}
    for start, stop, corr in session.device_ns():
        at = launched.get(corr)
        out[UNMATCHED if at is None else index.at(at)] += (stop - start) / 1e9
    return dict(out)


def _traced(ctx):
    """(session, span records, traced blocks) where all three are there,
    else None."""
    session, recorded = ctx.get("session"), ctx.get("spans")
    blocks = ctx["stats"].get("traced_blocks", 0)
    if recorded is None or not isinstance(session, HostSession) or not session.events or not blocks:
        return None
    return session, recorded["records"], blocks


def _untraced_ms(ctx, name: str) -> float | None:
    """Mean host ms of the ``name`` spans of the window's blocks outside the
    traced stretch."""
    recorded = ctx.get("spans")
    if recorded is None:
        return None
    session = ctx.get("session")
    t0, t1 = session.host_ns if isinstance(session, HostSession) else (0, 0)
    blocks = defaultdict(int)
    for r in recorded["records"]:
        if r[0] == name and not t0 <= r[1] <= t1:
            blocks[r[4]] += r[2] - r[1]
    return sum(blocks.values()) / len(blocks) / 1e6 if blocks else None


def track_issue_ms(ctx) -> float | None:
    return _untraced_ms(ctx, "track.block")


def loop_issue_ms(ctx) -> float | None:
    return _untraced_ms(ctx, "phase1.products")


def loop_dev_ms(ctx) -> float | None:
    got = _traced(ctx)
    if got is None or not got[0].launches:
        return None
    session, records, blocks = got
    return 1e3 * device_by_span(session, records).get("phase1.products", 0.0) / blocks


def _idle_ms(ctx, name: str) -> float | None:
    got = _traced(ctx)
    if got is None:
        return None
    session, records, blocks = got
    return 1e3 * idle_by_span(session, records).get(name, 0.0) / blocks


def idle_loop_ms(ctx) -> float | None:
    return _idle_ms(ctx, "phase1.products")


def idle_caller_ms(ctx) -> float | None:
    return _idle_ms(ctx, CALLER)


READINGS = {
    "track.issue_ms": track_issue_ms,
    "phase1.loop_issue_ms": loop_issue_ms,
    "phase1.loop_dev_ms": loop_dev_ms,
    "idle.loop_ms": idle_loop_ms,
    "idle.caller_ms": idle_caller_ms,
}


def report_lines(ctx) -> list[str]:
    """The traced stretch's idle time and device time by host span, ms a
    block, the idle line closed on the trace's total gap time."""
    got = _traced(ctx)
    if got is None:
        return []
    session, records, blocks = got
    idle = idle_by_span(session, records)
    dev = device_by_span(session, records)
    total_gap = sum(s for _, s in trace.idle_gaps(session.events, top=10**9))

    def line(sums):
        return ", ".join(f"{k} {1e3 * v / blocks:.4f}" for k, v in sorted(sums.items(), key=lambda kv: -kv[1]))

    return [
        f"idle ms a traced block by host span ({blocks} blocks): {line(idle)}; sum "
        f"{1e3 * sum(idle.values()) / blocks:.4f}, the trace's gaps {1e3 * total_gap / blocks:.4f}",
        f"device ms a traced block by launching span: {line(dev)}; "
        f"{len(session.launches)} host records",
    ]

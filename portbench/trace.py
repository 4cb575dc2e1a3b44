"""The device trace of a stretch of blocks or of a whole window, and what is
read from it.

``torch.profiler`` records the card's activity only (kernels, copies,
memsets: no host operators, whose recording would slow the host that paces
the card); its records are read from the profiler's results in memory, so
nothing is written to disk. CUDA events around each traced block time the
same stretch on the card's own clock, so a record the profiler loses shows
as a gap between the two (the run's "profiler check" line); a kernel that
runs once a block (the traffic kind's ``block_kernel``: K1 in the farm) has
its count of records as a second check (``kernel_count``).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

@dataclass
class DeviceEvent:
    name: str
    start_us: float
    dur_us: float

    @property
    def end_us(self) -> float:
        return self.start_us + self.dur_us


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameter list: 'void at::native::foo<4, bar>(int)' ->
    'at::native::foo'."""
    kept, depth = [], 0
    for ch in re.sub(r"^void\s+", "", name.strip()):
        if ch == "<":
            depth += 1
        elif ch == ">" and depth:
            depth -= 1
        elif not depth:
            kept.append(ch)
    out = "".join(kept).strip()
    if out.endswith(")"):
        depth = 0
        for i in range(len(out) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(out[i], 0)
            if depth == 0:
                out = out[:i]
                break
    return out.strip()


def device_events(records) -> list[DeviceEvent]:
    """The device events among ``records`` ((on the device, name, start ns,
    duration ns) each), by start time, in us from the first record's start
    (so float64 keeps sub-ns precision)."""
    rows = [(n, t, d) for on_device, n, t, d in records if on_device]
    if not rows:
        return []
    base = min(t for _, t, _ in rows)
    return sorted((DeviceEvent(str(n), (t - base) / 1e3, d / 1e3) for n, t, d in rows),
                  key=lambda e: e.start_us)


@dataclass
class Session:
    """A profiler session over a stretch of blocks and the CUDA events
    around each block in it."""

    block_spans: list = field(default_factory=list)  # (start event, end event)
    events: list[DeviceEvent] = field(default_factory=list)
    _prof: object = None
    _running: bool = False

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        self._running = True

    def stop(self) -> None:
        """End the recording (after the card has finished what it was
        given); ``read`` exports it later, outside the window."""
        import torch

        torch.cuda.synchronize()
        self._prof.stop()
        self._running = False

    def read(self) -> None:
        """Keep the recording's device events and drop the rest."""
        from torch.autograd import DeviceType

        # With host operators not recorded, the card's records are its
        # kernels, copies and memsets.
        results = self._prof.profiler.kineto_results
        self.events = device_events((e.device_type() == DeviceType.CUDA, e.name(), e.start_ns(),
                                     e.duration_ns()) for e in results.events())
        self._prof = None

    @property
    def active(self) -> bool:
        return self._running

    def event_block_ms(self) -> list[float]:
        """Each traced block's span on the card by CUDA events (ms)."""
        return [a.elapsed_time(b) for a, b in self.block_spans]

    def window_s(self) -> float:
        """From the first traced block's start event to the last one's end
        event, on the card's clock."""
        if not self.block_spans:
            return 0.0
        return self.block_spans[0][0].elapsed_time(self.block_spans[-1][1]) / 1e3


def busy_s(events: list[DeviceEvent]) -> float:
    """Seconds in which at least one device operation ran: the length of
    the union of the events' intervals."""
    total, end = 0.0, None
    start = None
    for e in events:
        if end is None or e.start_us > end:
            if end is not None:
                total += end - start
            start, end = e.start_us, e.end_us
        else:
            end = max(end, e.end_us)
    if end is not None:
        total += end - start
    return total / 1e6


def device_ops(events: list[DeviceEvent], top: int = 10) -> list[list]:
    """[[operation, seconds], ...]: device time by operation, the most first."""
    sums: dict[str, float] = {}
    for e in events:
        key = short_name(e.name)
        sums[key] = sums.get(key, 0.0) + e.dur_us / 1e6
    return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:top]]


def idle_gaps(events: list[DeviceEvent], top: int = 10) -> list[list]:
    """[[label, seconds], ...]: the card's idle time between operations,
    summed by where it falls ('<operation before> -> <operation after>'),
    which says what the host was issuing meanwhile; the longest first."""
    sums: dict[str, float] = {}
    end, last = None, None
    for e in events:
        if end is not None and e.start_us > end:
            key = f"{short_name(last)} -> {short_name(e.name)}"
            sums[key] = sums.get(key, 0.0) + (e.start_us - end) / 1e6
        if end is None or e.end_us >= end:
            end, last = e.end_us, e.name
    return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:top]]


K1_KERNEL = "fixup_kernel"


def is_host_copy(e: DeviceEvent) -> bool:
    """A copy between the card and the host (the outputs' copy here): it
    runs on a copy engine at the pace of the host's memory."""
    return any(k in e.name for k in ("DtoH", "HtoD", "Pinned", "Pageable"))


def kernel_count(events: list[DeviceEvent], kernel: str) -> int:
    """The records whose name holds ``kernel``."""
    return sum(1 for e in events if kernel in e.name)


def k1_ms(ctx) -> float | None:
    """K1's device ms a traced block, None without a trace or K1 in it."""
    session, blocks = ctx["session"], ctx["stats"]["traced_blocks"]
    if session is None or not blocks:
        return None
    total = sum(e.dur_us for e in session.events if K1_KERNEL in e.name)
    return total / 1e3 / blocks if total > 0 else None


def phase1_ms(ctx) -> float | None:
    """Device ms a traced block of everything but K1 and the outputs' copy."""
    session, blocks = ctx["session"], ctx["stats"]["traced_blocks"]
    if session is None or not blocks:
        return None
    total = sum(e.dur_us for e in session.events
                if K1_KERNEL not in e.name and not is_host_copy(e))
    return total / 1e3 / blocks if total > 0 else None

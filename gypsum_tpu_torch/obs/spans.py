"""The program's host spans and counters, on the clock of the device trace.

A span is a named stretch of host time inside the block tracker (the farm
entry, phase 1's parts, K1's launch, the carry; the bank's dispatch, wait
and collect). Spans are off unless a caller turns them on, and off a span
is one shared do-nothing object: no allocation, no clock read, no torch
call. On, each span appends one record

    (name, start_ns, end_ns, parent, block)

to a list in memory: ``start_ns``/``end_ns`` from ``time.time_ns()``, the
clock ``torch.profiler`` stamps its host records with, so a span can be set
beside the profiler's CUDA runtime records (and, through their correlation
ids, beside the device records); ``parent`` the index of the enclosing open
span in the list, -1 for a root; ``block`` the sequence number of the
enclosing root span, so every span of one block shares one id. No span
makes a CUDA call, on or off.

    from gypsum_tpu_torch.obs import spans
    spans.enable()
    ...                          # blocks
    records, counters = spans.drain()

``enable(annotate=True)`` also opens a ``torch.profiler.record_function``
range per span, so a profiler that records host activity (the CLI's
``--profile-dir``) shows the spans as ``user_annotation`` ranges. Spans
nest per process on one host thread: the tracker is driven from one.
"""

from __future__ import annotations

import time


class _Off:
    """The span of a recorder that is off: enters and exits doing nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None


OFF = _Off()


class _Span:
    __slots__ = ("_rec", "_name", "_annotation")

    def __init__(self, rec: "Recorder", name: str) -> None:
        self._rec, self._name, self._annotation = rec, name, None

    def __enter__(self):
        rec = self._rec
        parent = rec.open[-1] if rec.open else -1
        if parent < 0:
            rec.blocks += 1
            block = rec.blocks
        else:
            block = rec.records[parent][4]
        rec.open.append(len(rec.records))
        if rec.annotate:
            from torch.profiler import record_function

            self._annotation = record_function(self._name)
            self._annotation.__enter__()
        rec.records.append([self._name, time.time_ns(), 0, parent, block])
        return self

    def __exit__(self, *exc) -> None:
        rec = self._rec
        rec.records[rec.open.pop()][2] = time.time_ns()
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        return None


class Recorder:
    """Spans and counters of one process; off until ``enable``."""

    def __init__(self) -> None:
        self.on = False
        self.annotate = False
        self.records: list[list] = []
        self.open: list[int] = []  # indexes of the open spans, innermost last
        self.counters: dict[str, int] = {}
        self.blocks = -1  # the last root span's id

    def span(self, name: str):
        """A context manager timing ``name``; ``OFF`` when spans are off."""
        if not self.on:
            return OFF
        return _Span(self, name)

    def count(self, name: str, n: int = 1) -> None:
        if self.on:
            self.counters[name] = self.counters.get(name, 0) + n

    def enable(self, annotate: bool = False) -> None:
        self.on, self.annotate = True, annotate

    def disable(self) -> None:
        self.on, self.annotate = False, False

    def drain(self) -> tuple[list[tuple], dict[str, int]]:
        """The spans' records and the counters, cleared here. Call it between
        blocks: inside an open span it raises."""
        if self.open:
            raise RuntimeError(f"drain() inside {len(self.open)} open span(s)")
        records, counters = [tuple(r) for r in self.records], self.counters
        self.records, self.counters = [], {}
        return records, counters


_RECORDER = Recorder()
span = _RECORDER.span
count = _RECORDER.count
enable = _RECORDER.enable
disable = _RECORDER.disable
drain = _RECORDER.drain

"""The program's spans beside the device trace (``hosttrace.py``): the
readers on a synthetic trace with synthetic spans and launch records, the
tiny farm with spans on, and on the card, K1's launches inside ``k1``
spans."""

import pytest
import torch

from portbench import cells, hosttrace, spanrun, trace
from portbench.tests._tiny import tiny_root

torch.set_num_threads(2)
BASE = 1_792_320_111_715_776_620  # ns from the Unix epoch
SEED = 2**31 + 1919


def _ns(us: float) -> int:
    return BASE + int(us * 1e3)


def _span(name, start_us, end_us, parent, block):
    return (name, _ns(start_us), _ns(end_us), parent, block)


# Two traced blocks (ids 0 and 1), then one outside the traced stretch (2).
SPANS = [
    _span("track.block", 0, 100, -1, 0),
    _span("phase1.inputs", 0, 10, 0, 0),
    _span("phase1.wipe", 10, 20, 0, 0),
    _span("phase1.products", 20, 80, 0, 0),
    _span("k1", 80, 90, 0, 0),
    _span("track.carry", 90, 100, 0, 0),
    _span("track.block", 150, 250, -1, 1),
    _span("phase1.products", 160, 240, 6, 1),
    _span("track.block", 400, 480, -1, 2),
    _span("phase1.products", 410, 470, 8, 2),
]


def _session():
    """Device records A-D: A launched in phase1.products, B in k1 (it runs
    over track.carry and the caller's time), C by the caller between
    blocks, D with no launch record."""
    device = [("gemm A", 30, 20, 1), ("fixup_kernel B", 90, 30, 2), ("copy C", 160, 10, 3),
              ("memset D", 200, 10, 4)]
    rows = [(True, n, _ns(t), int(d * 1e3), c) for n, t, d, c in device]
    rows += [(False, "cudaLaunchKernel", _ns(25), 3000, 1), (False, "cuLaunchKernel", _ns(85), 2000, 2),
             (False, "cudaMemcpyAsync", _ns(130), 4000, 3), (False, "cudaStreamSynchronize", _ns(300), 10, 0)]
    session = hosttrace.HostSession()
    session.keep(rows)
    session.host_ns = (_ns(-5), _ns(300))
    return session


def _ctx(session=None, spans=True, traced_blocks=2):
    return {"session": session, "stats": {"traced_blocks": traced_blocks, "issue_s": []},
            "spans": {"records": SPANS, "counters": {}} if spans else None}


def test_session_keeps_the_host_side():
    session = _session()
    assert [e.start_us for e in session.events] == [0.0, 60.0, 130.0, 170.0]
    assert session.base_ns == _ns(30) and session.correlations == [1, 2, 3, 4]
    assert [h.name for h in session.launches] == ["cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync"]
    assert session.device_ns()[1] == (_ns(90), _ns(120), 2)


def test_idle_by_span_closes_on_the_gaps():
    session = _session()
    idle = hosttrace.idle_by_span(session, SPANS)
    # Gaps [50, 90], [120, 160], [170, 200] us.
    assert idle == pytest.approx({"phase1.products": 60e-6, "k1": 10e-6, "caller": 30e-6,
                                  "track.block": 10e-6})
    total = sum(s for _, s in trace.idle_gaps(session.events, top=100))
    assert sum(idle.values()) == pytest.approx(total) == pytest.approx(110e-6)


def test_an_operation_is_charged_to_the_span_it_was_launched_from():
    dev = hosttrace.device_by_span(_session(), SPANS)
    assert dev == pytest.approx({"phase1.products": 20e-6, "k1": 30e-6, "caller": 10e-6,
                                 "unmatched": 10e-6})


def test_readings_of_the_synthetic_trace():
    ctx = _ctx(_session())
    got = {name: read(ctx) for name, read in hosttrace.READINGS.items()}
    assert got == pytest.approx({"track.issue_ms": 0.08, "phase1.loop_issue_ms": 0.06,
                                 "phase1.loop_dev_ms": 0.01, "idle.loop_ms": 0.03,
                                 "idle.caller_ms": 0.015})
    lines = hosttrace.report_lines(ctx)
    assert lines[0].endswith("sum 0.0550, the trace's gaps 0.0550")
    # No spans: nothing to read. No trace, or no traced block: no device
    # reading. No launch records: no device time by span.
    assert all(read(_ctx(_session(), spans=False)) is None for read in hosttrace.READINGS.values())
    device = ("phase1.loop_dev_ms", "idle.loop_ms", "idle.caller_ms")
    for ctx in (_ctx(None), _ctx(_session(), traced_blocks=0)):
        assert all(hosttrace.READINGS[name](ctx) is None for name in device)
    bare = _session()
    bare.launches = []
    assert hosttrace.loop_dev_ms(_ctx(bare)) is None
    assert hosttrace.idle_loop_ms(_ctx(bare)) == pytest.approx(0.03)


def test_tiny_farm_reads_the_host_spans_on_the_cpu(tmp_path):
    cell = cells.load(tiny_root(tmp_path), "tiny-farm")
    res = spanrun.execute(cell, SEED, 0.3, 1, 0.2, device="cpu")
    m = res["metrics"]
    assert m["track.issue_ms"] > m["phase1.loop_issue_ms"] > 0
    for name in ("phase1.loop_dev_ms", "idle.loop_ms", "idle.caller_ms"):
        assert m[name] is None
    assert res["spans_a_block"] == 6 and res["products_a_block"] == 2
    assert len(res["cost"]["farm.issue_ms"]["on"]) == len(res["cost"]["farm.issue_ms"]["off"]) == 1
    assert res["cost"]["interleaved"]["blocks_each"] >= 1


@pytest.mark.card
def test_k1_launches_fall_inside_k1_spans(card, tmp_path):
    """The spans and the profiler's launch records share one clock: at
    least 99.5 % of K1's launch records fall inside a ``k1`` span."""
    from gypsum_tpu_torch.obs import spans
    from portbench import farm, generator

    cell = cells.load(tiny_root(tmp_path, capture_s=10), "tiny-farm")
    caps = generator.make_captures(cell.config, cell.traffic, SEED)
    system = farm.Farm(cell.config, cell.traffic, caps, generator.make_pool(caps, card), card)
    window = farm.Window(system, 2, SEED)
    window.warm(3)
    session = hosttrace.HostSession()  # the profiler's first start (seconds) outside the window
    session.start()
    window.warm(1)
    session.stop()
    session = hosttrace.HostSession()
    spans.enable()
    try:
        stats = window.run(2.0, session, (0, caps.ring))
    finally:
        spans.disable()
    records, counters = spans.drain()
    session.read()
    index = hosttrace.SpanIndex(records)
    launched = {h.correlation: h.start_ns for h in session.launches}
    k1 = [c for (_, _, c), e in zip(session.device_ns(), session.events) if trace.K1_KERNEL in e.name]
    assert len(k1) >= 0.995 * stats["traced_blocks"] > 100
    inside = sum(1 for c in k1 if c in launched and index.at(launched[c]) == "k1")
    assert inside >= 0.995 * len(k1), (inside, len(k1))
    assert counters["track.blocks"] == stats["blocks"]

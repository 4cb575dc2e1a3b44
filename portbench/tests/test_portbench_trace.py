"""The roofline and idle-share arithmetic, from shapes and a synthetic
trace."""

import pytest

from portbench import roofline, trace
from portbench.tests._tiny import BENCH


def test_track_bounds_at_the_gps_cell():
    # 64 x 12 channels, 1000 ms of 2046 samples, 2K+1 = 9 lags.
    flops = roofline.step_flops(1000, 2046, 768, 4)
    assert flops == pytest.approx(8 * 1000 * 2046 * 768 * 9)
    assert 1e3 * flops / roofline.BF16_OPS_PER_S == pytest.approx(0.1144, rel=1e-3)
    words = 1000 * 64 * 2046 * 2 + 4 * 1000 * 11 * 768
    assert roofline.bound_ms(words) == pytest.approx(0.0882, rel=1e-2)
    # K1: 2 x 9 lags read, 11 rows written, the carry in and out, 4 bytes each.
    k1_bytes = 4 * (2 * 1000 * 768 * 9 + 1000 * 11 * 768 + 2 * 12 * 768)
    assert roofline.k1_bound_ms(1000, 768, 4) == pytest.approx(1e3 * k1_bytes / 3.35e12)


def _events():
    E = trace.DeviceEvent
    return [E("void (anonymous namespace)::fixup_kernel<4>(float const*)", 100.0, 50.0),
            E("sm90_xmma_gemm_bf16", 0.0, 40.0),
            E("void at::native::elementwise_kernel<128, 4>(int)", 30.0, 30.0),  # overlaps
            E("Memcpy DtoH (Device -> Pinned)", 200.0, 20.0)]


def _records(base_ns=1_792_320_111_715_776_620):
    """The profiler's records of ``_events``, in ns from a clock's epoch."""
    raw = [(True, e.name, base_ns + int(e.start_us * 1e3), int(e.dur_us * 1e3)) for e in _events()]
    raw.append((False, "cudaLaunchKernel", base_ns - 5000, 500_000))
    return raw


def test_busy_idle_and_breakdown_from_a_synthetic_trace():
    events = trace.device_events(_records())
    assert [e.start_us for e in events] == [0.0, 30.0, 100.0, 200.0]
    # Union: [0, 60] + [100, 150] + [200, 220] = 130 us.
    assert trace.busy_s(events) == pytest.approx(130e-6)
    gaps = dict(trace.idle_gaps(events))
    assert gaps == pytest.approx({"at::native::elementwise_kernel -> (anonymous namespace)::fixup_kernel": 40e-6,
                                  "(anonymous namespace)::fixup_kernel -> Memcpy DtoH": 50e-6})
    ops = trace.device_ops(events)
    assert ops[0] == ["(anonymous namespace)::fixup_kernel", pytest.approx(50e-6)]

    class Session:
        def __init__(self, ev):
            self.events = ev

        def window_s(self):
            return 400e-6

    ctx = {"session": Session(events), "stats": {"traced_blocks": 2},
           "shape": {"block_ms": 1000, "channels": 768, "streams": 64, "samples_per_ms": 2046,
                     "k_half": 4}}
    assert trace.k1_ms(ctx) == pytest.approx(0.025)
    assert trace.phase1_ms(ctx) == pytest.approx((40 + 30) / 2 / 1e3)
    import importlib.util

    def reader(name):
        spec = importlib.util.spec_from_file_location(name, BENCH / "metrics" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    assert reader("device.idle_pct")(ctx) == pytest.approx(100 * (1 - 130 / 400))
    assert reader("k1_roofline")(ctx) == pytest.approx(
        100 * roofline.k1_bound_ms(1000, 768, 4) / 0.025)
    step = 1e3 * roofline.step_flops(1000, 2046, 768, 4) / roofline.BF16_OPS_PER_S
    assert reader("step_mfu")(ctx) == pytest.approx(100 * step / (0.025 + 0.035))
    assert reader("k1.dev_ms")({**ctx, "session": None}) is None


def _reader(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_card_rate_over_the_whole_window():
    """Channel-seconds over the card's computing seconds (copies to the host
    left out); nothing when the trace
    missed more than one block's K1 in 200 or covers part of the window."""
    E = trace.DeviceEvent
    events = [E("fixup_kernel", 0.0, 100.0), E("gemm", 150.0, 50.0),
              E("Memcpy DtoH (Device -> Pinned)", 200.0, 400.0),  # the host's, left out
              E("fixup_kernel", 1000.0, 100.0), E("gemm", 1050.0, 100.0)]  # busy 300 us

    class Session:
        pass

    session = Session()
    session.events = events
    shape = {"block_ms": 1000, "channels": 768}
    read = _reader("card_track_rate")
    ctx = {"session": session, "stats": {"blocks": 2, "traced_blocks": 2}, "shape": shape,
           "block_kernel": trace.K1_KERNEL}
    assert read(ctx) == pytest.approx(2 * 768 * 1.0 / 300e-6)
    assert read({**ctx, "stats": {"blocks": 3, "traced_blocks": 3}}) is None  # 1 of 3 K1 lost
    # One K1 record lost in 300 blocks is read; two are not.
    many = [E("fixup_kernel", 1000.0 * i, 100.0) for i in range(299)]
    one_lost = {**ctx, "session": session, "stats": {"blocks": 300, "traced_blocks": 300}}
    session.events = many
    assert read(one_lost) == pytest.approx(300 * 768 / (299 * 100e-6))
    session.events = many[:-1]
    assert read(one_lost) is None
    session.events = events
    assert read({**ctx, "stats": {"blocks": 3, "traced_blocks": 2}}) is None  # part of the window
    assert read({**ctx, "session": None}) is None
    assert read({**ctx, "block_kernel": None}) is None  # no kernel to count the loss by
    assert read({**ctx, "block_kernel": "gemm"}) == pytest.approx(2 * 768 * 1.0 / 300e-6)
    wall = {"stats": {"blocks": 2, "wall_s": 0.5, "latency_s": [0.01 * i for i in range(1, 21)]},
            "shape": shape}
    assert _reader("host_track_rate")(wall) == 2 * 768 / 0.5
    assert _reader("host_block_p95_ms")(wall) == pytest.approx(190.5)

"""The port's observability modules (obs/visualizer.py, obs/dashboard_client.py,
obs/dashboard_server.py) against the JAX package's, and the replay flags
that drive them (--render-figures, --web-ui) and the global --profile-dir.

One port Receiver(device="cpu") runs the 3 s, PRN 25 scene of
tests/test_obs.py:22-28 once; its (receiver, report) pairs feed both
packages' visualizers and clients, which must give byte-identical PNGs and
equal payloads. The bars are tests/test_obs.py's, on the port's modules,
and each package's client must work against the other package's server.
"""

import tests._torch_cpu  # noqa: F401  # isort: skip (first: caps torch's threads)

import base64
import io
import json
import logging
import threading
import urllib.request

import numpy as np
import pytest

from gypsum_tpu.obs import dashboard_server as jax_dashboard_server
from gypsum_tpu.obs.dashboard_client import DashboardClient as JaxDashboardClient
from gypsum_tpu.obs.visualizer import TrackerVisualizer as JaxTrackerVisualizer
from gypsum_tpu_torch.core.config import ObservabilityConfig, ReceiverConfig, TrackingConfig
from gypsum_tpu_torch.io.sources import ArraySampleSource
from gypsum_tpu_torch.obs import dashboard_server
from gypsum_tpu_torch.obs.dashboard_client import DashboardClient
from gypsum_tpu_torch.obs.metrics import ReceiverMetrics
from gypsum_tpu_torch.obs.visualizer import TrackerVisualizer
from gypsum_tpu_torch.runtime.receiver import Receiver
from gypsum_tpu_torch.signal.synth import SyntheticSatellite, synthesize_iq

FS = 2.046e6
L = 2046
# The metrics' wall-clock figures: two clients fed the same reports at two
# moments differ in these and in nothing else.
WALL_KEYS = ("wall_seconds", "msamples_per_sec", "realtime_factor")


def scene_iq() -> np.ndarray:
    sat = SyntheticSatellite(prn=25, doppler_hz=900.0, delay_samples=400, amplitude=0.25)
    return synthesize_iq([sat], 3000 * L, FS, noise_sigma=0.3, seed=5)


@pytest.fixture(scope="module")
def shared_run():
    """(receiver, reports) of one port run over the 3 s scene, 500 ms blocks."""
    cfg = ReceiverConfig(tracking=TrackingConfig(block_size_ms=500))
    recv = Receiver(ArraySampleSource(scene_iq(), FS), cfg, eligible_prns=[25], device="cpu")
    reports = []
    recv.add_block_listener(lambda r, report: reports.append(report))
    recv.run()
    return recv, reports


def feed(listener, shared_run, blocks=None) -> None:
    recv, reports = shared_run
    for report in reports[:blocks]:
        listener(recv, report)


def png_pixels(b64: str) -> np.ndarray:
    import matplotlib.image

    png = base64.b64decode(b64)
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    return matplotlib.image.imread(io.BytesIO(png), format="png")


class Server:
    """One package's dashboard server on 127.0.0.1:0 in a thread."""

    def __init__(self, module) -> None:
        self.httpd = module.ThreadingHTTPServer(("127.0.0.1", 0), module._Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}/"
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()

    def get(self, route: str = "") -> bytes:
        with urllib.request.urlopen(self.url + route, timeout=10) as resp:
            return resp.read()

    def state(self) -> dict:
        return json.loads(self.get("state.json"))

    def config(self) -> ObservabilityConfig:
        return ObservabilityConfig(dashboard_url=self.url, dashboard_scan_period_s=0.0)


def test_receiver_has_what_the_figures_read(shared_run):
    """The visualizer reads these through getattr: a renamed attribute would
    blank the figure's nav tiles without an error."""
    recv, _ = shared_run
    assert isinstance(recv.pipelines, dict) and 25 in recv.pipelines
    assert recv.pipelines[25].integrator is not None and recv.pipelines[25].decoder is not None
    assert hasattr(recv.world, "satellites_with_ephemeris") and hasattr(recv.world, "_sats")
    # What the dashboard client reads (tracked PRNs leave the eligible set).
    assert recv.eligible_prns == set() and recv.bank.tracked_prns == [25]


def test_metrics_listener(shared_run):
    """tests/test_obs.py:32-45 on the port's receiver."""
    metrics = ReceiverMetrics()
    feed(metrics.on_block, shared_run)
    snap = metrics.snapshot()
    assert snap["signal_seconds"] == pytest.approx(3.0)
    assert snap["blocks"] == 6
    assert snap["acquisitions"] >= 1
    ch = snap["channels"][25]
    assert abs(ch["doppler_hz"] - 900.0) < 10
    assert metrics.msamples_per_sec > 0
    assert "Msps" in metrics.summary_line()


def test_visualizer_png_identical_to_jax(shared_run):
    """Both packages' visualizers fed the same reports render the same bytes;
    the PNG for PRN 25 decodes (tests/test_obs.py:49-59)."""
    pytest.importorskip("matplotlib")
    port, jax_vis = TrackerVisualizer(render_period_s=1.0), JaxTrackerVisualizer(render_period_s=1.0)
    for vis in (port, jax_vis):
        feed(vis.on_block, shared_run, blocks=2)  # one render, at 0.5 s
    assert set(port.rendered_png_base64) == {25}
    assert port.rendered_png_base64 == jax_vis.rendered_png_base64
    pixels = png_pixels(port.rendered_png_base64[25])
    assert pixels.ndim == 3 and pixels.shape[0] > 500 and pixels.std() > 0


def test_visualizer_without_matplotlib_warns_once(shared_run, monkeypatch, caplog):
    import builtins

    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name == "matplotlib" or name.startswith("matplotlib."):
            raise ImportError("No module named 'matplotlib'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    vis = TrackerVisualizer(render_period_s=0.5)
    with caplog.at_level(logging.WARNING, logger="gypsum_tpu_torch.obs.visualizer"):
        feed(vis.on_block, shared_run)
    assert vis.rendered_png_base64 == {}
    warnings = [r for r in caplog.records if "matplotlib" in r.getMessage()]
    assert len(warnings) == 1 and warnings[0].levelno == logging.WARNING


def test_dashboard_server_and_client_loop(shared_run):
    """tests/test_obs.py:63-93 on the port's server and client."""
    with Server(dashboard_server) as server:
        client = DashboardClient(server.config())
        feed(client.on_block, shared_run, blocks=4)
        assert client._connected
        state = server.state()
        assert state["metrics"]["blocks"] >= 1
        assert 25 in state["tracked_prns"]
        html = server.get().decode()
        assert "gypsum_tpu" in html and "initPanel" in html  # double-buffered panels
        for route, needle in [
            ("satellite_infos", "PRN 25"),
            ("receiver_stats", "Signal time"),
            ("tracker_visualizers", "<body>"),
        ]:
            assert needle in server.get(route).decode()


def test_clients_cross_wired_push_equal_payloads(shared_run):
    """The port's client against the JAX server and the JAX client against
    the port's server, fed the same reports: each server holds what its
    client pushed, and the two payloads are equal as JSON (the metrics'
    wall-clock figures aside)."""
    with Server(jax_dashboard_server) as jax_server, Server(dashboard_server) as port_server:
        port_client = DashboardClient(jax_server.config())
        jax_client = JaxDashboardClient(port_server.config())
        for client in (port_client, jax_client):
            feed(client.on_block, shared_run)
            assert client._connected
        got = {}
        for name, server in (("port client", jax_server), ("jax client", port_server)):
            state = server.state()
            assert state["metrics"]["blocks"] >= 1 and state["tracked_prns"] == [25]
            assert "PRN 25" in server.get("satellite_infos").decode()
            for key in WALL_KEYS:
                state["metrics"].pop(key)
            got[name] = state
        assert got["port client"] == got["jax client"]


def test_visualizer_renders_sbas_channel():
    """tests/test_obs.py:96-116 on the port: an SBAS channel renders its
    frame-sync / MT9 tiles."""
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(4)
    symbols = (rng.integers(0, 2, size=750) * 2 - 1).astype(np.int8)
    sat = SyntheticSatellite(prn=120, doppler_hz=-25.0, delay_samples=300,
                             amplitude=0.25, nav_bits=symbols, symbol_periods=2)
    iq = synthesize_iq([sat], 3000 * L, FS, noise_sigma=0.3, seed=6)
    cfg = ReceiverConfig(tracking=TrackingConfig(block_size_ms=500))
    recv = Receiver(ArraySampleSource(iq, FS), cfg, eligible_prns=[120], device="cpu")
    vis = TrackerVisualizer(render_period_s=2.0)  # renders at 0.5 and 2.5 s
    recv.add_block_listener(vis.on_block)
    recv.run(max_seconds=2.5)
    assert recv.pipelines[120].sbas is not None
    assert 120 in vis.rendered_png_base64
    png_pixels(vis.rendered_png_base64[120])


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    path = tmp_path_factory.mktemp("obs") / "prn25.npy"
    np.save(path, scene_iq())
    return path


def test_cli_render_figures_writes_png(capture, tmp_path, monkeypatch, capsys):
    pytest.importorskip("matplotlib")
    from gypsum_tpu_torch.cli.main import main

    monkeypatch.chdir(tmp_path)
    assert main(["--device", "cpu", "replay", "--file", str(capture), "--prns", "25",
                 "--duration", "1", "--render-figures"]) == 0
    assert "acquired PRN 25" in capsys.readouterr().out
    png = tmp_path / "tracker_figures" / "prn25.png"
    png_pixels(base64.b64encode(png.read_bytes()).decode())


def test_cli_profile_dir_writes_a_trace(capture, tmp_path):
    from gypsum_tpu_torch.cli.main import main

    assert main(["--device", "cpu", "--profile-dir", str(tmp_path / "prof"),
                 "acquire", "--file", str(capture)]) == 0
    traces = list((tmp_path / "prof").glob("acquire.*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)


def test_cli_profile_dir_shows_the_tracker_spans(capture, tmp_path):
    """A replay's trace holds the tracker's spans (obs/spans.py) as
    user_annotation ranges, each block's inside its ``bank.dispatch``."""
    from gypsum_tpu_torch.cli.main import main
    from gypsum_tpu_torch.obs import spans

    assert main(["--device", "cpu", "--profile-dir", str(tmp_path / "prof"), "replay", "--file",
                 str(capture), "--prns", "25", "--duration", "1"]) == 0
    assert spans.drain() == ([], {}) and spans.span("after") is spans.OFF
    (trace,) = (tmp_path / "prof").glob("replay.*.pt.trace.json")
    ranges = {}
    for e in json.loads(trace.read_text())["traceEvents"]:
        if e.get("cat") == "user_annotation":
            ranges.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    names = {"bank.dispatch", "track.block", "phase1.inputs", "phase1.wipe", "phase1.products", "k1",
             "track.carry", "bank.collect"}
    assert names <= set(ranges)
    for start, end in ranges["track.block"]:
        assert any(s <= start and end <= e for s, e in ranges["bank.dispatch"])

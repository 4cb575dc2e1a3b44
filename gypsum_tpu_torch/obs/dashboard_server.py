"""Standalone web dashboard server (separate process, stdlib only).

Reference parity: the web_dashboard gunicorn/falcon app (reference:
web_dashboard/__init__.py, receiver_dashboard.py) — the receiver process
POSTs its state as JSON and browsers poll rendered views. This version uses
only the standard library (ThreadingHTTPServer), exposes the raw state at
/state.json, and renders a self-refreshing HTML overview with per-satellite
tracker figures (base64 PNGs, like the reference's double-buffered iframes).

Routes (reference: web_dashboard/__init__.py:33-40):
  GET /                     — overview (stats + satellites + figures)
  GET /receiver_stats       — stats panel only
  GET /satellite_infos      — per-satellite table only
  GET /tracker_visualizers  — tracker figure panels only
  GET /state.json           — the raw last-posted state
  POST /                    — receiver pushes its state JSON

The overview embeds the three panels as double-buffered iframes: each panel
swaps two stacked iframes on load so refreshes never flash white (the same
technique as the reference's static/js/double_buffered_iframe.js).

Port of gypsum_tpu/obs/dashboard_server.py: the same routes and the same
JSON wire format, so either package's client talks to either package's
server.

Run:  python -m gypsum_tpu_torch.obs.dashboard_server [--port 8080]
"""

from __future__ import annotations

import argparse
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_state_lock = threading.Lock()
_state: dict | None = None


# Double-buffered iframe swap: two stacked iframes per panel; the hidden one
# reloads, and on load the visibility flips — refreshes never flash white
# (reference: web_dashboard/static/js/double_buffered_iframe.js).
_DOUBLE_BUFFER_JS = """
function initPanel(name, period) {
  const a = document.getElementById(name + '_a');
  const b = document.getElementById(name + '_b');
  let front = a;
  function swap() {
    const back = (front === a) ? b : a;
    back.onload = function() {
      back.style.visibility = 'visible';
      front.style.visibility = 'hidden';
      front = back;
      back.onload = null;
    };
    back.src = '/' + name + '?t=' + Date.now();
  }
  setInterval(swap, period);
}
initPanel('receiver_stats', 1000);
initPanel('satellite_infos', 1000);
initPanel('tracker_visualizers', 2000);
"""


def _panel(name: str, height: int) -> str:
    style = "position:absolute;top:0;left:0;width:100%;height:100%;border:0;"
    return (
        f'<div style="position:relative;height:{height}px;">'
        f'<iframe id="{name}_a" src="/{name}" style="{style}"></iframe>'
        f'<iframe id="{name}_b" src="/{name}" style="{style}visibility:hidden;"></iframe>'
        "</div>"
    )


def _render_stats() -> str:
    with _state_lock:
        state = _state
    if state is None:
        return "<html><body><p>Waiting for a receiver to connect…</p></body></html>"
    metrics = state.get("metrics", {})
    fix = metrics.get("last_fix")
    fix_html = (
        f"<p><b>Last fix:</b> {fix['lat_deg']:.6f}, {fix['lon_deg']:.6f}, "
        f"{fix['alt_m']:.0f} m (bias {fix['clock_bias_s'] * 1e6:.2f} µs, "
        f"SVs {fix['satellites']})</p>"
        if fix
        else "<p><b>Last fix:</b> none yet</p>"
    )
    return (
        "<html><body>"
        f"<p><b>Signal time:</b> {metrics.get('signal_seconds', 0):.1f} s ·"
        f" <b>Throughput:</b> {metrics.get('msamples_per_sec', 0):.2f} Msps"
        f" ({metrics.get('realtime_factor', 0):.2f}× realtime) ·"
        f" <b>Subframes:</b> {metrics.get('subframes', 0)} ·"
        f" <b>Fixes:</b> {metrics.get('fixes', 0)}</p>"
        f"{fix_html}"
        f"<p><b>Eligible for acquisition:</b> {state.get('eligible_prns', [])}</p>"
        "</body></html>"
    )


def _render_satellites() -> str:
    with _state_lock:
        state = _state
    if state is None:
        return "<html><body></body></html>"
    metrics = state.get("metrics", {})
    rows = []
    for prn, ch in sorted(metrics.get("channels", {}).items(), key=lambda kv: int(kv[0])):
        locked = "LOCKED" if ch.get("locked") else "pull-in"
        rows.append(
            f"<tr><td>PRN {prn}</td><td>{ch.get('doppler_hz', 0):+.1f} Hz</td>"
            f"<td>{ch.get('quality', 0):.2f}</td><td>{locked}</td>"
            f"<td>{ch.get('code_phase', 0):.1f}</td></tr>"
        )
    return (
        "<html><body><table border=1 cellpadding=4>"
        "<tr><th>SV</th><th>Doppler</th><th>Quality</th><th>State</th><th>Code phase</th></tr>"
        f"{''.join(rows)}</table></body></html>"
    )


def _render_figures() -> str:
    with _state_lock:
        state = _state
    if state is None:
        return "<html><body></body></html>"
    figures = "".join(
        f'<div><h3>PRN {prn}</h3><img src="data:image/png;base64,{png}"/></div>'
        for prn, png in state.get("figures", {}).items()
    )
    return f"<html><body>{figures or '<p>No tracker figures.</p>'}</body></html>"


def _render_html() -> str:
    return (
        "<html><head><title>gypsum_tpu_torch dashboard</title></head>"
        "<body><h1>gypsum_tpu_torch receiver</h1>"
        + _panel("receiver_stats", 120)
        + _panel("satellite_infos", 260)
        + _panel("tracker_visualizers", 900)
        + f"<script>{_DOUBLE_BUFFER_JS}</script>"
        "</body></html>"
    )


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, *args):  # quiet
        pass

    def _send(self, code: int, content: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(content)))
        self.end_headers()
        self.wfile.write(content)

    def do_GET(self):
        route = self.path.split("?")[0]
        if route == "/state.json":
            with _state_lock:
                payload = json.dumps(_state or {}).encode()
            self._send(200, payload, "application/json")
        elif route == "/receiver_stats":
            self._send(200, _render_stats().encode(), "text/html")
        elif route == "/satellite_infos":
            self._send(200, _render_satellites().encode(), "text/html")
        elif route == "/tracker_visualizers":
            self._send(200, _render_figures().encode(), "text/html")
        elif route == "/":
            self._send(200, _render_html().encode(), "text/html")
        else:
            self._send(404, b"not found", "text/plain")

    def do_POST(self):
        global _state
        length = int(self.headers.get("Content-Length", 0))
        try:
            data = json.loads(self.rfile.read(length))
        except json.JSONDecodeError:
            self._send(400, b"bad json", "text/plain")
            return
        with _state_lock:
            _state = data
        self._send(200, b"ok", "text/plain")


def serve(port: int = 8080) -> None:
    server = ThreadingHTTPServer(("0.0.0.0", port), _Handler)
    print(f"gypsum_tpu_torch dashboard on http://0.0.0.0:{port}/")
    server.serve_forever()


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--port", type=int, default=8080)
    serve(parser.parse_args().port)


if __name__ == "__main__":
    main()

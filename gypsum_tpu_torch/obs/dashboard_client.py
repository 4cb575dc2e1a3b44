"""Receiver-side dashboard client: discovery pings + state push.

Reference parity: gypsum/receiver.py:269-341 — scan for the dashboard
webserver every few seconds, then POST the receiver state once per second of
signal time (and immediately on every position fix). stdlib urllib only.

Port of gypsum_tpu/obs/dashboard_client.py: the same JSON payload, so either
package's client talks to either package's server.
"""

from __future__ import annotations

import json
import logging
import urllib.error
import urllib.request

from gypsum_tpu_torch.core.config import ObservabilityConfig
from gypsum_tpu_torch.obs.metrics import ReceiverMetrics

_logger = logging.getLogger(__name__)


class DashboardClient:
    def __init__(self, config: ObservabilityConfig | None = None, visualizer=None) -> None:
        self.config = config or ObservabilityConfig()
        self.metrics = ReceiverMetrics()
        self.visualizer = visualizer
        self._connected = False
        self._last_scan: float | None = None
        self._last_push: float | None = None

    # The single receiver hook: attach with receiver.add_block_listener(.on_block).
    def on_block(self, receiver, report) -> None:
        self.metrics.on_block(receiver, report)
        if self.visualizer is not None:
            self.visualizer.on_block(receiver, report)
        now = report.block_end
        if not self._connected:
            if self._last_scan is None or now - self._last_scan >= self.config.dashboard_scan_period_s:
                self._last_scan = now
                self._scan()
        if self._connected:
            due = (
                self._last_push is None
                or now - self._last_push >= self.config.dashboard_update_period_s
                or report.fix is not None  # always push on a fix (reference :146)
            )
            if due:
                self._last_push = now
                self._push(receiver)

    def _scan(self) -> None:
        try:
            with urllib.request.urlopen(self.config.dashboard_url, timeout=0.5) as resp:
                resp.read(0)
            self._connected = True
            _logger.info("dashboard webserver detected at %s", self.config.dashboard_url)
        except (urllib.error.URLError, OSError):
            pass

    def _push(self, receiver) -> None:
        payload = {
            "metrics": self.metrics.snapshot(),
            "eligible_prns": sorted(receiver.eligible_prns),
            "tracked_prns": receiver.bank.tracked_prns,
            "figures": self.visualizer.rendered_png_base64 if self.visualizer else {},
        }
        try:
            req = urllib.request.Request(
                self.config.dashboard_url,
                data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"},
                method="POST",
            )
            with urllib.request.urlopen(req, timeout=0.5) as resp:
                resp.read(0)
        except (urllib.error.URLError, OSError):
            _logger.info("lost connection to dashboard webserver")
            self._connected = False

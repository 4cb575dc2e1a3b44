"""Per-satellite tracking dashboards (matplotlib, rendered off-screen).

Reference parity: gypsum/tracker_visualizer.py — a 5x4 grid of 20 panels per
tracked satellite (GraphTypeEnum, reference: tracker_visualizer.py:78-191):
Doppler, carrier phase, PLL error + variance, IQ constellation / components /
angle, pseudosymbols, emitted bits, DLL discriminator, code phases, lock and
bit/subframe health text tiles — refreshed ~1/s and exported as base64 PNG
for the web dashboard (reference: tracker_visualizer.py:408-415).

This implementation renders from the block observations plus the host nav
layer's state (bit phase, subframe phase/polarity, counts), is pure host-side
and entirely optional (it costs nothing when not attached).

Port of gypsum_tpu/obs/visualizer.py: the same figures, byte for byte, from
the same reports. One departure: without matplotlib it logs one warning
(the JAX module renders nothing and says nothing)."""

from __future__ import annotations

import base64
import io
import logging
from collections import deque

import numpy as np

_logger = logging.getLogger(__name__)


class _ChannelHistory:
    def __init__(self, seconds: int = 5) -> None:
        n = seconds * 1000
        self.doppler = deque(maxlen=n)
        self.carrier_phase = deque(maxlen=n)
        self.quality = deque(maxlen=n)
        self.pll_error = deque(maxlen=n)
        self.dll_error = deque(maxlen=n)
        self.code_phase = deque(maxlen=n)
        self.code_phase_measured = deque(maxlen=n)
        self.locked = deque(maxlen=n)
        self.prompts = deque(maxlen=2000)
        self.symbols = deque(maxlen=2000)
        self.bits = deque(maxlen=300)


class TrackerVisualizer:
    """Attach via DashboardClient(visualizer=...) or
    receiver.add_block_listener(vis.on_block)."""

    def __init__(self, render_period_s: float = 1.0, live_window: bool = False) -> None:
        """``live_window`` opens an interactive matplotlib window per
        satellite and refreshes it in place (the reference's
        --present_matplotlib_sat_tracker mode, tracker_visualizer.py:203-210);
        it silently downgrades to off-screen rendering on a display-less
        backend (Agg cannot show windows)."""
        self.render_period_s = render_period_s
        self.live_window = live_window
        self._history: dict[int, _ChannelHistory] = {}
        self._last_render: float | None = None
        self.rendered_png_base64: dict[int, str] = {}
        self._live_figs: dict[int, object] = {}
        self._warned_no_matplotlib = False

    def on_block(self, receiver, report) -> None:
        for obs in report.observations:
            h = self._history.setdefault(obs.prn, _ChannelHistory())
            h.doppler.extend(obs.dopplers.tolist())
            h.carrier_phase.extend(obs.carrier_phases.tolist())
            h.quality.extend(obs.quality.tolist())
            h.pll_error.extend(obs.pll_errors.tolist())
            h.dll_error.extend(obs.dll_errors.tolist())
            h.code_phase.extend(obs.code_phases.tolist())
            h.code_phase_measured.extend(obs.code_phases_measured.tolist())
            h.locked.extend(obs.locked.tolist())
            h.prompts.extend(obs.prompts.tolist())
            h.symbols.extend(obs.pseudosymbol_signs.tolist())
        for prn in report.dropped_prns:
            self._history.pop(prn, None)
            self.rendered_png_base64.pop(prn, None)
            fig = self._live_figs.pop(prn, None)
            if fig is not None:  # pragma: no cover - needs a display
                import matplotlib.pyplot as plt

                plt.close(fig)
        now = report.block_end
        if self._last_render is None or now - self._last_render >= self.render_period_s:
            self._last_render = now
            self._render_all(receiver, now)

    # ------------------------------------------------------------- rendering

    def _render_all(self, receiver, now: float) -> None:
        try:
            import matplotlib
        except ImportError:
            if not self._warned_no_matplotlib:
                self._warned_no_matplotlib = True
                _logger.warning("matplotlib is not installed: no tracker figures are rendered")
            return
        if not self.live_window:
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        if self.live_window and matplotlib.get_backend().lower() == "agg":
            _logger.warning("no interactive matplotlib backend; rendering off-screen")
            self.live_window = False
        if self.live_window:
            plt.ion()
        for prn, h in self._history.items():
            if len(h.doppler) < 10:
                continue
            self.rendered_png_base64[prn] = self._render_one(plt, receiver, prn, h, now)

    def _render_one(self, plt, receiver, prn: int, h: _ChannelHistory, now: float) -> str:
        if self.live_window and prn in self._live_figs:  # pragma: no cover
            # Refresh the existing window in place (clear + redraw) instead
            # of opening a new one every render period.
            fig = self._live_figs[prn]
            fig.clf()
            axes = fig.subplots(5, 4)
        else:
            fig, axes = plt.subplots(5, 4, figsize=(13, 12), dpi=70)
        fig.suptitle(f"PRN {prn} @ {now:.1f}s")
        prompts = np.asarray(h.prompts)
        A = axes.ravel()

        def text_tile(ax, title, lines):
            ax.set_title(title)
            ax.axis("off")
            ax.text(0.05, 0.85, "\n".join(lines), va="top", family="monospace", fontsize=9)

        # Row 1: carrier loop
        A[0].plot(np.asarray(h.doppler), lw=0.7)
        A[0].set_title("Doppler (Hz)")
        A[1].plot(np.asarray(h.carrier_phase), ".", ms=1)
        A[1].set_title("carrier phase (rad)")
        A[2].plot(np.asarray(h.pll_error), lw=0.5)
        A[2].set_ylim(-0.6, 0.6)
        A[2].set_title("PLL error")
        err = np.asarray(h.pll_error)
        var = np.array([err[max(0, i - 250) : i + 1].var() for i in range(0, len(err), 50)])
        A[3].plot(var, lw=0.8)
        A[3].set_title("PLL error variance (250 ms)")

        # Row 2: constellation
        A[4].scatter(prompts.real, prompts.imag, s=2, alpha=0.35)
        A[4].axhline(0, lw=0.5), A[4].axvline(0, lw=0.5)
        A[4].set_title("IQ constellation")
        A[5].plot(prompts.real[-1000:], lw=0.6)
        A[5].set_title("I component")
        A[6].plot(prompts.imag[-1000:], lw=0.6)
        A[6].set_title("Q component")
        A[7].plot(np.angle(prompts[-1000:]), ".", ms=1.2)
        A[7].set_title("IQ angle (rad)")

        # Row 3: code loop
        A[8].plot(np.asarray(h.dll_error), lw=0.5)
        A[8].set_ylim(-1, 1)
        A[8].set_title("DLL discriminator")
        A[9].plot(np.asarray(h.code_phase), lw=0.7)
        A[9].set_title("code phase (samples)")
        A[10].plot(np.asarray(h.code_phase_measured), ".", ms=1)
        A[10].set_title("measured code phase (sub-sample)")
        A[11].plot(np.asarray(h.quality), lw=0.8)
        A[11].set_ylim(-1, 1)
        A[11].set_title("lock quality EMA")

        # Row 4: bits (pull the nav layer's bit history first so the panel
        # shows THIS render's bits, not the previous period's).
        pipe = getattr(receiver, "pipelines", {}).get(prn)
        if pipe is not None and pipe.integrator is not None:
            self._extend_bits(h, pipe.integrator)
        A[12].step(range(len(h.symbols)), np.asarray(h.symbols), lw=0.5)
        A[12].set_title("pseudosymbols")
        bits = list(h.bits)
        A[13].step(range(len(bits)), bits, lw=0.7) if bits else A[13].set_xticks([])
        A[13].set_title("emitted bits")
        A[14].plot(np.asarray(h.locked, dtype=float), lw=0.8)
        A[14].set_ylim(-0.1, 1.1)
        A[14].set_title("PLL lock state")
        # Correlation magnitude of recent prompts (the prompt peak envelope —
        # the analogue of the reference's PRN correlation profile tile).
        A[15].plot(np.abs(prompts[-1000:]), lw=0.6)
        A[15].set_title("|prompt| envelope")

        # Row 5: nav/health text tiles
        world = getattr(receiver, "world", None)
        if pipe is not None and pipe.integrator is not None:
            integ, dec = pipe.integrator, pipe.decoder
            text_tile(A[16], "bit health", [
                f"bit phase: {integ.bit_phase}",
                f"bits emitted: {integ.emitted_bit_count}",
            ])
            text_tile(A[17], "subframe health", [
                f"subframe phase: {dec.subframe_phase}",
                f"polarity: {dec.polarity}",
                f"subframes: {dec.emitted_subframe_count}",
            ])
        elif pipe is not None and pipe.sbas is not None:
            # SBAS channel: the DO-229 frame decoder replaces the bit stack.
            sb = pipe.sbas
            synced = sb._next_block_sym is not None
            text_tile(A[16], "SBAS frame sync", [
                f"synced: {synced}",
                f"polarity: {sb._polarity:+d}" if synced else "",
            ])
            geo = None
            if world is not None and prn in world._sats:
                geo = world._sats[prn].geo
            text_tile(A[17], "GEO navigation", [
                "MT9: decoded" if geo is not None else "MT9: (waiting)",
                f"t0: {geo.t0_sec_of_day:.0f}s" if geo is not None else "",
            ])
        elif pipe is not None and getattr(pipe, "glonass", None) is not None:
            # GLONASS channel: the string decoder replaces the bit stack.
            gd = pipe.glonass
            text_tile(A[16], "GLONASS strings", [
                f"decoded: {gd.strings_decoded}",
                f"rejected: {gd.strings_rejected}",
            ])
            geph = None
            if world is not None and prn in world._sats:
                geph = world._sats[prn].glonass
            text_tile(A[17], "GLONASS orbit", [
                f"ephemeris: tb={geph.tb_day_s:.0f}s slot {geph.slot}"
                if geph is not None else "ephemeris: (waiting)",
                f"k = {prn - 208:+d}",
            ])
        else:
            text_tile(A[16], "bit health", ["(no pipeline)"])
            text_tile(A[17], "subframe health", ["(no pipeline)"])
        orbit_lines = []
        if world is not None:
            orbit_lines.append(
                f"eph complete: {prn in world.satellites_with_ephemeris()}"
            )
            if world.position_fixes:
                f = world.position_fixes[-1]
                orbit_lines.append(f"last fix: {f.lat_deg:.4f},{f.lon_deg:.4f}")
                orbit_lines.append(f"alt: {f.alt_m:.0f} m")
        text_tile(A[18], "orbit / fix", orbit_lines or ["(no data)"])
        cn0 = None
        if world is not None and prn in getattr(world, "_sats", {}):
            cn0 = world._sats[prn].cn0_dbhz
        text_tile(A[19], "channel", [
            f"doppler: {h.doppler[-1]:+.1f} Hz" if h.doppler else "",
            f"quality: {h.quality[-1]:.2f}" if h.quality else "",
            f"locked: {bool(h.locked[-1])}" if h.locked else "",
            f"C/N0: {cn0:.1f} dB-Hz" if cn0 is not None else "",
        ])

        for ax in A[:16]:
            ax.tick_params(labelsize=7)
        fig.tight_layout()
        buf = io.BytesIO()
        fig.savefig(buf, format="png")
        if self.live_window:  # pragma: no cover - needs a display
            self._live_figs[prn] = fig
            fig.show()
            fig.canvas.draw_idle()
            plt.pause(0.001)
        else:
            plt.close(fig)
        return base64.b64encode(buf.getvalue()).decode()

    @staticmethod
    def _extend_bits(h: _ChannelHistory, integ) -> None:
        h.bits.clear()
        h.bits.extend(integ.recent_bits)

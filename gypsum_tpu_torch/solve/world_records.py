"""Shared world-model records: per-satellite state, fixes, 4-SV lattice.

Split from solve/world.py (round-4 verdict item 7: the 1,767-line module had
outgrown safe modification). Contains the data layer every WorldModel mixin
shares: ``_SatelliteRecord`` (time base + orbit accessors),
``ReceiverSolution`` (the published fix), the orbit event, and the
canonical +/-1 ms 4-SV hypothesis lattice.

reference: gypsum/world_model.py:91-94 (fix record), :263-270 (orbit event),
:297-312 (tick time base).
"""

from __future__ import annotations

import numpy as np
from dataclasses import dataclass, field

from gypsum_tpu_torch.core.events import Event
from gypsum_tpu_torch.nav.subframes import Subframe1, Subframe2, Subframe3
from gypsum_tpu_torch.solve.ephemeris import (
    Ephemeris,
    clock_correction,
    ephemeris_from_subframes,
    satellite_position,
)
from gypsum_tpu_torch.solve.fix import solve_position
from gypsum_tpu_torch.solve.geodesy import ecef_to_lla


def _plausible_altitude(p: np.ndarray) -> bool:
    """Terrestrial-through-aviation receiver shell. Altitude only: the clock
    bias is legitimately large on early fix rounds (the slide hasn't
    settled), and a common-mode shift can't be repaired by the canonical
    lattice anyway — gating on bias fired spuriously in the campaign
    (seed 23) on a fix whose altitude was fine."""
    alt = ecef_to_lla(p)[2]
    return -1000.0 < alt < 20_000.0


def enumerate_4sv_hypotheses(
    sat_pos: np.ndarray, transit: np.ndarray, newton_iterations: int
) -> dict[tuple, tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Enumerate the canonical +/-1 ms lattice around a 4-SV transit set.

    A common shift across all satellites is absorbed by the clock bias, so
    hypotheses are canonicalized with dk[0] = 0 (27 solves). Returns
    {position_key: (dk, candidate_transit, position)} for every hypothesis
    whose re-solved position lies in the plausible-receiver shell; among
    equivalent hypotheses for one position the fewest-slips representative
    is kept. Shared by WorldModel._repair_four_satellite and the ambiguity
    measurement study (tools/lattice_study.py)."""
    import itertools

    n = len(transit)
    groups: dict[tuple, tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
    for dks in itertools.product((-1, 0, 1), repeat=n - 1):
        dk = np.array((0,) + dks, dtype=int)
        cand = transit + dk * 1e-3
        p2, b2 = solve_position(
            sat_pos, cand, initial_position=None, initial_bias=0.0,
            iterations=newton_iterations,
        )
        if not _plausible_altitude(p2):
            continue
        key = tuple(np.round(p2 / 200.0).astype(int))  # merge equivalents
        cur = groups.get(key)
        if cur is None or np.abs(dk).sum() < np.abs(cur[0]).sum():
            groups[key] = (dk, cand, p2)
    return groups


@dataclass(frozen=True)
class ReceiverSolution:
    """reference: gypsum/world_model.py:91-94."""

    clock_bias_s: float
    ecef: np.ndarray  # [3] meters
    lat_deg: float
    lon_deg: float
    alt_m: float
    satellites_used: tuple[int, ...]
    receiver_timestamp: float
    # Doppler-based velocity solve (solve/velocity.py — a capability the
    # reference lacks); None when fewer than 4 Doppler measurements exist.
    velocity_ecef_mps: np.ndarray | None = None
    clock_drift_s_per_s: float | None = None
    # Geometry quality (gdop/pdop/tdop; solve/fix.py:dilution_of_precision).
    dop: dict[str, float] | None = None
    # SBAS-style protection levels (hpl_m/vpl_m; solve/integrity.py) — the
    # certified bound on undetected position error. None below 4 SVs.
    protection: dict[str, float] | None = None
    # RAIM chi-square fault-detection result (solve/integrity.py:
    # raim_residual_test). ok=False means the post-fit residuals were
    # inconsistent with the formal sigmas and ``protection`` above was
    # computed from residual-scaled sigmas. None = no redundancy (dof < 1).
    raim: dict | None = None
    # "lsq": per-epoch least-squares fix (>= 4 satellites, the primary).
    # "ekf": navigation-filter coast solution bridging a < 4-satellite
    # outage (solve/ekf.py — no reference analogue).
    kind: str = "lsq"
    # GPS SVs whose pseudoranges carried an SBAS fast correction
    # (solve/sbas_corrections.py) in this solve.
    sbas_corrected: tuple[int, ...] = ()
    # Dual-constellation solves: the receiver's GLONASS clock bias minus its
    # GPS clock bias (hardware inter-channel delays + the residual
    # GPS-GLONASS time offset). None for single-constellation fixes.
    inter_system_bias_s: float | None = None
    # Satellites whose iono correction was MEASURED from the dual-frequency
    # L2-L1 code difference this solve (prn -> slant L1 group delay in
    # meters; solve/world_multiconstellation.py:measured_iono_l1_s). None
    # when no dual-frequency channel contributed.
    iono_measured_m: dict | None = None


@dataclass(frozen=True)
class DeterminedSatelliteOrbitEvent(Event):
    """reference: gypsum/world_model.py:263-270."""

    prn: int
    ephemeris: Ephemeris


@dataclass
class _SatelliteRecord:
    sf1: Subframe1 | None = None
    sf2: Subframe2 | None = None
    sf3: Subframe3 | None = None
    ephemeris: Ephemeris | None = None
    # SBAS GEO channels (PRNs 120-138) carry their orbit as an MT9 ECEF
    # polynomial instead of Keplerian subframes (nav/sbas.py).
    geo: "object | None" = None  # GeoNavigationMessage
    # GLONASS channels (ids 201-214) carry theirs as a state vector
    # integrated in the rotating frame (solve/glonass.py). ``sv_tow``
    # values for these records live in the GPS-comparable frame; the
    # deterministic UTC+3h/leap mapping converts back to the GLONASS day
    # for orbit/clock evaluation (the sub-us residual inter-system offset
    # rides the pseudoranges and is solved as the per-constellation bias).
    glonass: "object | None" = None  # GlonassEphemeris
    leap_seconds: int = 18
    # Per-channel carrier frequency for carrier-smoothing / code-drift
    # projection (None = GPS L1; GLONASS channels set their FDMA carrier).
    carrier_hz: float | None = None
    # GLONASS frame context: tk of the last string-1 frame + the receiver
    # time of that string's trailing edge, and the pending strings 1-4
    # ([m] -> (GlonassString, edge_rx)) for ephemeris assembly.
    glo_tk: float | None = None
    glo_tk_edge_rx: float | None = None
    glo_pending: dict = field(default_factory=dict)
    # Time base
    tow_at_last_subframe: float | None = None  # s of week (next-subframe edge)
    prn_ticks_since_subframe: int = 0
    counting: bool = False
    code_phase_delay_s: float = 0.0  # sub-ms arrival offset of the PRN edge
    doppler_hz: float | None = None  # last measured carrier Doppler
    cn0_dbhz: float | None = None  # last block's C/N0 estimate (obs/cn0.py)
    # Last block's NCO carrier-phase advance (cycles) + its duration, for
    # the TDCP velocity solve; None when the loop was not locked throughout.
    tdcp_cycles: float | None = None
    tdcp_dt_s: float = 0.0
    # Hatch-filtered sub-ms delay (carrier-smoothed pseudorange) + its
    # averaging depth (grows until the configured window).
    smoothed_delay_s: float | None = None
    smoothing_depth: int = 0
    # GLONASS L2OF dual-frequency state (band="glonass_l2" receiver): the
    # Hatch-filtered L2 code delay on the L2 carrier, its depth, the L2
    # carrier frequency, and the block-end time of the last L2 update (the
    # measured iono correction goes stale after
    # SolverConfig.l2_iono_max_age_s without one).
    l2_delay_s: float | None = None
    l2_smoothing_depth: int = 0
    l2_carrier_hz: float | None = None
    l2_updated_at: float | None = None
    l2_cn0_dbhz: float | None = None
    # Long-window average of the wrapped L2-L1 delay difference (seconds):
    # the difference is GEOMETRY-FREE (only the dispersive iono, moving at
    # cm/s), so unlike the range-tracking Hatch filter it can average far
    # beyond carrier_smoothing_window — per-SV iono noise shrinks with the
    # whole track length (SolverConfig.l2_iono_smoothing_window cap).
    iono_diff_s: float | None = None
    iono_diff_depth: int = 0
    # FDMA cross-channel ghost (solve/world_multiconstellation.py): the SP
    # code is shared by every GLONASS satellite, so a strong neighbor can
    # leak into a vacant sub-band, false-acquire there, and decode the SAME
    # navigation strings — detected when two channels decode one orbital
    # slot. The weaker channel is flagged; the receiver drops it and it
    # never enters a fix. (Campaign finding: a ghost ranged into a fix
    # moved it 335 m.)
    glonass_ghost: bool = False
    # Vector-coast flag (runtime/receiver.py): the channel is being driven
    # open-loop from predicted geometry — its "observables" are predictions,
    # so it must not feed the fix (excluded by _fix_ready_satellites).
    coasting: bool = False
    # Deep-integration ranging flag (track/deepmeas.py): this block's
    # coasting observables came from a genuine narrow-window correlation
    # MEASUREMENT, not the prediction — admissible to the fix when fewer
    # than four healthy channels remain (_fix_ready_satellites).
    deep_ranging: bool = False
    # Single-entry memo for (position, clock) at a given SV time: the fix's
    # outer rounds (SolverConfig.outer_rounds) re-evaluate the SAME sv_tow —
    # only the atmospheric corrections change per round. Bumping
    # orbit_version on any ephemeris/MT9 update invalidates both. (Joined
    # the pickled state in checkpoint v6.)
    orbit_version: int = 0
    _pos_cache: "tuple | None" = None
    _clk_cache: "tuple | None" = None

    def try_complete(self) -> Ephemeris | None:
        if self.sf1 is None or self.sf2 is None or self.sf3 is None:
            return None
        was = self.ephemeris
        self.ephemeris = ephemeris_from_subframes(self.sf1, self.sf2, self.sf3)
        self.orbit_version += 1
        return self.ephemeris if was is None else None

    # Orbit/clock accessors shared by the solver paths: Kepler ephemeris for
    # GPS records, the MT9 ECEF polynomial for SBAS GEO records.

    @property
    def has_orbit(self) -> bool:
        return (
            self.ephemeris is not None
            or self.geo is not None
            or self.glonass is not None
        )

    def _glonass_day(self, sv_tow: float) -> float:
        from gypsum_tpu_torch.solve.glonass import glonass_day_time_from_gps_sow

        return glonass_day_time_from_gps_sow(sv_tow, self.leap_seconds)

    def sv_position(self, sv_tow: float, kepler_iterations: int) -> np.ndarray:
        key = (sv_tow, kepler_iterations, self.orbit_version)
        if self._pos_cache is not None and self._pos_cache[0] == key:
            return self._pos_cache[1]
        if self.ephemeris is not None:
            pos = satellite_position(
                self.ephemeris, sv_tow, kepler_iterations=kepler_iterations
            )
        elif self.glonass is not None:
            from gypsum_tpu_torch.solve.glonass import glonass_satellite_position

            pos = glonass_satellite_position(self.glonass, self._glonass_day(sv_tow))
        else:
            pos = self.geo.position_velocity(sv_tow % 86400.0)[0]
        self._pos_cache = (key, pos)
        return pos

    def sv_velocity(self, sv_tow: float, kepler_iterations: int) -> np.ndarray:
        if self.ephemeris is not None:
            from gypsum_tpu_torch.solve.velocity import satellite_velocity

            return satellite_velocity(
                self.ephemeris, sv_tow, kepler_iterations=kepler_iterations
            )
        if self.glonass is not None:
            from gypsum_tpu_torch.solve.glonass import glonass_satellite_velocity

            return glonass_satellite_velocity(self.glonass, self._glonass_day(sv_tow))
        return self.geo.position_velocity(sv_tow % 86400.0)[1]

    def sv_clock_correction(self, t: float, iterations: int) -> float:
        key = (t, iterations, self.orbit_version)
        if self._clk_cache is not None and self._clk_cache[0] == key:
            return self._clk_cache[1]
        if self.ephemeris is not None:
            val = float(clock_correction(self.ephemeris, t, iterations=iterations))
        elif self.glonass is not None:
            from gypsum_tpu_torch.solve.glonass import glonass_clock_ahead_s

            val = float(glonass_clock_ahead_s(self.glonass, self._glonass_day(t)))
        else:
            val = float(self.geo.clock_correction_s(t % 86400.0))
        self._clk_cache = (key, val)
        return val

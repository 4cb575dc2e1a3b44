"""WorldModel mixin: integer-millisecond pseudorange repair + FDE.

Split from solve/world.py (round-4 verdict item 7). The millisecond-
ambiguity machinery: residual-driven +/-1 ms snaps with persistence into
the tick counters, exhaustive leave-k-out fault exclusion, and the
canonical 27-hypothesis lattice repair for exactly-4-satellite epochs.

No reference analogue (gypsum trusts its transit times unconditionally).
"""

from __future__ import annotations

import logging

import numpy as np

from gypsum_tpu_torch.core.constants import SPEED_OF_LIGHT_M_PER_S as C
from gypsum_tpu_torch.solve.fix import solve_position
from gypsum_tpu_torch.solve.geodesy import ecef_to_lla
from gypsum_tpu_torch.solve.world_records import (
    _plausible_altitude,
    enumerate_4sv_hypotheses,
)

_logger = logging.getLogger(__name__)


class RepairMixin:
    """Integer-millisecond repair + FDE for WorldModel."""

    def _repair_millisecond_ambiguities(
        self,
        prns: list[int],
        sat_pos: np.ndarray,
        transit: np.ndarray,
        pos: np.ndarray,
        bias: float,
    ) -> np.ndarray:
        """Detect and repair per-satellite integer-millisecond pseudorange
        errors (the classic coarse-time GNSS ambiguity repair).

        A +/-1 navigation-bit-phase error in the integrator shifts every
        timestamp of that satellite by exactly one pseudosymbol (1 ms =
        ~300 km of range) while its bits still decode — randomized campaigns
        produced exactly this failure. With >= 5 satellites the wrong one
        sticks out as a ~ k * 300 km residual against the solved position;
        snap it back by the integer millisecond and let the next outer round
        re-solve. (With only 4 satellites the system is exactly determined
        and residuals vanish, so nothing can be detected here — the 1 ms
        error is then visible only as an implausible fix — the 4-SV branch
        detects exactly that and enumerates the hypothesis lattice.)"""
        if len(prns) < 4:
            return transit
        if len(prns) == 4:
            return self._repair_four_satellite(prns, sat_pos, transit, pos, bias)

        def rms_m(tr, p, b):
            ranges = np.linalg.norm(sat_pos - p[None, :], axis=1)
            r = C * (tr - b) - ranges
            r = r - r.mean()  # common part belongs to the clock bias
            return float(np.sqrt(np.mean(r * r)))

        def median_snap(tr, p, b):
            """Hypothesis straight from the residual structure: demean the
            per-SV residuals by their MEDIAN (robust to a minority of
            slipped satellites) and round to integer milliseconds. Catches
            multi-slip patterns in one step where greedy descent falls into
            the complement path's local minimum (campaign seed 26: 2 of 8
            slipped; the 6-step complement walk plateaus)."""
            ranges = np.linalg.norm(sat_pos - p[None, :], axis=1)
            r = C * (tr - b) - ranges
            r_ms = (r - np.median(r)) / (C * 1e-3)
            return -np.round(r_ms).astype(int)

        def plausible(p, b):
            # Terrestrial receiver shell (+/- ~60 km of the geoid) and a sane
            # clock bias: integer-ms lattice points other than the truth are
            # near-degenerate in RMS but land far off the Earth's surface.
            return 6.30e6 < float(np.linalg.norm(p)) < 6.44e6 and abs(b) < 0.01

        base_rms = rms_m(transit, pos, bias)
        if base_rms < 1000.0:  # meters — consistent set, nothing to repair
            return transit
        # Newton smears a 1 ms outlier across every residual (the wrong
        # position absorbs most of it), so integer-snapping single residuals
        # fails. Greedy coordinate descent over per-satellite integer-ms
        # shifts instead. Acceptance is a 10% RMS improvement — NOT a
        # halving, and NOT plausibility: with k simultaneous slips, fixing
        # one of them improves RMS only ~sqrt((k-1)/k) (k=2 -> 0.71,
        # k=4 -> 0.87), and the intermediate position is still far off the
        # Earth shell (campaign seed 16: two +1 ms slips, unrepairable
        # under the old halve-and-be-plausible step gate). Plausibility and
        # consistency are enforced once, on the FINAL candidate, before any
        # tick correction commits.
        best = (base_rms, transit.copy(), np.zeros(len(prns), dtype=int), pos, bias)

        def try_exclusion(state):
            """Fault detection & exclusion, exhaustive leave-k-out: find the
            smallest set of satellites whose removal leaves a self-consistent
            subset (>= 5 kept, so consistency is a real statement), then
            read each excluded SV's integer-ms offset directly against that
            CLEAN solution — no smearing, so decoys snap to 0 and true
            slips to their k. Exhaustive, not greedy-by-largest-residual:
            with 2 of 8 slipped, Newton smearing makes a NON-slipped SV the
            largest residual (campaign seed 26), so residual ranking chases
            decoys. Cost is bounded: C(12,1)+C(12,2)+C(12,3) ~ 300 tiny
            host-side solves in the worst case, on a path that only runs
            for already-inconsistent epochs."""
            import itertools

            rms0, tr0, k0, _p0, _b0 = state
            n = len(tr0)
            found = None
            for k in range(1, min(3, n - 5) + 1):
                for excl in itertools.combinations(range(n), k):
                    active = [i for i in range(n) if i not in excl]
                    p_a, b_a = solve_position(
                        sat_pos[active], tr0[active], initial_position=None,
                        initial_bias=0.0, iterations=self.config.newton_iterations,
                    )
                    ranges = np.linalg.norm(sat_pos[active] - p_a[None, :], axis=1)
                    r = C * (tr0[active] - b_a) - ranges
                    r = r - r.mean()
                    rms_sub = float(np.sqrt(np.mean(r * r)))
                    if rms_sub < 1000.0 and (found is None or rms_sub < found[0]):
                        found = (rms_sub, excl, p_a, b_a)
                if found is not None:
                    break
            if found is None:
                return state
            _rms_sub, excl, p_a, b_a = found
            dk = np.zeros(n, dtype=int)
            for j in excl:
                r_j = C * (tr0[j] - b_a) - np.linalg.norm(sat_pos[j] - p_a)
                dk[j] = -int(np.round(r_j / (C * 1e-3)))
            if not dk.any():
                return state
            cand = tr0 + dk * 1e-3
            p2, b2 = solve_position(
                sat_pos, cand, initial_position=None, initial_bias=0.0,
                iterations=self.config.newton_iterations,
            )
            r2 = rms_m(cand, p2, b2)
            if r2 < rms0:
                return (r2, cand, k0 + dk, p2, b2)
            return state

        def try_snap(state):
            rms0, tr0, k0, p0, b0 = state
            dk = median_snap(tr0, p0, b0)
            if not dk.any():
                return state
            cand = tr0 + dk * 1e-3
            p2, b2 = solve_position(
                sat_pos, cand, initial_position=None, initial_bias=0.0,
                iterations=self.config.newton_iterations,
            )
            r2 = rms_m(cand, p2, b2)
            if r2 < rms0:
                return (r2, cand, k0 + dk, p2, b2)
            return state

        best = try_exclusion(best)
        best = try_snap(best)
        for _pass in range(6):
            if best[0] < 1000.0:
                break
            # Evaluate EVERY single +/-1 ms step and take the best — first-
            # qualifying greedy order walked into wrong satellites when a
            # non-slipped step also cleared the threshold (two-slip sets
            # have several ~0.88 decoys next to the true 0.37 step).
            step_best = None
            for i in range(len(prns)):
                for dk in (-1, 1):
                    cand = best[1].copy()
                    cand[i] += dk * 1e-3
                    p2, b2 = solve_position(
                        sat_pos, cand, initial_position=None, initial_bias=0.0,
                        iterations=self.config.newton_iterations,
                    )
                    r2 = rms_m(cand, p2, b2)
                    if step_best is None or r2 < step_best[0]:
                        step_best = (r2, cand, i, dk, p2, b2)
            if step_best is None or step_best[0] >= 0.9 * best[0]:
                break
            r2, cand, i, dk, p2, b2 = step_best
            k2 = best[2].copy()
            k2[i] += dk
            best = (r2, cand, k2, p2, b2)
            # Re-try the residual-structure snap from the new vantage: one
            # accepted step often de-smears the residuals enough for the
            # median round to read the remaining slips directly.
            best = try_snap(best)
        final_rms, final_transit, k_vec, final_pos, final_bias = best
        if final_rms >= 1000.0 or not k_vec.any() or not plausible(final_pos, final_bias):
            if k_vec.any() or base_rms >= 1000.0:
                _logger.warning(
                    "pseudorange set inconsistent (residual RMS %.0f m) and "
                    "no plausible integer-ms repair found; leaving as-is",
                    base_rms,
                )
            return transit
        for i in np.where(k_vec != 0)[0]:
            _logger.warning(
                "PRN %d pseudorange off by %+d ms (navigation bit-phase "
                "slip); repaired (residual RMS %.0f -> %.0f m)",
                prns[i], -k_vec[i], base_rms, final_rms,
            )
            # transit = arrival - sv_tow: lowering transit by 1 ms
            # persistently means one more counted tick.
            self._sats[prns[i]].prn_ticks_since_subframe += -k_vec[i]
        return final_transit

    def _repair_four_satellite(
        self,
        prns: list[int],
        sat_pos: np.ndarray,
        transit: np.ndarray,
        pos: np.ndarray,
        bias: float,
    ) -> np.ndarray:
        """Integer-millisecond repair for the exactly-determined 4-SV case.

        Residuals vanish with 4 satellites, so a slip is visible only as an
        implausible *fix* (the seed-11 campaign failure solved 226 km below
        the ellipsoid). When the base solution leaves the plausible-receiver
        shell, enumerate the integer-ms lattice (enumerate_4sv_hypotheses).
        Accept if exactly ONE distinct position is plausible; if SEVERAL
        are, fall back to a prior-fix proximity tie-break: a hypothesis
        within ``ambiguity_tiebreak_radius_m`` of the last committed fix is
        taken when it is the unique such one (integer-ms lattice points are
        ~300 km apart, so a receiver with any position history cannot
        confuse them; measured ambiguity rates: tools/lattice_study.py).
        Otherwise leave untouched (a detected-but-unrepairable fix beats a
        wrong repair)."""
        if _plausible_altitude(pos):
            return transit
        groups = enumerate_4sv_hypotheses(
            sat_pos, transit, self.config.newton_iterations
        )
        chosen = None
        if len(groups) == 1:
            chosen = next(iter(groups.values()))
        elif len(groups) > 1 and self.position_fixes:
            prior = self.position_fixes[-1].ecef
            near = [
                g for g in groups.values()
                if np.linalg.norm(g[2] - prior) < self.config.ambiguity_tiebreak_radius_m
            ]
            if len(near) == 1:
                chosen = near[0]
                _logger.warning(
                    "4-SV integer-ms ambiguity (%d plausible positions) "
                    "broken by prior-fix proximity (%.1f km)",
                    len(groups),
                    np.linalg.norm(chosen[2] - prior) / 1e3,
                )
        if chosen is None:
            _logger.warning(
                "4-SV fix implausible (alt %.0f km) and integer-ms repair %s; "
                "leaving as-is",
                ecef_to_lla(pos)[2] / 1e3,
                "ambiguous" if groups else "found no plausible hypothesis",
            )
            return transit
        dk, cand, _pos = chosen
        if not dk.any():  # base was the unique plausible one after all
            return transit
        for i in np.where(dk != 0)[0]:
            _logger.warning(
                "PRN %d pseudorange off by %+d ms (navigation bit-phase "
                "slip, 4-SV lattice repair)", prns[i], -dk[i],
            )
            # Same persistence as the >= 5 branch: shorter transit = one
            # more counted PRN tick.
            self._sats[prns[i]].prn_ticks_since_subframe += -dk[i]
        return cand


"""SBAS fast-correction bookkeeping (DO-229 §A.4.4.2/.3 application side).

The reference receiver has no differential capability at all; here a tracked
SBAS GEO's MT1 (PRN mask) + MT2-5 (fast corrections) messages correct the GPS
pseudoranges and drive the per-satellite integrity variance:

- MT1 defines the correction sequence: the mask's set slots, ascending;
  slots 1-37 are GPS PRNs 1-37. MT2-5 carry 13 sequence entries each.
- IODP must match between the mask and a correction message, or the
  corrections are held until a matching mask arrives.
- A correction is applied as PR_corrected = PR_measured + PRC while younger
  than ``timeout_s`` (DO-229's en-route fast-correction timeout tier);
  UDREI 14 (not monitored) / 15 (do not use) disqualify the satellite's
  correction. Range-rate carriers (RRC from successive IODFs) are not
  modeled — the synthesizer's injected biases are constant (see
  signal/constellation.py unmodeled_clock_error_m).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

from gypsum_tpu_torch.nav.sbas import (
    CORRECTIONS_PER_MESSAGE,
    FastCorrections,
    PrnMask,
    UDRE_VARIANCE_M2,
)

_logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class AppliedCorrection:
    prc_m: float
    udrei: int
    sigma2_udre_m2: float
    age_s: float


class SbasCorrectionStore:
    """Latest mask + per-slot fast corrections, with staleness gating."""

    def __init__(self, timeout_s: float = 30.0) -> None:
        self.timeout_s = float(timeout_s)
        self.mask: PrnMask | None = None
        # mask slot (1-based) -> (prc_m, udrei, receiver time of the block)
        self._by_slot: dict[int, tuple[float, int, float]] = {}
        # corrections received before any/matching mask, keyed by iodp
        self._pending: list[tuple[FastCorrections, float]] = []

    # ------------------------------------------------------------- ingest

    def handle_mask(self, mask: PrnMask) -> None:
        if self.mask is not None and mask.iodp != self.mask.iodp:
            # New issue-of-data: the sequence numbering changed; old
            # corrections no longer map to slots.
            self._by_slot.clear()
        self.mask = mask
        pending, self._pending = self._pending, []
        for fc, rx_time in pending:
            self.handle_fast(fc, rx_time)

    def handle_fast(self, fc: FastCorrections, rx_time: float) -> None:
        if self.mask is None or fc.iodp != self.mask.iodp:
            self._pending.append((fc, rx_time))
            del self._pending[:-8]  # bounded
            return
        offset = (fc.message_type - 2) * CORRECTIONS_PER_MESSAGE
        for k in range(CORRECTIONS_PER_MESSAGE):
            seq = offset + k
            if seq >= len(self.mask.slots):
                break
            slot = self.mask.slots[seq]
            self._by_slot[slot] = (fc.prc_m[k], fc.udrei[k], rx_time)

    # ------------------------------------------------------------ queries

    def correction_for(self, gps_prn: int, now: float) -> AppliedCorrection | None:
        """Usable fast correction for a GPS PRN (mask slots 1-37), or None."""
        if not 1 <= gps_prn <= 37:
            return None
        entry = self._by_slot.get(gps_prn)
        if entry is None:
            return None
        prc_m, udrei, rx_time = entry
        age = now - rx_time
        if age > self.timeout_s or age < 0:
            return None
        if udrei >= 14:  # not monitored / do not use
            return None
        return AppliedCorrection(
            prc_m=prc_m, udrei=udrei,
            sigma2_udre_m2=UDRE_VARIANCE_M2[udrei], age_s=age,
        )

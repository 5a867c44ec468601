"""Online calibration metrics for interruption/price forecasts.

A forecast is only worth dollars if its probabilities mean what they
say. `CalibrationTracker` scores two things, both computed online as
the run unfolds (no post-hoc pass):

  Brier score      every `note_prediction(zone, t, p)` opens a pending
                   "will a reclaim hit this zone within `horizon_s`?"
                   question; an observed reclaim before the deadline
                   resolves it with outcome 1, deadline expiry (driven
                   by `advance(t)`) resolves it with outcome 0. The
                   score is the running mean of `(p - outcome)^2` —
                   0 is clairvoyant, 0.25 is the uninformative p=0.5.
  band coverage    every `note_band(zone, t, lo, hi)` records the
                   forecaster's current price band; the *next* price
                   sample for the zone checks whether the realized
                   price fell inside it. Empirical coverage should
                   match the nominal band mass (e.g. a (0.1, 0.9)
                   band should cover ~80% of samples).

Both metrics answer -1.0 before their first resolution, which
`ForecastUpdated` telemetry records as "not yet measurable". The
pending-prediction set is bounded by construction: one deadline per
note, expired entries drop at every `advance`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class _Pending:
    """One open interruption-within-horizon question."""
    zone: Tuple[str, str]
    deadline: float
    p: float


class CalibrationTracker:
    """Online Brier score + quantile-band coverage (module docstring)."""

    def __init__(self, horizon_s: float = 600.0):
        self.horizon_s = horizon_s
        self._pending: List[_Pending] = []
        self._brier_sum = 0.0
        self._brier_n = 0
        self._band: Dict[Tuple[str, str], Tuple[float, float]] = {}
        self._band_hits = 0
        self._band_n = 0

    # ------------------------------------------------------------------
    # Interruption-probability scoring (Brier).
    # ------------------------------------------------------------------
    def note_prediction(self, provider: str, zone: str, t: float,
                        p: float) -> None:
        """Open a question: P(reclaim in this zone before
        `t + horizon_s`) was forecast as `p`."""
        self._pending.append(_Pending((provider, zone),
                                      t + self.horizon_s, p))

    def observe_reclaim(self, provider: str, zone: str,
                        t: float) -> None:
        """A reclaim landed: every open question for the zone whose
        deadline has not passed resolves with outcome 1."""
        key = (provider, zone)
        still_open: List[_Pending] = []
        for q in self._pending:
            if q.zone == key and q.deadline >= t:
                self._brier_sum += (q.p - 1.0) ** 2
                self._brier_n += 1
            else:
                still_open.append(q)
        self._pending = still_open

    def advance(self, t: float) -> None:
        """Time moved to `t`: questions whose deadline passed without
        a reclaim resolve with outcome 0."""
        still_open: List[_Pending] = []
        for q in self._pending:
            if q.deadline < t:
                self._brier_sum += q.p ** 2
                self._brier_n += 1
            else:
                still_open.append(q)
        self._pending = still_open

    def brier(self) -> float:
        """Running mean Brier score; -1.0 before any resolution."""
        if self._brier_n == 0:
            return -1.0
        return self._brier_sum / self._brier_n

    # ------------------------------------------------------------------
    # Quantile-band coverage.
    # ------------------------------------------------------------------
    def note_band(self, provider: str, zone: str,
                  lo: float, hi: float) -> None:
        """Record the forecaster's current price band for the zone;
        the next observed price sample scores it."""
        self._band[(provider, zone)] = (lo, hi)

    def observe_price(self, provider: str, zone: str, t: float,
                      price: float) -> None:
        """Score the previously noted band (if any) against the
        realized price, then retire it."""
        band = self._band.pop((provider, zone), None)
        if band is None:
            return
        lo, hi = band
        self._band_hits += 1 if lo <= price <= hi else 0
        self._band_n += 1

    def coverage(self) -> float:
        """Empirical band coverage in [0, 1]; -1.0 before any scored
        band."""
        if self._band_n == 0:
            return -1.0
        return self._band_hits / self._band_n

    # ------------------------------------------------------------------
    def n_resolved(self) -> int:
        """How many interruption questions have resolved so far."""
        return self._brier_n

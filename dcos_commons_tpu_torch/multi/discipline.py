"""Offer disciplines: which services may GROW footprint this cycle.

Reference: scheduler/multi/OfferDiscipline.java:11-33 +
ParallelFootprintDiscipline — services already at full footprint
always get offers (launch/maintenance); reservation growth is limited
to a sticky set of at most N services, so a burst of new services
deploys N-at-a-time instead of thrashing the fleet.

Port of ``dcos_commons_tpu/multi/discipline.py``.
"""

from __future__ import annotations

from typing import List, Set


class AnyFootprintDiscipline:
    """No limit (reference: OfferDiscipline.Any)."""

    def select(self, growing: List[str]) -> Set[str]:
        return set(growing)


class ParallelFootprintDiscipline:
    def __init__(self, max_concurrent: int = 1):
        if max_concurrent < 1:
            raise ValueError("max_concurrent must be >= 1")
        self._max = max_concurrent
        self._selected: Set[str] = set()

    def select(self, growing: List[str]) -> Set[str]:
        """Sticky selection: a service keeps its slot until it stops
        growing; freed slots go to the longest-waiting services."""
        self._selected &= set(growing)
        for name in growing:
            if len(self._selected) >= self._max:
                break
            self._selected.add(name)
        return set(self._selected)

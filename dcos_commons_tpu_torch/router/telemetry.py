"""Pod telemetry behind the staleness gate — the ONE router module
allowed to touch raw ``GET /stats`` dicts.

Everything the router learns about a pod's load arrives as a stats
snapshot (serve/engine.py ``stats()``: queue depth, free decode rows,
kv_pages_free, tokens/s, and the monotonic
``stats_age_s`` wedge stamp).  Snapshots go stale two ways:

* the POLL went stale — the router failed to refresh (pod
  unreachable, poll thread behind): age is measured router-side from
  the observation clock;
* the ENGINE went stale — the pod answered /stats but its engine loop
  has not completed a tick in ``stats_age_s`` seconds (a wedged
  decode, a stuck collective): the gauges are the pod's LAST-GOOD
  numbers, exactly what a router must not balance on.

``PodTelemetry`` parses a snapshot once and answers every load
question through freshness-aware accessors, so routing code never
reads a raw gauge without the gate.  sdklint's
``router-stats-staleness`` rule enforces the boundary: outside this
module, router code may not subscript/.get() a stats dict at all.
"""

from __future__ import annotations

from typing import Optional

# a pod whose engine loop has not ticked for this many seconds is
# routed around even when its HTTP server still answers /stats (the
# serving loop and the HTTP thread are separate; the whole point of
# the stamp is telling them apart)
DEFAULT_STALE_AFTER_S = 10.0


def _as_float(value, default: float = 0.0) -> float:
    try:
        return float(value)
    except (TypeError, ValueError):
        return default


class PodTelemetry:
    """One pod's parsed load gauges + the freshness verdict.

    ``observe(stats, now)`` ingests a raw snapshot (the only raw-dict
    access in the router); ``fresh(now)`` is the staleness gate every
    reader crosses.  Accessors return pessimistic defaults for a pod
    that never reported — an unknown pod is assumed LOADED, so traffic
    prefers pods that prove their headroom.
    """

    __slots__ = (
        "stale_after_s", "observed_at", "engine_age_s", "queue_depth",
        "active_slots", "free_slots", "kv_pages_free", "kv_occupancy",
        "tokens_per_s", "prefix_hit_rate", "ttft_p95_s", "has_snapshot",
        "serving_role", "prefill_backlog",
    )

    def __init__(self, stale_after_s: float = DEFAULT_STALE_AFTER_S):
        self.stale_after_s = float(stale_after_s)
        self.observed_at: Optional[float] = None  # router monotonic
        self.engine_age_s = 0.0
        self.queue_depth = 0.0
        self.active_slots = 0.0
        self.free_slots = 0.0
        self.kv_pages_free = 0.0
        self.kv_occupancy = 0.0
        self.tokens_per_s = 0.0
        self.prefix_hit_rate = 0.0
        self.ttft_p95_s = 0.0
        self.has_snapshot = False
        # disaggregation gauges: the pod's declared
        # serving role ("" until it reports one) and its unfilled
        # prompt-token backlog — the load signal that matters on a
        # prefill pod, whose decode gauges sit near zero by design
        self.serving_role = ""
        self.prefill_backlog = 0.0

    # -- ingestion (the single raw-dict touchpoint) -------------------

    def observe(self, stats: dict, now: float) -> None:
        """Parse one ``GET /stats`` snapshot observed at router
        monotonic time ``now``.  Malformed/partial dicts degrade to
        the pessimistic defaults rather than raising — a half-written
        snapshot must not take the pod's router state down with it."""
        if not isinstance(stats, dict) or not stats:
            return
        self.observed_at = now
        self.has_snapshot = True
        self.engine_age_s = _as_float(stats.get("stats_age_s"))
        self.queue_depth = _as_float(stats.get("queue_depth"))
        self.active_slots = _as_float(stats.get("active_slots"))
        self.free_slots = _as_float(stats.get("free_slots"))
        self.kv_pages_free = _as_float(stats.get("kv_pages_free"))
        self.kv_occupancy = _as_float(stats.get("kv_occupancy"))
        self.tokens_per_s = _as_float(stats.get("tokens_per_s"))
        self.prefix_hit_rate = _as_float(stats.get("prefix_cache_hit_rate"))
        self.ttft_p95_s = _as_float(stats.get("ttft_p95_s"))
        role = stats.get("serving_role")
        if isinstance(role, str):
            self.serving_role = role
        self.prefill_backlog = _as_float(
            stats.get("prefill_chunk_backlog")
        )

    # -- the staleness gate -------------------------------------------

    def fresh(self, now: float) -> bool:
        """True when the gauges are safe to balance on: a snapshot
        exists, the router observed it recently, and the pod's own
        engine loop was alive when it was taken."""
        if not self.has_snapshot or self.observed_at is None:
            return False
        if now - self.observed_at > self.stale_after_s:
            return False  # the POLL went stale
        return self.engine_age_s <= self.stale_after_s  # engine wedge

    def load_score(self, now: float) -> Optional[float]:
        """The pod's polled-load contribution for least-loaded
        placement: waiting + running work, with a KV-headroom tiebreak
        (a pod out of pages queues the next admission even with idle
        decode rows).  ``None`` when the gauges are stale — the caller
        must fall back to router-side in-flight counts, never to the
        last-good numbers."""
        if not self.fresh(now):
            return None
        headroom_penalty = 0.0
        if self.kv_occupancy > 0.9:
            headroom_penalty = (self.kv_occupancy - 0.9) * 10.0
        score = self.queue_depth + self.active_slots + headroom_penalty
        if self.serving_role == "prefill":
            # a prefill pod's real load is its unfilled prompt
            # backlog (rows sit in _prefilling, not the queue, and
            # hand off before decode): scale tokens to request-ish
            # units so prefill pods spread like any other capacity
            score += self.prefill_backlog / 64.0
        return score

    def describe(self, now: float) -> dict:
        """Debug-surface row (front door ``GET /pods``)."""
        return {
            "fresh": self.fresh(now),
            "observed_age_s": (
                round(now - self.observed_at, 3)
                if self.observed_at is not None else None
            ),
            "engine_stats_age_s": round(self.engine_age_s, 3),
            "queue_depth": self.queue_depth,
            "active_slots": self.active_slots,
            "free_slots": self.free_slots,
            "kv_pages_free": self.kv_pages_free,
            "kv_occupancy": self.kv_occupancy,
            "tokens_per_s": self.tokens_per_s,
            "prefix_cache_hit_rate": self.prefix_hit_rate,
            "ttft_p95_s": self.ttft_p95_s,
            "serving_role": self.serving_role or "unified",
            "prefill_chunk_backlog": self.prefill_backlog,
        }

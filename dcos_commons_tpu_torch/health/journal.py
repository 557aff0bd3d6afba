"""EventJournal: a durable, capacity-bounded fleet event log.

Traceview's flight recorder answers "what spans did the last N cycles
record" — in-memory, drop-oldest, gone on restart.  The journal is the
complementary surface: a small, append-only record of the events an
operator asks about AFTER the fact — operator verbs, plan/phase
transitions, failovers and lease epochs, admission rejections,
recovery actions, and detector alerts — persisted as ONE property in
the scheduler's state store, so in HA mode it rides the lease-fenced
writer and replays to the successor after a failover (the deposed
leader's post-deposition flush is rejected by the fence and counted,
never raced in).

Capacity-bounded by construction (drop-oldest at ``capacity``
events); the sequence number is monotonic ACROSS incarnations — a
successor resumes at ``seq+1``, so ``GET /v1/debug/events?since=``
cursors held by an operator survive a failover.

Writes are batched: ``append()`` is an in-memory deque push; the
owning loop calls ``flush()`` once per cycle (and the HTTP layer
flushes after operator verbs, which deserve immediate durability).  A
store outage degrades the journal, never the scheduler: flush errors
are swallowed and counted in ``write_errors``.

Port of ``dcos_commons_tpu/health/journal.py``, line for line but the imports.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from dcos_commons_tpu_torch.storage.persister import PersisterError

JOURNAL_PROPERTY = "health-journal"
JOURNAL_PATH = "/__health__/journal"
DEFAULT_CAPACITY = 512


class StatePropertyBackend:
    """Persist the journal as a state-store property (per-service
    namespacing and HA fencing come from the store's wired persister)."""

    def __init__(self, state_store, key: str = JOURNAL_PROPERTY):
        self._state_store = state_store
        self._key = key

    def load(self) -> Optional[bytes]:
        return self._state_store.fetch_property(self._key)

    def store(self, raw: bytes) -> None:
        self._state_store.store_property(self._key, raw)


class PersisterBackend:
    """Persist the journal at a raw tree path — the multi scheduler's
    fleet-level journal (admission rejections target services that may
    not exist yet, so no service store can own them)."""

    def __init__(self, persister, path: str = JOURNAL_PATH):
        self._persister = persister
        self._path = path

    def load(self) -> Optional[bytes]:
        return self._persister.get_or_none(self._path)

    def store(self, raw: bytes) -> None:
        # durcheck: dur-unfenced-write=builder injects a FencedPersister in HA mode, so the fence lives in the instance, not this call site
        self._persister.set(self._path, raw)


class EventJournal:
    """Append/query/flush; thread-safe (HTTP verbs append from server
    threads while the cycle thread flushes)."""

    def __init__(self, backend=None, capacity: int = DEFAULT_CAPACITY):
        self._backend = backend
        # capacity 0 = the DISABLED journal (health plane off): every
        # surface stays callable, nothing is recorded or persisted
        self.capacity = max(0, int(capacity))
        self._events: deque = deque(maxlen=self.capacity or 1)
        self._seq = 0
        self._dirty = False
        self._loaded = backend is None or not self.capacity
        self.write_errors = 0
        self._lock = threading.Lock()
        # serializes snapshot+store as one unit: two racing flushes
        # (the cycle's throttled flush vs an operator verb's inline
        # flush) must persist in snapshot order, or the earlier
        # payload can land LAST and a crash-then-replay would lose the
        # newer events and re-mint their seqs.  Separate from _lock so
        # append() never blocks on store IO.
        self._flush_lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return self.capacity > 0

    # -- persistence --------------------------------------------------

    def _load_locked(self) -> None:
        if self._loaded:
            return
        self._loaded = True
        try:
            raw = self._backend.load()
        except PersisterError:
            # unreadable store at build time: start empty; the next
            # flush will overwrite (or fail and be counted)
            return
        if raw is None:
            return
        try:
            data = json.loads(raw.decode("utf-8"))
            events = data.get("events") or []
            seq = int(data.get("seq", 0))
        except (ValueError, TypeError, UnicodeDecodeError):
            return  # corrupt journal must not brick the scheduler
        for event in events:
            if isinstance(event, dict):
                self._events.append(event)
        # the persisted seq dominates the replayed tail (events may
        # have been dropped by the capacity bound before the save)
        self._seq = max(
            seq, max((e.get("seq", 0) for e in self._events), default=0)
        )

    def load(self) -> None:
        with self._lock:
            self._load_locked()

    def flush(self) -> bool:
        """Persist if dirty.  Returns True when a write happened.
        Store failures (including a deposed leader's fenced write) are
        swallowed and counted — the journal is telemetry, and the
        fence's own rejection counter tells the real story."""
        with self._flush_lock:
            with self._lock:
                if not self._dirty or self._backend is None:
                    return False
                payload = json.dumps({
                    "seq": self._seq,
                    "events": list(self._events),
                }, sort_keys=True).encode("utf-8")
                self._dirty = False
            try:
                self._backend.store(payload)
                return True
            except PersisterError:
                with self._lock:
                    self._dirty = True
                    self.write_errors += 1
                return False

    # -- append / query -----------------------------------------------

    def append(
        self, kind: str, message: str = "", t: Optional[float] = None,
        **attrs,
    ) -> dict:
        """Record one event; returns it (with its assigned seq)."""
        if not self.capacity:
            return {}
        event: Dict[str, object] = {
            "kind": str(kind),
            "t": round(time.time() if t is None else t, 3),
        }
        if message:
            event["message"] = str(message)
        for key, value in attrs.items():
            if value is None:
                continue
            event[key] = value if isinstance(
                value, (int, float, bool)
            ) else str(value)
        with self._lock:
            self._load_locked()
            self._seq += 1
            event["seq"] = self._seq
            self._events.append(event)
            self._dirty = True
        return event

    def events(
        self, since: int = 0, kinds=None, limit: int = 0
    ) -> List[dict]:
        """Events with seq > ``since``, oldest first; optionally
        filtered by kind and capped to the newest ``limit``."""
        with self._lock:
            self._load_locked()
            out = [e for e in self._events if e.get("seq", 0) > since]
        if kinds:
            kinds = set(kinds)
            out = [e for e in out if e.get("kind") in kinds]
        if limit and len(out) > limit:
            out = out[-limit:]
        return out

    @property
    def last_seq(self) -> int:
        with self._lock:
            self._load_locked()
            return self._seq

    def describe(self) -> dict:
        with self._lock:
            self._load_locked()
            return {
                "seq": self._seq,
                "events": len(self._events),
                "capacity": self.capacity,
                "write_errors": self.write_errors,
            }

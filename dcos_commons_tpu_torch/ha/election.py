# sdklint: disable-file=lease-gated-mutation — this module IS the
# lease-fenced writer: the lease record itself must be written below
# the fence (a deposed leader could never resign otherwise), and
# FencedPersister's backend calls run under the fence verification.
"""Leader election: a TTL lease with a fencing epoch, in the store.

Reference: curator/CuratorLocker.java — one active scheduler per
service, enforced by a ZooKeeper mutex; lock loss exits the process.
This module upgrades the rebuild's equivalent (a TTL lease node) from
mutual exclusion to *split-brain safety*:

* the lease record carries a monotonic **lease epoch**, bumped on
  every change of ownership.  Renewals by the current holder keep the
  epoch; a takeover (expiry, resign) mints epoch+1 — the same
  construction ``storage/replication.py`` uses to fence a superseded
  primary's replication stream, extended here to the SCHEDULER role.
* ``FencedPersister`` wraps the scheduler's persister: every mutation
  first verifies — atomically with any in-process rival's
  ``try_acquire`` — that the lease is still held at OUR epoch.  A
  deposed leader (stalled past the TTL while a standby took over)
  gets ``LeaseFencedError`` instead of a write: split-brain is
  rejected at the write path, not merely discovered at renewal time.

Atomicity scope: verification and takeover serialize on one shared
per-backend lock, so two schedulers over the SAME persister object
(the in-process race tests, the chaos harness, multi-scheduler
processes sharing a PersisterCache) can never interleave
verify-then-write with a takeover.  Across processes the lease lives
in the replicated state tree behind the primary: a takeover is a
replicated write, a deposed leader's verification read observes it,
and the residual read-then-write window is bounded by the renewal
loop firing ``on_lost`` (and the process exiting) the moment a
renewal fails — the same guarantee CuratorLocker gives.

Cost: over remote state every fenced mutation pays one extra
``read_lease`` round trip (correctness-first; the scheduler's write
rate is cycles-per-second, not writes-per-request).  The zero-cost
construction — carrying the lease epoch ON each mutation and
rejecting stale epochs inside the state server's kv lock, exactly as
``_fence`` tokens already fence replication — is the natural next
step and would also close the cross-process residual window.

Port of ``dcos_commons_tpu/ha/election.py``, line for line but the imports.
"""

from __future__ import annotations

import json
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Callable, Optional

from dcos_commons_tpu_torch.storage.persister import Persister, PersisterError

LEADER_PREFIX = "/__ha__/leaders"


class LeaseFencedError(PersisterError):
    """A store mutation was attempted by a scheduler that no longer
    holds the leader lease at its epoch.  Fatal to the writer: the
    cycle fails, ``on_lost`` fires, and the process restarts as a
    candidate (crash-to-restart, the CuratorLocker discipline)."""


# one fence lock per UNDERLYING persister object: every LeaderLease
# and FencedPersister over the same backend serializes takeover and
# verify-then-write through it
_FENCE_LOCKS: "weakref.WeakValueDictionary[int, threading.RLock]" = (
    weakref.WeakValueDictionary()
)
_FENCE_REGISTRY_LOCK = threading.Lock()
# WeakValueDictionary would drop an unreferenced lock; pin each lock
# to its persister so lock lifetime == persister lifetime
_FENCE_ATTR = "_ha_fence_lock"


def fence_lock(persister: Persister) -> threading.RLock:
    """The shared fence lock of ``persister`` (created on first use)."""
    lock = getattr(persister, _FENCE_ATTR, None)
    if lock is not None:
        return lock
    with _FENCE_REGISTRY_LOCK:
        lock = getattr(persister, _FENCE_ATTR, None)
        if lock is None:
            lock = threading.RLock()
            try:
                setattr(persister, _FENCE_ATTR, lock)
            except AttributeError:
                # slotted persister: fall back to the id-keyed registry
                # (kept alive by the caller holding the persister)
                lock = _FENCE_LOCKS.setdefault(id(persister), lock)
        return lock


@dataclass
class LeaseState:
    """One decoded lease record (absent record = epoch 0, no owner)."""

    owner: str = ""
    epoch: int = 0
    expires_at: float = 0.0

    def live(self, now: float) -> bool:
        return bool(self.owner) and self.expires_at > now


def _lease_path(name: str) -> str:
    if not name or "/" in name:
        raise PersisterError(f"invalid lease name: {name!r}")
    return f"{LEADER_PREFIX}/{name}"


def read_lease(persister: Persister, name: str) -> LeaseState:
    raw = persister.get_or_none(_lease_path(name))
    if raw is None:
        return LeaseState()
    try:
        data = json.loads(raw.decode("utf-8"))
        return LeaseState(
            owner=str(data.get("owner", "")),
            epoch=int(data.get("epoch", 0)),
            expires_at=float(data.get("expires_at", 0.0)),
        )
    except (ValueError, TypeError):
        # an unreadable record must not brick the election: treat as
        # expired at epoch 0 — the next acquire overwrites it at
        # epoch 1 and fencing proceeds from there
        return LeaseState()


class LeaderLease:
    """Acquire/renew/resign the leader lease for ``name``.

    Wall-clock expiry (the record must mean the same thing to every
    candidate host); ``clock`` is injectable so the chaos/race tests
    can expire a lease deterministically.  The object is deliberately
    thread-free: ``LeaderLock`` (and the runner) own the renewal loop,
    tests drive ``try_acquire``/``renew`` directly.
    """

    def __init__(
        self,
        persister: Persister,
        name: str,
        owner: str,
        ttl_s: float = 15.0,
        clock: Callable[[], float] = time.time,
    ):
        self._persister = persister
        self.name = name
        self.owner = owner
        self.ttl_s = ttl_s
        self.clock = clock
        self._epoch = 0
        self._is_leader = False
        # takeovers from a DIFFERENT previous holder — the
        # ha.failovers_total gauge (a bootstrap acquire of a virgin
        # lease is a first election, not a failover)
        self.takeovers = 0
        # set by HAState.attach so promote/resign events land in the
        # owning scheduler's flight recorder — and, when a journal is
        # wired, in the durable event journal (the lease-churn
        # detector's raw material survives the churn it measures)
        self.tracer = None
        self.journal = None
        # where the promote event lives: (trace_id, span_id), used by
        # the scheduler to chain rehydrate.replay to the promotion
        self.promote_ref: Optional[tuple] = None
        # callable(reason) fired at most once per deposition
        self.on_lost: Optional[Callable[[str], None]] = None
        self._lost_fired = False

    # -- introspection ------------------------------------------------

    @property
    def is_leader(self) -> bool:
        return self._is_leader

    @property
    def epoch(self) -> int:
        return self._epoch

    def state(self) -> LeaseState:
        return read_lease(self._persister, self.name)

    # -- acquire / renew / resign -------------------------------------

    def _write(self, state: LeaseState) -> None:
        self._persister.set(
            _lease_path(self.name),
            json.dumps({
                "owner": state.owner,
                "epoch": state.epoch,
                "expires_at": state.expires_at,
            }, sort_keys=True).encode("utf-8"),
        )

    def try_acquire(self) -> bool:
        """Take (or renew) the lease.  A takeover — the record is
        absent, EXPIRED (even our own), or resigned — mints epoch+1; a
        renewal by the current holder of a LIVE lease keeps the epoch.
        False while another holder's lease is live.  Expiry always
        minting a new epoch keeps the fence deterministic: once a
        lease lapses, every write made under its epoch is dead,
        whether or not a rival ever existed."""
        with fence_lock(self._persister):
            now = self.clock()
            cur = read_lease(self._persister, self.name)
            if cur.owner and cur.owner != self.owner and cur.live(now):
                return False
            took_over = cur.owner != self.owner or not cur.live(now)
            epoch = cur.epoch + 1 if took_over else cur.epoch
            self._write(LeaseState(self.owner, epoch, now + self.ttl_s))
            self._epoch = epoch
            self._is_leader = True
            self._lost_fired = False
            if took_over:
                if cur.epoch > 0:
                    self.takeovers += 1
                self._record_event(
                    "election.promote",
                    epoch=epoch,
                    previous_owner=cur.owner or "(none)",
                )
            return True

    def renew(self) -> bool:
        """Extend the lease IF we still hold it, LIVE, at our epoch.
        A record held by someone else, re-minted at a new epoch, or
        EXPIRED means we were deposed: never silently resurrect
        (writes made by an interim leader would be grafted under, and
        resurrection would race ``verify()``'s strict expiry check —
        whether a stalled sole leader survived would depend on thread
        wakeup order); fire ``on_lost`` and return False so the
        process restarts as a candidate and re-elects at epoch+1."""
        with fence_lock(self._persister):
            now = self.clock()
            cur = read_lease(self._persister, self.name)
            if cur.owner == self.owner and cur.epoch == self._epoch \
                    and cur.live(now):
                self._write(LeaseState(self.owner, cur.epoch,
                                       now + self.ttl_s))
                return True
            if cur.owner == self.owner and cur.epoch == self._epoch:
                reason = (
                    f"lease for {self.name!r} expired un-renewed "
                    f"(stalled past ttl={self.ttl_s}s)"
                )
            else:
                reason = (
                    f"lease for {self.name!r} now held by "
                    f"{cur.owner or '(nobody)'} at epoch {cur.epoch}"
                )
            self._deposed_locked(reason)
            return False

    def resign(self) -> None:
        """Give the lease up cleanly: the record keeps its epoch (the
        successor must still mint epoch+1) but expires immediately, so
        candidates take over without waiting out the TTL."""
        with fence_lock(self._persister):
            cur = read_lease(self._persister, self.name)
            if cur.owner == self.owner:
                self._write(LeaseState("", cur.epoch, 0.0))
                self._record_event("election.resign", epoch=cur.epoch)
            self._is_leader = False

    # -- the fence ----------------------------------------------------

    def verify(self) -> None:
        """Raise ``LeaseFencedError`` unless the persisted record
        still names US at OUR epoch and is unexpired.  Called by
        ``FencedPersister`` under the shared fence lock, so the check
        is atomic with any in-process takeover."""
        now = self.clock()
        cur = read_lease(self._persister, self.name)
        if cur.owner == self.owner and cur.epoch == self._epoch \
                and cur.expires_at > now:
            return
        reason = (
            f"store mutation fenced: lease {self.name!r} is "
            f"{'expired' if cur.owner == self.owner else 'held by ' + (cur.owner or '(nobody)')} "
            f"at epoch {cur.epoch} (ours: {self._epoch})"
        )
        self._deposed_locked(reason)
        raise LeaseFencedError(reason)

    def _deposed_locked(self, reason: str) -> None:
        self._is_leader = False
        if self._lost_fired:
            return
        self._lost_fired = True
        callback = self.on_lost
        if callback is not None:
            try:
                callback(reason)
            except Exception:  # sdklint: disable=swallowed-exception — a broken loss callback must not mask the fencing error itself
                pass

    def _record_event(self, name: str, **attrs) -> None:
        journal = self.journal
        if journal is not None:
            # append only: the flush rides the owning scheduler's
            # cycle — a resign on the way OUT of leadership must not
            # block on (or be rejected by) the store it just lost
            journal.append("election", event=name, owner=self.owner,
                           **attrs)
        tracer = self.tracer
        if tracer is None:
            return
        event = tracer.event(name, track="scheduler", owner=self.owner,
                             **{k: str(v) for k, v in attrs.items()})
        if name == "election.promote":
            self.promote_ref = (event.trace_id, event.span_id)


class FencedPersister(Persister):
    """The lease-fenced writer: every mutation verifies the lease
    (atomically with in-process takeovers) before touching the
    backend.  Reads pass through unverified — a deposed leader may
    keep observing, it just may not write (the replication layer's
    reader/writer asymmetry, extended to the scheduler role)."""

    def __init__(self, backend: Persister, lease: LeaderLease):
        if isinstance(backend, FencedPersister):
            backend = backend.backend  # never stack fences
        self.backend = backend
        self.lease = lease
        self.rejected_writes = 0

    def _verify(self) -> None:
        try:
            self.lease.verify()
        except LeaseFencedError:
            self.rejected_writes += 1
            raise

    # -- reads (unfenced) ---------------------------------------------

    def get(self, path: str):
        return self.backend.get(path)

    def get_children(self, path: str):
        return self.backend.get_children(path)

    # -- mutations (fenced) -------------------------------------------

    def set(self, path: str, value: bytes) -> None:
        with fence_lock(self.backend):
            self._verify()
            self.backend.set(path, value)

    def recursive_delete(self, path: str) -> None:
        with fence_lock(self.backend):
            self._verify()
            self.backend.recursive_delete(path)

    def apply(self, ops) -> None:
        ops = list(ops)
        with fence_lock(self.backend):
            self._verify()
            self.backend.apply(ops)

    def close(self) -> None:
        self.backend.close()


class LeaderLock:
    """The runner-facing adapter: ``RemoteLocker``-shaped (acquire /
    release / on_lost) but HA — ``acquire()`` CANDIDATES instead of
    failing while another scheduler is alive, polling the lease until
    expiry hands it over, then keeps it renewed from a daemon thread.
    Lease loss fires ``on_lost`` exactly once (the runner exits; its
    supervisor restarts it as a candidate again)."""

    def __init__(
        self,
        persister: Persister,
        name: str,
        owner: str,
        ttl_s: float = 15.0,
    ):
        self.lease = LeaderLease(persister, name, owner, ttl_s=ttl_s)
        self.name = name
        self.owner = owner
        self.on_lost: Optional[Callable[[str], None]] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def acquire(self) -> bool:
        """Block as a CANDIDATE until the lease is ours (or abort()
        is called).  Poll cadence is a third of the TTL — the same
        rhythm the holder renews at, so takeover latency after a
        holder death is bounded by ~TTL + one poll."""
        self.lease.on_lost = self._lost
        while not self._stop.is_set():
            try:
                if self.lease.try_acquire():
                    self._thread = threading.Thread(
                        target=self._renew_loop,
                        name=f"ha-lease-{self.name}", daemon=True,
                    )
                    self._thread.start()
                    return True
            except PersisterError:
                pass  # state server unreachable: keep candidating
            self._stop.wait(self.lease.ttl_s / 3.0)
        return False

    def _renew_loop(self) -> None:
        last_ok = time.monotonic()
        while not self._stop.wait(self.lease.ttl_s / 3.0):
            try:
                if not self.lease.renew():
                    return  # renew() fired on_lost
                last_ok = time.monotonic()
            except PersisterError as e:
                # transient store outage: survivable while the lease
                # is live; past a full TTL it has lapsed server-side
                # and a standby may hold it
                if time.monotonic() - last_ok > self.lease.ttl_s:
                    self.lease._deposed_locked(
                        f"state server unreachable past TTL: {e}"
                    )
                    return

    def _lost(self, reason: str) -> None:
        self._stop.set()
        callback = self.on_lost
        if callback is not None:
            callback(reason)

    def abort(self) -> None:
        """Stop candidating/renewing without resigning (shutdown)."""
        self._stop.set()

    def release(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.lease.ttl_s)
        try:
            self.lease.resign()
        except PersisterError:
            pass  # the lease will expire on its own


def find_remote_persister(persister) -> Optional[object]:
    """Unwrap FencedPersister/PersisterCache layers down to a
    RemotePersister (None for purely local state) — the handle the HA
    observability surface uses to read /v1/repl/status."""
    from dcos_commons_tpu_torch.storage.remote import RemotePersister

    seen = set()
    node = persister
    while node is not None and id(node) not in seen:
        if isinstance(node, RemotePersister):
            return node
        seen.add(id(node))
        node = (
            getattr(node, "backend", None)
            or getattr(node, "_backend", None)
            or getattr(node, "_persister", None)
        )
    return None


class HAState:
    """The scheduler's HA observability handle: lease identity, the
    failover counter, replication watermarks, and the last
    re-hydration report — exported as ``ha.*`` gauges and served at
    ``GET /v1/debug/ha``."""

    # replication-status reads cross the network: cache them so a
    # metrics scrape costs at most one /v1/repl/status per window
    REPL_REFRESH_S = 10.0

    def __init__(self, persister: Persister, name: str,
                 lease: Optional[LeaderLease] = None):
        self.persister = persister
        self.name = name
        self.lease = lease
        self.last_rehydration: Optional[dict] = None
        self._lock = threading.Lock()
        self._repl: Optional[dict] = None
        self._repl_at = 0.0
        self._lag_gauges = set()
        self._metrics = None

    # -- wiring -------------------------------------------------------

    def attach(self, scheduler) -> "HAState":
        """Bind to a freshly-built scheduler: register the ha.*
        gauges, route election events into its flight recorder, and
        record the promotion that created this incarnation so the
        first cycle's ``rehydrate.replay`` chains to it."""
        scheduler.ha_state = self
        self._metrics = scheduler.metrics
        if self.lease is not None:
            self.lease.tracer = scheduler.tracer
            self.lease.journal = getattr(scheduler, "journal", None)
            if self.lease.is_leader and self.lease.promote_ref is None:
                # promoted before this scheduler (and its tracer)
                # existed: re-record so the failover chain is complete
                self.lease._record_event(
                    "election.promote", epoch=self.lease.epoch,
                    previous_owner="(pre-build)",
                )
        metrics = scheduler.metrics
        metrics.gauge("ha.is_leader", lambda: float(
            1.0 if self.lease is not None and self.lease.is_leader else 0.0
        ))
        metrics.gauge("ha.lease_epoch", lambda: float(
            self.lease.epoch if self.lease is not None else 0
        ))
        metrics.gauge("ha.failovers_total", lambda: float(
            self.lease.takeovers if self.lease is not None else 0
        ))
        metrics.gauge("ha.fenced_writes_rejected", self._rejected_writes)
        return self

    def _rejected_writes(self) -> float:
        fenced = self.persister if isinstance(
            self.persister, FencedPersister
        ) else None
        return float(fenced.rejected_writes if fenced is not None else 0)

    def note_rehydration(self, report: dict) -> None:
        self.last_rehydration = dict(report)

    # -- replication watermarks ---------------------------------------

    def replication_status(self, refresh: bool = False) -> Optional[dict]:
        """Cached /v1/repl/status of the backing state server (None
        for local state).  Discovered standbys get per-puller lag
        gauges ``ha.replication.lag.<id>`` (seq - acked)."""
        remote = find_remote_persister(self.persister)
        if remote is None:
            return None
        with self._lock:
            now = time.monotonic()
            if not refresh and self._repl is not None and \
                    now - self._repl_at < self.REPL_REFRESH_S:
                return self._repl
            try:
                status = remote._call("/v1/repl/status", {})
            except PersisterError:
                return self._repl
            self._repl = status
            self._repl_at = now
            if self._metrics is not None:
                for pid in (status.get("standbys") or {}):
                    if pid not in self._lag_gauges:
                        self._lag_gauges.add(pid)
                        self._metrics.gauge(  # sdklint: disable=metric-cardinality — bounded by the standby TOPOLOGY (a handful of operator-deployed pullers, not per-request ids) and deduped via _lag_gauges
                            f"ha.replication.lag.{pid}",
                            lambda pid=pid: self._lag_of(pid),
                        )
            return status

    def _lag_of(self, puller_id: str) -> float:
        status = self.replication_status()
        if not status:
            return 0.0
        st = (status.get("standbys") or {}).get(puller_id)
        if not st:
            return 0.0
        return float(int(status.get("seq", 0) or 0) - int(st.get("acked", 0)))

    # -- the /v1/debug/ha body ----------------------------------------

    def describe(self, refresh: bool = True) -> dict:
        lease_record = None
        try:
            # read through the LEASE's own persister when one exists:
            # the scheduler-side persister may be a write-through cache
            # that never observes the election's (out-of-band) renewals
            cur = (self.lease.state() if self.lease is not None
                   else read_lease(self.persister, self.name))
            now = (self.lease.clock() if self.lease is not None
                   else time.time())
            lease_record = {
                "owner": cur.owner,
                "epoch": cur.epoch,
                "expires_in_s": round(cur.expires_at - now, 3),
                "live": cur.live(now),
            }
        except PersisterError as e:
            lease_record = {"error": str(e)}
        body = {
            "enabled": True,
            "name": self.name,
            "leader": lease_record,
            "is_leader": bool(self.lease is not None
                              and self.lease.is_leader),
            "lease_epoch": self.lease.epoch if self.lease is not None else 0,
            "failovers_total": (
                self.lease.takeovers if self.lease is not None else 0
            ),
            "fenced_writes_rejected": int(self._rejected_writes()),
        }
        repl = self.replication_status(refresh=refresh)
        if repl is not None:
            seq = int(repl.get("seq", 0) or 0)
            body["replication"] = {
                "role": repl.get("role"),
                "epoch": repl.get("epoch"),
                "seq": seq,
                "acked_seq": repl.get("acked_seq"),
                "standbys": {
                    pid: {
                        "acked": st.get("acked"),
                        "lag": seq - int(st.get("acked", 0) or 0),
                        "lagging": st.get("lagging"),
                    }
                    for pid, st in (repl.get("standbys") or {}).items()
                },
            }
        if self.last_rehydration is not None:
            body["last_rehydration"] = self.last_rehydration
        return body

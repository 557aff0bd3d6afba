"""Reservation ledger: the WAL-backed resource claim book.

Replaces Mesos reservations + resource-id labels (reference:
offer/ResourceBuilder.java resource-id stamping, offer/ResourceUtils,
and the RESERVE/UNRESERVE operations sent via OfferAccepter).  Without
a Mesos master to arbitrate, the ledger IS the arbiter: a resource is
ours iff a reservation is committed here, and reservations are written
*before* launch (the PersistentLaunchRecorder discipline,
SURVEY.md section 7 hard part 1).

GC: reservations whose task no longer exists surface through
``unexpected_reservations`` — the analogue of the reference's
unexpected-resource cleanup (DefaultScheduler.java:483-538).

Port of ``dcos_commons_tpu/offer/ledger.py``,
line for line but the imports.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from dcos_commons_tpu_torch.common import SerializableMixin
from dcos_commons_tpu_torch.offer.inventory import ReservationLedgerView
from dcos_commons_tpu_torch.storage import Persister, SetOp
from dcos_commons_tpu_torch.storage.persister import namespace_root, validate_key


@dataclass
class Reservation(SerializableMixin):
    reservation_id: str
    host_id: str
    task_name: str = ""              # "<pod>-<i>-<task>" owning this claim
    role: str = ""
    cpus: float = 0.0
    memory_mb: int = 0
    disk_mb: int = 0
    chip_ids: List[str] = field(default_factory=list)
    ports: List[int] = field(default_factory=list)
    volume_id: str = ""              # persistent volume surviving relaunch
    container_path: str = ""
    # container_path -> durable volume key for EVERY volume of the
    # task; sibling tasks of one pod instance that declare the same
    # container path share the key (one durable dir per instance+path)
    volumes: Dict[str, str] = field(default_factory=dict)


def new_reservation_id() -> str:
    return uuid.uuid4().hex


class ReservationLedger(ReservationLedgerView):
    """Persisted under /reservations/<id>; cached in RAM for scans.

    The RAM cache carries two scan accelerators for the offer cycle's
    hot path: by-host and by-task indexes (``reserved_on``/``for_task``
    are O(claims on that host/task) instead of O(all claims)), and a
    monotonic generation counter bumped on every commit/release.  Each
    host records the generation of its last mutation, so
    ``SliceInventory.snapshots`` can reuse a cached per-host snapshot
    whenever ``host_generation`` is unchanged.
    """

    def __init__(self, persister: Persister, namespace: str = "") -> None:
        self._persister = persister
        self._root = namespace_root(namespace)
        self._cache: Dict[str, Reservation] = {}
        self._by_host: Dict[str, Dict[str, Reservation]] = {}
        self._by_task: Dict[str, Dict[str, Reservation]] = {}
        self._generation = 1
        # generation counters restart at 1 for every ledger OBJECT (a
        # service upgrade/reinstall rebuilds the ledger over the same
        # persisted tree): the epoch disambiguates, so a change token
        # minted against the old object can never alias the new one's
        # rebased generations (a stale-but-colliding token would hide
        # the final pre-rebuild commits from snapshot caches forever)
        self._epoch = uuid.uuid4().hex[:12]
        self._host_gen: Dict[str, int] = {}
        # newest pruned stamp: tokens older than this can no longer be
        # answered incrementally (the pruned host's change would be
        # invisible to them) and fall back to a full resync
        self._prune_floor = 0
        self._load()

    def _path(self, reservation_id: str) -> str:
        validate_key(reservation_id, "reservation id")
        return f"{self._root}/reservations/{reservation_id}"

    def _load(self) -> None:
        for rid in self._persister.get_children_or_empty(
            f"{self._root}/reservations"
        ):
            raw = self._persister.get_or_none(self._path(rid))
            if raw is not None:
                self._index(Reservation.from_bytes(raw))

    def _index(self, r: Reservation) -> None:
        old = self._cache.get(r.reservation_id)
        if old is not None:
            self._unindex(old)
        self._cache[r.reservation_id] = r
        self._by_host.setdefault(r.host_id, {})[r.reservation_id] = r
        self._by_task.setdefault(r.task_name, {})[r.reservation_id] = r
        self._host_gen[r.host_id] = self._generation

    def _unindex(self, r: Reservation) -> None:
        self._cache.pop(r.reservation_id, None)
        for index, key in ((self._by_host, r.host_id),
                           (self._by_task, r.task_name)):
            bucket = index.get(key)
            if bucket is not None:
                bucket.pop(r.reservation_id, None)
                if not bucket:
                    del index[key]
        self._host_gen[r.host_id] = self._generation

    # -- commit / release --------------------------------------------

    def commit(self, reservations: List[Reservation]) -> None:
        """Atomically commit a group of reservations (gang = one txn)."""
        ops = [
            SetOp(self._path(r.reservation_id), r.to_bytes())
            for r in reservations
        ]
        # durcheck: dur-unfenced-write=the scheduler builder hands this ledger a FencedPersister in HA mode; the fence is in the injected instance
        self._persister.apply(ops)
        self._generation += 1
        for r in reservations:
            self._index(r)

    def release(self, reservation_id: str) -> None:
        from dcos_commons_tpu_torch.storage import PersisterError

        path = self._path(reservation_id)
        try:
            # durcheck: dur-unfenced-write=same injected FencedPersister as commit(); a deposed leader's delete raises through the fence
            self._persister.recursive_delete(path)
        except PersisterError:
            pass
        old = self._cache.get(reservation_id)
        if old is not None:
            self._generation += 1
            self._unindex(old)
            self._compact_host_gen()

    def _compact_host_gen(self) -> None:
        """Prune generation stamps of hosts with no live claims once
        the journal exceeds 2x the claimed-host set — months of fleet
        churn (every replaced host once held a reservation) must not
        grow memory or per-sync dirty-scan cost without bound.  The
        same discipline as SliceInventory's topology-journal
        compaction: anything pruned raises ``_prune_floor`` so a
        pre-compaction token resyncs from scratch instead of missing
        the pruned host's release."""
        if len(self._host_gen) <= max(16, 2 * len(self._by_host)):
            return
        for host_id in [
            h for h in self._host_gen if h not in self._by_host
        ]:
            stamp = self._host_gen.pop(host_id)
            if stamp > self._prune_floor:
                self._prune_floor = stamp

    # -- queries ------------------------------------------------------

    @property
    def generation(self) -> int:
        """Monotonic mutation counter (bumped per commit/release)."""
        return self._generation

    def host_generation(self, host_id: str) -> int:
        """Generation of the last mutation touching ``host_id`` (0 =
        never touched).  Snapshot caches key on this value."""
        return self._host_gen.get(host_id, 0)

    @property
    def epoch(self) -> str:
        """Identity of this ledger OBJECT; tokens carry it so a
        rebuilt ledger's rebased generations never alias stale ones."""
        return self._epoch

    def generation_token(self):
        """Whole-ledger change token for incremental snapshot sync
        (SliceInventory dirty-host evaluation)."""
        return (self._epoch, self._generation)

    def changed_hosts_since(self, token) -> Optional[Set[str]]:
        """Hosts whose claims changed after ``token`` — the dirty set
        an incremental snapshot sync rebuilds.  O(1) when nothing
        changed; otherwise O(stamp journal), which compaction bounds
        at 2x the currently-claimed host set.  A token from another
        epoch (a superseded ledger object), from the future, or
        predating a compaction returns None: the caller must treat
        every host as dirty."""
        if not (
            isinstance(token, tuple)
            and len(token) == 2
            and token[0] == self._epoch
            and isinstance(token[1], int)
        ):
            return None
        if token[1] > self._generation:
            return None
        if token[1] == self._generation:
            return set()
        if token[1] < self._prune_floor:
            return None  # a pruned stamp postdates this token
        return {h for h, g in self._host_gen.items() if g > token[1]}

    def get(self, reservation_id: str) -> Optional[Reservation]:
        return self._cache.get(reservation_id)

    def all(self) -> List[Reservation]:
        return list(self._cache.values())

    def reserved_on(self, host_id: str) -> List[Reservation]:
        return list(self._by_host.get(host_id, {}).values())

    def for_task(self, task_name: str) -> List[Reservation]:
        return list(self._by_task.get(task_name, {}).values())

    def unexpected_reservations(self, expected_task_names: Set[str]) -> List[Reservation]:
        """Claims owned by no live task — candidates for UNRESERVE GC
        (reference: MesosEventClient.getUnexpectedResources)."""
        return [
            r
            for r in self._cache.values()
            if r.task_name not in expected_task_names
        ]

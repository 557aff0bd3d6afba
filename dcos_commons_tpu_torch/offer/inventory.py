"""The fleet model: GPU hosts, their cards, fabrics, snapshots (port of
``dcos_commons_tpu/offer/inventory.py``, line for line but the host).

Replaces Mesos agents + offers (reference: offer/MesosResourcePool.java
— the consumable view of one offer — and the agent attributes consumed
by placement rules).  The scheduler owns this inventory and synthesizes
"offers" (ResourceSnapshots) from it each cycle, instead of waiting
for a Mesos master to send them.

NVLink model: the placement unit is the host, one 8-GPU NVLink node
(an HGX board: every card hangs off NVSwitch, so any k of them are
equivalent and a host's cards can be split between pods).  Hosts
whose NCCL traffic can meet over one network fabric share a
``slice_id``, the fabric, which plays the TPU pod's role; ``node`` is
the host's ordinal in it and replaces the torus grid coordinate.  A
card's id is ``"<host_id>/<k>"``, k its host-local index, the value a
task's ``CUDA_VISIBLE_DEVICES`` names it by.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple


@dataclass(frozen=True)
class GpuHost:
    """One GPU host: an NVLink node and its CPUs, memory and disk.

    ``slice_id`` names the fabric this host belongs to; ``node`` is the
    host's ordinal in that fabric (the order gang placement takes
    hosts in); ``gpus`` is the host's card count.  CPU-only hosts (the
    helloworld case) have ``gpus == 0``.
    """

    host_id: str
    hostname: str = ""
    slice_id: str = ""
    generation: str = ""             # "" for CPU-only hosts
    node: int = 0
    gpus: int = 0  # sdklint: disable=no-gpus-resource — a host's card count, not a task resource
    cpus: float = 8.0
    memory_mb: int = 16384
    disk_mb: int = 102400
    ports: Tuple[Tuple[int, int], ...] = ((10000, 12000),)
    attributes: Dict[str, str] = field(default_factory=dict)
    zone: str = ""
    region: str = ""

    def __post_init__(self) -> None:
        if not self.hostname:
            object.__setattr__(self, "hostname", self.host_id)

    @property
    def chips_per_host(self) -> int:
        return self.gpus  # sdklint: disable=no-gpus-resource — a host's card count, not a task resource

    def chip_ids(self) -> List[str]:
        """Card ids "<host_id>/<k>" for every card this host owns, in
        host-local index order.

        Memoized: the dataclass is frozen, so the id list is a pure
        function of the host — snapshot synthesis used to re-format
        these strings for every host on every cycle."""
        cached = self.__dict__.get("_chip_ids")
        if cached is None:
            cached = tuple(f"{self.host_id}/{k}" for k in range(self.gpus))  # sdklint: disable=no-gpus-resource — a host's card count, not a task resource
            object.__setattr__(self, "_chip_ids", cached)
        return list(cached)


def card_index(chip_id: str) -> int:
    """The host-local index k of card ``"<host_id>/<k>"``: what the
    task's ``CUDA_VISIBLE_DEVICES`` lists it as."""
    return int(chip_id.rsplit("/", 1)[1])


def card_order(chip_id: str) -> Tuple[str, int]:
    """Sort key of card ids: by host, then by index (a plain string
    sort puts "h/10" before "h/2")."""
    host, k = chip_id.rsplit("/", 1)
    return host, int(k)


class ResourceSnapshot:
    """A consumable view of one host's free resources — the offer.

    Reference: offer/MesosResourcePool.java.  Mutated by evaluation
    stages as they claim resources; commit/rollback is handled by the
    evaluator working on copies (gang evaluation is all-or-nothing).

    Copy-on-write contract (fleet-scale fast path): the inventory's
    per-view caches hand out ``shared`` masters that are reused across
    requirements WITHOUT copying; reading them is free, but a caller
    that wants to consume must ``copy()`` first — the mutators raise
    on a shared snapshot so a forgotten clone fails loudly instead of
    silently poisoning every later evaluation.
    """

    def __init__(
        self,
        host: GpuHost,
        cpus: float,
        memory_mb: int,
        disk_mb: int,
        free_chips: Set[str],
        used_ports: Set[int],
    ):
        self.host = host
        self.cpus = cpus
        self.memory_mb = memory_mb
        self.disk_mb = disk_mb
        self.free_chips = set(free_chips)
        self.used_ports = set(used_ports)
        self.shared = False

    def copy(self) -> "ResourceSnapshot":
        return ResourceSnapshot(
            self.host, self.cpus, self.memory_mb, self.disk_mb,
            set(self.free_chips), set(self.used_ports),
        )

    def _writable(self) -> None:
        if self.shared:
            raise RuntimeError(
                f"shared snapshot for {self.host.host_id!r}: copy() "
                "before mutating (copy-on-write contract)"
            )

    # -- consumption (evaluation stages call these) -------------------

    def try_consume_scalar(self, cpus: float, memory_mb: int, disk_mb: int) -> bool:
        self._writable()
        if self.cpus + 1e-9 < cpus or self.memory_mb < memory_mb \
                or self.disk_mb < disk_mb:
            return False
        self.cpus -= cpus
        self.memory_mb -= memory_mb
        self.disk_mb -= disk_mb
        return True

    def try_consume_chips(self, count: int) -> Optional[List[str]]:
        self._writable()
        if len(self.free_chips) < count:
            return None
        taken = sorted(self.free_chips, key=card_order)[:count]
        self.free_chips -= set(taken)
        return taken

    def allocate_port(self, requested: int = 0) -> Optional[int]:
        """Fixed port if requested, else next free dynamic port."""
        self._writable()
        if requested:
            if requested in self.used_ports:
                return None
            self.used_ports.add(requested)
            return requested
        for lo, hi in self.host.ports:
            for port in range(lo, hi):
                if port not in self.used_ports:
                    self.used_ports.add(port)
                    return port
        return None


def host_field(host: GpuHost, field_name: str) -> str:
    """The ONE host-field accessor shared by placement rules and the
    inverted indexes — a rule and the index it pre-filters through
    must read the same value or candidates silently diverge."""
    if field_name == "hostname":
        return host.hostname
    if field_name == "zone":
        return host.zone
    if field_name == "region":
        return host.region
    if field_name == "generation":
        return host.generation
    if field_name == "slice":
        return host.slice_id
    return host.attributes.get(field_name, "")


class _ViewCache:
    """Per-(inventory, ledger-view) snapshot cache — the dirty-host
    incremental evaluation state.  One exists per view OBJECT, so a
    multi-service scheduler alternating between its merged view and a
    bare ledger no longer thrashes a single shared cache."""

    __slots__ = (
        "snaps", "tokens", "gen_token", "topo_gen", "ordered",
        "order_gen", "free_chip_count", "free_by_slice",
    )

    def __init__(self) -> None:
        self.snaps: Dict[str, ResourceSnapshot] = {}  # host_id -> shared master
        self.tokens: Dict[str, object] = {}           # host_id -> per-host token
        self.gen_token: object = None                 # view token at last sync
        self.topo_gen: int = -1
        self.ordered: Optional[List[ResourceSnapshot]] = None
        self.order_gen: int = -1                      # suspect-order stamp
        # ledger-dependent placement indexes, maintained with the
        # snapshots they describe (a stale index would pre-filter
        # against a fleet that no longer exists)
        self.free_chip_count: Dict[str, int] = {}
        self.free_by_slice: Dict[str, Set[str]] = {}


class HostIndex:
    """Read-only index facade handed to placement pre-filtering: the
    inventory's inverted field indexes (topology-keyed) plus one
    view's chip-availability indexes (ledger-keyed).  Rules emit
    candidate host-id SETS through this instead of filtering one
    snapshot at a time."""

    def __init__(self, inventory: "SliceInventory", cache: _ViewCache):
        self._inventory = inventory
        self._cache = cache

    def universe(self) -> Set[str]:
        """All up host ids (callers must not mutate)."""
        return self._inventory._up_ids()

    def hosts_with(self, field_name: str, value: str) -> Set[str]:
        return self._inventory._field_index(field_name).get(value, _EMPTY)

    def value_index(self, field_name: str) -> Dict[str, Set[str]]:
        """value -> up host ids for one field (callers must not mutate)."""
        return self._inventory._field_index(field_name)

    def ordinal(self, host_id: str) -> int:
        """Host's position in snapshot iteration order — candidates
        sorted by this reproduce exactly the full-scan winner."""
        return self._inventory._ordinals().get(host_id, 1 << 30)

    def snapshot(self, host_id: str) -> Optional[ResourceSnapshot]:
        return self._cache.snaps.get(host_id)

    def ordered_snapshots(self) -> List[ResourceSnapshot]:
        return self._inventory._ordered_snapshots(self._cache)

    def snapshots_for(self, host_ids: Set[str]) -> List[ResourceSnapshot]:
        """Shared snapshots for a candidate set, in scan order."""
        up = self._inventory._up_ids()
        if host_ids is up or len(host_ids) >= len(up):
            # candidate sets are built from up-host indexes, so a
            # full-cardinality set IS the universe — reuse the cached
            # scan-order list instead of re-sorting the whole fleet
            # per instance
            return self.ordered_snapshots()
        ordinals = self._inventory._ordinals()
        snaps = self._cache.snaps
        return [
            snaps[h]
            for h in sorted(host_ids, key=lambda h: ordinals.get(h, 1 << 30))
            if h in snaps
        ]

    def hosts_with_free_chips(self, count: int) -> Set[str]:
        """Up hosts with at least ``count`` chips unreserved under
        this view (free-chip-count bucket query)."""
        if count <= 0:
            return self.universe()
        return {
            h for h, n in self._cache.free_chip_count.items() if n >= count
        }

    def rule_candidates(self, rule, ctx) -> Optional[Set[str]]:
        """A rule's candidate host-id set, memoized per topology
        generation when the rule declares a static
        ``candidate_key()`` (field matches and their and/or algebra
        — incl. the O(fleet) inverted-match universe subtraction).
        A multi-instance deploy used to pay the
        full set algebra once PER INSTANCE; now it pays one lookup.
        Dynamic rules (count-dependent) fall through to a fresh
        computation every call — membership correctness first."""
        key_of = getattr(rule, "candidate_key", None)
        key = key_of() if callable(key_of) else None
        if key is None:
            return rule.candidate_host_ids(ctx, self)
        inv = self._inventory
        topo = inv._topology_gen
        entry = inv._static_candidates.get(key)
        if entry is not None and entry[0] == topo:
            inv.static_cand_hits += 1
            return entry[1]
        inv.static_cand_misses += 1
        cand = rule.candidate_host_ids(ctx, self)
        if len(inv._static_candidates) >= 256:
            # distinct static rules are few (they come from pod
            # specs); a runaway vocabulary resets rather than grows
            inv._static_candidates.clear()
        inv._static_candidates[key] = (
            topo, frozenset(cand) if cand is not None else None
        )
        return cand

    def free_by_slice(self) -> Dict[str, Set[str]]:
        """slice_id -> hosts of that fabric with at least one
        unreserved card — the gang pre-filter (``fully_free_by_slice``
        in the JAX package, whose torus takes whole hosts only; a gang
        here takes ``chips_per_host`` cards of a node, offer/nvlink.py,
        so a partly reserved host is still a candidate)."""
        return self._cache.free_by_slice



_EMPTY: Set[str] = frozenset()  # type: ignore[assignment]


class SliceInventory:
    """The fleet: hosts + the reservation ledger's committed claims.

    ``snapshots()`` synthesizes the current "offers": per-host free
    resources after subtracting every committed reservation.  This is
    the L0-replacement — where the reference waits for resourceOffers
    callbacks (FrameworkScheduler.java:196), our scheduler scans this.

    Fleet-scale fast path: snapshots are cached PER VIEW and synced
    incrementally — each pass asks the view which hosts changed since
    the last sync (``changed_hosts_since``) and rebuilds exactly
    those, so an idle 10k-host fleet pays an O(1) token compare, not
    10k rebuild-or-copy decisions.  ``offer_view`` returns SHARED
    copy-on-write masters; ``snapshots`` keeps the legacy
    copy-per-host contract for direct callers."""

    def __init__(self, hosts: Optional[List[GpuHost]] = None):
        self._hosts: Dict[str, GpuHost] = {}
        self._down: Set[str] = set()
        # Failure-domain states: ``preempted``
        # hosts are DOWN with a cause (the cloud took the capacity
        # back; tasks there are dead and recovery treats them as
        # PERMANENT); ``maintenance`` hosts are UP but drain-first —
        # excluded from every snapshot/candidate set (no NEW
        # placements, fresh or in-place growth) while their running
        # work keeps running until the operator (or the maintenance
        # automation) kills it.  Values: host_id -> wall-clock window
        # end (0.0 = indefinite / unknown).
        self._preempted: Set[str] = set()
        self._maintenance: Dict[str, float] = {}
        # per-view snapshot caches: id(view) -> (view, _ViewCache).
        # The view object itself is held (not just its id()): id reuse
        # after GC must never validate a stale cache.
        self._view_caches: Dict[int, tuple] = {}
        # static placement candidate sets (HostIndex.rule_candidates):
        # candidate_key -> (topology_gen, frozenset | None).  Stamped
        # per entry, so no invalidation hook is needed — a topology
        # bump simply makes every stamp compare stale.
        self._static_candidates: Dict[tuple, tuple] = {}
        self.static_cand_hits = 0
        self.static_cand_misses = 0
        self.cache_hits = 0
        self.cache_misses = 0
        # dirty-host count of the most recent sync that found work
        # (surfaced as the offers.dirty_hosts gauge)
        self.last_dirty_hosts = 0
        # bumped on any EFFECTIVE host add/remove/up/down so per-cycle
        # consumers know when to rebuild; per-host change generations
        # let view caches compute exactly which hosts moved
        self._topology_gen = 0
        self._host_topo_gen: Dict[str, int] = {}
        # inverted indexes over UP hosts (field value -> host ids),
        # built lazily per field and discarded on topology change;
        # _ordinal_cache maps host_id -> scan position
        self._field_indexes: Dict[str, Dict[str, Set[str]]] = {}
        self._index_gen = -1
        self._ordinal_cache: Dict[str, int] = {}
        self._ordinal_gen: object = -1
        # soft placement signal (health plane): suspect hosts sort
        # LAST in scan order — superset-sound, a suspect host is still
        # offered, it just loses first-fit ties to healthy peers.
        # Order changes bump _order_gen so scan-order caches (ordinals,
        # per-view ordered lists) re-sort without touching snapshots.
        self._suspect: frozenset = frozenset()
        self._suspect_sources: Dict[str, frozenset] = {}
        self._order_gen = 0
        self._scan_cache: Optional[List[GpuHost]] = None
        self._scan_cache_gen: object = None
        self._up_ids_cache: Optional[Set[str]] = None
        self._up_ids_gen = -1
        self._hosts_by_id: Optional[Dict[str, GpuHost]] = None
        self._hosts_by_id_gen = -1
        for host in hosts or []:
            self.add_host(host)

    @property
    def topology_generation(self) -> int:
        return self._topology_gen

    # -- mutators (the ONLY writers of host state; each effective
    # change bumps the generation so caches and indexes re-sync) ------

    def add_host(self, host: GpuHost) -> None:
        self._hosts[host.host_id] = host
        self._topology_gen += 1
        self._host_topo_gen[host.host_id] = self._topology_gen

    def remove_host(self, host_id: str) -> None:
        if host_id not in self._hosts:
            return  # no-op: an unknown host must not dirty the fleet
        self._hosts.pop(host_id, None)
        self._down.discard(host_id)
        self._preempted.discard(host_id)
        self._maintenance.pop(host_id, None)
        self._topology_gen += 1
        self._host_topo_gen[host_id] = self._topology_gen
        # journal compaction: removed hosts' stamps must outlive every
        # view cache that hasn't observed the removal yet, so they are
        # kept — but a months-long churny fleet must not accumulate
        # them without bound.  Past 2x the live fleet, drop non-member
        # stamps and clear the view caches outright: a from-scratch
        # resync can never miss a pruned removal.
        if len(self._host_topo_gen) > 2 * max(len(self._hosts), 512):
            self._host_topo_gen = {
                h: g for h, g in self._host_topo_gen.items()
                if h in self._hosts
            }
            self._view_caches.clear()

    def mark_down(self, host_id: str) -> None:
        """Host lost/maintenance: excluded from snapshots (the TASK_LOST
        / PARTITION_AWARE analogue, SURVEY.md section 5.3)."""
        if host_id in self._hosts and host_id not in self._down:
            self._down.add(host_id)
            self._topology_gen += 1
            self._host_topo_gen[host_id] = self._topology_gen

    def mark_up(self, host_id: str) -> None:
        # no-op guard: re-marking an up (or unknown) host used to bump
        # the generation anyway, invalidating every per-cycle hosts
        # dict and dirtying the whole fleet for nothing.  A returning
        # host sheds its preemption mark (the capacity is back) but
        # NOT a maintenance mark — the drain was scheduled by an
        # operator and only clear_host_state/the window may end it.
        if host_id in self._down:
            self._down.discard(host_id)
            self._preempted.discard(host_id)
            self._topology_gen += 1
            self._host_topo_gen[host_id] = self._topology_gen

    # -- preemption / maintenance -------------------------------------

    def set_preempted(self, host_id: str) -> bool:
        """Immediate, involuntary capacity loss: the host is DOWN (its
        tasks are dead, snapshots excluded) and the preemption cause is
        recorded so recovery and the /v1/hosts surface can tell a
        preemption from a plain heartbeat loss.  Returns False when
        the host is unknown or already marked."""
        if host_id not in self._hosts or host_id in self._preempted:
            return False
        self._preempted.add(host_id)
        self._maintenance.pop(host_id, None)
        if host_id not in self._down:
            self._down.add(host_id)
        self._topology_gen += 1
        self._host_topo_gen[host_id] = self._topology_gen
        return True

    def set_maintenance(self, host_id: str, window_end: float = 0.0) -> bool:
        """Scheduled drain: the host stays UP (running work keeps
        running, in-place relaunches of existing footprints still
        work) but is HARD-excluded from snapshots and candidate
        indexes — no new placement lands on a host about to go away.
        ``window_end`` is the wall-clock end of the maintenance window
        (0.0 = indefinite); the elastic-resize decision rule reads it
        to choose waiting over shrinking.  Returns False when the
        host is unknown or already draining with the same window."""
        if host_id not in self._hosts:
            return False
        if self._maintenance.get(host_id) == window_end and \
                host_id in self._maintenance:
            return False
        self._maintenance[host_id] = float(window_end)
        self._topology_gen += 1
        self._host_topo_gen[host_id] = self._topology_gen
        return True

    def clear_host_state(self, host_id: str) -> bool:
        """Operator ``up`` verb: shed preempted/maintenance/down marks
        and return the host to full placement eligibility."""
        if host_id not in self._hosts:
            return False
        changed = (
            host_id in self._down
            or host_id in self._preempted
            or host_id in self._maintenance
        )
        if not changed:
            return False
        self._down.discard(host_id)
        self._preempted.discard(host_id)
        self._maintenance.pop(host_id, None)
        self._topology_gen += 1
        self._host_topo_gen[host_id] = self._topology_gen
        return True

    def host_state(self, host_id: str) -> str:
        """One of "up" | "down" | "preempted" | "maintenance" ("" for
        an unknown host).  ``maintenance`` wins over up (the host IS
        up — that is the point of a drain)."""
        if host_id not in self._hosts:
            return ""
        if host_id in self._preempted:
            return "preempted"
        if host_id in self._down:
            return "down"
        if host_id in self._maintenance:
            return "maintenance"
        return "up"

    def maintenance_window(self, host_id: str) -> Optional[float]:
        """Window end for a draining host (0.0 = indefinite), None
        when the host is not in maintenance."""
        return self._maintenance.get(host_id)

    def maintenance_hosts(self) -> Dict[str, float]:
        return dict(self._maintenance)

    def preempted_hosts(self) -> Set[str]:
        return set(self._preempted)

    def host_states(self) -> Dict[str, dict]:
        """Per-host state rows for GET /v1/hosts (operator surface)."""
        out: Dict[str, dict] = {}
        for host_id, host in self._hosts.items():
            row: Dict[str, object] = {
                "state": self.host_state(host_id),
                "slice": host.slice_id,
                "chips": host.chips_per_host,
            }
            window = self._maintenance.get(host_id)
            if window is not None:
                row["window_end"] = window
            out[host_id] = row
        return out

    def _placement_excluded(self, host_id: str) -> bool:
        """Down OR draining: no snapshot, no candidate membership."""
        return host_id in self._down or host_id in self._maintenance

    # -- queries ------------------------------------------------------

    def is_up(self, host_id: str) -> bool:
        return host_id in self._hosts and host_id not in self._down

    def host(self, host_id: str) -> Optional[GpuHost]:
        return self._hosts.get(host_id)

    def hosts(self) -> List[GpuHost]:
        return list(self._hosts.values())

    def up_hosts(self) -> List[GpuHost]:
        return [h for h in self._hosts.values() if h.host_id not in self._down]

    def hosts_by_id(self) -> Dict[str, GpuHost]:
        """host_id -> host over the WHOLE fleet (incl. down hosts),
        cached on the topology generation.  Callers must not mutate —
        every evaluation context of a cycle shares this dict."""
        gen = self._topology_gen
        if self._hosts_by_id is None or self._hosts_by_id_gen != gen:
            self._hosts_by_id = dict(self._hosts)
            self._hosts_by_id_gen = gen
        return self._hosts_by_id

    # -- snapshots ----------------------------------------------------

    def snapshots(self, ledger: "ReservationLedgerView") -> List[ResourceSnapshot]:
        """Legacy contract: synthesize the current offers as MUTABLE
        per-host copies.  Direct callers (tests, tools) may consume
        them freely; the evaluator's fast path uses ``offer_view``."""
        cache = self._sync_view(ledger)
        return [s.copy() for s in self._ordered_snapshots(cache)]

    def offer_view(self, ledger: "ReservationLedgerView") -> HostIndex:
        """Sync this view's cache against the ledger + topology and
        return the index facade over SHARED copy-on-write snapshots.
        This is the per-requirement entry point: an unchanged fleet
        costs one token compare, a changed one costs O(dirty hosts)."""
        return HostIndex(self, self._sync_view(ledger))

    def debug_stats(self) -> Dict[str, object]:
        """Dirty-set / cache / index observability for
        /v1/debug/offers (the slow-cycle triage surface).  Runs on
        HTTP threads while the cycle thread mutates: the C-level
        list()/dict() snapshots below are atomic under the GIL, so
        iteration can never see a resize mid-flight."""
        caches = list(self._view_caches.values())
        field_indexes = dict(self._field_indexes)
        return {
            "topology_generation": self._topology_gen,
            "hosts": len(self._hosts),
            "up_hosts": len(self._up_ids()),
            "preempted_hosts": sorted(self._preempted),
            "maintenance_hosts": dict(sorted(self._maintenance.items())),
            "suspect_hosts": sorted(self._suspect),
            "last_dirty_hosts": self.last_dirty_hosts,
            "snapshot_cache": {
                "hits": self.cache_hits,
                "misses": self.cache_misses,
                "views": len(caches),
                "entries": sum(len(c.snaps) for _, c in caches),
            },
            "index_cardinalities": {
                f: len(ix) for f, ix in field_indexes.items()
            },
            "static_candidates": {
                "hits": self.static_cand_hits,
                "misses": self.static_cand_misses,
                "entries": len(self._static_candidates),
            },
        }

    # -- incremental sync (internal) ----------------------------------

    # distinct live views are few (a service's ledger, the multi
    # merged view); the bound only matters when views are RECREATED —
    # live options updates swap the evaluator's ledger object, and
    # each superseded view would otherwise pin a fleet-sized snapshot
    # cache forever
    _MAX_VIEW_CACHES = 8

    def _sync_view(self, view: "ReservationLedgerView") -> _ViewCache:
        key = id(view)
        entry = self._view_caches.pop(key, None)
        if entry is None or entry[0] is not view:
            cache = _ViewCache()
            while len(self._view_caches) >= self._MAX_VIEW_CACHES:
                # LRU eviction: every sync re-inserts at the end, so
                # the first key is the least-recently-synced view
                self._view_caches.pop(next(iter(self._view_caches)))
            self._view_caches[key] = (view, cache)
        else:
            # re-insert at the end (most-recently used)
            self._view_caches[key] = entry
            cache = entry[1]
        token_fn = getattr(view, "generation_token", None)
        token = token_fn() if token_fn is not None else None
        if (
            token is not None
            and cache.gen_token == token
            and cache.topo_gen == self._topology_gen
        ):
            # steady state: nothing changed anywhere — O(1)
            self.cache_hits += len(cache.snaps)
            self.last_dirty_hosts = 0
            return cache
        # which hosts moved?  Ledger side from the view's change
        # journal (None = unknown -> per-host token compare), topology
        # side from the per-host generation stamps.
        changed: Optional[Set[str]] = None
        if cache.gen_token is not None:
            changed_fn = getattr(view, "changed_hosts_since", None)
            if changed_fn is not None:
                changed = changed_fn(cache.gen_token)
        if cache.topo_gen != self._topology_gen and changed is not None:
            changed = set(changed) | {
                h for h, g in self._host_topo_gen.items()
                if g > cache.topo_gen
            }
        if changed is None:
            self._sync_full(view, cache)
        else:
            self._sync_dirty(view, cache, changed)
        cache.gen_token = token
        cache.topo_gen = self._topology_gen
        return cache

    def _sync_dirty(
        self, view: "ReservationLedgerView", cache: _ViewCache,
        dirty: Set[str],
    ) -> None:
        self.last_dirty_hosts = len(dirty)
        if not dirty:
            self.cache_hits += len(cache.snaps)
            return
        gen_of = getattr(view, "host_generation", None)
        rebuilt = 0
        for host_id in dirty:
            host = self._hosts.get(host_id)
            if host is None or self._placement_excluded(host_id):
                self._drop_entry(cache, host_id)
                continue
            token = gen_of(host_id) if gen_of is not None else None
            self._rebuild_entry(view, cache, host, token)
            rebuilt += 1
        self.cache_misses += rebuilt
        self.cache_hits += len(cache.snaps) - rebuilt

    def _sync_full(
        self, view: "ReservationLedgerView", cache: _ViewCache
    ) -> None:
        """No change journal available: fall back to comparing every
        up host's per-view token (the plain path, minus the copies)."""
        gen_of = getattr(view, "host_generation", None)
        seen: Set[str] = set()
        rebuilt = 0
        for host in self._hosts.values():
            host_id = host.host_id
            if self._placement_excluded(host_id):
                self._drop_entry(cache, host_id)
                continue
            seen.add(host_id)
            token = gen_of(host_id) if gen_of is not None else None
            current = cache.snaps.get(host_id)
            if (
                token is not None
                and current is not None
                and current.host is host
                and cache.tokens.get(host_id) == token
            ):
                self.cache_hits += 1
                continue
            self.cache_misses += 1
            rebuilt += 1
            self._rebuild_entry(view, cache, host, token)
        for host_id in list(cache.snaps):
            if host_id not in seen:
                self._drop_entry(cache, host_id)
        self.last_dirty_hosts = rebuilt

    def _rebuild_entry(
        self, view, cache: _ViewCache, host: GpuHost, token
    ) -> None:
        snap = self._build_snapshot(host, view)
        snap.shared = True
        host_id = host.host_id
        prev = cache.snaps.get(host_id)
        if prev is not None and prev.host.slice_id != host.slice_id:
            # host re-registered under a different slice: it must
            # leave the OLD slice's free bucket or the gang
            # pre-filter counts a host that is no longer there
            old_bucket = cache.free_by_slice.get(prev.host.slice_id)
            if old_bucket is not None:
                old_bucket.discard(host_id)
        cache.snaps[host_id] = snap
        cache.tokens[host_id] = token
        cache.ordered = None
        n_free = len(snap.free_chips)
        cache.free_chip_count[host_id] = n_free
        bucket = cache.free_by_slice.setdefault(host.slice_id, set())
        if n_free:
            bucket.add(host_id)
        else:
            bucket.discard(host_id)

    def _drop_entry(self, cache: _ViewCache, host_id: str) -> None:
        snap = cache.snaps.pop(host_id, None)
        cache.tokens.pop(host_id, None)
        cache.free_chip_count.pop(host_id, None)
        if snap is not None:
            cache.ordered = None
            bucket = cache.free_by_slice.get(snap.host.slice_id)
            if bucket is not None:
                bucket.discard(host_id)

    def _ordered_snapshots(self, cache: _ViewCache) -> List[ResourceSnapshot]:
        if cache.ordered is None or cache.order_gen != self._order_gen:
            snaps = cache.snaps
            cache.ordered = [
                snaps[h.host_id]
                for h in self._scan_hosts()
                if h.host_id in snaps
            ]
            cache.order_gen = self._order_gen
        return cache.ordered

    # -- scan order (health plane's soft placement signal) ------------

    def set_suspect_hosts(self, host_ids, source: str = "") -> None:
        """Demote hosts to the END of placement scan order (the health
        monitor pushes its straggler suspect set here).  Superset-sound
        by construction: membership in every candidate set and
        snapshot cache is untouched — only iteration ORDER changes, so
        a suspect host still places when it is the only fit.

        ``source`` keys the contribution: on a SHARED multi-service
        inventory every service's monitor pushes only its own
        stragglers, so the effective demotion set is the UNION across
        sources — a service with no stragglers pushing ``set()`` must
        not clobber another service's demotion of a host they share.
        No-op when the union is unchanged (a per-source change that
        doesn't move the union never resorts); otherwise only the
        ordering caches re-sort (snapshot content is
        order-independent)."""
        new = frozenset(host_ids)
        if self._suspect_sources.get(source, frozenset()) == new:
            return
        if new:
            self._suspect_sources[source] = new
        else:
            self._suspect_sources.pop(source, None)
        union = frozenset().union(
            *self._suspect_sources.values()
        ) if self._suspect_sources else frozenset()
        if union == self._suspect:
            return
        self._suspect = union
        self._order_gen += 1

    def suspect_hosts(self) -> Set[str]:
        return set(self._suspect)

    def _scan_hosts(self) -> List[GpuHost]:
        """Hosts in scan (tie-breaking) order: registration order with
        suspect hosts moved to the back, cached until topology or the
        suspect set changes.  The ONE order shared by ``_ordinals`` and
        the per-view ordered snapshot lists — indexed candidates sorted
        by ordinal must reproduce exactly the full-scan winner."""
        gen = (self._topology_gen, self._order_gen)
        if self._scan_cache is None or self._scan_cache_gen != gen:
            if self._suspect:
                head = [
                    h for h in self._hosts.values()
                    if h.host_id not in self._suspect
                ]
                head += [
                    h for h in self._hosts.values()
                    if h.host_id in self._suspect
                ]
                self._scan_cache = head
            else:
                self._scan_cache = list(self._hosts.values())
            self._scan_cache_gen = gen
        return self._scan_cache

    # -- inverted indexes (internal; rebuilt on topology change) ------

    def _up_ids(self) -> Set[str]:
        # capture the generation BEFORE building: a topology mutation
        # racing this rebuild (HTTP debug thread vs cycle thread) must
        # leave the cache stamped stale, not mask the change until the
        # NEXT topology bump
        gen = self._topology_gen
        if self._up_ids_cache is None or self._up_ids_gen != gen:
            # C-level snapshots first: debug_stats calls this from
            # HTTP threads while the cycle thread mutates the fleet.
            # Maintenance hosts are excluded like down ones — this set
            # feeds candidate indexes, and a draining host may take no
            # new placements (its RUNNING work is untouched)
            excluded = set(self._down) | set(self._maintenance)
            self._up_ids_cache = {
                h for h in list(self._hosts) if h not in excluded
            }
            self._up_ids_gen = gen
        return self._up_ids_cache

    def _ordinals(self) -> Dict[str, int]:
        gen = (self._topology_gen, self._order_gen)
        if self._ordinal_gen != gen:
            self._ordinal_cache = {
                host.host_id: i
                for i, host in enumerate(self._scan_hosts())
            }
            self._ordinal_gen = gen
        return self._ordinal_cache

    def _field_index(self, field_name: str) -> Dict[str, Set[str]]:
        gen = self._topology_gen
        if self._index_gen != gen:
            self._field_indexes = {}
            self._index_gen = gen
        index = self._field_indexes.get(field_name)
        if index is None:
            index = {}
            for host in self._hosts.values():
                if self._placement_excluded(host.host_id):
                    continue
                index.setdefault(
                    host_field(host, field_name), set()
                ).add(host.host_id)
            self._field_indexes[field_name] = index
        return index

    def _build_snapshot(
        self, host: GpuHost, ledger: "ReservationLedgerView"
    ) -> ResourceSnapshot:
        free_chips = set(host.chip_ids())
        used_ports: Set[int] = set()
        cpus, mem, disk = host.cpus, host.memory_mb, host.disk_mb
        for res in ledger.reserved_on(host.host_id):
            cpus -= res.cpus
            mem -= res.memory_mb
            disk -= res.disk_mb
            free_chips -= set(res.chip_ids)
            used_ports |= set(res.ports)
        return ResourceSnapshot(host, cpus, mem, disk, free_chips, used_ports)


class ReservationLedgerView:
    """What SliceInventory needs from the ledger (breaks import cycle)."""

    def reserved_on(self, host_id: str):  # pragma: no cover - interface
        raise NotImplementedError

    def host_generation(self, host_id: str):
        """Change token for ``reserved_on(host_id)``; snapshots cached
        against it are reused while it compares equal.  None (the
        default) means "unknown — never cache"."""
        return None

    def generation_token(self):
        """Whole-view change token: snapshots synced against it are
        reused wholesale while it compares equal.  None (the default)
        means "unknown — re-check every host each pass"."""
        return None

    def changed_hosts_since(self, token):
        """Host ids whose ``reserved_on`` may differ from when the
        view reported ``token``; None (the default) means "unknown —
        treat every host as potentially dirty"."""
        return None


def make_test_fleet(
    slice_id: str = "fabric-0",
    nodes: int = 4,
    gpus: int = 8,  # sdklint: disable=no-gpus-resource — a host's card count, not a task resource
    generation: str = "h100",
    cpus: float = 16.0,
    memory_mb: int = 65536,
    zone_of=None,
) -> List[GpuHost]:
    """Fabricate one fabric's NVLink nodes (the SendOffer-builder
    equivalent, reference: sdk/testing Expect/SendOffer fixtures)."""
    return [
        GpuHost(
            host_id=f"{slice_id}-n{node}",
            slice_id=slice_id,
            generation=generation,
            node=node,
            gpus=gpus,  # sdklint: disable=no-gpus-resource — a host's card count, not a task resource
            cpus=cpus,
            memory_mb=memory_mb,
            zone=zone_of(node) if zone_of else f"zone-{node}",
        )
        for node in range(nodes)
    ]

"""The evaluation pipeline: requirement + snapshots -> operations (port
of ``dcos_commons_tpu/offer/evaluate.py``: ``pod.gpu`` for ``pod.tpu``,
``find_node_set`` for the torus, and the card env below).

Reference: offer/evaluate/OfferEvaluator.java:65,113 and its stage
pipeline (:250-310, new-pod :411-522): Placement -> per-task resources
(cpu/mem/ports/volumes) -> launch, each stage returning an
EvaluationOutcome; first fully-passing host wins (:137-248); existing
pods reuse prior reservation ids (TaskResourceMapper) so relaunches
keep their footprint.  PodInfoBuilder's TaskInfo assembly (env, ports,
readiness labels) lives in ``_build_task_info`` here.

Gang requirements are evaluated atomically across hosts via
offer/nvlink.py ``find_node_set``; the evaluator allocates the
rendezvous point (worker-0 coordinator address) and injects the
process-group env contract into every worker (the moral equivalent of
the reference's bootstrap DNS-wait, sdk/bootstrap/main.go:218-289).
The contract keeps the JAX package's names (``TPU_WORKER_ID``,
``TPU_CHIP_IDS``, ...): the port's workers read them as they are.

The card env: every task gets ``CUDA_VISIBLE_DEVICES``, the host-local
indices of its reserved cards comma-joined in order, in place of the
TPU's ``TPU_CHIPS_PER_HOST_BOUNDS``.  It is what confines a worker to
its reservation on a shared node (the worker starts one rank a card it
can see).  A chip-less task of a pod instance that holds cards sees
the instance's cards, whether its card holder launches with it (a
gang's restart relaunches every task of the pod), before it (a sidecar
plan's task) or again with it; a task of an instance without cards
gets "" and sees none (no var at all would mean every card of the
host).
"""

from __future__ import annotations

import contextlib
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from dcos_commons_tpu_torch.common import Label, TaskInfo, new_task_id
from dcos_commons_tpu_torch.offer.inventory import (
    ResourceSnapshot,
    SliceInventory,
    card_index,
    card_order,
)
from dcos_commons_tpu_torch.offer.ledger import (
    Reservation,
    ReservationLedger,
    new_reservation_id,
)
from dcos_commons_tpu_torch.offer.multislice import (
    ENV_TPU_SLICE_COORDS,
    SLICE_COORDINATOR_PORT_NAME,
    eligible_slice_ids,
    place_slice_set,
)
from dcos_commons_tpu_torch.offer.outcome import EvaluationOutcome
from dcos_commons_tpu_torch.offer.placement import (
    PlacementContext,
    PlacementRule,
    parse_placement,
)
from dcos_commons_tpu_torch.plan.step import PodInstanceRequirement, RecoveryType
from dcos_commons_tpu_torch.specification.specs import (
    PodSpec,
    TaskSpec,
    task_full_name,
)
from dcos_commons_tpu_torch.state.state_store import GoalStateOverride, StateStore
from dcos_commons_tpu_torch.trace.recorder import NULL_TRACER

# env contract injected into every launched task (reference analogue:
# offer/taskdata/EnvConstants + PodInfoBuilder env assembly)
# idle command a PAUSED task runs instead of its real cmd (reference:
# the pause override sleep cmd in PodQueries/GoalStateOverride)
PAUSE_COMMAND = "sleep 1209600"

ENV_POD_INSTANCE_INDEX = "POD_INSTANCE_INDEX"
ENV_TASK_NAME = "TASK_NAME"
ENV_FRAMEWORK_NAME = "FRAMEWORK_NAME"
ENV_TPU_WORKER_ID = "TPU_WORKER_ID"
ENV_TPU_WORKER_COUNT = "TPU_WORKER_COUNT"
ENV_TPU_CHIPS_PER_HOST = "TPU_CHIPS_PER_HOST"
ENV_TPU_TOPOLOGY = "TPU_TOPOLOGY"
ENV_TPU_GENERATION = "TPU_GENERATION"
# card provisioning env (the reference bootstrap's task-side setup,
# sdk/bootstrap/main.go; here the scheduler computes it at placement):
# the card ids this host contributes, and the host-local indices the
# CUDA runtime confines the task to
ENV_TPU_CHIP_IDS = "TPU_CHIP_IDS"
ENV_CUDA_VISIBLE_DEVICES = "CUDA_VISIBLE_DEVICES"
ENV_COORDINATOR_ADDRESS = "COORDINATOR_ADDRESS"
ENV_TPU_SLICE_INDEX = "TPU_SLICE_INDEX"
ENV_TPU_NUM_SLICES = "TPU_NUM_SLICES"
COORDINATOR_PORT_NAME = "coordinator"


class EvaluationContext:
    """Shared per-cycle evaluation state (the offer-cycle fast path).

    ``run_cycle`` constructs ONE of these and threads it through every
    candidate evaluation, so the state-store task scan and the hosts
    dict are computed once per cycle instead of once per step.  Both
    are lazy — an idle cycle (no candidates) pays nothing.

    Correctness contract: the scheduler must call ``note_launched``
    after recording a launch, so the next candidate in the SAME cycle
    sees the just-launched tasks exactly as a fresh ``fetch_tasks``
    would (max-per/colocate rules count them).
    """

    def __init__(self, state_store: StateStore, inventory: SliceInventory):
        self._state_store = state_store
        self._inventory = inventory
        self._tasks: Optional[List[TaskInfo]] = None
        self._task_index: Optional[Dict[str, Dict[str, List[TaskInfo]]]] = None

    def tasks(self) -> List[TaskInfo]:
        if self._tasks is None:
            self._tasks = list(self._state_store.fetch_tasks())
        return self._tasks

    def hosts(self) -> Dict[str, object]:
        # cached on the inventory itself (keyed to its topology
        # generation) so every context of every cycle shares one dict
        # instead of rebuilding a fleet-sized map per cycle
        return self._inventory.hosts_by_id()

    def task_index(self) -> Dict[str, Dict[str, List[TaskInfo]]]:
        """pod_type -> instance key -> task infos, built once per
        cycle: PlacementContext counts come from this instead of a
        per-requirement scan over the whole task list."""
        if self._task_index is None:
            idx: Dict[str, Dict[str, List[TaskInfo]]] = {}
            for info in self.tasks():
                idx.setdefault(info.pod_type, {}).setdefault(
                    f"{info.pod_type}-{info.pod_index}", []
                ).append(info)
            self._task_index = idx
        return self._task_index

    def note_launched(self, infos: List[TaskInfo]) -> None:
        """Mirror ``StateStore.store_tasks`` semantics on the cached
        task list: a relaunch replaces the same-named entry."""
        if self._tasks is None or not infos:
            return
        names = {i.name for i in infos}
        self._tasks = [
            t for t in self._tasks if t.name not in names
        ] + list(infos)
        self._task_index = None

    def invalidate_tasks(self) -> None:
        """Drop the cached task scan after a mid-cycle state mutation
        this context cannot mirror (e.g. an ActionStep erasing tasks);
        the next evaluation re-fetches."""
        self._tasks = None
        self._task_index = None


@dataclass
class ReserveRecommendation:
    reservation: Reservation


@dataclass
class LaunchRecommendation:
    task_info: TaskInfo


@dataclass
class EvaluationResult:
    passed: bool
    outcome: EvaluationOutcome
    reservations: List[Reservation] = field(default_factory=list)
    task_infos: List[TaskInfo] = field(default_factory=list)

    @property
    def recommendations(self) -> List[object]:
        return [ReserveRecommendation(r) for r in self.reservations] + [
            LaunchRecommendation(t) for t in self.task_infos
        ]


class OfferEvaluator:
    def __init__(
        self,
        state_store: StateStore,
        ledger: ReservationLedger,
        service_name: str,
        target_config_id: str,
    ):
        self._state_store = state_store
        self._ledger = ledger
        self._service_name = service_name
        self._target_config_id = target_config_id
        # multi-service: free-capacity snapshots must subtract EVERY
        # service's claims, not just this service's namespaced ledger
        # (reference: one Mesos master arbitrates all frameworks; here
        # the merged ledger view is the arbiter)
        self._snapshot_view = ledger
        # set by the scheduler so snapshot synthesis shows up under
        # the cycle.* timers; None when wired by hand in tests
        self.metrics = None
        # traceview flight recorder (set by the scheduler alongside
        # metrics); hand-wired evaluators default to the no-op recorder
        self.tracer = None
        # fleet-scale fast path: shared copy-on-write snapshots,
        # indexed placement pre-filtering, and the per-requirement
        # failure memo.  False = the plain behavior (per-host snapshot
        # copies, full candidate scans) — the reference oracle the
        # equivalence tests and bench_fleet_scale compare against.
        self.fast_path = True
        # requirement-name -> (change token, failed result, pod spec):
        # a requirement that failed against an unchanged fleet/ledger/
        # task set short-circuits without re-scanning.  The pod spec
        # object is held so identity comparison can never alias a
        # recycled id() from a superseded config.
        self._memo: Dict[tuple, tuple] = {}

    @property
    def target_config_id(self) -> str:
        """The config id launches are stamped with (read by the
        autoscale plan synthesis when no config store is wired)."""
        return self._target_config_id

    def set_target_config(self, config_id: str) -> None:
        self._target_config_id = config_id
        self._memo.clear()

    def set_snapshot_view(self, view) -> None:
        self._snapshot_view = view
        self._memo.clear()

    def invalidate_memo(self) -> None:
        """Drop memoized requirement outcomes after a state mutation
        the change tokens cannot see (e.g. an ActionStep erasing
        tasks mid-cycle)."""
        self._memo.clear()

    def _incr(self, name: str) -> None:
        if self.metrics is not None:
            self.metrics.incr(name)

    # ------------------------------------------------------------------

    def evaluate(
        self,
        requirement: PodInstanceRequirement,
        inventory: SliceInventory,
        context: Optional[EvaluationContext] = None,
        trace_parent=None,
    ) -> EvaluationResult:
        """Match one requirement against the current inventory.

        ``context`` shares the task scan and hosts dict across every
        candidate of one scheduler cycle; omitted (direct callers,
        tests), a private one is built — same results, less reuse.
        ``trace_parent`` is the offer-cycle span: the evaluation span
        and its per-pod outcome events inherit its correlation id."""
        if context is None:
            context = EvaluationContext(self._state_store, inventory)
        tracer = self.tracer or NULL_TRACER
        pod = requirement.pod
        with tracer.span(
            f"evaluate:{requirement.name}", parent=trace_parent,
            track="scheduler", pod=pod.type,
        ) as span:
            result = self._evaluate_requirement(
                requirement, inventory, context
            )
            span.set_attr("passed", str(result.passed).lower())
            reason = result.outcome.reason or result.outcome.source
            if not result.passed:
                span.set_attr("failing_requirement", reason)
            # per-pod outcome events: one lane per pod instance, the
            # failing requirement attached where evaluation refused
            for index in requirement.instances:
                attrs = {"outcome": "pass" if result.passed else "fail"}
                if not result.passed:
                    attrs["failing_requirement"] = reason
                tracer.event(
                    f"evaluate:{pod.type}-{index}", parent=span,
                    track=f"{pod.type}-{index}", **attrs,
                )
            return result

    def _memo_token(self, inventory: SliceInventory):
        """Change token guarding the requirement-failure memo: the
        snapshot view's whole-ledger token plus the topology
        generation.  None disables memoization (view has no token)."""
        token_fn = getattr(self._snapshot_view, "generation_token", None)
        view_token = token_fn() if token_fn is not None else None
        if view_token is None:
            return None
        return (view_token, inventory.topology_generation)

    def _evaluate_requirement(
        self,
        requirement: PodInstanceRequirement,
        inventory: SliceInventory,
        context: EvaluationContext,
    ) -> EvaluationResult:
        token = self._memo_token(inventory) if self.fast_path else None
        memo_key = None
        if token is not None:
            memo_key = (
                requirement.name,
                tuple(requirement.instances),
                tuple(requirement.tasks_to_launch),
                requirement.recovery_type,
            )
            hit = self._memo.get(memo_key)
            if hit is not None and hit[0] == token \
                    and hit[2] is requirement.pod:
                # prior outcome was computed against an unchanged
                # candidate set: short-circuit without re-scanning
                self._incr("offers.eval.shortcircuit")
                return hit[1]
        timer = (
            self.metrics.time("cycle.snapshot")
            if self.metrics is not None else contextlib.nullcontext()
        )
        index = None
        with timer:
            if self.fast_path:
                index = inventory.offer_view(self._snapshot_view)
                snapshots = index.ordered_snapshots()
            else:
                snapshots = inventory.snapshots(self._snapshot_view)
        excluded = set(requirement.task_names())
        if index is not None:
            ctx = PlacementContext(
                pod_type=requirement.pod.type,
                hosts=context.hosts(),
                task_index=context.task_index(),
                excluded_names=frozenset(excluded),
            )
        else:
            ctx = PlacementContext(
                pod_type=requirement.pod.type,
                existing_tasks=[
                    t
                    for t in context.tasks()
                    # tasks being relaunched must not block their own
                    # placement
                    if t.name not in excluded
                ],
                hosts=context.hosts(),
            )
        result = self._evaluate_placed(
            requirement, inventory, snapshots, ctx, index
        )
        if memo_key is not None and not result.passed:
            # only failures memoize: a pass consumes capacity and is
            # never legitimately replayed
            self._memo[memo_key] = (token, result, requirement.pod)
        return result

    def _evaluate_placed(
        self,
        requirement: PodInstanceRequirement,
        inventory: SliceInventory,
        snapshots,
        ctx: PlacementContext,
        index,
    ) -> EvaluationResult:

        # In-place relaunch: reuse committed reservations when they are
        # still valid (reference: existing-pod pipeline reusing prior
        # resource ids, OfferEvaluator.java:266-310).  PERMANENT
        # recovery skips this and re-places from scratch.
        if requirement.recovery_type is not RecoveryType.PERMANENT:
            reuse = self._try_reuse(requirement, inventory)
            if reuse is not None:
                return reuse
            # sidecar tasks (backup/bench plans) launch inside a pod
            # instance whose footprint already exists: same host, own
            # scalars, never the pod's chips
            colocate = self._try_colocate(requirement, inventory, snapshots)
            if colocate is not None:
                return colocate

        pod = requirement.pod
        rule = parse_placement(pod.placement)
        # pre-reserved capacity (reference: ResourceSpec preReservedRole
        # + PreReservationCannotChange): the fleet operator marks hosts
        # as carved out for a role via the reserved_role attribute.
        # BOTH directions are enforced — a pod declaring the role
        # places ONLY on those hosts, and an ordinary pod NEVER lands
        # on a carved-out host (otherwise first-fit would consume the
        # reservation); the outcome tracker records refusals like any
        # placement term.
        from dcos_commons_tpu_torch.offer.placement import (
            AndRule,
            FieldMatchRule,
        )

        if pod.pre_reserved_role:
            rule = AndRule([
                FieldMatchRule("reserved_role", [pod.pre_reserved_role]),
                rule,
            ])
        else:
            rule = AndRule([
                FieldMatchRule("reserved_role", [""], invert=False),
                rule,
            ])
        # profile volumes constrain placement: the host must advertise
        # every storage profile the pod's volumes demand
        profiles = {
            p
            for task in pod.tasks
            for v in task.volumes
            for p in v.profiles
        }
        if profiles:
            from dcos_commons_tpu_torch.offer.placement import VolumeProfilesRule

            rule = AndRule([VolumeProfilesRule(profiles), rule])
        if pod.gang and pod.gpu is not None and pod.gpu.topology:
            return self._evaluate_gang(
                requirement, snapshots, rule, ctx, index
            )
        return self._evaluate_instances(
            requirement, snapshots, rule, ctx, index
        )

    # -- reuse path ----------------------------------------------------

    def _try_reuse(
        self,
        requirement: PodInstanceRequirement,
        inventory: SliceInventory,
    ) -> Optional[EvaluationResult]:
        """Relaunch on existing reservations if every task of the
        requirement still has its full footprint on healthy hosts."""
        placements: List[Tuple[int, str, List[Reservation]]] = []
        for index in requirement.instances:
            host_ids = set()
            reservations: List[Reservation] = []
            for task_name in requirement.tasks_to_launch:
                full = task_full_name(requirement.pod.type, index, task_name)
                task_reservations = self._ledger.for_task(full)
                if not task_reservations:
                    return None
                reservations.extend(task_reservations)
                host_ids |= {r.host_id for r in task_reservations}
            if len(host_ids) != 1:
                return None
            host_id = host_ids.pop()
            if not inventory.is_up(host_id):
                return None  # host gone: fall through to fresh placement
            placements.append((index, host_id, reservations))

        coordinator = self._existing_coordinator(requirement, inventory)
        pod = requirement.pod
        if pod.gang and pod.gpu is not None and pod.gpu.topology \
                and not coordinator:
            # a gang relaunch without the rendezvous reservation would
            # launch workers that hang forever in
            # init_process_group — fail loudly instead; the
            # operator escalates with `pod replace` (PERMANENT), which
            # re-places from scratch and mints a fresh coordinator
            return EvaluationResult(
                False,
                EvaluationOutcome.fail(
                    "reuse",
                    "no coordinator reservation found for gang "
                    "relaunch; refusing to launch a gang that cannot "
                    "rendezvous (escalate with pod replace)",
                ),
            )
        outcome = EvaluationOutcome.ok(
            "reuse", f"relaunching in place on {[p[1] for p in placements]}"
        )
        # multi-slice gangs carry a slice env contract
        # (TPU_SLICE_INDEX/TPU_NUM_SLICES, set at claim time in
        # _evaluate_gang); an in-place relaunch must restore it or the
        # mesh layer builds a dcn-less mesh.  Derived from the INSTANCE
        # index and pod.count: at claim time instances are [0..count-1]
        # slice-major, so worker_id == index — a subset relaunch (a
        # per-index deploy step) must not renumber from its enumerate
        # position.
        n_slices = pod.gpu.slices if pod.gpu is not None else 1
        hosts_per_slice = max(1, pod.count // max(1, n_slices))
        slice_coords: List[str] = []
        if n_slices > 1:
            slice_coords = self._existing_slice_coords(
                requirement, inventory, n_slices, hosts_per_slice
            )
        task_infos = []
        for index, host_id, reservations in placements:
            worker_id = index
            slice_env: Dict[str, str] = {}
            if n_slices > 1:
                slice_env = {
                    ENV_TPU_SLICE_INDEX: str(index // hosts_per_slice),
                    ENV_TPU_NUM_SLICES: str(n_slices),
                }
                if slice_coords:
                    slice_env[ENV_TPU_SLICE_COORDS] = ",".join(slice_coords)
            host = inventory.host(host_id)
            for task_name in requirement.tasks_to_launch:
                task_spec = requirement.pod.task(task_name)
                full = task_full_name(requirement.pod.type, index, task_name)
                task_res = [
                    r for r in reservations if r.task_name == full
                    and r.container_path not in (
                        COORDINATOR_PORT_NAME, SLICE_COORDINATOR_PORT_NAME
                    )
                ]
                # rebuild the PORT_* env contract from the reservation's
                # port list (appended in spec order at claim time)
                port_env: Dict[str, str] = {}
                if task_res:
                    for port_spec, port in zip(
                        task_spec.resources.ports, task_res[0].ports
                    ):
                        key = port_spec.env_key or f"PORT_{port_spec.name.upper()}"
                        port_env[key] = str(port)
                # chips follow the reservation holder (see claim path)
                task_chips = sorted({
                    c for r in task_res for c in r.chip_ids
                }, key=card_order)
                # a chip-less task sees the instance's cards, whether
                # its card holder is relaunched with it (a gang pod's
                # restart relaunches every task) or not (a sidecar
                # plan's task)
                visible = task_chips or sorted(
                    {c for r in reservations for c in r.chip_ids}
                    | set(self._instance_cards(requirement, index)),
                    key=card_order,
                )
                task_infos.append(
                    self._build_task_info(
                        requirement, task_spec, index, host,
                        reservations=task_res,
                        chips=task_chips,
                        coordinator=coordinator,
                        worker_id=worker_id,
                        extra_env={**port_env, **slice_env},
                        visible=visible,
                    )
                )
        return EvaluationResult(True, outcome, [], task_infos)

    def _try_colocate(
        self,
        requirement: PodInstanceRequirement,
        inventory: SliceInventory,
        snapshots: List[ResourceSnapshot],
    ) -> Optional[EvaluationResult]:
        """Place tasks into a pod instance whose footprint already
        exists: sibling tasks of the instance hold reservations, so the
        new tasks claim only their own cpu/mem/ports on that host.

        This is the sidecar-plan path (reference: cassandra backup
        plans run extra tasks inside the pod's existing executor
        footprint rather than re-negotiating resources).  The pod's
        chips are NOT re-reserved — they belong to its main tasks.
        """
        pod = requirement.pod
        sibling_names = {t.name for t in pod.tasks} - set(
            requirement.tasks_to_launch
        )
        if not sibling_names:
            return None
        placements: List[Tuple[int, str]] = []
        for index in requirement.instances:
            anchors: List[Reservation] = []
            for other in sibling_names:
                anchors.extend(
                    self._ledger.for_task(
                        task_full_name(pod.type, index, other)
                    )
                )
            host_ids = {r.host_id for r in anchors}
            if len(host_ids) != 1:
                return None  # no (or ambiguous) footprint: fresh placement
            host_id = host_ids.pop()
            if not inventory.is_up(host_id):
                return None
            placements.append((index, host_id))
        snap_by_host = {s.host.host_id: s for s in snapshots}
        outcome = EvaluationOutcome.ok(
            "colocate",
            f"sidecar tasks joining existing footprint on "
            f"{[h for _, h in placements]}",
        )
        reservations: List[Reservation] = []
        task_infos: List[TaskInfo] = []
        # a gang sidecar group (the collectives bench) rendezvous like
        # the main gang: instance 0's host carries a fresh coordinator
        # port for THIS task group — the trainer's port is in use
        gang_group = (
            pod.gang and pod.gpu is not None and len(placements) > 1
        )
        coordinator = ""
        if gang_group:
            coord_host = placements[0][1]
            coord_snap = snap_by_host.get(coord_host)
            if coord_snap is None:
                return None
            coord_port = coord_snap.copy().allocate_port()
            coordinator = _coordinator_address(coord_snap.host, coord_port)
        # instances sharing a host consume from ONE working snapshot so
        # capacity cannot be double-booked
        claimed: Dict[str, ResourceSnapshot] = {}
        for worker_id, (index, host_id) in enumerate(placements):
            work = claimed.get(host_id)
            if work is None:
                snap = snap_by_host.get(host_id)
                if snap is None:
                    return None
                work = snap.copy()
                claimed[host_id] = work
            res, infos = self._claim_instance(
                requirement, index, work, [], coordinator=coordinator,
                coordinator_here=(gang_group and worker_id == 0),
                worker_id=worker_id,
                visible=self._instance_cards(requirement, index),
            )
            if res is None:
                return EvaluationResult(
                    False,
                    EvaluationOutcome.fail(
                        "colocate",
                        f"pod {pod.type}-{index} footprint host {host_id} "
                        "lacks cpu/mem for the sidecar task",
                    ),
                )
            reservations.extend(res)
            task_infos.extend(infos)
        return EvaluationResult(True, outcome, reservations, task_infos)

    def _existing_coordinator(
        self, requirement: PodInstanceRequirement, inventory
    ) -> str:
        # relaunches keep the original rendezvous point: reservations
        # for instance 0 carry the coordinator port
        for r in self._ledger.for_task(
            task_full_name(
                requirement.pod.type, 0, requirement.tasks_to_launch[0]
            )
        ):
            if r.container_path == COORDINATOR_PORT_NAME and r.ports:
                host = inventory.host(r.host_id)
                if host is not None:
                    return _coordinator_address(host, r.ports[0])
                # coordinator host gone from the inventory: there is
                # no dialable address — return nothing so the gang
                # reuse guard fails LOUDLY instead of launching
                # workers that hang in init_process_group
                return ""
        return ""

    def _instance_cards(
        self, requirement: PodInstanceRequirement, index: int
    ) -> List[str]:
        """The cards held by pod instance ``index``'s tasks that this
        requirement does not launch: what a sidecar task joining the
        instance sees (the chips of the reference's sidecar path are
        not re-reserved, and on a GPU host no ``CUDA_VISIBLE_DEVICES``
        would show it every card of the host)."""
        pod = requirement.pod
        launching = set(requirement.tasks_to_launch)
        cards = {
            c
            for task in pod.tasks if task.name not in launching
            for r in self._ledger.for_task(
                task_full_name(pod.type, index, task.name)
            )
            for c in r.chip_ids
        }
        return sorted(cards, key=card_order)

    def _existing_slice_coords(
        self, requirement: PodInstanceRequirement, inventory,
        n_slices: int, hosts_per_slice: int,
    ) -> List[str]:
        """Rebuild the per-slice coordinator address list from the
        slice leaders' SLICE_COORDINATOR_PORT_NAME reservations (the
        multi-slice analogue of ``_existing_coordinator``).  An empty
        list means some leader's claim is gone — the caller omits
        TPU_SLICE_COORDS rather than advertise a partial set."""
        coords: List[str] = []
        for k in range(n_slices):
            leader = k * hosts_per_slice
            addr = ""
            for r in self._ledger.for_task(
                task_full_name(
                    requirement.pod.type, leader,
                    requirement.tasks_to_launch[0],
                )
            ):
                if r.container_path == SLICE_COORDINATOR_PORT_NAME \
                        and r.ports:
                    host = inventory.host(r.host_id)
                    if host is not None:
                        addr = _coordinator_address(host, r.ports[0])
                    break
            if not addr:
                return []
            coords.append(addr)
        return coords

    # -- fresh placement ----------------------------------------------

    def _evaluate_gang(
        self,
        requirement: PodInstanceRequirement,
        snapshots: List[ResourceSnapshot],
        rule: PlacementRule,
        ctx: PlacementContext,
        index=None,
    ) -> EvaluationResult:
        pod = requirement.pod
        scalar_needs = _pod_scalar_needs(pod, requirement.tasks_to_launch)

        def eligible(snap: ResourceSnapshot) -> EvaluationOutcome:
            rule_outcome = rule.filter(snap, ctx)
            if not rule_outcome.passed:
                return rule_outcome
            probe = snap.copy()
            if not probe.try_consume_scalar(*scalar_needs):
                return EvaluationOutcome.fail(
                    f"host:{snap.host.host_id}",
                    f"insufficient cpu/mem/disk for {scalar_needs}",
                )
            return EvaluationOutcome.ok(f"host:{snap.host.host_id}")

        if index is not None:
            # slice-set pre-filter (offer/multislice.py): fabrics that
            # cannot hold even one `topology` node set are skipped
            # before any node search
            eligible_slices = eligible_slice_ids(
                index, ctx.hosts, pod.gpu.total_chips,
                generation=pod.gpu.generation,
                chips_per_host=pod.gpu.chips_per_host,
            )
            if eligible_slices:
                slice_index = index.value_index("slice")
                candidate_ids: set = set()
                for s in eligible_slices:
                    candidate_ids |= slice_index.get(s, frozenset())
                self._incr("offers.index.hit")
                snapshots = index.snapshots_for(candidate_ids)
            else:
                # nothing can place: run the UNFILTERED search so the
                # outcome tree explains every slice's refusal (the
                # requirement memo keeps repeat failures O(1))
                self._incr("offers.index.scan")

        # multi-slice gangs (gpu: slices: N): N slice-local sub-gangs,
        # one `topology` node set in each of N DISTINCT fabrics, all
        # on one DCN pool (offer/multislice.py).  Workers
        # are numbered slice-major; every worker gets
        # TPU_SLICE_INDEX/TPU_NUM_SLICES so the mesh layer lays the dcn
        # (data-parallel-across-slices) axis over the slice boundary
        # and keeps tp/sp collectives inside a fabric.
        n_slices = pod.gpu.slices
        placement = place_slice_set(snapshots, pod.gpu, eligible)
        outcome = placement.outcome
        if not placement.ok:
            return EvaluationResult(False, outcome)
        ordered = placement.snapshots
        if len(ordered) != len(requirement.instances):
            outcome.passed = False
            outcome.reason = (
                f"{n_slices} slice(s) of topology yield {len(ordered)} "
                f"hosts but pod count is {len(requirement.instances)}"
            )
            return EvaluationResult(False, outcome)

        # worker 0's host (slice 0) carries the process group's
        # coordinator for the WHOLE multi-slice gang: one global
        # rendezvous, fabric-local + cross-fabric DCN under one
        # mesh.  Each slice leader (worker k*hosts_per_slice)
        # additionally carries a slice-local rendezvous port; the full
        # slice-major address list is advertised to every worker as
        # TPU_SLICE_COORDS.  Ports are probed on snapshot COPIES here
        # and re-allocated identically at claim time — both walks
        # start from the same committed snapshot state, so the claim
        # is deterministic (the established coordinator idiom).
        coord_snap = ordered[0]
        probe = coord_snap.copy()
        coord_port = probe.allocate_port()
        coordinator = _coordinator_address(coord_snap.host, coord_port)
        hosts_per_slice = placement.hosts_per_slice
        slice_coords: List[str] = []
        if n_slices > 1:
            for k in range(n_slices):
                leader = ordered[k * hosts_per_slice]
                # slice 0's leader already allocated the global
                # coordinator port on `probe` — reuse that walk so the
                # second allocation cannot collide with the first
                leader_probe = probe if k == 0 else leader.copy()
                slice_port = leader_probe.allocate_port()
                slice_coords.append(
                    _coordinator_address(leader.host, slice_port)
                )

        reservations: List[Reservation] = []
        task_infos: List[TaskInfo] = []
        for worker_id, (index_i, snap) in enumerate(
            zip(requirement.instances, ordered)
        ):
            work = snap.copy()
            # the spec's share of the node, not the whole host: any k
            # cards of an NVSwitch node serve (offer/nvlink.py)
            chips = work.try_consume_chips(pod.gpu.chips_per_host)
            if chips is None:  # cannot happen post-eligibility; guard anyway
                return EvaluationResult(
                    False,
                    EvaluationOutcome.fail(
                        "gang", f"chips vanished on {snap.host.host_id}"
                    ),
                )
            slice_env = {}
            slice_coordinator = ""
            if n_slices > 1:
                slice_env = {
                    ENV_TPU_SLICE_INDEX: str(worker_id // hosts_per_slice),
                    ENV_TPU_NUM_SLICES: str(n_slices),
                    ENV_TPU_SLICE_COORDS: ",".join(slice_coords),
                }
                if worker_id % hosts_per_slice == 0:
                    slice_coordinator = slice_coords[
                        worker_id // hosts_per_slice
                    ]
            res, infos = self._claim_instance(
                requirement, index_i, work, chips, coordinator,
                coordinator_here=(worker_id == 0), worker_id=worker_id,
                extra_env=slice_env, slice_coordinator=slice_coordinator,
            )
            if res is None:
                return EvaluationResult(
                    False,
                    EvaluationOutcome.fail(
                        "gang", f"resource claim failed on {snap.host.host_id}"
                    ),
                )
            reservations.extend(res)
            task_infos.extend(infos)
        return EvaluationResult(True, outcome, reservations, task_infos)

    def _evaluate_instances(
        self,
        requirement: PodInstanceRequirement,
        snapshots: List[ResourceSnapshot],
        rule: PlacementRule,
        ctx: PlacementContext,
        index=None,
    ) -> EvaluationResult:
        """Non-gang: place each instance independently, first host wins
        (reference: first fully-passing offer, OfferEvaluator.java:137-171).

        Indexed path: the rule emits a candidate host-id SET which is
        intersected with the free-chip-count bucket BEFORE any
        snapshot is touched; candidates iterate in scan-order so the
        winner is identical to a full scan.  Recomputed per instance —
        each placement updates the counts the rules consult."""
        pod = requirement.pod
        reservations: List[Reservation] = []
        task_infos: List[TaskInfo] = []
        root = EvaluationOutcome.ok("evaluate", pod.type)
        claimed_hosts: Dict[str, ResourceSnapshot] = {}
        # deploy-time candidate algebra: a rule
        # with a STATIC candidate key yields the same candidate set —
        # and the same chip-bucket intersection, which reads the
        # committed view, not the loop's local claims — for every
        # instance of this requirement, so the set algebra and the
        # scan-order sort run ONCE, not once per instance.  Dynamic
        # rules (count-dependent) recompute per placement as before.
        static_scan: Optional[List[ResourceSnapshot]] = None
        rule_is_static = False
        if index is not None:
            key_of = getattr(rule, "candidate_key", None)
            rule_is_static = callable(key_of) and key_of() is not None
            if rule_is_static:
                cand = index.rule_candidates(rule, ctx)
                if pod.gpu is not None:
                    chip_ok = index.hosts_with_free_chips(
                        pod.gpu.chips_per_host
                    )
                    cand = chip_ok if cand is None else cand & chip_ok
                if cand:
                    static_scan = index.snapshots_for(cand)
        for index_i in requirement.instances:
            scan = snapshots
            if index is not None and rule_is_static:
                if static_scan is not None:
                    self._incr("offers.index.hit")
                    scan = static_scan
                else:
                    self._incr("offers.index.scan")
            elif index is not None:
                cand = index.rule_candidates(rule, ctx)
                if pod.gpu is not None:
                    chip_ok = index.hosts_with_free_chips(
                        pod.gpu.chips_per_host
                    )
                    cand = chip_ok if cand is None else cand & chip_ok
                if cand:
                    self._incr("offers.index.hit")
                    scan = index.snapshots_for(cand)
                else:
                    # unbounded rule (None) — or an EMPTY candidate
                    # set, where the full scan runs so the outcome
                    # tree explains every host's refusal (the
                    # requirement memo keeps repeat failures O(1))
                    self._incr("offers.index.scan")
            placed = False
            for snap in scan:
                snap = claimed_hosts.get(snap.host.host_id, snap)
                rule_outcome = rule.filter(snap, ctx)
                if not rule_outcome.passed:
                    root.children.append(rule_outcome)
                    continue
                work = snap.copy()
                chips = None
                if pod.gpu is not None:
                    if not snap.host.generation:
                        root.children.append(EvaluationOutcome.fail(
                            f"host:{snap.host.host_id}", "not a GPU host"
                        ))
                        continue
                    if snap.host.generation != pod.gpu.generation:
                        # the kernels are built for one generation
                        # (sm_90a for h100): another card cannot run
                        # them, so it is no substitute
                        root.children.append(EvaluationOutcome.fail(
                            f"host:{snap.host.host_id}",
                            f"generation {snap.host.generation!r}, pod "
                            f"needs {pod.gpu.generation!r}",
                        ))
                        continue
                    chips = work.try_consume_chips(pod.gpu.chips_per_host)
                    if chips is None:
                        root.children.append(EvaluationOutcome.fail(
                            f"host:{snap.host.host_id}",
                            f"needs {pod.gpu.chips_per_host} chips, "
                            f"{len(snap.free_chips)} free",
                        ))
                        continue
                res, infos = self._claim_instance(
                    requirement, index_i, work, chips or [], coordinator="",
                    coordinator_here=False, worker_id=index_i,
                )
                if res is None:
                    root.children.append(EvaluationOutcome.fail(
                        f"host:{snap.host.host_id}", "insufficient cpu/mem/disk"
                    ))
                    continue
                reservations.extend(res)
                task_infos.extend(infos)
                claimed_hosts[snap.host.host_id] = work
                # placement context must see this instance for max-per
                # rules on subsequent instances in the same requirement
                ctx.record_tasks(infos)
                placed = True
                root.children.append(EvaluationOutcome.ok(
                    f"host:{snap.host.host_id}",
                    f"{pod.type}-{index_i} placed",
                ))
                break
            if not placed:
                root.passed = False
                root.reason = f"no host satisfies {pod.type}-{index_i}"
                return EvaluationResult(False, root)
        return EvaluationResult(True, root, reservations, task_infos)

    # -- claim + TaskInfo assembly ------------------------------------

    def _claim_instance(
        self,
        requirement: PodInstanceRequirement,
        index: int,
        work: ResourceSnapshot,
        chips: List[str],
        coordinator: str,
        coordinator_here: bool,
        worker_id: int,
        extra_env: Optional[Dict[str, str]] = None,
        slice_coordinator: str = "",
        visible: Optional[List[str]] = None,
    ):
        """Consume scalars/ports on ``work`` and emit reservations +
        TaskInfos for every task of one pod instance.

        ``slice_coordinator`` (multi-slice gangs, slice leaders only)
        is this host's slice-local rendezvous address: its port is
        claimed here under SLICE_COORDINATOR_PORT_NAME, riding the
        first task's resource ids like the global coordinator port.
        ``visible`` (the sidecar path) is the instance's cards, which a
        task given no ``chips`` sees."""
        pod = requirement.pod
        reservations: List[Reservation] = []
        task_infos: List[TaskInfo] = []
        chips_assigned = False
        # volume keys shared across the tasks claimed in THIS call
        # (ledger lookups only see already-committed siblings)
        instance_volumes: Dict[str, str] = {}
        anchor_res: List[Reservation] = []
        if coordinator_here:
            coord_port = work.allocate_port(int(coordinator.rsplit(":", 1)[1]))
            if coord_port is None:
                coord_port = work.allocate_port()
                coordinator = _coordinator_address(work.host, coord_port)
            anchor_res.append(Reservation(
                reservation_id=new_reservation_id(),
                host_id=work.host.host_id,
                task_name=task_full_name(
                    pod.type, index, requirement.tasks_to_launch[0]
                ),
                cpus=0.0,
                ports=[coord_port],
                container_path=COORDINATOR_PORT_NAME,
            ))
        if slice_coordinator:
            slice_port = work.allocate_port(
                int(slice_coordinator.rsplit(":", 1)[1])
            )
            if slice_port is None:
                slice_port = work.allocate_port()
            anchor_res.append(Reservation(
                reservation_id=new_reservation_id(),
                host_id=work.host.host_id,
                task_name=task_full_name(
                    pod.type, index, requirement.tasks_to_launch[0]
                ),
                cpus=0.0,
                ports=[slice_port],
                container_path=SLICE_COORDINATOR_PORT_NAME,
            ))
        reservations.extend(anchor_res)
        disk_seen_paths: set = set()
        for task_name in requirement.tasks_to_launch:
            task_spec = pod.task(task_name)
            full = task_full_name(pod.type, index, task_name)
            task_disk = _task_disk_mb(task_spec, disk_seen_paths)
            if not work.try_consume_scalar(
                task_spec.resources.cpus,
                task_spec.resources.memory_mb,
                task_disk,
            ):
                return None, None
            ports: List[int] = []
            port_env: Dict[str, str] = {}
            for port_spec in task_spec.resources.ports:
                port = work.allocate_port(port_spec.port)
                if port is None:
                    return None, None
                ports.append(port)
                key = port_spec.env_key or f"PORT_{port_spec.name.upper()}"
                port_env[key] = str(port)
            task_chips = chips if not chips_assigned else []
            chips_assigned = chips_assigned or bool(chips)
            volumes = self._instance_volume_keys(
                requirement, pod, index, task_spec, instance_volumes
            )
            reservation = Reservation(
                reservation_id=new_reservation_id(),
                host_id=work.host.host_id,
                task_name=full,
                role=self._service_name,
                cpus=task_spec.resources.cpus,
                memory_mb=task_spec.resources.memory_mb,
                disk_mb=task_disk,
                chip_ids=list(task_chips),
                ports=ports,
                volume_id=(uuid.uuid4().hex if task_spec.volumes else ""),
                container_path=(
                    task_spec.volumes[0].container_path if task_spec.volumes else ""
                ),
                volumes=volumes,
            )
            reservations.append(reservation)
            # the coordinator-port claims (global and slice-local)
            # ride on the first task's resource ids so reservation GC
            # (which keeps every id referenced by a stored TaskInfo)
            # never reclaims them
            info_res = [reservation]
            if anchor_res and not task_infos:
                info_res.extend(anchor_res)
            info = self._build_task_info(
                requirement, task_spec, index, work.host,
                # chips follow the RESERVATION holder: only the task
                # whose reservation carries the chip ids receives the
                # card provisioning env — a co-launched chip-less
                # sidecar must not double-bind the devices
                reservations=info_res, chips=list(task_chips),
                coordinator=coordinator, worker_id=worker_id,
                extra_env={**(extra_env or {}), **port_env},
                # a chip-less sibling sees the instance's cards: those
                # claimed in this call, else a sidecar's ``visible``
                visible=task_chips or visible or list(chips),
            )
            task_infos.append(info)
        return reservations, task_infos

    def _instance_volume_keys(
        self,
        requirement,
        pod,
        index: int,
        task_spec,
        claimed_now: Optional[Dict[str, str]] = None,
    ) -> Dict[str, str]:
        """container_path -> durable volume key for one task.

        Sibling tasks of one pod instance that declare the SAME
        container path share one key, so the hdfs format-then-node
        choreography writes and reads one durable directory
        (reference: pods share their resource set's volumes).  A
        PERMANENT replace never reuses old keys — the replacement
        starts empty."""
        keys: Dict[str, str] = {}
        if not task_spec.volumes:
            return keys
        existing: Dict[str, str] = dict(claimed_now or {})
        if requirement.recovery_type is not RecoveryType.PERMANENT:
            for sibling in pod.tasks:
                full = task_full_name(pod.type, index, sibling.name)
                for res in self._ledger.for_task(full):
                    for path, key in (res.volumes or {}).items():
                        existing.setdefault(path, key)
        for v in task_spec.volumes:
            keys[v.container_path] = existing.get(
                v.container_path, uuid.uuid4().hex
            )
            existing[v.container_path] = keys[v.container_path]
        if claimed_now is not None:
            claimed_now.update(keys)
        return keys

    def _build_task_info(
        self,
        requirement: PodInstanceRequirement,
        task_spec: TaskSpec,
        index: int,
        host,
        reservations: List[Reservation],
        chips: List[str],
        coordinator: str,
        worker_id: int = 0,
        extra_env: Optional[Dict[str, str]] = None,
        visible: Optional[List[str]] = None,
    ) -> TaskInfo:
        """Reference: PodInfoBuilder (offer/evaluate/PodInfoBuilder.java,
        831 LoC) — command, env, readiness label, discovery assembly.
        ``visible``: the cards the task sees (``chips`` when None)."""
        pod = requirement.pod
        full = task_full_name(pod.type, index, task_spec.name)
        env = dict(task_spec.env)
        env.update(extra_env or {})
        # parameterized-plan env (PodInstanceRequirement.env_overrides)
        # beats the spec but never the system contract vars below
        env.update(requirement.env_overrides)
        env[ENV_POD_INSTANCE_INDEX] = str(index)
        env[ENV_TASK_NAME] = full
        env[ENV_FRAMEWORK_NAME] = self._service_name
        if pod.gpu is not None:
            env[ENV_TPU_WORKER_ID] = str(worker_id)
            # a gang's worker count is the GANG size, even when this
            # evaluation covers a subset (per-index relaunch step)
            env[ENV_TPU_WORKER_COUNT] = str(
                pod.count if pod.gang else len(requirement.instances)
            )
            # the mesh slice of the contract comes from the spec
            # itself (GpuSpec.mesh_env) — the same dict the static
            # sharding analyzer evaluates, so launch and analysis
            # cannot drift.  Claim-time slice vars (extra_env) agree
            # by construction when both set TPU_NUM_SLICES.
            env.update(pod.gpu.mesh_env())
            if chips:
                # callers pass THIS host's chips (claim consumes per
                # host; reuse gathers per instance); ';'-separated as
                # in the JAX package, whose chip ids carry grid commas
                env[ENV_TPU_CHIP_IDS] = ";".join(chips)
            if coordinator:
                env[ENV_COORDINATOR_ADDRESS] = coordinator
        # every task, of a GPU pod or not: on a GPU host a task with
        # no CUDA_VISIBLE_DEVICES would see every card of the host
        env[ENV_CUDA_VISIBLE_DEVICES] = ",".join(
            str(card_index(c))
            for c in (chips if visible is None else visible)
        )
        labels = {
            Label.TARGET_CONFIG: self._target_config_id,
            Label.HOSTNAME: host.hostname,
            Label.ZONE: host.zone,
            Label.REGION: host.region,
            Label.GOAL_STATE: task_spec.goal.value,
        }
        if pod.networks:
            # virtual network membership (reference: CNI networks on
            # the ContainerInfo): recorded for the agent's container
            # runtime and surfaced to the task
            labels[Label.NETWORKS] = ",".join(pod.networks)
            env["TASK_NETWORKS"] = ",".join(pod.networks)
        if pod.share_pid_namespace:
            labels[Label.SHARE_PID_NAMESPACE] = "true"
        # pod pause: a PAUSED goal override swaps the real command for
        # an idle one, so the task occupies its reservations without
        # doing work (reference: GoalStateOverride.PAUSED launched with
        # a sleep override cmd, PodQueries.java:183-203)
        command = task_spec.cmd
        override, _progress = self._state_store.fetch_goal_override(full)
        if override is GoalStateOverride.PAUSED:
            command = PAUSE_COMMAND
            labels[Label.GOAL_STATE_OVERRIDE] = override.value
        volumes: Dict[str, str] = {}
        for r in reservations:
            volumes.update(r.volumes or {})
        return TaskInfo(
            name=full,
            task_id=new_task_id(full),
            agent_id=host.host_id,
            pod_type=pod.type,
            pod_index=index,
            command=command,
            env=env,
            resource_ids=[r.reservation_id for r in reservations],
            tpu_chip_ids=list(chips),
            volume_ids=[r.volume_id for r in reservations if r.volume_id],
            volumes=volumes,
            labels=labels,
        )


def _coordinator_address(host, port) -> str:
    """The process group's rendezvous point workers DIAL — it must be
    a reachable address, so the topology's ``hostname`` (the DCN
    address of the host) wins over the logical host_id."""
    return f"{host.hostname or host.host_id}:{port}"


def _task_disk_mb(task_spec, seen_paths: set) -> int:
    """Disk demand of one task within a pod instance.  A volume path
    SHARED by sibling tasks (pod-level volumes are merged into every
    task's spec) is one durable directory — only the first sibling
    pays its size, or a 2-task pod would demand twice the disk the
    instance actually uses."""
    disk = task_spec.resources.disk_mb
    for v in task_spec.volumes:
        if v.container_path not in seen_paths:
            seen_paths.add(v.container_path)
            disk += v.size_mb
    return disk


def _pod_scalar_needs(pod: PodSpec, tasks_to_launch: List[str]) -> Tuple[float, int, int]:
    cpus, mem, disk = 0.0, 0, 0
    seen_paths: set = set()
    for name in tasks_to_launch:
        spec = pod.task(name)
        cpus += spec.resources.cpus
        mem += spec.resources.memory_mb
        disk += _task_disk_mb(spec, seen_paths)
    return cpus, mem, disk

"""Elastic re-slicing: the gang that shrinks instead of waiting.

The reference SDK only ever recovers 1:1 — PERMANENT recovery
re-places the same footprint it lost (SURVEY section 7 stage 8).  A
GPU fleet loses capacity it cannot get back (preemption) or loses it
for a bounded window (maintenance), and a DP-sharded trainer can keep
making progress on a smaller mesh: params and optimizer state are
replicated over the ``dp`` axis, so restoring the newest fenced
checkpoint onto fewer hosts is a pure re-layout — same leaves, new
sharding (parallel/mesh.py ``elastic_reshard_ok`` is the worker-side
contract check).

Two pieces live here:

* :func:`decide_resize` — the PURE decision rule (plancheck-style
  verifiable, property-testable): when a full-size sub-slice cannot
  place, shrink only if (a) the pod opted in (``gpu: elastic:``),
  (b) enough placement attempts failed that "transient fragmentation"
  is off the table, (c) no maintenance window promises the capacity
  back, and (d) a clean smaller size exists — a DIVISOR of the full
  gang (so the global batch reshards evenly over the new ``dp``) at
  or above ``min_hosts``.
* :class:`ElasticGangStep` — the recovery plan's replace step: a
  DeploymentStep whose requirement starts at full size and re-scopes
  itself (smaller pod copy, scaled topology) when the rule says
  shrink.  Every re-scope is journaled; the step stays operator-
  interruptible like any other.

Port of ``dcos_commons_tpu/recovery/elastic.py``, line for line but
the imports and ``pod.gpu`` for ``pod.tpu``.  ``shrink_topology``
keeps the reference's halve-largest-first rule, made for torus
rectangles, although the node-set search (offer/nvlink.py) needs only
``total_chips == hosts x chips_per_host``: every shrink decision stays
equal to the reference's.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, List, Optional

from dcos_commons_tpu_torch.plan.backoff import Backoff
from dcos_commons_tpu_torch.plan.step import (
    DeploymentStep,
    PodInstanceRequirement,
    RecoveryType,
)
from dcos_commons_tpu_torch.specification.specs import PodSpec, task_full_name


@dataclass(frozen=True)
class ElasticPolicy:
    """Per-pod elastic-resize policy (from the ``gpu:`` YAML block)."""

    enabled: bool = False
    # never shrink below this many hosts (the operator's floor: a
    # 2-host trainer may be pointless for the workload)
    min_hosts: int = 1
    # full-size placement attempts (declined offer cycles) before the
    # rule considers the capacity really gone rather than fragmented
    shrink_after_declines: int = 3


@dataclass(frozen=True)
class ResizeDecision:
    target_hosts: int
    reason: str


def shrink_candidates(full_hosts: int, min_hosts: int) -> List[int]:
    """Descending proper divisors of ``full_hosts`` at or above
    ``min_hosts`` — the only sizes a DP-sharded trainer reshards onto
    cleanly (the global batch and the checkpoint's dp axis must
    divide)."""
    floor = max(1, int(min_hosts))
    return [
        k for k in range(full_hosts - 1, floor - 1, -1)
        if full_hosts % k == 0
    ]


def slice_shrink_candidates(
    full_hosts: int, min_hosts: int, host_quantum: int
) -> List[int]:
    """Descending whole-slice widths for a multi-slice gang: multiples
    of ``host_quantum`` (= hosts per slice) below ``full_hosts`` at or
    above ``min_hosts``.  Dropping whole slices shrinks ONLY the dcn
    axis — each surviving slice keeps its full ``topology`` rectangle,
    so the per-slice ICI layout (and every non-batch mesh axis) is
    untouched and the restore is a pure re-layout regardless of
    divisibility (``elastic_reshard_ok`` permits any dcn width)."""
    floor = max(1, int(min_hosts))
    q = max(1, int(host_quantum))
    return [
        k for k in range(full_hosts - q, 0, -q)
        if k >= floor
    ]


def decide_resize(
    current_hosts: int,
    full_hosts: int,
    declines: int,
    policy: ElasticPolicy,
    maintenance_returning: bool,
    host_quantum: int = 1,
) -> ResizeDecision:
    """The shrink-vs-wait rule.  PURE — no clocks, no inventory: the
    caller feeds observed facts, the rule returns the target size.

    ``maintenance_returning`` is True when any drained host has a
    FINITE maintenance window (the capacity comes back): waiting for
    the window beats training at half width and paying a second
    restart when it ends.  Preempted capacity never returns by
    contract, so a pure-preemption loss shrinks as soon as the
    decline budget is spent.

    ``host_quantum`` > 1 is the multi-slice gang case (quantum =
    hosts per slice): valid widths drop WHOLE slices — the dcn axis
    shrinks, each surviving slice keeps its topology — instead of the
    single-slice divisor rule.
    """
    if not policy.enabled:
        return ResizeDecision(current_hosts, "elastic disabled")
    if declines < max(1, policy.shrink_after_declines):
        return ResizeDecision(
            current_hosts,
            f"waiting: {declines}/{policy.shrink_after_declines} "
            "placement attempts",
        )
    if maintenance_returning:
        return ResizeDecision(
            current_hosts,
            "waiting: a maintenance window promises the capacity back",
        )
    # sizes strictly below the current target the checkpoint reshards
    # onto cleanly: divisors of the FULL gang (dp axis must divide) —
    # or whole-slice multiples when the gang spans slices (dcn axis)
    if host_quantum > 1:
        candidates = slice_shrink_candidates(
            full_hosts, policy.min_hosts, host_quantum
        )
    else:
        candidates = shrink_candidates(full_hosts, policy.min_hosts)
    for k in candidates:
        if k < current_hosts:
            kind = "slice(s)" if host_quantum > 1 else "hosts"
            width = k // host_quantum if host_quantum > 1 else k
            cur = (
                current_hosts // host_quantum
                if host_quantum > 1 else current_hosts
            )
            return ResizeDecision(
                k, f"shrinking {cur} -> {width} {kind}"
            )
    return ResizeDecision(
        current_hosts,
        f"no clean size between {policy.min_hosts} and "
        f"{current_hosts - 1} hosts",
    )


def shrink_topology(gpu, target_hosts: int) -> Optional[str]:
    """Scale a declared gang topology down to ``target_hosts`` hosts
    by halving dimensions largest-first; None when no clean rectangle
    exists (the caller must not shrink).  The result keeps every
    dimension a positive integer and the card total exactly
    ``target_hosts * chips_per_host`` — what ``find_node_set`` needs
    to place the smaller gang."""
    dims = list(gpu.topology_dims())
    if not dims:
        return ""
    want = target_hosts * gpu.chips_per_host
    have = 1
    for d in dims:
        have *= d
    while have > want:
        dims.sort(reverse=True)
        if have % 2 or dims[0] % 2:
            return None
        dims[0] //= 2
        have //= 2
    if have != want:
        return None
    return "x".join(str(d) for d in sorted(dims, reverse=True))


def shrunken_pod(pod: PodSpec, target_hosts: int) -> Optional[PodSpec]:
    """A copy of a gang pod scoped to ``target_hosts`` instances with
    a proportionally scaled topology; None when the topology cannot
    scale to that size.  The copy rides ONLY the recovery
    requirement — the service spec keeps the full-size pod, so a
    later `pod replace` (or a scheduler restart's update plan)
    restores full width when capacity returns."""
    if target_hosts >= pod.count:
        return pod
    if pod.gpu is None:
        return dataclasses.replace(pod, count=target_hosts)
    if pod.gpu.slices > 1:
        # multi-slice gangs shrink by WHOLE slices: the
        # per-slice topology is untouched — only `slices` (the dcn
        # axis) drops — so count must stay a multiple of
        # hosts-per-slice or the requirement could never satisfy
        # count == slices x hosts-per-slice
        hps = max(1, pod.count // pod.gpu.slices)
        if target_hosts % hps or target_hosts < hps:
            return None
        gpu = dataclasses.replace(pod.gpu, slices=target_hosts // hps)
        return dataclasses.replace(pod, count=target_hosts, gpu=gpu)
    topo = shrink_topology(pod.gpu, target_hosts)
    if topo is None:
        return None
    gpu = dataclasses.replace(pod.gpu, topology=topo)
    return dataclasses.replace(pod, count=target_hosts, gpu=gpu)


class ElasticGangStep(DeploymentStep):
    """The gang recovery plan's replace step.

    Starts as a PERMANENT whole-gang requirement.  Each declined offer
    cycle feeds :func:`decide_resize`; when the rule says shrink, the
    requirement is re-scoped in place to a smaller pod copy (count +
    topology scaled) and the next evaluation places the narrower gang.
    ``target_hosts`` is read by the trailing trim step to erase the
    surplus instances' state so recovery does not chase ghosts.

    ``maintenance_probe`` is a callable returning True while any
    drained host has a finite maintenance window (recovery manager
    closes it over the shared inventory)."""

    def __init__(
        self,
        name: str,
        pod: PodSpec,
        tasks: Optional[List[str]],
        backoff: Optional[Backoff],
        policy: ElasticPolicy,
        maintenance_probe: Optional[Callable[[], bool]] = None,
        journal=None,
    ):
        self._full_pod = pod
        self._tasks = list(tasks) if tasks is not None else None
        self._policy = policy
        self._maintenance_probe = maintenance_probe or (lambda: False)
        self.journal = journal
        self.target_hosts = pod.count
        self._declines = 0
        super().__init__(
            name,
            PodInstanceRequirement(
                pod=pod,
                instances=list(range(pod.count)),
                recovery_type=RecoveryType.PERMANENT,
                tasks_to_launch=list(self._tasks or []),
            ),
            backoff=backoff,
        )

    def update_offer_status(self, launched: bool) -> None:
        with self._lock:
            if launched:
                self._declines = 0
                return
            self._declines += 1
            # a multi-slice gang resizes in whole-slice steps: the
            # quantum pins valid widths to multiples of hosts-per-slice
            quantum = 1
            gpu = self._full_pod.gpu
            if gpu is not None and gpu.slices > 1:
                quantum = max(1, self._full_pod.count // gpu.slices)
            decision = decide_resize(
                self.target_hosts,
                self._full_pod.count,
                self._declines,
                self._policy,
                self._maintenance_probe(),
                host_quantum=quantum,
            )
            if decision.target_hosts >= self.target_hosts:
                return
            pod = shrunken_pod(self._full_pod, decision.target_hosts)
            if pod is None:
                return  # topology cannot scale to that size: keep waiting
            self._rescope_locked(pod, decision)

    def _rescope_locked(self, pod: PodSpec, decision: ResizeDecision) -> None:
        self.target_hosts = pod.count
        self._declines = 0
        self.requirement = PodInstanceRequirement(
            pod=pod,
            instances=list(range(pod.count)),
            recovery_type=RecoveryType.PERMANENT,
            tasks_to_launch=list(self._tasks or []),
        )
        # the status-routing map must match the new scope, or a
        # surplus instance's stale status could move this step
        self._spec_by_full = {
            task_full_name(pod.type, i, spec.name): spec
            for i in self.requirement.instances
            for spec in pod.tasks
            if spec.name in self.requirement.tasks_to_launch
        }
        self._expected = {}
        self._task_states = {}
        self._task_ready = {}
        if self.journal is not None:
            self.journal.append(
                "recovery",
                pod=pod.type,
                verb="elastic-shrink",
                hosts=pod.count,
                full=self._full_pod.count,
                topology=pod.gpu.topology if pod.gpu else "",
                slices=pod.gpu.slices if pod.gpu else 1,
                message=(
                    f"elastic re-slice: {decision.reason} "
                    f"(topology {pod.gpu.topology if pod.gpu else 'n/a'}"
                    + (
                        f" x {pod.gpu.slices} slice(s)"
                        if pod.gpu and pod.gpu.slices > 1 else ""
                    )
                    + ")"
                ),
            )

    def surplus_instances(self) -> List[int]:
        """Instances of the FULL gang the current scope dropped — the
        trim step erases their task state after the narrow gang is
        running."""
        with self._lock:
            return list(range(self.target_hosts, self._full_pod.count))

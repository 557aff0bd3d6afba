"""Deterministic scheduler re-hydration: plan checkpoints + WAL replay.

Reference: the reference's ``SchedulerRestartServiceTest`` pattern —
kill the scheduler anywhere, restart it anywhere, and the plans
resume mid-step because every decision was persisted before it was
acted on.  Most of that already holds here (the launch WAL, the
reservation ledger, ``DeployPlanFactory.seed_step_from_state``, the
startup ``Reconciler``); this module closes the two gaps a failover
harness actually trips:

* **Plan-state checkpoints** — operator verbs (interrupt, proceed,
  force-complete, a started sidecar plan) live only in scheduler
  memory; a restart used to silently resume an interrupted rollout.
  ``PlanCheckpointer`` persists each plan's interrupt flags and
  step statuses as a state-store property whenever they change, and
  ``restore_plans`` replays them into the freshly-rebuilt plan tree —
  never regressing a COMPLETE step (the no-step-regression chaos
  invariant is enforced here by construction).
* **The WAL-replay report** — re-hydration classifies every stored
  launch against agent reality: *adopted* (the task is alive; keep
  it), *re-issued* (WAL'd but the launch never reached an agent — the
  crash landed between WAL and launch; the synthesized LOST status
  sends the step back through evaluation, which relaunches in place
  on the already-committed reservations), *lost* (launched but died
  unobserved; recovery owns it), plus orphan and double-reservation
  scans.  The report is exported at ``GET /v1/debug/ha`` and asserted
  per kill-point by the chaos harness.

Cold start and failover are the same code path: the scheduler runs
this once, inside its first ``run_cycle``, whoever built it and for
whatever reason.

Port of ``dcos_commons_tpu/ha/rehydrate.py``, line for line but the imports.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Callable, Dict, List, Optional

from dcos_commons_tpu_torch.plan.plan import Plan
from dcos_commons_tpu_torch.plan.status import Status

PLAN_CKPT_PREFIX = "plan-checkpoint-"


@dataclass
class RehydrationReport:
    """What one re-hydration pass found and did."""

    adopted: int = 0            # stored live tasks the agent confirms
    reissued: int = 0           # WAL'd, never launched -> re-driven
    lost: int = 0               # launched, died unobserved -> recovery
    orphans: int = 0            # agent tasks no store owns (swept)
    restored_plans: int = 0     # plans a checkpoint re-shaped
    restored_steps: int = 0     # force-completes/interrupts re-applied
    double_reservations: int = 0  # chip claimed by >1 reservation
    notes: List[str] = field(default_factory=list)

    def to_dict(self) -> dict:
        return asdict(self)


# -- plan-state checkpoints -------------------------------------------


def _raw_status(step) -> Status:
    """The step's stored status, bypassing interrupt/delay overlays
    (an interrupted PENDING step must checkpoint as PENDING+interrupted,
    not WAITING — restore re-applies the overlay separately)."""
    getter = getattr(step, "get_raw_status", None)
    if callable(getter):
        return getter()
    return step.get_status()


def serialize_plan_state(plan: Plan) -> dict:
    return {
        "interrupted": plan.is_interrupted(),
        "phases": {
            phase.name: {
                "interrupted": phase.is_interrupted(),
                "steps": {
                    step.name: {
                        "status": _raw_status(step).value,
                        "interrupted": step.is_interrupted(),
                    }
                    for step in phase.steps
                },
            }
            for phase in plan.phases
        },
    }


class PlanCheckpointer:
    """Persist plan runtime state (interrupts, step statuses) so a
    restarted scheduler resumes at the exact state the operator left.

    One property per plan (namespaced, so multi-service schedulers
    checkpoint independently); writes only on change (the scheduler
    calls this every dirty cycle).  ``chaos`` is the harness's kill
    hook: a crash between the write and the prune — or between two
    plans' writes — must leave a tree ``restore_plans`` tolerates,
    and the chaos tier proves it does.
    """

    def __init__(self, state_store):
        self._state_store = state_store
        self._last: Dict[str, str] = {}
        # plan-name set the last prune ran against: the stale scan is
        # a store enumeration (a remote round trip), and the set only
        # changes at scheduler (re)build — not per dirty cycle
        self._pruned_for: Optional[frozenset] = None

    def checkpoint(
        self,
        plans: Dict[str, Plan],
        chaos: Optional[Callable[[str], None]] = None,
    ) -> int:
        writes = 0
        for name in sorted(plans):
            payload = json.dumps(
                serialize_plan_state(plans[name]), sort_keys=True
            )
            if self._last.get(name) == payload:
                continue
            self._state_store.store_property(
                PLAN_CKPT_PREFIX + name, payload.encode("utf-8")
            )
            self._last[name] = payload
            writes += 1
            if chaos is not None:
                chaos("mid-checkpoint-prune")
        # prune checkpoints of plans that no longer exist (a completed
        # decommission plan, deploy renamed to update across a restart)
        # — only when the plan-name set changed since the last prune:
        # the scan enumerates store keys, which crosses the network on
        # remote state
        names = frozenset(plans)
        if names == self._pruned_for:
            return writes
        for key in self._state_store.fetch_property_keys():
            if not key.startswith(PLAN_CKPT_PREFIX):
                continue
            if key[len(PLAN_CKPT_PREFIX):] in plans:
                continue
            self._state_store.clear_property(key)
            self._last.pop(key[len(PLAN_CKPT_PREFIX):], None)
            writes += 1
            if chaos is not None:
                chaos("mid-checkpoint-prune")
        self._pruned_for = names
        return writes


def restore_plans(
    state_store, plans: Dict[str, Plan], report: RehydrationReport
) -> None:
    """Replay persisted plan checkpoints into freshly-built plans.

    Only the state the task-status replay cannot reconstruct is
    applied: interrupt flags at every level, and force-completed steps
    (checkpoint COMPLETE, rebuilt not complete).  A COMPLETE rebuilt
    step is NEVER regressed, whatever the checkpoint says — the
    checkpoint may predate the statuses that completed it."""
    for name, plan in plans.items():
        raw = state_store.fetch_property(PLAN_CKPT_PREFIX + name)
        if raw is None:
            continue
        try:
            data = json.loads(raw.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            report.notes.append(f"unreadable checkpoint for plan {name}")
            continue
        touched = False
        if bool(data.get("interrupted")) != plan.is_interrupted():
            (plan.interrupt if data.get("interrupted")
             else plan.proceed)()
            touched = True
        for phase in plan.phases:
            ckpt_phase = (data.get("phases") or {}).get(phase.name)
            if ckpt_phase is None:
                continue  # new phase this checkpoint never saw
            if bool(ckpt_phase.get("interrupted")) != phase.is_interrupted():
                (phase.interrupt if ckpt_phase.get("interrupted")
                 else phase.proceed)()
                touched = True
            for step in phase.steps:
                ckpt_step = (ckpt_phase.get("steps") or {}).get(step.name)
                if ckpt_step is None:
                    continue
                if bool(ckpt_step.get("interrupted")) != \
                        step.is_interrupted():
                    (step.interrupt if ckpt_step.get("interrupted")
                     else step.proceed)()
                    report.restored_steps += 1
                    touched = True
                if ckpt_step.get("status") == Status.COMPLETE.value and \
                        not _raw_status(step).is_complete:
                    # a force-complete (or completed work whose statuses
                    # were since cleared) — resume at the exact status
                    step.force_complete()
                    report.restored_steps += 1
                    touched = True
        if touched:
            report.restored_plans += 1


# -- ledger consistency -----------------------------------------------


def scan_double_reservations(ledger, report: RehydrationReport) -> None:
    """A chip claimed by two live reservations is the split-brain
    outcome fencing exists to prevent; re-hydration proves its absence
    on every takeover (and the chaos harness asserts the count is 0)."""
    claimed: Dict[tuple, str] = {}
    for reservation in ledger.all():
        for chip in reservation.chip_ids:
            key = (reservation.host_id, chip)
            prior = claimed.get(key)
            if prior is not None and prior != reservation.reservation_id:
                report.double_reservations += 1
                report.notes.append(
                    f"chip {chip} on {reservation.host_id} claimed by "
                    f"reservations {prior} and {reservation.reservation_id}"
                )
            else:
                claimed[key] = reservation.reservation_id

"""UninstallScheduler: the event loop that tears the service down.

Reference: scheduler/uninstall/UninstallScheduler.java +
UninstallPlanFactory.java — selected by SchedulerBuilder when
SDK_UNINSTALL is set (SchedulerBuilder.java:331+); drives a plan of
kill -> unreserve -> deregister phases, then wipes all persisted
state.  A restart after completion rebuilds over empty state: every
phase is trivially complete, which IS the reference's "skeleton
scheduler" (FrameworkRunner.java:99-115,214-238) — the API serves a
COMPLETE deploy/uninstall plan so the package manager can finish.

Port of ``dcos_commons_tpu/uninstall/scheduler.py``, line for line but the imports.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, Optional

from dcos_commons_tpu_torch.common import task_name_of
from dcos_commons_tpu_torch.debug.trackers import OfferOutcomeTracker
from dcos_commons_tpu_torch.metrics.registry import Metrics
from dcos_commons_tpu_torch.plan.coordinator import DefaultPlanCoordinator
from dcos_commons_tpu_torch.plan.phase import Phase
from dcos_commons_tpu_torch.plan.plan import Plan
from dcos_commons_tpu_torch.plan.plan_manager import DefaultPlanManager
from dcos_commons_tpu_torch.plan.step import ActionStep
from dcos_commons_tpu_torch.plan.strategy import SerialStrategy
from dcos_commons_tpu_torch.runtime.reconciler import Reconciler
from dcos_commons_tpu_torch.runtime.task_killer import TaskKiller

LOG = logging.getLogger(__name__)

UNINSTALL_PLAN_NAME = "uninstall"


class UninstallPlanFactory:
    def build(self, state_store, ledger) -> Plan:
        def kill_all(scheduler) -> bool:
            """Kill every known task; done when all are terminal and
            the agent reports nothing alive."""
            all_done = True
            for name, status in scheduler.state_store.fetch_statuses().items():
                if status.state.is_terminal:
                    continue
                scheduler.task_killer.kill(status.task_id)
                all_done = False
            # tasks the agent knows but the store lost (torn WAL, old
            # runs) die too — but ONLY in a standalone (whole-framework)
            # uninstall.  A namespaced multi-service removal sees the
            # SHARED agent's task set and must never touch ids other
            # services own (reference: single-service removal tears
            # down only that client's tasks, MultiServiceEventClient).
            owned = {
                info.task_id for info in scheduler.state_store.fetch_tasks()
            }
            for task_id in scheduler.agent.active_task_ids():
                if not scheduler._deregister and task_id not in owned:
                    continue
                scheduler.task_killer.kill(task_id)
                all_done = False
            return all_done

        def unreserve_all(scheduler) -> bool:
            """ResourceCleanupStep: release every ledger claim."""
            for reservation in scheduler.ledger.all():
                scheduler.ledger.release(reservation.reservation_id)
                scheduler.metrics.incr("operations.unreserve")
            return True

        def deregister(scheduler) -> bool:
            """DeregisterStep: drop the framework identity and wipe all
            persisted state (reference: FrameworkID cleared + ZK wiped,
            FrameworkRunner.java:147-155, PersisterUtils.clearAllData)."""
            if scheduler._deregister and scheduler.framework_store is not None:
                scheduler.framework_store.clear_framework_id()
            scheduler.wipe_state()
            return True

        return Plan(
            UNINSTALL_PLAN_NAME,
            [
                Phase("kill-tasks", [ActionStep("kill-all-tasks", kill_all)],
                      SerialStrategy()),
                Phase("unreserve-resources",
                      [ActionStep("unreserve-all", unreserve_all)],
                      SerialStrategy()),
                Phase("deregister", [ActionStep("deregister", deregister)],
                      SerialStrategy()),
            ],
            SerialStrategy(),
        )


class UninstallScheduler:
    """Duck-type compatible with DefaultScheduler for the HTTP API and
    sim harness (plans()/plan()/run_cycle()/stores)."""

    def __init__(
        self,
        spec,
        state_store,
        ledger,
        inventory,
        agent,
        persister,
        config_store=None,
        framework_store=None,
        metrics: Optional[Metrics] = None,
        namespace: str = "",
        deregister: bool = True,
    ):
        # multi-service removal tears down ONE namespaced service: it
        # wipes only its subtree and must not drop the shared framework
        # identity (reference: MultiServiceEventClient uninstall-and-
        # remove flow vs whole-framework uninstall)
        self._namespace = namespace
        self._deregister = deregister
        self.spec = spec
        self.state_store = state_store
        self.ledger = ledger
        self.inventory = inventory
        self.agent = agent
        self.persister = persister
        self.config_store = config_store
        self.framework_store = framework_store
        self.metrics = metrics or Metrics()
        self.outcome_tracker = OfferOutcomeTracker()
        self.task_killer = TaskKiller(agent)
        self.reconciler = Reconciler(state_store, agent)
        plan = UninstallPlanFactory().build(state_store, ledger)
        self.uninstall_manager = DefaultPlanManager(plan)
        # deploy_manager alias: /v1/health and tooling ask whether
        # "deployment" finished; during uninstall that IS the teardown
        self.deploy_manager = self.uninstall_manager
        self.coordinator = DefaultPlanCoordinator([self.uninstall_manager])
        self._stop = threading.Event()
        self._lock = threading.RLock()
        self._wiped = False

    # -- loop ---------------------------------------------------------

    def run_cycle(self) -> None:
        with self._lock:
            for status in self.agent.poll():
                self._process_status(status)
            if not self.reconciler.is_reconciled:
                # stale RUNNING statuses for tasks the agent lost would
                # wedge kill_all forever: synthesize LOST for them, as
                # the deploy scheduler does (runtime/reconciler.py)
                for status in self.reconciler.reconcile():
                    self._process_status(status)
            for step in self.coordinator.get_candidates():
                if isinstance(step, ActionStep):
                    step.execute(self)
            self.task_killer.retry_pending()

    def run_forever(self, interval_s: float = 0.5) -> threading.Thread:
        def loop():
            while not self._stop.is_set():
                try:
                    self.run_cycle()
                except Exception:
                    LOG.exception("uninstall cycle failed")
                self._stop.wait(interval_s)

        thread = threading.Thread(
            target=loop, name="uninstall-loop", daemon=True
        )
        thread.start()
        return thread

    def stop(self) -> None:
        self._stop.set()

    def _process_status(self, status) -> None:
        if self._wiped:
            return  # post-wipe stragglers have nowhere to go
        try:
            task_name = task_name_of(status.task_id)
        except ValueError:
            return
        self.state_store.store_status(task_name, status)
        self.task_killer.handle_status(status)
        for manager in self.coordinator.plan_managers:
            manager.update(status)

    def wipe_state(self) -> None:
        """Delete every persisted node of this service (the whole tree
        for a standalone service, only the namespace subtree in
        multi-service mode)."""
        from dcos_commons_tpu_torch.storage.persister import wipe_namespace

        wipe_namespace(self.persister, self._namespace)
        self._wiped = True

    # -- API surface --------------------------------------------------

    @property
    def is_complete(self) -> bool:
        return self.uninstall_manager.get_plan().is_complete

    def plans(self) -> Dict[str, Plan]:
        plan = self.uninstall_manager.get_plan()
        # serve the teardown under both names: Cosmos-equivalent
        # tooling polls "deploy" for completion (reference skeleton
        # scheduler serves an empty COMPLETE deploy plan)
        return {UNINSTALL_PLAN_NAME: plan, "deploy": plan}

    def plan(self, name: str) -> Optional[Plan]:
        return self.plans().get(name)

    def restart_pod(self, pod_type: str, index: int, replace: bool = False):
        return []  # no pod verbs during uninstall

    def pause_pod(self, pod_type, index, tasks=None):
        return []

    def resume_pod(self, pod_type, index, tasks=None):
        return []

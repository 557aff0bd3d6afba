"""DefaultScheduler: the event loop tying every layer together.

Reference: scheduler/DefaultScheduler.java:81 + framework/
OfferProcessor.java — one cycle of ``run_cycle()`` corresponds to one
pass of the reference's offer thread (OfferProcessor.java:294-418):

    status intake  (statusUpdate fan-in,    DefaultScheduler.java:541-568)
    reconcile gate (AbstractScheduler.java:163-184)
    plan candidates -> evaluate -> WAL -> launch
                   (PlanScheduler.java:50-100 -> OfferEvaluator ->
                    PersistentLaunchRecorder, DefaultScheduler.java:423-470)
    reservation GC (unexpected resources,   DefaultScheduler.java:483-538)
    kill retries   (TaskKiller)

The loop is synchronous and steppable — the sim harness and tests call
run_cycle() directly (the reference's sim harness scripts ticks the
same way); ``run_forever`` wraps it in a thread for production.

Port of ``dcos_commons_tpu/scheduler/scheduler.py``, line for line but the imports.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional, Set

from dcos_commons_tpu_torch.agent.base import Agent
from dcos_commons_tpu_torch.common import Label, TaskStatus, task_name_of
from dcos_commons_tpu_torch.debug.trackers import OfferOutcomeTracker
from dcos_commons_tpu_torch.metrics.registry import Metrics
from dcos_commons_tpu_torch.offer.evaluate import EvaluationContext, OfferEvaluator
from dcos_commons_tpu_torch.offer.inventory import SliceInventory
from dcos_commons_tpu_torch.offer.ledger import ReservationLedger
from dcos_commons_tpu_torch.plan.coordinator import DefaultPlanCoordinator
from dcos_commons_tpu_torch.plan.plan import Plan
from dcos_commons_tpu_torch.plan.plan_manager import DefaultPlanManager, PlanManager
from dcos_commons_tpu_torch.plan.step import ActionStep, DeploymentStep
from dcos_commons_tpu_torch.recovery.manager import DefaultRecoveryPlanManager
from dcos_commons_tpu_torch.runtime.reconciler import Reconciler
from dcos_commons_tpu_torch.runtime.task_killer import TaskKiller
from dcos_commons_tpu_torch.runtime.token_bucket import TokenBucket
from dcos_commons_tpu_torch.specification.specs import ServiceSpec, task_full_name
from dcos_commons_tpu_torch.state.launch_recorder import PersistentLaunchRecorder
from dcos_commons_tpu_torch.state.state_store import (
    GoalStateOverride,
    OverrideProgress,
    StateStore,
)
from dcos_commons_tpu_torch.trace.recorder import TraceRecorder

LOG = logging.getLogger(__name__)


class DefaultScheduler:
    def __init__(
        self,
        spec: ServiceSpec,
        state_store: StateStore,
        ledger: ReservationLedger,
        inventory: SliceInventory,
        agent: Agent,
        evaluator: OfferEvaluator,
        deploy_manager: DefaultPlanManager,
        recovery_manager: DefaultRecoveryPlanManager,
        other_managers: Optional[List[PlanManager]] = None,
        metrics: Optional[Metrics] = None,
        outcome_tracker: Optional[OfferOutcomeTracker] = None,
        config_store=None,
        framework_store=None,
        kill_orphaned_tasks: bool = True,
        revive_bucket: Optional[TokenBucket] = None,
        tracer: Optional[TraceRecorder] = None,
        journal=None,
        health_monitor=None,
        action_policy=None,
    ):
        # stores surfaced to the HTTP API (/v1/configs, /v1/state);
        # None when the scheduler is wired by hand in unit tests
        self.config_store = config_store
        self.framework_store = framework_store
        self.spec = spec
        self.state_store = state_store
        self.ledger = ledger
        self.inventory = inventory
        self.agent = agent
        self.evaluator = evaluator
        self.deploy_manager = deploy_manager
        self.recovery_manager = recovery_manager
        self.other_managers = list(other_managers or [])
        self.metrics = metrics or Metrics()
        self.outcome_tracker = outcome_tracker or OfferOutcomeTracker()
        # traceview: the bounded flight recorder every layer of one
        # offer cycle records into (trace/recorder.py).  One
        # correlation id is minted per cycle; launches register their
        # span so later status arrivals and the plan-step transitions
        # they trigger join the chain.  Surfaced at /v1/debug/trace.
        self.tracer = tracer or TraceRecorder()
        if self.tracer.metrics is None:
            self.tracer.metrics = self.metrics
        self.tracer.service = self.tracer.service or spec.name
        # correlation context of the in-flight status/launch: set under
        # _lock by the cycle's thread, tagged with that thread's id so
        # a step verb arriving on an HTTP thread (step.restart() is
        # lock-free) can never borrow an unrelated status's anchor
        self._trace_ctx: Optional[tuple] = None  # (thread_id, trace, span)
        # HA (dcos_commons_tpu_torch/ha/): crash-injection hook for the chaos
        # harness — callable(kind) invoked at every span-boundary kind
        # (post-evaluate, post-wal, mid-status-fan-in,
        # mid-plan-transition, mid-checkpoint-prune); None in
        # production.  ha_state (election.HAState) is attached by the
        # builder/runner when a leader lease is wired; last_rehydration
        # is the first cycle's WAL-replay report.
        self.chaos = None
        self.ha_state = None
        self.last_rehydration = None
        # health plane (dcos_commons_tpu_torch/health/): the durable event
        # journal (operator verbs, plan transitions, failovers,
        # recovery, detector alerts — persisted through the state
        # store, so HA mode fences and replays it) and the per-cycle
        # monitor (metric history sampling + anomaly detectors).
        # Surfaced at /v1/debug/health and /v1/debug/events.
        from dcos_commons_tpu_torch.health import (
            EventJournal,
            HealthMonitor,
            StatePropertyBackend,
        )

        if journal is None:
            # adopt the monitor's journal when it brought a real (or
            # deliberately disabled) one; default to a store-backed
            # journal otherwise
            if health_monitor is not None and (
                health_monitor.journal._backend is not None
                or not health_monitor.journal.enabled
            ):
                journal = health_monitor.journal
            else:
                journal = EventJournal(StatePropertyBackend(state_store))
        self.journal = journal
        self.health = health_monitor or HealthMonitor(journal=journal)
        self.health.journal = journal
        self.health.attach(self)
        # recovery phases journal their creation (the recovery plan
        # prunes completed phases; the journal remembers them)
        recovery_manager.journal = journal
        from dcos_commons_tpu_torch.ha.rehydrate import PlanCheckpointer

        self._plan_checkpointer = PlanCheckpointer(state_store)
        # set by nudge()/step transitions; checkpointing skips clean
        # cycles so idle heartbeats never serialize the plan tree
        self._plan_dirty = True
        self._transition_seq = 0
        # the closed health->action loop (health/actions.py): the
        # engine's dynamic `autoscale` plan joins the coordinator so
        # automated scale-out/scale-in phases ride the ordinary
        # candidate -> evaluate -> WAL -> launch machinery, are
        # operator-interruptible via the plan verbs, and are
        # checkpointed/restored across failover like every plan.
        # Policy defaults OFF; the engine still settles/reseeds
        # journal-latched actions so a disabled successor never
        # forgets a predecessor's in-flight plan.
        from dcos_commons_tpu_torch.health.actions import HealthActionEngine

        self.actions = HealthActionEngine(policy=action_policy)
        self.other_managers.append(self.actions.manager)
        # an instance an in-flight scale action owns is the SCALE
        # phase's to drive (incl. retrying a failed scale-out
        # launch) — recovery must defer exactly as it defers to an
        # incomplete deploy step, or the two plans would trade
        # launches for the same task names
        recovery_manager.add_externally_managed(
            self._scale_managed_instance
        )
        # deploy before recovery: rollout owns incomplete pods, and the
        # recovery manager defers to them via externally_managed
        self.coordinator = DefaultPlanCoordinator(
            [deploy_manager, recovery_manager, *self.other_managers]
        )
        self.launch_recorder = PersistentLaunchRecorder(
            state_store, tracer=self.tracer
        )
        self.task_killer = TaskKiller(agent)
        self.reconciler = Reconciler(state_store, agent)
        # standalone mode sweeps agent tasks the store doesn't own
        # (lost-kill safety net); in multi-service mode the agent view
        # is SHARED, so the MultiServiceScheduler does a merged sweep
        # instead and this is disabled per service
        self.kill_orphaned_tasks = kill_orphaned_tasks
        # revive throttling: a flapping work-set (task crash-looping
        # between suppress and revive) may not hammer the inventory
        # scan every cycle (reference: rate-limited ReviveManager,
        # framework/ReviveManager.java + TokenBucket.java).  Fallback
        # tuning comes from SchedulerConfig so there is one source of
        # truth for the defaults.
        if revive_bucket is None:
            from dcos_commons_tpu_torch.scheduler.config import SchedulerConfig

            defaults = SchedulerConfig()
            revive_bucket = TokenBucket(
                capacity=defaults.revive_capacity,
                refill_interval_s=defaults.revive_refill_s,
            )
        self.revive_bucket = revive_bucket
        # base URL of this scheduler's own API server, set by the serve
        # runner; when present agents pull config templates from
        # /v1/artifacts over HTTP (the reference bootstrap flow,
        # sdk/bootstrap/main.go:291-376); when absent (in-process
        # tests/bench) template content ships inline with the launch
        self.artifact_base: Optional[str] = None
        # security plane (X2): resolves pod secret refs at launch and
        # issues per-task TLS PEMs; values ride ONLY the launch channel
        # (never the state store or artifact URLs).  Set by the builder
        # (reference: SecretsClient + CertificateAuthorityClient)
        self.secrets_provider = None
        self.certificate_authority = None
        self._suppressed = False
        # pending-nudge flag consumed by the multi-service offer
        # discipline: a suppressed (skipped) service is revived when a
        # nudge fired since its last cycle (status arrival, HTTP verb)
        self._nudged = False
        self._fatal_error: Optional[str] = None
        self._stop = threading.Event()
        # event-driven wake-up (offer-cycle fast path): status arrival
        # and HTTP mutations set this, so run_forever cycles at event
        # speed and the interval is only a fallback heartbeat
        self._wake = threading.Event()
        self._lock = threading.RLock()
        # snapshot-cache observability, surfaced through the existing
        # /v1 metrics routes (gauges ride the Metrics snapshot)
        self.metrics.gauge(
            "offers.snapshot_cache.hit",
            lambda: float(getattr(inventory, "cache_hits", 0)),
        )
        self.metrics.gauge(
            "offers.snapshot_cache.miss",
            lambda: float(getattr(inventory, "cache_misses", 0)),
        )
        # dirty-host incremental evaluation: how many hosts the last
        # snapshot sync actually re-synthesized (0 on a quiet fleet)
        self.metrics.gauge(
            "offers.dirty_hosts",
            lambda: float(getattr(inventory, "last_dirty_hosts", 0)),
        )
        self.evaluator.metrics = self.metrics
        self.evaluator.tracer = self.tracer
        self._wire_step_tracing()
        # agents that learn of statuses asynchronously (readiness
        # monitors, test fixtures) nudge the loop instead of waiting
        # out the heartbeat
        add_listener = getattr(agent, "add_status_listener", None)
        if callable(add_listener):
            add_listener(self.nudge)

    # -- the loop -----------------------------------------------------

    def run_cycle(self, allow_footprint_growth: bool = True) -> None:
        """One pass of the event loop.  ``allow_footprint_growth=False``
        is the multi-service offer discipline: status intake, kills, GC
        and in-place relaunches proceed, but no NEW reservations are
        taken (reference: OfferDiscipline/ParallelFootprintDiscipline,
        scheduler/multi/OfferDiscipline.java:11-33)."""
        with self._lock, self.metrics.time("cycle.process"):
            # the reference's offers.process timer (Metrics.java:33):
            # scale tests fence on this staying bounded as the fleet
            # and service count grow.  The cycle span mints THE
            # correlation id: everything this cycle causes (evaluation,
            # WAL, launch — and, via the launch registry, the statuses
            # and step transitions that arrive in later cycles) shares
            # its trace id.
            with self.tracer.span("cycle", track="scheduler") as cycle:
                # recovery steps are created dynamically: (re)attach
                # the transition listener before statuses route
                self._wire_step_tracing()
                n_statuses = self._intake_statuses(cycle)
                if not self.reconciler.is_reconciled:
                    # first cycle of this scheduler incarnation: full
                    # re-hydration (plan-checkpoint restore + WAL
                    # replay against agent reality).  Cold start and
                    # failover take the same path — the only
                    # difference is what the replay finds.
                    n_statuses += self._rehydrate_locked(cycle)
                    self.metrics.incr("reconciles")
                n_candidates = self._process_candidates(
                    allow_footprint_growth, parent=cycle
                )
                self._gc_reservations()
                if self.kill_orphaned_tasks:
                    self._kill_orphans()
                self.task_killer.retry_pending()
                # first full deployment done: scheduler restarts now
                # build an *update* plan (reference: StateStoreUtils
                # deployment-completed bit read by selectDeployPlan)
                if not self.state_store.deployment_was_completed() and \
                        self.deploy_manager.get_plan().is_complete:
                    self.state_store.set_deployment_completed()
                if self._plan_dirty:
                    # persist plan runtime state (interrupts, step
                    # statuses) so a successor resumes at the exact
                    # state the operator left — the failover contract.
                    # Cleared BEFORE serializing (a racing flip costs
                    # one extra checkpoint, never a lost one) but
                    # restored on failure: a transient store error
                    # must not silently drop an operator verb's
                    # checkpoint until the next plan transition.
                    self._plan_dirty = False
                    try:
                        self._plan_checkpointer.checkpoint(
                            self.plans(), chaos=self._chaos_point
                        )
                    except BaseException:
                        self._plan_dirty = True
                        raise
                # health plane: metric-history sampling + detectors +
                # journal flush, time-throttled internally.  Runs on
                # idle heartbeats too — a serving pod burns its TTFT
                # SLO precisely while the control plane has nothing
                # to do.  Never raises (counted in observe_errors).
                self.health.observe(self)
                cycle.set_attr("statuses", n_statuses)
                cycle.set_attr("candidates", n_candidates)
                if n_statuses == 0 and n_candidates == 0:
                    # idle heartbeat: keep the bounded flight recorder
                    # for cycles that did work (busy-polls at 0.05s
                    # would otherwise evict every interesting trace)
                    cycle.drop()

    def run_forever(
        self,
        interval_s: float = 0.5,
        max_consecutive_failures: int = 5,
        busy_poll_s: float = 0.05,
    ) -> threading.Thread:
        """A transient cycle failure is logged and retried; after
        ``max_consecutive_failures`` in a row the loop declares itself
        wedged, records ``fatal_error`` and stops, so the serving
        process can exit and be restarted by its supervisor (reference:
        deliberate crash-to-restart on deadlock, SchedulerConfig.java
        DISABLE_DEADLOCK_EXIT semantics — exit is the default).

        The wait between cycles is event-driven: ``nudge()`` (status
        arrival, HTTP mutations) wakes the loop immediately, and while
        launched work awaits its statuses the wait shortens to
        ``busy_poll_s`` (poll-only agents surface transitions only
        inside a cycle).  ``interval_s`` is the idle fallback
        heartbeat, so an N-step deploy no longer pays N x interval_s
        of pure sleep."""
        def loop():
            failures = 0
            while not self._stop.is_set():
                self._wake.clear()
                try:
                    self.run_cycle()
                    failures = 0
                except Exception as exc:
                    failures += 1
                    LOG.exception(
                        "scheduler cycle failed (%d consecutive)", failures
                    )
                    if failures >= max_consecutive_failures:
                        self._fatal_error = repr(exc)
                        LOG.critical(
                            "scheduler wedged after %d consecutive cycle "
                            "failures; stopping loop for supervised restart",
                            failures,
                        )
                        self._stop.set()
                        break
                timeout = interval_s
                if self._work_in_flight():
                    timeout = min(interval_s, busy_poll_s)
                with self.metrics.time("cycle.wait"):
                    self._wake.wait(timeout)

        thread = threading.Thread(target=loop, name="scheduler-loop", daemon=True)
        thread.start()
        return thread

    def nudge(self) -> None:
        """Wake run_forever for an immediate cycle (status arrival,
        plan work made pending, HTTP mutation).  Safe from any thread;
        a nudge during a cycle makes the next wait return at once."""
        self.metrics.incr("cycle.nudges")
        # anything worth waking for may have changed plan state (HTTP
        # plan verbs mutate plan objects directly): re-checkpoint on
        # the next cycle.  Monotonic bool flip from any thread; the
        # cycle clears it BEFORE serializing, so a racing flip only
        # costs one extra checkpoint, never a lost one.
        # racecheck: handoff=monotonic dirty flip; cycle clears before serializing, a racing flip costs one extra checkpoint, never a lost one
        self._plan_dirty = True  # sdklint: disable=lock-discipline — see above
        self._nudged = True  # sdklint: disable=lock-discipline — same monotonic-flip contract
        self._wake.set()

    def take_nudge(self) -> bool:
        """Consume the pending-nudge flag (multi-service offer
        discipline): True when nudge() fired since the last consume.
        Monotonic bool flip; a racing nudge after the read costs one
        extra revive cycle, never a lost wake."""
        if self._nudged:
            self._nudged = False  # sdklint: disable=lock-discipline — see nudge()
            return True
        return False

    def work_pending(self) -> bool:
        """True while this service could need an offer cycle: pending/
        in-flight plan work, unfinished reconciliation, or unacked
        kills.  False = the service may be SUPPRESSED (skipped
        entirely by MultiServiceScheduler.run_cycle) until a status or
        nudge revives it — the reference's suppress/revive semantics
        (framework/ReviveManager.java), now load-bearing at fleet
        scale.  DELAYED (backoff) steps keep a plan incomplete, so a
        service waiting out a crash-loop backoff is never suppressed
        (backoff expiry is time-, not event-, driven)."""
        return (
            not self.reconciler.is_reconciled
            or bool(self.task_killer.pending_ids())
            or self.coordinator.has_work()
        )

    def _chaos_point(self, kind: str) -> None:
        """Crash-injection hook: the chaos harness installs a callable
        that raises at a chosen span-boundary kind, simulating a
        scheduler death at exactly that point.  No-op in production."""
        if self.chaos is not None:
            self.chaos(kind)

    # -- re-hydration (dcos_commons_tpu_torch/ha/rehydrate.py) --------------

    def _rehydrate_locked(self, cycle) -> int:
        """First cycle of this incarnation: restore plan checkpoints
        (operator interrupts / force-completes), then replay the
        launch WAL against agent reality — adopt live tasks, re-issue
        launches the crash lost, hand unobserved deaths to recovery —
        and record it all as one ``rehydrate.replay`` span chained to
        the election.promote that created this incarnation (when one
        did).  Returns the number of synthesized statuses routed."""
        from dcos_commons_tpu_torch.common import TaskState
        from dcos_commons_tpu_torch.ha import rehydrate as _rehydrate

        promote_ref = (
            self.ha_state.lease.promote_ref
            if self.ha_state is not None and self.ha_state.lease is not None
            else None
        )
        kwargs = (
            {"trace_id": promote_ref[0], "parent_id": promote_ref[1]}
            if promote_ref is not None else {"parent": cycle}
        )
        # re-synthesize journal-latched in-flight health actions
        # BEFORE the checkpoint restore: their phases must exist for
        # restore_plans to re-apply operator interrupts onto them
        self.actions.seed(self)
        report = _rehydrate.RehydrationReport()
        with self.tracer.span(
            "rehydrate.replay", track="scheduler", **kwargs
        ) as span:
            _rehydrate.restore_plans(
                self.state_store, self.plans(), report
            )
            _rehydrate.scan_double_reservations(self.ledger, report)
            stored = self.state_store.fetch_statuses()
            stored_ids = {s.task_id for s in stored.values()}
            active = self.agent.active_task_ids()
            report.adopted = sum(
                1 for s in stored.values()
                if not s.state.is_terminal and s.task_id in active
            )
            report.orphans = len(active - stored_ids)
            n = 0
            for status in self.reconciler.reconcile():
                try:
                    prev = stored.get(task_name_of(status.task_id))
                except ValueError:
                    prev = None
                if prev is not None and prev.state is TaskState.STAGING:
                    # the WAL seed never progressed and no agent knows
                    # the task: the crash landed between WAL and
                    # launch.  The LOST status re-pends the step; the
                    # evaluator relaunches in place on the committed
                    # reservations.
                    report.reissued += 1
                else:
                    report.lost += 1
                self._process_status(status, parent=span)
                n += 1
            for attr in ("adopted", "reissued", "lost", "orphans",
                         "restored_plans", "restored_steps",
                         "double_reservations"):
                span.set_attr(attr, getattr(report, attr))
        self.last_rehydration = report.to_dict()
        if self.ha_state is not None:
            self.ha_state.note_rehydration(self.last_rehydration)
        for key in ("adopted", "reissued", "lost"):
            value = getattr(report, key)
            if value:
                self.metrics.incr(f"ha.rehydrate.{key}", value)
        # journal the incarnation boundary: a failover (promotion at a
        # new lease epoch) or a cold start, with the replay verdict —
        # the journal survives the takeover, so the successor's first
        # event explains what it inherited
        lease = self.ha_state.lease if self.ha_state is not None else None
        self.journal.append(
            "election" if lease is not None else "recovery",
            message=(
                f"rehydrated: adopted={report.adopted} "
                f"reissued={report.reissued} lost={report.lost} "
                f"orphans={report.orphans}"
            ),
            adopted=report.adopted,
            reissued=report.reissued,
            lost=report.lost,
            orphans=report.orphans,
            epoch=lease.epoch if lease is not None else None,
        )
        return n

    def _work_in_flight(self) -> bool:
        """True while any plan step holds launched-but-unconfirmed
        work (PREPARED/STARTING) — the statuses that complete it are
        only observable by polling the agent inside a cycle."""
        return any(
            manager.in_progress_assets()
            for manager in self.coordinator.plan_managers
        )

    @property
    def fatal_error(self) -> Optional[str]:
        """Non-None once run_forever gave up; surfaced via /v1/health
        and the serve entrypoint's exit code."""
        return self._fatal_error

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()  # release a loop parked in its fallback wait

    # -- status intake ------------------------------------------------

    def _intake_statuses(self, parent=None) -> int:
        n = 0
        for status in self.agent.poll():
            self._process_status(status, parent=parent)
            n += 1
        return n

    def _process_status(self, status: TaskStatus, parent=None) -> None:
        """Reference: DefaultScheduler.processStatusUpdate (:541-568)."""
        self.metrics.incr(f"task_status.{status.state.value}")
        try:
            task_name = task_name_of(status.task_id)
        except ValueError:
            LOG.warning("unparseable task id %s", status.task_id)
            return
        # status span, linked to its LAUNCH span via the task id so the
        # chain survives across cycles; an unknown launch (pre-restart
        # task, reconciled orphan) anchors to the current cycle instead
        ref = self.tracer.launch_ref(status.task_id)
        event = self.tracer.event(
            f"status:{status.state.value}",
            parent=None if ref else parent,
            trace_id=ref.trace_id if ref else 0,
            parent_id=ref.span_id if ref else 0,
            track=ref.track if ref else "scheduler",
            task=task_name,
            task_id=status.task_id,
            **({"message": status.message} if status.message else {}),
        )
        stored = self.state_store.store_status(task_name, status)
        if not stored:
            event.attrs["stale"] = "true"
            LOG.info("dropped stale status %s for %s",
                     status.state.value, task_name)
            return
        # chaos: status persisted but NOT yet routed to the plans — a
        # successor must converge from the stored status alone
        self._chaos_point("mid-status-fan-in")
        # a pause/resume override completes once the task relaunched
        # UNDER the override (progress IN_PROGRESS, set at launch time)
        # reaches RUNNING; a RUNNING from the pre-override task arrives
        # while progress is still PENDING and must not complete it
        # (reference: GoalStateOverride progress machine)
        if status.state.is_running:
            override, progress = self.state_store.fetch_goal_override(task_name)
            if progress is OverrideProgress.IN_PROGRESS:
                self.state_store.store_goal_override(
                    task_name, override, OverrideProgress.COMPLETE
                )
        self.task_killer.handle_status(status)
        # step transitions triggered by THIS status reference its
        # correlation id (the listener reads _trace_ctx)
        # racecheck: handoff=thread-id-stamped slot; _on_step_transition only honors a ctx whose get_ident matches its own, so a concurrent writer's value is ignored, worst case an unanchored span
        self._trace_ctx = (
            threading.get_ident(), event.trace_id, event.span_id
        )
        seq_before = self._transition_seq
        try:
            for manager in self.coordinator.plan_managers:
                manager.update(status)
        finally:
            self._trace_ctx = None
        if self._transition_seq != seq_before:
            # chaos: the status moved a plan step, but the cycle's
            # post-transition work (deployment-completed flip, plan
            # checkpoint) never ran — a successor must not re-run the
            # transitioned step
            self._chaos_point("mid-plan-transition")

    def _wire_step_tracing(self) -> None:
        """Attach the step-transition listener to every plan step that
        exists right now (recovery steps are created dynamically, so
        run_cycle re-wires each pass before routing statuses)."""
        for manager in self.coordinator.plan_managers:
            set_listener = getattr(manager, "set_transition_listener", None)
            if callable(set_listener):
                set_listener(self._on_step_transition)

    def _on_step_transition(self, step, old, new, status=None) -> None:
        """Record a plan-step state transition as an instantaneous
        span.  Anchored to the in-flight status/launch correlation when
        one is active AND this is the thread that set it; operator
        verbs firing from HTTP threads record unanchored (they were
        not caused by the status the cycle thread is processing)."""
        self._transition_seq += 1
        # same monotonic-flip contract as nudge(): operator verbs fire
        # transitions from HTTP threads without the scheduler lock
        self._plan_dirty = True  # sdklint: disable=lock-discipline — see nudge()
        ctx = self._trace_ctx
        if ctx is not None and ctx[0] == threading.get_ident():
            trace_id, parent_id = ctx[1], ctx[2]
        else:
            trace_id, parent_id = 0, 0
        self.tracer.event(
            f"step:{step.name}",
            trace_id=trace_id,
            parent_id=parent_id,
            track="plan",
            **{"from": old.value, "to": new.value},
        )
        # the journal keeps step transitions AFTER the flight
        # recorder's ring has evicted them (flushed by the next
        # cycle's health pass — transitions fire inside cycles and
        # from HTTP verb threads, neither of which should pay a
        # store write per step)
        # racecheck: handoff=EventJournal.append takes its own internal lock; the attribute itself is bound once in __init__
        self.journal.append(  # sdklint: disable=lock-discipline — EventJournal serializes internally; like the tracer, it is callable from any thread
            "plan", step=step.name,
            **{"from": old.value, "to": new.value},
        )

    # -- candidates -> launches ---------------------------------------

    def _process_candidates(
        self, allow_footprint_growth: bool = True, parent=None
    ) -> int:
        candidates = self.coordinator.get_candidates()
        if not candidates:
            if not self._suppressed:
                # racecheck: handoff=only the cycle thread reaches _process_candidates (run_forever's loop, or a test driving run_cycle inline); cycles never overlap
                self._suppressed = True
                self.metrics.incr("suppresses")
            return 0
        if self._suppressed:
            # new work while suppressed: revive, rate-limited so a
            # crash-looping task can't force a full rescan every cycle
            if not self.revive_bucket.try_acquire():
                self.metrics.incr("revives.throttled")
                return 0
            self._suppressed = False
            self.metrics.incr("revives")
        # one shared evaluation context for the whole cycle: the task
        # scan and hosts dict are computed once, not once per step
        context = EvaluationContext(self.state_store, self.inventory)
        for step in candidates:
            if isinstance(step, ActionStep):
                # scheduler-side work (decommission/uninstall/custom)
                step.execute(self)
                # it may have killed/erased tasks: the shared context
                # must not serve the pre-action scan to later steps,
                # and memoized requirement outcomes computed against
                # the pre-action task set are void too
                context.invalidate_tasks()
                self.evaluator.invalidate_memo()
                continue
            if not isinstance(step, DeploymentStep):
                continue
            requirement = step.start()
            if requirement is None:
                continue
            if not allow_footprint_growth and \
                    not self._has_full_footprint(requirement):
                continue  # needs new reservations: wait for selection
            with self.metrics.time("cycle.evaluate"):
                result = self.evaluator.evaluate(
                    requirement, self.inventory, context,
                    trace_parent=parent,
                )
            self.outcome_tracker.record(requirement.name, result.outcome)
            self.metrics.incr("offers.evaluated")
            if not result.passed:
                step.update_offer_status(False)
                self.metrics.incr("offers.declined")
                continue
            # chaos: evaluation passed but NOTHING is persisted yet —
            # a successor re-evaluates from scratch, nothing leaks
            self._chaos_point("post-evaluate")
            self._kill_previous_launches(result.task_infos)
            with self.tracer.span(
                f"launch:{requirement.name}", parent=parent,
                track="scheduler",
                task_ids=",".join(t.task_id for t in result.task_infos),
            ) as launch_span:
                # WAL discipline: reservations + task infos are durable
                # BEFORE the agent sees a launch
                # (DefaultScheduler.java:454)
                # durcheck: dur-effect-before-wal=the preceding kill is recovery-covered: a crash here leaves a terminal status the successor relaunches from; this WAL only covers the NEW launch
                self.ledger.commit(result.reservations)
                self.launch_recorder.record(
                    result.task_infos, parent=launch_span
                )
                context.note_launched(result.task_infos)
                for info in result.task_infos:
                    override, progress = self.state_store.fetch_goal_override(
                        info.name
                    )
                    if progress is OverrideProgress.PENDING:
                        self.state_store.store_goal_override(
                            info.name, override, OverrideProgress.IN_PROGRESS
                        )
                    # statuses for these ids — however many cycles
                    # later — join this launch's correlation chain
                    self.tracer.register_launch(
                        info.task_id, launch_span,
                        track=f"{info.pod_type}-{info.pod_index}",
                    )
                # the PENDING->STARTING transition is launch-caused:
                # anchor it to the launch span, not a status
                self._trace_ctx = (threading.get_ident(),
                                   launch_span.trace_id,
                                   launch_span.span_id)
                try:
                    step.record_launch(
                        {t.name: t.task_id for t in result.task_infos}
                    )
                finally:
                    self._trace_ctx = None
                # chaos: reservations + WAL are durable but the agent
                # never hears about the launch — a successor must
                # re-issue it (the STAGING seed reconciles to LOST)
                self._chaos_point("post-wal")
                self._launch(result.task_infos, requirement)
            self.metrics.incr("operations.launch", len(result.task_infos))
        return len(candidates)

    def _has_full_footprint(self, requirement) -> bool:
        """True when every task of the requirement already holds
        committed reservations (an in-place relaunch, not growth)."""
        return all(
            self.ledger.for_task(name) for name in requirement.task_names()
        )

    def _kill_previous_launches(self, task_infos) -> None:
        """A relaunch of task name N must kill N's previous process
        before the new one starts (rolling update / recovery path).

        The previous launch is identified by the task id recorded in
        THIS service's own state store — never by an agent-wide name
        scan, which in multi-service mode would kill another service's
        same-named task (reference: prior task id read from the pod's
        own state store via PersistentLaunchRecorder/StateStore)."""
        for info in task_infos:
            prev = self.state_store.fetch_task(info.name)
            if prev is None or prev.task_id == info.task_id:
                continue
            status = self.state_store.fetch_status(info.name)
            if status is not None and status.task_id == prev.task_id \
                    and status.state.is_terminal:
                continue  # previous launch already dead
            self.task_killer.kill(prev.task_id)

    def _launch(self, task_infos, requirement) -> None:
        pod = requirement.pod
        for info in task_infos:
            task_spec = None
            for spec in pod.tasks:
                # exact-name match: suffix matching would confuse task
                # names that are dash-suffixes of each other
                if task_full_name(pod.type, info.pod_index, spec.name) == \
                        info.name:
                    task_spec = spec
                    break
            # paused tasks run an idle command: their readiness/health
            # checks would probe a server that isn't there
            paused = info.labels.get(Label.GOAL_STATE_OVERRIDE) == \
                GoalStateOverride.PAUSED.value
            launch_one = getattr(self.agent, "launch_one", None)
            if launch_one is not None and task_spec is not None:
                files, secret_env = self._security_payload(
                    info, pod, task_spec
                )
                kwargs = {}
                if files or secret_env:
                    kwargs = {"files": files, "secret_env": secret_env}
                if task_spec.uris:
                    # artifact entries ride the launch request; the
                    # agent fetches before the command runs (reference:
                    # Mesos fetcher on TaskInfo URIs,
                    # YAMLToInternalMappers.java:397)
                    kwargs["uris"] = [
                        {
                            "uri": u.uri,
                            "dest": u.effective_dest(),
                            "sha256": u.sha256,
                            "extract": u.extract,
                            "executable": u.executable,
                        }
                        for u in task_spec.uris
                    ]
                if pod.rlimits:
                    # the agent applies these via setrlimit(2) in the
                    # task's exec path (reference: RLimitSpec ->
                    # Mesos RLimitInfo on the ContainerInfo)
                    kwargs["rlimits"] = [
                        {"name": r.name, "soft": r.soft, "hard": r.hard}
                        for r in pod.rlimits
                    ]
                launch_one(
                    info,
                    readiness=None if paused else task_spec.readiness_check,
                    health=None if paused else task_spec.health_check,
                    templates=self._templates_for(info, task_spec),
                    kill_grace_s=task_spec.kill_grace_period_s,
                    **kwargs,
                )
            else:
                self.agent.launch([info])

    def _security_payload(self, info, pod, task_spec):
        """Secret files/env + TLS PEMs for one launch.

        Reference: TLSEvaluationStage.java placing cert/key artifacts
        and the Mesos Secret volume flow — values resolve at launch
        and ship with the request; a missing secret fails the launch
        as an ERROR file entry (the agent refuses to start the task),
        matching the fail-before-cmd bootstrap discipline.
        """
        import base64 as _b64

        files: List[dict] = []
        secret_env: Dict[str, str] = {}

        def add_file(dest: str, content: bytes, mode: int = 0o600) -> None:
            files.append({
                "dest": dest,
                "content": _b64.b64encode(content).decode(),
                "mode": mode,
            })

        for sec in pod.secrets:
            try:
                if self.secrets_provider is None:
                    raise RuntimeError("no secrets provider configured")
                value = self.secrets_provider.fetch(sec.secret)
            except Exception as e:
                files.append({
                    "dest": sec.file or sec.secret,
                    "error": f"secret {sec.secret!r} unavailable: {e}",
                })
                continue
            if sec.file:
                add_file(sec.file, value)
            env_key = sec.effective_env_key()
            if env_key:
                secret_env[env_key] = value.decode("utf-8", "replace")
        tls_specs = [
            t for t in task_spec.transport_encryption
            if t.type in ("TLS", "KEYSTORE")
        ]
        if tls_specs:
            ca = self.certificate_authority
            if ca is None:
                files.append({
                    "dest": f"{tls_specs[0].name}.crt",
                    "error": "transport-encryption requested but the "
                             "scheduler has no certificate authority",
                })
            else:
                hostname = info.labels.get(Label.HOSTNAME, "")
                for te in tls_specs:
                    cert, key = ca.issue(
                        info.name, sans=[info.name, hostname]
                    )
                    add_file(f"{te.name}.crt", cert, 0o644)
                    add_file(f"{te.name}.key", key, 0o600)
                    add_file(f"{te.name}.ca", ca.ca_cert_pem, 0o644)
        return files, secret_env

    def _templates_for(self, info, task_spec) -> List[dict]:
        """Config templates for the agent to render into the sandbox.

        URL mode (serve): the agent pulls from this scheduler's
        /v1/artifacts endpoint, pinned to the task's target config id
        so a mid-rollout task renders ITS config version (reference:
        ArtifactResource.java:50 path carries the config UUID).
        Inline mode: template text is read here and shipped with the
        launch request."""
        import os as _os

        out: List[dict] = []
        for template_path, dest in task_spec.config_templates:
            name = _os.path.basename(template_path)
            entry: dict = {"name": name, "dest": dest}
            if self.artifact_base:
                target = info.labels.get(Label.TARGET_CONFIG, "")
                entry["url"] = (
                    f"{self.artifact_base}/v1/artifacts/template/"
                    f"{target}/{info.pod_type}/{task_spec.name}/{name}"
                )
            else:
                try:
                    with open(template_path, "r") as f:
                        entry["content"] = f.read()
                except OSError as e:
                    # ship the failure to the agent: the task must
                    # ERROR rather than run with a missing config
                    entry["error"] = f"unreadable template: {e}"
            out.append(entry)
        return out

    def _kill_orphans(self) -> None:
        """Kill agent tasks this service's store does not own — either
        an unknown name or a stale id for a known name (a lost kill
        whose successor already launched).  Reference: kill-unneeded-
        tasks on register, DefaultScheduler.java:252-270.  The launch
        WAL runs before the agent launch, so a freshly-launched task is
        always store-known and never swept."""
        for task_id in self.agent.active_task_ids():
            try:
                name = task_name_of(task_id)
            except ValueError:
                self.task_killer.kill(task_id)
                continue
            info = self.state_store.fetch_task(name)
            if info is None or info.task_id != task_id:
                self.task_killer.kill(task_id)
                self.metrics.incr("operations.kill_orphan")

    # -- reservation GC ----------------------------------------------

    def _gc_reservations(self) -> None:
        """Reference: unexpected-resource cleanup
        (DefaultScheduler.java:483-538): any reservation no stored
        TaskInfo references is released."""
        expected: Set[str] = set()
        for info in self.state_store.fetch_tasks():
            expected |= set(info.resource_ids)
        for reservation in self.ledger.all():
            if reservation.reservation_id not in expected:
                self.ledger.release(reservation.reservation_id)
                self.metrics.incr("operations.unreserve")

    # -- operator verbs (wired to HTTP in http/) ----------------------

    def restart_pod(self, pod_type: str, index: int, replace: bool = False) -> List[str]:
        """Reference: PodQueries.restart (:263) — ``replace`` marks
        tasks permanently failed (pod replace), otherwise a plain
        restart (kill; recovery relaunches in place).

        Takes the scheduler lock: operator verbs arrive on HTTP server
        threads and must serialize with run_cycle so kills/overrides
        never interleave with an in-flight evaluation."""
        with self._lock:
            pod = self.spec.pod(pod_type)
            indices = list(range(pod.count)) if pod.gang else [index]
            killed = []
            for i in indices:
                for task_spec in pod.tasks:
                    full = task_full_name(pod_type, i, task_spec.name)
                    info = self.state_store.fetch_task(full)
                    if info is None:
                        continue
                    if replace:
                        self.state_store.store_tasks(
                            [info.with_label(Label.PERMANENTLY_FAILED, "true")]
                        )
                    self.task_killer.kill(
                        info.task_id, task_spec.kill_grace_period_s
                    )
                    killed.append(full)
            self.journal.append(
                "operator",
                verb="replace" if replace else "restart",
                pod=f"{pod_type}-{index}",
                tasks=len(killed),
            )
            self.nudge()  # recovery work just became pending
            return killed

    def pause_pod(
        self, pod_type: str, index: int, tasks: Optional[List[str]] = None
    ) -> List[str]:
        """Reference: PodQueries pause (:183-203) — store a PAUSED goal
        override and kill the tasks; recovery relaunches them with the
        idle override command on their existing reservations."""
        return self._override_pod(
            pod_type, index, tasks, GoalStateOverride.PAUSED
        )

    def resume_pod(
        self, pod_type: str, index: int, tasks: Optional[List[str]] = None
    ) -> List[str]:
        """Reference: PodQueries resume — clear the override and kill;
        the relaunch restores the real command."""
        return self._override_pod(
            pod_type, index, tasks, GoalStateOverride.NONE
        )

    def _override_pod(
        self,
        pod_type: str,
        index: int,
        tasks: Optional[List[str]],
        override: GoalStateOverride,
    ) -> List[str]:
        # serialized with run_cycle (see restart_pod): otherwise the
        # PENDING->IN_PROGRESS flip can attach to a relaunch that was
        # evaluated with the real (non-override) command
        with self._lock:
            pod = self.spec.pod(pod_type)
            indices = list(range(pod.count)) if pod.gang else [index]
            touched = []
            for i in indices:
                for task_spec in pod.tasks:
                    if tasks and task_spec.name not in tasks:
                        continue
                    full = task_full_name(pod_type, i, task_spec.name)
                    current, _progress = self.state_store.fetch_goal_override(
                        full
                    )
                    if current is override:
                        # no-op transition (pause of a paused task,
                        # resume of a running one): don't kill anything
                        continue
                    self.state_store.store_goal_override(
                        full, override, OverrideProgress.PENDING
                    )
                    touched.append(full)
                    info = self.state_store.fetch_task(full)
                    if info is not None:
                        self.task_killer.kill(
                            info.task_id, task_spec.kill_grace_period_s
                        )
            if touched:
                self.journal.append(
                    "operator",
                    verb="pause" if override is GoalStateOverride.PAUSED
                    else "resume",
                    pod=f"{pod_type}-{index}",
                    tasks=len(touched),
                )
            self.nudge()  # override relaunch work just became pending
            return touched

    # -- instance-count + scale verbs (the health loop) -----

    def _scale_managed_instance(self, asset: str) -> bool:
        """True while an incomplete autoscale phase step owns this
        pod-instance asset (recovery's externally-managed check)."""
        for phase in self.actions.manager.get_plan().phases:
            for step in phase.steps:
                if asset in step.get_asset_names() and \
                        not step.is_complete:
                    return True
        return False

    def set_pod_count(self, pod_type: str, count: int,
                      source: str = "operator") -> bool:
        """THE one mutation point for a non-gang pod's instance count:
        swaps the live spec (frozen dataclasses — a replaced copy),
        keeps the recovery manager's spec in step, persists the
        desired count as a state-store property so a restart/failover
        rebuilds the deploy plan at the scaled width, and journals.
        Idempotent at the target count (returns False) — what lets
        the autoscale grow/shrink steps re-run safely after a
        failover.  Action code (health/actions.py) mutates counts
        ONLY through this verb (the health-plan-only lint rule)."""
        import dataclasses

        from dcos_commons_tpu_torch.health.actions import COUNT_PROPERTY_PREFIX

        with self._lock:
            pod = self.spec.pod(pod_type)
            count = int(count)
            if pod.gang:
                raise ValueError(
                    f"pod {pod_type!r} is a gang: its count is the "
                    "mesh width (elastic re-slicing owns gang width)"
                )
            if count < 1:
                raise ValueError("count must be >= 1")
            if count == pod.count:
                return False
            new_pod = dataclasses.replace(pod, count=count)
            self.spec = dataclasses.replace(
                self.spec,
                pods=tuple(
                    new_pod if p.type == pod_type else p
                    for p in self.spec.pods
                ),
            )
            self.recovery_manager.set_spec(self.spec)
            # the property carries the YAML floor it was written
            # against ("count@floor"): a later config update that
            # CHANGES the YAML count invalidates the override at the
            # next rebuild — operator intent in the spec always beats
            # a stale autoscale decision
            floor = self.actions._baseline(self, pod_type)
            self.state_store.store_property(
                f"{COUNT_PROPERTY_PREFIX}{pod_type}",
                f"{count}@{floor}".encode("utf-8"),
            )
            self.journal.append(
                "health" if source == "autoscale" else "operator",
                verb="set-count", pod=pod_type, count=count,
                source=source,
            )
            self.nudge()
            return True

    def scale_pod(self, pod_type: str, count: int):
        """Operator ``POST /v1/pod/<type>/scale``: manual scale
        through the SAME plan machinery (and single-flight rule) as
        the automated loop — the returned phase is visible and
        interruptible under the ``autoscale`` plan.  Serialized with
        run_cycle like every verb."""
        with self._lock:
            return self.actions.request_scale(self, pod_type, count)

    def abandon_scale(self, pod_type: str) -> bool:
        """Operator ``POST /v1/pod/<type>/scale/abandon``: drop the
        pod's in-flight scale action, reconciling the persisted count
        to deployed reality (a half-deployed widening must not resume
        at the next restart) and latching the direction's cooldown.
        The bail-out for a wedged scale action — plan interrupt only
        PARKS it (single flight then blocks the pod forever), and
        force-complete would journal a false completion."""
        with self._lock:
            return self.actions.abandon(self, pod_type)

    def draining_instances(self) -> Set[str]:
        """Pod-instance names an ACTIVE teardown plan is about to
        kill (surplus decommission or autoscale scale-in): endpoint
        assembly flips their backend rows to ``draining:true`` so the
        router stops placing BEFORE the kill step fires, while task
        and host still look perfectly healthy."""
        out: Set[str] = set()
        for plan in self.plans().values():
            for phase in plan.phases:
                targets = getattr(phase, "decommission_targets", None)
                if targets and not phase.is_complete:
                    out |= set(targets)
        return out

    # -- host lifecycle verbs (preemption & maintenance) ----

    def drain_host(self, host_id: str, window_s: float = 0.0) -> bool:
        """Operator ``POST /v1/hosts/<id>/drain``: mark the host for
        maintenance.  Placement excludes it immediately (hard
        exclusion at admission); running work keeps running (soft
        drain) and the /v1/endpoints backend rows surface it as
        ``draining`` so the serving front door stops routing new
        requests BEFORE anything is killed.  ``window_s`` > 0 records
        when the window ends — the elastic-resize rule prefers
        waiting out a finite window over shrinking a gang."""
        import time as _time

        with self._lock:
            window_end = _time.time() + window_s if window_s > 0 else 0.0
            changed = self.inventory.set_maintenance(host_id, window_end)
            if changed:
                self.journal.append(
                    "host", verb="drain", host=host_id,
                    window_s=window_s,
                    message=f"host {host_id} entering maintenance"
                            + (f" ({window_s:.0f}s window)"
                               if window_s > 0 else ""),
                )
            self.nudge()
            return changed

    def undrain_host(self, host_id: str) -> bool:
        """Operator ``POST /v1/hosts/<id>/up``: clear every
        preempted/maintenance/down mark and return the host to full
        placement eligibility."""
        with self._lock:
            changed = self.inventory.clear_host_state(host_id)
            if changed:
                self.journal.append(
                    "host", verb="up", host=host_id,
                    message=f"host {host_id} back in service",
                )
            self.nudge()
            return changed

    def preempt_host(self, host_id: str) -> List[str]:
        """Operator ``POST /v1/hosts/<id>/preempt`` (or the agent
        plane's preemption notice): the cloud took the host back.
        Marks it preempted in the inventory and surfaces the loss to
        THIS service's tasks — see :meth:`note_host_preempted`."""
        with self._lock:
            self.inventory.set_preempted(host_id)
            return self.note_host_preempted(host_id)

    def note_host_preempted(self, host_id: str) -> List[str]:
        """Every stored task on the preempted host is dead NOW and the
        capacity is not coming back: stamp PERMANENTLY_FAILED (so
        recovery goes straight to PERMANENT — for a gang member, the
        gang recovery plan) and route a synthesized TASK_LOST through
        the normal status path.  Idempotent: already-terminal tasks
        are skipped, so a verb racing the agent plane's own
        down-detection stamps each task once."""
        from dcos_commons_tpu_torch.common import TaskState

        with self._lock:
            touched: List[str] = []
            for info in self.state_store.fetch_tasks():
                if info.agent_id != host_id:
                    continue
                status = self.state_store.fetch_status(info.name)
                if status is not None and status.task_id == info.task_id \
                        and status.state.is_terminal:
                    continue
                self.state_store.store_tasks(
                    [info.with_label(Label.PERMANENTLY_FAILED, "true")]
                )
                self._process_status(TaskStatus(
                    task_id=info.task_id,
                    state=TaskState.LOST,
                    agent_id=host_id,
                    message=f"host {host_id} preempted",
                ))
                touched.append(info.name)
            self.journal.append(
                "host", verb="preempt", host=host_id, tasks=len(touched),
                message=f"host {host_id} preempted "
                        f"({len(touched)} task(s) lost)",
            )
            self.nudge()  # gang recovery work just became pending
            return touched

    def plans(self) -> Dict[str, Plan]:
        out = {}
        for manager in self.coordinator.plan_managers:
            plan = manager.get_plan()
            out[plan.name] = plan
        return out

    def plan(self, name: str) -> Optional[Plan]:
        return self.plans().get(name)

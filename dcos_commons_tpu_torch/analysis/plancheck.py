"""plancheck: a bounded explicit-state model checker for the plan tree
(port of ``dcos_commons_tpu/analysis/plancheck.py``, line for line but
the imports: it drives the port's ``plan/``, ``health/actions.py`` and
``specification/``).

The reference SDK's ``plan/`` layer was hand-audited Java reviewed for
years; this rebuild's scheduler trusts the same state machines under
REORDERED status arrivals, operator verbs racing deploys, and gang
recovery restarts.  Unit tests sample a handful of interleavings;
this module explores ALL of them, bounded: it drives the *real*
``Status``/``Step``/``Phase``/``Plan``/``Strategy`` objects (no
abstract model to drift out of sync) through exhaustive breadth-first
search over an event alphabet of

- task status arrivals (RUNNING / FINISHED / FAILED / ERROR, plus a
  stale status from a dead launch),
- step launches (candidate -> ``start()`` -> ``record_launch``),
- operator verbs (restart, force-complete, interrupt, proceed at
  step / phase / plan level),

deduplicating by a canonical snapshot of every mutable field, so the
search visits each reachable *state* once (10^4–10^5 states per
configuration).  BFS order means every reported violation comes with
a MINIMAL event trace from the initial state.

Invariants checked (see docs/developer-guide.md §9 for how to add
one):

- ``no-silent-regression``: a COMPLETE step only leaves COMPLETE via
  an explicit restart verb.
- ``error-absorbs``: an ERROR step stays ERROR until an operator
  restart/force-complete.
- ``aggregate-consistent``: ``status.aggregate`` is permutation-
  insensitive over every child multiset the search actually reaches,
  ERROR dominates, and all-COMPLETE <=> COMPLETE.
- ``dependency-honored``: a DependencyStrategy phase never emits a
  candidate whose dependency is not COMPLETE.
- ``interrupt-visible``: an interrupted (WAITING) child is never
  hidden behind IN_PROGRESS/PENDING at the parent while incomplete.
- ``no-livelock``: every reachable state can still reach a
  plan-COMPLETE state (checked on the full reachability graph, so
  only sound when the exploration wasn't truncated by the cap).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from dcos_commons_tpu_torch.common import TaskState, TaskStatus
from dcos_commons_tpu_torch.plan.backoff import Backoff
from dcos_commons_tpu_torch.plan.phase import Phase
from dcos_commons_tpu_torch.plan.plan import Plan
from dcos_commons_tpu_torch.plan.status import Status, aggregate
from dcos_commons_tpu_torch.plan.step import (
    ActionStep,
    DeploymentStep,
    PodInstanceRequirement,
)
from dcos_commons_tpu_torch.plan.strategy import (
    CanaryStrategy,
    DependencyStrategy,
    ParallelStrategy,
    SerialStrategy,
)
from dcos_commons_tpu_torch.specification.specs import GoalState, PodSpec, TaskSpec

# deterministic task-id scheme: the model always launches the same id
# per step, and delivers stale statuses under a distinct dead id
_LIVE = "live"
_STALE = "stale"
_FAR_FUTURE = float("inf")


class ModelBackoff(Backoff):
    """DELAYED that never expires on its own: the checker explores the
    backoff branch symbolically (restart/force-complete are the exits)
    instead of racing the wall clock."""

    def next_delay(self, key: str) -> float:
        return _FAR_FUTURE

    def clear(self, key: str) -> None:
        pass

    def current_delay(self, key: str) -> float:
        return 0.0


# -- snapshots --------------------------------------------------------------


def _snap_step(step, quotient: bool = False) -> tuple:
    if isinstance(step, ActionStep):
        # scheduler-side steps (the gang recovery choreography's
        # kill/unreserve/trim): three mutable fields, no launch residue
        return ("A", step._status.value, step._interrupted,
                tuple(step.errors))
    if quotient and step._status is Status.COMPLETE and not step.errors:
        # quotient: a COMPLETE step ignores every status (the
        # is_complete guard) and every exit (restart) wipes the
        # residue, so the _expected/_task_states left behind by
        # force-complete are behaviorally dead — collapsing them cuts
        # the state space several-fold without losing any behavior.
        # NOT assumed: _quotient_probe() verifies the guard actually
        # holds for these step objects before the quotient is enabled,
        # so a step class that DOES react to post-COMPLETE statuses
        # falls back to exhaustive snapshots and the regression is
        # caught, not hidden.
        return (Status.COMPLETE.value, step._interrupted)
    return (
        step._status.value,
        step._interrupted,
        tuple(sorted(step._expected.items())),
        tuple(sorted((k, v.value) for k, v in step._task_states.items())),
        tuple(sorted(step._task_ready.items())),
        # canonical: the exact deadline is wall-clock noise — only
        # "parked in backoff" vs "free" distinguishes behaviors
        step._status is Status.DELAYED and step._delay_until > 0,
        tuple(step.errors),
    )


def _restore_step(step, snap: tuple) -> None:
    if isinstance(step, ActionStep):
        _tag, status, interrupted, errors = snap
        step._status = Status(status)
        step._interrupted = interrupted
        step.errors[:] = list(errors)
        return
    if len(snap) == 2:  # the COMPLETE quotient
        step._status = Status.COMPLETE
        step._interrupted = snap[1]
        step._expected = {}
        step._task_states = {}
        step._task_ready = {}
        step._delay_until = 0.0
        step.errors.clear()
        return
    (status, interrupted, expected, states, ready, delayed,
     errors) = snap
    step._status = Status(status)
    step._interrupted = interrupted
    step._expected = dict(expected)
    step._task_states = {k: TaskState(v) for k, v in states}
    step._task_ready = dict(ready)
    step._delay_until = _FAR_FUTURE if delayed else 0.0
    step.errors[:] = list(errors)


def _snap_strategy(strategy) -> tuple:
    if isinstance(strategy, CanaryStrategy):
        return (strategy._interrupted, strategy._proceeds)
    return (strategy._interrupted,)


def _restore_strategy(strategy, snap: tuple) -> None:
    if isinstance(strategy, CanaryStrategy):
        strategy._interrupted, strategy._proceeds = snap
    else:
        (strategy._interrupted,) = snap


class PlanHarness:
    """One plan instance + snapshot/restore + the event alphabet.

    ``step_interrupts`` adds per-step interrupt/proceed verbs (doubles
    each step's state space — worth it in one small configuration, not
    in all of them; phase/plan interrupts are always in the alphabet).
    """

    def __init__(self, plan: Plan, step_interrupts: bool = False,
                 world=None):
        self.plan = plan
        self.step_interrupts = step_interrupts
        self.quotient = False  # enabled by _quotient_probe() only
        # optional non-plan model state (the gang-recovery config):
        # snapshot/restore ride the plan's; ``world.events(harness)``
        # joins the alphabet; ``world.launch_overrides`` maps step
        # name -> replacement launch callable (a launch with a WAL
        # side effect the model must observe)
        self.world = world
        self.steps: List[DeploymentStep] = [
            s for p in plan.phases for s in p.steps
        ]
        self.strategies = [plan.strategy] + [
            p.strategy for p in plan.phases
        ]

    def snapshot(self) -> tuple:
        snap = (
            tuple(_snap_step(s, self.quotient) for s in self.steps),
            tuple(_snap_strategy(s) for s in self.strategies),
        )
        if self.world is not None:
            return snap + (self.world.snapshot(),)
        return snap

    def restore(self, snap: tuple) -> None:
        step_snaps, strat_snaps = snap[0], snap[1]
        for step, ssnap in zip(self.steps, step_snaps):
            _restore_step(step, ssnap)
        for strategy, tsnap in zip(self.strategies, strat_snaps):
            _restore_strategy(strategy, tsnap)
        if self.world is not None:
            self.world.restore(snap[2])

    # -- events -------------------------------------------------------

    def events(self) -> List[Tuple[str, Callable[[], None]]]:
        """The full alphabet.  Enabledness is implicit: an event that
        does not change the snapshot is a self-loop and is dropped by
        the dedup, so "disabled" events cost one transition apply."""
        out: List[Tuple[str, Callable[[], None]]] = []
        overrides = getattr(self.world, "launch_overrides", {}) \
            if self.world is not None else {}
        for step in self.steps:
            name = step.name
            if isinstance(step, ActionStep):
                # scheduler-side step: its "launch" is execute(),
                # gated on candidacy exactly as run_cycle gates it.
                # No force_complete in the model alphabet: forcing a
                # kill/unreserve step asserts OUT-OF-BAND operator
                # knowledge (the processes are known dead, the claims
                # known released) the world cannot represent — modeled
                # instead by the world's own death/release events.
                out.append((f"execute({name})", self._executor(step)))
                out.append((f"restart({name})", step.restart))
                if self.step_interrupts:
                    out.append((f"interrupt({name})", step.interrupt))
                    out.append((f"proceed({name})", step.proceed))
                continue
            launcher = overrides.get(name) or self._launcher(step)
            out.append((f"launch({name})", launcher))
            # status events for EVERY task the step covers (a gang
            # step completes only when all its tasks report; a
            # single-task step is unchanged by the loop)
            for task, spec in step._spec_by_full.items():
                statuses = [
                    ("RUNNING", TaskState.RUNNING, False),
                    ("FINISHED", TaskState.FINISHED, False),
                    ("FAILED", TaskState.FAILED, False),
                    ("TASK_ERROR", TaskState.ERROR, False),
                ]
                if spec.readiness_check is not None:
                    # only meaningful with a readiness gate; elsewhere
                    # it just doubles RUNNING
                    statuses.insert(1, ("READY", TaskState.RUNNING, True))
                prefix = f"status({name}" if len(step._spec_by_full) == 1 \
                    else f"status({name}:{task}"
                for label, state, ready in statuses:
                    out.append((
                        f"{prefix},{label})",
                        self._status_sender(task, state, ready, _LIVE),
                    ))
                # a status from a launch that no longer exists
                # (reordered delivery across a restart) — must always
                # be ignored
                out.append((
                    f"{prefix},STALE_FAILED)",
                    self._status_sender(
                        task, TaskState.FAILED, False, _STALE
                    ),
                ))
            out.append((f"restart({name})", step.restart))
            out.append((f"force_complete({name})", step.force_complete))
            if self.step_interrupts:
                out.append((f"interrupt({name})", step.interrupt))
                out.append((f"proceed({name})", step.proceed))
        for i, phase in enumerate(self.plan.phases):
            out.append((f"interrupt(phase:{phase.name})", phase.interrupt))
            out.append((f"proceed(phase:{phase.name})", phase.proceed))
        out.append(("interrupt(plan)", self.plan.interrupt))
        out.append(("proceed(plan)", self.plan.proceed))
        if self.world is not None:
            out.extend(self.world.events(self))
        return out

    def _executor(self, step: ActionStep) -> Callable[[], None]:
        def execute() -> None:
            # run_cycle only executes CANDIDATES; the serial strategy
            # is what orders kill -> unreserve -> replace
            if step not in self.plan.candidates(set()):
                return
            step.execute(None)
        return execute

    def _launcher(self, step: DeploymentStep) -> Callable[[], None]:
        def launch() -> None:
            # the offer cycle only starts CANDIDATES: mutual exclusion
            # and ordering come from the strategies, exactly as in
            # PlanCoordinator.process_offers
            if step not in self.plan.candidates(set()):
                return
            requirement = step.start()
            if requirement is None:
                return
            step.record_launch({
                task: f"{task}__{_LIVE}"
                for task in requirement.task_names()
            })
        return launch

    def _status_sender(
        self, task: str, state: TaskState, ready: bool, suffix: str
    ) -> Callable[[], None]:
        # one immutable TaskStatus per event, built once: update()
        # never mutates the status, and the dataclass construction is
        # measurable at ~10^6 transitions
        status = TaskStatus(
            task_id=f"{task}__{suffix}",
            state=state,
            ready=ready,
            timestamp=1.0,
        )

        def send() -> None:
            self.plan.update(status)
        return send


def _quotient_probe(harness: PlanHarness) -> bool:
    """Verify the COMPLETE-residue quotient is sound for THESE step
    objects: craft representative COMPLETE states still carrying
    launch residue (expected ids, task states), fire every status and
    launch event at them, and require the step to stay COMPLETE with
    no errors.  A step class missing the is_complete guard (or a
    strategy that launches completed steps) fails the probe, the
    checker falls back to exhaustive snapshots, and the regression is
    REPORTED by the search instead of being quotiented away.

    Caller must restore the pre-probe snapshot afterwards.
    """
    events = harness.events()
    for step in harness.steps:
        if isinstance(step, ActionStep):
            continue  # no launch residue to quotient
        task = next(iter(step._spec_by_full))
        live = f"{task}__{_LIVE}"
        running = TaskState.RUNNING.value
        residues = [
            # natural completion: expected + RUNNING (+ready)
            (Status.COMPLETE.value, False, ((task, live),),
             ((task, running),), ((task, True),), False, ()),
            # force-complete mid-launch: expected, no states yet
            (Status.COMPLETE.value, False, ((task, live),),
             (), (), False, ()),
        ]
        mine = [
            ev for label, ev in events
            if label.startswith(f"status({step.name},")
            or label.startswith(f"status({step.name}:")
            or label == f"launch({step.name})"
        ]
        for residue in residues:
            for ev in mine:
                _restore_step(step, residue)
                ev()
                if step._status is not Status.COMPLETE or step.errors:
                    return False
    return True


# -- invariants -------------------------------------------------------------


@dataclass
class Violation:
    invariant: str
    detail: str
    trace: Tuple[str, ...]

    def render(self) -> str:
        steps = "\n".join(
            f"    {i + 1}. {event}" for i, event in enumerate(self.trace)
        ) or "    (initial state)"
        return (
            f"[{self.invariant}] {self.detail}\n"
            f"  minimal trace ({len(self.trace)} events):\n{steps}"
        )


class Invariant:
    """Base: override either hook.  ``on_transition`` sees the step
    statuses before/after one event; ``on_state`` sees each NEW
    deduplicated state once.  Return a violation detail string, or
    None."""

    name = ""

    def on_transition(
        self,
        harness: PlanHarness,
        before: Sequence[Status],
        event: str,
        after: Sequence[Status],
    ) -> Optional[str]:
        return None

    def on_state(self, harness: PlanHarness) -> Optional[str]:
        return None


def _restart_scope(event: str, step_name: str) -> bool:
    """True when ``event`` is a restart verb covering ``step_name``."""
    return event.startswith("restart(")


class NoSilentRegression(Invariant):
    """COMPLETE only leaves COMPLETE via an explicit restart."""

    name = "no-silent-regression"

    def on_transition(self, harness, before, event, after):
        for step, prev, cur in zip(harness.steps, before, after):
            if prev is Status.COMPLETE and cur is not Status.COMPLETE:
                if not _restart_scope(event, step.name):
                    return (
                        f"step {step.name} regressed COMPLETE -> "
                        f"{cur.value} on {event} (only restart may do "
                        "that)"
                    )
        return None


class ErrorAbsorbs(Invariant):
    """ERROR is sticky until an operator restart/force-complete."""

    name = "error-absorbs"

    def on_transition(self, harness, before, event, after):
        for step, prev, cur in zip(harness.steps, before, after):
            if prev is Status.ERROR and cur is not Status.ERROR:
                if not (
                    event.startswith("restart(")
                    or event.startswith("force_complete(")
                ):
                    return (
                        f"step {step.name} left ERROR -> {cur.value} on "
                        f"{event} without operator intervention"
                    )
        return None


class AggregateConsistent(Invariant):
    """aggregate() is order-insensitive on every reached multiset,
    ERROR dominates, all-COMPLETE <=> COMPLETE (non-empty)."""

    name = "aggregate-consistent"

    def __init__(self) -> None:
        self._checked: set = set()

    def on_state(self, harness):
        groups: List[Tuple[Status, ...]] = [
            tuple(s.get_status() for s in phase.steps)
            for phase in harness.plan.phases
        ]
        groups.append(tuple(
            p.get_status() for p in harness.plan.phases
        ))
        for statuses in groups:
            for interrupted in (False, True):
                key = (tuple(sorted(s.value for s in statuses)),
                       interrupted)
                if key in self._checked:
                    continue
                self._checked.add(key)
                detail = self._check_multiset(statuses, interrupted)
                if detail:
                    return detail
        return None

    @staticmethod
    def _check_multiset(statuses, interrupted):
        base = aggregate(statuses, interrupted)
        seq = list(statuses)
        perms = (
            itertools.permutations(seq) if len(seq) <= 4
            else [seq, list(reversed(seq)),
                  sorted(seq, key=lambda s: s.value)]
        )
        for perm in perms:
            got = aggregate(perm, interrupted)
            if got is not base:
                return (
                    f"aggregate({[s.value for s in seq]}, "
                    f"interrupted={interrupted}) is order-sensitive: "
                    f"{base.value} vs {got.value} for "
                    f"{[s.value for s in perm]}"
                )
        if statuses:
            all_complete = all(s is Status.COMPLETE for s in statuses)
            if all_complete and base is not Status.COMPLETE:
                return (
                    f"aggregate of all-COMPLETE reads {base.value}"
                )
            if not all_complete and base is Status.COMPLETE:
                return (
                    f"aggregate({[s.value for s in statuses]}) reads "
                    "COMPLETE with incomplete children"
                )
            if any(s is Status.ERROR for s in statuses) and \
                    base is not Status.ERROR:
                return (
                    f"aggregate({[s.value for s in statuses]}) hides a "
                    f"child ERROR behind {base.value}"
                )
        return None


class DependencyHonored(Invariant):
    """DependencyStrategy never emits a candidate whose declared
    dependency is non-COMPLETE."""

    name = "dependency-honored"

    def on_state(self, harness):
        for phase in harness.plan.phases:
            strategy = phase.strategy
            if not isinstance(strategy, DependencyStrategy):
                continue
            by_name = {s.name: s for s in phase.steps}
            for cand in phase.candidates(set()):
                for dep in strategy._edges.get(cand.name, ()):
                    dep_step = by_name.get(dep)
                    if dep_step is not None and not dep_step.is_complete:
                        return (
                            f"{cand.name} emitted as candidate while "
                            f"dependency {dep} is "
                            f"{dep_step.get_status().value}"
                        )
        return None


class InterruptVisible(Invariant):
    """An incomplete WAITING child surfaces at the parent: the
    operator who parked a step must see WAITING in `plan show`, not a
    parent claiming PENDING/IN_PROGRESS while nothing can move."""

    name = "interrupt-visible"

    def on_state(self, harness):
        for phase in harness.plan.phases:
            statuses = [s.get_status() for s in phase.steps]
            parent = phase.get_status()
            if (
                Status.WAITING in statuses
                and parent in (Status.PENDING, Status.IN_PROGRESS)
                and not any(s.is_running for s in statuses)
                and not any(
                    s in (Status.PENDING, Status.DELAYED)
                    for s in statuses
                )
            ):
                return (
                    f"phase {phase.name} reads {parent.value} but its "
                    "only incomplete children are WAITING (interrupt "
                    "hidden from the operator)"
                )
        return None


def default_invariants() -> List[Invariant]:
    return [
        NoSilentRegression(),
        ErrorAbsorbs(),
        AggregateConsistent(),
        DependencyHonored(),
        InterruptVisible(),
    ]


# -- the checker ------------------------------------------------------------


@dataclass
class CheckResult:
    config: str
    states: int
    transitions: int
    complete_states: int
    truncated: bool
    violations: List[Violation] = field(default_factory=list)
    livelock_checked: bool = False
    # False = the probe found a step reacting to post-COMPLETE events
    # and the run fell back to exhaustive (un-quotiented) snapshots
    quotient: bool = True

    @property
    def ok(self) -> bool:
        return not self.violations


def check_plan(
    factory: Callable[[], Plan],
    invariants: Optional[Iterable[Invariant]] = None,
    max_states: int = 200_000,
    max_violations: int = 5,
    config_name: str = "plan",
    check_livelock: bool = True,
    step_interrupts: bool = False,
) -> CheckResult:
    """Exhaustively explore ``factory()``'s plan under the full event
    alphabet; returns states explored, violations with minimal traces.

    The factory is called once — exploration runs on the live object
    graph via snapshot/restore, so the checker checks the REAL
    production classes, not a transcription of them.
    """
    made = factory()
    if isinstance(made, tuple):
        plan, world = made
    else:
        plan, world = made, None
    harness = PlanHarness(
        plan, step_interrupts=step_interrupts, world=world
    )
    invs = list(invariants) if invariants is not None \
        else default_invariants()
    if world is not None and hasattr(world, "invariants"):
        invs += world.invariants()
    events = harness.events()

    pre_probe = harness.snapshot()
    harness.quotient = _quotient_probe(harness)
    harness.restore(pre_probe)
    init = harness.snapshot()
    # state -> (parent state, event label) for minimal-trace replay
    parents: Dict[tuple, Optional[Tuple[tuple, str]]] = {init: None}
    order: List[tuple] = [init]
    edges: List[Tuple[int, int]] = []
    index: Dict[tuple, int] = {init: 0}
    complete: List[int] = []
    violations: List[Violation] = []
    transitions = 0
    truncated = False

    def trace_of(state: tuple, extra: Optional[str] = None) -> Tuple[str, ...]:
        out: List[str] = []
        cur = state
        while parents[cur] is not None:
            prev, label = parents[cur]
            out.append(label)
            cur = prev
        out.reverse()
        if extra:
            out.append(extra)
        return tuple(out)

    def statuses_of() -> Tuple[Status, ...]:
        return tuple(s.get_status() for s in harness.steps)

    head = 0
    while head < len(order):
        state = order[head]
        head += 1
        harness.restore(state)
        before = statuses_of()
        if harness.plan.get_status() is Status.COMPLETE:
            complete.append(index[state])
        for label, apply_event in events:
            harness.restore(state)
            apply_event()
            after = harness.snapshot()
            transitions += 1
            if after == state:
                continue  # self-loop: disabled or no-op event
            after_statuses = statuses_of()
            for inv in invs:
                detail = inv.on_transition(
                    harness, before, label, after_statuses
                )
                if detail and len(violations) < max_violations:
                    violations.append(Violation(
                        inv.name, detail, trace_of(state, label)
                    ))
            if after in parents:
                edges.append((index[state], index[after]))
                continue
            parents[after] = (state, label)
            index[after] = len(order)
            edges.append((index[state], index[after]))
            order.append(after)
            for inv in invs:
                detail = inv.on_state(harness)
                if detail and len(violations) < max_violations:
                    violations.append(Violation(
                        inv.name, detail, trace_of(after)
                    ))
            if len(order) >= max_states:
                truncated = True
                break
        if truncated:
            break

    result = CheckResult(
        config=config_name,
        states=len(order),
        transitions=transitions,
        complete_states=len(complete),
        truncated=truncated,
        violations=violations,
        quotient=harness.quotient,
    )

    # livelock: backward reachability from every plan-COMPLETE state.
    # Only sound on the full graph — a truncated frontier could hold
    # the missing escape path.
    if check_livelock and not truncated:
        result.livelock_checked = True
        reach_complete = set(complete)
        reverse: Dict[int, List[int]] = {}
        for src, dst in edges:
            reverse.setdefault(dst, []).append(src)
        frontier = list(reach_complete)
        while frontier:
            node = frontier.pop()
            for src in reverse.get(node, ()):
                if src not in reach_complete:
                    reach_complete.add(src)
                    frontier.append(src)
        if len(reach_complete) < len(order) and \
                len(violations) < max_violations:
            trapped = min(
                i for i in range(len(order)) if i not in reach_complete
            )
            violations.append(Violation(
                "no-livelock",
                f"{len(order) - len(reach_complete)} reachable state(s) "
                "can never reach plan COMPLETE; first trapped state "
                "shown",
                trace_of(order[trapped]),
            ))
    return result


# -- built-in configurations ------------------------------------------------


def _pod(name: str, readiness: bool = False,
         goal: GoalState = GoalState.RUNNING) -> PodSpec:
    from dcos_commons_tpu_torch.specification.specs import ReadinessCheckSpec

    return PodSpec(
        type=name,
        count=1,
        tasks=[TaskSpec(
            name="server", goal=goal, cmd="run",
            readiness_check=(
                ReadinessCheckSpec(cmd="check") if readiness else None
            ),
        )],
    )


def _step(name: str, pod_type: str, readiness: bool = False,
          goal: GoalState = GoalState.RUNNING) -> DeploymentStep:
    return DeploymentStep(
        name,
        PodInstanceRequirement(pod=_pod(pod_type, readiness, goal),
                               instances=[0]),
        backoff=ModelBackoff(),
    )


def _serial_plan() -> Plan:
    phase1 = Phase(
        "node", [_step("node-0", "na"), _step("node-1", "nb")],
        SerialStrategy(),
    )
    phase2 = Phase("sidecar", [_step("sidecar-0", "sc")], SerialStrategy())
    return Plan("deploy", [phase1, phase2], SerialStrategy())


def _parallel_plan() -> Plan:
    # readiness-gated task + a FINISH-goal sidecar: exercises the
    # STARTED -> COMPLETE readiness edge and the FINISHED mapping
    phase = Phase(
        "node",
        [_step("node-0", "pa", readiness=True),
         _step("node-1", "pb", goal=GoalState.FINISH)],
        ParallelStrategy(),
    )
    return Plan("deploy", [phase], SerialStrategy())


def _dependency_plan() -> Plan:
    phase = Phase(
        "pipeline",
        [_step("stage-a", "da"), _step("stage-b", "db"),
         _step("stage-c", "dc")],
        DependencyStrategy({"stage-b": ["stage-a"],
                            "stage-c": ["stage-a"]}),
    )
    return Plan("deploy", [phase], SerialStrategy())


def _canary_plan() -> Plan:
    phase = Phase(
        "node", [_step("canary-0", "ca"), _step("canary-1", "cb")],
        CanaryStrategy(SerialStrategy(), canary_count=1),
    )
    return Plan("update", [phase], SerialStrategy())


# -- the gang-recovery configuration ----------------------------------
#
# Models DefaultRecoveryPlanManager._make_gang_phase's choreography
# with the REAL plan objects (ActionStep kill/unreserve + a gang
# DeploymentStep replace under SerialStrategy) over a tiny world of
# the non-plan facts the steps mutate: which OLD incarnation
# processes still run, and which incarnation holds reservations.
# Old-task deaths arrive as world events (covering kill acks AND a
# second preemption landing mid-recovery — the storm case); the
# replace launch carries the WAL side effect (reservations commit
# with the launch).  Verified invariants:
#
#   no-split-brain-gang      an old-incarnation process never
#                            coexists with a RUNNING new-incarnation
#                            task (the wedged-collective guarantee)
#   no-double-reservation    the broken sub-slice's claims are
#                            released before the replacement gang's
#                            claims commit


class GangRecoveryWorld:
    """Non-plan model state for the gang-recovery configuration."""

    # surviving old-incarnation processes at entry; each dies
    # independently at any point (kill ack or mid-recovery
    # preemption), so the subset lattice is explored exhaustively.
    # 4 old x 2-host replacement gang lands the configuration at
    # ~10k states in ~12s — deep enough for the storm interleavings,
    # cheap enough for the repo gate.
    N_OLD = 4

    def __init__(self, kill_step, unreserve_step, replace_step):
        self.kill_step = kill_step
        self.unreserve_step = unreserve_step
        self.replace_step = replace_step
        self.old_alive = frozenset(range(self.N_OLD))
        self.old_reserved = True
        self.new_reserved = False
        self.launch_overrides = {
            replace_step.name: self._launch_replace,
        }
        self._plan: Optional[Plan] = None

    def bind(self, plan: Plan) -> "GangRecoveryWorld":
        self._plan = plan
        return self

    # -- snapshot protocol -------------------------------------------

    def snapshot(self) -> tuple:
        return (self.old_alive, self.old_reserved, self.new_reserved)

    def restore(self, snap: tuple) -> None:
        self.old_alive, self.old_reserved, self.new_reserved = snap

    # -- model events -------------------------------------------------

    def events(self, harness: "PlanHarness"):
        out = []
        for i in range(self.N_OLD):
            # an old process dies: a kill ack, OR the host it sat on
            # getting preempted mid-recovery (the storm case) — the
            # model does not distinguish, the plan must tolerate both
            # at ANY point
            out.append((
                f"old-task-dies({i})",
                lambda i=i: self._die(i),
            ))
        return out

    def _die(self, i: int) -> None:
        self.old_alive = self.old_alive - {i}

    def _launch_replace(self) -> None:
        step = self.replace_step
        if step not in self._plan.candidates(set()):
            return
        requirement = step.start()
        if requirement is None:
            return
        # WAL discipline: reservations are durable WITH the launch
        # record (run_cycle commits the ledger inside the launch span)
        self.new_reserved = True
        step.record_launch({
            task: f"{task}__{_LIVE}"
            for task in requirement.task_names()
        })

    # -- model actions (close over self; ActionStep passes None) ------

    def kill_survivors(self, _scheduler) -> bool:
        # issues kills; completes only when nothing old is alive —
        # exactly DefaultRecoveryPlanManager's kill action, with the
        # agent's process table abstracted to ``old_alive``
        return not self.old_alive

    def unreserve_slice(self, _scheduler) -> bool:
        self.old_reserved = False
        return True

    # -- invariants ----------------------------------------------------

    def invariants(self) -> List["Invariant"]:
        return [NoSplitBrainGang(), NoDoubleReservation()]


class NoSplitBrainGang(Invariant):
    """Old and new gang incarnations never run simultaneously: a new
    task reaching RUNNING while an old process survives means two
    incarnations fight over the checkpoint directory and the
    collective fabric (incarnation fencing makes the loser's WRITES
    harmless, but the plan must never create the overlap)."""

    name = "no-split-brain-gang"

    def on_state(self, harness):
        world = harness.world
        if not world.old_alive:
            return None
        step = world.replace_step
        # the hazard is a RUNNING new task while an old process lives.
        # A force-completed replace step with no launch is NOT a
        # split brain — the operator skipped the relaunch, nothing
        # new runs (and any status-driven COMPLETE passed through a
        # RUNNING state this check already saw).
        running = [
            task for task, state in step._task_states.items()
            if state is TaskState.RUNNING
        ]
        if running:
            return (
                f"old incarnation processes {sorted(world.old_alive)} "
                f"still alive while replacement gang runs "
                f"{sorted(running)}"
            )
        return None


class NoDoubleReservation(Invariant):
    """The broken sub-slice's reservations are released before the
    replacement gang's commit: overlapping claims would double-count
    capacity and can double-book chips once the freed hosts re-enter
    the candidate set mid-evaluation."""

    name = "no-double-reservation"

    def on_state(self, harness):
        world = harness.world
        if world.old_reserved and world.new_reserved:
            return (
                "broken sub-slice still reserved while the replacement "
                "gang holds committed reservations"
            )
        return None


def _gang_recovery_plan():
    from dcos_commons_tpu_torch.plan.strategy import SerialStrategy as _Serial

    # the REPLACEMENT gang is 2 hosts (an elastic shrink of the 4 old
    # survivors' slice) — decoupled from N_OLD on purpose: the
    # replace step's task lattice and the old-process subset lattice
    # multiply, and 2x4 is the sweet spot between depth and gate cost
    pod = PodSpec(
        type="trainer",
        count=2,
        gang=True,
        tasks=[TaskSpec(name="worker", goal=GoalState.RUNNING,
                        cmd="train")],
    )
    replace = DeploymentStep(
        "replace-trainer-gang",
        PodInstanceRequirement(
            pod=pod,
            instances=list(range(pod.count)),
        ),
        backoff=ModelBackoff(),
    )
    # world first (the action callables close over it), steps after
    kill = ActionStep("kill-trainer-survivors", lambda s: False)
    unreserve = ActionStep("unreserve-trainer-slice", lambda s: False)
    world = GangRecoveryWorld(kill, unreserve, replace)
    kill._action = world.kill_survivors
    unreserve._action = world.unreserve_slice
    phase = Phase(
        "recover-trainer-gang", [kill, unreserve, replace], _Serial()
    )
    plan = Plan("recovery", [phase], _Serial())
    world.bind(plan)
    return plan, world


# -- the multi-slice recovery configuration ---------------------------
#
# Models the whole-slice elastic choreography end to end: a
# dcn-spanning gang loses one slice, the recovery plan shrinks to the
# surviving slice (kill-survivors -> unreserve-dead-slice ->
# replace-shrunken), and when slice capacity returns the manager's
# regrow phase widens back to declared width (kill-shrunken ->
# unreserve-shrunken -> replace-full).  THREE incarnations (old /
# shrunken / full) share one fabric and one ledger, so the
# gang-recovery invariants quantify over all of them:
#
#   no-split-brain-multislice   no older incarnation's process is
#                               alive while a newer incarnation's
#                               task runs (shrink AND regrow edges)
#   no-double-slice-reservation two incarnations never hold committed
#                               claims simultaneously
#
# The production manager synthesizes the regrow phase only once a
# fresh slice registers; the model pre-builds both phases and gates
# the regrow's first action (and the full-width launch) on the
# ``slice-capacity-returns`` world event instead.  The
# ``regrow_skips_kill`` knob exists ONLY for the seeded-bug fixture
# in test_lint_gate: a regrow that relaunches the declared width
# without first killing + unreserving the shrunken gang is caught by
# both invariants with a minimal trace.


class MultiSliceRecoveryWorld:
    """Non-plan model state for the multislice-recovery config."""

    # survivors of the OLD full-width incarnation on the live slice,
    # and the shrunken replacement's width.  2 x 2 x six steps across
    # two serial phases x the capacity bit lands ~40k states — well
    # past the 10k repo-gate bar, untruncated under its 120k cap.
    # Per-step interrupt verbs are OFF for this configuration (the
    # phase/plan interrupts stay in the alphabet): six steps double
    # six times and the space blows through the cap.
    N_OLD = 2
    N_SHRUNK = 2

    def __init__(self, replace_shrunk, replace_full):
        self.replace_shrunk = replace_shrunk
        self.replace_full = replace_full
        self.old_alive = frozenset(range(self.N_OLD))
        self.shrunk_alive: frozenset = frozenset()
        self.old_reserved = True
        self.shrunk_reserved = False
        self.full_reserved = False
        self.capacity = False
        # set once the regrow choreography arms: the production
        # manager REPLACES the shrink phase with the regrow phase in
        # its phase map, so the shrink replace step cannot relaunch
        # afterwards — the model keeps both phases alive and fences
        # the stale launch path with this bit instead
        self.regrow_begun = False
        self.launch_overrides = {
            replace_shrunk.name: self._launch_shrunk,
            replace_full.name: self._launch_full,
        }
        self._plan: Optional[Plan] = None

    def bind(self, plan: Plan) -> "MultiSliceRecoveryWorld":
        self._plan = plan
        return self

    # -- snapshot protocol -------------------------------------------

    def snapshot(self) -> tuple:
        return (
            self.old_alive, self.shrunk_alive, self.old_reserved,
            self.shrunk_reserved, self.full_reserved, self.capacity,
            self.regrow_begun,
        )

    def restore(self, snap: tuple) -> None:
        (self.old_alive, self.shrunk_alive, self.old_reserved,
         self.shrunk_reserved, self.full_reserved, self.capacity,
         self.regrow_begun) = snap

    # -- model events -------------------------------------------------

    def events(self, harness: "PlanHarness"):
        out = []
        for i in range(self.N_OLD):
            # a surviving old worker dies at ANY point: kill ack or a
            # second preemption landing mid-recovery (the storm case)
            out.append((
                f"old-task-dies({i})",
                lambda i=i: self._die_old(i),
            ))
        for i in range(self.N_SHRUNK):
            # a shrunken worker dies mid-regrow — the kill step's ack,
            # or the surviving slice getting reclaimed too
            out.append((
                f"shrunk-task-dies({i})",
                lambda i=i: self._die_shrunk(i),
            ))
        out.append((
            "slice-capacity-returns", self._capacity_returns,
        ))
        return out

    def _die_old(self, i: int) -> None:
        self.old_alive = self.old_alive - {i}

    def _die_shrunk(self, i: int) -> None:
        self.shrunk_alive = self.shrunk_alive - {i}

    def _capacity_returns(self) -> None:
        self.capacity = True

    def _launch_shrunk(self) -> None:
        step = self.replace_shrunk
        if step not in self._plan.candidates(set()):
            return
        # placement feasibility the model MUST keep: the shrunken
        # gang targets the surviving slice, and an offer cycle
        # declines while another incarnation's claims sit on those
        # chips — without this, an operator restart of the completed
        # shrink step after regrow would "place" over the full gang
        if self.old_reserved or self.full_reserved:
            return
        if self.regrow_begun:
            return  # the manager swapped phases: this step is stale
        requirement = step.start()
        if requirement is None:
            return
        self.shrunk_reserved = True
        # a (re)launch is a fresh set of shrunken processes
        self.shrunk_alive = frozenset(range(self.N_SHRUNK))
        step.record_launch({
            task: f"{task}__{_LIVE}"
            for task in requirement.task_names()
        })

    def _launch_full(self) -> None:
        step = self.replace_full
        if step not in self._plan.candidates(set()):
            return
        if not self.capacity:
            return  # no fresh slice registered: the offer declines
        # deliberately NO claim-feasibility guard here (mirroring
        # GangRecoveryWorld's launch): the invariant certifies the
        # PLAN orders unreserve-shrunken before replace-full — the
        # choreography must not lean on evaluator feasibility to
        # avoid the double-commit
        requirement = step.start()
        if requirement is None:
            return
        self.full_reserved = True
        step.record_launch({
            task: f"{task}__{_LIVE}"
            for task in requirement.task_names()
        })

    # -- model actions (close over self; ActionStep passes None) ------

    def kill_old_survivors(self, _scheduler) -> bool:
        return not self.old_alive

    def unreserve_dead_slice(self, _scheduler) -> bool:
        self.old_reserved = False
        return True

    def kill_shrunken_gang(self, _scheduler) -> bool:
        # the regrow choreography arms only once a fresh slice
        # registers (the manager's capacity probe), then completes
        # when nothing shrunken is left running
        if not self.capacity:
            return False
        self.regrow_begun = True
        return not self.shrunk_alive

    def unreserve_shrunken_claims(self, _scheduler) -> bool:
        self.shrunk_reserved = False
        return True

    # -- invariants ----------------------------------------------------

    def invariants(self) -> List["Invariant"]:
        return [NoSplitBrainMultiSlice(), NoDoubleSliceReservation()]


class NoSplitBrainMultiSlice(Invariant):
    """No older incarnation's process survives while a newer
    incarnation's task runs: old-vs-shrunken is the wedged-collective
    guarantee from the single-slice configuration, and
    shrunken-vs-full is the regrow edge — the widened gang re-forms
    the dcn ring over the surviving slice's chips, so a leftover
    shrunken worker there fights the full gang for its own fabric."""

    name = "no-split-brain-multislice"

    def on_state(self, harness):
        world = harness.world
        hazards = (
            (world.old_alive, world.replace_shrunk, "old"),
            (world.old_alive, world.replace_full, "old"),
            (world.shrunk_alive, world.replace_full, "shrunken"),
        )
        for ghosts, step, label in hazards:
            if not ghosts:
                continue
            running = [
                task for task, state in step._task_states.items()
                if state is TaskState.RUNNING
            ]
            if running:
                return (
                    f"{label} incarnation processes {sorted(ghosts)} "
                    f"still alive while {step.name} runs "
                    f"{sorted(running)}"
                )
        return None


class NoDoubleSliceReservation(Invariant):
    """At most one gang incarnation holds committed claims: the
    shrink must release the dead span's rows before the shrunken
    commit, and the regrow must release the shrunken rows before the
    full-width commit — overlap double-counts the surviving slice's
    chips in the ledger."""

    name = "no-double-slice-reservation"

    def on_state(self, harness):
        world = harness.world
        holders = [
            label for label, held in (
                ("old", world.old_reserved),
                ("shrunken", world.shrunk_reserved),
                ("full", world.full_reserved),
            ) if held
        ]
        if len(holders) > 1:
            return (
                f"incarnations {holders} hold committed reservations "
                "simultaneously"
            )
        return None


def _multislice_recovery_plan(regrow_skips_kill: bool = False):
    from dcos_commons_tpu_torch.plan.strategy import SerialStrategy as _Serial

    # the gang declares 2 slices x 2 hosts; the shrunken incarnation
    # is the surviving slice's pair (instances 0/1) and the regrown
    # full width relaunches EVERYTHING — the model tracks ONE
    # fresh-slice worker (instance 2) for the full step so the two
    # incarnations' status alphabets stay disjoint (production reuses
    # names with fresh task ids; the model's __live suffix cannot
    # carry that distinction) and the state space clears the repo
    # gate untruncated; the hazards quantify over ANY running full
    # task, so one representative is enough
    shrunk_pod = PodSpec(
        type="trainer",
        count=2,
        gang=True,
        tasks=[TaskSpec(name="worker", goal=GoalState.RUNNING,
                        cmd="train")],
    )
    full_pod = PodSpec(
        type="trainer",
        count=4,
        gang=True,
        tasks=[TaskSpec(name="worker", goal=GoalState.RUNNING,
                        cmd="train")],
    )
    replace_shrunk = DeploymentStep(
        "replace-shrunken-gang",
        PodInstanceRequirement(pod=shrunk_pod, instances=[0, 1]),
        backoff=ModelBackoff(),
    )
    replace_full = DeploymentStep(
        "replace-full-gang",
        PodInstanceRequirement(pod=full_pod, instances=[2]),
        backoff=ModelBackoff(),
    )
    kill_old = ActionStep("kill-old-survivors", lambda s: False)
    unreserve_old = ActionStep("unreserve-dead-slice", lambda s: False)
    kill_shrunk = ActionStep("kill-shrunken-gang", lambda s: False)
    unreserve_shrunk = ActionStep(
        "unreserve-shrunken-gang", lambda s: False
    )
    world = MultiSliceRecoveryWorld(replace_shrunk, replace_full)
    kill_old._action = world.kill_old_survivors
    unreserve_old._action = world.unreserve_dead_slice
    kill_shrunk._action = world.kill_shrunken_gang
    unreserve_shrunk._action = world.unreserve_shrunken_claims
    shrink = Phase(
        "shrink-to-surviving-slice",
        [kill_old, unreserve_old, replace_shrunk],
        _Serial(),
    )
    regrow_steps = [replace_full] if regrow_skips_kill else [
        kill_shrunk, unreserve_shrunk, replace_full,
    ]
    regrow = Phase(
        "regrow-to-declared-width", regrow_steps, _Serial()
    )
    plan = Plan("recovery", [shrink, regrow], _Serial())
    world.bind(plan)
    return plan, world


def _multislice_recovery_plan_strict():
    return _multislice_recovery_plan()


# -- the autoscale configuration --------------------------------------
#
# Models the closed health->action loop's no-flap algebra with the
# REAL plan objects AND the REAL decision functions
# (health/actions.py decide() / remediation_allowed() — not a
# transcription): three scale actions (two successive scale-outs and
# a scale-in, so the cooldown latch between same-direction actions is
# reachable) plus a remediation flag, driven by breach/cooldown
# toggles, a deterministic governor tick, and a settle event that
# starts cooldown clocks at every terminal action state.  Arming is
# gated by the WORLD (action callables return False and the launch
# override no-ops while unarmed), so the whole operator-verb alphabet
# stays live without a per-phase interrupt blow-up.  Verified
# invariants (the no-flap contract):
#
#   no-opposite-concurrent   a scale-out and a scale-in are never
#                            armed simultaneously (single flight)
#   cooldown-honored         no same-direction action arms while its
#                            direction's cooldown latch is set
#   no-remediation-storm     remediation never arms while any scale
#                            action is armed (at most one eviction
#                            per service at a time)
#
# The ``honor_cooldown`` / ``single_flight`` knobs exist ONLY for the
# seeded-flap fixture in test_lint_gate: a governor that skips either
# check is caught with a minimal trace.

_NOW = 1_000.0


class AutoscaleWorld:
    """Non-plan model state for the autoscale configuration."""

    DIRECTION = {
        "scale-out-a": "out",
        "scale-out-b": "out",
        "scale-in-a": "in",
    }

    def __init__(self, actions: Dict[str, List],
                 honor_cooldown: bool = True,
                 single_flight: bool = True):
        from dcos_commons_tpu_torch.health.actions import ActionPolicy

        # action name -> its steps (all must complete to settle)
        self.actions = actions
        self.honor_cooldown = honor_cooldown
        self.single_flight = single_flight
        self.policy = ActionPolicy(
            autoscale=True, breach_hold_s=0.0, quiet_hold_s=0.0,
            max_instances=4, cooldown_out_s=60.0, cooldown_in_s=60.0,
        )
        self.breach = False
        self.quiet = False
        self.cool_out = False
        self.cool_in = False
        self.replace_active = False
        self.armed: frozenset = frozenset()
        # set (only reachable with broken knobs) when remediation
        # armed while a scale action was armed — the storm marker
        self.storm = False
        self.launch_overrides = {}
        for name, steps in actions.items():
            for step in steps:
                if isinstance(step, ActionStep):
                    step._action = self._gated_action(name)
                else:
                    self.launch_overrides[step.name] = \
                        self._gated_launch(name, step)
        self._plan: Optional[Plan] = None

    def bind(self, plan: Plan) -> "AutoscaleWorld":
        self._plan = plan
        return self

    # -- snapshot protocol -------------------------------------------

    def snapshot(self) -> tuple:
        return (self.breach, self.quiet, self.cool_out, self.cool_in,
                self.replace_active, self.armed, self.storm)

    def restore(self, snap: tuple) -> None:
        (self.breach, self.quiet, self.cool_out, self.cool_in,
         self.replace_active, self.armed, self.storm) = snap

    # -- arming gates --------------------------------------------------

    def _gated_action(self, name: str):
        def action(_scheduler) -> bool:
            # the engine only has steps for ARMED actions; here the
            # phase is pre-built, so unarmed steps simply make no
            # progress (stay PENDING)
            return name in self.armed
        return action

    def _gated_launch(self, name: str, step: DeploymentStep):
        def launch() -> None:
            if name not in self.armed:
                return
            if step not in self._plan.candidates(set()):
                return
            requirement = step.start()
            if requirement is None:
                return
            step.record_launch({
                task: f"{task}__{_LIVE}"
                for task in requirement.task_names()
            })
        return launch

    def _steps_complete(self, name: str) -> bool:
        return all(s.get_status().is_complete for s in self.actions[name])

    # -- model events -------------------------------------------------

    def events(self, harness: "PlanHarness"):
        return [
            ("breach-start", lambda: self._set_breach(True)),
            ("breach-end", lambda: self._set_breach(False)),
            ("quiet-start", lambda: self._set_quiet(True)),
            ("quiet-end", lambda: self._set_quiet(False)),
            ("cooldown-out-expires", lambda: self._expire("out")),
            ("cooldown-in-expires", lambda: self._expire("in")),
            ("governor-tick", self._tick),
            ("settle", self._settle),
            ("replace-done", self._replace_done),
        ]

    def _set_breach(self, value: bool) -> None:
        self.breach = value

    def _set_quiet(self, value: bool) -> None:
        self.quiet = value

    def _expire(self, direction: str) -> None:
        if direction == "out":
            self.cool_out = False
        else:
            self.cool_in = False

    def _replace_done(self) -> None:
        self.replace_active = False

    def _tick(self) -> None:
        """One governor pass: applies the REAL decide() /
        remediation_allowed() (with the knob-degraded inputs a broken
        governor would pass) and arms at most one action."""
        from dcos_commons_tpu_torch.health.actions import (
            decide,
            remediation_allowed,
        )

        active_dirs = {self.DIRECTION[n] for n in self.armed}
        active = (
            sorted(active_dirs)[0]
            if active_dirs and self.single_flight else None
        )
        far = _FAR_FUTURE
        for name in ("scale-out-a", "scale-out-b", "scale-in-a"):
            if name in self.armed or self._steps_complete(name):
                continue
            decision = decide(
                _NOW,
                policy=self.policy,
                count=2,
                baseline=1,
                breach_since=0.0 if self.breach else None,
                severity=4.0,
                quiet_since=0.0 if self.quiet else None,
                active=active,
                hold=False,
                cooldown_out_until=(
                    far if (self.cool_out and self.honor_cooldown)
                    else 0.0
                ),
                cooldown_in_until=(
                    far if (self.cool_in and self.honor_cooldown)
                    else 0.0
                ),
            )
            if decision is not None and \
                    decision.direction == self.DIRECTION[name]:
                self.armed = self.armed | {name}
                return
        if not self.replace_active and remediation_allowed(
            _NOW,
            enabled=True,
            scale_active=bool(self.armed) and self.single_flight,
            hold=False,
            last_replace_t=None,
            cooldown_s=0.0,
        ):
            if self.armed:
                self.storm = True  # only reachable with broken knobs
            self.replace_active = True

    def _settle(self) -> None:
        """Terminal action states start their direction's cooldown
        clock and disarm — the engine's _settle, every terminal state
        counted (natural completion and operator force-complete
        alike)."""
        for name in sorted(self.armed):
            if not self._steps_complete(name):
                continue
            self.armed = self.armed - {name}
            if self.DIRECTION[name] == "out":
                self.cool_out = True
            else:
                self.cool_in = True

    # -- invariants ----------------------------------------------------

    def invariants(self) -> List["Invariant"]:
        return [NoOppositeConcurrent(), CooldownHonored(),
                NoRemediationStorm()]


class NoOppositeConcurrent(Invariant):
    """A scale-out and a scale-in never run concurrently: the pair
    would thrash capacity (the scale-in killing what the scale-out
    just deployed) — the definition of flapping."""

    name = "no-opposite-concurrent"

    def on_state(self, harness):
        world = harness.world
        dirs = {world.DIRECTION[n] for n in world.armed}
        if "out" in dirs and "in" in dirs:
            return (
                f"opposite-direction actions armed concurrently: "
                f"{sorted(world.armed)}"
            )
        return None


class CooldownHonored(Invariant):
    """No same-direction action is armed while that direction's
    cooldown latch (set at every terminal action state) is still
    set: settle disarms atomically with latching, so the overlap is
    reachable only through a governor that skipped the cooldown
    check."""

    name = "cooldown-honored"

    def on_state(self, harness):
        world = harness.world
        for name in sorted(world.armed):
            direction = world.DIRECTION[name]
            cooling = (
                world.cool_out if direction == "out" else world.cool_in
            )
            if cooling:
                return (
                    f"{name} armed while the {direction}-direction "
                    "cooldown is still latched"
                )
        return None


class NoRemediationStorm(Invariant):
    """Remediation never arms while a scale action is armed: an
    automated eviction racing an automated resize is the storm the
    single-flight rule exists to prevent (at most one automated
    eviction per service at a time)."""

    name = "no-remediation-storm"

    def on_state(self, harness):
        if harness.world.storm:
            return (
                "remediation armed while a scale action was in "
                f"flight ({sorted(harness.world.armed)})"
            )
        return None


def _autoscale_plan(honor_cooldown: bool = True,
                    single_flight: bool = True):
    grow_a = ActionStep("grow-serve-to-3", lambda s: False)
    deploy_a = DeploymentStep(
        "deploy-serve-2",
        PodInstanceRequirement(pod=_pod("serve", readiness=True),
                               instances=[2]),
        backoff=ModelBackoff(),
    )
    grow_b = ActionStep("grow-serve-to-4", lambda s: False)
    shrink = ActionStep("shrink-serve-to-1", lambda s: False)
    world = AutoscaleWorld(
        {
            "scale-out-a": [grow_a, deploy_a],
            "scale-out-b": [grow_b],
            "scale-in-a": [shrink],
        },
        honor_cooldown=honor_cooldown,
        single_flight=single_flight,
    )
    phase = Phase(
        "autoscale-serve", [grow_a, deploy_a, grow_b, shrink],
        ParallelStrategy(),
    )
    plan = Plan("autoscale", [phase], ParallelStrategy())
    world.bind(plan)
    return plan, world


def _autoscale_plan_strict():
    return _autoscale_plan()


# -- the migration configuration --------------------------------------
#
# Models serve/migration.py's fenced cutover protocol (freeze ->
# stream/splice -> cutover -> release) as four ActionSteps under
# SerialStrategy over a world of the two pods' session facts: where
# the session's row is live (source serving / frozen / released,
# destination none / spliced / active), with operator abort and
# either pod dying as world events at EVERY protocol state.  The
# protocol's two one-way doors are what the search certifies:
#
#   no-double-serve   the source row never serves while an ACTIVATED
#                     destination copy is alive (cutover is final —
#                     abort must refuse after it; a resumed source
#                     plus an active dest would decode the session
#                     twice and fork the token stream)
#   no-token-loss     the source row is only retired once the
#                     destination copy is ACTIVATED (release before
#                     the activate ack — or after an abort/dest
#                     death — discards the only copy mid-generation)
#
# Pod deaths are availability loss, not protocol loss: a session on
# a dying pod dies with it exactly as it would without migration, so
# death alone never fires no-token-loss; the invariant fires only
# when the PROTOCOL retires the surviving copy.  Actions complete
# vacuously once their work is moot (abort honored, pod dead), so
# the plan always terminates and the livelock check stays sound.
#
# The ``abort_after_cutover`` / ``release_before_activate`` knobs
# exist ONLY for the seeded fixtures in test_lint_gate: a protocol
# that honors an abort after activation, or retires the source on
# splice success instead of the activate ack, is caught with a
# minimal trace.


class MigrationWorld:
    """Non-plan model state for the migration configuration."""

    def __init__(self, freeze_step, stream_step, cutover_step,
                 release_step,
                 abort_after_cutover: bool = False,
                 release_before_activate: bool = False):
        self.freeze_step = freeze_step
        self.stream_step = stream_step
        self.cutover_step = cutover_step
        self.release_step = release_step
        self.abort_after_cutover = abort_after_cutover
        self.release_before_activate = release_before_activate
        self.source_alive = True
        self.dest_alive = True
        self.source_state = "serving"   # serving | frozen | released
        self.dest_state = "none"        # none | spliced | active
        self.aborted = False
        # set when a protocol action discards the session's only
        # copy (retires the source with no activated destination) —
        # reachable only with broken knobs
        self.lost = False
        self.launch_overrides: Dict[str, Callable[[], None]] = {}
        self._plan: Optional[Plan] = None

    def bind(self, plan: Plan) -> "MigrationWorld":
        self._plan = plan
        return self

    # -- snapshot protocol -------------------------------------------

    def snapshot(self) -> tuple:
        return (self.source_alive, self.dest_alive, self.source_state,
                self.dest_state, self.aborted, self.lost)

    def restore(self, snap: tuple) -> None:
        (self.source_alive, self.dest_alive, self.source_state,
         self.dest_state, self.aborted, self.lost) = snap

    # -- model events -------------------------------------------------

    def events(self, harness: "PlanHarness"):
        # all three may land at ANY protocol state — that coverage is
        # the point of the configuration
        return [
            ("operator-abort", self._op_abort),
            ("source-pod-dies", self._source_dies),
            ("dest-pod-dies", self._dest_dies),
        ]

    def _op_abort(self) -> None:
        self.aborted = True
        if self.abort_after_cutover and self.source_alive \
                and self.source_state == "frozen":
            # SEEDED BUG: the abort handler unfreezes the source
            # without checking whether the destination already
            # activated — post-cutover this forks the stream
            self.source_state = "serving"

    def _source_dies(self) -> None:
        self.source_alive = False

    def _dest_dies(self) -> None:
        if not self.dest_alive:
            return
        self.dest_alive = False
        # its spliced pages / activation die with the pod
        self.dest_state = "none"

    def _resume_source(self) -> None:
        """Pre-cutover failure path: retire any splice, unfreeze the
        source.  NEVER past activation — cutover is a one-way door."""
        if self.dest_state == "active":
            return
        if self.dest_state == "spliced":
            self.dest_state = "none"  # abort_splice at the dest
        if self.source_alive and self.source_state == "frozen":
            self.source_state = "serving"

    # -- model actions (close over self; ActionStep passes None) ------

    def do_freeze(self, _scheduler) -> bool:
        if self.aborted or not self.source_alive \
                or self.source_state != "serving":
            return True  # moot: nothing to fence
        self.source_state = "frozen"
        return True

    def do_stream(self, _scheduler) -> bool:
        if self.dest_state != "none":
            return True  # already streamed
        if self.aborted or not self.source_alive \
                or not self.dest_alive or self.source_state != "frozen":
            self._resume_source()
            return True
        self.dest_state = "spliced"
        return True

    def do_cutover(self, _scheduler) -> bool:
        if self.dest_state == "active":
            return True  # already activated
        if self.release_before_activate and self.source_alive \
                and self.source_state == "frozen" \
                and self.dest_state == "spliced":
            # SEEDED BUG: retire the source row on splice success,
            # before the activate ack lands
            self.source_state = "released"
            if self.aborted or not self.dest_alive:
                self.dest_state = "none"
                self.lost = True
            else:
                self.dest_state = "active"
            return True
        if self.aborted or not self.dest_alive \
                or self.dest_state != "spliced":
            self._resume_source()
            return True
        self.dest_state = "active"
        return True

    def do_release(self, _scheduler) -> bool:
        if not self.source_alive or self.source_state != "frozen":
            return True  # nothing to retire
        if self.dest_state != "active":
            # activation never landed (abort, dest death): the only
            # legal continuation is keeping the source copy — the
            # ``aborted`` flag is deliberately NOT consulted here,
            # because post-cutover the move is final
            self._resume_source()
            return True
        self.source_state = "released"
        return True

    # -- invariants ----------------------------------------------------

    def invariants(self) -> List["Invariant"]:
        return [NoDoubleServe(), NoTokenLoss()]


class NoDoubleServe(Invariant):
    """The source row never serves while an activated destination
    copy is alive: both would decode the same session and the token
    streams fork — the exactly-once cutover contract."""

    name = "no-double-serve"

    def on_state(self, harness):
        world = harness.world
        if (world.source_alive and world.source_state == "serving"
                and world.dest_alive and world.dest_state == "active"):
            return (
                "source row serving while the activated destination "
                "copy is alive (the session decodes twice)"
            )
        return None


class NoTokenLoss(Invariant):
    """The source row is only retired once the destination copy is
    ACTIVATED: releasing against anything weaker (splice success, an
    abort, a dead dest) discards the session's only copy."""

    name = "no-token-loss"

    def on_state(self, harness):
        if harness.world.lost:
            return (
                "source row retired with no activated destination "
                "copy (mid-generation tokens discarded)"
            )
        return None


def _migration_plan(abort_after_cutover: bool = False,
                    release_before_activate: bool = False):
    freeze = ActionStep("freeze-session", lambda s: False)
    stream = ActionStep("stream-pages", lambda s: False)
    cutover = ActionStep("cutover-dest", lambda s: False)
    release = ActionStep("release-source", lambda s: False)
    world = MigrationWorld(
        freeze, stream, cutover, release,
        abort_after_cutover=abort_after_cutover,
        release_before_activate=release_before_activate,
    )
    freeze._action = world.do_freeze
    stream._action = world.do_stream
    cutover._action = world.do_cutover
    release._action = world.do_release
    phase = Phase(
        "migrate-session", [freeze, stream, cutover, release],
        SerialStrategy(),
    )
    plan = Plan("migration", [phase], SerialStrategy())
    world.bind(plan)
    return plan, world


def _migration_plan_strict():
    return _migration_plan()


# name -> (factory, step_interrupts): per-step interrupt verbs only
# where the extra state-space doubling buys new interleavings.
# ``gang-recovery``'s, ``autoscale``'s and ``migration``'s factories
# return (plan, world) — the checker folds the world's state into
# dedup snapshots and its events into the alphabet.
BUILTIN_CONFIGS: Dict[str, Tuple[Callable[[], Plan], bool]] = {
    "serial-2phase": (_serial_plan, False),
    "parallel": (_parallel_plan, True),
    "dependency-dag": (_dependency_plan, False),
    "canary": (_canary_plan, True),
    "gang-recovery": (_gang_recovery_plan, True),
    "multislice-recovery": (_multislice_recovery_plan_strict, False),
    "autoscale": (_autoscale_plan_strict, False),
    "migration": (_migration_plan_strict, True),
}


@dataclass
class PlanCheckSummary:
    results: List[CheckResult]

    @property
    def states_explored(self) -> int:
        return sum(r.states for r in self.results)

    @property
    def transitions(self) -> int:
        return sum(r.transitions for r in self.results)

    @property
    def violations(self) -> List[Violation]:
        return [v for r in self.results for v in r.violations]

    @property
    def ok(self) -> bool:
        return not self.violations

    def render(self) -> str:
        lines = []
        for r in self.results:
            flag = "" if not r.truncated else " (TRUNCATED)"
            lines.append(
                f"  {r.config}: {r.states} states, {r.transitions} "
                f"transitions, {r.complete_states} complete, "
                f"{len(r.violations)} violation(s){flag}"
            )
        for v in self.violations:
            lines.append(v.render())
        return "\n".join(lines)


def check_all(
    max_states: int = 200_000,
    configs: Optional[
        Dict[str, Tuple[Callable[[], Plan], bool]]
    ] = None,
) -> PlanCheckSummary:
    """Run every built-in configuration; the CI gate entry point."""
    results = []
    for name, (factory, step_interrupts) in (
        configs or BUILTIN_CONFIGS
    ).items():
        results.append(check_plan(
            factory, max_states=max_states, config_name=name,
            step_interrupts=step_interrupts,
        ))
    return PlanCheckSummary(results)

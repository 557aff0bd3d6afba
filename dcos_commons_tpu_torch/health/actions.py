"""The closed health->action loop: SLO autoscaling + remediation.

The detectors (health/detectors.py) are advisory, and the monitor's
``auto_replace`` gate is only the minimal straggler->replace seam.
This module turns verdicts into ACTIONS — and makes the actions
themselves safe to automate:

  scale-out    a serving SLO breach episode (TTFT p95 / queue depth /
               KV-pages-free, the gauges each serve pod already
               exports) that persists past the hysteresis hold
               synthesizes a plan that raises the pod's instance
               count and deploys the new instances through the
               NORMAL offer cycle (WAL, reservations, discipline).
  scale-in     a sustained quiet-pod episode (the low-watermark
               ``QuietPodWatcher`` over the same gauges) synthesizes
               a decommission-shaped teardown riding the
               DecommissionPlanFactory's kill+unreserve+erase steps,
               with the /v1/endpoints surface flipping
               ``draining:true`` and a router drain-grace elapsing
               BEFORE the kill step fires.
  remediation  the auto-replace seam, grown general: a
               confirmed straggler episode triggers at most one
               audited pod replace per episode, preferring gang
               members (whose whole slice the straggler drags) and —
               under the ``remediation`` policy gate — any pod on
               the suspect host.

Flap-proofing is structural, not best-effort:

  * hysteresis: a breach must HOLD for ``breach_hold_s`` (quiet for
    ``quiet_hold_s``) before any action; the quiet watermark sits at
    ``quiet_factor`` x the breach threshold, so a signal parked
    between the two bands never triggers anything in either
    direction (the band cannot oscillate on a constant signal).
  * per-direction cooldowns: after EVERY terminal plan state the
    direction's cooldown clock starts; no same-direction action
    fires inside it.
  * single flight: one action per pod at a time, no scale-down while
    a scale-up is in flight (and vice versa), no remediation while
    any scale plan for the service is active.  Bounded concurrent
    growth ACROSS services is the multi scheduler's existing
    OfferDiscipline: a scale-out plan makes the service "growing",
    so ``ParallelFootprintDiscipline`` bounds how many grow at once.
  * flap hold: while a lease-churn episode is open (flapping
    leadership), every automated action is suspended — a control
    plane trading its own lease must not also be resizing the fleet.

Every action RIDES THE PLAN ENGINE: one ``autoscale`` plan whose
phases are interruptible/resumable/force-completable through the
ordinary plan verbs, journaled as ``kind=health`` events
(trace-correlated to the triggering episode's task/signal/value),
and failover-safe — action latches and cooldown clocks are seeded
from the REPLAYED event journal exactly like ``LeaseChurnWatcher``,
so a successor neither re-fires a completed action nor forgets an
in-flight one (steps are idempotent and deployment steps re-seed
COMPLETE from the state store).

Layering invariant (enforced by the ``health-plan-only`` sdklint
rule): nothing in this module writes the ledger or state store
directly.  Mutation happens only through factory-built plan steps
(plan/builders.py, decommission/factory.py) and journaled scheduler
verbs (``set_pod_count``, ``restart_pod``).

Port of ``dcos_commons_tpu/health/actions.py``, line for line but the imports.
``scale_out_target`` keeps the reference's clamp to ``max_instances``
also where that is below the current count.
"""

from __future__ import annotations

import math
import re
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from dcos_commons_tpu_torch.plan.phase import Phase
from dcos_commons_tpu_torch.plan.plan import Plan
from dcos_commons_tpu_torch.plan.plan_manager import PlanManager
from dcos_commons_tpu_torch.plan.step import ActionStep, Step
from dcos_commons_tpu_torch.plan.strategy import ParallelStrategy, SerialStrategy

AUTOSCALE_PLAN_NAME = "autoscale"
# state-store property prefix for the durable desired-count override
# (written by the set_pod_count VERB, read back by SchedulerBuilder so
# a failover/restart rebuilds the deploy plan at the scaled width)
COUNT_PROPERTY_PREFIX = "autoscale-count-"


@dataclass(frozen=True)
class ActionPolicy:
    """Knobs of the automated loop.  Both action families default OFF
    — automated resizing/eviction is an operator decision."""

    autoscale: bool = False
    remediation: bool = False
    max_instances: int = 4
    # cap how many instances one scale-out action may add
    scale_step_max: int = 2
    # hysteresis holds: how long an episode must persist before acting
    breach_hold_s: float = 10.0
    quiet_hold_s: float = 60.0
    # the quiet low watermark sits at quiet_factor x the breach
    # threshold (QuietPodWatcher) — the dead band between the two
    # is what makes a constant signal flap-proof
    quiet_factor: float = 0.25
    # per-direction cooldowns, started at EVERY terminal plan state
    cooldown_out_s: float = 60.0
    cooldown_in_s: float = 300.0
    # router drain grace between the endpoints draining flip and the
    # scale-in kill step
    drain_grace_s: float = 5.0
    # drain-with-migration (serve/migration.py): at drain start, ask
    # the scale-in victim to MOVE its live sessions to the surviving
    # peers — the grace then covers router awareness only, not whole
    # generations, and the eventual kill cuts nothing off.  Best
    # effort: a pod without the migrate surface rides the grace
    # exactly as before
    drain_migrate: bool = True
    remediation_cooldown_s: float = 300.0


@dataclass(frozen=True)
class Decision:
    direction: str  # "out" | "in"
    target: int


def scale_out_target(
    count: int, max_instances: int, severity: float, step_max: int = 2
) -> int:
    """Target instance count for a breach of magnitude ``severity``
    (value/threshold; >= 1).  MONOTONE in severity by construction:
    the step is floor(log2(severity)) + 1, clamped to
    [1, step_max] — a 2x breach adds up to 2 instances, a marginal
    one adds 1 — and the target is clamped to ``max_instances``
    (hypothesis-tested in test_health_actions)."""
    sev = max(1.0, float(severity))
    step = max(1, min(int(step_max), int(math.floor(math.log2(sev))) + 1))
    return min(int(max_instances), int(count) + step)


def decide(
    now: float,
    *,
    policy: ActionPolicy,
    count: int,
    baseline: int,
    breach_since: Optional[float] = None,
    severity: float = 1.0,
    quiet_since: Optional[float] = None,
    active: Optional[str] = None,
    hold: bool = False,
    cooldown_out_until: float = 0.0,
    cooldown_in_until: float = 0.0,
) -> Optional[Decision]:
    """The PURE autoscale decision rule (the hypothesis properties in
    test_health_actions and the plancheck autoscale config both drive
    THIS function, not a transcription of it).

    Precedence: an open breach episode always dominates quiet (the
    two cannot emit opposite directions from one state); ``active``
    (an in-flight action on this pod) and ``hold`` (open lease-churn
    episode) suppress everything — the single-flight and flap-hold
    rules live here so every caller inherits them."""
    if not policy.autoscale or hold or active is not None:
        return None
    if breach_since is not None:
        if now - breach_since < policy.breach_hold_s:
            return None
        if now < cooldown_out_until:
            return None
        target = scale_out_target(
            count, policy.max_instances, severity, policy.scale_step_max
        )
        if target > count:
            return Decision("out", target)
        return None
    if quiet_since is not None and count > baseline:
        if now - quiet_since < policy.quiet_hold_s:
            return None
        if now < cooldown_in_until:
            return None
        return Decision("in", count - 1)
    return None


def remediation_allowed(
    now: float,
    *,
    enabled: bool,
    scale_active: bool,
    hold: bool,
    last_replace_t: Optional[float],
    cooldown_s: float,
) -> bool:
    """Gate for the auto-replace seam: never while a scale plan for
    the service is in flight (a remediation racing its own scale-out
    is exactly the storm the plancheck no-storm invariant forbids),
    never during a lease-churn flap hold, and rate-limited by its own
    cooldown so a detector wobble cannot evict pod after pod."""
    if not enabled or scale_active or hold:
        return False
    if last_replace_t is not None and now - last_replace_t < cooldown_s:
        return False
    return True


def seed_latches(
    events: List[dict],
) -> Tuple[Dict[str, dict], Dict[Tuple[str, str], float], Optional[float]]:
    """Fold replayed ``kind=health`` journal events into the
    governor's durable state: still-in-flight actions (a ``start``
    without a later terminal event), per-(pod, direction) last
    terminal times (the cooldown clocks), and the last auto-replace
    time.

    PERMUTATION-INVARIANT over the input list: events are folded in
    journal-sequence order (``seq``), so any shuffling of the same
    event set seeds identical latches — the property the failover
    contract needs and the hypothesis test pins."""
    in_flight: Dict[str, dict] = {}
    done_t: Dict[Tuple[str, str], float] = {}
    last_replace: Optional[float] = None
    for event in sorted(events, key=lambda e: e.get("seq", 0)):
        verb = event.get("verb")
        if verb in ("scale-out", "scale-in"):
            pod = str(event.get("pod", ""))
            direction = "out" if verb == "scale-out" else "in"
            stage = event.get("stage")
            if stage == "start":
                try:
                    in_flight[pod] = {
                        "direction": direction,
                        "from": int(event.get("from", 0)),
                        "to": int(event.get("to", 0)),
                        "t": float(event.get("t", 0.0)),
                    }
                except (TypeError, ValueError):
                    continue
            elif stage in ("complete", "abandoned"):
                in_flight.pop(pod, None)
                key = (pod, direction)
                done_t[key] = max(
                    done_t.get(key, 0.0), float(event.get("t", 0.0))
                )
        elif verb == "auto-replace":
            last_replace = max(
                last_replace or 0.0, float(event.get("t", 0.0))
            )
    return in_flight, done_t, last_replace


class ActionPlanManager(PlanManager):
    """Owns the dynamic ``autoscale`` plan: one phase per pod with an
    in-flight action (single flight makes "per pod" and "per action"
    the same thing), phases for different pods progressing in
    parallel.  Pruning is the engine's job (``_settle``) — a
    completed phase must be journaled and its cooldown clock started
    before it disappears."""

    def __init__(self):
        self._phases: Dict[str, Phase] = {}
        self._plan = Plan(AUTOSCALE_PLAN_NAME, [], ParallelStrategy())

    def get_plan(self) -> Plan:
        self._plan.phases = list(self._phases.values())
        return self._plan

    def get_candidates(self, dirty_assets: Set[str]) -> List[Step]:
        return self.get_plan().candidates(dirty_assets)

    def update(self, status) -> None:
        for phase in list(self._phases.values()):
            phase.update(status)

    def phase_for(self, pod_type: str) -> Optional[Phase]:
        return self._phases.get(pod_type)

    def add(self, pod_type: str, phase: Phase) -> None:
        self._phases[pod_type] = phase

    def remove(self, pod_type: str) -> None:
        self._phases.pop(pod_type, None)


class HealthActionEngine:
    """The governor: consumes detector episodes (via the
    HealthMonitor's watchers), applies :func:`decide`, synthesizes
    action phases, settles terminal ones, and carries the latches.

    Thread discipline: every entry point is called either from the
    cycle thread inside ``run_cycle`` (monitor.observe) or from an
    HTTP verb that holds the scheduler lock (``scale_pod``), so the
    engine itself needs no lock of its own."""

    def __init__(self, policy: Optional[ActionPolicy] = None,
                 clock=time.time):
        self.policy = policy or ActionPolicy()
        self.manager = ActionPlanManager()
        # pod type -> the YAML instance count (the scale-in floor);
        # set by the builder, defaulted lazily from the live spec
        self.baselines: Dict[str, int] = {}
        # launch backoff for scale-out deployment steps (set by the
        # builder alongside baselines): a crash-looping scale-out
        # instance must back off exactly like a deploy-plan instance,
        # not hot-retry every cycle.  None = DisabledBackoff.
        self.backoff = None
        self._clock = clock
        self._seeded = False
        # (pod, direction) -> last terminal time (cooldown clocks)
        self._done_t: Dict[Tuple[str, str], float] = {}
        self._last_replace_t: Optional[float] = None
        # hosts already remediated this episode (cleared event re-arms)
        self._replaced_hosts: Set[str] = set()
        self.actions_started = 0

    # -- failover seeding --------------------------------------------

    def seed(self, scheduler) -> None:
        """Replay the journal's ``kind=health`` events once per
        incarnation: cooldown clocks resume, and a still-in-flight
        action's plan is RE-SYNTHESIZED — its steps are idempotent
        and its deployment steps seed COMPLETE from the state store,
        so a successor resumes exactly where the deposed leader
        stopped instead of re-firing or forgetting."""
        if self._seeded:
            return
        self._seeded = True
        in_flight, self._done_t, self._last_replace_t = seed_latches(
            scheduler.journal.events(kinds=("health",))
        )
        from dcos_commons_tpu_torch.specification.specs import SpecError

        for pod_type, latch in in_flight.items():
            try:
                pod = scheduler.spec.pod(pod_type)
            except SpecError:
                continue  # pod dropped from the spec since the event
            if self.manager.phase_for(pod_type) is not None:
                continue
            if latch["direction"] == "out":
                self._synthesize_out(
                    scheduler, pod, latch["from"], latch["to"]
                )
            else:
                self._synthesize_in(
                    scheduler, pod, latch["from"], latch["to"]
                )

    def _baseline(self, scheduler, pod_type: str) -> int:
        if pod_type not in self.baselines:
            from dcos_commons_tpu_torch.specification.specs import SpecError

            try:
                self.baselines[pod_type] = scheduler.spec.pod(
                    pod_type
                ).count
            except SpecError:
                self.baselines[pod_type] = 1
        return self.baselines[pod_type]

    # -- the per-observe pass ----------------------------------------

    def observe(self, scheduler, monitor,
                now: Optional[float] = None) -> List[dict]:
        """One governor pass, called by HealthMonitor after the
        detectors scored.  Returns the journaled action events (the
        engine appends them itself — they are alerts and deserve the
        monitor's inline flush)."""
        now = self._clock() if now is None else now
        self.seed(scheduler)
        events = self._settle(scheduler, now)
        if not self.policy.autoscale:
            return events
        hold = bool(getattr(monitor.lease_churn, "alerted", False))
        for pod in scheduler.spec.pods:
            if pod.gang:
                # a gang pod's count is its mesh width, not a replica
                # count — gang serving scales by adding services, and
                # elastic re-slicing (recovery/elastic.py) owns width
                continue
            signal = self._pod_signal(scheduler, pod, monitor)
            if signal is None:
                continue
            breach_since, severity, quiet_since, trigger = signal
            active_phase = self.manager.phase_for(pod.type)
            active = (
                getattr(active_phase, "autoscale_direction", "out")
                if active_phase is not None else None
            )
            baseline = self._baseline(scheduler, pod.type)
            decision = decide(
                now,
                policy=self.policy,
                count=pod.count,
                baseline=baseline,
                breach_since=breach_since,
                severity=severity,
                quiet_since=quiet_since,
                active=active,
                hold=hold,
                cooldown_out_until=self._cooldown_until(pod.type, "out"),
                cooldown_in_until=self._cooldown_until(pod.type, "in"),
            )
            if decision is not None:
                events.append(self._start(
                    scheduler, pod, decision, now, trigger
                ))
        return events

    def _cooldown_until(self, pod_type: str, direction: str) -> float:
        done = self._done_t.get((pod_type, direction))
        if done is None:
            return 0.0
        window = (
            self.policy.cooldown_out_s if direction == "out"
            else self.policy.cooldown_in_s
        )
        return done + window

    @staticmethod
    def _task_owner(spec, task_name: str):
        """(pod_type, index) owning ``task_name`` by LONGEST-type
        match — a bare ``^<type>-(\\d+)-`` prefix test would hand pod
        ``web`` the tasks of a sibling pod named ``web-2`` (task
        names embed the type, and types may themselves end in a
        numeric segment)."""
        best = None
        for p in spec.pods:
            match = re.match(
                rf"^{re.escape(p.type)}-(\d+)-", task_name
            )
            if match and (best is None or len(p.type) > len(best[0])):
                best = (p.type, int(match.group(1)))
        return best

    def _pod_signal(self, scheduler, pod, monitor):
        """(breach_since, severity, quiet_since, trigger attrs) for
        one pod off the watcher state, or None when no serving task
        of the pod has ever reported (non-serving pods never
        autoscale).  Quiet requires EVERY live instance quiet — a
        pod with one idle and one loaded instance is load-imbalanced,
        not over-provisioned."""
        spec = scheduler.spec
        breach_since: Optional[float] = None
        severity = 1.0
        trigger: dict = {}
        for (task, sig), since in sorted(
            getattr(monitor.slo, "breach_since", {}).items()
        ):
            owner = self._task_owner(spec, task)
            if owner is None or owner[0] != pod.type:
                continue
            mag = monitor.slo.breach_severity.get((task, sig), 1.0)
            if breach_since is None or since < breach_since:
                breach_since = since
            if mag >= severity:
                severity = mag
                trigger = {
                    "task": task, "signal": sig,
                    "value": monitor.slo.breaches.get((task, sig)),
                }
        quiet_since: Optional[float] = None
        owned = {
            task: owner[1]
            for task in monitor.serving_stats
            for owner in [self._task_owner(spec, task)]
            if owner is not None and owner[0] == pod.type
        }
        if not owned and breach_since is None:
            return None
        if breach_since is None and owned:
            quiet = monitor.quiet.quiet_since
            if set(range(pod.count)) <= set(owned.values()) and all(
                t in quiet for t in owned
            ):
                quiet_since = max(quiet[t] for t in owned)
        return breach_since, severity, quiet_since, trigger

    # -- starting actions --------------------------------------------

    def _start(self, scheduler, pod, decision: Decision, now: float,
               trigger: dict) -> dict:
        from_count = pod.count
        if decision.direction == "out":
            self._synthesize_out(
                scheduler, pod, from_count, decision.target
            )
        else:
            self._synthesize_in(
                scheduler, pod, from_count, decision.target
            )
        self.actions_started += 1
        verb = "scale-out" if decision.direction == "out" else "scale-in"
        event = scheduler.journal.append(
            "health",
            verb=verb,
            stage="start",
            pod=pod.type,
            to=decision.target,
            t=now,
            message=(
                f"{verb} {pod.type}: {from_count} -> {decision.target} "
                + ("(SLO breach episode)" if decision.direction == "out"
                   else "(sustained quiet episode)")
            ),
            **{"from": from_count},
            **{k: v for k, v in trigger.items() if v is not None},
        )
        scheduler.metrics.incr(f"health.actions.{verb}")
        scheduler.nudge()  # the new plan work is pending NOW
        return event

    def request_scale(self, scheduler, pod_type: str,
                      target: int) -> Phase:
        """Operator-initiated scale (POST /v1/pod/<type>/scale):
        rides the exact same plan machinery — and the same
        single-flight rule — as the automated loop, skipping only the
        hysteresis holds (the operator IS the hysteresis).  Caller
        holds the scheduler lock.

        Settles terminal phases FIRST: with the health plane disabled
        (NullHealthMonitor) nothing else ever calls _settle, and a
        completed-but-unsettled phase would hold the single-flight
        latch against every future manual scale forever."""
        self.seed(scheduler)
        self._settle(scheduler, self._clock())
        pod = scheduler.spec.pod(pod_type)
        if pod.gang:
            raise ValueError(
                f"pod {pod_type!r} is a gang (count is its mesh "
                "width); elastic re-slicing owns gang width"
            )
        target = int(target)
        if target < 1:
            raise ValueError("count must be >= 1")
        baseline = self._baseline(scheduler, pod_type)
        if target < baseline:
            # the persisted-count overlay clamps to the YAML count on
            # every rebuild, so a below-floor scale would silently
            # undo itself at the next restart — refuse loudly instead
            raise ValueError(
                f"count {target} is below the YAML floor {baseline}; "
                "lower the pod's count in the service spec "
                "(allow-decommission) to shrink past it"
            )
        if self.manager.phase_for(pod_type) is not None:
            raise RuntimeError(
                f"a scale action for {pod_type!r} is already in "
                "flight (single-flight; interrupt it via the "
                "autoscale plan verbs first)"
            )
        if target == pod.count:
            raise ValueError(f"{pod_type} already has {target} instance(s)")
        now = self._clock()
        direction = "out" if target > pod.count else "in"
        if direction == "in" and target != pod.count - 1:
            # scale-in steps one instance at a time (highest index
            # first, the decommission discipline); repeat to go lower
            raise ValueError(
                f"scale-in proceeds one instance at a time "
                f"(ask for {pod.count - 1})"
            )
        self._start(
            scheduler, pod, Decision(direction, target), now,
            {"source": "operator"},
        )
        return self.manager.phase_for(pod_type)

    # -- plan synthesis ----------------------------------------------

    def _target_config_id(self, scheduler) -> str:
        store = getattr(scheduler, "config_store", None)
        if store is not None:
            target = store.get_target_config()
            if target:
                return target
        return getattr(scheduler.evaluator, "target_config_id", "")

    def _synthesize_out(self, scheduler, pod, from_count: int,
                        to_count: int) -> Phase:
        """grow (count verb) -> one deployment step per new instance,
        serial.  Idempotent for the failover re-synthesis: the grow
        verb no-ops at the target count and deployment steps seed
        COMPLETE from the state store for already-launched
        instances."""
        import dataclasses

        from dcos_commons_tpu_torch.plan.builders import build_instance_steps

        pod_type = pod.type

        def grow(s) -> bool:
            s.set_pod_count(pod_type, to_count, source="autoscale")
            return True

        scaled = dataclasses.replace(pod, count=to_count)
        steps: List[Step] = [
            ActionStep(f"grow-{pod_type}-to-{to_count}", grow)
        ]
        steps += build_instance_steps(
            scaled,
            list(range(from_count, to_count)),
            scheduler.state_store,
            self._target_config_id(scheduler),
            backoff=self.backoff,
        )
        phase = Phase(
            f"scale-out-{pod_type}-{to_count}", steps, SerialStrategy()
        )
        phase.autoscale_direction = "out"
        phase.pod_type = pod_type
        phase.from_count = from_count
        phase.to_count = to_count
        self.manager.add(pod_type, phase)
        return phase

    def _synthesize_in(self, scheduler, pod, from_count: int,
                       to_count: int) -> Phase:
        """shrink (count verb) -> drain grace -> the decommission
        factory's kill+unreserve+erase, serial.  The shrink runs
        FIRST so the recovery scan stops owning the victim before
        anything dies; the phase's ``decommission_targets`` flips the
        victim's /v1/endpoints rows to ``draining:true`` from the
        moment the phase exists, and the drain step holds the kill
        until the router grace elapsed.  Across a failover the drain
        clock restarts from zero — conservative, never shorter."""
        from dcos_commons_tpu_torch.decommission.factory import (
            build_scale_in_phase,
        )

        pod_type = pod.type

        def shrink(s) -> bool:
            s.set_pod_count(pod_type, to_count, source="autoscale")
            return True

        drain_started: List[float] = []
        victim_index = from_count - 1

        def drain(s) -> bool:
            if not drain_started:
                drain_started.append(self._clock())
                if self.policy.drain_migrate:
                    # move the victim's live sessions to surviving
                    # peers NOW, so the grace below covers router
                    # awareness — not whole generations — and the
                    # kill step cuts nothing off (serve/migration.py)
                    self._migrate_victim_sessions(
                        s, pod_type, victim_index, to_count
                    )
                return False
            return (
                self._clock() - drain_started[0]
                >= self.policy.drain_grace_s
            )

        phase = build_scale_in_phase(
            pod, from_count - 1,
            shrink_action=shrink,
            drain_action=drain,
            to_count=to_count,
        )
        phase.autoscale_direction = "in"
        phase.pod_type = pod_type
        phase.from_count = from_count
        phase.to_count = to_count
        self.manager.add(pod_type, phase)
        return phase

    def _migrate_victim_sessions(
        self, scheduler, pod_type: str, victim_index: int,
        to_count: int,
    ) -> None:
        """Best-effort drain-with-migration: POST the victim's serve
        worker a one-shot drain verb naming the SURVIVING instances
        as destinations (the serve worker's /migrate).  Any
        failure — no serving stats, no dialable peers, a pod built
        before the migrate surface — leaves the legacy wait-out drain
        in charge; this never blocks or fails the scale-in plan."""
        import json as _json
        import urllib.request

        try:
            serving = self._serving_addresses(scheduler, pod_type)
            victim = serving.get(victim_index)
            dests = {
                f"{pod_type}-{idx}": addr
                for idx, addr in serving.items()
                if idx < to_count
            }
            if victim is None or not dests:
                return
            req = urllib.request.Request(
                f"http://{victim}/migrate",
                data=_json.dumps(
                    {"verb": "drain", "dests": dests}
                ).encode("utf-8"),
                headers={"Content-Type": "application/json"},
                method="POST",
            )
            with urllib.request.urlopen(req, timeout=120.0) as resp:
                report = _json.loads(resp.read().decode("utf-8"))
            rows = report.get("report") or []
            moved = sum(1 for r in rows if r.get("ok"))
            scheduler.journal.append(
                "health",
                verb="scale-in",
                stage="migrate",
                pod=pod_type,
                message=(
                    f"scale-in drain migrated {moved}/{len(rows)} "
                    f"live session(s) off {pod_type}-{victim_index}"
                ),
            )
        except Exception as e:  # noqa: BLE001 — best-effort by contract
            try:
                scheduler.journal.append(
                    "health",
                    verb="scale-in",
                    stage="migrate",
                    pod=pod_type,
                    message=(
                        f"scale-in drain of {pod_type}-{victim_index} "
                        f"fell back to wait-out: {e}"
                    ),
                )
            except Exception:  # noqa: BLE001, sdklint: disable=swallowed-exception — journaling a fallback must not break the drain step
                pass

    def _serving_addresses(
        self, scheduler, pod_type: str
    ) -> Dict[int, str]:
        """pod index -> dialable address for every instance of
        ``pod_type`` whose sandbox mirrors serving stats with an
        http_port annotation (the same advertised-port contract
        /v1/endpoints reads)."""
        reader = getattr(scheduler.agent, "serving_stats_of", None)
        if not callable(reader):
            return {}
        hosts = {
            h.host_id: h for h in scheduler.inventory.hosts()
        }
        out: Dict[int, str] = {}
        for info in scheduler.state_store.fetch_tasks():
            if info.pod_type != pod_type:
                continue
            try:
                stats = reader(info.name)
            except OSError:
                continue
            port = (stats or {}).get("http_port")
            if not port:
                continue
            host = hosts.get(info.agent_id)
            hostname = host.hostname if host else "127.0.0.1"
            out[info.pod_index] = f"{hostname}:{int(port)}"
        return out

    # -- settling ----------------------------------------------------

    def _settle(self, scheduler, now: float) -> List[dict]:
        """Journal terminal phases and start their cooldown clocks.
        EVERY terminal state counts — natural completion, operator
        force-complete — per the no-flap contract (the cooldown is
        what stands between a wobbling signal and an action storm).
        Errored/interrupted phases stay put for the operator (plan
        verbs are the exits); the single-flight rule holds while they
        do."""
        out: List[dict] = []
        for pod_type, phase in list(self.manager._phases.items()):
            if not phase.is_complete:
                continue
            direction = getattr(phase, "autoscale_direction", "out")
            self._done_t[(pod_type, direction)] = now
            self.manager.remove(pod_type)
            verb = "scale-out" if direction == "out" else "scale-in"
            event = scheduler.journal.append(
                "health",
                verb=verb,
                stage="complete",
                pod=pod_type,
                to=getattr(phase, "to_count", None),
                t=now,
                message=(
                    f"{verb} {pod_type} complete at "
                    f"{getattr(phase, 'to_count', '?')} instance(s); "
                    f"{direction}-cooldown started"
                ),
                **{"from": getattr(phase, "from_count", None)},
            )
            scheduler.metrics.incr(f"health.actions.{verb}_complete")
            out.append(event)
        return out

    def abandon(self, scheduler, pod_type: str) -> bool:
        """Operator bail-out (DELETE semantics): drop an in-flight
        action's phase without completing it.  Journaled as
        ``abandoned`` — which is a terminal state, so the cooldown
        clock starts (an operator abandoning a flap must not re-arm
        it instantly).  The persisted count is RECONCILED to deployed
        reality (the longest contiguous instance prefix that actually
        exists within the action's [from, to] range): an abandoned
        half-deployed scale-out must not leave a wider count behind
        that the next restart's overlay would silently resume, and an
        abandoned scale-in whose victim still runs takes the victim
        back into the spec."""
        # settle first (mirrors request_scale): with the health plane
        # disabled a COMPLETED phase must settle as complete, never
        # be "abandoned" with a false journal stage
        self._settle(scheduler, self._clock())
        phase = self.manager.phase_for(pod_type)
        if phase is None:
            return False
        now = self._clock()
        direction = getattr(phase, "autoscale_direction", "out")
        self._done_t[(pod_type, direction)] = now
        self.manager.remove(pod_type)
        from_count = getattr(phase, "from_count", None)
        to_count = getattr(phase, "to_count", None)
        settled_count = None
        if from_count is not None and to_count is not None:
            from dcos_commons_tpu_torch.specification.specs import (
                SpecError,
                task_full_name,
            )

            try:
                pod = scheduler.spec.pod(pod_type)
            except SpecError:
                pod = None
            if pod is not None:
                lo = min(from_count, to_count)
                hi = max(from_count, to_count)
                settled_count = lo
                for index in range(lo, hi):
                    if any(
                        scheduler.state_store.fetch_task(
                            task_full_name(pod_type, index, t.name)
                        ) is not None
                        for t in pod.tasks
                    ):
                        settled_count = index + 1
                    else:
                        break
                scheduler.set_pod_count(
                    pod_type, settled_count, source="autoscale"
                )
        verb = "scale-out" if direction == "out" else "scale-in"
        scheduler.journal.append(
            "health", verb=verb, stage="abandoned", pod=pod_type,
            to=to_count, t=now, settled=settled_count,
            message=f"{verb} {pod_type} abandoned by operator"
            + (f" (count settled at {settled_count})"
               if settled_count is not None else ""),
        )
        scheduler.nudge()
        return True

    # -- remediation (the grown auto-replace seam) --------------------

    def remediate(self, scheduler, events: List[dict],
                  enabled: bool,
                  now: Optional[float] = None,
                  hold: bool = False) -> List[dict]:
        """Act on this pass's straggler episode edges: at most ONE
        audited replace per pass, per-host episode latch re-armed by
        the episode's cleared event, suppressed entirely while any
        scale plan is active or leadership is flapping.  Gang members
        are preferred (the straggler drags its whole slice); under
        the ``remediation`` policy gate any pod instance on the host
        qualifies.  The replace rides ``restart_pod(replace=True)``
        -> the recovery plan — operator-interruptible like every
        plan, and the re-place prefers non-suspect hosts because
        suspects sort last in placement scan order."""
        now = self._clock() if now is None else now
        for event in events:
            if event.get("detector") == "straggler" and \
                    event.get("cleared"):
                self._replaced_hosts.discard(event.get("host"))
        # the flap hold is the caller-passed STATEFUL episode flag
        # (monitor.lease_churn.alerted) — the churn alert event fires
        # only on the episode's opening edge, so an events-only check
        # would hold for exactly one pass of a multi-pass episode
        churn = hold or any(
            e.get("detector") == "lease-churn" and not e.get("cleared")
            for e in events
        )
        if not remediation_allowed(
            now,
            enabled=enabled,
            scale_active=bool(self.manager._phases),
            hold=churn,
            last_replace_t=self._last_replace_t,
            cooldown_s=self.policy.remediation_cooldown_s,
        ):
            return []
        out: List[dict] = []
        for event in events:
            if event.get("detector") != "straggler" or \
                    event.get("cleared"):
                continue
            host = event.get("host")
            if host in self._replaced_hosts:
                continue
            target = self._pod_on(scheduler, host)
            if target is None:
                continue
            pod_type, index = target
            # latch AFTER the replace succeeds: a transient store
            # error inside restart_pod must not consume the episode's
            # one allowed action with neither a replace nor an audit
            killed = scheduler.restart_pod(pod_type, index, replace=True)
            self._replaced_hosts.add(host)
            self._last_replace_t = now
            action = {
                "kind": "health",
                "verb": "auto-replace",
                "host": host,
                "pod": f"{pod_type}-{index}",
                "tasks": len(killed),
                "t": now,
                "message": (
                    f"auto-replace: confirmed straggler {host} carries "
                    f"{pod_type}-{index}; replacing onto a non-suspect "
                    "host (suspects sort last in placement)"
                ),
            }
            scheduler.journal.append(
                "health",
                message=action["message"],
                **{k: v for k, v in action.items()
                   if k not in ("kind", "message")},
            )
            scheduler.metrics.incr("health.auto_replace")
            out.append(action)
            break  # at most one automated replace per pass
        return out

    def _pod_on(self, scheduler, host):
        """(pod_type, index) of the remediation target on ``host``:
        a gang member when one runs there (the auto-replace seam's
        target, always eligible once it is enabled), else — only under the
        general ``remediation`` policy gate — any pod instance on
        the host."""
        gang_types = {p.type for p in scheduler.spec.pods if p.gang}
        fallback = None
        for info in scheduler.state_store.fetch_tasks():
            if info.agent_id != host:
                continue
            if info.pod_type in gang_types:
                return (info.pod_type, info.pod_index)
            if fallback is None:
                fallback = (info.pod_type, info.pod_index)
        if self.policy.remediation:
            return fallback
        return None

    # -- the /v1/debug/health block -----------------------------------

    def describe(self) -> dict:
        active = {}
        for pod_type, phase in self.manager._phases.items():
            active[pod_type] = {
                "direction": getattr(phase, "autoscale_direction", "?"),
                "from": getattr(phase, "from_count", None),
                "to": getattr(phase, "to_count", None),
                "phase": phase.name,
                "status": phase.get_status().value,
            }
        return {
            "enabled": self.policy.autoscale,
            "remediation": self.policy.remediation,
            "active": active,
            "cooldowns": {
                f"{pod}:{direction}": round(t, 3)
                for (pod, direction), t in sorted(self._done_t.items())
            },
            "last_replace_t": self._last_replace_t,
            "actions_started": self.actions_started,
            "baselines": dict(self.baselines),
        }

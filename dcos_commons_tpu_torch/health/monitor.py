"""HealthMonitor: the per-scheduler health plane driver.

Owned by ``DefaultScheduler`` and called at the end of every
``run_cycle``.  One ``observe()`` pass:

  * samples the metric registry into its bounded history rings
    (time-throttled: ``history_interval_s``),
  * fans in worker telemetry — steplogs and serving gauges — through
    the agent's sandbox readers (time-throttled:
    ``telemetry_interval_s``; the reads are one file open or HTTP
    round trip PER TASK, so production collection runs on a
    background thread and the cycle never blocks on a slow daemon;
    ``telemetry_interval_s=0`` collects inline for deterministic
    tests/benches),
  * runs the detectors (straggler, serving SLO, lease churn) once per
    COMPLETED collection,
  * pushes the suspect-host set into the inventory as the soft
    placement signal (suspect hosts sort LAST in scan order —
    superset-sound, placement never excludes a host on a score),
  * journals detector alerts and flushes the journal if dirty.

A broken detector degrades to a counted error
(``health.observe_errors``), never a failed scheduler cycle.

Port of ``dcos_commons_tpu/health/monitor.py``, line for line but the imports.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from dcos_commons_tpu_torch.health.detectors import (
    LeaseChurnWatcher,
    QuietPodWatcher,
    ServingSloWatcher,
    StragglerDetector,
)
from dcos_commons_tpu_torch.health.journal import EventJournal


class NullHealthMonitor:
    """The disabled plane (``health_enabled=False`` / the bench's
    disabled arm): every scheduler-facing surface exists and costs
    nothing."""

    def __init__(self):
        self.journal = EventJournal(backend=None, capacity=0)
        self.observe_errors = 0

    def attach(self, scheduler) -> "NullHealthMonitor":
        return self

    def observe(self, scheduler, now=None) -> list:
        return []

    def describe(self, scheduler, metric=None) -> dict:
        return {"enabled": False}


class HealthMonitor:
    def __init__(
        self,
        journal: Optional[EventJournal] = None,
        straggler: Optional[StragglerDetector] = None,
        slo: Optional[ServingSloWatcher] = None,
        lease_churn: Optional[LeaseChurnWatcher] = None,
        quiet: Optional[QuietPodWatcher] = None,
        interval_s: float = 0.0,
        telemetry_interval_s: float = 5.0,
        history_interval_s: float = 1.0,
        flush_interval_s: float = 1.0,
        auto_replace: bool = False,
        quiet_factor: float = 0.25,
    ):
        self.journal = journal or EventJournal(backend=None)
        self.straggler = straggler or StragglerDetector()
        self.slo = slo or ServingSloWatcher()
        self.lease_churn = lease_churn or LeaseChurnWatcher()
        # the scale-in low-watermark detector shares the SLO watcher's
        # threshold resolution (the two hysteresis bands must never
        # drift apart)
        self.quiet = quiet or QuietPodWatcher(
            self.slo, quiet_factor=quiet_factor
        )
        # detector cadence: 0 = every observe() call (tests, bench
        # worst case); production default rides the cycle rate
        self.interval_s = float(interval_s)
        # sandbox/wire fan-in cadence: steplog + servestats reads are
        # file opens per task (or HTTP round trips on a remote fleet)
        self.telemetry_interval_s = float(telemetry_interval_s)
        self.history_interval_s = float(history_interval_s)
        # journal flush cadence for cycle-batched events (plan
        # transitions): a flush serializes the whole bounded deque, so
        # per-dirty-cycle flushing is O(events) per cycle on a busy
        # deploy.  Alerts force an immediate flush, and operator verbs
        # flush inline at the HTTP layer — only routine transition
        # batching rides this clock (bounded-loss contract: a crash
        # forfeits at most flush_interval_s of transition events)
        self.flush_interval_s = float(flush_interval_s)
        # health -> action seam, DEFAULT OFF.  The logic lives in the
        # scheduler-owned HealthActionEngine (health/actions.py) —
        # this flag is the legacy gate that enables the
        # straggler auto-replace path even when the full action
        # policy is off; the engine also honors its own
        # ``policy.remediation`` gate.
        self.auto_replace = bool(auto_replace)
        self.observe_errors = 0
        self._last_observe = 0.0
        self._last_telemetry = 0.0
        self._last_history = 0.0
        self._last_flush = 0.0
        self._churn_seeded = False
        # completed-collection counter vs last-scored counter: the
        # detectors run exactly once per finished fan-in, whether it
        # ran inline (interval 0) or on the background thread
        self._telemetry_seq = 0
        self._scored_seq = 0
        # publication lock for the completed-collection snapshot: the
        # background collector swaps the three dicts + bumps the seq
        # under it, the scoring pass grabs the seq and dict REFERENCES
        # under it (the dicts themselves are replaced wholesale, never
        # mutated in place, so readers hold a consistent snapshot
        # lock-free once they have the references)
        self._telemetry_lock = threading.Lock()
        self._telemetry_thread: Optional[threading.Thread] = None
        # one steplog series per task, grouped by host (list of
        # record-lists — the straggler window applies per series)
        self._steplogs_by_host: Dict[str, List[List[dict]]] = {}
        self._serving_stats: Dict[str, dict] = {}
        self._serving_env: Dict[str, Dict[str, str]] = {}
        self._alerts = 0

    # -- wiring -------------------------------------------------------

    def attach(self, scheduler) -> "HealthMonitor":
        """Register the health.* gauges on a freshly-built scheduler."""
        metrics = scheduler.metrics
        metrics.gauge(
            "health.suspect_hosts",
            lambda: float(len(self.straggler.suspects)),
        )
        metrics.gauge(
            "health.straggler.max_score",
            lambda: float(max(self.straggler.scores.values(), default=0.0)),
        )
        metrics.gauge(
            "health.slo.breaches",
            lambda: float(len(self.slo.breaches)),
        )
        metrics.gauge(
            "health.journal.seq",
            lambda: float(self.journal.last_seq),
        )
        return self

    # -- the per-cycle pass -------------------------------------------

    def observe(self, scheduler, now: Optional[float] = None) -> List[dict]:
        """One health pass; returns the events journaled.  Never
        raises: the scheduler cycle must not die of its telemetry."""
        try:
            return self._observe(scheduler, now)
        except Exception:
            with self._telemetry_lock:
                self.observe_errors += 1
            scheduler.metrics.incr("health.observe_errors")
            return []

    def _observe(self, scheduler, now: Optional[float]) -> List[dict]:
        now = time.time() if now is None else now
        if self.interval_s and now - self._last_observe < self.interval_s:
            return []
        self._last_observe = now
        if not self.history_interval_s or \
                now - self._last_history >= self.history_interval_s:
            self._last_history = now
            scheduler.metrics.sample_history(t=now)
        telemetry_due = not self.telemetry_interval_s or \
            now - self._last_telemetry >= self.telemetry_interval_s
        if telemetry_due:
            self._last_telemetry = now
            if not self.telemetry_interval_s:
                # deterministic inline mode (tests, bench worst case)
                self._collect_telemetry(scheduler)
            elif self._telemetry_thread is None or \
                    not self._telemetry_thread.is_alive():
                # production: the fan-in is one blocking sandbox read
                # (or HTTP round trip, on a remote fleet) PER TASK —
                # serially inside run_cycle, one slow daemon would
                # stall every scheduler cycle, so collection runs off
                # the cycle thread and detectors score the completed
                # snapshot on a later cycle
                thread = threading.Thread(
                    target=self._collect_background,
                    args=(scheduler,),
                    name="health-telemetry",
                    daemon=True,
                )
                self._telemetry_thread = thread
                thread.start()
        events = []
        # steplog/servestats detectors re-score only when a collection
        # COMPLETED since the last scoring pass: identical cached
        # telemetry yields identical verdicts, and the median-ratio
        # pass over a big fleet's windows is the expensive part
        with self._telemetry_lock:
            telemetry_seq = self._telemetry_seq
            steplogs_by_host = self._steplogs_by_host
            serving_stats = self._serving_stats
            serving_env = self._serving_env
        if telemetry_seq != self._scored_seq:
            self._scored_seq = telemetry_seq
            events += self.straggler.observe(steplogs_by_host)
            self._push_suspects(scheduler)
            events += self.slo.observe(
                serving_stats, serving_env, now=now
            )
            events += self.quiet.observe(
                serving_stats, serving_env, now=now
            )
        ha_state = getattr(scheduler, "ha_state", None)
        lease = getattr(ha_state, "lease", None)
        # the persisted-record probe below is a store read — ride the
        # telemetry cadence rather than every cycle (the epoch moves
        # at most once per failover; a remote store would otherwise
        # pay an HTTP read per busy-poll cycle)
        if lease is not None and telemetry_due:
            # the local LeaderLease epoch is CONSTANT for this
            # incarnation's lifetime (losing the lease restarts the
            # process), so flapping is only visible across
            # incarnations: seed the watcher from the journaled
            # election events (the journal survives failover), then
            # watch the PERSISTED record's epoch — it moves when any
            # scheduler takes over
            if not self._churn_seeded:
                self._churn_seeded = True
                for event in self.journal.events(kinds=("election",)):
                    epoch = event.get("epoch")
                    if isinstance(epoch, (int, float)):
                        events += self.lease_churn.observe(
                            int(epoch), t=float(event.get("t", now))
                        )
            events += self.lease_churn.observe(
                lease.state().epoch, t=now
            )
        for event in events:
            attrs = {
                k: v for k, v in event.items()
                if k not in ("kind", "message")
            }
            self.journal.append(
                event.get("kind", "alert"),
                message=event.get("message", ""),
                **attrs,
            )
            self._alerts += 1
            scheduler.metrics.incr("health.alerts")
        # the action governor (health/actions.py): settle terminal
        # action phases, apply the autoscale decision rule against
        # this pass's episode state, and run the remediation seam on
        # this pass's straggler edges.  The engine journals its own
        # events (they are alerts: inline durability below).
        actions = getattr(scheduler, "actions", None)
        if actions is not None:
            events += actions.observe(scheduler, self, now)
            # one gate expression; remediate() is a cheap no-op when
            # disabled (remediation_allowed re-checks enabled)
            events += actions.remediate(
                scheduler, events,
                self.auto_replace or actions.policy.remediation,
                now,
                # the STATEFUL churn flag: the hold must cover the
                # whole open episode, not just its opening edge
                hold=bool(getattr(self.lease_churn, "alerted", False)),
            )
        # alerts deserve immediate durability; routine transition
        # batches flush on the throttle clock
        if events or not self.flush_interval_s or \
                now - self._last_flush >= self.flush_interval_s:
            self._last_flush = now
            self.journal.flush()
        return events

    @property
    def serving_stats(self):
        """The last completed telemetry snapshot (task -> stats) —
        the action governor's read surface."""
        return self._serving_stats

    def _collect_background(self, scheduler) -> None:
        try:
            self._collect_telemetry(scheduler)
        except Exception:
            with self._telemetry_lock:
                self.observe_errors += 1
            try:
                scheduler.metrics.incr("health.observe_errors")
            except Exception:  # sdklint: disable=swallowed-exception — already inside the error path of a telemetry thread; observe_errors was counted above, and a metrics hiccup must not kill the collector
                pass

    def _collect_telemetry(self, scheduler) -> None:
        read_steplog = getattr(scheduler.agent, "steplog_of", None)
        read_serving = getattr(scheduler.agent, "serving_stats_of", None)
        steplogs: Dict[str, List[List[dict]]] = {}
        serving: Dict[str, dict] = {}
        env_of: Dict[str, Dict[str, str]] = {}
        for info in scheduler.state_store.fetch_tasks():
            if callable(read_steplog):
                try:
                    # agent_id pins the route: on a shared remote
                    # fleet, task names are not service-qualified and
                    # a name-only lookup could read another service's
                    # same-named task
                    records = read_steplog(
                        info.name, agent_id=info.agent_id
                    )
                except OSError:
                    records = []
                if records:
                    # several tasks can share a host (colocated pods):
                    # each task stays its own series so the detector's
                    # trailing window applies per task, never evicting
                    # one colocated task's records with another's
                    steplogs.setdefault(info.agent_id, []).append(records)
            if callable(read_serving):
                try:
                    stats = read_serving(
                        info.name, agent_id=info.agent_id
                    )
                except OSError:
                    stats = {}
                if stats:
                    serving[info.name] = stats
                    env_of[info.name] = info.env
        # publish the completed fan-in atomically: fresh dicts swapped
        # in wholesale (never mutated after this point), seq bumped
        # LAST so a reader seeing the new seq sees the new dicts
        with self._telemetry_lock:
            self._steplogs_by_host = steplogs
            self._serving_stats = serving
            self._serving_env = env_of
            self._telemetry_seq += 1

    def _push_suspects(self, scheduler) -> None:
        setter = getattr(scheduler.inventory, "set_suspect_hosts", None)
        if callable(setter):
            # keyed by service: on a shared multi-service inventory
            # the demotion set is the union across services — this
            # service reporting "no stragglers among MY tasks" must
            # not clear a host another service demoted
            setter(
                set(self.straggler.suspects),
                source=getattr(scheduler.spec, "name", ""),
            )

    # -- the /v1/debug/health body ------------------------------------

    def describe(self, scheduler, metric: Optional[str] = None) -> dict:
        body = {
            "enabled": True,
            "status": "warn" if (
                self.straggler.suspects or self.slo.breaches
            ) else "ok",
            "suspect_hosts": dict(sorted(self.straggler.suspects.items())),
            "straggler": {
                "threshold": self.straggler.threshold,
                "window": self.straggler.window,
                "scores": {
                    host: round(score, 3)
                    for host, score in sorted(self.straggler.scores.items())
                },
            },
            "slo": {
                "breaches": [
                    {"task": task, "signal": signal, "value": value}
                    for (task, signal), value in sorted(
                        self.slo.breaches.items()
                    )
                ],
                # snapshots discarded unscored because their liveness
                # stamps went stale (a wedged pod's last-good gauges)
                "stale_discards": self.slo.stale_discards,
            },
            "quiet": {
                "tasks": {
                    task: round(since, 3)
                    for task, since in sorted(
                        self.quiet.quiet_since.items()
                    )
                },
                "factor": self.quiet.quiet_factor,
            },
            "serving": self._serving_stats,
            "journal": self.journal.describe(),
            "alerts_recent": self.journal.events(kinds=("alert",), limit=20),
            "observe_errors": self.observe_errors,
        }
        actions = getattr(scheduler, "actions", None)
        if actions is not None:
            # the closed-loop state: active scale phases, cooldown
            # clocks, remediation latches (the runbook's first read
            # when triaging an automated action)
            body["actions"] = actions.describe()
            body["actions"]["recent"] = self.journal.events(
                kinds=("health",), limit=20
            )
        history = scheduler.metrics.history
        if metric:
            body["history"] = {
                "metric": metric,
                "samples": [
                    [round(t, 3), v] for t, v in history.series(metric)
                ],
                "rate_per_s": history.rate(metric),
            }
        else:
            body["history"] = history.summary()
        return body

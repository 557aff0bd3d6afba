"""Anomaly detectors: straggler scoring, SLO watchers, lease churn.

Every detector here runs scheduler-side off data the system already
collects — merged worker steplogs (trace/steplog.py), per-pod serving
gauges (serve/engine.py servestats), the ha.* lease state — and emits
into the event journal.  Detection is advisory by contract: a suspect
host is SORTED LAST in placement scan order (superset-sound, never
excluded), and an SLO alert is a journal record, not an action.

Straggler math — median-ratio over a sliding window: each host's
score is the median of its recent per-step OWN time (``wall_s -
blocked_s``: the barrier probe bills gang-imposed waiting to
``blocked_s``, so own time isolates the host's contribution — in a
synchronized gang every host's ``wall_s`` converges to the slowest
host's, which would hide exactly the host we want to find) divided by
the fleet median of those per-host medians.  Medians at both levels
make the score robust: one preempted step doesn't flag a host, and
one slow HOST doesn't shift the fleet baseline it is compared to
(at ≥3 hosts, where the median excludes the outlier by construction).

Port of ``dcos_commons_tpu/health/detectors.py``, line for line but the imports.
"""

from __future__ import annotations

import time
from statistics import median
from typing import Dict, List, Optional

# below this many hosts the fleet median IS (or is dragged by) the
# outlier: scoring 1-2 hosts against themselves only yields noise
MIN_FLEET_FOR_SCORING = 3
# ignore hosts whose own-time median is below this: sub-millisecond
# steps are timer noise, and a ratio of two noise floors flags nothing
# anyone can act on
MIN_OWN_TIME_S = 1e-4


def median_ratio_scores(
    values_by_host: Dict[str, List[float]],
    min_samples: int = 3,
) -> Dict[str, float]:
    """host -> (median of host's values) / (fleet median of those
    medians).  Hosts with fewer than ``min_samples`` values are
    skipped (a freshly-joined host must not be scored off one step);
    {} when fewer than MIN_FLEET_FOR_SCORING hosts qualify.
    Permutation-invariant by construction: medians depend on value
    multisets only, never on dict or list order."""
    per_host: Dict[str, float] = {}
    for host, values in values_by_host.items():
        usable = [v for v in values if v >= 0.0]
        if len(usable) < min_samples:
            continue
        per_host[host] = median(usable)
    if len(per_host) < MIN_FLEET_FOR_SCORING:
        return {}
    fleet = median(per_host.values())
    if fleet < MIN_OWN_TIME_S:
        return {}
    return {host: value / fleet for host, value in per_host.items()}


class StragglerDetector:
    """Scores per-host step own-time from merged steplogs and tracks
    the suspect set with alert edge-triggering.

    ``observe(steplogs_by_host)`` takes {host_id: [steplog records]}
    for one series per host, or {host_id: [[records], [records]]} for
    a host running several tasks (records newest-last either way; the
    trailing ``window`` applies PER SERIES — pooling colocated tasks
    into one flat list would let whichever task was appended last
    evict another task's records entirely, making detection depend on
    task iteration order instead of recency).  Returns the events to
    journal: an ``alert`` when a host's score first crosses
    ``threshold``, and a ``clear`` when a previously-suspect host
    drops back under it — an operator reading the journal sees
    episodes, not one line per cycle.
    """

    def __init__(
        self,
        threshold: float = 2.0,
        window: int = 32,
        min_samples: int = 3,
    ):
        self.threshold = float(threshold)
        self.window = max(1, int(window))
        self.min_samples = max(1, int(min_samples))
        self.scores: Dict[str, float] = {}
        self.suspects: Dict[str, float] = {}

    @staticmethod
    def own_time(record: dict) -> Optional[float]:
        try:
            wall = float(record.get("wall_s", 0.0) or 0.0)
            blocked = float(record.get("blocked_s", 0.0) or 0.0)
        except (TypeError, ValueError):
            return None
        return max(0.0, wall - blocked)

    def observe(
        self, steplogs_by_host: Dict[str, List[dict]]
    ) -> List[dict]:
        values: Dict[str, List[float]] = {}
        for host, records in steplogs_by_host.items():
            series_list = records if records and isinstance(
                records[0], list
            ) else [records]
            owns = []
            for series in series_list:
                for record in series[-self.window:]:
                    own = self.own_time(record)
                    if own is not None:
                        owns.append(own)
            if owns:
                values.setdefault(host, []).extend(owns)
        self.scores = median_ratio_scores(
            values, min_samples=self.min_samples
        )
        now_suspect = {
            host: round(score, 3)
            for host, score in self.scores.items()
            if score >= self.threshold
        }
        events = []
        for host, score in sorted(now_suspect.items()):
            if host not in self.suspects:
                events.append({
                    "kind": "alert",
                    "detector": "straggler",
                    "host": host,
                    "score": score,
                    "threshold": self.threshold,
                    "message": (
                        f"host {host} step own-time is {score}x the "
                        f"fleet median (threshold {self.threshold}x)"
                    ),
                })
        for host in sorted(self.suspects):
            # a host that stopped reporting keeps its suspect mark
            # (silence is not health); only a measured recovery clears
            if host in self.scores and host not in now_suspect:
                events.append({
                    "kind": "alert",
                    "detector": "straggler",
                    "host": host,
                    "score": round(self.scores[host], 3),
                    "cleared": True,
                    "message": f"host {host} back under the straggler "
                               "threshold",
                })
                continue
            if host not in now_suspect:
                now_suspect[host] = self.suspects[host]
        self.suspects = now_suspect
        return events


class ServingSloWatcher:
    """Serving SLO burn off the merged per-task engine gauges.

    Thresholds come from each serving task's own rendered env (the
    options.json serving.* knobs ride the task env contract), falling
    back to the scheduler-level defaults; a threshold of 0 disables
    that check.  Edge-triggered per (task, signal): one alert when the
    breach starts, one clear when it ends.  Signals carry a DIRECTION:
    ``max`` breaches above the threshold (latency, depth, occupancy);
    ``min`` breaches below it — ``kv_pages_free`` is the paged
    engine's memory headroom, and running OUT of pages (503s with a
    kv-page-budget reason) is the breach.

    STALE snapshots are discarded, not scored: a wedged
    pod keeps mirroring its last-good gauges, and judging SLOs off
    them would hold a dead pod "healthy" forever.  A snapshot is
    stale when its engine-liveness stamp (``stats_age_s``: seconds
    since the serve loop last ticked, serve/engine.py) or its
    wall-clock write stamp (``t``) exceeds ``stale_stats_s``.  A
    stale snapshot counts as a MISSED sample: open episodes survive
    ``RETIRE_AFTER_MISSES`` collections (no silent recovery), then
    retire as unmeasurable — the same contract as an absent task.
    """

    SIGNALS = (
        # (signal key in stats, env knob, default attr, direction)
        ("ttft_p95_s", "SERVE_TTFT_SLO_S", "ttft_p95_slo_s", "max"),
        ("queue_depth", "SERVE_QUEUE_DEPTH_SLO", "queue_depth_slo",
         "max"),
        ("kv_occupancy", "SERVE_KV_OCCUPANCY_SLO", "kv_occupancy_slo",
         "max"),
        ("kv_pages_free", "SERVE_KV_PAGES_FREE_SLO",
         "kv_pages_free_slo", "min"),
        ("prefill_chunk_backlog", "SERVE_PREFILL_BACKLOG_SLO",
         "prefill_backlog_slo", "max"),
    )
    # signals that are MEANINGLESS for a serving role and must be
    # neither breached on nor counted as quiet evidence there.  A
    # prefill pod (disaggregation) holds KV pages only for
    # the instants between finishing a prompt and streaming it to a
    # decode pod: its occupancy/headroom gauges sit near their idle
    # values BY DESIGN, and judging it on them would let the quiet
    # watcher scale in a prefill pod that is saturated with prompt
    # work (its real load lives in prefill_chunk_backlog).
    ROLE_EXCLUDED_SIGNALS = {
        "prefill": frozenset({"kv_occupancy", "kv_pages_free"}),
    }
    # consecutive collections a breaching (task, signal) may go
    # unsampled before its episode is dropped as retired
    RETIRE_AFTER_MISSES = 3

    def __init__(
        self,
        ttft_p95_slo_s: float = 0.0,
        queue_depth_slo: float = 0.0,
        kv_occupancy_slo: float = 0.0,
        kv_pages_free_slo: float = 0.0,
        prefill_backlog_slo: float = 0.0,
        stale_stats_s: float = 30.0,
    ):
        self.ttft_p95_slo_s = float(ttft_p95_slo_s)
        self.queue_depth_slo = float(queue_depth_slo)
        self.kv_occupancy_slo = float(kv_occupancy_slo)
        self.kv_pages_free_slo = float(kv_pages_free_slo)
        self.prefill_backlog_slo = float(prefill_backlog_slo)
        # 0 disables the staleness gate (deterministic tests)
        self.stale_stats_s = float(stale_stats_s)
        self.breaches: Dict[tuple, float] = {}  # (task, signal) -> value
        # episode metadata the action governor consumes (health/
        # actions.py): when each open breach STARTED (the hysteresis
        # hold measures against this) and its current magnitude
        # (value/threshold for max-direction signals, threshold/value
        # for min — >= 1, what scale_out_target is monotone in)
        self.breach_since: Dict[tuple, float] = {}
        self.breach_severity: Dict[tuple, float] = {}
        self._missed: Dict[tuple, int] = {}  # consecutive absent samples
        self.stale_discards = 0  # snapshots discarded as stale

    @classmethod
    def _excluded_signals(cls, stats: dict) -> frozenset:
        """The signals this snapshot's serving role opts out of.
        Pods that never report a role ("" / absent → unified) keep
        the full signal set — pre-disaggregation fleets see zero
        behavior change."""
        role = stats.get("serving_role")
        if not isinstance(role, str):
            return frozenset()
        return cls.ROLE_EXCLUDED_SIGNALS.get(role, frozenset())

    def _threshold(self, env: Dict[str, str], knob: str, attr: str) -> float:
        raw = (env or {}).get(knob, "")
        if raw:
            try:
                return float(raw)
            except ValueError:
                pass
        return getattr(self, attr)

    def _is_stale(self, stats: dict, now: float) -> bool:
        """Either liveness stamp past the horizon marks the snapshot
        unusable: ``stats_age_s`` (the pod's own serve loop wedged)
        or ``t`` (the mirror file stopped being rewritten — the
        whole worker is gone but its last file survives)."""
        if self.stale_stats_s <= 0:
            return False
        for key, basis in (("stats_age_s", 0.0), ("t", now)):
            raw = stats.get(key)
            if raw is None:
                continue
            try:
                age = basis - float(raw) if key == "t" else float(raw)
            except (TypeError, ValueError):
                continue
            if age > self.stale_stats_s:
                return True
        return False

    def observe(
        self,
        stats_by_task: Dict[str, dict],
        env_by_task: Optional[Dict[str, Dict[str, str]]] = None,
        now: Optional[float] = None,
    ) -> List[dict]:
        now = time.time() if now is None else now
        events = []
        seen = set()
        for task, stats in sorted(stats_by_task.items()):
            env = (env_by_task or {}).get(task, {})
            if self._is_stale(stats, now):
                # discard, do not score: last-good gauges from a
                # wedged pod look healthy precisely when it is not.
                # The open episodes ride the missed-sample counter.
                self.stale_discards += 1
                continue
            excluded = self._excluded_signals(stats)
            for signal, knob, attr, direction in self.SIGNALS:
                if signal in excluded:
                    continue  # meaningless for this serving role
                threshold = self._threshold(env, knob, attr)
                if threshold <= 0 or signal not in stats:
                    continue
                try:
                    value = float(stats[signal])
                except (TypeError, ValueError):
                    continue
                key = (task, signal)
                seen.add(key)
                breaching = (
                    value < threshold if direction == "min"
                    else value > threshold
                )
                if breaching:
                    tiny = 1e-9
                    self.breach_severity[key] = (
                        threshold / max(value, tiny)
                        if direction == "min"
                        else value / max(threshold, tiny)
                    )
                if breaching and key in self.breaches:
                    # still breaching: no repeat alert, but keep the
                    # CURRENT magnitude — an operator triaging
                    # /v1/debug/health must see the runaway value,
                    # not the marginal first-breach one
                    self.breaches[key] = value
                elif breaching:
                    self.breaches[key] = value
                    self.breach_since[key] = now
                    events.append({
                        "kind": "alert",
                        "detector": "slo",
                        "task": task,
                        "signal": signal,
                        "value": round(value, 4),
                        "threshold": threshold,
                        "message": (
                            f"{task} {signal}={round(value, 4)} breaches "
                            f"SLO {threshold}"
                            + (" (below minimum)"
                               if direction == "min" else "")
                        ),
                    })
                elif not breaching and key in self.breaches:
                    del self.breaches[key]
                    self.breach_since.pop(key, None)
                    self.breach_severity.pop(key, None)
                    recovery = (
                        "back above minimum SLO"
                        if direction == "min" else "back under SLO"
                    )
                    events.append({
                        "kind": "alert",
                        "detector": "slo",
                        "task": task,
                        "signal": signal,
                        "value": round(value, 4),
                        "cleared": True,
                        "message": f"{task} {signal} {recovery}",
                    })
        # a missing sample is not a recovery: one failed collection
        # (a dropped RPC, an idle window omitting a percentile) must
        # neither end an episode silently nor re-alert when the next
        # sample arrives still breaching.  Only a task absent for
        # several consecutive collections (a retired pod) drops its
        # episodes — silently, since nothing was measured.
        for key in list(self.breaches):
            if key in seen:
                self._missed.pop(key, None)
                continue
            self._missed[key] = self._missed.get(key, 0) + 1
            if self._missed[key] >= self.RETIRE_AFTER_MISSES:
                del self.breaches[key]
                del self._missed[key]
                self.breach_since.pop(key, None)
                self.breach_severity.pop(key, None)
        return events


class QuietPodWatcher:
    """The LOW-watermark detector over the same serving gauges: a pod
    instance is QUIET when every enabled max-direction SLO signal it
    reports sits at or below ``quiet_factor`` x its breach threshold
    (and no min-direction signal is breaching).  The gap between the
    quiet watermark and the breach threshold is the hysteresis dead
    band — a constant signal inside it triggers neither direction.

    Edge-triggered episodes like every detector here: one alert when
    quiet is ESTABLISHED (carrying ``since``), one clear when any
    signal rises back above the watermark.  The scale-in governor
    applies its own ``quiet_hold_s`` on top of ``since`` — this
    watcher marks episodes, the policy decides.

    Threshold resolution is SHARED with the breach watcher (same
    env-knob fallback chain), so the two bands can never drift apart;
    missing/stale samples ride the same missed-sample counter (one
    dropped RPC neither ends a quiet episode nor starts one)."""

    RETIRE_AFTER_MISSES = 3

    def __init__(self, slo: ServingSloWatcher,
                 quiet_factor: float = 0.25):
        self._slo = slo
        self.quiet_factor = float(quiet_factor)
        self.quiet_since: Dict[str, float] = {}
        self._missed: Dict[str, int] = {}

    def _is_quiet(self, stats: dict, env: Dict[str, str]) -> Optional[bool]:
        """True/False, or None when no enabled LOAD signal is present
        (an unknown pod is neither quiet nor loaded).  Quiet EVIDENCE
        comes only from max-direction load signals sitting under the
        watermark; min-direction headroom signals can veto (a starved
        arena is the opposite of quiet) but never attest — a
        deployment with only ``kv_pages_free_slo`` enabled would
        otherwise mark every non-starved pod quiet regardless of
        load, and the scale-in it triggers would breach and flap."""
        any_load_signal = False
        excluded = ServingSloWatcher._excluded_signals(stats)
        for signal, knob, attr, direction in ServingSloWatcher.SIGNALS:
            if signal in excluded:
                # role-excluded gauges attest nothing: a prefill
                # pod's near-zero decode occupancy is its design
                # point, not quiet evidence
                continue
            threshold = self._slo._threshold(env, knob, attr)
            if threshold <= 0 or signal not in stats:
                continue
            try:
                value = float(stats[signal])
            except (TypeError, ValueError):
                continue
            if direction == "min":
                # headroom signal: breaching (below minimum) is the
                # opposite of quiet; plentiful headroom is neutral
                if value < threshold:
                    return False
                continue
            any_load_signal = True
            if value > threshold * self.quiet_factor:
                return False
        return True if any_load_signal else None

    def observe(
        self,
        stats_by_task: Dict[str, dict],
        env_by_task: Optional[Dict[str, Dict[str, str]]] = None,
        now: Optional[float] = None,
    ) -> List[dict]:
        now = time.time() if now is None else now
        events: List[dict] = []
        seen = set()
        for task, stats in sorted(stats_by_task.items()):
            env = (env_by_task or {}).get(task, {})
            if self._slo._is_stale(stats, now):
                continue  # missed sample, not evidence of anything
            verdict = self._is_quiet(stats, env)
            if verdict is None:
                continue
            seen.add(task)
            if verdict and task not in self.quiet_since:
                self.quiet_since[task] = now
                events.append({
                    "kind": "alert",
                    "detector": "quiet",
                    "task": task,
                    "since": round(now, 3),
                    "message": (
                        f"{task} quiet: all serving gauges at or "
                        f"below {self.quiet_factor}x their SLO "
                        "thresholds"
                    ),
                })
            elif not verdict and task in self.quiet_since:
                del self.quiet_since[task]
                events.append({
                    "kind": "alert",
                    "detector": "quiet",
                    "task": task,
                    "cleared": True,
                    "message": f"{task} back above the quiet watermark",
                })
        for task in list(self.quiet_since):
            if task in seen:
                self._missed.pop(task, None)
                continue
            self._missed[task] = self._missed.get(task, 0) + 1
            if self._missed[task] >= self.RETIRE_AFTER_MISSES:
                # retired pod (or the scale-in that quiet triggered
                # already killed it): drop silently, nothing measured
                del self.quiet_since[task]
                del self._missed[task]
        return events


class LeaseChurnWatcher:
    """Flags flapping leadership: ``churn_n`` or more lease-epoch
    changes inside ``window_s`` means schedulers are trading the lease
    instead of holding it (renewal starvation, a crash loop, or a
    split network) — each individual failover looks routine, the RATE
    is the anomaly.  Edge-triggered episodes like the other detectors:
    one alert when the rate crosses ``churn_n``, one clear (and
    re-arm) when it drops back below — NOT when the window fully
    empties, or a steady sub-threshold drip of routine failovers
    would hold the alert suppressed forever."""

    def __init__(self, churn_n: int = 3, window_s: float = 300.0):
        self.churn_n = max(2, int(churn_n))
        self.window_s = float(window_s)
        self._changes: List[float] = []  # times of observed epoch bumps
        self._last_epoch: Optional[int] = None
        self._alerted = False

    @property
    def alerted(self) -> bool:
        """True while a churn episode is OPEN — the action governor's
        flap hold (no automated scale/remediation under flapping
        leadership)."""
        return self._alerted

    def observe(self, epoch: Optional[int], t: Optional[float] = None) -> List[dict]:
        if epoch is None:
            return []
        now = time.time() if t is None else t
        if self._last_epoch is not None and epoch != self._last_epoch:
            self._changes.append(now)
        self._last_epoch = epoch
        self._changes = [
            ts for ts in self._changes if now - ts <= self.window_s
        ]
        if len(self._changes) >= self.churn_n:
            if not self._alerted:
                self._alerted = True
                return [{
                    "kind": "alert",
                    "detector": "lease-churn",
                    "epoch": epoch,
                    "changes": len(self._changes),
                    "window_s": self.window_s,
                    "message": (
                        f"leader lease changed {len(self._changes)} times "
                        f"in {self.window_s:.0f}s (epoch now {epoch}) — "
                        "flapping leadership"
                    ),
                }]
        elif self._alerted:
            self._alerted = False  # episode over: clear and re-arm
            return [{
                "kind": "alert",
                "detector": "lease-churn",
                "epoch": epoch,
                "changes": len(self._changes),
                "cleared": True,
                "message": "leader lease churn back under the "
                           "flapping threshold",
            }]
        return []

"""RequestRouter: the transport-free routing brain of the serving
front door.

One router fronts N serve pods.  Every placement decision composes
three signals, in order:

* **drain awareness** — a pod marked draining (operator verb,
  scheduler decommission/pause state from discovery, or a transport
  failure observed mid-request) receives ZERO new admissions; its
  in-flight requests finish normally.  A pod that died mid-request
  fails over to a peer under an honest retry budget — the retry is
  counted, bounded, and only taken when the failure proves no
  response was produced (a transport error), never on an application
  error, so no reply is ever silently doubled.
* **prefix affinity** (router/affinity.py) — the prompt's
  page-aligned prefix chain (the same construction serve/paging.py
  interns) is matched against which pod last served each chain node;
  shared-prefix sessions land on the pod already holding the cached
  pages, so the prefix cache's hit rate survives fan-out instead of
  being diluted 1/N by random spray.  Affinity yields to load: a
  claimed pod more than ``affinity_slack`` requests busier than the
  least-loaded peer is skipped (a hot system prompt must not weld
  itself to one pod).
* **least-loaded** (router/telemetry.py) — polled queue-depth/
  active-rows/KV-headroom gauges, gated on freshness: a pod whose
  snapshot is stale (poll failed, or the pod's own engine loop
  stopped ticking per its ``stats_age_s`` stamp) is scored
  pessimistically on router-side in-flight counts alone, never on
  its last-good numbers.

The router is transport-free by the same discipline as the serve
engine: ``send(pod_name, address, request) -> response`` is injected
(the HTTP front door binds it to POST /generate; tests and the bench
bind it straight onto in-process engines).  ``PodTransportError``
from ``send`` is the ONLY failover trigger; every other exception
passes through to the caller untouched.

Reference: the reference SDK's EndpointsResource/NamedVIPSpec answer
"where are the backends" (SURVEY §2.1) and leave balancing to
dcos-l4lb; this module is the TPU-serving-aware balancer that VIP
machinery never had.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

from dcos_commons_tpu_torch.router.affinity import (
    AffinityMap,
    prefix_chain_keys,
)
from dcos_commons_tpu_torch.router.telemetry import (
    DEFAULT_STALE_AFTER_S,
    PodTelemetry,
)
from dcos_commons_tpu_torch.serve.migration import SessionMigratedError

ROUTERSTATS_NAME = "servestats.json"  # rides the serving-stats plumbing
_LATENCY_WINDOW = 512


class PodTransportError(RuntimeError):
    """The pod could not be reached or died mid-request — no response
    was produced, so failing over to a peer cannot double a reply."""


class NoPodAvailableError(RuntimeError):
    """No pod is currently admitting (all draining/failed/unknown) —
    the front door maps this to 503."""


class _PodState:
    """Router-side view of one serve pod."""

    __slots__ = (
        "name", "address", "telemetry", "draining",
        "operator_drained", "failed", "in_flight", "admitted",
        "role",
    )

    def __init__(self, name: str, address: str, stale_after_s: float):
        self.name = name
        self.address = address
        self.telemetry = PodTelemetry(stale_after_s)
        # serving role (disaggregation): "unified" serves
        # everything; "prefill" pods take long prompts and hand the
        # finished pages to the decode pool; "decode" pods take the
        # short/interactive traffic.  Seeded from discovery (the
        # pod's SERVE_ROLE env, surfaced through /v1/endpoints) and
        # refined by the pod's own serving_role gauge
        self.role = "unified"
        # two INDEPENDENT drain flags, OR'd for admission: discovery
        # state (scheduler-side pause/decommission, refreshed by every
        # update_pods) and the operator's front-door verb (owned by
        # drain()/undrain() ONLY — a discovery refresh must never
        # silently undo a runbook drain mid-decommission)
        self.draining = False
        self.operator_drained = False
        self.failed = False      # transport failure; cleared by fresh stats
        self.in_flight = 0
        self.admitted = 0

    @property
    def admitting_blocked(self) -> bool:
        return self.draining or self.operator_drained

    def load(self, now: float) -> float:
        """Placement score, lower = preferred.  Fresh gauges add the
        pod's polled backlog; stale gauges contribute a flat penalty
        so a pod of UNKNOWN load never outbids one that proves its
        headroom — but an all-stale fleet still spreads by in-flight
        counts instead of wedging."""
        polled = self.telemetry.load_score(now)
        if polled is None:
            return self.in_flight + _STALE_LOAD_PENALTY
        return self.in_flight + polled


# stale pods rank behind any fresh pod with fewer than this many
# queued+active requests; in-flight counts still order stale pods
# among themselves
_STALE_LOAD_PENALTY = 1e6


class RequestRouter:
    """See module docstring.  Thread-safe: submit() runs on client
    threads; discovery/stats observation on the front door's poll
    thread; ``send`` always runs OUTSIDE the lock."""

    def __init__(
        self,
        send: Callable[[str, str, dict], list],
        page_tokens: int = 16,
        policy: str = "affinity",
        stale_after_s: float = DEFAULT_STALE_AFTER_S,
        retry_budget: int = 2,
        affinity_slack: float = 4.0,
        affinity_capacity: int = 65536,
        prefill_route_tokens: Optional[int] = None,
        log: Optional[Callable[[str], None]] = None,
    ):
        if policy not in ("affinity", "least-loaded", "round-robin"):
            raise ValueError(f"unknown routing policy {policy!r}")
        self._send = send
        self._page_tokens = int(page_tokens)
        self._policy = policy
        self._stale_after_s = float(stale_after_s)
        self._retry_budget = max(0, int(retry_budget))
        self._affinity_slack = float(affinity_slack)
        # disaggregation threshold: prompts at least this long go to
        # prefill-role capacity (when any is offered).  None = auto
        # (a prompt spanning 4+ pages is "long" — one chunked-prefill
        # burst a decode tick should not absorb); 0 = never steer by
        # length (prefill pods then only take traffic as a last
        # resort).  Role filtering is inert while every pod is
        # unified, which is every pre-disaggregation deployment.
        if prefill_route_tokens is None:
            self._prefill_route_tokens = 4 * self._page_tokens
        else:
            self._prefill_route_tokens = max(0, int(prefill_route_tokens))
        self._log = log
        self._lock = threading.Lock()
        self._pods: Dict[str, _PodState] = {}
        self._generation: Optional[str] = None
        self._affinity = AffinityMap(affinity_capacity)
        self._rr_next = 0
        # telemetry (counters under the lock; windows pruned on append)
        self._requests = 0
        self._completed = 0
        self._retries = 0
        self._failovers = 0
        self._rejected_no_pod = 0
        self._affinity_lookups = 0
        self._affinity_hits = 0
        self._affinity_overridden = 0
        self._stale_routing_rounds = 0
        self._migration_follows = 0
        self._chain_repoints = 0
        self._latency: deque = deque(maxlen=_LATENCY_WINDOW)
        self._started_mono = time.monotonic()
        self._extra_stats: Dict[str, object] = {}

    def annotate_stats(self, **extra) -> None:
        """Attach static facts to every stats() snapshot (the front
        door's actually-bound http_port — the same /v1/endpoints
        advertisement contract as serve/engine.py)."""
        with self._lock:
            self._extra_stats.update(extra)

    # -- pod set (discovery-driven) -----------------------------------

    def update_pods(self, backends: Dict[str, dict],
                    generation: Optional[str] = None) -> bool:
        """Install the discovered pod set.  ``backends``: name ->
        {"address": "host:port", "draining": bool}.  With a
        ``generation`` matching the last install this is ONE compare
        and no rebuild (the quiet-fleet discipline: the scheduler's
        endpoint generation only moves on task/reservation churn).
        Returns True when the set was (re)installed."""
        with self._lock:
            if generation is not None and generation == self._generation:
                return False
            self._generation = generation
            removed = [n for n in self._pods if n not in backends]
            for name in removed:
                del self._pods[name]
                self._affinity.evict_pod(name)
            for name, entry in backends.items():
                address = entry["address"] if isinstance(entry, dict) \
                    else str(entry)
                draining = bool(entry.get("draining", False)) \
                    if isinstance(entry, dict) else False
                pod = self._pods.get(name)
                if pod is None or pod.address != address:
                    # new pod, or a replaced pod behind the old name:
                    # either way its cache is cold — drop stale claims
                    if pod is not None:
                        self._affinity.evict_pod(name)
                    pod = _PodState(name, address, self._stale_after_s)
                    self._pods[name] = pod
                if draining and not pod.draining:
                    self._affinity.evict_pod(name)
                pod.draining = draining
                role = entry.get("role") if isinstance(entry, dict) \
                    else None
                if role:
                    pod.role = str(role)
        if removed and self._log is not None:
            self._log(f"router: pods left the set: {sorted(removed)}")
        return True

    def observe_stats(self, name: str, stats: dict,
                      now: Optional[float] = None) -> None:
        """Ingest one pod's /stats snapshot (poll thread).  A fresh
        snapshot clears the pod's transport-failure mark: the pod
        answered, so it is dialable again."""
        now = time.monotonic() if now is None else now
        with self._lock:
            pod = self._pods.get(name)
            if pod is None:
                return
            pod.telemetry.observe(stats, now)
            if pod.telemetry.fresh(now):
                pod.failed = False
            if pod.telemetry.serving_role:
                pod.role = pod.telemetry.serving_role

    def drain(self, name: str,
              migrated_to: Optional[str] = None) -> bool:
        """Operator drain: zero new admissions, in-flight finishes.
        The drain runbook's first verb (operations-guide).  Sticky
        against discovery: only undrain() (or the pod leaving the
        set) clears it — a poll-driven pod-set refresh must not undo
        a drain mid-decommission.

        ``migrated_to`` names the pod the drain migrated this pod's
        sessions (and their cached pages) to: the leaving pod's
        prefix-chain claims RE-POINT there instead of being dropped,
        so post-drain requests still hit the moved cache.  Without it
        — the legacy wait-out drain — claims are evicted, because the
        cache genuinely dies with the pod."""
        with self._lock:
            pod = self._pods.get(name)
            if pod is None:
                return False
            pod.operator_drained = True
            dest = self._pods.get(migrated_to) if migrated_to else None
            if dest is not None and dest.name != name:
                moved = self._affinity.repoint_pod(name, dest.name)
                self._chain_repoints += moved
            else:
                moved = -self._affinity.evict_pod(name)
        if self._log is not None:
            if moved > 0:
                self._log(
                    f"router: draining {name}; {moved} prefix claims "
                    f"re-pointed to {migrated_to}"
                )
            else:
                self._log(f"router: draining {name}")
        return True

    def undrain(self, name: str) -> bool:
        with self._lock:
            pod = self._pods.get(name)
            if pod is None:
                return False
            pod.operator_drained = False
        return True

    def pods(self) -> List[str]:
        with self._lock:
            return sorted(self._pods)

    def repoint_prompt(self, tokens: Sequence[int], dest: str) -> int:
        """Re-point one prompt's prefix-chain claims to ``dest`` —
        the rebalance consumer's verb: after migrating a session's
        pages, its chain knowledge follows (drain_sessions report
        rows carry the tokens).  Returns claims moved."""
        keys = prefix_chain_keys(tokens, self._page_tokens)
        with self._lock:
            if not keys or dest not in self._pods:
                return 0
            moved = self._affinity.repoint(keys, dest)
            self._chain_repoints += moved
            return moved

    def rebalance_suggestion(self, min_claims: int = 8,
                             min_skew: float = 2.0) -> Optional[dict]:
        """Prefix-hotspot detection: the pod whose claim count AND
        load dominate its peers is where a hot shared prefix welded
        traffic.  Returns ``{"from", "to", "claims", "load_gap"}`` —
        migrate sessions from/to those pods (serve.migration.
        drain_sessions + repoint_prompt) to shed load WITH the cache
        — or None while the fleet is balanced."""
        now = time.monotonic()
        with self._lock:
            pods = self._eligible_locked(())
            if len(pods) < 2:
                return None
            counts = self._affinity.claims_by_pod()
            hot = max(pods, key=lambda p: (counts.get(p.name, 0),
                                           p.load(now), p.name))
            cold = min(pods, key=lambda p: (counts.get(p.name, 0),
                                            p.load(now), p.name))
            hot_claims = counts.get(hot.name, 0)
            cold_claims = counts.get(cold.name, 0)
            if (hot.name == cold.name
                    or hot_claims < max(1, int(min_claims))
                    or hot_claims < min_skew * max(1, cold_claims)
                    or hot.load(now) <= cold.load(now)):
                return None
            return {
                "from": hot.name, "to": cold.name,
                "claims": hot_claims,
                "load_gap": round(hot.load(now) - cold.load(now), 2),
            }

    # -- placement ----------------------------------------------------

    def _eligible_locked(self, exclude) -> List[_PodState]:
        return [
            p for p in self._pods.values()
            if not p.admitting_blocked and not p.failed
            and p.name not in exclude
        ]

    def _role_filter_locked(self, pods: List[_PodState],
                            prompt_len: int) -> List[_PodState]:
        """Disaggregated placement: long prompts go to prefill-role
        capacity; everything else stays off it (a short prompt on a
        prefill pod would just bounce through a handoff).  Inert
        while no offered pod declares a prefill role — every
        pre-disaggregation fleet."""
        prefill = [p for p in pods if p.role == "prefill"]
        if not prefill or len(prefill) == len(pods):
            return pods
        if (self._prefill_route_tokens > 0
                and prompt_len >= self._prefill_route_tokens):
            return prefill
        return [p for p in pods if p.role != "prefill"]

    def _pick_locked(self, keys: Sequence[int], exclude,
                     prompt_len: int = 0) -> _PodState:
        pods = self._eligible_locked(exclude)
        if not pods:
            self._rejected_no_pod += 1
            raise NoPodAvailableError(
                "no serve pod is admitting (all draining, failed, or "
                "undiscovered)"
            )
        pods = self._role_filter_locked(pods, prompt_len)
        allowed = {p.name for p in pods}
        now = time.monotonic()
        if all(not p.telemetry.fresh(now) for p in pods):
            self._stale_routing_rounds += 1
        if self._policy == "round-robin":
            ordered = sorted(pods, key=lambda p: p.name)
            pod = ordered[self._rr_next % len(ordered)]
            self._rr_next += 1
            return pod
        by_load = min(pods, key=lambda p: (p.load(now), p.name))
        if self._policy == "affinity" and keys:
            self._affinity_lookups += 1
            claimed, _depth = self._affinity.lookup(keys)
            if claimed is not None and claimed in allowed:
                pod = self._pods.get(claimed)
                if (pod is not None and not pod.admitting_blocked
                        and not pod.failed and pod.name not in exclude):
                    if pod.load(now) <= by_load.load(now) + \
                            self._affinity_slack:
                        self._affinity_hits += 1
                        return pod
                    self._affinity_overridden += 1
        return by_load

    def route(self, tokens: Sequence[int]) -> str:
        """Placement decision alone (tests/debug): which pod would
        this prompt go to right now?"""
        keys = prefix_chain_keys(tokens, self._page_tokens)
        with self._lock:
            return self._pick_locked(
                keys, exclude=(), prompt_len=len(tokens)
            ).name

    # -- the request path ---------------------------------------------

    def submit(
        self,
        tokens: Sequence[int],
        max_new_tokens: int,
        temperature: float = 0.0,
        eos: Optional[int] = None,
    ) -> List[int]:
        """Route one prompt and return its continuation.  Transport
        failures fail over within the retry budget; application
        errors (the pod ANSWERED with an error) pass through — the
        pod produced a verdict, and re-asking a peer would double
        work the client will retry anyway."""
        request = {
            "tokens": [[int(t) for t in tokens]],
            "max_new_tokens": int(max_new_tokens),
            "temperature": float(temperature),
        }
        if eos is not None:
            request["eos"] = int(eos)
        keys = prefix_chain_keys(tokens, self._page_tokens)
        tried: set = set()
        attempts = 0
        t0 = time.monotonic()
        with self._lock:
            self._requests += 1
        while True:
            with self._lock:
                pod = self._pick_locked(
                    keys, tried, prompt_len=len(tokens)
                )
                pod.in_flight += 1
                pod.admitted += 1
                if self._policy == "affinity" and keys:
                    # claim BEFORE the send completes: a concurrent
                    # same-prefix request must follow this one onto
                    # the same pod, not race past it to another
                    self._affinity.record(keys, pod.name)
                name, address = pod.name, pod.address
            try:
                result = self._send(name, address, request)
            except PodTransportError as e:
                with self._lock:
                    pod.in_flight -= 1
                    pod.failed = True
                    self._affinity.evict_pod(name)
                    tried.add(name)
                    attempts += 1
                    self._retries += 1
                    budget_left = attempts <= self._retry_budget
                if self._log is not None:
                    self._log(
                        f"router: {name} failed mid-request ({e}); "
                        + (f"failing over (attempt {attempts}/"
                           f"{self._retry_budget})" if budget_left
                           else "retry budget exhausted")
                    )
                if not budget_left:
                    raise PodTransportError(
                        f"request failed on {attempts} pod(s), retry "
                        f"budget {self._retry_budget} exhausted: {e}"
                    ) from e
                with self._lock:
                    self._failovers += 1
                continue
            except SessionMigratedError as e:
                # the session moved mid-generation (drain, rebalance,
                # or a prefill pod's handoff): follow it with a
                # collect — the destination answers with the FULL
                # output, so the client sees one uninterrupted reply
                with self._lock:
                    pod.in_flight -= 1
                    self._migration_follows += 1
                    dest = self._pods.get(e.moved_to)
                    if dest is not None:
                        dest.in_flight += 1
                if dest is None:
                    raise PodTransportError(
                        f"session migrated to unknown pod "
                        f"{e.moved_to!r}"
                    ) from e
                if self._log is not None:
                    self._log(
                        f"router: following migrated session from "
                        f"{name} to {dest.name}"
                    )
                try:
                    result = self._send(
                        dest.name, dest.address,
                        {"collect": int(e.dest_rid)},
                    )
                finally:
                    with self._lock:
                        dest.in_flight -= 1
                now = time.monotonic()
                with self._lock:
                    self._completed += 1
                    self._latency.append(now - t0)
                return result[0]
            except Exception:
                with self._lock:
                    pod.in_flight -= 1
                raise  # application error: pass through, never retried
            now = time.monotonic()
            with self._lock:
                pod.in_flight -= 1
                self._completed += 1
                self._latency.append(now - t0)
            # send's contract: the pod's row list for the one-row
            # request — the continuation is its first (only) row
            return result[0]

    # -- gauges (the watcher-compatible snapshot) ---------------------

    def stats(self) -> dict:
        """Router load snapshot.  Deliberately shares key names with
        the serve engine's gauges (queue_depth, ttft_p95_s,
        stats_age_s) so the scheduler's ServingSloWatcher watches a
        router task with the SAME env knobs as a serve pod; router_*
        keys carry the front-door-specific counters."""
        from dcos_commons_tpu_torch.metrics.registry import percentile

        with self._lock:
            pods = list(self._pods.values())
            latency = sorted(self._latency)
            out = {
                "router_pods": len(pods),
                "router_pods_draining": sum(
                    p.admitting_blocked for p in pods
                ),
                "router_pods_failed": sum(p.failed for p in pods),
                "queue_depth": sum(p.in_flight for p in pods),
                "requests_admitted": self._requests,
                "requests_completed": self._completed,
                "router_retries": self._retries,
                "router_failovers": self._failovers,
                "router_rejected_no_pod": self._rejected_no_pod,
                "router_affinity_lookups": self._affinity_lookups,
                "router_affinity_hits": self._affinity_hits,
                "router_affinity_overridden": self._affinity_overridden,
                "router_affinity_hit_rate": round(
                    self._affinity_hits / self._affinity_lookups, 4
                ) if self._affinity_lookups else 0.0,
                "router_stale_routing_rounds": self._stale_routing_rounds,
                "router_migration_follows": self._migration_follows,
                "router_chain_repoints": self._chain_repoints,
                "router_prefill_pods": sum(
                    p.role == "prefill" for p in pods
                ),
                "router_policy": self._policy,
                "router_generation": self._generation,
            }
            out.update(self._extra_stats)
        if latency:
            out["ttft_p50_s"] = round(percentile(latency, 50), 4)
            out["ttft_p95_s"] = round(percentile(latency, 95), 4)
        # the router computes its snapshot on demand: age 0 by
        # construction, present so staleness-gated readers need no
        # special case for router tasks
        out["stats_age_s"] = 0.0
        out["t"] = time.time()
        return out

    def describe(self) -> dict:
        """Per-pod debug rows (front door GET /pods; the
        prefix-affinity triage surface)."""
        now = time.monotonic()
        with self._lock:
            return {
                "generation": self._generation,
                "policy": self._policy,
                "affinity_entries": len(self._affinity),
                "pods": {
                    p.name: {
                        "address": p.address,
                        "role": p.role,
                        "draining": p.admitting_blocked,
                        "discovery_draining": p.draining,
                        "operator_drained": p.operator_drained,
                        "failed": p.failed,
                        "in_flight": p.in_flight,
                        "admitted": p.admitted,
                        "telemetry": p.telemetry.describe(now),
                    }
                    for p in self._pods.values()
                },
            }

    def write_stats(self, path: str) -> None:
        """Mirror the router gauges to a sandbox file (same atomic
        pattern as serve/engine.py): the scheduler's /v1/debug/serving
        and /v1/debug/router merge them per task."""
        try:
            tmp = path + ".tmp"
            # durcheck: dur-file-discipline=telemetry mirror: loss on power failure is acceptable, the rename alone keeps readers partial-free
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(self.stats(), f)
            os.replace(tmp, path)
        except OSError:
            pass  # sdklint: disable=swallowed-exception — telemetry must never take the front door down

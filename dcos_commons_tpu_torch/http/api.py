"""Query logic behind every /v1 route (transport-free).

Reference: http/queries/*.java — the reference splits Jersey resource
classes (transport) from query logic classes; this module is the query
half, returning ``(http_status, jsonable_body)`` tuples so both the
HTTP server and in-process callers (tests, CLI fallback) share one
implementation.

Port of ``dcos_commons_tpu/http/api.py``, line for line but the imports.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

from dcos_commons_tpu_torch.debug.trackers import serialize_plan
from dcos_commons_tpu_torch.specification.specs import task_full_name
from dcos_commons_tpu_torch.state.state_store import (
    GoalStateOverride,
    OverrideProgress,
)

Response = Tuple[int, Any]


class SchedulerApi:
    def __init__(self, scheduler):
        self._scheduler = scheduler

    def set_scheduler(self, scheduler) -> None:
        """Swap the backing scheduler (live options update rebuilds it
        in-process; the HTTP server and its routes stay up)."""
        self._scheduler = scheduler

    def _nudge(self) -> None:
        """Wake an event-driven scheduler loop after a mutation so the
        verb takes effect at evaluation speed, not heartbeat speed."""
        nudge = getattr(self._scheduler, "nudge", None)
        if callable(nudge):
            nudge()

    def _journal_verb(self, verb: str, **attrs) -> None:
        """Operator verbs land in the durable event journal — flushed
        INLINE (unlike cycle-batched events): the operator's interrupt
        must survive a crash that happens before the next cycle."""
        journal = getattr(self._scheduler, "journal", None)
        if journal is None:
            return
        journal.append("operator", verb=verb, **attrs)
        journal.flush()

    # -- health (reference: http/endpoints/HealthResource.java) -------

    def health(self) -> Response:
        plans = self._scheduler.plans()
        statuses = {name: p.get_status().value for name, p in plans.items()}
        has_errors = any(p.has_errors() for p in plans.values())
        deployed = all(
            p.is_complete for n, p in plans.items()
            if n in ("deploy", "update")
        )
        fatal = getattr(self._scheduler, "fatal_error", None)
        healthy = not has_errors and fatal is None
        body = {
            "healthy": healthy,
            "deployed": deployed,
            "plans": statuses,
        }
        if fatal is not None:
            body["fatal_error"] = fatal
        return (200 if healthy else 503), body

    # -- plans (reference: http/queries/PlansQueries.java:47-231) -----

    def list_plans(self) -> Response:
        return 200, sorted(self._scheduler.plans().keys())

    def get_plan(self, plan_name: str) -> Response:
        plan = self._scheduler.plan(plan_name)
        if plan is None:
            return 404, {"message": f"no plan named {plan_name}"}
        body = serialize_plan(plan)
        # the reference returns 202 while a plan is in progress and 200
        # once complete (PlansQueries.getPlanInfo)
        code = 200 if plan.is_complete else 202
        return code, body

    def _plan_element(
        self, plan_name: str, phase: Optional[str], step: Optional[str]
    ):
        plan = self._scheduler.plan(plan_name)
        if plan is None:
            return None, (404, {"message": f"no plan named {plan_name}"})
        if phase is None:
            return plan, None
        phase_el = plan.phase(phase)
        if phase_el is None:
            return None, (404, {"message": f"no phase {phase}"})
        if step is None:
            return phase_el, None
        for s in phase_el.steps:
            if s.name == step or s.id == step:
                return s, None
        return None, (404, {"message": f"no step {step}"})

    def _plan_verb(
        self,
        plan_name: str,
        phase: Optional[str],
        step: Optional[str],
        verb: str,
    ) -> Response:
        element, error = self._plan_element(plan_name, phase, step)
        if error is not None:
            return error
        getattr(element, verb)()
        self._journal_verb(verb, plan=plan_name, phase=phase, step=step)
        self._nudge()
        return 200, {"message": f"{verb} invoked", "plan": plan_name}

    def plan_interrupt(self, plan_name, phase=None, step=None) -> Response:
        return self._plan_verb(plan_name, phase, step, "interrupt")

    def plan_continue(self, plan_name, phase=None, step=None) -> Response:
        return self._plan_verb(plan_name, phase, step, "proceed")

    def plan_restart(self, plan_name, phase=None, step=None) -> Response:
        return self._plan_verb(plan_name, phase, step, "restart")

    def plan_force_complete(self, plan_name, phase=None, step=None) -> Response:
        return self._plan_verb(plan_name, phase, step, "force_complete")

    def plan_start(self, plan_name, env=None) -> Response:
        """Reference: PlansQueries.start (PlansQueries.java:47-231) —
        restart + proceed, with an optional ``{"env": {...}}`` body
        merged into every task the plan launches (what makes sidecar
        plans like backup/restore operable: snapshot name, target
        location)."""
        element, error = self._plan_element(plan_name, None, None)
        if error is not None:
            return error
        if env:
            if not isinstance(env, dict) or not all(
                isinstance(k, str) and isinstance(v, str)
                for k, v in env.items()
            ):
                return 400, {"message": "env must be a {str: str} object"}
            setter = getattr(element, "set_env_overrides", None)
            if setter is None:
                return 409, {
                    "message": f"plan {plan_name} cannot take env overrides"
                }
            setter(env)
        element.restart()
        element.proceed()
        self._journal_verb("start", plan=plan_name)
        self._nudge()
        return 200, {
            "message": "started", "plan": plan_name,
            "env": sorted(env) if env else [],
        }

    def plan_stop(self, plan_name) -> Response:
        """Reference: PlansQueries.stop — interrupt + restart."""
        element, error = self._plan_element(plan_name, None, None)
        if error is not None:
            return error
        element.interrupt()
        element.restart()
        self._journal_verb("stop", plan=plan_name)
        self._nudge()
        return 200, {"message": "stopped", "plan": plan_name}

    # -- pods (reference: http/queries/PodQueries.java:69-263) --------

    def list_pods(self) -> Response:
        names = []
        for pod in self._scheduler.spec.pods:
            for i in range(pod.count):
                names.append(f"{pod.type}-{i}")
        return 200, names

    def pod_statuses(self) -> Response:
        statuses = self._scheduler.state_store.fetch_statuses()
        body = []
        for pod in self._scheduler.spec.pods:
            instances = []
            for i in range(pod.count):
                tasks = []
                for task_spec in pod.tasks:
                    full = task_full_name(pod.type, i, task_spec.name)
                    status = statuses.get(full)
                    info = self._scheduler.state_store.fetch_task(full)
                    shown = status.state.value if status else None
                    # a PAUSED override rewrites the shown state
                    # (reference: PodQueries surfacing PAUSING/PAUSED
                    # instead of the raw Mesos state)
                    override, progress = (
                        self._scheduler.state_store.fetch_goal_override(full)
                    )
                    if override is GoalStateOverride.PAUSED:
                        shown = (
                            "PAUSED"
                            if progress is OverrideProgress.COMPLETE
                            else "PAUSING"
                        )
                    tasks.append(
                        {
                            "name": full,
                            "id": info.task_id if info else None,
                            "status": shown,
                            "ready": status.ready if status else False,
                        }
                    )
                instances.append({"name": f"{pod.type}-{i}", "tasks": tasks})
            body.append({"name": pod.type, "instances": instances})
        return 200, {"service": self._scheduler.spec.name, "pods": body}

    def pod_status(self, pod_instance: str) -> Response:
        pod_type, index, error = self._parse_instance(pod_instance)
        if error:
            return error
        code, body = self.pod_statuses()
        for pod in body["pods"]:
            for instance in pod["instances"]:
                if instance["name"] == pod_instance:
                    return 200, instance
        return 404, {"message": f"no pod instance {pod_instance}"}

    def pod_info(self, pod_instance: str) -> Response:
        pod_type, index, error = self._parse_instance(pod_instance)
        if error:
            return error
        pod = self._scheduler.spec.pod(pod_type)
        out = []
        for task_spec in pod.tasks:
            full = task_full_name(pod_type, index, task_spec.name)
            info = self._scheduler.state_store.fetch_task(full)
            if info is not None:
                out.append(info.to_dict())
        return 200, out

    def pod_restart(self, pod_instance: str) -> Response:
        return self._pod_restart(pod_instance, replace=False)

    def pod_replace(self, pod_instance: str) -> Response:
        return self._pod_restart(pod_instance, replace=True)

    def _pod_restart(self, pod_instance: str, replace: bool) -> Response:
        pod_type, index, error = self._parse_instance(pod_instance)
        if error:
            return error
        killed = self._scheduler.restart_pod(pod_type, index, replace=replace)
        self._flush_journal()  # the scheduler verb journaled; make it durable now
        return 200, {"pod": pod_instance, "tasks": killed}

    def _flush_journal(self) -> None:
        journal = getattr(self._scheduler, "journal", None)
        if journal is not None:
            journal.flush()

    def pod_pause(self, pod_instance: str, tasks=None) -> Response:
        pod_type, index, error = self._parse_instance(pod_instance)
        if error:
            return error
        touched = self._scheduler.pause_pod(pod_type, index, tasks)
        if not touched:
            # no-op transition rejected (reference: PodQueries refuses
            # invalid override transitions)
            return 409, {"message": f"{pod_instance} is already paused"}
        self._flush_journal()
        return 200, {"pod": pod_instance, "tasks": touched}

    def pod_resume(self, pod_instance: str, tasks=None) -> Response:
        pod_type, index, error = self._parse_instance(pod_instance)
        if error:
            return error
        touched = self._scheduler.resume_pod(pod_type, index, tasks)
        if not touched:
            return 409, {"message": f"{pod_instance} is not paused"}
        self._flush_journal()
        return 200, {"pod": pod_instance, "tasks": touched}

    def pod_scale(self, pod_type: str, body: Optional[dict] = None) -> Response:
        """Operator scale verb (``POST /v1/pod/<type>/scale`` with
        ``{"count": N}``): rides the autoscale plan machinery — the
        action is visible, journaled, and interruptible under the
        ``autoscale`` plan, and the single-flight rule applies (409
        while another scale action for the pod is in flight)."""
        try:
            self._scheduler.spec.pod(pod_type)
        except Exception:
            return 404, {"message": f"no pod type {pod_type}"}
        count = (body or {}).get("count")
        if not isinstance(count, int) or isinstance(count, bool):
            return 400, {"message": "body must be {\"count\": <int>}"}
        try:
            phase = self._scheduler.scale_pod(pod_type, count)
        except RuntimeError as e:
            return 409, {"message": str(e)}
        except ValueError as e:
            return 400, {"message": str(e)}
        self._flush_journal()
        return 200, {
            "pod": pod_type,
            "count": count,
            "plan": "autoscale",
            "phase": phase.name,
        }

    def pod_scale_abandon(self, pod_type: str) -> Response:
        """Drop an in-flight scale action for the pod: the persisted
        count settles to deployed reality and the direction's
        cooldown latches (journaled as ``stage=abandoned``)."""
        try:
            self._scheduler.spec.pod(pod_type)
        except Exception:
            return 404, {"message": f"no pod type {pod_type}"}
        if not self._scheduler.abandon_scale(pod_type):
            return 409, {
                "message": f"no in-flight scale action for {pod_type}"
            }
        self._flush_journal()
        return 200, {"pod": pod_type, "abandoned": True}

    def _parse_instance(self, pod_instance: str):
        pod_type, sep, index = pod_instance.rpartition("-")
        if not sep or not index.isdigit():
            return None, None, (
                400,
                {"message": f"expected <pod>-<index>, got {pod_instance!r}"},
            )
        try:
            self._scheduler.spec.pod(pod_type)
        except Exception:
            return None, None, (404, {"message": f"no pod type {pod_type}"})
        return pod_type, int(index), None

    # -- configs (reference: http/queries/ConfigQueries.java) ---------

    def list_configs(self) -> Response:
        store = self._scheduler.config_store
        if store is None:
            return 503, {"message": "no config store"}
        return 200, store.list_ids()

    def get_config(self, config_id: str) -> Response:
        store = self._scheduler.config_store
        if store is None:
            return 503, {"message": "no config store"}
        data = store.fetch(config_id)
        if data is None:
            return 404, {"message": f"no config {config_id}"}
        return 200, data

    def target_config_id(self) -> Response:
        store = self._scheduler.config_store
        if store is None:
            return 503, {"message": "no config store"}
        target = store.get_target_config()
        if target is None:
            return 404, {"message": "no target config"}
        return 200, target

    def target_config(self) -> Response:
        code, target = self.target_config_id()
        if code != 200:
            return code, target
        return self.get_config(target)

    # -- state (reference: http/queries/StateQueries.java) ------------

    def state_properties(self) -> Response:
        return 200, self._scheduler.state_store.fetch_property_keys()

    def state_property(self, key: str) -> Response:
        value = self._scheduler.state_store.fetch_property(key)
        if value is None:
            return 404, {"message": f"no property {key}"}
        try:
            return 200, value.decode("utf-8")
        except UnicodeDecodeError:
            return 200, value.hex()

    _FILE_PREFIX = "file."

    def state_files(self) -> Response:
        """Reference: StateQueries.java:78 — operator-managed files in
        the state store (small configs/keytabs an operator stages for
        tasks or tooling to read back)."""
        keys = self._scheduler.state_store.fetch_property_keys()
        return 200, sorted(
            k[len(self._FILE_PREFIX):] for k in keys
            if k.startswith(self._FILE_PREFIX)
        )

    def state_file_get(self, name: str) -> Response:
        import base64 as _b64

        value = self._scheduler.state_store.fetch_property(
            self._FILE_PREFIX + name
        )
        if value is None:
            return 404, {"message": f"no file {name}"}
        return 200, {
            "name": name,
            "content": _b64.b64encode(value).decode("ascii"),
        }

    def state_file_put(self, name: str, body: dict) -> Response:
        import base64 as _b64

        content = (body or {}).get("content")
        if not isinstance(content, str):
            return 400, {"message": "body must be {\"content\": b64}"}
        try:
            value = _b64.b64decode(content, validate=True)
        except Exception:
            return 400, {"message": "content is not valid base64"}
        if len(value) > 1 << 20:
            # the state tree is replicated + snapshotted: it is for
            # small operator files, not artifact storage (uris: is)
            return 413, {"message": "file too large (1 MiB cap)"}
        from dcos_commons_tpu_torch.state.state_store import StateStoreException

        try:
            self._scheduler.state_store.store_property(
                self._FILE_PREFIX + name, value
            )
        except StateStoreException as e:
            # key validation: the CLIENT's name is bad.  Persister/IO
            # failures propagate to the dispatcher's 500 path — a
            # store outage is not a malformed request.
            return 400, {"message": str(e)}
        return 200, {"name": name, "bytes": len(value)}

    def state_framework_id(self) -> Response:
        store = self._scheduler.framework_store
        if store is None:
            return 503, {"message": "no framework store"}
        framework_id = store.fetch_framework_id()
        if framework_id is None:
            return 404, {"message": "not registered"}
        return 200, framework_id

    def state_zones(self) -> Response:
        """Host -> zone map of the current inventory (reference:
        StateQueries zone files)."""
        return 200, {
            h.host_id: h.zone for h in self._scheduler.inventory.hosts()
        }

    # -- hosts (preemption & maintenance verbs) -------------

    def list_hosts(self) -> Response:
        """Per-host lifecycle state (up/down/preempted/maintenance)
        plus maintenance windows — the operator's drain dashboard."""
        inventory = self._scheduler.inventory
        if not hasattr(inventory, "host_states"):
            return 200, {"hosts": {}}
        return 200, {"hosts": inventory.host_states()}

    def host_drain(self, host_id: str, body: Optional[dict] = None) -> Response:
        if self._scheduler.inventory.host(host_id) is None:
            return 404, {"message": f"no host {host_id}"}
        try:
            window_s = float((body or {}).get("window_s", 0) or 0)
        except (TypeError, ValueError):
            return 400, {"message": "window_s must be a number"}
        changed = self._scheduler.drain_host(host_id, window_s=window_s)
        self._flush_journal()
        return 200, {
            "host": host_id,
            "state": "maintenance",
            "changed": changed,
            "window_s": window_s,
        }

    def host_preempt(self, host_id: str) -> Response:
        if self._scheduler.inventory.host(host_id) is None:
            return 404, {"message": f"no host {host_id}"}
        lost = self._scheduler.preempt_host(host_id)
        self._flush_journal()
        return 200, {
            "host": host_id,
            "state": "preempted",
            "tasks_lost": lost,
        }

    def host_up(self, host_id: str) -> Response:
        if self._scheduler.inventory.host(host_id) is None:
            return 404, {"message": f"no host {host_id}"}
        changed = self._scheduler.undrain_host(host_id)
        self._flush_journal()
        return 200, {"host": host_id, "state": "up", "changed": changed}

    # -- endpoints (reference: http/endpoints/EndpointsResource) ------

    def endpoints_generation(self) -> str:
        """Change stamp of the endpoint surface: reservations (ports
        move with claims) + the task subtree (launches, statuses,
        pause overrides — and advertised ports, which only change
        across a relaunch, i.e. a task mutation).  A router polling
        discovery compares this and skips the rebuild on a quiet
        fleet (the generation discipline)."""
        ledger = self._scheduler.ledger
        store = self._scheduler.state_store
        task_gen = getattr(store, "task_generation", "")
        return f"{ledger.epoch}.{ledger.generation}/{task_gen}"

    def _assemble_endpoints(self):
        """One walk building both surfaces: port name -> ["host:port",
        ...] (plus gang coordinator addresses under "coordinator"),
        and per-endpoint BACKEND rows carrying the task, its state,
        and whether it is draining — what a routing tier needs beyond
        bare addresses.

        Cost per call: O(THIS service's tasks) store reads (the same
        order as pod_statuses), plus one agent servestats read per
        ``advertise: true`` task — serve pods only, so a router's
        per-second discovery poll stays bounded by the serve pod
        count, never the fleet.  The stamp skips the ROUTER-side
        rebuild; caching the assembly scheduler-side would need the
        advertised ports folded into the base counters first (they
        are read live, outside them)."""
        out: Dict[str, List[str]] = {}
        backends: Dict[str, List[Dict[str, Any]]] = {}
        ledger = self._scheduler.ledger
        store = self._scheduler.state_store
        hosts = {h.host_id: h for h in self._scheduler.inventory.hosts()}
        port_reader = getattr(
            self._scheduler.agent, "advertised_port_of", None
        )
        # instances an ACTIVE pod-level teardown (surplus
        # decommission or autoscale scale-in) is about to kill: their
        # rows flip draining:true while task AND host still look
        # healthy, so the router drain-grace elapses before the kill
        # step fires (host-level drain alone would miss pod-granular
        # teardowns)
        drain_reader = getattr(
            self._scheduler, "draining_instances", None
        )
        draining_pods = drain_reader() if callable(drain_reader) else set()
        for info in store.fetch_tasks():
            host = hosts.get(info.agent_id)
            hostname = host.hostname if host else info.agent_id
            pod = None
            for p in self._scheduler.spec.pods:
                if p.type == info.pod_type:
                    pod = p
            if pod is None:
                continue
            # full names are <pod>-<index>-<task> and TASK names may
            # themselves contain dashes (server-a): strip the known
            # prefix instead of splitting on the last dash
            prefix = f"{info.pod_type}-{info.pod_index}-"
            try:
                task_spec = pod.task(
                    info.name[len(prefix):]
                    if info.name.startswith(prefix)
                    else info.name.rsplit("-", 1)[-1]
                )
            except Exception:
                task_spec = None
            status = store.fetch_status(info.name)
            override, _progress = store.fetch_goal_override(info.name)
            state = status.state.value if status else None
            ready = bool(status.ready) if status else False
            # a backend is DRAINING when it should receive no new
            # requests: paused (decommission/pause rides the override),
            # not running, not yet warm — or its HOST is leaving
            # (maintenance drain, mark_down, preemption).  The host
            # check is what makes `host drain` stop the routing tier
            # BEFORE any kill fires: the task is still RUNNING and
            # ready, but its machine is going away (the task-level signals
            # alone would never surface a pre-kill drain)
            host_state = getattr(
                self._scheduler.inventory, "host_state", lambda _h: "up"
            )(info.agent_id)
            draining = (
                override is not GoalStateOverride.NONE
                or state != "TASK_RUNNING"
                or not ready
                or host_state not in ("up", "")
                or f"{info.pod_type}-{info.pod_index}" in draining_pods
            )
            advertised: Optional[int] = None
            advertised_read = False
            reservations = list(ledger.for_task(info.name))
            for reservation in reservations:
                port_specs = (
                    task_spec.resources.ports if task_spec is not None else []
                )
                for port_spec, port in zip(port_specs, reservation.ports):
                    if port_spec.advertise and callable(port_reader):
                        # the worker's actually-bound port (servestats
                        # annotation) wins over the reserved one: the
                        # listing names what is DIALABLE.  One read
                        # per task, shared by its advertise ports.
                        if not advertised_read:
                            advertised_read = True
                            try:
                                advertised = port_reader(
                                    info.name, agent_id=info.agent_id
                                )
                            except OSError:
                                advertised = None
                        if advertised:
                            port = advertised
                    address = f"{hostname}:{port}"
                    # serving role rides discovery: the
                    # router learns prefill/decode capacity from the
                    # same poll that hands it addresses — no extra
                    # round trip before the first placement decision
                    role = info.env.get("SERVE_ROLE", "")
                    out.setdefault(port_spec.name, []).append(address)
                    backends.setdefault(port_spec.name, []).append({
                        "address": address,
                        "task": info.name,
                        "state": state,
                        "ready": ready,
                        "draining": draining,
                        "role": role,
                    })
                    if port_spec.vip:
                        # VIP discovery (reference: NamedVIPEvaluation
                        # Stage + EndpointUtils VIP listing): clients
                        # resolve the stable VIP name to the live
                        # backend set; "web:80" lists under "vip:web"
                        vip_name = port_spec.vip.split(":", 1)[0]
                        out.setdefault(f"vip:{vip_name}", []).append(
                            address
                        )
                        backends.setdefault(f"vip:{vip_name}", []).append({
                            "address": address,
                            "task": info.name,
                            "state": state,
                            "ready": ready,
                            "draining": draining,
                            "role": role,
                        })
            # stable DNS-style names (reference: DiscoveryInfo +
            # EndpointUtils listing <task>.<svc>.<tld> names; the
            # `discovery: prefix:` override renames the task part, and
            # `service-tld:` the suffix — custom_tld.yml analogue).
            # Wiring the names into a resolver is the fleet's job; the
            # listing is the contract.
            tld = self._scheduler.spec.service_tld
            if tld and task_spec is not None:
                if task_spec.discovery_prefix:
                    disc_name = (
                        f"{task_spec.discovery_prefix}-{info.pod_index}"
                    )
                else:
                    disc_name = info.name
                dns_name = (
                    f"{disc_name}.{self._scheduler.spec.name}.{tld}"
                )
                entries = out.setdefault("dns", [])
                for reservation in reservations:
                    for port in reservation.ports:
                        entry = f"{dns_name}:{port}"
                        if entry not in entries:
                            entries.append(entry)
                if not any(
                    e.startswith(dns_name + ":") for e in entries
                ):
                    if dns_name not in entries:
                        entries.append(dns_name)
            coord = info.env.get("COORDINATOR_ADDRESS")
            if coord:
                entries = out.setdefault("coordinator", [])
                if coord not in entries:
                    entries.append(coord)
        if self._scheduler.spec.web_url:
            # web-url.yml analogue: the service's UI advertised with
            # its endpoints (reference: webui_url in FrameworkInfo)
            out.setdefault("web", []).append(self._scheduler.spec.web_url)
        return out, backends

    def _endpoint_map(self) -> Dict[str, List[str]]:
        """port name -> ["host:port", ...] (the original surface)."""
        return self._assemble_endpoints()[0]

    def list_endpoints(self) -> Response:
        return 200, sorted(self._endpoint_map().keys())

    def get_endpoint(self, name: str) -> Response:
        """One endpoint's addresses, its backend rows (task, state,
        draining — the routing tier's discovery contract), and the
        generation stamp a poller compares to skip quiet refreshes."""
        import hashlib as _hashlib
        import json as _json

        entries, backends = self._assemble_endpoints()
        addresses = entries.get(name)
        if addresses is None:
            return 404, {"message": f"no endpoint {name}"}
        body: Dict[str, Any] = {
            "name": name,
            "address": sorted(addresses),
        }
        rows = backends.get(name)
        if rows:
            body["backends"] = sorted(
                rows, key=lambda r: (r["task"], r["address"])
            )
        # the stamp covers exactly what a poller CONSUMES: the base
        # task/reservation generations plus a fingerprint of this
        # endpoint's assembled surface.  Advertised ports are read
        # live (outside the base counters), so without the
        # fingerprint a transiently-failed servestats read could
        # hand out a wrong address that an equal stamp then caches
        # at the router until unrelated churn
        surface = _hashlib.sha256(_json.dumps(
            [body["address"], body.get("backends", [])],
            sort_keys=True,
        ).encode("utf-8")).hexdigest()[:12]
        body["generation"] = f"{self.endpoints_generation()}+{surface}"
        return 200, body

    # -- artifacts (reference: http/endpoints/ArtifactResource:50) ----

    def artifact_template(
        self, config_id: str, pod_type: str, task_name: str, template_name: str
    ) -> Response:
        """Serve a config template's raw content for the given stored
        configuration (tasks pull these at bootstrap and render them
        against their env, sdk/bootstrap/main.go:291-376)."""
        store = self._scheduler.config_store
        if store is None:
            return 503, {"message": "no config store"}
        data = store.fetch(config_id)
        if data is None:
            return 404, {"message": f"no config {config_id}"}
        from dcos_commons_tpu_torch.specification.specs import ServiceSpec

        spec = ServiceSpec.from_dict(data)
        try:
            task_spec = spec.pod(pod_type).task(task_name)
        except Exception:
            return 404, {"message": f"no task {pod_type}/{task_name}"}
        for template_path, dest in task_spec.config_templates:
            if os.path.basename(template_path) == template_name or \
                    dest == template_name:
                try:
                    with open(template_path, "r") as f:
                        return 200, f.read()
                except OSError as e:
                    return 500, {"message": f"cannot read template: {e}"}
        return 404, {"message": f"no template {template_name}"}

    # -- debug (reference: debug/*.java, /v1/debug) -------------------

    def debug_offers(self) -> Response:
        """Offer outcomes PLUS the fleet-scale evaluation state: the
        dirty-set size and cache hit rates of the incremental snapshot
        sync, index cardinalities, the requirement-memo/index counters
        and this service's suppress state — the first read in a
        slow-cycle triage (operations-guide)."""
        counters = self._scheduler.metrics.counters()
        evaluation: Dict[str, Any] = {}
        inventory = getattr(self._scheduler, "inventory", None)
        if inventory is not None and hasattr(inventory, "debug_stats"):
            evaluation = inventory.debug_stats()
        evaluation["counters"] = {
            key: counters[key]
            for key in (
                "offers.index.hit", "offers.index.scan",
                "offers.eval.shortcircuit", "offers.evaluated",
                "offers.declined", "suppresses", "revives",
            )
            if key in counters
        }
        # multi-service offer discipline: which services the fan-out
        # loop is currently skipping (attached by MultiServiceScheduler)
        discipline = getattr(self._scheduler, "offer_discipline", None)
        if callable(discipline):
            evaluation["discipline"] = discipline()
        return 200, {
            "outcomes": self._scheduler.outcome_tracker.to_json(),
            "evaluation": evaluation,
        }

    def debug_plans(self) -> Response:
        return 200, {
            name: serialize_plan(plan)
            for name, plan in self._scheduler.plans().items()
        }

    def debug_task_statuses(self) -> Response:
        from dcos_commons_tpu_torch.debug.trackers import TaskStatusesTracker

        return 200, TaskStatusesTracker(self._scheduler.state_store).to_json()

    def debug_reservations(self) -> Response:
        from dcos_commons_tpu_torch.debug.trackers import TaskReservationsTracker

        return 200, TaskReservationsTracker(self._scheduler.ledger).to_json()

    def debug_trace(self, fmt: Optional[str] = None) -> Response:
        """The traceview flight recorder: one causal timeline from
        offer intake through launch, status arrival, plan-step
        transition, and (via sandbox steplogs) the workers' own step
        loops.  ``?fmt=chrome`` returns Perfetto-loadable trace-event
        JSON (pid = service, tid lanes per pod); default is a plain-
        text timeline."""
        from dcos_commons_tpu_torch.trace.export import to_chrome, to_text

        tracer = getattr(self._scheduler, "tracer", None)
        if tracer is None:
            return 503, {"message": "no trace recorder"}
        steplogs = self._collect_steplogs()
        service = self._scheduler.spec.name
        if fmt == "chrome":
            return 200, to_chrome(tracer, service=service,
                                  steplogs=steplogs)
        if fmt not in (None, "", "text"):
            return 400, {"message": f"unknown trace format {fmt!r} "
                                    "(expected 'chrome' or 'text')"}
        # journal events (operator verbs, failovers, detector alerts)
        # render into the text timeline on a `journal` lane, so the
        # ssh-and-curl view shows causes next to the spans they caused
        journal = getattr(self._scheduler, "journal", None)
        events = journal.events() if journal is not None else None
        return 200, to_text(tracer, service=service, steplogs=steplogs,
                            events=events)

    def debug_health(self, metric: Optional[str] = None) -> Response:
        """The fleet health plane: detector states (straggler scores,
        suspect hosts, SLO breaches), journal stats, recent alerts,
        and the bounded metric history (summary rows by default;
        ``?metric=<name>`` returns that metric's full timestamped
        series with the derived rate for counters)."""
        health = getattr(self._scheduler, "health", None)
        if health is None:
            return 200, {"enabled": False}
        return 200, health.describe(self._scheduler, metric=metric)

    def debug_events(self, since: Optional[str] = None,
                     kind: Optional[str] = None) -> Response:
        """The durable event journal: operator verbs, plan-step
        transitions, failovers/lease epochs, admission rejections,
        recovery actions, detector alerts.  ``?since=<seq>`` resumes a
        cursor (seqs are monotonic ACROSS failovers); ``?kind=`` filters
        (e.g. ``alert``)."""
        journal = getattr(self._scheduler, "journal", None)
        if journal is None:
            return 200, {"enabled": False, "events": [], "seq": 0}
        try:
            since_seq = int(since) if since else 0
        except ValueError:
            return 400, {"message": f"bad since cursor {since!r}"}
        return 200, {
            "events": journal.events(
                since=since_seq, kinds=[kind] if kind else None
            ),
            "seq": journal.last_seq,
            "journal": journal.describe(),
        }

    def debug_ha(self) -> Response:
        """HA control-plane state: leader identity + lease expiry (the
        record in the replicated tree), this scheduler's lease epoch
        and failover count, fenced-write rejections, per-standby
        replication watermarks, and the last re-hydration report.
        The failover runbook (docs/operations-guide.md) reads this
        before and after a manual promotion."""
        ha = getattr(self._scheduler, "ha_state", None)
        if ha is None:
            body: Dict[str, Any] = {"enabled": False}
            report = getattr(self._scheduler, "last_rehydration", None)
            if report is not None:
                body["last_rehydration"] = report
            return 200, body
        return 200, ha.describe(refresh=True)

    def debug_serving(self) -> Response:
        """Per-pod serving load: each serve worker mirrors its engine
        gauges (queue depth, active slots, KV occupancy, tokens/s,
        TTFT percentiles) to its sandbox; this merges them per task —
        the signal a load-driven scale-out plan reads (ROADMAP item
        2), and the place an operator checks which pod is saturating
        before the 503s start."""
        reader = getattr(self._scheduler.agent, "serving_stats_of", None)
        if not callable(reader):
            return 200, {"serving": {}}
        out: Dict[str, dict] = {}
        for info in self._scheduler.state_store.fetch_tasks():
            try:
                stats = reader(info.name)
            except OSError:
                continue
            if stats:
                out[info.name] = stats
        return 200, {"serving": out}

    def debug_router(self) -> Response:
        """Serving-front-door state: every router task's gauge
        snapshot (pod set size, draining/failed counts, affinity hit
        rate, retries/failovers, latency percentiles — router/core.py
        ``stats()``), split out of the serving merge by the
        ``router_pods`` marker key, plus the endpoint generation the
        routers' discovery is tracking.  The prefix-affinity triage
        surface (operations-guide "Serving front door")."""
        reader = getattr(self._scheduler.agent, "serving_stats_of", None)
        routers: Dict[str, dict] = {}
        if callable(reader):
            for info in self._scheduler.state_store.fetch_tasks():
                try:
                    stats = reader(info.name)
                except OSError:
                    continue
                if isinstance(stats, dict) and "router_pods" in stats:
                    routers[info.name] = stats
        return 200, {
            "routers": routers,
            "endpoints_generation": self.endpoints_generation(),
        }

    def _collect_steplogs(self) -> Dict[str, List[dict]]:
        """Worker step telemetry, merged from task sandboxes when the
        agent surfaces them (LocalProcessAgent.steplog_of); remote
        fleets return {} until their daemons grow the same surface."""
        reader = getattr(self._scheduler.agent, "steplog_of", None)
        if not callable(reader):
            return {}
        out: Dict[str, List[dict]] = {}
        for info in self._scheduler.state_store.fetch_tasks():
            try:
                records = reader(info.name)
            except OSError:
                continue
            if records:
                out[info.name] = records
        return out

    # -- metrics ------------------------------------------------------

    def metrics_json(self) -> Response:
        return 200, self._scheduler.metrics.snapshot()

    def metrics_prometheus(self) -> Tuple[int, str]:
        return 200, self._scheduler.metrics.prometheus()

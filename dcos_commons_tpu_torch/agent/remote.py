"""RemoteFleet: the scheduler's view of a fleet of per-host agents.

Implements the Agent contract over HTTP against N AgentDaemon
processes (one per GPU host), making the control plane distributed in
fact: launches route to the daemon owning the task's placed host,
statuses are pulled over real sockets, and an unreachable daemon is
detected and surfaced as host-down + TASK_LOST so the recovery
machinery replaces its tasks — the role Mesos master partition
signals play for the reference (FrameworkRunner.java:185-189
PARTITION_AWARE; agent loss -> TASK_LOST fan-in).

Port of ``dcos_commons_tpu/agent/remote.py``, line for line but the
imports.  A fleet's ``agent_id`` is the ``GpuHost.host_id``, so card
ids stay ``"<host_id>/<k>"``.
"""

from __future__ import annotations

import json
import logging
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Set, Tuple

from dcos_commons_tpu_torch.agent.base import Agent
from dcos_commons_tpu_torch.agent.daemon import serialize_check
from dcos_commons_tpu_torch.common import TaskInfo, TaskState, TaskStatus

LOG = logging.getLogger(__name__)


class RemoteAgentClient:
    """HTTP client for one host's AgentDaemon."""

    def __init__(
        self,
        host_id: str,
        base_url: str,
        timeout_s: float = 5.0,
        launch_timeout_s: float = 30.0,
        auth_token: str = "",
        ca_file: str = "",
    ):
        from dcos_commons_tpu_torch.security import auth as _auth

        self.host_id = host_id
        self.base_url = base_url.rstrip("/")
        self.timeout_s = timeout_s
        # launches block on daemon-side template fetches (10s per
        # template); a timeout shorter than that would declare a
        # successfully-launching task LOST and double-book the slice
        self.launch_timeout_s = launch_timeout_s
        self._headers = {"Content-Type": "application/json",
                         **_auth.auth_headers(auth_token)}
        self._ssl_ctx = (
            _auth.client_ssl_context(ca_file)
            if self.base_url.startswith("https") else None
        )

    def _request(
        self,
        method: str,
        path: str,
        body: Optional[dict] = None,
        timeout_s: Optional[float] = None,
    ):
        data = json.dumps(body).encode("utf-8") if body is not None else None
        req = urllib.request.Request(
            f"{self.base_url}{path}",
            data=data,
            method=method,
            headers=dict(self._headers),
        )
        with urllib.request.urlopen(
            req,
            timeout=timeout_s if timeout_s is not None else self.timeout_s,
            context=self._ssl_ctx,
        ) as resp:
            return json.loads(resp.read().decode("utf-8"))

    def info(self) -> dict:
        return self._request("GET", "/v1/agent/info")

    def launch(self, entries: List[dict]) -> List[str]:
        # each config template may cost the daemon a fetch of up to 10s
        # (agent/local.py prepare_templates); size the RPC timeout to
        # the request or a false timeout here double-books the task
        n_templates = sum(len(e.get("templates") or []) for e in entries)
        # artifact downloads can be big (corpus/tokenizer staging);
        # digest-cached relaunches return fast but the first fetch
        # must not be declared dead mid-download
        n_uris = sum(len(e.get("uris") or []) for e in entries)
        return self._request(
            "POST",
            "/v1/agent/launch",
            {"tasks": entries},
            timeout_s=self.launch_timeout_s + 12.0 * n_templates
            + 130.0 * n_uris,
        )["launched"]

    def kill(self, task_id: str, grace_period_s: float) -> None:
        self._request(
            "POST",
            "/v1/agent/kill",
            {"task_id": task_id, "grace_period_s": grace_period_s},
        )

    def tasks(self) -> Set[str]:
        return set(self._request("GET", "/v1/agent/tasks")["task_ids"])

    def reconcile(self) -> None:
        self._request("POST", "/v1/agent/reconcile")

    def drain(self) -> List[TaskStatus]:
        raw = self._request("POST", "/v1/agent/drain")
        return [TaskStatus.from_dict(s) for s in raw["statuses"]]

    def steplog_of(self, task_name: str) -> List[dict]:
        """Worker step telemetry off the daemon's sandbox (the remote
        half of LocalProcessAgent.steplog_of)."""
        from urllib.parse import quote

        body = self._request(
            "GET", f"/v1/agent/steplog?task={quote(task_name)}"
        )
        records = body.get("records")
        return records if isinstance(records, list) else []

    def serving_stats_of(self, task_name: str) -> dict:
        """Serving-engine gauges off the daemon's sandbox."""
        from urllib.parse import quote

        body = self._request(
            "GET", f"/v1/agent/servestats?task={quote(task_name)}"
        )
        stats = body.get("stats")
        return stats if isinstance(stats, dict) else {}

    def sandbox_file(self, task_name: str, rel: str = "stdout") -> str:
        from urllib.parse import quote

        req = urllib.request.Request(
            f"{self.base_url}/v1/agent/sandbox"
            f"?task={quote(task_name)}&file={quote(rel)}",
            headers=dict(self._headers),
        )
        with urllib.request.urlopen(
            req, timeout=self.timeout_s, context=self._ssl_ctx
        ) as resp:
            return resp.read().decode("utf-8")


class RemoteFleet(Agent):
    """Agent multiplexer over per-host daemons, keyed by ``agent_id``.

    Host-down detection: ``down_after`` consecutive failed polls of a
    daemon declare its host down — tracked tasks on it get synthesized
    TASK_LOST and ``on_host_down(host_id)`` fires (the runner wires it
    to SliceInventory.mark_down so placement stops offering the host).
    A successful poll afterwards fires ``on_host_up``.
    """

    is_remote = True

    def __init__(
        self,
        timeout_s: float = 5.0,
        down_after: int = 3,
        on_host_down: Optional[Callable[[str], None]] = None,
        on_host_up: Optional[Callable[[str], None]] = None,
        auth_token: str = "",
        ca_file: str = "",
    ):
        self._clients: Dict[str, RemoteAgentClient] = {}
        self._timeout_s = timeout_s
        self._auth_token = auth_token
        self._ca_file = ca_file
        self._down_after = down_after
        self._failures: Dict[str, int] = {}
        self._down: Set[str] = set()
        # task_id -> host_id for kill routing + LOST synthesis; rebuilt
        # lazily from daemon task lists after a scheduler restart
        self._owners: Dict[str, str] = {}
        # telemetry routes by task NAME: a generation-stamped lazy
        # index over _owners (every mutation bumps _owners_gen, the
        # index rebuilds once per change) — the health monitor makes
        # TWO name lookups per task per refresh, and a linear
        # owner-map scan per lookup would be O(tasks^2) per refresh
        # under the fleet lock
        self._owners_gen = 0
        self._owner_names: Dict[str, str] = {}
        self._owner_names_gen = -1
        self._pending: List[TaskStatus] = []
        self.on_host_down = on_host_down
        self.on_host_up = on_host_up
        self._lock = threading.RLock()
        # per-host RPCs fan out concurrently so one unreachable host's
        # connect timeout cannot stall the whole scheduler cycle
        self._pool: Optional[ThreadPoolExecutor] = None

    def _fan_out(self, fn) -> List[Tuple[str, object]]:
        """Run ``fn(host_id, client)`` for every host concurrently;
        returns [(host_id, result-or-exception)] in host order."""
        with self._lock:
            clients = sorted(self._clients.items())
            if self._pool is None or self._pool._max_workers < len(clients):
                if self._pool is not None:
                    self._pool.shutdown(wait=False)
                self._pool = ThreadPoolExecutor(
                    max_workers=max(4, len(clients)),
                    thread_name_prefix="fleet-rpc",
                )
            pool = self._pool

        def call(item):
            host_id, client = item
            try:
                return host_id, fn(host_id, client)
            except Exception as e:  # scored by the caller
                return host_id, e

        return list(pool.map(call, clients))

    def add_host(self, host_id: str, url: str) -> None:
        with self._lock:
            self._clients[host_id] = RemoteAgentClient(
                host_id, url, self._timeout_s,
                auth_token=self._auth_token, ca_file=self._ca_file,
            )
            self._failures[host_id] = 0

    def hosts(self) -> List[str]:
        with self._lock:
            return sorted(self._clients)

    def client(self, host_id: str) -> Optional[RemoteAgentClient]:
        return self._clients.get(host_id)

    # -- Agent --------------------------------------------------------

    def launch(self, task_infos: List[TaskInfo]) -> None:
        for info in task_infos:
            self.launch_one(info)

    def launch_one(
        self,
        info: TaskInfo,
        readiness=None,
        health=None,
        templates: Optional[List[dict]] = None,
        files: Optional[List[dict]] = None,
        secret_env: Optional[Dict[str, str]] = None,
        kill_grace_s: float = 5.0,
        uris: Optional[List[dict]] = None,
        rlimits: Optional[List[dict]] = None,
    ) -> None:
        client = self._clients.get(info.agent_id)
        if client is None:
            self._fail_launch(info, f"no agent for host {info.agent_id!r}")
            return
        entry = {
            "info": info.to_dict(),
            "readiness": serialize_check(readiness),
            "health": serialize_check(health),
            "templates": templates or [],
            "files": files or [],
            "secret_env": secret_env or {},
            "kill_grace_s": kill_grace_s,
            "uris": uris or [],
            "rlimits": rlimits or [],
        }
        try:
            client.launch([entry])
        except (urllib.error.URLError, OSError, json.JSONDecodeError) as e:
            # the daemon may be mid-crash: surface LOST so recovery
            # replaces the task instead of the step hanging in STARTING
            self._fail_launch(info, f"agent unreachable at launch: {e}")
            return
        with self._lock:
            if self._owners.get(info.task_id) != info.agent_id:
                self._owners[info.task_id] = info.agent_id
                self._owners_gen += 1

    def _fail_launch(self, info: TaskInfo, message: str) -> None:
        LOG.warning("launch of %s failed: %s", info.task_id, message)
        with self._lock:
            self._pending.append(
                TaskStatus(
                    task_id=info.task_id,
                    state=TaskState.LOST,
                    message=message,
                    agent_id=info.agent_id,
                )
            )

    def kill(self, task_id: str, grace_period_s: float = 0.0) -> None:
        with self._lock:
            owner = self._owners.get(task_id)
        if owner and owner in self._clients:
            try:
                self._clients[owner].kill(task_id, grace_period_s)
            except (urllib.error.URLError, OSError):
                pass  # TaskKiller retries until a terminal status lands
            return
        # unknown owner (restart before any poll): broadcast — kill of
        # an unknown id is an idempotent no-op daemon-side
        self._fan_out(lambda _h, c: c.kill(task_id, grace_period_s))

    def active_task_ids(self) -> Set[str]:
        out: Set[str] = set()
        for host_id, result in self._fan_out(lambda _h, c: c.tasks()):
            if isinstance(result, Exception):
                # liveness is only scored by poll() — a scheduler cycle
                # calls both methods, and double-counting would halve
                # the documented down_after threshold.  A down host's
                # tasks count as active until LOST is synthesized by
                # poll(), so the reconciler doesn't double-report them.
                with self._lock:
                    out |= {
                        t for t, h in self._owners.items() if h == host_id
                    }
                continue
            self._note_success(host_id)
            with self._lock:
                for task_id in result:
                    if task_id not in self._owners:
                        self._owners[task_id] = host_id
                        self._owners_gen += 1
            out |= result
        return out

    def reconcile(self) -> None:
        """Explicit reconciliation across the fleet (the Reconciler's
        startup hook): every reachable daemon re-arms its tasks'
        CURRENT states for the next drain, so statuses a dead
        scheduler drained but never acted on are re-delivered to its
        successor.  Best-effort per host — an unreachable daemon's
        tasks are handled by poll()'s down-host LOST synthesis."""
        for host_id, result in self._fan_out(
            lambda _h, c: c.reconcile()
        ):
            if isinstance(result, Exception):
                LOG.info("reconcile skipped on %s: %s", host_id, result)

    def poll(self) -> List[TaskStatus]:
        out: List[TaskStatus] = []
        with self._lock:
            out.extend(self._pending)
            self._pending.clear()
        for host_id, statuses in self._fan_out(lambda _h, c: c.drain()):
            if isinstance(statuses, Exception):
                self._note_failure(host_id)
                # the threshold may have been crossed by a failed
                # active_task_ids() call between polls; LOST synthesis
                # is idempotent (owners entries are consumed), so run
                # it whenever the host is down
                with self._lock:
                    is_down = host_id in self._down
                if is_down:
                    out.extend(self._lose_tasks_on(host_id))
                continue
            self._note_success(host_id)
            for status in statuses:
                with self._lock:
                    # bump the generation only when the map actually
                    # changed: a reconcile()-re-emitted RUNNING is a
                    # no-op here, and a spurious bump would rebuild
                    # the telemetry name index every refresh
                    if status.state.is_terminal:
                        if self._owners.pop(status.task_id, None) is not None:
                            self._owners_gen += 1
                    elif status.task_id not in self._owners:
                        self._owners[status.task_id] = host_id
                        self._owners_gen += 1
                out.append(status)
        return out

    # -- host liveness ------------------------------------------------

    def _note_failure(self, host_id: str) -> bool:
        """Returns True when this failure crosses the down threshold."""
        with self._lock:
            self._failures[host_id] = self._failures.get(host_id, 0) + 1
            if (
                self._failures[host_id] >= self._down_after
                and host_id not in self._down
            ):
                self._down.add(host_id)
                LOG.warning(
                    "agent %s unreachable %d times: declaring host down",
                    host_id, self._failures[host_id],
                )
                callback = self.on_host_down
            else:
                return False
        if callback is not None:
            callback(host_id)
        return True

    def _note_success(self, host_id: str) -> None:
        with self._lock:
            self._failures[host_id] = 0
            if host_id not in self._down:
                return
            self._down.discard(host_id)
            callback = self.on_host_up
        LOG.info("agent %s reachable again: host back up", host_id)
        if callback is not None:
            callback(host_id)

    def _lose_tasks_on(self, host_id: str) -> List[TaskStatus]:
        with self._lock:
            lost = [t for t, h in self._owners.items() if h == host_id]
            for task_id in lost:
                del self._owners[task_id]
            if lost:
                self._owners_gen += 1
        return [
            TaskStatus(
                task_id=task_id,
                state=TaskState.LOST,
                message=f"host {host_id} unreachable",
                agent_id=host_id,
            )
            for task_id in lost
        ]

    def down_hosts(self) -> Set[str]:
        with self._lock:
            return set(self._down)

    # -- worker telemetry fan-in (best-effort) ------------------------

    def _owner_client(self, task_name: str) -> Optional[RemoteAgentClient]:
        """The daemon holding ``task_name``'s sandbox, via the
        name-keyed owner index (rebuilt from the owner map only when
        it changed — so a telemetry refresh over N tasks costs O(N)
        once, not O(N^2); the owner map itself is rebuilt from daemon
        task lists after a restart, so a freshly failed-over scheduler
        regains telemetry after its first poll)."""
        from dcos_commons_tpu_torch.common import task_name_of

        with self._lock:
            if self._owner_names_gen != self._owners_gen:
                names: Dict[str, str] = {}
                for task_id, host_id in self._owners.items():
                    try:
                        names[task_name_of(task_id)] = host_id
                    except ValueError:
                        continue
                self._owner_names = names
                self._owner_names_gen = self._owners_gen
            host_id = self._owner_names.get(task_name)
            if host_id is None or host_id in self._down:
                return None
            return self._clients.get(host_id)

    def _telemetry_client(
        self, task_name: str, agent_id: Optional[str]
    ) -> Optional[RemoteAgentClient]:
        """Callers that know which host owns the task (the health
        monitor reads ``info.agent_id`` from its own state store) pass
        it and route EXACTLY — task names are not service-qualified,
        so on a fleet shared by several services the name index could
        hand service A another service's same-named task.  Name-based
        lookup stays as the fallback for host-agnostic callers."""
        if agent_id:
            with self._lock:
                if agent_id in self._down:
                    return None
                return self._clients.get(agent_id)
        return self._owner_client(task_name)

    def steplog_of(
        self, task_name: str, agent_id: Optional[str] = None
    ) -> List[dict]:
        """Worker step telemetry over the wire — the production
        topology's half of the /v1/debug/trace merge and the
        straggler detector's input.  Best-effort by contract: no
        owner, a down host, or a failed RPC reads as "no telemetry",
        never as an error (liveness is poll()'s job — a telemetry
        probe must not move the down-detection counters)."""
        client = self._telemetry_client(task_name, agent_id)
        if client is None:
            return []
        try:
            return client.steplog_of(task_name)
        except (urllib.error.URLError, OSError, json.JSONDecodeError,
                ValueError):
            return []

    def serving_stats_of(
        self, task_name: str, agent_id: Optional[str] = None
    ) -> dict:
        """Serving-engine gauges over the wire (same best-effort
        contract as steplog_of)."""
        client = self._telemetry_client(task_name, agent_id)
        if client is None:
            return {}
        try:
            return client.serving_stats_of(task_name)
        except (urllib.error.URLError, OSError, json.JSONDecodeError,
                ValueError):
            return {}

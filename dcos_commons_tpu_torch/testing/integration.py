"""Integration-test harness: drive a SERVED scheduler over HTTP.

Reference: testing/sdk_plan.py:29-333 (wait_for_completed_deployment,
wait_for_plan_status, force_complete), testing/sdk_tasks.py (task-id
snapshots asserting which tasks restarted across an operation), and
testing/sdk_install.py (process launch + teardown).  Where the
reference drives a real DC/OS cluster through the dcos CLI, this
drives real scheduler/agent *processes* through their HTTP APIs —
everything crosses sockets, nothing is in-process.

Port of ``dcos_commons_tpu/testing/integration.py``, line for line but
the imports: the processes it spawns are ``python -m
dcos_commons_tpu_torch ...``.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional

from dcos_commons_tpu_torch.cli.client import ApiClient, CliError


class WaitTimeout(AssertionError):
    pass


def wait_for(predicate, timeout_s: float = 30.0, interval_s: float = 0.1,
             what: str = "condition"):
    """Poll until ``predicate()`` is truthy; returns its value."""
    deadline = time.monotonic() + timeout_s
    last_error: Optional[Exception] = None
    while time.monotonic() < deadline:
        try:
            value = predicate()
            if value:
                return value
            last_error = None
        except (CliError, OSError) as e:
            last_error = e
        time.sleep(interval_s)
    detail = f" (last error: {last_error})" if last_error else ""
    raise WaitTimeout(f"timed out after {timeout_s}s waiting for {what}{detail}")


class ServiceClient(ApiClient):
    """sdk_plan + sdk_tasks vocabulary over one served scheduler."""

    # -- sdk_plan analogues ------------------------------------------

    def plan_status(self, plan: str) -> str:
        return self.get(f"/v1/plans/{plan}")["status"]

    def wait_for_plan_status(
        self, plan: str, status: str = "COMPLETE", timeout_s: float = 60.0
    ) -> dict:
        def check():
            body = self.get(f"/v1/plans/{plan}")
            return body if body["status"] == status else None

        return wait_for(
            check, timeout_s, what=f"plan {plan} to reach {status}"
        )

    def wait_for_completed_deployment(self, timeout_s: float = 60.0) -> dict:
        plans = wait_for(
            lambda: self.get("/v1/plans"), timeout_s, what="plan list"
        )
        plan = "update" if "update" in plans else "deploy"
        return self.wait_for_plan_status(plan, "COMPLETE", timeout_s)

    def wait_for_completed_recovery(self, timeout_s: float = 60.0) -> dict:
        return self.wait_for_plan_status("recovery", "COMPLETE", timeout_s)

    def force_complete(self, plan: str, phase: str, step: str) -> None:
        self.post(
            f"/v1/plans/{plan}/forceComplete",
            {"phase": phase, "step": step},
        )

    # -- sdk_tasks analogues -----------------------------------------

    def task_ids(self, prefix: str = "") -> Dict[str, str]:
        """Snapshot of task name -> live task id (sdk_tasks.get_task_ids)."""
        out: Dict[str, str] = {}
        for pod in self.get("/v1/pod/status")["pods"]:
            for instance in pod["instances"]:
                for task in instance["tasks"]:
                    if task["id"] and task["name"].startswith(prefix):
                        out[task["name"]] = task["id"]
        return out

    def wait_for_tasks_updated(
        self, old_ids: Dict[str, str], prefix: str = "",
        timeout_s: float = 60.0,
    ) -> Dict[str, str]:
        """Every task under ``prefix`` must have a NEW id and be running
        (sdk_tasks.check_tasks_updated)."""
        def check():
            now = self.task_ids(prefix)
            relevant = {n: i for n, i in old_ids.items()
                        if n.startswith(prefix)}
            if not now or set(now) < set(relevant):
                return None
            changed = all(
                now.get(name) and now[name] != old_id
                for name, old_id in relevant.items()
            )
            return now if changed else None

        return wait_for(
            check, timeout_s, what=f"tasks {prefix or '*'} to be replaced"
        )

    def check_tasks_not_updated(
        self, old_ids: Dict[str, str], prefix: str = ""
    ) -> None:
        now = self.task_ids(prefix)
        for name, old_id in old_ids.items():
            if not name.startswith(prefix):
                continue
            assert now.get(name) == old_id, (
                f"task {name} restarted: {old_id} -> {now.get(name)}"
            )

    def wait_for_task_state(
        self, task_name: str, state: str, timeout_s: float = 60.0
    ) -> None:
        def check():
            for pod in self.get("/v1/pod/status")["pods"]:
                for instance in pod["instances"]:
                    for task in instance["tasks"]:
                        if task["name"] == task_name and \
                                task["status"] == state:
                            return True
            return None

        wait_for(check, timeout_s, what=f"{task_name} to reach {state}")


# ---------------------------------------------------------------------------
# Process harness: launch real scheduler + agent processes
# ---------------------------------------------------------------------------


def _read_announce(path: str, timeout_s: float = 20.0) -> str:
    def check():
        if os.path.exists(path):
            with open(path) as f:
                content = f.read().strip()
            return content or None
        return None

    return wait_for(check, timeout_s, what=f"announce file {path}")


class AgentProcess:
    """One agent daemon subprocess (a simulated GPU host)."""

    def __init__(self, host_id: str, workdir: str, repo_root: str = "",
                 extra_args: Optional[List[str]] = None):
        self.host_id = host_id
        self.workdir = workdir
        announce = os.path.join(workdir, "announce")
        os.makedirs(workdir, exist_ok=True)
        if os.path.exists(announce):
            os.remove(announce)  # never read a previous run's port
        self._log = open(os.path.join(workdir, "agent.log"), "ab")
        self.process = subprocess.Popen(
            [
                sys.executable, "-m", "dcos_commons_tpu_torch", "agent",
                "--host-id", host_id,
                "--workdir", os.path.join(workdir, "sandboxes"),
                "--announce-file", announce,
                *(extra_args or []),
            ],
            cwd=repo_root or None,
            stdout=self._log,
            stderr=subprocess.STDOUT,
        )
        announced = _read_announce(announce)
        self.url = announced.split()[-1]

    def kill(self) -> None:
        """Hard-kill the daemon — the host-failure injection."""
        self.process.kill()
        self.process.wait(timeout=10)
        self._log.close()

    def stop(self) -> None:
        if self.process.poll() is None:
            self.process.terminate()
            try:
                self.process.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.process.kill()
                self.process.wait(timeout=10)
        if not self._log.closed:
            self._log.close()


def start_state_server(workdir: str, repo_root: str = "",
                       standby_of: str = ""):
    """Spawn a ``state-server`` subprocess; returns (proc, state_url,
    log_file).  Caller terminates the proc and closes the log.
    ``standby_of`` runs it as a hot standby of that primary URL."""
    announce = os.path.join(workdir, "state-announce")
    os.makedirs(workdir, exist_ok=True)
    if os.path.exists(announce):
        os.remove(announce)
    log = open(os.path.join(workdir, "state-server.log"), "ab")
    proc = subprocess.Popen(
        [
            sys.executable, "-m", "dcos_commons_tpu_torch", "state-server",
            "--data-dir", os.path.join(workdir, "data"),
            "--announce-file", announce,
            *(("--standby-of", standby_of) if standby_of else ()),
        ],
        cwd=repo_root or None,
        stdout=log,
        stderr=subprocess.STDOUT,
    )
    url = _read_announce(announce)
    return proc, url, log


def promote_state_server(standby_url: str, fence_old: str = "",
                         repo_root: str = "") -> None:
    """Operator failover verb: promote the standby at ``standby_url``
    to primary (``state-server --promote``); optionally demote a
    still-reachable old primary."""
    subprocess.run(
        [
            sys.executable, "-m", "dcos_commons_tpu_torch", "state-server",
            "--promote", standby_url,
            *(("--fence-old", fence_old) if fence_old else ()),
        ],
        cwd=repo_root or None,
        check=True,
        capture_output=True,
        timeout=30,
    )


def reap_orphan_tasks(agents) -> None:
    """Kill task process groups that outlive their daemons.  Stopping
    (or killing) a daemon leaves its supervised tasks RUNNING by
    design — durable-task semantics — so tests that launch real
    long-running commands must reap them or leak processes into the
    host.  Pids come from the supervisors' durable records."""
    for agent in agents:
        root = os.path.join(agent.workdir, "sandboxes")
        for dirpath, _dirs, files in os.walk(root):
            for name in ("child.pid", "task.pid"):
                if name not in files:
                    continue
                try:
                    pid = int(open(os.path.join(dirpath, name)).read())
                    os.killpg(pid, signal.SIGKILL)
                except (OSError, ValueError):
                    pass


class SchedulerProcess:
    """One served scheduler subprocess (``dcos_commons_tpu_torch serve``)."""

    def __init__(
        self,
        svc_yml: str,
        topology_yml: str,
        workdir: str,
        env: Optional[Dict[str, str]] = None,
        repo_root: str = "",
        wait_listening: bool = True,
        extra_args: Optional[List[str]] = None,
        auth_token: str = "",
        ca_file: str = "",
    ):
        self.auth_token = auth_token
        self.ca_file = ca_file
        self.workdir = workdir
        self._svc_yml = svc_yml
        self._topology_yml = topology_yml
        self._env = dict(env or {})
        self._repo_root = repo_root
        self._extra_args = list(extra_args or [])
        announce = os.path.join(workdir, "announce")
        os.makedirs(workdir, exist_ok=True)
        if os.path.exists(announce):
            os.remove(announce)  # never read a previous run's port
        run_env = dict(os.environ)
        run_env.update(env or {})
        self._log = open(os.path.join(workdir, "scheduler.log"), "ab")
        self.process = subprocess.Popen(
            [
                sys.executable, "-m", "dcos_commons_tpu_torch", "serve",
                svc_yml,
                "--topology", topology_yml,
                "--port", "0",
                "--state-dir", os.path.join(workdir, "state"),
                "--sandbox-root", os.path.join(workdir, "sandboxes"),
                "--announce-file", announce,
                *(extra_args or []),
            ],
            cwd=repo_root or None,
            env=run_env,
            stdout=self._log,
            stderr=subprocess.STDOUT,
        )
        self.url = _read_announce(announce) if wait_listening else ""

    def client(self) -> ServiceClient:
        return ServiceClient(
            self.url, auth_token=self.auth_token, ca_file=self.ca_file
        )

    def terminate(self) -> int:
        if self.process.poll() is None:
            self.process.terminate()
        try:
            return self.process.wait(timeout=15)
        except subprocess.TimeoutExpired:
            self.process.kill()
            return self.process.wait(timeout=10)
        finally:
            if not self._log.closed:
                self._log.close()

    def upgrade(
        self,
        svc_yml: Optional[str] = None,
        env: Optional[Dict[str, str]] = None,
        timeout_s: float = 90.0,
    ) -> "SchedulerProcess":
        """The sdk_upgrade analogue: stop this scheduler, start a new
        one over the SAME state with a changed service definition or
        env, and wait for the resulting update plan to complete.

        Returns the new SchedulerProcess (self is terminated).
        Reference: testing/sdk_upgrade.py — bump the package/options,
        wait_for_completed_deployment."""
        assert self.terminate() == 0, self.log_tail()
        successor = SchedulerProcess(
            svc_yml or self._svc_yml,
            self._topology_yml,
            self.workdir,
            env={**(self._env or {}), **(env or {})},
            repo_root=self._repo_root,
            extra_args=self._extra_args,
            auth_token=self.auth_token,
            ca_file=self.ca_file,
        )
        client = successor.client()

        def rolled_out():
            # rollout after a completed deployment is the 'update' plan
            for plan in ("update", "deploy"):
                try:
                    if client.plan_status(plan) == "COMPLETE":
                        return True
                except CliError:
                    continue
            return None

        wait_for(rolled_out, timeout_s, what="post-upgrade rollout")
        return successor

    def log_tail(self, lines: int = 40) -> str:
        path = os.path.join(self.workdir, "scheduler.log")
        if not os.path.exists(path):
            return ""
        with open(path, errors="replace") as f:
            return "\n".join(f.read().splitlines()[-lines:])

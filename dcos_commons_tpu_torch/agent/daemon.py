"""Per-host agent daemon: the task-running half of the control plane.

One daemon process runs on each GPU host and exposes the Agent
contract over HTTP to the scheduler.  This is the rebuild's analogue of
the Mesos agent + the reference's task-side bootstrap binary rolled
into one long-lived process: launch/kill/status cross a real network
boundary (reference: FrameworkScheduler.java:196 callbacks crossing the
Mesos master process boundary; sdk/bootstrap/main.go doing task-side
sandbox preparation), sandboxes are provisioned locally, and config
templates are pulled from the scheduler's /v1/artifacts endpoint and
rendered against the task env (sdk/bootstrap/main.go:291-376).

Protocol (JSON over HTTP, scheduler -> agent):

    GET  /v1/agent/info    {host_id, active, uptime_s}
    POST /v1/agent/launch  {tasks: [{info, readiness?, health?, templates?}]}
    POST /v1/agent/kill    {task_id, grace_period_s}
    GET  /v1/agent/tasks   {task_ids: [...]}
    POST /v1/agent/drain   -> {statuses: [...]}   (drains pending updates)
    POST /v1/agent/reconcile  (re-arm current task states for re-delivery)
    GET  /v1/agent/sandbox?task=<name>&file=<rel> -> file text (debugging)
    GET  /v1/agent/steplog?task=<name>    -> {records: [...]}  (telemetry)
    GET  /v1/agent/servestats?task=<name> -> {stats: {...}}    (telemetry)

Statuses are *pulled* by the scheduler (drain), matching the poll-based
Agent contract — the daemon never needs to know where the scheduler
lives, which keeps scheduler failover trivial.

Port of ``dcos_commons_tpu/agent/daemon.py``, line for line but the
imports and the ``--provision-cmd`` help: a host's first deploy here
pays the kernel build into ``build/kernels/``, not an XLA compile.
``serialize_check`` lives in ``agent/local.py`` and is re-exported.
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from dcos_commons_tpu_torch.agent.local import (  # noqa: F401
    LocalProcessAgent,
    serialize_check,
)
from dcos_commons_tpu_torch.common import TaskInfo
from dcos_commons_tpu_torch.specification.specs import (
    HealthCheckSpec,
    ReadinessCheckSpec,
)


class AgentDaemon:
    """HTTP front end over a LocalProcessAgent for ONE host."""

    def __init__(
        self,
        host_id: str,
        workdir: str,
        port: int = 0,
        bind: str = "127.0.0.1",
        advertise_host: str = "",
        auth_token: str = "",
        tls=None,
        ca_file: str = "",
    ):
        from dcos_commons_tpu_torch.security import auth as _auth

        self.host_id = host_id
        # a daemon bound to 0.0.0.0 must announce a routable address
        # (the scheduler dials what the announce file says); mirrors the
        # runner's --advertise-url
        self.advertise_host = advertise_host
        self._executor = LocalProcessAgent(
            workdir, auth_token=auth_token, ca_file=ca_file
        )
        self._started_at = time.monotonic()
        self._scheme = _auth.url_scheme(tls)
        daemon = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _authorized(self) -> bool:
                # launch IS remote command execution: with a token set,
                # EVERY agent route (including sandbox reads) requires
                # it — there is no anonymous surface on a daemon
                if _auth.check_bearer(self.headers, auth_token):
                    return True
                self._reply(*_auth.UNAUTHORIZED)
                return False

            def _body(self) -> dict:
                length = int(self.headers.get("Content-Length", 0))
                if not length:
                    return {}
                return json.loads(self.rfile.read(length).decode("utf-8"))

            def _reply(self, code: int, body) -> None:
                if isinstance(body, str):
                    payload = body.encode("utf-8")
                    ctype = "text/plain; charset=utf-8"
                else:
                    payload = json.dumps(body).encode("utf-8")
                    ctype = "application/json"
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def do_GET(self):
                if not self._authorized():
                    return
                parsed = urlparse(self.path)
                try:
                    if parsed.path == "/v1/agent/info":
                        self._reply(200, daemon.info())
                    elif parsed.path == "/v1/agent/tasks":
                        self._reply(
                            200,
                            {"task_ids": sorted(
                                daemon._executor.active_task_ids()
                            )},
                        )
                    elif parsed.path == "/v1/agent/sandbox":
                        query = parse_qs(parsed.query)
                        task = (query.get("task") or [""])[0]
                        rel = (query.get("file") or ["stdout"])[0]
                        path = daemon.resolve_sandbox_path(task, rel)
                        if path is None or not os.path.isfile(path):
                            self._reply(404, {"message": f"no file {rel}"})
                            return
                        # the file can vanish between the isfile check
                        # and the open (sandbox GC race) — the outer
                        # guard turns that into a 500, not a dropped
                        # connection
                        with open(path, "r", errors="replace") as f:
                            self._reply(200, f.read())
                    elif parsed.path == "/v1/agent/steplog":
                        # worker step telemetry for the scheduler's
                        # traceview merge + straggler detector (the
                        # remote half of LocalProcessAgent.steplog_of)
                        query = parse_qs(parsed.query)
                        task = (query.get("task") or [""])[0]
                        if not daemon.valid_task_name(task):
                            self._reply(404, {"message": "bad task name"})
                            return
                        self._reply(200, {
                            "records": daemon._executor.steplog_of(task)
                        })
                    elif parsed.path == "/v1/agent/servestats":
                        query = parse_qs(parsed.query)
                        task = (query.get("task") or [""])[0]
                        if not daemon.valid_task_name(task):
                            self._reply(404, {"message": "bad task name"})
                            return
                        self._reply(200, {
                            "stats": daemon._executor.serving_stats_of(task)
                        })
                    else:
                        self._reply(
                            404, {"message": f"no route {parsed.path}"}
                        )
                except Exception as e:
                    self._reply(500, {"message": f"agent error: {e}"})

            def do_POST(self):
                if not self._authorized():
                    return
                parsed = urlparse(self.path)
                try:
                    if parsed.path == "/v1/agent/launch":
                        body = self._body()
                        launched = daemon.launch(body.get("tasks", []))
                        self._reply(200, {"launched": launched})
                    elif parsed.path == "/v1/agent/kill":
                        body = self._body()
                        daemon._executor.kill(
                            body["task_id"],
                            float(body.get("grace_period_s", 0.0)),
                        )
                        self._reply(200, {"message": "kill requested"})
                    elif parsed.path == "/v1/agent/drain":
                        statuses = [
                            s.to_dict() for s in daemon._executor.poll()
                        ]
                        self._reply(200, {"statuses": statuses})
                    elif parsed.path == "/v1/agent/reconcile":
                        # explicit reconciliation: a failed-over
                        # scheduler asks for CURRENT task states —
                        # transitions a dead predecessor drained are
                        # re-armed for the next drain
                        daemon._executor.reconcile()
                        self._reply(200, {"message": "reconcile armed"})
                    else:
                        self._reply(404, {"message": f"no route {parsed.path}"})
                except Exception as e:
                    self._reply(500, {"message": f"agent error: {e}"})

        self._server = _auth.wrap_http_server(
            ThreadingHTTPServer((bind, port), Handler), tls
        )
        self._thread: Optional[threading.Thread] = None

    # -- request handling --------------------------------------------

    def valid_task_name(self, task: str) -> bool:
        """Task names are attacker-controlled query params; the
        steplog/servestats readers join them onto the workdir, so the
        same confinement as sandbox reads applies."""
        return bool(task) and os.sep not in task and task not in (".", "..")

    def resolve_sandbox_path(self, task: str, rel: str) -> Optional[str]:
        """Confine sandbox reads to the named task's sandbox: both the
        task name and the relative path are attacker-controlled query
        params, so resolve symlinks/.. and require the result to stay
        under ``<workdir>/<task>/``."""
        if not task or os.sep in task or task in (".", ".."):
            return None
        sandbox = os.path.realpath(self._executor.sandbox_of(task))
        workdir_prefix = os.path.realpath(self._executor._workdir) + os.sep
        if not sandbox.startswith(workdir_prefix):
            return None
        path = os.path.realpath(os.path.join(sandbox, rel))
        if path != sandbox and not path.startswith(sandbox + os.sep):
            return None
        return path

    def info(self) -> dict:
        return {
            "host_id": self.host_id,
            "active": len(self._executor.active_task_ids()),
            "uptime_s": round(time.monotonic() - self._started_at, 1),
            "pid": os.getpid(),
        }

    def launch(self, tasks: list) -> list:
        launched = []
        for entry in tasks:
            info = TaskInfo.from_dict(entry["info"])
            readiness = entry.get("readiness")
            health = entry.get("health")
            self._executor.launch_one(
                info,
                readiness=ReadinessCheckSpec(**readiness) if readiness else None,
                health=HealthCheckSpec(**health) if health else None,
                templates=entry.get("templates"),
                files=entry.get("files"),
                secret_env=entry.get("secret_env"),
                kill_grace_s=float(entry.get("kill_grace_s", 5.0)),
                uris=entry.get("uris"),
                rlimits=entry.get("rlimits"),
            )
            launched.append(info.task_id)
        return launched

    # -- lifecycle ----------------------------------------------------

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    @property
    def url(self) -> str:
        host, port = self._server.server_address[:2]
        if self.advertise_host:
            host = self.advertise_host
        elif host in ("0.0.0.0", "::"):
            import socket

            host = socket.gethostname()
        return f"{self._scheme}://{host}:{port}"

    def start(self) -> "AgentDaemon":
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name=f"agent-{self.host_id}",
            daemon=True,
        )
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self._server.serve_forever()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._executor.shutdown()


def _tls_pair_or_die(cert: str, key: str):
    from dcos_commons_tpu_torch.security.auth import tls_pair

    try:
        return tls_pair(cert, key)
    except ValueError as e:
        import sys

        print(f"configuration error: {e}", file=sys.stderr)
        raise SystemExit(4)  # EXIT_BAD_CONFIG


def main(argv: Optional[list] = None) -> int:
    """``python -m dcos_commons_tpu_torch agent`` — run one host's daemon."""
    import argparse

    parser = argparse.ArgumentParser(
        prog="dcos_commons_tpu_torch agent", description=__doc__.splitlines()[0]
    )
    parser.add_argument("--host-id", required=True)
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--bind", default="127.0.0.1")
    parser.add_argument(
        "--advertise-host",
        default="",
        help="hostname/IP to announce instead of the bind address "
             "(required when binding 0.0.0.0 on a multi-host fleet)",
    )
    parser.add_argument("--workdir", default="./agent-sandboxes")
    parser.add_argument(
        "--announce-file",
        default="",
        help="write '<host_id> <url>' here once listening (ephemeral ports)",
    )
    parser.add_argument(
        "--auth-token-file",
        default="",
        help="cluster bearer token file; also $AUTH_TOKEN(_FILE). "
             "REQUIRED for non-loopback binds (launch = remote exec)",
    )
    parser.add_argument("--tls-cert", default="", help="serve HTTPS: cert PEM")
    parser.add_argument("--tls-key", default="", help="serve HTTPS: key PEM")
    parser.add_argument(
        "--tls-ca", default="",
        help="CA bundle for verifying the scheduler's HTTPS artifact "
             "endpoint; also $TLS_CA_FILE",
    )
    parser.add_argument(
        "--provision-cmd", default="",
        help="host provisioning command run ONCE before serving "
             "(shell): e.g. build the CUDA kernels into build/kernels/ "
             "so a fresh host's first deploy finds them built, not "
             "paying nvcc inside its first task.  A "
             "nonzero exit aborts the daemon — a half-provisioned "
             "host must not take tasks.",
    )
    parser.add_argument(
        "--provision-timeout-s", type=float, default=600.0,
        help="hard cap on --provision-cmd: a wedged provisioning "
             "compile must abort LOUDLY, not leave a host that "
             "silently never joins the fleet",
    )
    args = parser.parse_args(argv)
    from dcos_commons_tpu_torch.security.auth import load_token

    token = load_token(token_file=args.auth_token_file)
    if not token and args.bind not in ("127.0.0.1", "localhost", "::1"):
        import sys

        print(
            "WARNING: agent bound on a non-loopback address with NO auth "
            "token — anyone who can reach this port can run commands. "
            "Pass --auth-token-file (see security/auth.py trust model).",
            file=sys.stderr,
        )
    if args.provision_cmd:
        import signal as _signal
        import subprocess
        import sys
        import time as _time

        t0 = _time.time()
        # own session + group kill on timeout: the provisioning
        # command's typical job is a kernel build, whose compiler a
        # hung grandchild may be — it must die with the command
        proc = subprocess.Popen(
            ["/bin/sh", "-c", args.provision_cmd],
            start_new_session=True,
        )
        try:
            rc = proc.wait(timeout=args.provision_timeout_s)
        except subprocess.TimeoutExpired:
            try:
                os.killpg(proc.pid, _signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
            proc.wait(timeout=10)
            print(
                f"provisioning timed out after "
                f"{args.provision_timeout_s:.0f}s: {args.provision_cmd}",
                file=sys.stderr,
            )
            return 1
        if rc != 0:
            print(
                f"provisioning failed (rc={rc}): {args.provision_cmd}",
                file=sys.stderr,
            )
            return rc
        print(
            f"provisioned in {_time.time() - t0:.1f}s: "
            f"{args.provision_cmd}",
            flush=True,
        )
    daemon = AgentDaemon(
        args.host_id,
        args.workdir,
        port=args.port,
        bind=args.bind,
        advertise_host=args.advertise_host,
        auth_token=token,
        tls=_tls_pair_or_die(args.tls_cert, args.tls_key),
        ca_file=args.tls_ca or os.environ.get("TLS_CA_FILE", ""),
    )
    if args.announce_file:
        from dcos_commons_tpu_torch.common import atomic_write_text

        atomic_write_text(
            args.announce_file, f"{daemon.host_id} {daemon.url}\n"
        )
    try:
        daemon.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        daemon.stop()
    return 0

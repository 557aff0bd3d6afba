"""LocalProcessAgent: run tasks as real subprocesses with sandboxes.

Plays the role of the Mesos agent + sdk/bootstrap for a simulated
fleet: each task gets a sandbox directory, its env contract (the
PodInfoBuilder-assembled env), readiness-check execution (reference:
readiness spec stored as a label, PodInfoBuilder.java:511-526, executed
task-side), and health-check supervision with kill-on-max-failures.

Port of ``dcos_commons_tpu/agent/local.py``, line for line but the
imports, with ``agent/daemon.py``'s ``serialize_check`` kept here
(the port's daemon re-exports it).  A task's env is the agent
process's own ``os.environ`` with the TaskInfo's env laid over it, so
a worker's model width and ``PYTHONPATH`` come from the agent's host,
its card from the evaluator's ``CUDA_VISIBLE_DEVICES``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from dcos_commons_tpu_torch.common import TaskInfo, TaskState, TaskStatus
from dcos_commons_tpu_torch.specification.specs import (
    HealthCheckSpec,
    ReadinessCheckSpec,
)


def serialize_check(check) -> Optional[dict]:
    """Check specs -> JSON for the launch request wire format."""
    if check is None:
        return None
    return dataclasses.asdict(check)


def prepare_templates(
    task_env: Dict[str, str],
    templates: Optional[List[dict]],
    auth_token: str = "",
    ca_file: str = "",
) -> List[Tuple[str, str]]:
    """Fetch + render config templates; no filesystem writes.

    The task-side half of the per-task config plane: the reference's
    bootstrap binary fetches each template from the scheduler's
    /v1/artifacts endpoint and mustache-renders it against the task env
    (sdk/bootstrap/main.go:291-376).  Each template dict carries
    ``dest`` (sandbox-relative path) and either inline ``content`` or
    a ``url`` to fetch from the scheduler.  Kept free of locks and
    sandbox state: URL fetches can be slow and must not stall the
    agent's kill/poll handling.
    """
    out: List[Tuple[str, str]] = []
    for template in templates or []:
        if "error" in template:
            raise ValueError(template["error"])
        dest = template["dest"]
        content = template.get("content")
        if content is None:
            url = template.get("url")
            if not url:
                raise ValueError(
                    f"template {template.get('name')!r} has neither "
                    "content nor url"
                )
            import urllib.request

            from dcos_commons_tpu_torch.security import auth as _auth

            # the scheduler's /v1/artifacts is bearer-protected like
            # every other route; the daemon holds the cluster token
            req = urllib.request.Request(
                url, headers=_auth.auth_headers(auth_token)
            )
            ctx = (
                _auth.client_ssl_context(ca_file)
                if url.startswith("https") else None
            )
            with urllib.request.urlopen(req, timeout=10, context=ctx) as resp:
                content = resp.read().decode("utf-8")
        from dcos_commons_tpu_torch.specification.yaml_spec import render_template

        out.append((dest, render_template(content, task_env)))
    return out


def _sandbox_path(sandbox: str, dest: str, what: str) -> str:
    """Resolve a sandbox-relative dest, rejecting escapes (dest is
    remote-controlled via the launch request)."""
    root = os.path.normpath(sandbox)
    if os.path.isabs(dest):
        raise ValueError(f"{what} dest must be sandbox-relative: {dest}")
    path = os.path.normpath(os.path.join(root, dest))
    if not path.startswith(root + os.sep):
        raise ValueError(f"{what} dest escapes the sandbox: {dest}")
    return path


def stage_uris(
    uris: Optional[List[dict]],
    cache_dir: str,
    ca_file: str = "",
) -> List[Tuple[dict, str]]:
    """Download task artifacts; no sandbox writes (slow network work
    happens OUTSIDE the agent lock, like prepare_templates).

    The task-side half of the reference's pre-launch artifact fetch
    (``uris:`` in YAML, fetched by the Mesos fetcher before the task
    command runs; YAMLToInternalMappers.java:397).  Digest-pinned
    artifacts (``sha256``) are cached per host under ``cache_dir``
    keyed by digest — a GPU fleet stages the same corpus/tokenizer on
    every host, and relaunches must not re-download gigabytes.
    Unpinned artifacts are fetched fresh every launch (a mutable URL
    must not serve a stale cache).  The cluster bearer token is NEVER
    attached: these are arbitrary operator URLs, not scheduler routes
    — leaking the token to an external host would hand out the
    control plane.  Returns [(entry, staged_file_path)].
    """
    import hashlib
    import tempfile
    import urllib.request

    def sha256_file(path: str) -> str:
        digest = hashlib.sha256()
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                digest.update(chunk)
        return digest.hexdigest()

    staged: List[Tuple[dict, str]] = []
    os.makedirs(cache_dir, exist_ok=True)
    try:
        for entry in uris or []:
            uri = entry.get("uri", "")
            if not uri:
                raise ValueError(f"artifact entry without a uri: {entry!r}")
            pin = str(entry.get("sha256", "")).lower()
            if pin:
                cached = os.path.join(cache_dir, pin)
                if os.path.exists(cached) and sha256_file(cached) == pin:
                    staged.append((entry, cached))
                    continue
                if os.path.exists(cached):
                    os.remove(cached)  # corrupted cache entry: refetch
            ctx = None
            if uri.startswith("https"):
                from dcos_commons_tpu_torch.security import auth as _auth

                ctx = _auth.client_ssl_context(ca_file)
            # STREAM to disk while hashing: artifacts are corpus-sized
            # (gigabytes) — buffering one in RAM would OOM the agent
            # and every task it supervises
            digest = hashlib.sha256()
            fd, tmp = tempfile.mkstemp(dir=cache_dir, prefix=".fetch-")
            try:
                with os.fdopen(fd, "wb") as f, urllib.request.urlopen(
                    uri, timeout=120, context=ctx
                ) as resp:
                    for chunk in iter(lambda: resp.read(1 << 20), b""):
                        digest.update(chunk)
                        f.write(chunk)
                if pin and digest.hexdigest() != pin:
                    raise ValueError(
                        f"artifact {uri} digest mismatch: expected "
                        f"{pin}, got {digest.hexdigest()}"
                    )
            except BaseException:
                try:
                    os.remove(tmp)
                except OSError:
                    pass
                raise
            if pin:
                os.replace(tmp, os.path.join(cache_dir, pin))
                staged.append((entry, os.path.join(cache_dir, pin)))
            else:
                staged.append((entry, tmp))
    except BaseException:
        discard_staged(staged)
        raise
    return staged


def discard_staged(staged: List[Tuple[dict, str]]) -> None:
    """Remove unpinned temp files that were never consumed by
    install_uris (launch aborted between stage and install) — churny
    relaunches must not fill the agent's disk with orphans.  Pinned
    entries live in the cache by design and are kept."""
    for entry, path in staged:
        if entry.get("sha256"):
            continue
        try:
            os.remove(path)
        except OSError:
            pass


def install_uris(
    sandbox: str, staged: List[Tuple[dict, str]]
) -> None:
    """Place staged artifacts into the sandbox: copy to dest
    (traversal-safe), optional +x, optional tar extraction (member
    paths validated — a hostile archive must not escape).  Unpinned
    temp files are consumed."""
    import shutil
    import tarfile

    for entry, source in staged:
        dest = entry.get("dest") or \
            entry["uri"].rstrip("/").rsplit("/", 1)[-1].split("?")[0]
        path = _sandbox_path(sandbox, dest, "artifact")
        os.makedirs(os.path.dirname(path) or sandbox, exist_ok=True)
        pinned = bool(entry.get("sha256"))
        if pinned:
            shutil.copyfile(source, path)  # cache entry stays
        else:
            os.replace(source, path)
        if entry.get("executable"):
            os.chmod(path, os.stat(path).st_mode | 0o755)
        if entry.get("extract"):
            target_dir = os.path.dirname(path) or sandbox
            with tarfile.open(path) as tar:
                for member in tar.getmembers():
                    member_path = os.path.normpath(
                        os.path.join(target_dir, member.name)
                    )
                    root = os.path.normpath(sandbox)
                    # './' members (tar -C dir .) normalize to the
                    # root itself — benign, allowed
                    if member_path != root and \
                            not member_path.startswith(root + os.sep):
                        raise ValueError(
                            f"archive member escapes the sandbox: "
                            f"{member.name}"
                        )
                    if member.issym() or member.islnk():
                        raise ValueError(
                            f"archive member is a link: {member.name}"
                        )
                try:
                    tar.extractall(target_dir, filter="data")
                except TypeError:  # pre-3.12: manual checks above apply
                    tar.extractall(target_dir)


def write_templates(sandbox: str, rendered: List[Tuple[str, str]]) -> None:
    """Write rendered templates, confined to the sandbox: ``dest`` is
    remote-controlled (launch request), so absolute paths and ``..``
    escapes are rejected."""
    root = os.path.normpath(sandbox)
    for dest, text in rendered:
        if os.path.isabs(dest):
            raise ValueError(f"template dest must be sandbox-relative: {dest}")
        path = os.path.normpath(os.path.join(root, dest))
        if not path.startswith(root + os.sep):
            raise ValueError(f"template dest escapes the sandbox: {dest}")
        os.makedirs(os.path.dirname(path) or root, exist_ok=True)
        with open(path, "w") as f:
            f.write(text)


@dataclass
class _Running:
    info: TaskInfo
    # Popen when this agent process launched the task; None for a task
    # recovered from a previous agent incarnation (tracked by pid +
    # the supervisor's durable exit_status record)
    process: Optional[subprocess.Popen]
    sandbox: str
    readiness: Optional[ReadinessCheckSpec]
    health: Optional[HealthCheckSpec]
    started_at: float
    pid: int = 0
    pid_identity: str = ""          # /proc start time: pid-reuse guard
    native: bool = False            # supervised by the C++ task_exec
    record_dir: str = ""            # per-INCARNATION lifecycle records
    ready_reported: bool = False
    running_reported: bool = False
    health_failures: int = 0
    last_check_at: float = 0.0
    last_health_at: float = 0.0
    kill_requested: bool = False
    kill_deadline: float = 0.0

    def exit_code(self) -> Optional[int]:
        """None while alive; the exit code once done; -1 when the fate
        is unknowable (supervisor lost / non-native recovery).

        Self-launched tasks short-circuit on the Popen (the native
        supervisor exits WITH the child's code); recovered tasks read
        the supervisor's durable exit_status record."""
        if self.process is not None:
            return self.process.poll()
        status_path = os.path.join(
            self.record_dir or self.sandbox, "exit_status"
        )
        try:
            with open(status_path) as f:
                return int(f.read().strip())
        except (OSError, ValueError):
            pass
        if self.pid and not _pid_alive(self.pid, self.pid_identity):
            # pid gone (or recycled by another process) without a
            # durable record: the fate is unknowable
            return -1
        return None


def _rlimit_preexec(rlimits: List[dict]):
    """Child-side hook applying per-task resource limits between fork
    and exec (reference: RLimitSpec -> Mesos RLimitInfo, enforced by
    the containerizer; here setrlimit(2) directly).  A limit that
    cannot be applied fails the launch — silently running without the
    isolation the spec demanded is worse than not running."""
    import resource

    pairs = []
    for rl in rlimits:
        res = getattr(resource, str(rl["name"]))
        soft = int(rl.get("soft", -1))
        hard = int(rl.get("hard", -1))
        pairs.append((
            res,
            resource.RLIM_INFINITY if soft < 0 else soft,
            resource.RLIM_INFINITY if hard < 0 else hard,
        ))

    def apply():
        for res, soft, hard in pairs:
            resource.setrlimit(res, (soft, hard))

    return apply


def _proc_identity(pid: int) -> str:
    """Process start time from /proc — distinguishes a live pid from a
    recycled one.  Empty string when unavailable (non-Linux)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            fields = f.read().rsplit(") ", 1)[-1].split()
        # field 22 of /proc/pid/stat overall = index 19 after comm
        return fields[19]
    except (OSError, IndexError):
        return ""


def _pid_alive(pid: int, identity: str = "") -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        pass
    if identity:
        current = _proc_identity(pid)
        if current and current != identity:
            return False  # pid recycled by an unrelated process
    return True


class LocalProcessAgent:
    """One agent process simulating every host in the fleet.

    ``readiness_for``/``health_for`` map task *spec* checks in; the
    scheduler passes them at launch via TaskInfo labels is avoided —
    instead the scheduler registers specs with the agent directly
    (launch_with_checks), keeping TaskInfo JSON-small.
    """

    def __init__(self, workdir: str, use_native: bool = True,
                 auth_token: str = "", ca_file: str = ""):
        # anchor the sandbox root: the $SANDBOX env contract and the
        # durable supervisor records are consumed from the TASK's cwd
        # (the sandbox itself), so a relative --sandbox-root would
        # hand every task a path that resolves nowhere
        self._workdir = os.path.abspath(workdir)
        # credentials for pulling templates off the scheduler's
        # bearer-protected /v1/artifacts endpoint
        self._auth_token = auth_token
        self._ca_file = ca_file
        self._tasks: Dict[str, _Running] = {}
        self._pending: List[TaskStatus] = []
        # recovered terminal fates whose records retire at delivery
        self._undelivered_records: Dict[str, str] = {}
        self._lock = threading.RLock()
        self._use_native = use_native
        if use_native:
            # build the supervisor binary NOW, before any lock is ever
            # held: a first-launch g++ run under the agent lock would
            # freeze poll()/status delivery for every running task
            from dcos_commons_tpu_torch.native import task_exec_path

            task_exec_path()
        os.makedirs(workdir, exist_ok=True)
        with self._lock:
            self._recover_tasks_locked()

    def _recover_tasks_locked(self) -> None:
        """Rebuild task state from sandbox records after an agent
        restart: the C++ supervisor persisted task.json at launch and
        exit_status at exit, so a daemon crash loses no task fates.

        Still-running tasks resume monitoring by pid; exited ones get
        their terminal status synthesized exactly once (the record is
        renamed after delivery)."""
        try:
            names = os.listdir(self._workdir)
        except OSError:
            return
        for name in names:
            sandbox = os.path.join(self._workdir, name)
            super_root = os.path.join(sandbox, ".super")
            try:
                incarnations = os.listdir(super_root)
            except OSError:
                continue
            for task_id in incarnations:
                record_dir = os.path.join(super_root, task_id)
                record_path = os.path.join(record_dir, "task.json")
                if not os.path.isfile(record_path):
                    continue
                try:
                    with open(record_path) as f:
                        record = json.load(f)
                except (OSError, ValueError):
                    continue
                info = TaskInfo.from_dict(record["info"])
                readiness = record.get("readiness")
                health = record.get("health")
                running = _Running(
                    info=info,
                    process=None,
                    sandbox=sandbox,
                    readiness=(
                        ReadinessCheckSpec(**readiness) if readiness else None
                    ),
                    health=HealthCheckSpec(**health) if health else None,
                    started_at=time.monotonic(),
                    pid=int(record.get("pid", 0)),
                    pid_identity=str(record.get("pid_identity", "")),
                    native=bool(record.get("native", False)),
                    record_dir=record_dir,
                )
                code = running.exit_code()
                if code is None:
                    # alive across the restart: resume supervision;
                    # RUNNING is re-reported (status intake idempotent)
                    self._tasks[info.task_id] = running
                    continue
                if code == -1:
                    # no durable record (non-native fallback, or the
                    # supervisor was SIGKILLed): the fate is unknowable
                    # — LOST lets recovery decide, never claiming a
                    # success or failure we cannot prove
                    state = TaskState.LOST
                else:
                    # signal deaths are FAILED: whether the pre-crash
                    # agent had requested the kill is unknowable, and
                    # KILLED (a non-failure state) would wedge a deploy
                    # step waiting on this task
                    state = (
                        TaskState.FINISHED if code == 0
                        else TaskState.FAILED
                    )
                self._pending.append(TaskStatus(
                    task_id=info.task_id,
                    state=state,
                    message=f"recovered after agent restart: exit {code}",
                    agent_id=info.agent_id,
                ))
                # the record is retired only when the fate is HANDED
                # OUT (poll), so a crash before delivery re-recovers it
                self._undelivered_records[info.task_id] = record_path

    # -- Agent --------------------------------------------------------

    def launch(self, task_infos: List[TaskInfo]) -> None:
        for info in task_infos:
            self.launch_one(info)

    def _write_secure_files(
        self, sandbox: str, files: Optional[List[dict]]
    ) -> None:
        """Write launch-shipped secret/TLS files, sandbox-confined,
        with the scheduler-specified mode (0600 for keys).  An entry
        carrying ``error`` fails the launch before the command runs
        (the bootstrap fail-before-cmd discipline)."""
        import base64 as _b64

        for entry in files or []:
            if "error" in entry:
                raise ValueError(entry["error"])
            dest = entry["dest"]
            real_sandbox = os.path.realpath(sandbox)
            path = os.path.realpath(os.path.join(real_sandbox, dest))
            if path != real_sandbox and not path.startswith(
                real_sandbox + os.sep
            ):
                raise ValueError(f"file dest escapes sandbox: {dest!r}")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            content = _b64.b64decode(entry.get("content") or "")
            fd = os.open(
                path,
                os.O_WRONLY | os.O_CREAT | os.O_TRUNC,
                int(entry.get("mode", 0o600)),
            )
            try:
                os.write(fd, content)
            finally:
                os.close(fd)
            # O_CREAT mode is masked by umask and ignored on existing
            # files: enforce explicitly
            os.chmod(path, int(entry.get("mode", 0o600)))

    def _attach_volumes(self, sandbox: str, info: TaskInfo) -> None:
        """Materialize persistent volumes: a durable directory per
        volume key under <workdir>/volumes/, symlinked into the sandbox
        at the declared container path.

        Reference: VolumeEvaluationStage + the Mesos agent's persistent
        volume mount (offer/evaluate/VolumeEvaluationStage.java, 265
        LoC).  TRANSIENT relaunches carry the same volume key and so
        reattach their data; a PERMANENT replace minted a fresh
        reservation (fresh key) and starts empty.
        """
        for container_path, volume_key in sorted(info.volumes.items()):
            durable = os.path.join(
                self._workdir, "volumes", volume_key.replace(os.sep, "_")
            )
            os.makedirs(durable, exist_ok=True)
            link = os.path.join(sandbox, container_path)
            if os.path.islink(link):
                if os.readlink(link) == durable:
                    continue  # relaunch with the same volume key
                # new key into an old sandbox (PERMANENT replace on the
                # same host): relink, or the task would silently
                # reattach the previous incarnation's data
                os.remove(link)
            elif os.path.exists(link):
                continue  # pre-existing real dir: leave it alone
            os.makedirs(os.path.dirname(link), exist_ok=True)
            os.symlink(durable, link)

    def launch_one(
        self,
        info: TaskInfo,
        readiness: Optional[ReadinessCheckSpec] = None,
        health: Optional[HealthCheckSpec] = None,
        templates: Optional[List[dict]] = None,
        files: Optional[List[dict]] = None,
        secret_env: Optional[Dict[str, str]] = None,
        kill_grace_s: float = 5.0,
        uris: Optional[List[dict]] = None,
        rlimits: Optional[List[dict]] = None,
    ) -> None:
        with self._lock:
            if info.task_id in self._tasks:
                return  # idempotent
        # template fetch/render happens OUTSIDE the lock: a slow
        # scheduler artifact endpoint must not block kill/poll/tasks
        # (and thereby trip the fleet's host-down detection)
        try:
            rendered = prepare_templates(
                info.env, templates,
                auth_token=self._auth_token, ca_file=self._ca_file,
            )
        except Exception as e:
            # the reference's bootstrap exits nonzero on a failed
            # template render, failing the task before its command
            # ever runs (sdk/bootstrap/main.go:291-376)
            with self._lock:
                self._pending.append(
                    TaskStatus(
                        task_id=info.task_id,
                        state=TaskState.ERROR,
                        message=f"config template render failed: {e}",
                        agent_id=info.agent_id,
                    )
                )
            return
        # artifact downloads too — network work stays off the lock
        try:
            staged_uris = stage_uris(
                uris,
                cache_dir=os.path.join(self._workdir, ".uri-cache"),
                ca_file=self._ca_file,
            )
        except Exception as e:
            with self._lock:
                self._pending.append(
                    TaskStatus(
                        task_id=info.task_id,
                        state=TaskState.ERROR,
                        message=f"artifact fetch failed: {e}",
                        agent_id=info.agent_id,
                    )
                )
            return
        try:
            with self._lock:
                if info.task_id in self._tasks:
                    return  # raced with a duplicate launch
                sandbox = os.path.join(self._workdir, info.name)
                os.makedirs(sandbox, exist_ok=True)
                try:
                    self._attach_volumes(sandbox, info)
                except OSError as e:
                    self._pending.append(
                        TaskStatus(
                            task_id=info.task_id,
                            state=TaskState.ERROR,
                            message=f"volume provisioning failed: {e}",
                            agent_id=info.agent_id,
                        )
                    )
                    return
                env = dict(os.environ)
                env.update(info.env)
                # secret env values ride the launch request only — merged
                # here at exec time, never part of the persisted TaskInfo
                env.update(secret_env or {})
                env["SANDBOX"] = sandbox
                try:
                    self._write_secure_files(sandbox, files)
                except Exception as e:
                    self._pending.append(
                        TaskStatus(
                            task_id=info.task_id,
                            state=TaskState.ERROR,
                            message=f"secure file provisioning failed: {e}",
                            agent_id=info.agent_id,
                        )
                    )
                    return
                try:
                    write_templates(sandbox, rendered)
                except Exception as e:
                    self._pending.append(
                        TaskStatus(
                            task_id=info.task_id,
                            state=TaskState.ERROR,
                            message=f"config template render failed: {e}",
                            agent_id=info.agent_id,
                        )
                    )
                    return
                try:
                    install_uris(sandbox, staged_uris)
                except Exception as e:
                    self._pending.append(
                        TaskStatus(
                            task_id=info.task_id,
                            state=TaskState.ERROR,
                            message=f"artifact install failed: {e}",
                            agent_id=info.agent_id,
                        )
                    )
                    return
                # durable pre-launch record: a restarted agent rebuilds its
                # task table from these (+ the supervisor's exit_status)
                native_exe = ""
                if self._use_native:
                    from dcos_commons_tpu_torch.native import task_exec_path

                    native_exe = task_exec_path()
                try:
                    # lifecycle records are per INCARNATION: a dying
                    # predecessor's exit record must never shadow the new
                    # launch.  Delivered (.done) records of other
                    # incarnations are pruned here.
                    record_dir = os.path.join(sandbox, ".super", info.task_id)
                    os.makedirs(record_dir, exist_ok=True)
                    self._prune_delivered_records(sandbox, keep=info.task_id)
                    if native_exe:
                        argv = [
                            native_exe,
                            "--sandbox", sandbox,
                            "--record-dir", record_dir,
                            "--grace", str(kill_grace_s),
                        ]
                        for rl in rlimits or []:
                            # applied by the supervisor in the child
                            # between fork and exec (setrlimit(2))
                            argv += [
                                "--rlimit",
                                f"{rl['name']}="
                                f"{rl.get('soft', -1)}:{rl.get('hard', -1)}",
                            ]
                        argv += ["--", info.command]
                        process = subprocess.Popen(
                            argv,
                            env=env,
                            start_new_session=True,
                        )
                    else:
                        process = subprocess.Popen(
                            ["/bin/sh", "-c", info.command],
                            cwd=sandbox,
                            env=env,
                            stdout=open(os.path.join(sandbox, "stdout"), "ab"),
                            stderr=open(os.path.join(sandbox, "stderr"), "ab"),
                            start_new_session=True,
                            preexec_fn=(
                                _rlimit_preexec(rlimits) if rlimits
                                else None
                            ),
                        )
                except (OSError, ValueError,
                        subprocess.SubprocessError) as e:
                    # ValueError covers preexec_fn setrlimit failures:
                    # CPython re-raises EPERM/EINVAL from the child as
                    # ValueError in the parent — it must fail THIS
                    # launch with an ERROR status, not escape into the
                    # scheduler's plan loop
                    self._pending.append(
                        TaskStatus(
                            task_id=info.task_id,
                            state=TaskState.ERROR,
                            message=f"launch failed: {e}",
                            agent_id=info.agent_id,
                        )
                    )
                    return
                # the durable record is best-effort: a failed write only
                # degrades RESTART recovery — the process is running and
                # must be tracked regardless, or it leaks untracked
                pid_identity = _proc_identity(process.pid)
                try:
                    record = {
                        "info": info.to_dict(),
                        "pid": process.pid,
                        "pid_identity": pid_identity,
                        "native": bool(native_exe),
                        "readiness": serialize_check(readiness),
                        "health": serialize_check(health),
                    }
                    with open(os.path.join(record_dir, "task.json"), "w") as f:
                        json.dump(record, f)
                except OSError:
                    pass
                self._tasks[info.task_id] = _Running(
                    info=info,
                    process=process,
                    sandbox=sandbox,
                    readiness=readiness,
                    health=health,
                    started_at=time.monotonic(),
                    pid=process.pid,
                    pid_identity=pid_identity,
                    native=bool(native_exe),
                    record_dir=record_dir,
                )
        finally:
            # unpinned staged artifacts not consumed by install_uris
            # (any aborted launch path above) must not pile up on disk
            discard_staged(staged_uris)

    def _prune_delivered_records(self, sandbox: str, keep: str) -> None:
        import shutil as _shutil

        super_root = os.path.join(sandbox, ".super")
        try:
            entries = os.listdir(super_root)
        except OSError:
            return
        for task_id in entries:
            if task_id == keep:
                continue
            record_dir = os.path.join(super_root, task_id)
            if os.path.exists(os.path.join(record_dir, "task.json.done")):
                _shutil.rmtree(record_dir, ignore_errors=True)

    def kill(self, task_id: str, grace_period_s: float = 0.0) -> None:
        with self._lock:
            running = self._tasks.get(task_id)
            if running is None:
                return
            running.kill_requested = True
            # native tasks: the supervisor owns grace escalation; the
            # Python deadline is only the lost-supervisor backstop
            margin = 10.0 if running.native else 0.0
            running.kill_deadline = (
                time.monotonic() + grace_period_s + margin
            )
            if running.native and grace_period_s > 0:
                # hand the REQUESTED grace to the supervisor (it reads
                # record_dir/grace on SIGTERM) — the launch-time --grace
                # is only the default, and e.g. pod replace may ask for
                # a different drain than the spec's kill-grace-period
                from dcos_commons_tpu_torch.common import atomic_write_text

                try:
                    atomic_write_text(
                        os.path.join(
                            running.record_dir or running.sandbox, "grace"
                        ),
                        f"{grace_period_s}\n",
                    )
                except OSError:
                    pass  # supervisor falls back to the launch grace
            try:
                if running.native:
                    os.kill(running.pid, signal.SIGTERM)
                else:
                    os.killpg(running.pid, signal.SIGTERM)
            except (ProcessLookupError, PermissionError):
                pass
            if running.native and grace_period_s <= 0:
                # an explicit zero grace means NOW — don't defer to the
                # supervisor's launch-time grace
                self._force_kill(running)

    def _force_kill(self, running: _Running) -> None:
        """SIGKILL the task's process group (non-native: the child IS
        the group leader; native: read the supervisor's child.pid)."""
        pid = running.pid
        if running.native:
            try:
                with open(os.path.join(
                    running.record_dir or running.sandbox, "child.pid"
                )) as f:
                    pid = int(f.read().strip())
            except (OSError, ValueError):
                pass
        try:
            os.killpg(pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass

    def active_task_ids(self) -> Set[str]:
        with self._lock:
            return set(self._tasks)

    def reconcile(self) -> None:
        """Explicit reconciliation (reference: ExplicitReconciler —
        the master re-sends CURRENT task states on request).  Status
        transitions here are edge-triggered: once poll() hands a
        RUNNING out, it is never re-reported — so a scheduler that
        died between draining poll() and acting on the batch would
        strand its successor with store-STAGING tasks whose RUNNING
        can never arrive (found by the chaos harness's
        mid-status-fan-in/mid-plan-transition kills).  A restarted
        scheduler calls this to re-arm the current state of every
        live task for the next poll; terminal fates already
        re-deliver via the durable task records."""
        with self._lock:
            for running in self._tasks.values():
                running.running_reported = False

    def poll(self) -> List[TaskStatus]:
        with self._lock:
            out = list(self._pending)
            self._pending.clear()
            for status in out:
                record_path = self._undelivered_records.pop(
                    status.task_id, None
                )
                if record_path:
                    try:
                        os.replace(record_path, record_path + ".done")
                    except OSError:
                        pass
            now = time.monotonic()
            finished: List[str] = []
            for task_id, running in self._tasks.items():
                out.extend(self._poll_one(task_id, running, now, finished))
            for task_id in finished:
                del self._tasks[task_id]
            return out

    # -- internals ----------------------------------------------------

    def _poll_one(
        self, task_id: str, running: _Running, now: float, finished: List[str]
    ) -> List[TaskStatus]:
        out: List[TaskStatus] = []
        info = running.info
        returncode = running.exit_code()
        if returncode is not None:
            finished.append(task_id)
            # fate delivered: the durable record must not be re-
            # reported by a later agent restart
            if running.record_dir:
                record = os.path.join(running.record_dir, "task.json")
                try:
                    os.replace(record, record + ".done")
                except OSError:
                    pass
            if returncode == -1 and not running.kill_requested:
                state = TaskState.LOST  # fate unknowable
            elif running.kill_requested:
                state = TaskState.KILLED
                # NOTE: an unrequested signal death (OOM killer,
                # operator SIGKILL) stays FAILED — KILLED is not a
                # failure state and would leave a deploy step wedged
            elif returncode == 0:
                state = TaskState.FINISHED
            else:
                state = TaskState.FAILED
            out.append(
                TaskStatus(
                    task_id=task_id,
                    state=state,
                    message=(
                        "supervisor lost" if returncode == -1
                        else f"exit {returncode}"
                    ),
                    agent_id=info.agent_id,
                )
            )
            return out
        if running.kill_requested and now >= running.kill_deadline:
            self._force_kill(running)
        if not running.running_reported:
            running.running_reported = True
            out.append(
                TaskStatus(
                    task_id=task_id,
                    state=TaskState.RUNNING,
                    agent_id=info.agent_id,
                    # a reconcile()-triggered re-report must carry the
                    # readiness the task already earned, or the step
                    # waits forever for a check that won't re-run
                    ready=running.readiness is None or
                    running.ready_reported,
                )
            )
        # readiness: run the check at its declared interval until it
        # passes once (a subprocess per poll per task would melt the
        # agent at fleet scale and ignore the spec's cadence)
        if running.readiness is not None and not running.ready_reported:
            if now - running.last_check_at >= running.readiness.interval_s:
                running.last_check_at = now
                if self._run_check(running, running.readiness.cmd,
                                   running.readiness.timeout_s):
                    running.ready_reported = True
                    out.append(
                        TaskStatus(
                            task_id=task_id,
                            state=TaskState.RUNNING,
                            agent_id=info.agent_id,
                            ready=True,
                            message="readiness check passed",
                        )
                    )
        # health: checking begins after delay_s AND grace_period_s,
        # then runs at the declared interval; failures accumulate ->
        # kill (reference HealthCheckSpec: delay gates the first check,
        # grace suppresses failure counting while warming)
        health = running.health
        if health is not None and \
                now - running.started_at > max(
                    health.grace_period_s, health.delay_s
                ) and \
                now - running.last_health_at >= health.interval_s:
            running.last_health_at = now
            if self._run_check(running, health.cmd, health.timeout_s):
                running.health_failures = 0
            else:
                running.health_failures += 1
                if running.health_failures >= health.max_consecutive_failures:
                    self.kill(task_id)
        return out

    def _run_check(self, running: _Running, cmd: str, timeout_s: float) -> bool:
        env = dict(os.environ)
        env.update(running.info.env)
        env["SANDBOX"] = running.sandbox
        try:
            result = subprocess.run(
                ["/bin/sh", "-c", cmd],
                cwd=running.sandbox,
                env=env,
                timeout=timeout_s,
                capture_output=True,
            )
            return result.returncode == 0
        except subprocess.TimeoutExpired:
            return False

    # -- test helpers -------------------------------------------------

    def sandbox_of(self, task_name: str) -> str:
        return os.path.join(self._workdir, task_name)

    def steplog_of(
        self, task_name: str, agent_id: Optional[str] = None
    ) -> List[dict]:
        """Worker step telemetry from the task's sandbox
        (trace/steplog.py JSONL): the scheduler's /v1/debug/trace
        merges these into the control-plane timeline so gang skew
        across hosts is visible in one view.  [] when the task never
        wrote one.  ``agent_id`` is the routing hint RemoteFleet
        needs; one sandbox tree serves every simulated host here."""
        from dcos_commons_tpu_torch.trace.steplog import STEPLOG_NAME, read_steplog

        return read_steplog(
            os.path.join(self._workdir, task_name, STEPLOG_NAME)
        )

    def serving_stats_of(
        self, task_name: str, agent_id: Optional[str] = None
    ) -> dict:
        """Serving-load gauges from the task's sandbox (serve/engine.py
        servestats.json): queue depth, active slots, KV occupancy,
        tokens/s.  The scheduler's /v1/debug/serving merges these per
        pod — the load signal scale-out decisions read.  {} when the
        task is not a serving worker (never wrote one)."""
        from dcos_commons_tpu_torch.serve.engine import (
            SERVESTATS_NAME,
            read_servestats,
        )

        return read_servestats(
            os.path.join(self._workdir, task_name, SERVESTATS_NAME)
        )

    def advertised_port_of(
        self, task_name: str, agent_id: Optional[str] = None
    ) -> Optional[int]:
        """The HTTP port the task actually bound (annotated into its
        servestats snapshot): /v1/endpoints advertises THIS for
        ``advertise: true`` ports — on a one-machine simulated fleet
        the reserved port may be taken, and the listing must name the
        dialable one."""
        from dcos_commons_tpu_torch.agent.base import Agent

        return Agent.advertised_port_of(self, task_name, agent_id)

    def shutdown(self) -> None:
        with self._lock:
            for task_id in list(self._tasks):
                self.kill(task_id)
            for running in self._tasks.values():
                if running.process is not None:
                    try:
                        running.process.wait(timeout=5)
                    except subprocess.TimeoutExpired:
                        self._force_kill(running)
                elif running.pid:
                    # recovered task: give the supervisor a moment to
                    # run its grace escalation, then force.  Polling is
                    # correct here: the pid is a FOREIGN process
                    # (adopted across an agent restart, not our child),
                    # so there is no waitable handle — kill(pid, 0) is
                    # the only portable liveness probe, and this runs
                    # once at shutdown, never in the offer/status path.
                    deadline = time.monotonic() + 5
                    while time.monotonic() < deadline and _pid_alive(
                        running.pid
                    ):
                        time.sleep(0.05)  # sdklint: disable=no-blocking-sleep — see above: no child handle to wait on
                    if _pid_alive(running.pid):
                        self._force_kill(running)
            self._tasks.clear()

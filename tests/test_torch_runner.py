"""The port's scheduler process (``python -m dcos_commons_tpu_torch
serve``: ``runtime/runner.py``) against the JAX package's, on the CPU.

Each package's ``serve`` runs as a subprocess in a session of its own,
over a one-host topology file (the port's with ``GpuHost`` fields, the
JAX package's twin with ``TpuHost`` fields), a ``sleep`` service, a
state directory, a sandbox root, an announce file and a bearer token;
each is driven through its own package's CLI:

- the API is announced, and ``plan status deploy`` reaches COMPLETE;
- a second ``serve`` on the held state directory exits ``EXIT_LOCKED``
  (3);
- SIGTERM: exit 0, the task keeps running under its supervisor;
- ``serve`` again over the same state directory reconciles without a
  relaunch: the deployment (now the ``update`` plan, as a completed
  deployment's plan is named after a restart) COMPLETE with the same
  task id;
- SIGTERM, then ``serve`` with ``SDK_UNINSTALL=1``: the task is killed,
  the state tree wiped, exit 0, no process of the sandbox root left;
- the two packages' runs record the same milestones.

Also: a bad YAML exits ``EXIT_BAD_CONFIG`` (4); ``load_topology``
refuses a file that mixes remote and local hosts and one with no hosts,
and reads the port's GPU fields; ``--multi``, an ``agent_url``
topology (over an ``agent`` daemon) and ``--state-url`` (over a
``state-server``) deploy as the JAX package's ``serve`` does.  Every subprocess has a deadline,
and each test kills its sessions' processes in a ``finally``."""

import importlib
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import pytest

from dcos_commons_tpu.cli import commands as j_commands
from dcos_commons_tpu.storage import FileWalPersister as JWal
from dcos_commons_tpu_torch.cli import commands as t_commands
from dcos_commons_tpu_torch.offer.inventory import GpuHost
from dcos_commons_tpu_torch.runtime import runner as t_runner
from dcos_commons_tpu_torch.storage import FileWalPersister as TWal
from test_torch_cli import run_main
from test_torch_remote_agent import kill_sandbox_tasks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKEN = "runner-token"

SVC = """
name: tiny
pods:
  app:
    count: 1
    tasks:
      main:
        goal: RUNNING
        cmd: "sleep 300"
        cpus: 0.1
        memory: 32
"""

TOPOLOGY = {
    "jax": "hosts:\n  - host_id: h0\n    hostname: 127.0.0.1\n"
           "    slice_id: s0\n    grid: [0, 0]\n    chip_block: [0, 0]\n"
           "    cpus: 4\n    memory_mb: 4096\n",
    "port": "hosts:\n  - host_id: h0\n    hostname: 127.0.0.1\n"
            "    slice_id: s0\n    node: 0\n    gpus: 0\n"
            "    cpus: 4\n    memory_mb: 4096\n",
}
PACKAGES = {"jax": ("dcos_commons_tpu", j_commands, JWal),
            "port": ("dcos_commons_tpu_torch", t_commands, TWal)}


def live_pids(mark):
    """Live processes whose environment holds ``mark``."""
    out = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/environ", "rb") as f:
                env = f.read().split(b"\0")
            with open(f"/proc/{name}/stat") as f:
                state = f.read().rsplit(") ", 1)[1].split()[0]
        except (OSError, IndexError):
            continue
        if state != "Z" and any(v.startswith(mark) for v in env):
            out.append(int(name))
    return out


class Service:
    """One package's ``serve`` processes over one directory."""

    def __init__(self, pkg, root):
        self.pkg = pkg
        self.module, self.commands, self.wal = PACKAGES[pkg]
        self.root = root
        root.mkdir()
        (root / "svc.yml").write_text(SVC)
        (root / "cluster.yml").write_text(TOPOLOGY[pkg])
        (root / "token").write_text(TOKEN + "\n")
        os.chmod(root / "token", 0o600)
        self.sandbox = str(root / "sandboxes")
        self.procs = []

    def start(self, *extra, env=None):
        announce = self.root / "url"
        if announce.exists():
            announce.unlink()
        proc = subprocess.Popen(
            [sys.executable, "-m", self.module, "serve",
             str(self.root / "svc.yml"), "--topology",
             str(self.root / "cluster.yml"), "--port", "0",
             "--state-dir", str(self.root / "state"),
             "--sandbox-root", self.sandbox,
             "--announce-file", str(announce),
             "--auth-token-file", str(self.root / "token"), *extra],
            cwd=REPO, start_new_session=True, stdout=subprocess.DEVNULL,
            stderr=open(self.root / f"serve{len(self.procs)}.log", "w"),
            env=dict(os.environ, **(env or {})))
        self.procs.append(proc)
        return proc

    def url(self, proc, deadline_s=60):
        announce = self.root / "url"
        end = time.monotonic() + deadline_s
        while not announce.exists():
            assert proc.poll() is None, self.log()
            assert time.monotonic() < end, "no announce"
            time.sleep(0.05)
        return announce.read_text().strip()

    def cli(self, url, *argv):
        rc, out, err = run_main(self.commands, [
            "--url", url, "--auth-token-file", str(self.root / "token"),
            *argv])
        assert rc == 0, err
        return json.loads(out)

    def wait_complete(self, url, *verb, deadline_s=60):
        end = time.monotonic() + deadline_s
        while self.cli(url, *(verb or ("plan", "status", "deploy")))[
                "status"] != "COMPLETE":
            assert time.monotonic() < end, self.log()
            time.sleep(0.1)

    def task_id(self, url):
        status = self.cli(url, "pod", "status", "app-0")
        return status["tasks"][0]["id"]

    def log(self):
        return "\n".join(p.read_text()[-3000:]
                         for p in sorted(self.root.glob("serve*.log")))

    def stop(self, proc, deadline_s=60):
        proc.send_signal(signal.SIGTERM)
        return proc.wait(timeout=deadline_s)

    def tree(self):
        persister = self.wal(str(self.root / "state"), fsync=False)
        try:
            return persister.get_children_or_empty("/")
        finally:
            persister.close()

    def task_pids(self):
        return live_pids(f"SANDBOX={self.sandbox}{os.sep}".encode())

    def kill_all(self):
        for proc in self.procs:
            if proc.poll() is None:
                try:
                    os.killpg(proc.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
                proc.wait(timeout=30)
        for pid in self.task_pids():
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass


def lifecycle(service):
    """The scenario on one package; returns its milestones."""
    out = {}
    first = service.start()
    url = service.url(first)
    out["unauthorized"] = run_main(service.commands, ["--url", url, "plan",
                                                 "list"])[0]
    service.wait_complete(url)
    task_id = service.task_id(url)
    pids = service.task_pids()
    out["task running"] = bool(pids)
    locked = service.start()
    out["second serve"] = locked.wait(timeout=60)
    out["sigterm"] = service.stop(first)
    out["task survives"] = all(p in service.task_pids() for p in pids)

    again = service.start()
    url = service.url(again)
    # a completed deployment's plan is "update" after a restart:
    # ``update status`` reads whichever the scheduler serves
    service.wait_complete(url, "update", "status")
    out["same task id"] = service.task_id(url) == task_id
    out["plans"] = service.cli(url, "plan", "list")
    out["second sigterm"] = service.stop(again)

    uninstall = service.start(env={"SDK_UNINSTALL": "1"})
    out["uninstall exit"] = uninstall.wait(timeout=60)
    end = time.monotonic() + 10
    while service.task_pids() and time.monotonic() < end:
        time.sleep(0.1)
    out["processes left"] = service.task_pids()
    out["tree after uninstall"] = service.tree()
    return out


def test_serve_lifecycle_as_the_jax_runner(tmp_path):
    services = [Service(pkg, tmp_path / pkg) for pkg in ("jax", "port")]
    try:
        runs = [lifecycle(s) for s in services]
    finally:
        for service in services:
            service.kill_all()
    assert runs[1] == runs[0], [s.log() for s in services]
    assert runs[0] == {
        "unauthorized": 1, "task running": True,
        "second serve": t_runner.EXIT_LOCKED, "sigterm": 0,
        "task survives": True, "same task id": True,
        "plans": ["autoscale", "recovery", "update"],
        "second sigterm": 0, "uninstall exit": 0, "processes left": [],
        "tree after uninstall": [],
    }


def serve_rc(pkg, tmp_path, svc=SVC, topology=None, extra=()):
    service = Service(pkg, tmp_path / pkg)
    (service.root / "svc.yml").write_text(svc)
    if topology is not None:
        (service.root / "cluster.yml").write_text(topology)
    try:
        proc = service.start(*extra)
        rc = proc.wait(timeout=60)
    finally:
        service.kill_all()
    return rc, service.log()


def test_bad_yaml_exits_bad_config(tmp_path):
    for pkg in ("jax", "port"):
        rc, log = serve_rc(pkg, tmp_path, svc="name: [unclosed\n")
        assert rc == t_runner.EXIT_BAD_CONFIG == 4, log
        assert "configuration error" in log


def test_load_topology_reads_gpu_hosts_and_refuses_bad_files(tmp_path):
    path = tmp_path / "cluster.yml"
    path.write_text(
        "hosts:\n  - host_id: n0\n    slice_id: fabric-0\n"
        "    generation: h100\n    node: 1\n    gpus: 8\n    cpus: 16\n"
        "    memory_mb: 65536\n    ports: [[20000, 20100]]\n"
        "    zone: z0\n    region: r0\n    attributes: {rack: a}\n")
    hosts, urls = t_runner.load_topology(str(path))
    assert hosts == [GpuHost(
        host_id="n0", slice_id="fabric-0", generation="h100", node=1,
        gpus=8, cpus=16.0, memory_mb=65536, ports=((20000, 20100),),
        zone="z0", region="r0", attributes={"rack": "a"})]
    assert urls == {}
    path.write_text("hosts:\n  - host_id: a\n    agent_url: http://x:1\n"
                    "  - host_id: b\n")
    with pytest.raises(ValueError, match="mixes remote and local"):
        t_runner.load_topology(str(path))
    path.write_text("hosts: []\n")
    with pytest.raises(ValueError, match="defines no hosts"):
        t_runner.load_topology(str(path))


def distributed_run(pkg, root, entry):
    """``serve`` of one package on one of the paths that span
    processes: ``--multi`` (the service PUT through the API), an
    ``agent_url`` topology (an ``agent`` daemon of the package) or
    ``--state-url`` (a ``state-server`` of the package).  Returns the
    run's milestones."""
    integration = importlib.import_module(f"{PACKAGES[pkg][0]}.testing."
                                          "integration")
    service = Service(pkg, root)
    token = str(root / "token")
    helpers = []
    out = {}
    try:
        extra = ()
        if entry == "--multi":
            extra = ("--multi",)
        elif entry == "agent_url":
            agent = integration.AgentProcess(
                "h0", str(root / "agent"), REPO,
                extra_args=["--auth-token-file", token])
            helpers.append(agent)
            (root / "cluster.yml").write_text(
                TOPOLOGY[pkg] + f"    agent_url: {agent.url}\n")
        else:
            announce = root / "state-url"
            server = subprocess.Popen(
                [sys.executable, "-m", service.module, "state-server",
                 "--data-dir", str(root / "remote-state"),
                 "--announce-file", str(announce),
                 "--auth-token-file", token],
                cwd=REPO, start_new_session=True,
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
            service.procs.append(server)
            end = time.monotonic() + 30
            while not announce.exists() or not announce.read_text():
                assert server.poll() is None and time.monotonic() < end
                time.sleep(0.05)
            extra = ("--state-url", announce.read_text().strip())
        proc = service.start(*extra)
        url = service.url(proc)
        if entry == "--multi":
            # the YAML's service, and a second one PUT through the API;
            # a service's own API is the multi API under its name
            req = urllib.request.Request(
                url + "/v1/multi/other", method="PUT",
                data=SVC.replace("name: tiny", "name: other").encode(),
                headers={"Authorization": f"Bearer {TOKEN}"})
            with urllib.request.urlopen(req, timeout=30) as resp:
                out["put"] = resp.status
            for name in ("tiny", "other"):
                service.wait_complete(f"{url}/v1/multi/{name}")
            req = urllib.request.Request(
                url + "/v1/multi", headers={"Authorization":
                                            f"Bearer {TOKEN}"})
            with urllib.request.urlopen(req, timeout=30) as resp:
                out["services"] = json.loads(resp.read())
        else:
            service.wait_complete(url)
            out["pod"] = [(t["name"], t["status"]) for t in service.cli(
                url, "pod", "status", "app-0")["tasks"]]
        if entry == "agent_url":
            sandboxes = root / "agent" / "sandboxes"
            out["ran on the daemon"] = (sandboxes / "app-0-main").is_dir()
            out["local sandbox"] = os.path.isdir(service.sandbox)
        if entry == "--state-url":
            persister = importlib.import_module(
                f"{service.module}.storage.remote").RemotePersister(
                    extra[1], auth_token=TOKEN)
            out["remote tree"] = sorted(persister.get_children("/"))
            out["remote tasks"] = persister.get_children("/tasks")
            out["local state"] = (root / "state").is_dir()
        out["sigterm"] = service.stop(proc)
    finally:
        service.kill_all()
        for helper in helpers:
            helper.stop()
        kill_sandbox_tasks(root)
    return out


@pytest.mark.parametrize("entry", ["--multi", "--state-url", "agent_url"])
def test_distributed_paths_deploy_as_the_jax_runner(entry, tmp_path):
    """``serve --multi``, ``serve --state-url`` over a state server and
    ``serve`` over an ``agent_url`` topology reach deploy COMPLETE as
    the JAX package's ``serve`` does on the same path, with the same
    milestones: the service's tasks run in the daemon's sandbox, the
    state lives on the state server."""
    runs = [distributed_run(pkg, tmp_path / pkg, entry)
            for pkg in ("jax", "port")]
    assert runs[1] == runs[0]
    assert runs[0]["sigterm"] == 0
    if entry == "--multi":
        assert runs[0]["put"] == 200
        assert sorted(runs[0]["services"]) == ["other", "tiny"]
    else:
        assert runs[0]["pod"] == [("app-0-main", "TASK_RUNNING")]
    if entry == "agent_url":
        assert runs[0]["ran on the daemon"] is True
        assert runs[0]["local sandbox"] is False
    if entry == "--state-url":
        assert runs[0]["remote tasks"] == ["app-0-main"]
        assert "config-target" in runs[0]["remote tree"]

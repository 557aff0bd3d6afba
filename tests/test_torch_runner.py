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
topology and ``--state-url`` raise the ``ModuleNotFoundError`` of the
port module that is not there yet.  Every subprocess has a deadline,
and each test kills its sessions' processes in a ``finally``."""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

from dcos_commons_tpu.cli import commands as j_commands
from dcos_commons_tpu.storage import FileWalPersister as JWal
from dcos_commons_tpu_torch.cli import commands as t_commands
from dcos_commons_tpu_torch.offer.inventory import GpuHost
from dcos_commons_tpu_torch.runtime import runner as t_runner
from dcos_commons_tpu_torch.scheduler.config import SchedulerConfig
from dcos_commons_tpu_torch.storage import FileWalPersister as TWal
from test_torch_cli import run_main

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


MISSING = {
    "--multi": "dcos_commons_tpu_torch.multi",
    "agent_url": "dcos_commons_tpu_torch.agent.remote",
    "--state-url": "dcos_commons_tpu_torch.storage.remote",
}


@pytest.mark.parametrize("entry", sorted(MISSING))
def test_unported_paths_raise_their_missing_module(entry, tmp_path):
    """In process: the runner's call raises the ``ModuleNotFoundError``
    naming the port's missing module; as a subprocess, ``serve`` fails
    with that module named and runs no stand-in."""
    from dcos_commons_tpu_torch.specification.yaml_spec import from_yaml

    spec = from_yaml(SVC)
    config = SchedulerConfig(state_dir=str(tmp_path / "state"),
                             sandbox_root=str(tmp_path / "sbx"))
    with pytest.raises(ModuleNotFoundError) as err:
        if entry == "--multi":
            t_runner.MultiFrameworkRunner([spec], config).build()
        elif entry == "agent_url":
            t_runner.FrameworkRunner(
                spec, config, topology_hosts=[GpuHost(host_id="h0")],
                agent_urls={"h0": "http://127.0.0.1:1"})._build_infra()
        else:
            config.state_url = "http://127.0.0.1:1"
            t_runner.FrameworkRunner(spec, config)
    assert err.value.name == MISSING[entry]

    topology = None
    extra = ()
    if entry == "--multi":
        extra = ("--multi",)
    elif entry == "agent_url":
        topology = TOPOLOGY["port"] + "    agent_url: http://127.0.0.1:1\n"
    else:
        extra = ("--state-url", "http://127.0.0.1:1")
    rc, log = serve_rc("port", tmp_path, topology=topology, extra=extra)
    assert rc != 0 and f"No module named '{MISSING[entry]}" in log, log

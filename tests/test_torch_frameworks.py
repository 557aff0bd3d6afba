"""The port's cassandra and hdfs schedulers
(``dcos_commons_tpu_torch/frameworks/cassandra_scheduler.py`` and
``hdfs_scheduler.py``) against the reference's
(``frameworks/cassandra/scheduler.py``, ``frameworks/hdfs/scheduler.py``),
over the same ``frameworks/<name>/svc.yml``.

* In the simulation harness (each package's ``ServiceTestRunner`` over
  its ``FakeAgent``, the same host ids): the deploy, the seeds and
  name-node endpoints' bodies, the recovery plan after a PERMANENT
  replace (cassandra: ``REPLACE_ADDRESS`` in the relaunched server's
  env; hdfs: the bootstrap step before the node step) and after a
  transient failure; plans, launches and bodies compared exactly.
* As processes (the runner's ``serve`` with each framework's hooks,
  over a ``LocalProcessAgent``): each scheduler of both packages starts,
  announces, deploys, and serves its custom endpoint beside the SDK's
  routes with the same body.
"""

import contextlib
import importlib.util
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import pytest

from dcos_commons_tpu import testing as j_testing
from dcos_commons_tpu.offer.inventory import TpuHost
from dcos_commons_tpu.plan.status import Status as JStatus
from dcos_commons_tpu.recovery.monitor import (
    TestingFailureMonitor as JFailureMonitor,
)
from dcos_commons_tpu_torch import testing as t_testing
from dcos_commons_tpu_torch.frameworks import (
    cassandra_scheduler as t_cassandra,
)
from dcos_commons_tpu_torch.frameworks import hdfs_scheduler as t_hdfs
from dcos_commons_tpu_torch.offer.inventory import GpuHost
from dcos_commons_tpu_torch.plan.status import Status as TStatus
from dcos_commons_tpu_torch.recovery.monitor import (
    TestingFailureMonitor as TFailureMonitor,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    """The reference's ``frameworks/<name>/scheduler.py`` under a name
    of its own (both frameworks' files are ``scheduler.py``)."""
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}_scheduler",
        os.path.join(REPO, "frameworks", name, "scheduler.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SIDES = {
    "jax": dict(testing=j_testing, host=TpuHost, status=JStatus,
                monitor=JFailureMonitor, cassandra=_load("cassandra"),
                hdfs=_load("hdfs")),
    "torch": dict(testing=t_testing, host=GpuHost, status=TStatus,
                  monitor=TFailureMonitor, cassandra=t_cassandra,
                  hdfs=t_hdfs),
}


def _svc(name):
    with open(os.path.join(REPO, "frameworks", name, "svc.yml")) as f:
        return f.read()


def _cassandra_deploy(tk):
    ticks = []
    for i in range(3):
        ticks += [tk.AdvanceCycles(1),
                  tk.ExpectLaunchedTasks(f"node-{i}-server"),
                  tk.SendTaskRunning(f"node-{i}-server")]
    return ticks + [tk.ExpectDeploymentComplete()]


def _hdfs_deploy(tk):
    return [
        tk.AdvanceCycles(1),
        tk.ExpectLaunchedTasks("journal-0-node", "journal-1-node",
                               "journal-2-node"),
        tk.SendTaskRunning("journal-0-node"),
        tk.SendTaskRunning("journal-1-node"),
        tk.SendTaskRunning("journal-2-node"),
        tk.AdvanceCycles(1),
        tk.ExpectLaunchedTasks("name-0-format"),
        tk.SendTaskFinished("name-0-format"),
        tk.AdvanceCycles(1),
        tk.ExpectLaunchedTasks("name-0-node"),
        tk.SendTaskRunning("name-0-node"),
        tk.AdvanceCycles(1),
        tk.ExpectLaunchedTasks("name-1-bootstrap"),
        tk.SendTaskFinished("name-1-bootstrap"),
        tk.AdvanceCycles(1),
        tk.ExpectLaunchedTasks("name-1-node"),
        tk.SendTaskRunning("name-1-node"),
        tk.AdvanceCycles(1),
        tk.ExpectLaunchedTasks("data-0-node", "data-1-node", "data-2-node"),
        tk.SendTaskRunning("data-0-node"),
        tk.SendTaskRunning("data-1-node"),
        tk.SendTaskRunning("data-2-node"),
        tk.ExpectDeploymentComplete(),
    ]


def _runner(side, name, hosts=3):
    s = SIDES[side]
    return s["testing"].ServiceTestRunner(
        _svc(name), hosts=[s["host"](host_id=f"host-{i}")
                           for i in range(hosts)])


def _plans(scheduler):
    return {
        name: (plan.get_status().value, [
            (phase.name, phase.get_status().value,
             [(step.name, step.get_status().value) for step in phase.steps])
            for phase in plan.phases])
        for name, plan in sorted(scheduler.plans().items())
    }


def _launches(agent):
    return [(i.name, i.agent_id) for i in agent.launched]


# -- cassandra ---------------------------------------------------------


def _seeds(side, monkeypatch):
    runner = _runner(side, "cassandra")
    runner.run(_cassandra_deploy(SIDES[side]["testing"]))
    monkeypatch.setenv("TASKCFG_ALL_REMOTE_SEEDS",
                       "node-0.dc2.fleet.local,node-1.dc2.fleet.local")
    ((method, pattern, handler),) = SIDES[side]["cassandra"]\
        .make_seeds_routes(runner.world.scheduler)
    return (method, pattern, handler(None, None),
            _plans(runner.world.scheduler), _launches(runner.world.agent))


def test_cassandra_seeds_endpoint_bodies_equal(monkeypatch):
    j, t = (_seeds(side, monkeypatch) for side in ("jax", "torch"))
    assert t == j
    method, pattern, (code, body), _plans_, _l = t
    assert (method, pattern, code) == ("GET", r"/v1/seeds", 200)
    assert [s["seed"] for s in body["seeds"]] == [
        "node-0.cassandra.fleet.local", "node-1.cassandra.fleet.local"]
    assert all(s["state"] == "TASK_RUNNING" and s["host"]
               for s in body["seeds"])
    assert body["remote_seeds"] == ["node-0.dc2.fleet.local",
                                    "node-1.dc2.fleet.local"]


def _cassandra_replace(side, permanent):
    s = SIDES[side]
    tk, mod = s["testing"], s["cassandra"]
    runner = _runner(side, "cassandra")
    spec = runner.spec
    task = "node-1-server" if permanent else "node-2-server"

    def hook(builder):
        builder.add_recovery_overrider(mod.make_node_replace_overrider(spec))
        if permanent:
            builder.set_failure_monitor(s["monitor"](permanent_tasks=[task]))

    runner._builder_hook = hook
    runner.run(_cassandra_deploy(tk))
    first_id = runner.world.agent.task_id_of(task)
    runner.run([tk.SendTaskFailed(task), tk.AdvanceCycles(1)])
    during = _plans(runner.world.scheduler)
    runner.run([tk.ExpectLaunchedTasks(task), tk.SendTaskRunning(task),
                tk.ExpectPlanStatus("recovery", s["status"].COMPLETE)])
    info = runner.world.agent.task_info_of(task)
    return (during, _plans(runner.world.scheduler),
            _launches(runner.world.agent), info.task_id != first_id,
            info.env.get("REPLACE_ADDRESS", ""), mod.ring_name(spec, 1))


@pytest.mark.parametrize("permanent", [True, False])
def test_cassandra_recovery_plan_equal(permanent):
    """A PERMANENT replace of node 1 runs the overrider's phase and
    relaunches the server with ``REPLACE_ADDRESS`` set to its ring
    name; a transient failure of node 2 keeps the default recovery
    with no replace address.  Plans, launches and the env are equal."""
    j = _cassandra_replace("jax", permanent)
    t = _cassandra_replace("torch", permanent)
    assert t == j
    during, _after, _launches_, replaced, address, ring = t
    recovery = dict(during)["recovery"][1]
    if permanent:
        assert [step for step, _ in recovery[0][2]] == ["replace-node-1"]
        assert replaced and address == ring == \
            "node-1.cassandra.fleet.local"
    else:
        assert address == ""


# -- hdfs --------------------------------------------------------------


def _name_nodes(side):
    runner = _runner(side, "hdfs", hosts=9)
    runner.run(_hdfs_deploy(SIDES[side]["testing"]))
    ((method, pattern, handler),) = SIDES[side]["hdfs"]\
        .make_name_nodes_routes(runner.world.scheduler)
    return (method, pattern, handler(None, None),
            _plans(runner.world.scheduler), _launches(runner.world.agent))


def test_hdfs_name_nodes_endpoint_bodies_equal():
    j, t = _name_nodes("jax"), _name_nodes("torch")
    assert t == j
    method, pattern, (code, body), _p, _l = t
    assert (method, pattern, code) == ("GET", r"/v1/namenodes", 200)
    assert [n["name"] for n in body["namenodes"]] == ["name-0-node",
                                                       "name-1-node"]
    assert all(n["state"] == "TASK_RUNNING" and n["host"]
               for n in body["namenodes"])


def _hdfs_replace(side, permanent):
    s = SIDES[side]
    tk, mod = s["testing"], s["hdfs"]
    runner = _runner(side, "hdfs", hosts=9)
    spec = runner.spec
    task = "name-1-node" if permanent else "journal-2-node"

    def hook(builder):
        builder.add_recovery_overrider(mod.make_name_node_overrider(spec))
        if permanent:
            builder.set_failure_monitor(s["monitor"](permanent_tasks=[task]))

    runner._builder_hook = hook
    runner.run(_hdfs_deploy(tk))
    runner.run([tk.SendTaskFailed(task), tk.AdvanceCycles(1)])
    during = _plans(runner.world.scheduler)
    if permanent:
        runner.run([
            tk.ExpectLaunchedTasks("name-1-bootstrap"),
            tk.SendTaskFinished("name-1-bootstrap"),
            tk.AdvanceCycles(1),
        ])
    runner.run([tk.ExpectLaunchedTasks(task), tk.SendTaskRunning(task),
                tk.ExpectPlanStatus("recovery", s["status"].COMPLETE)])
    agent = runner.world.agent
    return (during, _plans(runner.world.scheduler), _launches(agent),
            len(agent.launches_of("name-1-bootstrap")),
            len(agent.launches_of(task)))


@pytest.mark.parametrize("permanent", [True, False])
def test_hdfs_recovery_plan_equal(permanent):
    """A PERMANENT name-node replace re-runs the bootstrap step before
    the node step; a journal node's failure keeps the default
    single-step recovery.  Plans and launches are equal."""
    j = _hdfs_replace("jax", permanent)
    t = _hdfs_replace("torch", permanent)
    assert t == j
    during, _after, _launches_, bootstraps, relaunches = t
    recovery = dict(during)["recovery"][1]
    if permanent:
        assert [step for step, _ in recovery[0][2]] == [
            "bootstrap-name-1", "relaunch-name-1"]
        assert bootstraps == 2
    else:
        assert bootstraps == 1 and relaunches == 2


# -- the scheduler processes -------------------------------------------


FRAMEWORKS = {
    # (reference file, port file, endpoint, hosts, the rows' key)
    "cassandra": ("frameworks/cassandra/scheduler.py",
                  "dcos_commons_tpu_torch/frameworks/cassandra_scheduler.py",
                  "/v1/seeds", 3, "seeds"),
    "hdfs": ("frameworks/hdfs/scheduler.py",
             "dcos_commons_tpu_torch/frameworks/hdfs_scheduler.py",
             "/v1/namenodes", 9, "namenodes"),
}


def _live(mark):
    """Live processes whose environment holds ``mark`` (the tasks the
    schedulers' agents started inherit it)."""
    out = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/environ", "rb") as f:
                env = f.read().split(b"\0")
            with open(f"/proc/{pid}/stat") as f:
                state = f.read().rsplit(") ", 1)[1].split()[0]
        except (OSError, IndexError):
            continue
        if state != "Z" and mark.encode() in env:
            out.append(int(pid))
    return out


def _start(path, name, hosts, root):
    os.makedirs(root, exist_ok=True)
    topo = os.path.join(root, "topology.yml")
    with open(topo, "w") as f:
        f.write("hosts:\n" + "".join(
            f"  - host_id: h{i}\n    cpus: 8\n    memory_mb: 8192\n"
            for i in range(hosts)))
    announce = os.path.join(root, "announce")
    proc = subprocess.Popen(
        [sys.executable, path, f"frameworks/{name}/svc.yml",
         "--topology", topo, "--port", "0",
         "--state-dir", os.path.join(root, "state"),
         "--sandbox-root", os.path.join(root, "sbx"),
         "--announce-file", announce, "--env", "SLEEP_DURATION=600"],
        cwd=REPO, env=dict(os.environ, FRAMEWORKS_TEST_ROOT=root),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    return proc, announce


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=5) as r:
        return json.loads(r.read())


@pytest.mark.parametrize("name", sorted(FRAMEWORKS))
def test_scheduler_processes_start_announce_and_serve(name, tmp_path):
    """Both packages' schedulers of ``name`` run as processes at once:
    each announces, deploys its tasks as real processes, serves its
    framework endpoint beside the SDK's health route, and the endpoint
    rows (name or seed, and state) are equal; SIGTERM exits both, and
    the tasks they leave running (by design) are killed after."""
    ref, port_file, endpoint, hosts, key = FRAMEWORKS[name]
    procs = {side: _start(path, name, hosts, str(tmp_path / side))
             for side, path in (("jax", ref), ("torch", port_file))}
    try:
        urls = {}
        deadline = time.monotonic() + 60
        for side, (proc, announce) in procs.items():
            while not os.path.exists(announce):
                assert proc.poll() is None, f"{side} exited {proc.returncode}"
                assert time.monotonic() < deadline, f"{side} never announced"
                time.sleep(0.1)
            with open(announce) as f:
                urls[side] = f.read().strip()
        rows = {}
        deadline = time.monotonic() + 120
        for side, url in urls.items():
            while True:
                body = _get(url, endpoint)[key]
                if body and all(r["state"] == "TASK_RUNNING" and r["host"]
                                for r in body):
                    break
                assert time.monotonic() < deadline, (side, body)
                time.sleep(0.3)
            assert _get(url, "/v1/health")["healthy"]
            rows[side] = [(r.get("name", r.get("seed")), r["state"])
                          for r in body]
        assert rows["torch"] == rows["jax"]
    finally:
        for proc, _announce in procs.values():
            if proc.poll() is None:
                proc.terminate()
        codes = {side: proc.wait(timeout=30)
                 for side, (proc, _a) in procs.items()}
        marks = [f"FRAMEWORKS_TEST_ROOT={tmp_path / side}" for side in procs]
        deadline = time.monotonic() + 10
        while any(_live(m) for m in marks) and time.monotonic() < deadline:
            for pid in [p for m in marks for p in _live(m)]:
                with contextlib.suppress(ProcessLookupError):
                    os.kill(pid, signal.SIGKILL)
            time.sleep(0.1)
        left = [p for m in marks for p in _live(m)]
    assert codes == {"jax": 0, "torch": 0}
    assert not left, left

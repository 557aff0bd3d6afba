"""The port's agent daemon and remote fleet (``agent/daemon.py``,
``agent/remote.py``) against the JAX package's, on the CPU.

Each case is a scenario of ``tests/test_remote_agent.py`` written once
and run on twin objects: JAX ``AgentDaemon``s driven by the JAX
``RemoteAgentClient`` and ``RemoteFleet``, then the port's.  Every
status crosses a real socket, every task runs under its package's
native supervisor in a sandbox tree of its own.  A scenario returns
what it observed (task states in the order they were drained, sandbox
files, refusals, placements, the fleet's down hosts), and the two
packages' observations must be equal.  The port's scheduler places on
``GpuHost``s where the JAX one places on ``TpuHost``s; the fleet's
``agent_id`` is the host id in both.  Cross-package cases drive a JAX
daemon with the port's client and the reverse.  Each test stops its
daemons and kills their tasks in a ``finally``."""

import importlib
import json
import os
import signal
import time
import types
import urllib.error
import urllib.request
from urllib.parse import quote

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVERS_YAML = """
name: web
pods:
  app:
    count: 2
    placement: 'max-per-host:1'
    tasks:
      server:
        goal: RUNNING
        cmd: "echo serving > out.txt && sleep 60"
        cpus: 0.1
        memory: 32
"""


def package(root, host):
    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    common = mod("common")
    scheduler = mod("scheduler")
    return types.SimpleNamespace(
        root=root,
        AgentDaemon=mod("agent.daemon").AgentDaemon,
        RemoteAgentClient=mod("agent.remote").RemoteAgentClient,
        RemoteFleet=mod("agent.remote").RemoteFleet,
        TaskInfo=common.TaskInfo, TaskState=common.TaskState,
        Host=getattr(mod("offer.inventory"), host),
        SliceInventory=mod("offer.inventory").SliceInventory,
        TestingFailureMonitor=mod("recovery.monitor").TestingFailureMonitor,
        SchedulerBuilder=scheduler.SchedulerBuilder,
        SchedulerConfig=scheduler.SchedulerConfig,
        from_yaml=mod("specification").from_yaml,
        MemPersister=mod("storage").MemPersister,
    )


JAX = package("dcos_commons_tpu", "TpuHost")
PORT = package("dcos_commons_tpu_torch", "GpuHost")
PKGS = {"jax": JAX, "port": PORT}


class Daemons:
    """Starts a package's daemons under one directory; ``close`` stops
    them and kills every task their supervisors still run."""

    def __init__(self, P, root):
        self.P = P
        self.root = root
        self.started = []

    def __call__(self, host_id):
        daemon = self.P.AgentDaemon(
            host_id, str(self.root / f"sandbox-{host_id}")).start()
        self.started.append(daemon)
        return daemon

    def close(self):
        for daemon in self.started:
            try:
                daemon.stop()
            except OSError:
                pass
        kill_sandbox_tasks(self.root)


def kill_sandbox_tasks(root):
    """Kill the process group of every task a supervisor under ``root``
    recorded (a stopped daemon leaves its tasks running by design)."""
    for dirpath, _dirs, files in os.walk(root):
        for name in ("child.pid", "task.pid"):
            if name in files:
                try:
                    with open(os.path.join(dirpath, name)) as f:
                        os.killpg(int(f.read()), signal.SIGKILL)
                except (OSError, ValueError):
                    pass


def twin(scenario, tmp_path, *args):
    """Run ``scenario`` on both packages, each with its own daemons;
    their observations must be equal.  Returns the port's."""
    runs = []
    for name, P in (("jax", JAX), ("port", PORT)):
        root = tmp_path / name
        root.mkdir()
        daemons = Daemons(P, root)
        try:
            runs.append(scenario(P, daemons, root, *args))
        finally:
            daemons.close()
    assert runs[1] == runs[0]
    return runs[1]


def drain_until(client, done, timeout_s=10.0):
    """Drain ``client`` until ``done(states)``; returns every
    ``(task_id, state name)`` in the order drained."""
    states = []
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        states += [(s.task_id, s.state.name) for s in client.drain()]
        if done(states):
            break
        time.sleep(0.05)
    return states


def drive(scheduler, until, timeout_s=15.0, interval_s=0.05):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        scheduler.run_cycle()
        if until(scheduler):
            return True
        time.sleep(interval_s)
    return False


def scenario_launch_drain(P, daemons, root):
    daemon = daemons("h0")
    client = P.RemoteAgentClient("h0", daemon.url)
    info = P.TaskInfo(name="app-0-server", task_id="app-0-server__1",
                      agent_id="h0",
                      command="echo hi > out.txt && sleep 0.5")
    client.launch([{"info": info.to_dict()}])
    out = [client.info()["host_id"], "app-0-server__1" in client.tasks()]
    out.append(drain_until(
        client, lambda s: ("app-0-server__1", "FINISHED") in s))
    out.append(client.sandbox_file("app-0-server", "out.txt").strip())
    return out


def test_daemon_launch_drain_roundtrip(tmp_path):
    out = twin(scenario_launch_drain, tmp_path)
    assert out == ["h0", True, [("app-0-server__1", "RUNNING"),
                                ("app-0-server__1", "FINISHED")], "hi"]


def scenario_reconcile(P, daemons, root):
    daemon = daemons("h0")
    client = P.RemoteAgentClient("h0", daemon.url)
    info = P.TaskInfo(name="app-0-server", task_id="app-0-server__1",
                      agent_id="h0", command="sleep 30")
    client.launch([{"info": info.to_dict()}])
    out = [drain_until(client, lambda s: bool(s))]
    out.append([s.state.name for s in client.drain()])
    client.reconcile()
    redelivered = [(s.task_id, s.state.name, s.ready)
                   for s in client.drain()]
    out.append(redelivered)
    fleet = P.RemoteFleet()
    fleet.add_host("h0", daemon.url)
    fleet.reconcile()
    out.append([(s.task_id, s.state.name) for s in fleet.poll()])
    fleet.kill("app-0-server__1")
    return out


def test_daemon_reconcile_rearms_drained_statuses(tmp_path):
    out = twin(scenario_reconcile, tmp_path)
    assert out == [[("app-0-server__1", "RUNNING")], [],
                   [("app-0-server__1", "RUNNING", True)],
                   [("app-0-server__1", "RUNNING")]]


def scenario_templates(P, daemons, root):
    daemon = daemons("h0")
    client = P.RemoteAgentClient("h0", daemon.url)
    info = P.TaskInfo(name="app-0-server", task_id="app-0-server__t",
                      agent_id="h0",
                      command="cat conf/app.cfg > rendered.txt",
                      env={"APP_PORT": "8080"})
    client.launch([{"info": info.to_dict(), "templates": [{
        "name": "app.cfg", "dest": "conf/app.cfg",
        "content": "port={{APP_PORT}} mode={{MODE:-prod}}\n"}]}])
    states = drain_until(client, lambda s: ("app-0-server__t", "FINISHED")
                         in s)
    return [states, client.sandbox_file("app-0-server",
                                         "rendered.txt").strip()]


def test_daemon_renders_templates_before_launch(tmp_path):
    out = twin(scenario_templates, tmp_path)
    assert out[1] == "port=8080 mode=prod"


def errored_messages(client, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        errored = [s.message for s in client.drain()
                   if s.state.name == "ERROR"]
        if errored:
            return errored
        time.sleep(0.05)
    return []


def scenario_template_failure(P, daemons, root):
    daemon = daemons("h0")
    client = P.RemoteAgentClient("h0", daemon.url)
    info = P.TaskInfo(name="app-0-server", task_id="app-0-server__e",
                      agent_id="h0", command="sleep 60")
    client.launch([{"info": info.to_dict(), "templates": [{
        "name": "bad.cfg", "dest": "bad.cfg",
        "content": "value={{UNSET_VARIABLE}}\n"}]}])
    return errored_messages(client)


def test_template_render_failure_fails_task(tmp_path):
    messages = twin(scenario_template_failure, tmp_path)
    assert len(messages) == 1 and "template" in messages[0]


def scenario_sandbox_confined(P, daemons, root):
    daemon = daemons("h0")
    secret = root / "secret.txt"
    secret.write_text("s3cret")
    codes = []
    for task, rel in [("../..", "secret.txt"),
                      ("app-0-server", "../../secret.txt"),
                      ("app-0-server", str(secret))]:
        url = (f"{daemon.url}/v1/agent/sandbox"
               f"?task={quote(task)}&file={quote(rel)}")
        try:
            urllib.request.urlopen(url, timeout=5)
            codes.append(200)
        except urllib.error.HTTPError as e:
            body = json.loads(e.read())
            codes.append((e.code, body["message"].replace(str(root), "<root>")))
    return codes


def test_sandbox_read_confined_to_task_sandbox(tmp_path):
    codes = twin(scenario_sandbox_confined, tmp_path)
    assert [c[0] for c in codes] == [404, 404, 404]


def scenario_template_escape(P, daemons, root):
    daemon = daemons("h0")
    client = P.RemoteAgentClient("h0", daemon.url)
    info = P.TaskInfo(name="app-0-server", task_id="app-0-server__esc",
                      agent_id="h0", command="sleep 60")
    client.launch([{"info": info.to_dict(), "templates": [{
        "name": "evil", "dest": "../outside.txt", "content": "x"}]}])
    messages = errored_messages(client)
    return [["escapes the sandbox" in m for m in messages],
            (root / "sandbox-h0" / "outside.txt").exists()]


def test_template_dest_escape_fails_task(tmp_path):
    assert twin(scenario_template_escape, tmp_path) == [[True], False]


def build_remote_scheduler(P, fleet, hosts, root, monitor=None):
    builder = P.SchedulerBuilder(
        P.from_yaml(SERVERS_YAML),
        P.SchedulerConfig(sandbox_root=str(root / "unused"),
                          backoff_enabled=False),
        P.MemPersister())
    builder.set_inventory(P.SliceInventory(hosts))
    builder.set_agent(fleet)
    if monitor is not None:
        builder.set_failure_monitor(monitor)
    return builder.build()


def scenario_deploy(P, daemons, root):
    fleet = P.RemoteFleet()
    hosts = []
    for i in range(2):
        fleet.add_host(f"h{i}", daemons(f"h{i}").url)
        hosts.append(P.Host(host_id=f"h{i}"))
    scheduler = build_remote_scheduler(P, fleet, hosts, root)
    out = [drive(scheduler,
                 lambda s: s.deploy_manager.get_plan().is_complete)]
    placed = {}
    for i in range(2):
        info = scheduler.state_store.fetch_task(f"app-{i}-server")
        placed[info.agent_id] = fleet.client(info.agent_id).sandbox_file(
            f"app-{i}-server", "out.txt").strip()
    out.append(placed)
    fleet.kill(scheduler.state_store.fetch_task("app-0-server").task_id)
    return out


def test_deploy_across_remote_daemons(tmp_path):
    out = twin(scenario_deploy, tmp_path)
    assert out == [True, {"h0": "serving", "h1": "serving"}]


def scenario_host_down(P, daemons, root):
    hosts = [P.Host(host_id=f"h{i}") for i in range(3)]
    fleet = P.RemoteFleet(down_after=2, timeout_s=1.0)
    victim = daemons("h0")
    fleet.add_host("h0", victim.url)
    fleet.add_host("h1", daemons("h1").url)
    fleet.add_host("h2", daemons("h2").url)
    scheduler = build_remote_scheduler(
        P, fleet, hosts, root,
        monitor=P.TestingFailureMonitor(["app-0-server", "app-1-server"]))
    fleet.on_host_down = scheduler.inventory.mark_down
    fleet.on_host_up = scheduler.inventory.mark_up
    out = [drive(scheduler,
                 lambda s: s.deploy_manager.get_plan().is_complete)]
    placed = {i: scheduler.state_store.fetch_task(f"app-{i}-server")
              .agent_id for i in range(2)}
    out.append(placed)
    victim_index = next(i for i, h in placed.items() if h == "h0")
    victim.stop()

    def replaced(s):
        info = s.state_store.fetch_task(f"app-{victim_index}-server")
        status = s.state_store.fetch_status(f"app-{victim_index}-server")
        return (info is not None and info.agent_id != "h0"
                and status is not None and status.task_id == info.task_id
                and status.state is P.TaskState.RUNNING)

    out.append(drive(scheduler, replaced, timeout_s=30.0))
    out.append(scheduler.state_store.fetch_task(
        f"app-{victim_index}-server").agent_id)
    out.append([sorted(fleet.down_hosts()), scheduler.inventory.is_up("h0")])
    other = 1 - victim_index
    out.append(scheduler.state_store.fetch_task(
        f"app-{other}-server").agent_id == placed[other])
    return out


def test_daemon_death_triggers_host_down_and_replace(tmp_path):
    """A daemon's death: ``down_after`` failed polls mark its host down,
    its task is synthesized ``TASK_LOST`` and replaced on the spare."""
    out = twin(scenario_host_down, tmp_path)
    assert out[0] is True and out[2:] == [True, "h2", [["h0"], False], True]


def scenario_telemetry(P, daemons, root):
    out = []
    daemon = daemons("h0")
    client = P.RemoteAgentClient("h0", daemon.url)
    record = {"step": 3, "t": 10.0, "wall_s": 0.5, "blocked_s": 0.1}
    stats = {"queue_depth": 2, "active_slots": 1, "ttft_p95_s": 0.8}
    info = P.TaskInfo(
        name="app-0-server", task_id="app-0-server__tl", agent_id="h0",
        command=(f"echo '{json.dumps(record)}' > steplog.jsonl && "
                 f"echo '{json.dumps(stats)}' > servestats.json && "
                 "sleep 60"))
    client.launch([{"info": info.to_dict()}])
    fleet = P.RemoteFleet()
    fleet.add_host("h0", daemon.url)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        if any(s.state.is_running for s in fleet.poll()):
            break
        time.sleep(0.05)
    records = []
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and not records:
        records = client.steplog_of("app-0-server")
        time.sleep(0.05)
    out.append(records)
    out.append(client.serving_stats_of("app-0-server"))
    out.append([fleet.steplog_of("app-0-server"),
                fleet.serving_stats_of("app-0-server"),
                fleet.steplog_of("never-launched"),
                fleet.serving_stats_of("never-launched"),
                fleet.steplog_of("app-0-server", agent_id="h0"),
                fleet.steplog_of("app-0-server", agent_id="h-unknown")])
    fleet.poll()
    gen_before = fleet._owners_gen
    fleet.poll()
    out.append(fleet._owners_gen == gen_before)
    d1 = daemons("h1")
    fleet.add_host("h1", d1.url)
    fleet.kill(info.task_id)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        if any(s.state.is_terminal for s in fleet.poll()):
            break
        time.sleep(0.05)
    moved_record = {"step": 9, "t": 20.0, "wall_s": 0.7, "blocked_s": 0.2}
    moved = P.TaskInfo(
        name="app-0-server", task_id="app-0-server__tl2", agent_id="h1",
        command=f"echo '{json.dumps(moved_record)}' > steplog.jsonl && "
                "sleep 60")
    P.RemoteAgentClient("h1", d1.url).launch([{"info": moved.to_dict()}])
    routed = []
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and not routed:
        fleet.poll()
        routed = fleet.steplog_of("app-0-server")
        time.sleep(0.05)
    out.append(routed)
    daemon.stop()
    d1.stop()
    out.append([fleet.steplog_of("app-0-server"),
                fleet.serving_stats_of("app-0-server"),
                fleet.down_hosts()])
    return out


def test_fleet_telemetry_fan_in_over_the_wire(tmp_path):
    out = twin(scenario_telemetry, tmp_path)
    record = {"step": 3, "t": 10.0, "wall_s": 0.5, "blocked_s": 0.1}
    assert out[0] == [record]
    assert out[2] == [[record], out[1], [], {}, [record], []]
    assert out[3] is True
    assert out[4] == [{"step": 9, "t": 20.0, "wall_s": 0.7,
                       "blocked_s": 0.2}]
    assert out[5][:2] == [[], {}] and not out[5][2]


def scenario_kill_unknown_owner(P, daemons, root):
    fleet = P.RemoteFleet()
    d0, d1 = daemons("h0"), daemons("h1")
    fleet.add_host("h0", d0.url)
    fleet.add_host("h1", d1.url)
    info = P.TaskInfo(name="app-0-server", task_id="app-0-server__b",
                      agent_id="h1", command="sleep 60")
    P.RemoteAgentClient("h1", d1.url).launch([{"info": info.to_dict()}])
    fleet.kill("app-0-server__b")
    states = []
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and ("app-0-server__b",
                                           "KILLED") not in states:
        states += [(s.task_id, s.state.name) for s in fleet.poll()]
        time.sleep(0.05)
    return states[-1]


def test_fleet_kill_unknown_owner_broadcasts(tmp_path):
    assert twin(scenario_kill_unknown_owner, tmp_path) == (
        "app-0-server__b", "KILLED")


def scenario_crash_restart(P, daemons, root):
    workdir = str(root / "sandbox-crash")
    first = P.AgentDaemon("hx", workdir).start()
    daemons.started.append(first)
    client = P.RemoteAgentClient("hx", first.url)
    client.launch([
        {"info": P.TaskInfo(name="app-0-long", task_id="app-0-long__1",
                            agent_id="hx", command="sleep 30").to_dict()},
        {"info": P.TaskInfo(name="app-0-short", task_id="app-0-short__1",
                            agent_id="hx", command="exit 0").to_dict()},
    ])
    exit_file = (root / "sandbox-crash" / "app-0-short" / ".super"
                 / "app-0-short__1" / "exit_status")
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and not exit_file.exists():
        time.sleep(0.05)
    out = [exit_file.exists()]
    first._server.shutdown()
    first._server.server_close()
    daemons.started.remove(first)
    second = P.AgentDaemon("hx", workdir).start()
    daemons.started.append(second)
    client2 = P.RemoteAgentClient("hx", second.url)
    out.append(sorted(client2.tasks()))
    seen = set()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and not {
            ("app-0-short__1", "FINISHED"),
            ("app-0-long__1", "RUNNING")} <= seen:
        seen |= {(s.task_id, s.state.name) for s in client2.drain()}
        time.sleep(0.05)
    out.append(sorted(seen))
    client2.kill("app-0-long__1", 0.5)
    killed = drain_until(client2, lambda s: ("app-0-long__1", "KILLED") in s)
    out.append(killed[-1])
    return out


def test_daemon_crash_restart_recovers_tasks(tmp_path):
    """A daemon that dies without cleanup loses no task: a fresh daemon
    over the same workdir resumes the live one and reports the exited
    one's fate."""
    out = twin(scenario_crash_restart, tmp_path)
    assert out == [True, ["app-0-long__1"],
                   [("app-0-long__1", "RUNNING"),
                    ("app-0-short__1", "FINISHED")],
                   ("app-0-long__1", "KILLED")]


def scenario_taskcfg(P, daemons, root):
    """``tests/test_helloworld.py``'s config plane through a daemon: it
    renders server.properties from the task env, and a config update
    relaunches the task with the file rendered again."""
    daemon = daemons("h0")
    fleet = P.RemoteFleet()
    fleet.add_host("h0", daemon.url)
    persister = P.MemPersister()
    hosts = [P.Host(host_id="h0")]
    from_yaml_file = importlib.import_module(
        f"{P.root}.specification").from_yaml_file

    def build(greeting):
        spec = from_yaml_file(
            os.path.join(REPO, "frameworks", "helloworld", "taskcfg.yml"),
            env={"TASKCFG_ALL_GREETING": greeting})
        builder = P.SchedulerBuilder(
            spec, P.SchedulerConfig(sandbox_root=str(root / "unused"),
                                    backoff_enabled=False), persister)
        builder.set_inventory(P.SliceInventory(hosts))
        builder.set_agent(fleet)
        return builder.build()

    out = []
    for greeting in ("v1", "v2"):
        scheduler = build(greeting)
        out.append(drive(scheduler, lambda s: s.deploy_manager.get_plan()
                         .is_complete, timeout_s=20.0))
        rendered = fleet.client("h0").sandbox_file("hello-0-server",
                                                   "server.properties")
        out.append(sorted(line for line in rendered.splitlines()
                          if line.split("=")[0] in (
                              "greeting", "pod-index", "hostname")))
    return out


def test_taskcfg_template_rendered_and_rerendered_on_update(tmp_path):
    out = twin(scenario_taskcfg, tmp_path)
    assert out[0] is out[2] is True
    assert "greeting=v1" in out[1] and "greeting=v2" in out[3]
    assert {"pod-index=0", "hostname=hello-0-server"} <= set(out[1])


# -- the wire across packages -----------------------------------------


def scenario_cross_wire(daemon_pkg, client_pkg, root):
    """A ``client_pkg`` client and fleet drive a ``daemon_pkg`` daemon:
    launch with a template, drain, sandbox, steplog, reconcile, kill."""
    D, C = PKGS[daemon_pkg], PKGS[client_pkg]
    daemons = Daemons(D, root)
    try:
        daemon = daemons("h0")
        client = C.RemoteAgentClient("h0", daemon.url)
        record = {"step": 1, "t": 1.0, "wall_s": 0.25, "blocked_s": 0.0}
        info = C.TaskInfo(
            name="app-0-server", task_id="app-0-server__x", agent_id="h0",
            command=(f"echo '{json.dumps(record)}' > steplog.jsonl && "
                     "cat conf/app.cfg > rendered.txt && sleep 30"),
            env={"APP_PORT": "8080"})
        client.launch([{"info": info.to_dict(), "templates": [{
            "name": "app.cfg", "dest": "conf/app.cfg",
            "content": "port={{APP_PORT}}\n"}]}])
        out = [client.info()["host_id"], client.tasks()]
        out.append(drain_until(client, lambda s: bool(s)))
        records = []
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not records:
            records = client.steplog_of("app-0-server")
            time.sleep(0.05)
        out.append(records)
        out.append(client.sandbox_file("app-0-server",
                                       "rendered.txt").strip())
        fleet = C.RemoteFleet()
        fleet.add_host("h0", daemon.url)
        fleet.reconcile()
        out.append([(s.task_id, s.state.name, s.ready)
                    for s in fleet.poll()])
        fleet.kill("app-0-server__x")
        states = []
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not states:
            states = [(s.task_id, s.state.name) for s in fleet.poll()
                      if s.state.is_terminal]
            time.sleep(0.05)
        out.append(states)
        return out
    finally:
        daemons.close()


@pytest.mark.parametrize("daemon_pkg,client_pkg",
                         [("jax", "port"), ("port", "jax")])
def test_client_of_one_package_drives_a_daemon_of_the_other(
        daemon_pkg, client_pkg, tmp_path):
    """The port's ``RemoteAgentClient`` and ``RemoteFleet`` against a
    JAX ``AgentDaemon``, and the reverse, observe what a client of the
    daemon's own package observes: the wire is the same."""
    crossed = scenario_cross_wire(daemon_pkg, client_pkg, tmp_path / "x")
    own = scenario_cross_wire(daemon_pkg, daemon_pkg, tmp_path / "own")
    assert crossed == own
    assert crossed[2:] == [
        [("app-0-server__x", "RUNNING")],
        [{"step": 1, "t": 1.0, "wall_s": 0.25, "blocked_s": 0.0}],
        "port=8080", [("app-0-server__x", "RUNNING", True)],
        [("app-0-server__x", "KILLED")]]

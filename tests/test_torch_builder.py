"""The port's ``SchedulerBuilder`` (``dcos_commons_tpu_torch/scheduler/
builder.py``) and uninstall scheduler against the JAX package's, on the
CPU.

- Every helloworld/hdfs/cassandra YAML and the port's five YAMLs (the
  JAX package's ``frameworks/jax/`` five beside them), built by both
  builders over a ``MemPersister``: the same plans (names, statuses,
  ``serialize_plan`` with element ids pinned), the same target config
  (bytes, or equal once the designed differences are mapped), the same
  stored tree, or the same refusal.
- The same YAMLs deployed by each builder's scheduler through
  ``run_cycle`` over twin ``FakeAgent``s (test_torch_scheduler's
  ``Twin``, built instead of wired): the same launches, kills and plan
  statuses cycle by cycle, and the same WAL record by record.
- The builder's ``ConfigValidationError`` texts, the decommission plan
  of stored surplus instances, the autoscale count overlay, and the
  uninstall branch's ``UninstallScheduler``.
- The state crossing: a ``FileWalPersister`` tree written by one
  package's builder is rebuilt by the other's with the same plans,
  statuses and target config id.
- ``make_persister``'s remote branch: a ``RemotePersister`` over a live
  state server.
- ``tests/test_scheduler_e2e.py``'s flows, twinned: each builder over a
  real ``LocalProcessAgent`` and ``sleep`` tasks (deploy, finish, kill
  and recovery, permanent replace, scheduler restart, a WAL-only
  launch, a config update), the same outcome from both.

Ids are uuid4s: each package draws them from its own pinned counter
(``pinned`` of test_torch_scheduler), so they compare too."""

import json
import os
import shutil
import time
import types

import pytest

from dcos_commons_tpu.agent import LocalProcessAgent as JLocalAgent
from dcos_commons_tpu.debug import trackers as j_trackers
from dcos_commons_tpu.offer.inventory import TpuHost
from dcos_commons_tpu.plan.step import PodInstanceRequirement as JReq
from dcos_commons_tpu.recovery import monitor as j_monitor
from dcos_commons_tpu.scheduler import builder as j_builder
from dcos_commons_tpu.scheduler.config import SchedulerConfig as JConfig
from dcos_commons_tpu.storage import MemPersister as JMem
from dcos_commons_tpu import testing as j_testing
from dcos_commons_tpu import uninstall as j_uninstall
from dcos_commons_tpu_torch.agent import LocalProcessAgent as TLocalAgent
from dcos_commons_tpu_torch.debug import trackers as t_trackers
from dcos_commons_tpu_torch.offer.inventory import GpuHost
from dcos_commons_tpu_torch.plan.step import PodInstanceRequirement as TReq
from dcos_commons_tpu_torch.recovery import monitor as t_monitor
from dcos_commons_tpu_torch.scheduler import builder as t_builder
from dcos_commons_tpu_torch.scheduler.config import SchedulerConfig as TConfig
from dcos_commons_tpu_torch.storage import FileWalPersister as TWal
from dcos_commons_tpu_torch.storage import MemPersister as TMem
from dcos_commons_tpu_torch import testing as t_testing
from dcos_commons_tpu_torch import uninstall as t_uninstall
from test_torch_scheduler import (
    JAX as J_SCHED,
    PORT as T_SCHED,
    PORT_YAMLS,
    REFERENCE_YAMLS,
    REPO,
    Twin,
    _both,
    cpu_fleet,
    designed,
    pin_ids,
    pinned,  # noqa: F401 — the fixture
    wal_records,
)
from dcos_commons_tpu.offer.inventory import make_test_fleet

JAX = types.SimpleNamespace(
    **vars(J_SCHED), builder=j_builder, config=JConfig, mem=JMem,
    trackers=j_trackers, testing=j_testing, uninstall=j_uninstall,
    monitor=j_monitor, local=JLocalAgent, req=JReq,
    host=lambda host_id, **kw: TpuHost(host_id=host_id, **kw))
PORT = types.SimpleNamespace(
    **vars(T_SCHED), builder=t_builder, config=TConfig, mem=TMem,
    trackers=t_trackers, testing=t_testing, uninstall=t_uninstall,
    monitor=t_monitor, local=TLocalAgent, req=TReq,
    host=lambda host_id, **kw: GpuHost(host_id=host_id, **kw))
PACKAGES = (JAX, PORT)

# the CA's key and certificate are random: equal in layout, not bytes
RANDOM_PATHS = ("/security/ca/key.pem", "/security/ca/cert.pem")


def same_value(jv, tv):
    """Two stored values: equal bytes, or equal JSON once ``designed``
    maps the port's designed differences out."""
    if jv == tv:
        return True
    try:
        return designed(json.loads(jv), False) == designed(json.loads(tv),
                                                           True)
    except ValueError:
        return False


def same_tree(jdump, tdump):
    """Two persisters' trees: the same paths, each value the same."""
    assert sorted(jdump) == sorted(tdump)
    for path in jdump:
        if path in RANDOM_PATHS:
            assert bool(jdump[path]) == bool(tdump[path])
            continue
        assert same_value(jdump[path], tdump[path]), path


def plans_of(pkg, sched):
    return {name: pkg.trackers.serialize_plan(plan)
            for name, plan in sorted(sched.plans().items())}


def build(pkg, spec, persister, **config):
    """``SchedulerBuilder(...).build()``, or the refusal's type and
    texts."""
    builder = pkg.builder.SchedulerBuilder(
        spec, pkg.config(backoff_enabled=False, **config), persister)
    builder.set_inventory(pkg.offer.SliceInventory([]))
    builder.set_agent(pkg.agent())
    try:
        return builder.build()
    except Exception as e:  # noqa: BLE001 — compared across packages
        return (type(e).__name__, getattr(e, "errors", str(e)))


def compare_builds(specs, **config):
    """Both packages' builds of ``specs`` over fresh ``MemPersister``s:
    the same plans, target config and stored tree, or the same
    refusal.  Returns the two schedulers (or refusals)."""
    out = []
    for pkg, spec in zip(PACKAGES, specs):
        persister = pkg.mem()
        out.append((build(pkg, spec, persister, **config), persister))
    (jsched, jpers), (tsched, tpers) = out
    if isinstance(jsched, tuple):
        assert tsched == jsched
        return jsched, tsched
    assert plans_of(PORT, tsched) == plans_of(JAX, jsched)
    jtarget = jsched.config_store.get_target_config()
    ttarget = tsched.config_store.get_target_config()
    assert ttarget == jtarget
    assert designed(tsched.config_store.fetch(ttarget), True) == designed(
        jsched.config_store.fetch(jtarget), False)
    same_tree(jpers.dump(), tpers.dump())
    return jsched, tsched


@pytest.mark.parametrize("rel", REFERENCE_YAMLS)
def test_reference_yamls_build_as_the_jax_builder(rel, pinned):
    specs = _both(lambda pkg: os.path.join(REPO, "frameworks", rel))
    if specs[0] is None:
        return  # both refuse the YAML (test_torch_spec holds why)
    jsched, _ = compare_builds(specs)
    if rel.endswith("secrets.yml"):
        # no provider: the builder refuses before any plan is built
        assert jsched[0] == "ConfigValidationError"


@pytest.mark.parametrize("name", sorted(PORT_YAMLS))
def test_port_yamls_build_as_the_jax_ones(name, pinned):
    specs = _both(lambda pkg: os.path.join(pkg.frameworks, name))
    jsched, tsched = compare_builds(specs)
    assert not isinstance(jsched, tuple)
    assert sorted(tsched.plans()) == sorted(jsched.plans())
    assert tsched.deploy_manager.get_plan().phases


# -- builder-built twins, driven ----------------------------------------


class BuiltTwin(Twin):
    """test_torch_scheduler's ``Twin`` with the scheduler that
    ``SchedulerBuilder`` builds in place of the hand-wired one: no
    launch backoff and an unthrottled revive bucket (each read the real
    clock), every other setting the builder's default."""

    def __init__(self, pkg, spec, hosts, directory, clock):
        self.pkg = pkg
        self.spec = spec
        self.hosts = pkg.fleet(hosts)
        self.directory = directory
        self.clock = clock
        self.agent = pkg.agent()
        self.persister = pkg.wal(directory, fsync=False,
                                 compact_every=1 << 30)
        config = pkg.config(backoff_enabled=False, revive_capacity=1 << 30)
        self.sched = (pkg.builder.SchedulerBuilder(spec, config,
                                                   self.persister)
                      .set_inventory(pkg.offer.SliceInventory(self.hosts))
                      .set_agent(self.agent)
                      .build())
        self.sched.actions._clock = clock.time
        self.seen = self.kills = self.n = 0
        self.fail = {}


def compare_wals(jdir, tdir):
    """test_torch_scheduler's record-by-record WAL comparison, with the
    CA's random key and certificate compared by presence.  Returns
    (values equal byte for byte, values equal by design)."""
    jwal, twal = wal_records(jdir), wal_records(tdir)
    assert len(jwal) == len(twal)
    raw = mapped = 0
    for jtx, ttx in zip(jwal, twal):
        assert [(op, path) for op, path, _ in jtx] == [
            (op, path) for op, path, _ in ttx]
        for (_, path, jv), (_, _, tv) in zip(jtx, ttx):
            if path in RANDOM_PATHS:
                assert bool(jv) == bool(tv)
            elif jv == tv:
                raw += 1
            else:
                assert same_value(jv, tv), path
                mapped += 1
    return raw, mapped


def built_twin_run(specs, hosts, tmp_path, clocks):
    """Both packages' builder-built schedulers deployed by ``run_cycle``
    over fake agents, every third launch failing once: the same trace
    and the same WAL record by record."""
    sides = [BuiltTwin(pkg, spec, hosts, str(tmp_path / pkg.name),
                       clocks[pkg.name])
             for pkg, spec in zip(PACKAGES, specs)]
    traces = [side.drive() for side in sides]
    for side in sides:
        side.close()
    assert traces[1] == traces[0]
    return traces[0], compare_wals(sides[0].directory, sides[1].directory)


@pytest.mark.parametrize("rel", REFERENCE_YAMLS)
def test_builder_built_reference_yamls_deploy_as_the_jax_ones(rel, pinned,
                                                              tmp_path):
    specs = _both(lambda pkg: os.path.join(REPO, "frameworks", rel))
    if specs[0] is None or rel.endswith("secrets.yml"):
        return  # refused by both: to the spec, or (no provider) to build
    _, (raw, _) = built_twin_run(specs, cpu_fleet(), tmp_path, pinned)
    assert raw > 0


@pytest.mark.parametrize("name", sorted(PORT_YAMLS))
def test_builder_built_port_yamls_deploy_as_the_jax_ones(name, pinned,
                                                         tmp_path):
    specs = _both(lambda pkg: os.path.join(pkg.frameworks, name))
    trace, (_, mapped) = built_twin_run(
        specs, make_test_fleet(**PORT_YAMLS[name]), tmp_path, pinned)
    launched = [n for obs in trace if obs[0] == "cycle" for n, *_ in obs[1]]
    assert launched and mapped > 0


# -- the builder's refusals ---------------------------------------------

SECRET_YAML = """
name: secret-svc
pods:
  app:
    count: 1
    secrets:
      pw:
        secret: app/password
        file: pw.txt
    tasks:
      run:
        goal: RUNNING
        cmd: "sleep 100"
        cpus: 0.1
        memory: 32
"""

SIMPLE_YAML = """
name: simple
pods:
  web:
    count: 2
    allow-decommission: true
    tasks:
      srv:
        goal: RUNNING
        cmd: "sleep 100"
        cpus: 0.1
        memory: 32
        volume:
          path: data
          size: 64
          type: ROOT
"""


def yaml_specs(text, **env):
    return [pkg.yaml.from_yaml(text, env=env) for pkg in PACKAGES]


def test_secrets_without_a_provider_refused_with_the_same_text(pinned,
                                                               tmp_path):
    jref, tref = compare_builds(yaml_specs(SECRET_YAML))
    assert jref[0] == "ConfigValidationError"
    assert "no secrets provider is configured" in jref[1][0]
    # a secrets directory is a provider: both build
    compare_builds(yaml_specs(SECRET_YAML), secrets_dir=str(tmp_path))


def test_rejected_config_update_keeps_the_target(pinned):
    """A volume change after the first target: the update is refused,
    the old target kept and the refusal's texts land in the deploy
    plan's errors, the same in both."""
    out = []
    for pkg in PACKAGES:
        persister = pkg.mem()
        first = build(pkg, pkg.yaml.from_yaml(SIMPLE_YAML), persister)
        target = first.config_store.get_target_config()
        changed = pkg.yaml.from_yaml(SIMPLE_YAML.replace("size: 64",
                                                         "size: 128"))
        second = build(pkg, changed, persister)
        assert second.config_store.get_target_config() == target
        out.append((target, plans_of(pkg, second)))
    assert out[1] == out[0]
    assert out[0][1]["deploy"]["errors"]


def test_invalid_first_config_refuses_to_start(pinned):
    bad = SIMPLE_YAML.replace("count: 2", "count: 2\n    placement: 'no-such-rule:1'")
    jref, tref = compare_builds(yaml_specs(bad))
    assert jref[0] == "ConfigValidationError" and jref[1]


# -- decommission, autoscale, uninstall ---------------------------------

THREE_POD_YAML = """
name: shrink-svc
pods:
  web:
    count: 3
    allow-decommission: true
    tasks:
      srv:
        goal: RUNNING
        cmd: "serve"
        cpus: 0.1
        memory: 32
"""


def deploy_three(pkg, persister=None):
    t = pkg.testing
    runner = t.ServiceTestRunner(THREE_POD_YAML, persister=persister)
    runner.run([
        t.AdvanceCycles(1), t.SendTaskRunning("web-0-srv"),
        t.AdvanceCycles(1), t.SendTaskRunning("web-1-srv"),
        t.AdvanceCycles(1), t.SendTaskRunning("web-2-srv"),
        t.ExpectDeploymentComplete(),
    ])
    return runner


def rebuild(pkg, runner, text, **config):
    """A builder over the runner's persister, fleet and agent."""
    builder = pkg.builder.SchedulerBuilder(
        pkg.yaml.from_yaml(text), pkg.config(backoff_enabled=False,
                                             **config), runner.persister)
    builder.set_inventory(runner.inventory)
    builder.set_agent(runner.agent)
    return builder.build()


def test_decommission_plan_of_stored_surplus_is_the_same(pinned):
    out = []
    for pkg in PACKAGES:
        runner = deploy_three(pkg)
        sched = rebuild(pkg, runner,
                        THREE_POD_YAML.replace("count: 3", "count: 2"))
        out.append(plans_of(pkg, sched))
    assert out[1] == out[0]
    assert [p["name"] for p in out[0]["decommission"]["phases"]] == [
        "decommission-web-2"]


@pytest.mark.parametrize("raw", [b"5@3", b"2@3", b"5", b"5@4", b"x@3",
                                 b"\xff@3"])
def test_autoscale_counts_overlay_as_the_jax_builder(raw, pinned):
    """A stored ``autoscale-count-web`` property (``count@floor``) over
    the 3-instance spec: the same counts, baselines and plans."""
    out = []
    for pkg in PACKAGES:
        runner = deploy_three(pkg)
        store = runner.world.scheduler.state_store
        store.store_property("autoscale-count-web", raw)
        spec, baselines = pkg.builder._apply_autoscale_counts(
            pkg.yaml.from_yaml(THREE_POD_YAML), store)
        sched = rebuild(pkg, runner, THREE_POD_YAML)
        out.append(([(p.type, p.count) for p in spec.pods], baselines,
                    [(p.type, p.count) for p in sched.spec.pods],
                    dict(sched.actions.baselines), plans_of(pkg, sched)))
    assert out[1] == out[0]


def test_uninstall_branch_builds_the_same_uninstall_scheduler(pinned):
    out = []
    for pkg in PACKAGES:
        runner = deploy_three(pkg)
        sched = rebuild(pkg, runner, THREE_POD_YAML, uninstall=True)
        assert isinstance(sched, pkg.uninstall.UninstallScheduler)
        trace = [plans_of(pkg, sched)]
        for _ in range(4):
            sched.run_cycle()
            trace.append(plans_of(pkg, sched))
        out.append((trace, sched.is_complete,
                    sorted(runner.agent.killed_names()),
                    runner.persister.get_children_or_empty("/")))
    assert out[1] == out[0]
    assert out[0][1] and out[0][3] == []


# -- the state crossing -------------------------------------------------

HELLO = os.path.join(REPO, "frameworks", "helloworld", "svc.yml")


def wal_deploy(pkg, directory, cycles):
    """helloworld deployed by ``pkg``'s sim runner over a WAL for
    ``cycles`` scripted rounds, then closed."""
    t = pkg.testing
    persister = pkg.wal(directory, fsync=False)
    spec = _both(lambda p: HELLO)[PACKAGES.index(pkg)]
    runner = t.ServiceTestRunner(spec=spec, persister=persister)
    world = runner.build()
    for _ in range(cycles):
        world.scheduler.run_cycle()
        for info in world.new_launches():
            runner.run([t.SendTaskRunning(info.name)])
        world.launch_watermark = len(world.agent.launched)
    persister.close()


def rebuilt_view(pkg, directory):
    persister = pkg.wal(directory, fsync=False)
    spec = _both(lambda p: HELLO)[PACKAGES.index(pkg)]
    sched = build(pkg, spec, persister)
    view = (plans_of(pkg, sched), sched.config_store.get_target_config(),
            {n: s.state.name for n, s in
             sched.state_store.fetch_statuses().items()},
            sorted(i.task_id for i in sched.state_store.fetch_tasks()))
    persister.close()
    return view


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("cycles", [2, 6])
def test_state_crosses_between_the_packages(writer, cycles, pinned,
                                            tmp_path, monkeypatch):
    """One package's sim runner writes a WAL (mid-deploy or complete);
    copies of it are rebuilt by both builders: the same plans, statuses
    and target config id."""
    wpkg = JAX if writer == "jax" else PORT
    src = str(tmp_path / "written")
    wal_deploy(wpkg, src, cycles)
    views = []
    for pkg in PACKAGES:
        directory = str(tmp_path / pkg.name)
        shutil.copytree(src, directory)
        # each rebuild draws its ids from the same point, past the
        # writer's
        pin_ids(monkeypatch, 1000)
        views.append(rebuilt_view(pkg, directory))
    assert views[1] == views[0]
    assert views[0][2]  # statuses were stored and read back


def test_make_persister_remote_is_a_remote_persister():
    """``make_persister`` with a ``state_url`` returns a
    ``RemotePersister`` over that state server (under the store cache),
    as the JAX one does: what it writes the server holds."""
    from dcos_commons_tpu.storage import remote as j_remote
    from dcos_commons_tpu_torch.storage import remote as t_remote

    for builder, config, remote in ((j_builder, JConfig, j_remote),
                                    (t_builder, TConfig, t_remote)):
        server = t_remote.StateServer().start()
        try:
            persister = builder.make_persister(
                config(state_url=server.url))
            assert type(persister).__name__ == "PersisterCache"
            assert type(persister._backend) is remote.RemotePersister
            persister.set("/svc/a", b"1")
            assert server._backend.get("/svc/a") == b"1"
        finally:
            server.stop()


def test_make_persister_local_is_the_file_wal(tmp_path):
    persister = t_builder.make_persister(TConfig(state_dir=str(tmp_path)))
    assert isinstance(persister, TWal)
    persister.close()


# -- tests/test_scheduler_e2e.py's flows over real processes ------------

HELLO_YAML = """
name: hello-world
pods:
  hello:
    count: 2
    placement: 'max-per-host:1'
    tasks:
      server:
        goal: RUNNING
        cmd: "echo hello-$POD_INSTANCE_INDEX > out.txt && sleep 60"
        cpus: 0.1
        memory: 32
"""

ONCE_YAML = """
name: once-svc
pods:
  job:
    count: 1
    tasks:
      run:
        goal: FINISH
        cmd: "echo done > result.txt"
        cpus: 0.1
        memory: 32
"""


def e2e_builder(pkg, text, tmp_path, persister=None, agent=None):
    spec = pkg.yaml.from_yaml(text)
    root = str(tmp_path / pkg.name / "sandboxes")
    config = pkg.config(sandbox_root=root, backoff_enabled=False)
    builder = pkg.builder.SchedulerBuilder(spec, config,
                                           persister or pkg.mem())
    builder.set_inventory(pkg.offer.SliceInventory(
        [pkg.host(f"h{i}") for i in range(3)]))
    builder.set_agent(agent or pkg.local(root))
    return builder


def drive(scheduler, until, timeout_s=20.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        scheduler.run_cycle()
        if until(scheduler):
            return True
        time.sleep(0.05)
    return False


def deploy_complete(s):
    return s.deploy_manager.get_plan().is_complete


def replaced_since(name, old):
    def done(s):
        info = s.state_store.fetch_task(name)
        status = s.state_store.fetch_status(name)
        return (info.task_id != old.task_id and status is not None
                and status.task_id == info.task_id
                and status.state.name == "RUNNING")
    return done


def flow_deploy(pkg, tmp_path):
    sched = e2e_builder(pkg, HELLO_YAML, tmp_path).build()
    try:
        ok = drive(sched, deploy_complete)
        agents = {i.agent_id for i in sched.state_store.fetch_tasks()}
        out = os.path.join(sched.agent.sandbox_of("hello-0-server"),
                           "out.txt")
        return ok, len(agents), open(out).read().strip()
    finally:
        sched.agent.shutdown()


def flow_finish(pkg, tmp_path):
    sched = e2e_builder(pkg, ONCE_YAML, tmp_path).build()
    try:
        ok = drive(sched, deploy_complete)
        status = sched.state_store.fetch_status("job-0-run")
        sched.run_cycle()
        return ok, status.state.name, sched.recovery_manager.get_plan().phases
    finally:
        sched.agent.shutdown()


def flow_kill_recovery(pkg, tmp_path):
    sched = e2e_builder(pkg, HELLO_YAML, tmp_path).build()
    try:
        ok = drive(sched, deploy_complete)
        victim = sched.state_store.fetch_task("hello-0-server")
        sched.agent.kill(victim.task_id)
        recovered = drive(sched, replaced_since("hello-0-server", victim))
        again = sched.state_store.fetch_task("hello-0-server")
        return (ok, recovered, deploy_complete(sched),
                again.agent_id == victim.agent_id)
    finally:
        sched.agent.shutdown()


def flow_permanent_replace(pkg, tmp_path):
    builder = e2e_builder(pkg, HELLO_YAML, tmp_path)
    builder.set_failure_monitor(pkg.monitor.TestingFailureMonitor(
        permanent_tasks={"hello-0-server"}))
    sched = builder.build()
    try:
        ok = drive(sched, deploy_complete)
        victim = sched.state_store.fetch_task("hello-0-server")
        sched.agent.kill(victim.task_id)
        replaced = drive(sched, replaced_since("hello-0-server", victim))
        new = sched.state_store.fetch_task("hello-0-server")
        live = {r.reservation_id for r in sched.ledger.all()}
        return (ok, replaced,
                set(new.resource_ids) != set(victim.resource_ids),
                not (live & set(victim.resource_ids)))
    finally:
        sched.agent.shutdown()


def flow_restart(pkg, tmp_path):
    persister = pkg.wal(str(tmp_path / pkg.name / "state"), fsync=False)
    sched = e2e_builder(pkg, HELLO_YAML, tmp_path, persister).build()
    agent = sched.agent

    def first_running(s):
        status = s.state_store.fetch_status("hello-0-server")
        return status is not None and status.state.name == "RUNNING"

    try:
        first = drive(sched, first_running)
        midway = deploy_complete(sched)
        original = sched.state_store.fetch_task("hello-0-server").task_id
        restarted = e2e_builder(pkg, HELLO_YAML, tmp_path, persister,
                                agent).build()
        done = drive(restarted, deploy_complete)
        resumed = restarted.state_store.fetch_task("hello-0-server").task_id
        return first, midway, done, resumed == original
    finally:
        agent.shutdown()
        persister.close()


def flow_wal_only_launch(pkg, tmp_path):
    persister = pkg.wal(str(tmp_path / pkg.name / "state"), fsync=False)
    sched = e2e_builder(pkg, HELLO_YAML, tmp_path, persister).build()
    req = pkg.req(pod=sched.spec.pod("hello"), instances=[0])
    result = sched.evaluator.evaluate(req, sched.inventory)
    sched.ledger.commit(result.reservations)
    sched.launch_recorder.record(result.task_infos)
    ghost = result.task_infos[0].task_id
    try:
        ok = drive(sched, deploy_complete)
        info = sched.state_store.fetch_task("hello-0-server")
        return ok, info.task_id != ghost
    finally:
        sched.agent.shutdown()
        persister.close()


def flow_config_update(pkg, tmp_path):
    persister = pkg.wal(str(tmp_path / pkg.name / "state"), fsync=False)
    sched = e2e_builder(pkg, HELLO_YAML, tmp_path, persister).build()
    agent = sched.agent
    try:
        ok = drive(sched, deploy_complete)
        old = {i.name: i.task_id for i in sched.state_store.fetch_tasks()}
        updated = e2e_builder(
            pkg, HELLO_YAML.replace("echo hello-", "echo updated-"),
            tmp_path, persister, agent).build()
        plan = updated.deploy_manager.get_plan()
        before = (plan.name, plan.is_complete)
        done = drive(updated, deploy_complete)
        new = {i.name: i.task_id for i in updated.state_store.fetch_tasks()}
        out = os.path.join(agent.sandbox_of("hello-1-server"), "out.txt")
        deadline = time.monotonic() + 10
        content = ""
        while content != "updated-1" and time.monotonic() < deadline:
            try:
                content = open(out).read().strip()
            except OSError:
                content = ""
            time.sleep(0.05)
        return (ok, before, done, all(new[n] != old[n] for n in old),
                content)
    finally:
        agent.shutdown()
        persister.close()


FLOWS = {
    "deploy": (flow_deploy, (True, 2, "hello-0")),
    "finish": (flow_finish, (True, "FINISHED", [])),
    "kill-recovery": (flow_kill_recovery, (True, True, True, True)),
    "permanent-replace": (flow_permanent_replace, (True, True, True, True)),
    "restart": (flow_restart, (True, False, True, True)),
    "wal-only-launch": (flow_wal_only_launch, (True, True)),
    "config-update": (flow_config_update,
                      (True, ("update", False), True, True, "updated-1")),
}


@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_e2e_flow_over_a_local_agent_as_the_jax_builder(flow, tmp_path):
    run, want = FLOWS[flow]
    assert [run(pkg, tmp_path) for pkg in PACKAGES] == [want, want]

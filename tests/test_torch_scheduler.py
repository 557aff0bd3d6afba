"""The port's scheduler loop (``dcos_commons_tpu_torch/scheduler``)
against the JAX package's, on the CPU.

Twin ``DefaultScheduler``s, each wired from its own package's parts as
the JAX package's ``SchedulerBuilder`` wires them (``wire``), run over
twin ``FakeAgent``s and twin fleets (a TPU host and its GPU twin,
``gpu_fleet``), on ``FileWalPersister``s:

- every helloworld/hdfs/cassandra YAML, and the port's five YAMLs
  against frameworks/jax/'s five, deployed by ``run_cycle`` alone: the
  same launches (task names, ids, hosts) in the same cycle, the same
  kills, every plan's status after every cycle, interrupted plans
  proceeded when the loop is idle, every third launch failing once;
- the WAL: every record of both logs, in order, the same path and the
  same bytes, but for the values that carry a designed difference
  (``designed``: the pod block's name ``gpu``, the card env, the card
  ids and the port's commands), which are equal once those are mapped;
- the operator verbs: ``restart_pod``, ``pause_pod``/``resume_pod``,
  ``scale_pod``, a host preemption, and a failover: the persister
  abandoned mid-deploy (no ``close``), a successor wired over the same
  WAL directory and the surviving agent resumes to the same plan
  states; a port scheduler also resumes from a WAL the JAX scheduler
  wrote, as a JAX successor does.

Task, reservation, config and element ids are uuid4s and a status's
time is the clock's: each package draws them from its own pinned
sequence (``pinned``) and a clock that moves one second a cycle, so
they compare too."""

import json
import os
import shutil
import struct
import time
import types

import pytest

import dcos_commons_tpu.common as j_common
import dcos_commons_tpu.health.journal as j_journal
import dcos_commons_tpu.health.monitor as j_monitor_mod
import dcos_commons_tpu.offer.evaluate as j_evaluate
import dcos_commons_tpu.offer.ledger as j_ledger
import dcos_commons_tpu.plan.element as j_element
import dcos_commons_tpu.recovery.manager as j_manager
import dcos_commons_tpu.state.config_store as j_config_store
import dcos_commons_tpu.state.framework_store as j_framework_store
from dcos_commons_tpu import decommission as j_decommission
from dcos_commons_tpu import health as j_health
from dcos_commons_tpu import offer as j_offer
from dcos_commons_tpu import plan as j_plan
from dcos_commons_tpu import recovery as j_recovery
from dcos_commons_tpu import state as j_state
from dcos_commons_tpu.scheduler.scheduler import DefaultScheduler as JSched
from dcos_commons_tpu.specification import yaml_spec as j_yaml
from dcos_commons_tpu.storage import FileWalPersister as JWal
from dcos_commons_tpu.testing.fake_agent import FakeAgent as JFakeAgent
from dcos_commons_tpu.tools import options as j_options
import dcos_commons_tpu_torch.common as t_common
import dcos_commons_tpu_torch.health.journal as t_journal
import dcos_commons_tpu_torch.health.monitor as t_monitor_mod
import dcos_commons_tpu_torch.offer.evaluate as t_evaluate
import dcos_commons_tpu_torch.offer.ledger as t_ledger
import dcos_commons_tpu_torch.plan.element as t_element
import dcos_commons_tpu_torch.recovery.manager as t_manager
import dcos_commons_tpu_torch.state.config_store as t_config_store
import dcos_commons_tpu_torch.state.framework_store as t_framework_store
from dcos_commons_tpu_torch import decommission as t_decommission
from dcos_commons_tpu_torch import health as t_health
from dcos_commons_tpu_torch import offer as t_offer
from dcos_commons_tpu_torch import plan as t_plan
from dcos_commons_tpu_torch import recovery as t_recovery
from dcos_commons_tpu_torch import state as t_state
from dcos_commons_tpu_torch.scheduler import DefaultScheduler as TSched
from dcos_commons_tpu_torch.specification import yaml_spec as t_yaml
from dcos_commons_tpu_torch.storage import FileWalPersister as TWal
from dcos_commons_tpu_torch.testing import FakeAgent as TFakeAgent
from dcos_commons_tpu_torch.tools import options as t_options
from dcos_commons_tpu.offer.inventory import TpuHost, make_test_fleet
from test_torch_offer import gpu_fleet, gpu_yaml
from test_torch_plan import PinnedUuid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE_YAMLS = sorted(
    os.path.join(name, f)
    for name in ("helloworld", "hdfs", "cassandra")
    for f in os.listdir(os.path.join(REPO, "frameworks", name))
    if f.endswith(".yml")
)
# each port YAML's fleet: a host grid where the torus and the node set
# agree (test_torch_offer's), with room for a second instance of a pod
PORT_YAMLS = {
    "svc.yml": dict(host_grid=(2, 2), chip_block=(2, 2)),
    "svc_mnist.yml": dict(host_grid=(3, 1), chip_block=(2, 2)),
    "svc_serve.yml": dict(host_grid=(3, 1), chip_block=(2, 2)),
    "svc_serve_gang.yml": dict(host_grid=(1, 2), chip_block=(1, 1)),
    "svc_router.yml": dict(host_grid=(3, 1), chip_block=(2, 2)),
}

JAX = types.SimpleNamespace(
    name="jax", common=j_common, plan=j_plan, state=j_state,
    offer=j_offer, recovery=j_recovery, decommission=j_decommission,
    health=j_health,
    sched=JSched, wal=JWal, agent=JFakeAgent, yaml=j_yaml,
    options=j_options, fix=lambda text: text, fleet=lambda hosts: hosts,
    frameworks=os.path.join(REPO, "frameworks", "jax"),
    uuid_modules=(j_common, j_ledger, j_evaluate, j_element,
                  j_framework_store),
    clock_modules=(j_common, j_journal, j_monitor_mod, j_manager),
    config_store=j_config_store,
)
PORT = types.SimpleNamespace(
    name="port", common=t_common, plan=t_plan, state=t_state,
    offer=t_offer, recovery=t_recovery, decommission=t_decommission,
    health=t_health,
    sched=TSched, wal=TWal, agent=TFakeAgent, yaml=t_yaml,
    options=t_options, fix=gpu_yaml, fleet=gpu_fleet,
    frameworks=os.path.join(REPO, "dcos_commons_tpu_torch", "frameworks"),
    uuid_modules=(t_common, t_ledger, t_evaluate, t_element,
                  t_framework_store),
    clock_modules=(t_common, t_journal, t_monitor_mod, t_manager),
    config_store=t_config_store,
)
PACKAGES = (JAX, PORT)


class Clock:
    """``time`` for the modules whose clock reaches the store: wall
    time is ``t`` (moved by the driver), all else the real module."""

    def __init__(self, t=1_700_000_000.0):
        self.t = t

    def time(self):
        return self.t

    def __getattr__(self, name):
        return getattr(time, name)


def pin_ids(monkeypatch, start=1):
    """Each package's uuid4s from a counter of its own, from ``start``."""
    for pkg in PACKAGES:
        ids = PinnedUuid(start)
        for module in pkg.uuid_modules:
            monkeypatch.setattr(module, "uuid", ids)
        monkeypatch.setattr(pkg.config_store, "uuid_mod", ids)


@pytest.fixture
def pinned(monkeypatch):
    """Each package's ids from its own counter and its store-visible
    wall time from its own clock; returns the clocks."""
    pin_ids(monkeypatch)
    clocks = {}
    for pkg in PACKAGES:
        clocks[pkg.name] = Clock()
        for module in pkg.clock_modules:
            monkeypatch.setattr(module, "time", clocks[pkg.name])
    return clocks


def render(pkg, path):
    schema = pkg.options.load_schema(os.path.dirname(path))
    env = pkg.options.render_options(schema, {}) if schema else {}
    return pkg.yaml.from_yaml_file(path, env)


def wire(pkg, spec, persister, hosts, agent, **extra):
    """A ``DefaultScheduler`` from its parts, as the JAX package's
    ``SchedulerBuilder.build`` wires them with its default config
    (plans from the YAML or the default factory, every other YAML plan
    interrupted, a decommission plan for stored surplus instances,
    recovery deferring to the deploy plan).  A store that already names
    a target config keeps it: the successor of a failover resumes that
    target.  ``extra`` goes to ``DefaultScheduler`` (a health monitor,
    an action policy)."""
    state = pkg.state
    state.SchemaVersionStore(persister).check()
    store = state.StateStore(persister)
    configs = state.ConfigStore(persister)
    target = configs.get_target_config()
    if target is None:
        target = configs.store(spec.to_dict())
        configs.set_target_config(target)
    generator = pkg.plan.PlanGenerator()
    raw = spec.plans or {}
    done = store.deployment_was_completed()
    name = "update" if done else "deploy"
    if done and raw.get("update"):
        deploy = generator.generate(spec, name, raw["update"], store, target)
    elif raw.get("deploy"):
        deploy = generator.generate(spec, name, raw["deploy"], store, target)
    else:
        deploy = pkg.plan.DeployPlanFactory().build(spec, store, target,
                                                    name)

    def externally_managed(asset):
        return any(asset in s.get_asset_names() and not s.is_complete
                   for s in deploy.all_steps())

    recovery = pkg.recovery.DefaultRecoveryPlanManager(
        spec, store, failure_monitor=pkg.recovery.NeverFailureMonitor(),
        externally_managed=externally_managed)
    inventory = pkg.offer.SliceInventory(hosts)
    recovery.inventory = inventory
    others = []
    for plan_name, raw_plan in raw.items():
        if plan_name in ("deploy", "update") or not raw_plan:
            continue
        custom = generator.generate(spec, plan_name, raw_plan, store, target)
        custom.interrupt()
        others.append(pkg.plan.DefaultPlanManager(custom))
    decommission = pkg.decommission.DecommissionPlanFactory().build(spec,
                                                                    store)
    if decommission.phases:
        others.append(pkg.plan.DefaultPlanManager(decommission))
    ledger = pkg.offer.ReservationLedger(persister)
    return pkg.sched(
        spec=spec, state_store=store, ledger=ledger, inventory=inventory,
        agent=agent,
        evaluator=pkg.offer.OfferEvaluator(store, ledger, spec.name, target),
        deploy_manager=pkg.plan.DefaultPlanManager(deploy),
        recovery_manager=recovery, other_managers=others,
        config_store=configs, framework_store=state.FrameworkStore(persister),
        **extra,
    )


# -- the twin run -------------------------------------------------------


class Twin:
    """One package's scheduler over its fake agent, fleet and WAL."""

    def __init__(self, pkg, spec, hosts, directory, clock, agent=None,
                 **extra):
        self.pkg = pkg
        self.spec = spec
        self.hosts = pkg.fleet(hosts)
        self.directory = directory
        self.clock = clock
        self.agent = agent or pkg.agent()
        self.persister = pkg.wal(directory, fsync=False,
                                 compact_every=1 << 30)
        self.sched = wire(pkg, spec, self.persister, self.hosts, self.agent,
                          **extra)
        # the action engine's clock (its cooldowns, drain graces and
        # the ``t`` of its journal events) is the twin's too
        self.sched.actions._clock = clock.time
        self.seen = len(self.agent.launched)
        self.kills = len(self.agent.kills)
        self.n = 0
        self.fail = {}

    def statuses(self):
        return sorted((name, plan.get_status().name)
                      for name, plan in self.sched.plans().items())

    def send(self, info, state, ready=False):
        common = self.pkg.common
        self.agent.send(common.TaskStatus(
            task_id=info.task_id, state=common.TaskState[state],
            agent_id=info.agent_id, ready=ready))

    def goal(self, info):
        pod = self.sched.spec.pod(info.pod_type)
        return next(t.goal.name for t in pod.tasks
                    if f"{pod.type}-{info.pod_index}-{t.name}" == info.name)

    def cycle(self, fail_every=3):
        """One ``run_cycle`` a second of the clock, then the agent's part:
        each new launch goes STARTING and RUNNING (ready), a FINISH/ONCE
        goal then FINISHED; every ``fail_every``-th launch goes FAILED
        instead.  Returns the cycle's observation."""
        self.clock.t += 1.0
        self.sched.run_cycle()
        new = self.agent.launched[self.seen:]
        kills = self.agent.kills[self.kills:]
        self.seen, self.kills = len(self.agent.launched), len(self.agent.kills)
        for info in new:
            self.n += 1
            if fail_every and self.n % fail_every == 0:
                states = [("STARTING", False), ("FAILED", False)]
            else:
                states = [("STARTING", False), ("RUNNING", True)]
                if self.goal(info) in ("FINISH", "ONCE"):
                    states.append(("FINISHED", False))
            for state, ready in states:
                self.send(info, state, ready)
        return ("cycle", [(i.name, i.task_id, i.agent_id) for i in new],
                kills, self.statuses())

    def drive(self, cycles=60, fail_every=3, proceed=True, idle=3):
        """Cycles until the loop has had nothing to do for ``idle``
        cycles in a row and no plan is in progress; then the first
        interrupted plan or phase is
        proceeded (``proceed``, as ``POST /v1/plans/<name>/continue``),
        else the drive ends.  Returns the trace."""
        trace = []
        quiet = 0
        for _ in range(cycles):
            obs = self.cycle(fail_every)
            trace.append(obs)
            quiet = 0 if obs[1] or obs[2] else quiet + 1
            if quiet < idle or any(s == "IN_PROGRESS" for _, s in obs[3]):
                continue
            parked = [p for _, p in sorted(self.sched.plans().items())
                      if not p.is_complete]
            gates = [e for p in parked for e in (p, *p.phases)
                     if e.is_interrupted() and not e.is_complete]
            if not proceed or not gates:
                break
            gates[0].proceed()
            quiet = 0
            trace.append(("proceed", gates[0].name))
        return trace

    def close(self):
        self.persister.close()


def twins(specs, hosts, tmp_path, clocks, agents=(None, None), extra=None):
    """Both packages' ``Twin``s; ``extra(pkg)`` gives each its
    ``DefaultScheduler`` keywords."""
    return [Twin(pkg, spec, hosts, str(tmp_path / pkg.name),
                 clocks[pkg.name], agent, **(extra(pkg) if extra else {}))
            for pkg, spec, agent in zip(PACKAGES, specs, agents)]


# -- the WAL, record by record ------------------------------------------

_HEADER = struct.Struct("<II")  # (length, crc32), as file_persister.py


def wal_records(directory):
    """Every transaction of ``wal.log``, in order: [(op, path, bytes)]."""
    with open(os.path.join(directory, "wal.log"), "rb") as f:
        data = f.read()
    out, offset = [], 0
    while offset + _HEADER.size <= len(data):
        length, _crc = _HEADER.unpack_from(data, offset)
        payload = data[offset + _HEADER.size:offset + _HEADER.size + length]
        offset += _HEADER.size + length
        out.append([(e["op"], e["path"], bytes.fromhex(e.get("value", "")))
                    for e in json.loads(payload)])
    assert offset == len(data)
    return out


CARD_ENV = ("CUDA_VISIBLE_DEVICES", "TPU_CHIPS_PER_HOST_BOUNDS")


def designed(value, port):
    """A stored value with the designed differences mapped out: the pod
    block ``tpu``/``gpu`` named ``accelerator``, its generation dropped,
    the card env keys dropped, card and chip ids by their count, and the
    port's commands made the JAX package's."""
    if isinstance(value, dict):
        out = {}
        for k, v in value.items():
            if k in CARD_ENV or k == "TPU_GENERATION":
                continue
            if k in ("tpu", "gpu"):
                k = "accelerator"
                if isinstance(v, dict):
                    v = {a: b for a, b in v.items() if a != "generation"}
            if k in ("tpu_chip_ids", "chip_ids") and isinstance(v, list):
                v = len(v)
            if k == "TPU_CHIP_IDS" and isinstance(v, str):
                v = len(v.split(";")) if v else 0
            out[k] = designed(v, port)
        return out
    if isinstance(value, list):
        return [designed(v, port) for v in value]
    if isinstance(value, str) and port:
        return value.replace("dcos_commons_tpu_torch/frameworks",
                             "frameworks/jax").replace(
            "dcos_commons_tpu_torch.parallel", "dcos_commons_tpu.parallel")
    return value


def compare_wals(jdir, tdir):
    """The two WALs, record by record: the same paths in the same order;
    a value equal byte for byte, else equal once ``designed`` maps both.
    Returns (values equal byte for byte, values equal by design)."""
    jwal, twal = wal_records(jdir), wal_records(tdir)
    assert len(jwal) == len(twal)
    raw = mapped = 0
    for jtx, ttx in zip(jwal, twal):
        assert [(op, path) for op, path, _ in jtx] == [
            (op, path) for op, path, _ in ttx]
        for (_, path, jv), (_, _, tv) in zip(jtx, ttx):
            if jv == tv:
                raw += 1
                continue
            jd = designed(json.loads(jv), port=False)
            td = designed(json.loads(tv), port=True)
            assert td == jd, path
            mapped += 1
    return raw, mapped


def twin_run(specs, hosts, tmp_path, clocks, cycles=60):
    sides = twins(specs, hosts, tmp_path, clocks)
    traces = [side.drive(cycles) for side in sides]
    for side in sides:
        side.close()
    assert traces[1] == traces[0]
    raw, mapped = compare_wals(sides[0].directory, sides[1].directory)
    return sides, traces[0], raw, mapped


def cpu_fleet():
    """Six CPU hosts over three zones, one reserved for a role."""
    hosts = [TpuHost(host_id=f"h{i}", zone=f"zone-{i % 3}", cpus=16.0,
                     memory_mb=65536) for i in range(5)]
    hosts.append(TpuHost(host_id="res-0", zone="zone-0",
                         attributes={"reserved_role": "dedicated"}))
    return hosts


def _both(path_of):
    specs, errors = [], []
    for pkg in PACKAGES:
        try:
            specs.append(render(pkg, path_of(pkg)))
            errors.append(None)
        except Exception as e:  # noqa: BLE001 — compared across packages
            specs.append(None)
            errors.append(type(e).__name__)
    assert errors[0] == errors[1]
    return specs


@pytest.mark.parametrize("rel", REFERENCE_YAMLS)
def test_reference_yamls_deploy_as_the_jax_scheduler(rel, pinned, tmp_path):
    specs = _both(lambda pkg: os.path.join(REPO, "frameworks", rel))
    if specs[0] is None:
        return  # both refuse the YAML (test_torch_spec holds why)
    _, trace, raw, mapped = twin_run(specs, cpu_fleet(), tmp_path, pinned)
    assert raw > 0


@pytest.mark.parametrize("name", sorted(PORT_YAMLS))
def test_port_yamls_deploy_as_the_jax_ones(name, pinned, tmp_path):
    specs = _both(lambda pkg: os.path.join(pkg.frameworks, name))
    _, trace, raw, mapped = twin_run(
        specs, make_test_fleet(**PORT_YAMLS[name]), tmp_path, pinned)
    launched = [n for obs in trace if obs[0] == "cycle" for n, *_ in obs[1]]
    assert launched and mapped > 0


# -- operator verbs -----------------------------------------------------


def _render_with(pkg, path, **env):
    schema = pkg.options.load_schema(os.path.dirname(path))
    rendered = pkg.options.render_options(schema, {}) if schema else {}
    rendered.update(env)
    return pkg.yaml.from_yaml_file(path, rendered)


def hello_specs():
    path = os.path.join(REPO, "frameworks", "helloworld", "svc.yml")
    return [_render_with(pkg, path, HELLO_COUNT="2", WORLD_COUNT="2")
            for pkg in PACKAGES]


def _host_of(side, task):
    return side.sched.state_store.fetch_task(task).agent_id


VERBS = {
    "restart": [lambda s: s.sched.restart_pod("hello", 0)],
    "replace": [lambda s: s.sched.restart_pod("hello", 1, replace=True)],
    "pause-resume": [lambda s: s.sched.pause_pod("hello", 0),
                     lambda s: s.sched.resume_pod("hello", 0)],
    "scale-out-in": [lambda s: s.sched.scale_pod("hello", 3) is not None,
                     lambda s: s.sched.scale_pod("hello", 2) is not None],
    "preempt": [lambda s: s.sched.preempt_host(_host_of(s, "world-0-server"))],
    "drain-up": [lambda s: s.sched.drain_host(_host_of(s, "hello-0-server")),
                 lambda s: s.sched.restart_pod("hello", 0),
                 lambda s: s.sched.undrain_host(
                     _host_of(s, "hello-0-server"))],
}


@pytest.mark.parametrize("verb", sorted(VERBS))
def test_operator_verbs_act_as_the_jax_scheduler(verb, pinned, tmp_path):
    """helloworld's svc.yml at two hellos and two worlds, deployed,
    then the verbs one after another, each followed by cycles until
    the loop is idle: the same launches, kills, returns and plan
    statuses, and the same WAL."""
    sides = twins(hello_specs(), cpu_fleet(), tmp_path, pinned)
    traces = []
    for side in sides:
        trace = side.drive(fail_every=0)
        assert side.sched.plan("deploy").is_complete
        for act in VERBS[verb]:
            trace.append(("verb", act(side)))
            trace += side.drive(fail_every=0)
        trace.append(("journal", [
            (e["kind"], e.get("verb"), e.get("step"))
            for e in side.sched.journal.events()]))
        traces.append(trace)
        side.close()
    assert traces[1] == traces[0]
    assert any(obs[0] == "cycle" and obs[2] for obs in traces[0]), \
        "the verb killed nothing"
    compare_wals(sides[0].directory, sides[1].directory)


# the tasks of the port's svc.yml trainer (one card, 1x1) that a
# restart_pod relaunches once its collectives sidecar has finished:
# a gang pod relaunches all of its tasks.  chip_smoke.py phase 20 holds
# the scheduler on the card to the same set.
TRAINER_RELAUNCH = ("trainer-0-collective-bench", "trainer-0-worker")


def trainer_specs():
    return [_render_with(pkg, os.path.join(pkg.frameworks, "svc.yml"),
                         TRAINER_COUNT="1", TPU_CHIPS_PER_HOST="1",
                         TPU_TOPOLOGY="1x1", TRAIN_STEPS="2")
            for pkg in PACKAGES]


def test_trainer_restart_relaunches_what_the_jax_scheduler_relaunches(
        pinned, tmp_path):
    """Phase 20's scheduler run over fake agents: the one-card trainer
    deployed, its collectives plan proceeded and finished, then
    ``restart_pod("trainer", 0)``: both packages kill and relaunch the
    same tasks, on the same host and without a new reservation."""
    fleet = make_test_fleet(host_grid=(1, 1), chip_block=(1, 1))
    sides = twins(trainer_specs(), fleet, tmp_path, pinned)
    out = []
    for side in sides:
        trace = side.drive(fail_every=0, proceed=False)
        assert side.sched.plan("deploy").is_complete
        side.sched.plan("collectives").proceed()
        trace += side.drive(fail_every=0, proceed=False)
        assert side.sched.plan("collectives").is_complete
        reserved = {r.reservation_id: r.chip_ids
                    for r in side.sched.ledger.all()}
        before = len(side.agent.launched)
        trace.append(("verb", side.sched.restart_pod("trainer", 0)))
        trace += side.drive(fail_every=0, proceed=False)
        relaunched = side.agent.launched[before:]
        after = {r.reservation_id: r.chip_ids
                 for r in side.sched.ledger.all()}
        # no new reservation; the card's reservation is the same one
        assert after.items() <= reserved.items()
        assert {k: v for k, v in after.items() if v} == {
            k: v for k, v in reserved.items() if v}
        assert {i.agent_id for i in relaunched} == {fleet[0].host_id}
        if side.pkg is PORT:
            # the chip-less sidecar relaunched with its card holder
            # sees the instance's card, as it did at its first launch
            assert {i.name: i.env["CUDA_VISIBLE_DEVICES"]
                    for i in relaunched} == dict.fromkeys(
                TRAINER_RELAUNCH, "0")
        out.append((trace, tuple(sorted(i.name for i in relaunched))))
        side.close()
    assert out[1] == out[0]
    assert out[0][1] == TRAINER_RELAUNCH
    compare_wals(sides[0].directory, sides[1].directory)


# -- failover -----------------------------------------------------------


def hdfs_specs():
    path = os.path.join(REPO, "frameworks", "hdfs", "svc.yml")
    return [render(pkg, path) for pkg in PACKAGES]


def test_failover_mid_deploy_resumes_as_the_jax_scheduler(pinned, tmp_path):
    """hdfs deployed for three cycles, the persister abandoned (no
    ``close``: a kill -9), then a successor over the same WAL directory
    and the agent that outlived it: both packages' successors adopt,
    reissue and resume to the same plan states."""
    sides = twins(hdfs_specs(), cpu_fleet(), tmp_path, pinned)
    traces = []
    for side in sides:
        trace = [side.cycle(fail_every=0) for _ in range(3)]
        successor = Twin(side.pkg, side.spec, cpu_fleet(), side.directory,
                         side.clock, side.agent)
        successor.seen, successor.kills = side.seen, side.kills
        trace += successor.drive(fail_every=0)
        trace.append(("rehydrated", successor.sched.last_rehydration))
        traces.append(trace)
        successor.close()
    assert traces[1] == traces[0]
    assert traces[0][-1][1]["adopted"] > 0
    assert any(obs[0] == "cycle" and obs[1] for obs in traces[0][3:])
    compare_wals(sides[0].directory, sides[1].directory)


def _port_agent(jagent):
    """The port's FakeAgent holding what the JAX agent holds: its
    launch history, its live tasks and its undelivered statuses."""
    agent = TFakeAgent()
    convert = t_common.TaskInfo.from_dict
    agent.launched = [convert(i.to_dict()) for i in jagent.launched]
    agent._active = {k: convert(i.to_dict())
                     for k, i in jagent._active.items()}
    agent._queue = [t_common.TaskStatus.from_dict(s.to_dict())
                    for s in jagent._queue]
    agent.kills = list(jagent.kills)
    return agent


def test_port_scheduler_resumes_a_wal_the_jax_scheduler_wrote(
        pinned, tmp_path, monkeypatch):
    """The JAX scheduler deploys hdfs for three cycles and dies; one JAX
    and one port successor each resume a copy of its WAL directory with
    the agent that outlived it: the same cycles from there on."""
    jspec, tspec = hdfs_specs()
    first = Twin(JAX, jspec, cpu_fleet(), str(tmp_path / "writer"),
                 pinned["jax"])
    for _ in range(3):
        first.cycle(fail_every=0)
    # the successors draw the same ids, past every id the writer drew
    handoff = int(j_common.new_task_id("x").split("__")[1], 16) + 1
    traces = []
    for pkg, spec, agent in ((JAX, jspec, first.agent),
                             (PORT, tspec, _port_agent(first.agent))):
        directory = str(tmp_path / pkg.name)
        shutil.copytree(first.directory, directory)
        pin_ids(monkeypatch, handoff)
        pinned[pkg.name].t = pinned["jax"].t
        successor = Twin(pkg, spec, cpu_fleet(), directory, pinned[pkg.name],
                         agent)
        successor.seen, successor.kills = first.seen, first.kills
        trace = successor.drive(fail_every=0)
        trace.append(("rehydrated", successor.sched.last_rehydration))
        traces.append(trace)
        successor.close()
    assert traces[1] == traces[0]
    assert traces[0][-1][1]["adopted"] > 0
    assert any(obs[0] == "cycle" and obs[1] for obs in traces[0])

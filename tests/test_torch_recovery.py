"""The port's recovery, elastic re-slicing and decommission
(``dcos_commons_tpu_torch/recovery``, ``decommission``) against the JAX
package's, on the CPU.

Twin ``DefaultRecoveryPlanManager``s over twin state stores (and, where
a case needs one, twin fleets: each TPU host's GPU twin, as
tests/test_torch_offer.py builds them) are fed the same task statuses;
the recovery plan's phases, step names, step statuses, requirements
(instances, tasks, ``RecoveryType``) and ``serialize_plan`` are held
exactly equal, case by case: TRANSIENT and PERMANENT
(``TestingFailureMonitor``), a RUNNING-goal task that FINISHED (the
trainer the card's plan phase relaunches), essential scoping, the
replace-delay, gang recovery with its kill/unreserve/replace/trim
choreography run against a stub scheduler, an elastic shrink,
deferral to an externally managed pod, and an overrider.  The elastic
decision rule, ``shrink_topology`` and ``shrunken_pod`` are hypothesis
properties against the reference, ``_regrow_capacity`` one over twin
fleets with hosts down, and the decommission plan of surplus instances
is built and run on both."""

import dataclasses
import os
import types

import pytest

from dcos_commons_tpu import common as j_common
from dcos_commons_tpu.debug import trackers as j_trackers
from dcos_commons_tpu.decommission import factory as j_decommission
from dcos_commons_tpu.offer import inventory as j_inventory
from dcos_commons_tpu.offer import ledger as j_ledger
from dcos_commons_tpu.plan import phase as j_phase
from dcos_commons_tpu.plan import step as j_step
from dcos_commons_tpu.plan import strategy as j_strategy
from dcos_commons_tpu.recovery import elastic as j_elastic
from dcos_commons_tpu.recovery import manager as j_manager
from dcos_commons_tpu.recovery import monitor as j_monitor
from dcos_commons_tpu.specification import specs as j_specs
from dcos_commons_tpu.specification import yaml_spec as j_yaml
from dcos_commons_tpu.state import state_store as j_state
from dcos_commons_tpu.storage import MemPersister as JMemPersister
from dcos_commons_tpu.tools import options as j_options
from dcos_commons_tpu_torch import common as t_common
from dcos_commons_tpu_torch.debug import trackers as t_trackers
from dcos_commons_tpu_torch.decommission import factory as t_decommission
from dcos_commons_tpu_torch.offer import inventory as t_inventory
from dcos_commons_tpu_torch.offer import ledger as t_ledger
from dcos_commons_tpu_torch.plan import phase as t_phase
from dcos_commons_tpu_torch.plan import step as t_step
from dcos_commons_tpu_torch.plan import strategy as t_strategy
from dcos_commons_tpu_torch.recovery import elastic as t_elastic
from dcos_commons_tpu_torch.recovery import manager as t_manager
from dcos_commons_tpu_torch.recovery import monitor as t_monitor
from dcos_commons_tpu_torch.specification import specs as t_specs
from dcos_commons_tpu_torch.specification import yaml_spec as t_yaml
from dcos_commons_tpu_torch.state import state_store as t_state
from dcos_commons_tpu_torch.storage import MemPersister as TMemPersister
from dcos_commons_tpu_torch.tools import options as t_options
from test_torch_offer import gpu_fleet, gpu_yaml
from test_torch_plan import pinned_ids  # noqa: F401 — a fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX = types.SimpleNamespace(
    common=j_common, specs=j_specs, yaml=j_yaml,
    options=j_options, state=j_state, persister=JMemPersister,
    manager=j_manager, monitor=j_monitor, elastic=j_elastic,
    decommission=j_decommission, trackers=j_trackers,
    inventory=j_inventory, ledger=j_ledger, step=j_step, phase=j_phase,
    strategy=j_strategy, fix=lambda text: text, fleet=lambda hosts: hosts,
    block="tpu", frameworks=os.path.join(REPO, "frameworks", "jax"),
)
PORT = types.SimpleNamespace(
    common=t_common, specs=t_specs, yaml=t_yaml,
    options=t_options, state=t_state, persister=TMemPersister,
    manager=t_manager, monitor=t_monitor, elastic=t_elastic,
    decommission=t_decommission, trackers=t_trackers,
    inventory=t_inventory, ledger=t_ledger, step=t_step, phase=t_phase,
    strategy=t_strategy, fix=gpu_yaml, fleet=gpu_fleet, block="gpu",
    frameworks=os.path.join(REPO, "dcos_commons_tpu_torch", "frameworks"),
)
PACKAGES = (JAX, PORT)

MIXED_YAML = """
name: mixed
pods:
  app:
    count: 2
    tasks:
      server: {goal: RUNNING, cmd: "serve", cpus: 0.2, memory: 64}
      metrics: {goal: RUNNING, cmd: "scrape", cpus: 0.1, memory: 32, essential: false}
      init: {goal: FINISH, cmd: "setup", cpus: 0.1, memory: 32}
"""

DELAY_YAML = """
name: delayed
replacement-failure-policy:
  permanent-failure-timeout-secs: 0
  min-replace-delay-secs: 3600
pods:
  app:
    count: 1
    tasks:
      main: {goal: RUNNING, cmd: "serve", cpus: 0.1, memory: 32}
"""

GANG_YAML = """
name: jax
pods:
  trainer:
    count: 4
    gang: true
    tpu:
      generation: v5e
      chips-per-host: 4
      topology: 4x4
      elastic: true
      min-hosts: 1
    tasks:
      worker: {goal: RUNNING, cmd: "python train.py", cpus: 2.0, memory: 4096}
"""

MULTISLICE_YAML = """
name: jax
pods:
  trainer:
    count: 4
    gang: true
    tpu:
      generation: v5e
      chips-per-host: 4
      topology: 2x4
      slices: 2
      elastic: true
      min-hosts: 2
    tasks:
      worker: {goal: RUNNING, cmd: "python train.py", cpus: 2.0, memory: 4096}
"""


def spec_of(pkg, text):
    return pkg.yaml.from_yaml(pkg.fix(text))


def trainer_spec(pkg):
    """The svc.yml trainer at one card, as the card's plan phase renders
    it (frameworks/jax/svc.yml on the JAX side)."""
    schema = pkg.options.load_schema(pkg.frameworks)
    env = pkg.options.render_options(schema, {})
    env.update(TRAINER_COUNT="1", TPU_CHIPS_PER_HOST="1", TPU_TOPOLOGY="1x1",
               TRAIN_STEPS="2")
    return pkg.yaml.from_yaml_file(os.path.join(pkg.frameworks, "svc.yml"),
                                   env)


class StubScheduler:
    """What an ``ActionStep`` reads of its scheduler: the stores, the
    ledger, the agent's live task ids, a task killer and metrics."""

    def __init__(self, store, ledger, active=()):
        self.state_store = store
        self.ledger = ledger
        self.journal = None
        self.active = set(active)
        self.kills = []
        self.counts = {}
        self.agent = types.SimpleNamespace(
            active_task_ids=lambda: set(self.active))
        self.task_killer = types.SimpleNamespace(kill=self._kill)
        self.metrics = types.SimpleNamespace(incr=self._incr)

    def _kill(self, task_id, grace=0.0):
        self.kills.append((task_id, grace))

    def _incr(self, name, n=1):
        self.counts[name] = self.counts.get(name, 0) + n


class RSide:
    """One package's recovery manager over its own state store and
    ledger, every pod instance deployed and healthy."""

    def __init__(self, pkg, spec, permanent=(), hosts=None,
                 externally_managed=None, overriders=None):
        self.pkg = pkg
        self.spec = spec
        persister = pkg.persister()
        self.store = pkg.state.StateStore(persister)
        self.ledger = pkg.ledger.ReservationLedger(persister)
        self.generation = 0
        self.manager = pkg.manager.DefaultRecoveryPlanManager(
            spec, self.store,
            failure_monitor=pkg.monitor.TestingFailureMonitor(permanent),
            externally_managed=externally_managed, overriders=overriders)
        if hosts is not None:
            self.manager.inventory = pkg.inventory.SliceInventory(
                pkg.fleet(hosts))

    def task_id(self, full):
        return f"{full}__{self.generation:032x}"

    def deploy(self, instances=None, tasks=None):
        """TaskInfos, reservations and healthy statuses for the pods'
        instances (``instances``: pod type -> indices; default all)."""
        common = self.pkg.common
        infos, reservations = [], []
        for pod in self.spec.pods:
            indices = (instances or {}).get(pod.type, range(pod.count))
            for index in indices:
                for task in pod.tasks:
                    if tasks is not None and task.name not in tasks:
                        continue
                    full = f"{pod.type}-{index}-{task.name}"
                    infos.append(common.TaskInfo(
                        name=full, task_id=self.task_id(full),
                        agent_id=f"host-{index}", pod_type=pod.type,
                        pod_index=index,
                        labels={common.Label.TARGET_CONFIG: "cfg-1"}))
                    reservations.append(self.pkg.ledger.Reservation(
                        reservation_id=f"r-{full}", host_id=f"host-{index}",
                        task_name=full, cpus=task.resources.cpus))
        self.store.store_tasks(infos)
        self.ledger.commit(reservations)
        for info in infos:
            goal = self.goal(info.name)
            self.feed(info.name, "FINISHED" if goal in ("FINISH", "ONCE")
                      else "RUNNING")

    def goal(self, full):
        for pod in self.spec.pods:
            for task in pod.tasks:
                if full.startswith(f"{pod.type}-") and \
                        full.endswith(f"-{task.name}"):
                    return task.goal.name
        raise KeyError(full)

    def feed(self, full, state):
        common = self.pkg.common
        info = self.store.fetch_task(full)
        status = common.TaskStatus(task_id=info.task_id,
                                   state=common.TaskState[state],
                                   ready=state == "RUNNING", timestamp=1.0)
        self.store.store_status(full, status)
        self.manager.update(status)

    def observe(self):
        candidates = self.manager.get_candidates(set())
        plan = self.manager.get_plan()
        steps = []
        for phase in plan.phases:
            for step in phase.steps:
                req = getattr(step, "requirement", None)
                steps.append((phase.name, step.name, step.get_status().name,
                              type(step).__name__) + ((
                                  req.pod.count, sorted(req.instances),
                                  sorted(req.tasks_to_launch),
                                  req.recovery_type.name)
                              if req is not None else ()))
        return (sorted(s.name for s in candidates), steps,
                self.pkg.trackers.serialize_plan(plan))


def recovery_steps(observation):
    """(step name, recovery type) of each step that launches tasks."""
    return [(s[1], s[-1]) for s in observation[1] if len(s) > 4]


def twin(text_or_spec, events, **kw):
    """The same deploy and status ``events`` ((task, state) or
    "observe") on both packages; returns each side's observations."""
    out = []
    for pkg in PACKAGES:
        spec = text_or_spec(pkg) if callable(text_or_spec) else spec_of(
            pkg, text_or_spec)
        side = RSide(pkg, spec, **kw)
        side.deploy()
        seen = [side.observe()]
        for event in events:
            if event == "observe":
                seen.append(side.observe())
            else:
                side.feed(*event)
        seen.append(side.observe())
        out.append(seen)
    assert out[0] == out[1]
    return out[1]


def test_transient_relaunch_of_a_failed_task(pinned_ids):
    seen = twin(MIXED_YAML, [("app-1-server", "FAILED")])
    assert seen[0][1] == []
    assert recovery_steps(seen[-1]) == [("recover-app-1", "TRANSIENT")]
    # the essential task relaunches the instance's launched RUNNING-goal
    # tasks, not its finished init
    assert seen[-1][1][0][6] == ["metrics", "server"]


def test_permanent_when_the_monitor_says_so(pinned_ids):
    seen = twin(MIXED_YAML, [("app-0-server", "LOST")],
                permanent=["app-0-server"])
    assert recovery_steps(seen[-1]) == [("recover-app-0", "PERMANENT")]
    # a PERMANENT replace takes the whole launched pod
    assert seen[-1][1][0][6] == ["init", "metrics", "server"]


def test_running_goal_task_that_finished_is_relaunched(pinned_ids):
    """The card's plan phase: the trainer (goal RUNNING) exits 0 after
    its steps, and the reference proposes a TRANSIENT relaunch of
    trainer-0."""
    seen = twin(trainer_spec, [("trainer-0-worker", "FINISHED")])
    assert recovery_steps(seen[-1]) == [("recover-trainer-0", "TRANSIENT")]
    phase, step, status, kind, count, instances, tasks, rtype = \
        seen[-1][1][0]
    assert (phase, status, kind, count, instances, tasks) == (
        "recover-trainer-0", "PENDING", "DeploymentStep", 1, [0],
        ["collective-bench", "worker"])
    assert seen[-1][0] == ["recover-trainer-0"]


def test_finish_goal_task_that_finished_is_left_alone(pinned_ids):
    seen = twin(MIXED_YAML, [("app-0-init", "FINISHED"), "observe",
                             ("app-1-init", "FINISHED")])
    assert all(o[1] == [] for o in seen)


def test_nonessential_failure_recovers_alone(pinned_ids):
    seen = twin(MIXED_YAML, [("app-0-metrics", "FAILED")])
    assert recovery_steps(seen[-1]) == [("recover-app-0", "TRANSIENT")]
    assert seen[-1][1][0][6] == ["metrics"]


def test_essential_failure_widens_an_inflight_subset_phase(pinned_ids):
    seen = twin(MIXED_YAML, [("app-0-metrics", "FAILED"), "observe",
                             ("app-0-server", "KILLED")])
    assert seen[1][1][0][6] == ["metrics"]
    assert seen[-1][1][0][6] == ["metrics", "server"]


def test_replace_delay_holds_the_second_permanent_back(pinned_ids):
    out = []
    for pkg in PACKAGES:
        side = RSide(pkg, spec_of(pkg, DELAY_YAML), permanent=["app-0-main"])
        side.deploy()
        side.feed("app-0-main", "FAILED")
        first = side.observe()
        # the replace launches and runs (the step completes and is
        # pruned), then the new incarnation fails at once
        step = side.manager.get_plan().phases[0].steps[0]
        step.start()
        side.generation += 1
        step.record_launch({"app-0-main": side.task_id("app-0-main")})
        side.deploy()
        assert step.get_status().name == "COMPLETE"
        assert side.observe()[1] == []
        side.feed("app-0-main", "FAILED")
        out.append((first, side.observe()))
    assert out[0] == out[1]
    first, second = out[1]
    assert recovery_steps(first) == [("recover-app-0", "PERMANENT")]
    assert recovery_steps(second) == [("recover-app-0", "TRANSIENT")]


def test_gang_transient_recovers_every_worker(pinned_ids):
    seen = twin(GANG_YAML, [("trainer-2-worker", "FAILED")])
    assert recovery_steps(seen[-1]) == [
        ("recover-trainer-gang", "TRANSIENT")]
    assert seen[-1][1][0][5] == [0, 1, 2, 3]


def test_gang_permanent_choreography(pinned_ids):
    """kill the survivors, unreserve the footprint, re-place the whole
    gang PERMANENT, trim: run against a stub scheduler on both sides."""
    out = []
    for pkg in PACKAGES:
        side = RSide(pkg, spec_of(pkg, GANG_YAML),
                     permanent=["trainer-1-worker"])
        side.deploy()
        side.feed("trainer-1-worker", "LOST")
        seen = [side.observe()]
        scheduler = StubScheduler(side.store, side.ledger, active=[
            side.task_id(f"trainer-{i}-worker") for i in (0, 2)])
        plan = side.manager.get_plan()
        (phase,) = plan.phases
        kill, unreserve, replace, trim = phase.steps
        kill.execute(scheduler)
        seen.append((kill.get_status().name, list(scheduler.kills)))
        scheduler.active.clear()
        kill.execute(scheduler)
        unreserve.execute(scheduler)
        seen.append((kill.get_status().name, unreserve.get_status().name,
                     sorted(r.reservation_id for r in side.ledger.all())))
        seen.append(side.observe())
        req = replace.start()
        seen.append((sorted(req.instances), req.recovery_type.name,
                     req.task_names()))
        seen.append(side.observe())
        out.append(seen)
    assert out[0] == out[1]
    seen = out[1]
    assert [s[1] for s in seen[0][1]] == [
        "kill-trainer-survivors", "unreserve-trainer-slice",
        "replace-trainer-gang", "trim-trainer-surplus"]
    assert seen[1] == ("PENDING", [(f"trainer-{i}-worker__{0:032x}", 0.0)
                                   for i in (0, 2)])
    assert seen[2] == ("COMPLETE", "COMPLETE", [])
    assert seen[4] == ([0, 1, 2, 3], "PERMANENT",
                       [f"trainer-{i}-worker" for i in range(4)])


def test_elastic_replace_step_shrinks_as_the_reference(pinned_ids):
    """Declined placements re-scope the replace step: the same widths
    and topologies (the declared shape halved largest-first), and the
    same surplus for the trim step."""
    out = []
    for pkg in PACKAGES:
        side = RSide(pkg, spec_of(pkg, GANG_YAML),
                     permanent=["trainer-0-worker"])
        side.deploy()
        side.feed("trainer-0-worker", "FAILED")
        side.observe()
        replace = side.manager.get_plan().phases[0].steps[2]
        widths = []
        for _ in range(12):
            replace.update_offer_status(False)
            pod = replace.requirement.pod
            block = getattr(pod, pkg.block)
            widths.append((pod.count, block.topology,
                           replace.surplus_instances()))
        out.append(widths)
    assert out[0] == out[1]
    assert (4, "4x4", []) in out[1] and (1, "2x2", [1, 2, 3]) in out[1]


def test_recovery_defers_to_an_externally_managed_pod(pinned_ids):
    managed = {"on": True}
    seen = twin(MIXED_YAML, [("app-0-server", "FAILED"), "observe"],
                externally_managed=lambda name: managed["on"]
                and name == "app-0")
    assert all(o[1] == [] for o in seen)
    out = []
    for pkg in PACKAGES:
        managed["on"] = True
        side = RSide(pkg, spec_of(pkg, MIXED_YAML),
                     externally_managed=lambda name: managed["on"]
                     and name == "app-0")
        side.deploy()
        side.feed("app-0-server", "FAILED")
        side.feed("app-1-server", "FAILED")
        first = side.observe()
        managed["on"] = False
        out.append((first, side.observe()))
    assert out[0] == out[1]
    assert [s[1] for s in out[1][0][1]] == ["recover-app-1"]
    assert sorted(s[1] for s in out[1][1][1]) == [
        "recover-app-0", "recover-app-1"]


def test_an_overrider_phase_is_taken_as_it_is(pinned_ids):
    out = []
    for pkg in PACKAGES:
        def overrider(pod_type, instances, recovery_type, pkg=pkg):
            if pod_type != "app" or instances != [1]:
                return None
            step = pkg.step.ActionStep("custom-bootstrap", lambda s: True,
                                       assets={"app-1"})
            return pkg.phase.Phase("custom-app-1", [step],
                                   pkg.strategy.SerialStrategy())
        side = RSide(pkg, spec_of(pkg, MIXED_YAML),
                     overriders=[overrider])
        side.deploy()
        side.feed("app-1-server", "FAILED")
        side.feed("app-0-server", "FAILED")
        out.append(side.observe())
    assert out[0] == out[1]
    assert [(s[0], s[1]) for s in out[1][1]] == [
        ("recover-app-0", "recover-app-0"),
        ("custom-app-1", "custom-bootstrap")]


# -- regrow of a shrunken multi-slice gang ------------------------------


def fleet(slices, down=()):
    """``slices`` pods of two 4-chip hosts each; ``down`` host ids marked
    down on both sides."""
    hosts = []
    for k in range(slices):
        hosts += j_inventory.make_test_fleet(
            slice_id=f"pod-{k}", host_grid=(2, 1), chip_block=(2, 2))
    return hosts


def test_shrunken_multislice_gang_regrows_when_capacity_returns(pinned_ids):
    out = []
    for pkg in PACKAGES:
        side = RSide(pkg, spec_of(pkg, MULTISLICE_YAML), hosts=fleet(2))
        # a healthy shrunken prefix: one slice (2 hosts) of the 4
        side.deploy(instances={"trainer": [0, 1]})
        out.append(side.observe())
    assert out[0] == out[1]
    assert [(s[0], s[1]) for s in out[1][1]] == [
        ("recover-trainer-gang", "kill-trainer-survivors"),
        ("recover-trainer-gang", "unreserve-trainer-slice"),
        ("recover-trainer-gang", "replace-trainer-gang"),
        ("recover-trainer-gang", "trim-trainer-surplus")]


hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

HOST_IDS = [f"pod-{k}-h{x}-0" for k in range(3) for x in range(2)]


@settings(max_examples=200, deadline=None)
@given(st.integers(1, 3), st.sets(st.sampled_from(HOST_IDS)),
       st.sets(st.sampled_from(HOST_IDS)))
def test_regrow_capacity_is_the_reference_capacity(slices, down, drained):
    """Fully-up hosts of the pod's generation counted per slice (per
    NVLink fabric on the port)."""
    got = []
    for pkg in PACKAGES:
        spec = spec_of(pkg, MULTISLICE_YAML)
        side = RSide(pkg, spec, hosts=fleet(slices))
        inventory = side.manager.inventory
        for host_id in down:
            if inventory.host(host_id) is not None:
                inventory.mark_down(host_id)
        for host_id in drained - down:
            if inventory.host(host_id) is not None:
                inventory.set_maintenance(host_id, 0.0)
        got.append(side.manager._regrow_capacity(spec.pod("trainer")))
    assert got[0] == got[1]


@settings(max_examples=300, deadline=None)
@given(st.integers(1, 16), st.integers(1, 16), st.integers(0, 5),
       st.booleans(), st.integers(1, 8), st.booleans(), st.integers(1, 4))
def test_decide_resize_is_the_reference_rule(current, full, declines,
                                             enabled, min_hosts,
                                             returning, quantum):
    got = []
    for pkg in PACKAGES:
        policy = pkg.elastic.ElasticPolicy(enabled=enabled,
                                           min_hosts=min_hosts)
        got.append(dataclasses.asdict(pkg.elastic.decide_resize(
            current, full, declines, policy, returning,
            host_quantum=quantum)))
    assert got[0] == got[1]


DIMS = st.lists(st.sampled_from([1, 2, 3, 4, 8, 16]), min_size=1,
                max_size=3)


@settings(max_examples=300, deadline=None)
@given(DIMS, st.sampled_from([1, 2, 4, 8]), st.integers(1, 16))
def test_shrink_topology_is_the_reference_rule(dims, per_host, target):
    topology = "x".join(map(str, dims))
    want = j_elastic.shrink_topology(
        j_specs.TpuSpec(chips_per_host=per_host, topology=topology), target)
    got = t_elastic.shrink_topology(
        t_specs.GpuSpec(chips_per_host=per_host, topology=topology), target)
    assert got == want


@settings(max_examples=200, deadline=None)
@given(DIMS, st.sampled_from([1, 2, 4]), st.integers(1, 3),
       st.integers(1, 16))
def test_shrunken_pod_is_the_reference_pod(dims, per_host, slices, target):
    topology = "x".join(map(str, dims))
    total = 1
    for d in dims:
        total *= d
    hosts = max(1, total // per_host) * slices
    got = []
    for pkg in PACKAGES:
        block_cls = j_specs.TpuSpec if pkg is JAX else t_specs.GpuSpec
        block = block_cls(chips_per_host=per_host, topology=topology,
                          slices=slices, elastic=True)
        pod = pkg.specs.PodSpec(type="trainer", count=hosts, gang=True,
                                **{pkg.block: block})
        small = pkg.elastic.shrunken_pod(pod, target)
        if small is None:
            got.append(None)
            continue
        b = getattr(small, pkg.block)
        got.append((small.count, b.topology, b.slices, b.chips_per_host))
    assert got[0] == got[1]


# -- decommission -------------------------------------------------------


DECOMMISSION_YAML = """
name: shrink
pods:
  hello:
    count: 2
    tasks:
      server: {goal: RUNNING, cmd: "serve", cpus: 0.2, memory: 64, kill-grace-period: 7}
      sidecar: {goal: RUNNING, cmd: "side", cpus: 0.1, memory: 32}
"""


def test_decommission_plan_of_surplus_instances(pinned_ids):
    """A spec scaled from 4 hello instances to 2 and rid of a pod type:
    the surplus instances, the plan, and its kill -> unreserve -> erase
    steps run against a stub scheduler, equal on both sides."""
    wide = DECOMMISSION_YAML.replace("count: 2", "count: 4") + """
  old:
    count: 1
    tasks:
      job: {goal: RUNNING, cmd: "old", cpus: 0.1, memory: 32}
"""
    out = []
    for pkg in PACKAGES:
        side = RSide(pkg, spec_of(pkg, wide))
        side.deploy()
        side.feed("hello-3-sidecar", "FAILED")
        narrow = spec_of(pkg, DECOMMISSION_YAML)
        surplus = pkg.decommission.find_surplus_instances(narrow, side.store)
        plan = pkg.decommission.DecommissionPlanFactory().build(
            narrow, side.store, exclude={"hello-2"})
        seen = [surplus, pkg.trackers.serialize_plan(plan)]
        scheduler = StubScheduler(side.store, side.ledger)
        killed = set()
        for _ in range(8):
            for step in plan.candidates(set()):
                step.execute(scheduler)
            seen.append(pkg.trackers.serialize_plan(plan)["status"])
            # the killer's kills land as terminal statuses
            for task_id, _grace in scheduler.kills:
                if task_id not in killed:
                    killed.add(task_id)
                    side.feed(task_id.rpartition("__")[0], "KILLED")
        seen += [scheduler.kills, scheduler.counts,
                 sorted(side.store.fetch_task_names()),
                 sorted(r.reservation_id for r in side.ledger.all())]
        out.append(seen)
    assert out[0] == out[1]
    surplus = out[1][0]
    assert [(p, i) for p, i, _names in surplus] == [
        ("hello", 3), ("hello", 2), ("old", 0)]
    assert out[1][-2] == [f"hello-{i}-{t}" for i in (0, 1, 2)
                          for t in ("server", "sidecar")]
    assert ("hello-3-server__" + "0" * 32, 7.0) in out[1][-4]


def test_shrink_rule_refuses_a_size_the_node_set_search_could_place():
    """The kept rule halves the largest dimension, made for torus
    rectangles: a 3x4 gang of 4-card hosts (3 hosts) does not shrink to
    one host in either package, though ``find_node_set`` places one
    host of 4 cards (its only need: total = hosts x cards a host)."""
    from dcos_commons_tpu_torch.offer.nvlink import find_node_set
    from dcos_commons_tpu_torch.offer.outcome import EvaluationOutcome

    assert j_elastic.shrink_topology(
        j_specs.TpuSpec(chips_per_host=4, topology="3x4"), 1) is None
    assert t_elastic.shrink_topology(
        t_specs.GpuSpec(chips_per_host=4, topology="3x4"), 1) is None
    host = t_inventory.GpuHost(host_id="n0", slice_id="fab",
                               generation="h100", gpus=8)
    snap = t_inventory.ResourceSnapshot(host, 8.0, 16384, 102400,
                                        set(host.chip_ids()), set())
    placed = find_node_set([snap], 4, 4,
                           lambda s: EvaluationOutcome.ok("host", "ok"))
    assert [s.host.host_id for s in placed.snapshots] == ["n0"]

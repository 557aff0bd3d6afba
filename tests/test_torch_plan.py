"""The port's plan engine (``dcos_commons_tpu_torch/plan``) against the
JAX package's, on the CPU.

- The reference's own cases: tests/test_plan.py and
  tests/test_plan_properties.py run on the port, their imports pointed
  at it and their ``tpu:`` blocks made ``gpu:`` blocks.
- Twin plans: every YAML under frameworks/helloworld, hdfs and
  cassandra, and the port's five YAMLs against frameworks/jax/'s five,
  each rendered with its options.json defaults, built into plans as a
  scheduler builds them (the deploy plan from ``plans.deploy`` or the
  default factory, every other YAML plan interrupted) on twin
  ``StateStore``s, and driven through ``DefaultPlanManager`` and
  ``DefaultPlanCoordinator`` with the same task ids and the same status
  sequences: candidates, their assets, launches, every plan's status
  after every status, proceed of the interrupted plans, the restart
  seeding of a plan rebuilt from the store, and ``serialize_plan`` are
  held exactly equal.  Element ids are uuid4s: both packages draw them
  from one pinned sequence each (``pinned_ids``), so they compare too.
- Generator errors and ``dependency_cycle`` against the reference's
  ``SpecError`` texts, and the status algebra as a twin property."""

import glob
import itertools
import os
import types

import pytest

from dcos_commons_tpu import common as j_common
from dcos_commons_tpu import plan as j_plan
from dcos_commons_tpu.debug import trackers as j_trackers
from dcos_commons_tpu.plan import element as j_element
from dcos_commons_tpu.plan import generator as j_generator
from dcos_commons_tpu.plan import status as j_status
from dcos_commons_tpu.specification import specs as j_specs
from dcos_commons_tpu.specification import yaml_spec as j_yaml
from dcos_commons_tpu.state import state_store as j_state
from dcos_commons_tpu.storage import MemPersister as JMemPersister
from dcos_commons_tpu.tools import options as j_options
from dcos_commons_tpu_torch import common as t_common
from dcos_commons_tpu_torch import plan as t_plan
from dcos_commons_tpu_torch.debug import trackers as t_trackers
from dcos_commons_tpu_torch.plan import element as t_element
from dcos_commons_tpu_torch.plan import generator as t_generator
from dcos_commons_tpu_torch.plan import status as t_status
from dcos_commons_tpu_torch.specification import specs as t_specs
from dcos_commons_tpu_torch.specification import yaml_spec as t_yaml
from dcos_commons_tpu_torch.state import state_store as t_state
from dcos_commons_tpu_torch.storage import MemPersister as TMemPersister
from dcos_commons_tpu_torch.tools import options as t_options
from test_torch_offer import gpu_yaml

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
PORT_FRAMEWORKS = os.path.join(REPO, "dcos_commons_tpu_torch", "frameworks")
JAX_FRAMEWORKS = os.path.join(REPO, "frameworks", "jax")
REFERENCE_YAMLS = sorted(
    os.path.relpath(p, REPO)
    for name in ("helloworld", "hdfs", "cassandra")
    for p in glob.glob(os.path.join(REPO, "frameworks", name, "*.yml"))
)
PORT_YAMLS = ("svc.yml", "svc_mnist.yml", "svc_serve.yml",
              "svc_serve_gang.yml", "svc_router.yml")


# -- the reference's own cases on the port -----------------------------


def _port_cases(filename):
    """``tests/<filename>`` with its imports pointed at the port and its
    YAMLs' ``tpu:`` blocks made ``gpu:`` blocks."""
    with open(os.path.join(HERE, filename)) as f:
        source = f.read()
    source = gpu_yaml(source.replace("from dcos_commons_tpu.",
                                     "from dcos_commons_tpu_torch."))
    assert "dcos_commons_tpu." not in source
    module = types.ModuleType(f"port_{filename[:-3]}")
    module.__file__ = os.path.join(HERE, filename)
    exec(compile(source, module.__file__, "exec"), module.__dict__)
    return module


PLAN_CASES = _port_cases("test_plan.py")
PROPERTY_CASES = _port_cases("test_plan_properties.py")


def _case_names(module):
    return sorted(n for n in vars(module) if n.startswith("test_"))


def test_every_reference_case_is_run():
    assert len(_case_names(PLAN_CASES)) == 29
    assert len(_case_names(PROPERTY_CASES)) == 4


@pytest.mark.parametrize("name", _case_names(PLAN_CASES))
def test_plan_case_on_the_port(name):
    getattr(PLAN_CASES, name)()


@pytest.mark.parametrize("name", _case_names(PROPERTY_CASES))
def test_plan_property_on_the_port(name):
    getattr(PROPERTY_CASES, name)()


# -- twin packages ------------------------------------------------------


JAX = types.SimpleNamespace(
    common=j_common, plan=j_plan, specs=j_specs, yaml=j_yaml,
    options=j_options, state=j_state, persister=JMemPersister,
    trackers=j_trackers, element=j_element, frameworks=JAX_FRAMEWORKS,
)
PORT = types.SimpleNamespace(
    common=t_common, plan=t_plan, specs=t_specs, yaml=t_yaml,
    options=t_options, state=t_state, persister=TMemPersister,
    trackers=t_trackers, element=t_element, frameworks=PORT_FRAMEWORKS,
)
PACKAGES = (JAX, PORT)


class _Uuid:
    def __init__(self, n):
        self.hex = f"{n:032x}"

    def __str__(self):
        h = self.hex
        return f"{h[:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:]}"


class PinnedUuid:
    """A stand-in for the ``uuid`` module whose ``uuid4`` counts up."""

    def __init__(self, start=1):
        self._next = itertools.count(start)

    def uuid4(self):
        return _Uuid(next(self._next))


@pytest.fixture
def pinned_ids(monkeypatch):
    """Every element id from a per-package counter, so the two packages
    give the same ids to the same elements."""
    for pkg in PACKAGES:
        monkeypatch.setattr(pkg.element, "uuid", PinnedUuid())


def render(pkg, path):
    """``path`` (a YAML of the package's own framework directory, or of
    frameworks/helloworld|hdfs|cassandra) rendered with its
    options.json defaults."""
    schema = pkg.options.load_schema(os.path.dirname(path))
    env = pkg.options.render_options(schema, {}) if schema else {}
    return pkg.yaml.from_yaml_file(path, env)


class Side:
    """One package's plans over its own state store, wired as a
    scheduler wires them: the deploy plan from ``plans.deploy`` (or the
    default factory), every other YAML plan built interrupted, one
    manager a plan, and the coordinator over them."""

    def __init__(self, pkg, spec):
        self.pkg = pkg
        self.spec = spec
        self.config_id = "cfg-1"
        self.store = pkg.state.StateStore(pkg.persister())
        self.seq = itertools.count()
        self.build()

    def build(self):
        pkg, spec = self.pkg, self.spec
        raw = spec.plans or {}
        generator = pkg.plan.PlanGenerator()
        if raw.get("deploy"):
            deploy = generator.generate(spec, "deploy", raw["deploy"],
                                        self.store, self.config_id)
        else:
            deploy = pkg.plan.DeployPlanFactory().build(
                spec, self.store, self.config_id)
        self.plans = [deploy]
        for name, raw_plan in raw.items():
            if name in ("deploy", "update") or not raw_plan:
                continue
            custom = generator.generate(spec, name, raw_plan, self.store,
                                        self.config_id)
            custom.interrupt()
            self.plans.append(custom)
        self.managers = [pkg.plan.DefaultPlanManager(p) for p in self.plans]
        self.coordinator = pkg.plan.DefaultPlanCoordinator(self.managers)

    def statuses(self):
        return [(p.name, p.get_status().name) for p in self.plans]

    def serialized(self):
        return [self.pkg.trackers.serialize_plan(p) for p in self.plans]

    def launch(self, requirement):
        """Task ids and stored TaskInfos for one requirement, as the
        launch recorder would store them."""
        common = self.pkg.common
        ids, infos = {}, []
        for index in requirement.instances:
            for task in requirement.tasks_to_launch:
                full = self.pkg.specs.task_full_name(requirement.pod.type,
                                                     index, task)
                ids[full] = f"{full}__{next(self.seq):032x}"
                infos.append(common.TaskInfo(
                    name=full, task_id=ids[full],
                    pod_type=requirement.pod.type, pod_index=index,
                    labels={common.Label.TARGET_CONFIG: self.config_id},
                ))
        self.store.store_launch(infos)
        return ids

    def feed(self, task_id, state, ready=False):
        common = self.pkg.common
        status = common.TaskStatus(task_id=task_id,
                                   state=common.TaskState[state],
                                   ready=ready, timestamp=1.0)
        self.store.store_status(common.task_name_of(task_id), status)
        for manager in self.managers:
            manager.update(status)


def _goal(requirement, full):
    for index in requirement.instances:
        for task in requirement.pod.tasks:
            if full == f"{requirement.pod.type}-{index}-{task.name}":
                return task.goal.name
    raise KeyError(full)


def drive(side, rounds=60, fail_every=4):
    """Offer cycles until no plan offers work: every candidate started,
    launched with fresh ids and fed STARTING, RUNNING and, for a
    FINISH/ONCE goal, FINISHED; every ``fail_every``-th launch first
    fails once.  When nothing is offered, each interrupted plan is
    proceeded (as ``POST /v1/plans/<name>/start``).  Returns the trace
    of observations."""
    trace = []
    launches = 0
    for _ in range(rounds):
        candidates = side.coordinator.get_candidates()
        trace.append(("candidates", [
            (s.name, sorted(s.get_asset_names()), s.get_status().name)
            for s in candidates]))
        if not candidates:
            parked = [p for p in side.plans if p.is_interrupted()]
            if not parked:
                break
            parked[0].proceed()
            trace.append(("proceed", parked[0].name, side.statuses()))
            continue
        for step in candidates:
            requirement = step.start()
            if requirement is None:
                trace.append(("no-requirement", step.name))
                continue
            ids = side.launch(requirement)
            step.record_launch(ids)
            launches += 1
            trace.append(("launch", step.name, sorted(ids),
                          requirement.recovery_type.name,
                          sorted(requirement.asset_names),
                          step.get_status().name))
            states = ["STARTING", "RUNNING"]
            if launches % fail_every == 0:
                states = ["STARTING", "FAILED"]
            for full in sorted(ids):
                for state in states:
                    finished = state == "RUNNING" and _goal(
                        requirement, full) in ("FINISH", "ONCE")
                    side.feed(ids[full], state, ready=state == "RUNNING")
                    trace.append(("status", full, state, step.name,
                                  step.get_status().name, side.statuses()))
                    if finished:
                        side.feed(ids[full], "FINISHED")
                        trace.append(("status", full, "FINISHED",
                                      step.name, step.get_status().name,
                                      side.statuses()))
    trace.append(("serialized", side.serialized()))
    return trace


def twin_trace(specs):
    """The drive's trace for each package's spec, then a restart: the
    plans rebuilt from the same store (the deploy plan seeds its
    finished steps COMPLETE) and serialized."""
    out = []
    for pkg, spec in zip(PACKAGES, specs):
        side = Side(pkg, spec)
        trace = [("built", side.statuses(), side.serialized())]
        # a restart in the middle of the deploy, then the rest
        first = drive(side, rounds=2)
        side.build()
        trace += first + [("rebuilt", side.statuses(), side.serialized())]
        trace += drive(side)
        side.build()
        trace.append(("restarted", side.statuses(), side.serialized()))
        out.append(trace)
    return out


def _parse_both(rel):
    path = os.path.join(REPO, rel)
    specs, errors = [], []
    for pkg in PACKAGES:
        try:
            specs.append(render(pkg, path))
            errors.append(None)
        except Exception as e:  # noqa: BLE001 — compared across packages
            specs.append(None)
            errors.append(type(e).__name__)
    return specs, errors


@pytest.mark.parametrize("rel", REFERENCE_YAMLS)
def test_reference_yamls_drive_the_same_plans(rel, pinned_ids):
    specs, errors = _parse_both(rel)
    assert errors[0] == errors[1]
    if specs[0] is None:
        return  # both refuse the YAML (test_torch_spec holds why)
    want, got = twin_trace(specs)
    assert got == want


@pytest.mark.parametrize("name", PORT_YAMLS)
def test_port_yamls_drive_the_plans_of_the_jax_ones(name, pinned_ids):
    specs = [render(pkg, os.path.join(pkg.frameworks, name))
             for pkg in PACKAGES]
    want, got = twin_trace(specs)
    assert got == want
    # every deploy plan reaches COMPLETE, every sidecar plan is run
    final = want[-1][1]
    assert all(status == "COMPLETE" for _name, status in final), final


def test_twin_drive_sees_failures_and_sidecars(pinned_ids):
    """The drive does what the twin tests rely on: on the port's
    ``svc.yml`` launches fail and are retried, the ``collectives``
    sidecar plan starts interrupted, is proceeded and runs."""
    spec = render(PORT, os.path.join(PORT_FRAMEWORKS, "svc.yml"))
    side = Side(PORT, spec)
    assert side.statuses() == [("deploy", "PENDING"),
                               ("collectives", "WAITING")]
    trace = drive(side, fail_every=2)
    assert ("proceed", "collectives",
            [("deploy", "COMPLETE"), ("collectives", "PENDING")]) in trace
    failed = [t for t in trace if t[0] == "status" and t[2] == "FAILED"]
    assert failed and all(t[4] == "PENDING" for t in failed)
    launched = [t[1] for t in trace if t[0] == "launch"]
    assert launched == ["trainer-gang:[worker]",
                        "trainer-gang:[collective-bench]",
                        "trainer-gang:[collective-bench]"]
    assert side.statuses() == [("deploy", "COMPLETE"),
                               ("collectives", "COMPLETE")]


# -- generator errors and the dependency DAG ---------------------------

BASE_YAML = """
name: svc
pods:
  hello:
    count: 2
    tasks:
      server: {goal: RUNNING, cmd: "sleep 1000"}
  once:
    count: 1
    tasks:
      init: {goal: ONCE, cmd: "echo done"}
"""

BAD_PLANS = {
    "index-out-of-range": """
plans:
  deploy:
    phases:
      p: {pod: hello, steps: [{5: [[server]]}]}
""",
    "unknown-task": """
plans:
  deploy:
    phases:
      p: {pod: hello, steps: [{0: [[bogus]]}]}
""",
    "unknown-pod": """
plans:
  deploy:
    phases:
      p: {pod: nobody}
""",
    "unknown-dependency": """
plans:
  deploy:
    phases:
      a: {pod: once}
      b: {pod: hello, dependencies: [zzz]}
""",
    "cycle": """
plans:
  deploy:
    phases:
      a: {pod: once, dependencies: [c]}
      b: {pod: hello, dependencies: [a]}
      c: {pod: hello, dependencies: [b]}
""",
    "strategy-with-dependencies": """
plans:
  deploy:
    strategy: serial
    phases:
      a: {pod: once}
      b: {pod: hello, dependencies: [a]}
""",
    "bad-strategy": """
plans:
  deploy:
    strategy: zigzag
    phases:
      a: {pod: once}
""",
    "bad-step-index": """
plans:
  deploy:
    phases:
      p: {pod: hello, steps: [{first: [[server]]}]}
""",
}


def _generate(pkg, text):
    spec = pkg.yaml.from_yaml(text)
    store = pkg.state.StateStore(pkg.persister())
    try:
        plan = pkg.plan.PlanGenerator().generate(
            spec, "deploy", spec.plans["deploy"], store, "c")
    except Exception as e:  # noqa: BLE001 — compared across packages
        return None, e
    return plan, None


@pytest.mark.parametrize("case", sorted(BAD_PLANS))
def test_generator_errors_match_the_reference(case):
    text = BASE_YAML + BAD_PLANS[case]
    (_, want), (_, got) = (_generate(pkg, text) for pkg in PACKAGES)
    assert want is not None
    assert type(got).__name__ == type(want).__name__
    assert str(got) == str(want)
    if isinstance(want, j_specs.SpecError):
        assert isinstance(got, t_specs.SpecError)


hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

NODES = ("a", "b", "c", "d", "e")


@settings(max_examples=300, deadline=None)
@given(st.dictionaries(st.sampled_from(NODES),
                       st.lists(st.sampled_from(NODES), max_size=3),
                       max_size=5))
def test_dependency_cycle_is_the_reference_cycle(edges):
    assert t_generator.dependency_cycle(edges) == \
        j_generator.dependency_cycle(edges)


@settings(max_examples=300, deadline=None)
@given(st.lists(st.sampled_from([s.name for s in j_status.Status]),
                max_size=5), st.booleans())
def test_aggregate_is_the_reference_aggregate(children, interrupted):
    want = j_status.aggregate([j_status.Status[c] for c in children],
                              interrupted)
    got = t_status.aggregate([t_status.Status[c] for c in children],
                             interrupted)
    assert got.name == want.name


@settings(max_examples=150, deadline=None)
@given(st.lists(st.sampled_from(["serial", "parallel", "serial-canary",
                                 "parallel-canary"]),
                min_size=1, max_size=3),
       st.lists(st.integers(0, 5), max_size=8))
def test_strategies_pick_the_reference_candidates(strategies, completions):
    """Phases of each strategy over one pod's instances; after each
    forced completion (the i-th candidate) and a canary proceed, the
    plan offers the reference's candidates."""
    phases = "\n".join(
        f"      p{i}: {{pod: hello, strategy: {name}}}"
        for i, name in enumerate(strategies))
    text = BASE_YAML.replace("count: 2", "count: 4") + (
        "plans:\n  deploy:\n    strategy: serial\n    phases:\n" + phases
        + "\n")
    plans = [_generate(pkg, text)[0] for pkg in PACKAGES]
    for pick in completions + [0]:
        seen = []
        for plan in plans:
            candidates = plan.candidates(set())
            seen.append(sorted(s.name for s in candidates))
            if candidates:
                candidates[pick % len(candidates)].force_complete()
            else:
                plan.proceed()
                for phase in plan.phases:
                    phase.proceed()
        assert seen[0] == seen[1]
        assert [p.get_status().name for p in plans[1].phases] == \
            [p.get_status().name for p in plans[0].phases]

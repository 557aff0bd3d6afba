"""The port's plancheck held against the JAX package's.

Each configuration, built-in or seeded with a bug, is checked on both
sides: the reference's ``check_plan`` over the reference's plan
objects, the port's over the port's, at the caps the reference gate
uses (tests/test_lint_gate.py).  States explored, transitions, the
truncation and quotient flags, and every violation's invariant, detail
and minimal trace must be equal.  The autoscale seeds are in
test_torch_plancheck_autoscale.py and the port's full-depth gate in
test_torch_plancheck_gate.py, each a file of its own for its time.
"""

import importlib
from types import SimpleNamespace

import pytest

from dcos_commons_tpu.analysis import plancheck as j_plancheck
from dcos_commons_tpu_torch.analysis import plancheck as t_plancheck

# the cap of the built-in configurations' twins; the full depth is the
# port's gate (test_torch_plancheck_gate.py)
BUILTIN_CAP = 5_000


def side(pkg: str) -> SimpleNamespace:
    """One package's plancheck and the plan modules a seed builds on."""
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    return SimpleNamespace(
        plancheck=mod("analysis.plancheck"),
        phase=mod("plan.phase"),
        plan=mod("plan.plan"),
        step=mod("plan.step"),
        strategy=mod("plan.strategy"),
        specs=mod("specification.specs"),
        common=mod("common"),
    )


SIDES = (side("dcos_commons_tpu"), side("dcos_commons_tpu_torch"))


def outcome(result):
    return (
        result.states, result.transitions, result.complete_states,
        result.truncated, result.livelock_checked, result.quotient,
        [(v.invariant, v.detail, tuple(v.trace))
         for v in result.violations],
    )


def twin(make_factory, **kwargs):
    """``check_plan(make_factory(side), **kwargs)`` on both sides; the
    outcomes must be equal.  Returns the port's result."""
    results = [
        s.plancheck.check_plan(make_factory(s), **kwargs) for s in SIDES
    ]
    assert outcome(results[1]) == outcome(results[0])
    return results[1]


def test_same_builtin_configurations():
    assert list(t_plancheck.BUILTIN_CONFIGS) == list(
        j_plancheck.BUILTIN_CONFIGS)
    assert [v[1] for v in t_plancheck.BUILTIN_CONFIGS.values()] == [
        v[1] for v in j_plancheck.BUILTIN_CONFIGS.values()]
    assert [i.name for i in t_plancheck.default_invariants()] == [
        i.name for i in j_plancheck.default_invariants()]


@pytest.mark.parametrize("name", list(t_plancheck.BUILTIN_CONFIGS))
def test_builtin_configuration_twins(name):
    step_interrupts = t_plancheck.BUILTIN_CONFIGS[name][1]
    result = twin(
        lambda s: s.plancheck.BUILTIN_CONFIGS[name][0],
        max_states=BUILTIN_CAP, config_name=name,
        step_interrupts=step_interrupts,
    )
    assert result.ok, [v.render() for v in result.violations]


# (config name, seed, invariant that must fire, longest minimal trace)
MIGRATION_SEEDS = [
    ("seeded-late-abort", dict(abort_after_cutover=True),
     "no-double-serve", 5),
    ("seeded-early-release", dict(release_before_activate=True),
     "no-token-loss", 5),
]


@pytest.mark.parametrize("name,seed,invariant,longest", MIGRATION_SEEDS)
def test_broken_cutover_protocol_twins(name, seed, invariant, longest):
    result = twin(
        lambda s: lambda: s.plancheck._migration_plan(**seed),
        config_name=name, max_states=120_000, check_livelock=False,
    )
    caught = [v for v in result.violations if v.invariant == invariant]
    assert caught, result.violations
    assert len(caught[0].trace) <= longest, caught[0].render()


def test_regrow_without_kill_twin():
    result = twin(
        lambda s: lambda: s.plancheck._multislice_recovery_plan(
            regrow_skips_kill=True),
        config_name="seeded-regrow-no-kill", max_states=120_000,
        check_livelock=False,
    )
    overlap = [v for v in result.violations
               if v.invariant == "no-double-slice-reservation"]
    assert overlap and len(overlap[0].trace) <= 9, result.violations


def _broken_gang(s):
    """A gang recovery phase whose strategy does not serialize kill ->
    unreserve -> replace (the reference gate's seeded bug)."""
    specs, step, P = s.specs, s.step, s.plancheck

    def factory():
        pod = specs.PodSpec(
            type="trainer", count=2, gang=True,
            tasks=[specs.TaskSpec(name="worker", goal=specs.GoalState.RUNNING,
                                  cmd="train")],
        )
        replace = step.DeploymentStep(
            "replace-trainer-gang",
            step.PodInstanceRequirement(pod=pod, instances=[0, 1]),
            backoff=P.ModelBackoff(),
        )
        kill = step.ActionStep("kill-trainer-survivors", lambda st: False)
        unreserve = step.ActionStep(
            "unreserve-trainer-slice", lambda st: False)
        world = P.GangRecoveryWorld(kill, unreserve, replace)
        kill._action = world.kill_survivors
        unreserve._action = world.unreserve_slice
        phase = s.phase.Phase(
            "recover-trainer-gang", [kill, unreserve, replace],
            s.strategy.ParallelStrategy(),  # the seeded bug: no ordering
        )
        plan = s.plan.Plan("recovery", [phase], s.strategy.ParallelStrategy())
        world.bind(plan)
        return plan, world

    return factory


def test_unordered_gang_recovery_twin():
    result = twin(_broken_gang, config_name="broken-gang",
                  max_states=50_000, max_violations=6,
                  check_livelock=False)
    names = {v.invariant for v in result.violations}
    assert {"no-split-brain-gang", "no-double-reservation"} <= names
    assert min(len(v.trace) for v in result.violations
               if v.invariant == "no-double-reservation") == 1


def _model_plan(s, steps, strategy):
    return s.plan.Plan(
        "deploy", [s.phase.Phase("phase", steps, strategy)],
        s.strategy.SerialStrategy(),
    )


def _broken_deps(s):
    class BrokenDeps(s.strategy.DependencyStrategy):
        def _candidates(self, children, dirty_assets):
            return [c for c in children
                    if s.strategy._eligible(c, dirty_assets)]

    return lambda: _model_plan(
        s,
        [s.plancheck._step("stage-a", "da"),
         s.plancheck._step("stage-b", "db")],
        BrokenDeps({"stage-b": ["stage-a"]}),
    )


def test_broken_dependency_strategy_twin():
    result = twin(_broken_deps, config_name="seeded-deps",
                  max_states=30_000)
    caught = [v for v in result.violations
              if v.invariant == "dependency-honored"]
    assert caught and caught[0].trace == ("launch(stage-a)",)


def _regressing(s):
    TaskState, task_name_of = s.common.TaskState, s.common.task_name_of

    class RegressingStep(s.step.DeploymentStep):
        def update(self, status):
            with self._lock:
                try:
                    name = task_name_of(status.task_id)
                except ValueError:
                    return
                if name not in self._expected:
                    return
                # the seeded bug: no is_complete guard, no stale check
                self._task_states[name] = status.state
                if status.ready:
                    self._task_ready[name] = True
                if status.state is not TaskState.ERROR:
                    self._recompute(failed=status.state.is_failure)

    def factory():
        step = RegressingStep(
            "node-0",
            s.step.PodInstanceRequirement(
                pod=s.plancheck._pod("na"), instances=[0]),
            backoff=s.plancheck.ModelBackoff(),
        )
        return _model_plan(s, [step], s.strategy.SerialStrategy())

    return factory


def test_complete_regression_twin():
    result = twin(_regressing, config_name="seeded-regress",
                  max_states=30_000)
    assert not result.quotient
    caught = [v for v in result.violations
              if v.invariant == "no-silent-regression"]
    assert caught and len(caught[0].trace) == 3
    assert caught[0].trace[0] == "launch(node-0)"


@pytest.mark.parametrize("step_interrupts", [True, False])
def test_quotient_probe_and_stale_status_twins(step_interrupts):
    result = twin(lambda s: s.plancheck._parallel_plan,
                  config_name="probe", max_states=30_000,
                  step_interrupts=step_interrupts)
    assert result.quotient and result.ok
    events = [
        label for label, _ in
        t_plancheck.PlanHarness(t_plancheck._parallel_plan()).events()
    ]
    assert any("STALE" in label for label in events)

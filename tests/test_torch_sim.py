"""The port's simulation harness (``dcos_commons_tpu_torch/testing/
runner.py`` and ``ticks.py``) against the JAX package's, on the CPU.

The JAX package's tick scripts (tests/test_sim_harness.py,
tests/test_uninstall_decommission.py and the cases of
tests/test_helloworld.py that drive a ``FakeAgent``) run twice: as
they are, on the JAX harness, and with their imports pointed at the
port (``TpuHost`` made ``GpuHost``), on the port's.  Each
``ServiceTestRunner.run`` is made to take its ticks one at a time and
record what can be observed after each (every plan's, phase's and
step's status, the launches with their hosts, the kills, the stored
statuses, the reservations); both packages must record the same
sequence, and each script's own assertions must hold on both.  The
harness's default fleet is three ``GpuHost``s in the port, three
``TpuHost``s in the JAX package, with the same host ids."""

import os
import types

import pytest

from dcos_commons_tpu.testing import runner as j_runner
from dcos_commons_tpu_torch.offer.inventory import GpuHost
from dcos_commons_tpu_torch.testing import runner as t_runner
from test_torch_offer import gpu_yaml

HERE = os.path.dirname(os.path.abspath(__file__))
SCRIPTS = ("test_sim_harness.py", "test_uninstall_decommission.py",
           "test_helloworld.py")
# cases that run real processes (a LocalProcessAgent, or the remote
# agent daemon), not ticks: test_torch_builder.py and
# test_torch_agent.py twin the local ones, test_torch_remote_agent.py
# the daemon's
REAL_PROCESSES = {"test_graceful_shutdown_honors_kill_grace",
                  "test_rlimits_enforced_in_real_task",
                  "test_taskcfg_template_rendered_and_rerendered_on_update"}


def port_module(filename):
    """``tests/<filename>`` with its imports pointed at the port."""
    with open(os.path.join(HERE, filename)) as f:
        source = f.read()
    source = gpu_yaml(source.replace("dcos_commons_tpu.",
                                     "dcos_commons_tpu_torch.")
                      .replace("TpuHost", "GpuHost"))
    module = types.ModuleType(f"port_{filename[:-3]}")
    module.__file__ = os.path.join(HERE, filename)
    exec(compile(source, module.__file__, "exec"), module.__dict__)
    return module


def jax_module(filename):
    module = types.ModuleType(f"jax_{filename[:-3]}")
    module.__file__ = os.path.join(HERE, filename)
    with open(module.__file__) as f:
        exec(compile(f.read(), module.__file__, "exec"), module.__dict__)
    return module


MODULES = {f: (jax_module(f), port_module(f)) for f in SCRIPTS}
CASES = [(f, name) for f in SCRIPTS
         for name in sorted(vars(MODULES[f][0]))
         if name.startswith("test_") and name not in REAL_PROCESSES]


def observe(world):
    """What a tick can see: plans, launches, kills, statuses,
    reservations."""
    plans = {
        name: (plan.get_status().value, [
            (phase.name, phase.get_status().value,
             [(step.name, step.get_status().value) for step in phase.steps])
            for phase in plan.phases])
        for name, plan in sorted(world.scheduler.plans().items())
    }
    return {
        "plans": plans,
        "launched": [(i.name, i.agent_id) for i in world.agent.launched],
        "kills": list(world.agent.killed_names()),
        "statuses": {n: s.state.value for n, s in sorted(
            world.state_store.fetch_statuses().items())},
        "reservations": sorted(
            (r.task_name, r.host_id) for r in world.scheduler.ledger.all()),
    }


def recording(monkeypatch, runner_module, log):
    """Make ``ServiceTestRunner.run`` apply its ticks one at a time and
    log (tick, observation) after each."""
    original = runner_module.ServiceTestRunner.run

    def run(self, ticks):
        world = self.world or self.build()
        for tick in ticks:
            original(self, [tick])
            log.append((tick.describe(), observe(world)))
        return world

    monkeypatch.setattr(runner_module.ServiceTestRunner, "run", run)


def test_every_script_is_run():
    assert len(CASES) == 7 + 5 + 28


@pytest.mark.parametrize("filename,name", CASES)
def test_tick_script_observes_as_the_jax_harness(filename, name,
                                                  monkeypatch):
    logs = []
    for module, runner_module in zip(MODULES[filename],
                                     (j_runner, t_runner)):
        log = []
        recording(monkeypatch, runner_module, log)
        getattr(module, name)()
        logs.append(log)
    assert logs[0], "the script ran no tick"
    assert [t for t, _ in logs[1]] == [t for t, _ in logs[0]]
    for (tick, jobs), (_, tobs) in zip(*logs):
        assert tobs == jobs, tick


def test_default_fleet_is_three_gpu_hosts():
    runner = t_runner.ServiceTestRunner(
        "name: s\npods:\n  p:\n    count: 1\n    tasks:\n      t:\n"
        "        goal: RUNNING\n        cmd: x\n        cpus: 0.1\n"
        "        memory: 32\n")
    assert runner.hosts == [GpuHost(host_id=f"host-{i}") for i in range(3)]

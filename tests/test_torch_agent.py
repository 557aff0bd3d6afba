"""The port's local agent (``dcos_commons_tpu_torch/agent/local.py``)
and native task supervisor (``native/``) against the JAX package's, on
the CPU (this host has ``g++``).

- The reference's own cases (tests/test_native_supervisor.py) run on
  the port, their imports pointed at it.
- Twin ``LocalProcessAgent``s, each under its own supervisor binary,
  run the same shell tasks: a finish, a failure, a readiness check, a
  failing health check, a kill inside its grace and a kill past it.
  Each task's statuses (state, readiness, message) come in the same
  order from both; the tasks wait for a file the test writes, so no
  status depends on when a poll falls.
- Recovery after an agent restart from the durable records, in each
  package and across them: an agent dies (dropped, no shutdown) with
  a live task and an exited one; the next agent over the same work
  directory adopts the live one, reports the exited one's exit once,
  and kills the live one.
- Phase 20 of chip_smoke.py rehearsed on the CPU: the port's
  ``DefaultScheduler`` and ``LocalProcessAgent`` deploy the port's
  svc.yml trainer (one card, 1x1, 2 steps) with ``TORCH_DEVICE=cpu``,
  2 layers and a narrow width, through ``run_cycle`` alone: deploy
  COMPLETE, the collectives sidecar, ``restart_pod``, and the relaunch
  restoring its checkpoint."""

import os
import shlex
import sys
import time
import types

import pytest

from dcos_commons_tpu.agent import local as j_local
from dcos_commons_tpu import common as j_common
from dcos_commons_tpu.specification import specs as j_specs
from dcos_commons_tpu_torch.agent import local as t_local
from dcos_commons_tpu_torch import common as t_common
from dcos_commons_tpu_torch import native as t_native
from dcos_commons_tpu_torch.specification import specs as t_specs
from test_torch_plan import _port_cases

JAX = types.SimpleNamespace(name="jax", local=j_local, common=j_common,
                            specs=j_specs)
PORT = types.SimpleNamespace(name="port", local=t_local, common=t_common,
                             specs=t_specs)
PACKAGES = (JAX, PORT)

NATIVE_CASES = _port_cases("test_native_supervisor.py")


def _case_names(module):
    return sorted(n for n in vars(module) if n.startswith("test_"))


def test_every_reference_case_is_run():
    assert len(_case_names(NATIVE_CASES)) == 8


@pytest.mark.parametrize("name", _case_names(NATIVE_CASES))
def test_native_supervisor_case_on_the_port(name, tmp_path):
    case = getattr(NATIVE_CASES, name)
    if "tmp_path" in case.__code__.co_varnames[:case.__code__.co_argcount]:
        case(tmp_path)
    else:
        case()


def test_the_port_builds_its_own_supervisor():
    path = t_native.task_exec_path()
    assert path.startswith(os.path.dirname(t_native.__file__) + os.sep)
    assert os.access(path, os.X_OK)
    assert not [n for n in os.listdir(os.path.dirname(path))
                if ".tmp" in n]


# -- twin agents --------------------------------------------------------

# each task starts once its sandbox holds ``go``; (command, checks, how
# the test ends it)
WAIT = "while [ ! -f go ]; do sleep 0.02; done"
TASKS = {
    "fin-0-a": (f"{WAIT}; echo done", {}, "go"),
    "fail-0-a": (f"{WAIT}; exit 3", {}, "go"),
    "ready-0-a": (f"{WAIT}; sleep 60",
                  {"readiness": dict(cmd="test -f ready", interval_s=0.0)},
                  "ready"),
    # a health kill has no grace: the supervisor's SIGTERM and the
    # agent's SIGKILL race, so the task ignores SIGTERM
    "sick-0-a": ('trap "" TERM; sleep 60',
                 {"health": dict(cmd="test -f healthy", interval_s=0.0,
                                 grace_period_s=0.0,
                                 max_consecutive_failures=2)},
                 None),
    "grace-0-a": ('trap "echo cleaning; exit 0" TERM; '
                  "while true; do sleep 0.02; done", {}, ("kill", 5.0)),
    "stubborn-0-a": ('trap "" TERM; sleep 60', {}, ("kill", 0.5)),
}


def _statuses_until_terminal(agent, task_id, timeout_s=15.0, seen=None):
    out = seen if seen is not None else []
    end = time.monotonic() + timeout_s
    while time.monotonic() < end:
        for s in agent.poll():
            out.append(s)
        if any(s.task_id == task_id and s.state.is_terminal for s in out):
            return out
        time.sleep(0.02)
    raise AssertionError(f"{task_id}: no terminal status in {out}")


def _run_task(pkg, workdir, name):
    """One agent, one task of ``TASKS``: its statuses, in order."""
    command, checks, end = TASKS[name]
    agent = pkg.local.LocalProcessAgent(str(workdir))
    info = pkg.common.TaskInfo(name=name, task_id=f"{name}__1",
                               command=command)
    agent.launch_one(
        info,
        readiness=(pkg.specs.ReadinessCheckSpec(**checks["readiness"])
                   if "readiness" in checks else None),
        health=(pkg.specs.HealthCheckSpec(**checks["health"])
                if "health" in checks else None))
    statuses = []
    end_t = time.monotonic() + 10
    while not any(s.state.name == "RUNNING" for s in statuses):
        assert time.monotonic() < end_t
        statuses += agent.poll()
        time.sleep(0.02)
    sandbox = agent.sandbox_of(name)
    if end == "ready":
        open(os.path.join(sandbox, "ready"), "w").close()
        end_t = time.monotonic() + 10
        while not any(s.ready and s.message for s in statuses):
            assert time.monotonic() < end_t
            statuses += agent.poll()
            time.sleep(0.02)
        agent.kill(info.task_id, 0.5)
    elif end == "go":
        open(os.path.join(sandbox, "go"), "w").close()
    elif end is not None:
        time.sleep(0.3)   # the shell has installed its trap
        agent.kill(info.task_id, end[1])
    _statuses_until_terminal(agent, info.task_id, seen=statuses)
    agent.shutdown()
    with open(os.path.join(sandbox, "stdout")) as f:
        stdout = f.read()
    return [(s.state.name, s.ready, s.message) for s in statuses], stdout


@pytest.mark.parametrize("name", sorted(TASKS))
def test_twin_agents_report_the_same_statuses(name, tmp_path):
    jax_run = _run_task(JAX, tmp_path / "jax", name)
    port_run = _run_task(PORT, tmp_path / "port", name)
    assert port_run == jax_run
    states = [state for state, _, _ in jax_run[0]]
    assert states[0] == "RUNNING" and states[-1] in (
        "FINISHED", "FAILED", "KILLED")
    if name == "grace-0-a":
        assert jax_run[1] == "cleaning\n"       # the grace let it clean up
        assert jax_run[0][-1][2] == "exit 0"
    if name == "stubborn-0-a":
        assert jax_run[0][-1][2] == "exit 137"  # escalated to SIGKILL


@pytest.mark.parametrize("first,second", [
    (JAX, PORT), (PORT, JAX), (PORT, PORT)],
    ids=["jax-then-port", "port-then-jax", "port-then-port"])
def test_agent_restart_recovers_from_the_durable_records(first, second,
                                                         tmp_path):
    """The second agent over the first one's work directory: the live
    task adopted (RUNNING again), the exited one's fate reported once,
    then the live one killed."""
    workdir = str(tmp_path / "w")
    agent = first.local.LocalProcessAgent(workdir)
    agent.launch_one(first.common.TaskInfo(
        name="live-0-main", task_id="live-0-main__1", command="sleep 30"))
    agent.launch_one(first.common.TaskInfo(
        name="done-0-main", task_id="done-0-main__1", command="exit 4"))
    exit_file = os.path.join(workdir, "done-0-main", ".super",
                             "done-0-main__1", "exit_status")
    end = time.monotonic() + 10
    while not os.path.exists(exit_file):
        assert time.monotonic() < end
        time.sleep(0.02)
    del agent   # dies: no shutdown, no kills
    after = second.local.LocalProcessAgent(workdir)
    assert after.active_task_ids() == {"live-0-main__1"}
    got = sorted((s.task_id, s.state.name, s.message) for s in after.poll())
    assert got == [
        ("done-0-main__1", "FAILED", "recovered after agent restart: exit 4"),
        ("live-0-main__1", "RUNNING", "")]
    again = second.local.LocalProcessAgent(workdir)
    assert not [s for s in again.poll() if s.task_id == "done-0-main__1"]
    after.kill("live-0-main__1", grace_period_s=0.5)
    statuses = _statuses_until_terminal(after, "live-0-main__1")
    assert [s.state.name for s in statuses if s.task_id == "live-0-main__1"
            ][-1] == "KILLED"
    after.shutdown()
    again.shutdown()


# -- phase 20 rehearsed on the CPU --------------------------------------

WIDTH = dict(VOCAB="64", D_MODEL="32", N_LAYERS="2", N_HEADS="4",
             N_KV_HEADS="4", D_FF="64", SEQ_LEN="16", TORCH_DEVICE="cpu",
             BENCH_PAYLOAD_MB="1", BENCH_ITERS="2")


def _stdout(agent, info):
    with open(os.path.join(agent.sandbox_of(info.name), "stdout")) as f:
        return f.read()


def test_scheduler_deploys_the_trainer_through_the_local_agent(
        tmp_path, monkeypatch):
    """The agent's host env carries the width, ``TORCH_DEVICE=cpu``,
    the checkout on PYTHONPATH and ``python`` this interpreter, as
    phase 20 gives them; every status comes from ``agent.poll()``."""
    from dcos_commons_tpu_torch.offer import GpuHost
    from dcos_commons_tpu_torch.storage import FileWalPersister
    from test_torch_scheduler import PORT as SPORT
    from test_torch_scheduler import REPO, TRAINER_RELAUNCH, _render_with
    from test_torch_scheduler import wire

    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    shim = bin_dir / "python"
    shim.write_text(f'#!/bin/sh\nexec {shlex.quote(sys.executable)} "$@"\n')
    shim.chmod(0o755)
    for key, value in WIDTH.items():
        monkeypatch.setenv(key, value)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("PYTHONPATH", REPO)
    monkeypatch.delenv("KEEPALIVE_S", raising=False)
    frameworks = os.path.join(REPO, "dcos_commons_tpu_torch", "frameworks")
    spec = _render_with(SPORT, os.path.join(frameworks, "svc.yml"),
                        TRAINER_COUNT="1", TPU_CHIPS_PER_HOST="1",
                        TPU_TOPOLOGY="1x1", TRAIN_STEPS="2",
                        TORCH_FRAMEWORK_DIR=frameworks,
                        CHECKPOINT_DIR=str(tmp_path / "ckpt"),
                        TRAINER_CPUS="1", TRAINER_MEM="1024")
    agent = t_local.LocalProcessAgent(str(tmp_path / "agent"))
    polled = []
    poll = agent.poll
    agent.poll = lambda: [polled.append(s) or s for s in poll()]
    persister = FileWalPersister(str(tmp_path / "wal"))
    host = GpuHost(host_id="local", hostname="local", slice_id="local",
                   generation="h100", gpus=1, cpus=8.0, memory_mb=16384)
    sched = wire(SPORT, spec, persister, [host], agent)

    def cycles_until(done, timeout_s=60.0):
        end = time.monotonic() + timeout_s
        while not done():
            assert time.monotonic() < end, sorted(
                (n, p.get_status().name) for n, p in sched.plans().items())
            sched.run_cycle()
            assert not [s for s in polled
                        if s.state.name in ("FAILED", "ERROR", "LOST")], (
                polled, agent.sandbox_of("trainer-0-worker"))
            time.sleep(0.05)

    try:
        cycles_until(lambda: sched.plan("deploy").is_complete)
        info = sched.state_store.fetch_task("trainer-0-worker")
        assert any(s.task_id == info.task_id and s.state.name == "RUNNING"
                   for s in polled)
        assert info.env["CUDA_VISIBLE_DEVICES"] == "0"
        cycles_until(lambda: "kernel launches" in _stdout(agent, info))
        assert "step 1 loss=" in _stdout(agent, info)
        sched.plan("collectives").proceed()
        cycles_until(lambda: sched.plan("collectives").is_complete)
        killed = sched.restart_pod("trainer", 0)
        assert sorted(killed) == list(TRAINER_RELAUNCH)
        cycles_until(lambda: sched.state_store.fetch_task(
            info.name).task_id != info.task_id)
        again = sched.state_store.fetch_task(info.name)
        assert any(s.task_id == info.task_id and s.state.name == "KILLED"
                   for s in polled)
        cycles_until(lambda: _stdout(agent, info).count(
            "kernel launches") == 2)
        out = _stdout(agent, info)
        assert "restored checkpoint step 2" in out
        assert out.count("step 1 loss=") == 1
        assert again.env["CUDA_VISIBLE_DEVICES"] == "0"
        sched.stop()
        agent.kill(again.task_id, 1.0)
        end = time.monotonic() + 15
        while not any(s.task_id == again.task_id and s.state.is_terminal
                      for s in polled):
            assert time.monotonic() < end
            agent.poll()
            time.sleep(0.05)
    finally:
        agent.shutdown()
        persister.close()
    assert agent.active_task_ids() == set()

"""The Send/Expect tick vocabulary.

Reference: sdk/testing/.../SimulationTick.java:6 (marker interface),
Send* (SendOffer/SendTaskStatus builders) and the Expect catalogue
(Expect.java:47-631: declinedLastOffer, launchedTasks, taskKilled,
planStatus, stepStatus, recoveryStep, storedTaskEnv, samePod, ...).
Send ticks mutate the world then run one scheduler cycle (one pass of
the offer thread); Expect ticks assert and never advance the clock.

Port of ``dcos_commons_tpu/testing/ticks.py``, line for line but the imports; ``AddHost``
takes a ``GpuHost``.
"""

from __future__ import annotations

from typing import Optional

from dcos_commons_tpu_torch.common import TaskState, TaskStatus
from dcos_commons_tpu_torch.offer.inventory import GpuHost
from dcos_commons_tpu_torch.plan.status import Status
from dcos_commons_tpu_torch.testing.runner import SimulationWorld


class SimulationTick:
    def apply(self, world: SimulationWorld) -> None:
        raise NotImplementedError

    def describe(self) -> str:
        return type(self).__name__


class Send(SimulationTick):
    """Mutation tick: subclasses mutate, then one cycle runs."""

    def mutate(self, world: SimulationWorld) -> None:
        raise NotImplementedError

    def apply(self, world: SimulationWorld) -> None:
        self.mutate(world)
        world.scheduler.run_cycle()


class Expect(SimulationTick):
    """Assertion tick."""


# ---------------------------------------------------------------------------
# Send ticks
# ---------------------------------------------------------------------------


class AdvanceCycles(Send):
    """Run N scheduler cycles with no other stimulus (the reference's
    equivalent is sending an empty offer cycle)."""

    def __init__(self, n: int = 1):
        self.n = n

    def mutate(self, world: SimulationWorld) -> None:
        for _ in range(self.n - 1):
            world.scheduler.run_cycle()

    def describe(self) -> str:
        return f"AdvanceCycles({self.n})"


class SendStatus(Send):
    """Inject a TaskStatus for a task *name* (the current launch's id
    is resolved from the agent, or pass task_id explicitly).
    Reference: SendTaskStatus (SimulationTick)."""

    def __init__(
        self,
        task_name: str,
        state: TaskState,
        ready: bool = False,
        message: str = "",
        task_id: Optional[str] = None,
    ):
        self.task_name = task_name
        self.state = state
        self.ready = ready
        self.message = message
        self.task_id = task_id

    def mutate(self, world: SimulationWorld) -> None:
        task_id = self.task_id or world.agent.task_id_of(self.task_name)
        assert task_id is not None, f"no launch recorded for {self.task_name}"
        info = world.agent.task_info_of(self.task_name)
        world.agent.send(
            TaskStatus(
                task_id=task_id,
                state=self.state,
                ready=self.ready,
                message=self.message,
                agent_id=info.agent_id if info else "",
            )
        )

    def describe(self) -> str:
        return f"SendStatus({self.task_name}, {self.state.value})"


class SendTaskRunning(SendStatus):
    def __init__(self, task_name: str, ready: bool = True):
        super().__init__(task_name, TaskState.RUNNING, ready=ready)


class SendTaskFinished(SendStatus):
    def __init__(self, task_name: str):
        super().__init__(task_name, TaskState.FINISHED)


class SendTaskFailed(SendStatus):
    def __init__(self, task_name: str, message: str = "simulated crash"):
        super().__init__(task_name, TaskState.FAILED, message=message)


class AddHost(Send):
    def __init__(self, host: GpuHost):
        self.host = host

    def mutate(self, world: SimulationWorld) -> None:
        world.inventory.add_host(self.host)


class RemoveHost(Send):
    def __init__(self, host_id: str):
        self.host_id = host_id

    def mutate(self, world: SimulationWorld) -> None:
        world.inventory.remove_host(self.host_id)


class MarkHostDown(Send):
    def __init__(self, host_id: str):
        self.host_id = host_id

    def mutate(self, world: SimulationWorld) -> None:
        world.inventory.mark_down(self.host_id)


class MarkHostUp(Send):
    def __init__(self, host_id: str):
        self.host_id = host_id

    def mutate(self, world: SimulationWorld) -> None:
        world.inventory.mark_up(self.host_id)


class PreemptHost(Send):
    """Host preemption: the host's task processes die
    silently, then the scheduler is told (the operator verb / agent
    plane path) — tasks are stamped PERMANENTLY_FAILED and LOST, and
    a gang member's loss synthesizes the gang recovery plan."""

    def __init__(self, host_id: str):
        self.host_id = host_id

    def mutate(self, world: SimulationWorld) -> None:
        fail = getattr(world.agent, "fail_host", None)
        if callable(fail):
            fail(self.host_id)
        world.scheduler.preempt_host(self.host_id)

    def describe(self) -> str:
        return f"PreemptHost({self.host_id})"


class DrainHost(Send):
    """Maintenance drain: placement excludes the host immediately,
    serve backends surface draining, running work keeps running."""

    def __init__(self, host_id: str, window_s: float = 0.0):
        self.host_id = host_id
        self.window_s = window_s

    def mutate(self, world: SimulationWorld) -> None:
        world.scheduler.drain_host(self.host_id, window_s=self.window_s)

    def describe(self) -> str:
        return f"DrainHost({self.host_id})"


class HostUp(Send):
    """Clear preempted/maintenance/down marks (the `up` verb)."""

    def __init__(self, host_id: str):
        self.host_id = host_id

    def mutate(self, world: SimulationWorld) -> None:
        world.scheduler.undrain_host(self.host_id)

    def describe(self) -> str:
        return f"HostUp({self.host_id})"


class _PlanVerb(Send):
    """Plan lifecycle verbs (reference: PlansQueries.java:47-231)."""

    def __init__(self, plan_name: str, phase: Optional[str] = None,
                 step: Optional[str] = None):
        self.plan_name = plan_name
        self.phase = phase
        self.step = step

    def _target(self, world: SimulationWorld):
        plan = world.scheduler.plan(self.plan_name)
        assert plan is not None, f"no plan {self.plan_name}"
        if self.phase is None:
            return plan
        phase = plan.phase(self.phase)
        assert phase is not None, f"no phase {self.phase}"
        if self.step is None:
            return phase
        step = phase.step(self.step) if hasattr(phase, "step") else None
        if step is None:
            for s in phase.steps:
                if s.name == self.step:
                    step = s
        assert step is not None, f"no step {self.step}"
        return step

    def describe(self) -> str:
        return f"{type(self).__name__}({self.plan_name})"


class PlanInterrupt(_PlanVerb):
    def mutate(self, world: SimulationWorld) -> None:
        self._target(world).interrupt()


class PlanContinue(_PlanVerb):
    def mutate(self, world: SimulationWorld) -> None:
        self._target(world).proceed()


class PlanRestart(_PlanVerb):
    def mutate(self, world: SimulationWorld) -> None:
        self._target(world).restart()


class PlanForceComplete(_PlanVerb):
    def mutate(self, world: SimulationWorld) -> None:
        self._target(world).force_complete()


class PlanStart(_PlanVerb):
    """Kick an interrupted sidecar plan: restart + proceed, matching
    the HTTP verb (reference: PlansQueries.start)."""

    def mutate(self, world: SimulationWorld) -> None:
        target = self._target(world)
        target.restart()
        target.proceed()


# ---------------------------------------------------------------------------
# Expect ticks
# ---------------------------------------------------------------------------


class ExpectLaunchedTasks(Expect):
    """The launches since the last ExpectLaunchedTasks/ExpectNoLaunches
    are exactly these task names (reference: Expect.launchedTasks)."""

    def __init__(self, *task_names: str):
        self.task_names = set(task_names)

    def apply(self, world: SimulationWorld) -> None:
        new = world.new_launches()
        names = {i.name for i in new}
        assert names == self.task_names, (
            f"expected launches {sorted(self.task_names)}, got {sorted(names)}"
        )
        world.launch_watermark = len(world.agent.launched)

    def describe(self) -> str:
        return f"ExpectLaunchedTasks({sorted(self.task_names)})"


class ExpectNoLaunches(Expect):
    def apply(self, world: SimulationWorld) -> None:
        new = world.new_launches()
        assert not new, f"unexpected launches: {[i.name for i in new]}"


class ExpectTaskKilled(Expect):
    def __init__(self, task_name: str):
        self.task_name = task_name

    def apply(self, world: SimulationWorld) -> None:
        from dcos_commons_tpu_torch.common import task_name_of

        new = world.new_kills()
        names = set()
        for task_id in new:
            try:
                names.add(task_name_of(task_id))
            except ValueError:
                pass
        assert self.task_name in names, (
            f"expected kill of {self.task_name}, kills={sorted(names)}"
        )
        world.kill_watermark = len(world.agent.kills)

    def describe(self) -> str:
        return f"ExpectTaskKilled({self.task_name})"


class ExpectTaskNotKilled(Expect):
    def __init__(self, task_name: str):
        self.task_name = task_name

    def apply(self, world: SimulationWorld) -> None:
        assert self.task_name not in world.agent.killed_names(), (
            f"{self.task_name} was killed"
        )


class ExpectPlanStatus(Expect):
    def __init__(self, plan_name: str, status: Status):
        self.plan_name = plan_name
        self.status = status

    def apply(self, world: SimulationWorld) -> None:
        plan = world.scheduler.plan(self.plan_name)
        assert plan is not None, f"no plan {self.plan_name}"
        actual = plan.get_status()
        assert actual is self.status, (
            f"plan {self.plan_name}: expected {self.status.value}, "
            f"got {actual.value}"
        )

    def describe(self) -> str:
        return f"ExpectPlanStatus({self.plan_name}={self.status.value})"


class ExpectStepStatus(Expect):
    def __init__(self, plan_name: str, phase_name: str, step_name: str,
                 status: Status):
        self.plan_name = plan_name
        self.phase_name = phase_name
        self.step_name = step_name
        self.status = status

    def apply(self, world: SimulationWorld) -> None:
        plan = world.scheduler.plan(self.plan_name)
        assert plan is not None, f"no plan {self.plan_name}"
        step = plan.step(self.phase_name, self.step_name)
        assert step is not None, (
            f"no step {self.phase_name}/{self.step_name} in {self.plan_name}"
        )
        actual = step.get_status()
        assert actual is self.status, (
            f"step {self.step_name}: expected {self.status.value}, "
            f"got {actual.value}"
        )

    def describe(self) -> str:
        return (
            f"ExpectStepStatus({self.plan_name}/{self.phase_name}/"
            f"{self.step_name}={self.status.value})"
        )


class ExpectDeploymentComplete(Expect):
    def apply(self, world: SimulationWorld) -> None:
        plan = world.scheduler.deploy_manager.get_plan()
        assert plan.is_complete, (
            f"deploy plan is {plan.get_status().value}"
        )


class ExpectAllPlansComplete(Expect):
    def apply(self, world: SimulationWorld) -> None:
        for name, plan in world.scheduler.plans().items():
            assert plan.is_complete, f"plan {name} is {plan.get_status().value}"


class ExpectRecoveryStep(Expect):
    """The recovery plan currently contains a step covering this pod
    instance (reference: Expect.recoveryStep)."""

    def __init__(self, asset: str, present: bool = True):
        self.asset = asset
        self.present = present

    def apply(self, world: SimulationWorld) -> None:
        plan = world.scheduler.recovery_manager.get_plan()
        assets = set()
        for step in plan.all_steps():
            assets |= step.get_asset_names()
        if self.present:
            assert self.asset in assets, (
                f"no recovery step for {self.asset}; recovery assets={assets}"
            )
        else:
            assert self.asset not in assets, (
                f"unexpected recovery step for {self.asset}"
            )

    def describe(self) -> str:
        return f"ExpectRecoveryStep({self.asset}, present={self.present})"


class ExpectTaskEnv(Expect):
    """The stored/launched TaskInfo for a task carries this env var
    (reference: Expect.storedTaskEnv)."""

    def __init__(self, task_name: str, key: str, value: Optional[str] = None):
        self.task_name = task_name
        self.key = key
        self.value = value

    def apply(self, world: SimulationWorld) -> None:
        info = world.agent.task_info_of(self.task_name)
        if info is None:
            info = world.state_store.fetch_task(self.task_name)
        assert info is not None, f"no TaskInfo for {self.task_name}"
        assert self.key in info.env, (
            f"{self.task_name} env lacks {self.key}; keys={sorted(info.env)}"
        )
        if self.value is not None:
            assert info.env[self.key] == self.value, (
                f"{self.task_name} env[{self.key}]={info.env[self.key]!r}, "
                f"expected {self.value!r}"
            )

    def describe(self) -> str:
        return f"ExpectTaskEnv({self.task_name}, {self.key})"


class ExpectTaskStateStored(Expect):
    def __init__(self, task_name: str, state: TaskState):
        self.task_name = task_name
        self.state = state

    def apply(self, world: SimulationWorld) -> None:
        status = world.state_store.fetch_status(self.task_name)
        assert status is not None, f"no status for {self.task_name}"
        assert status.state is self.state, (
            f"{self.task_name}: stored {status.state.value}, "
            f"expected {self.state.value}"
        )

    def describe(self) -> str:
        return f"ExpectTaskStateStored({self.task_name}={self.state.value})"


class ExpectReservationCount(Expect):
    def __init__(self, count: int):
        self.count = count

    def apply(self, world: SimulationWorld) -> None:
        actual = len(world.scheduler.ledger.all())
        assert actual == self.count, (
            f"expected {self.count} reservations, ledger has {actual}"
        )

    def describe(self) -> str:
        return f"ExpectReservationCount({self.count})"


class ExpectDistinctHosts(Expect):
    """Placement assertion: these tasks landed on pairwise-distinct
    hosts (reference: Expect.samePod inverse)."""

    def __init__(self, *task_names: str):
        self.task_names = task_names

    def apply(self, world: SimulationWorld) -> None:
        hosts = []
        for name in self.task_names:
            info = world.agent.task_info_of(name)
            assert info is not None, f"no launch for {name}"
            hosts.append(info.agent_id)
        assert len(set(hosts)) == len(hosts), (
            f"expected distinct hosts, got {dict(zip(self.task_names, hosts))}"
        )


class ExpectSameHost(Expect):
    def __init__(self, *task_names: str):
        self.task_names = task_names

    def apply(self, world: SimulationWorld) -> None:
        hosts = set()
        for name in self.task_names:
            info = world.agent.task_info_of(name)
            assert info is not None, f"no launch for {name}"
            hosts.add(info.agent_id)
        assert len(hosts) == 1, (
            f"expected colocated tasks, hosts={hosts}"
        )


class ExpectDeclined(Expect):
    """The last evaluated requirement failed to place (reference:
    Expect.declinedLastOffer) — asserted via the offer outcome
    tracker's most recent record."""

    def __init__(self, requirement_fragment: str = ""):
        self.fragment = requirement_fragment

    def apply(self, world: SimulationWorld) -> None:
        records = world.scheduler.outcome_tracker.to_json()
        assert records, "no offer evaluations recorded"
        last = records[-1]
        assert not last["passed"], (
            f"last evaluation passed: {last['requirement']}"
        )
        if self.fragment:
            assert self.fragment in last["requirement"], (
                f"last declined requirement {last['requirement']!r} does not "
                f"match {self.fragment!r}"
            )

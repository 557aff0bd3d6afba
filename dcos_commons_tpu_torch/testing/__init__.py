"""Simulation test harness: full scheduler stack, no processes, no fleet.

Rebuild of the reference's `sdk/testing/` simulation harness
(reference: sdk/testing/.../ServiceTestRunner.java:38,
SimulationTick.java:6, Expect.java:47-631): boot the *entire* scheduler
(builder -> config update -> plans -> offer evaluation -> launch WAL)
against a MemPersister and a scripted FakeAgent, then drive it with
tick sequences -- `Send*` mutations followed by one scheduler cycle,
`Expect*` assertions over the observable state.  Scheduler restarts
are simulated by rebuilding the runner over the same persister, just
as the reference rebuilds ServiceTestRunner over one MemPersister
(ServiceTest.java:57-77).

Port of ``dcos_commons_tpu/testing/__init__.py``, line for line but the
imports: the scripted ``FakeAgent``, ``drive_until``, the simulation
runner and its ticks over a default fleet of ``GpuHost``s.  The
process harness (``testing/integration.py``) and the diagnostics
bundle (``testing/diagnostics.py``) are exported too, loaded on first
use.
"""

from dcos_commons_tpu_torch.testing.fake_agent import FakeAgent


def drive_until(scheduler, predicate, timeout_s: float = 30.0,
                interval_s: float = 0.05) -> bool:
    """Run real scheduler cycles until ``predicate()`` is truthy.

    The shared poll loop for tests that drive a scheduler against a
    REAL agent (process launches) rather than scripted ticks."""
    import time as _time

    deadline = _time.monotonic() + timeout_s
    while _time.monotonic() < deadline:
        scheduler.run_cycle()
        if predicate():
            return True
        _time.sleep(interval_s)
    return False
from dcos_commons_tpu_torch.testing.runner import (
    ServiceTestRunner,
    SimulationWorld,
    cosmos_render,
)
from dcos_commons_tpu_torch.testing.ticks import (
    AddHost,
    AdvanceCycles,
    Expect,
    ExpectAllPlansComplete,
    ExpectDeclined,
    ExpectDeploymentComplete,
    ExpectDistinctHosts,
    ExpectLaunchedTasks,
    ExpectNoLaunches,
    ExpectPlanStatus,
    ExpectRecoveryStep,
    ExpectReservationCount,
    ExpectSameHost,
    ExpectStepStatus,
    ExpectTaskEnv,
    ExpectTaskKilled,
    ExpectTaskNotKilled,
    ExpectTaskStateStored,
    DrainHost,
    HostUp,
    MarkHostDown,
    MarkHostUp,
    PreemptHost,
    PlanContinue,
    PlanForceComplete,
    PlanInterrupt,
    PlanRestart,
    PlanStart,
    RemoveHost,
    Send,
    SendStatus,
    SendTaskFailed,
    SendTaskFinished,
    SendTaskRunning,
    SimulationTick,
)

__all__ = [
    "FakeAgent",
    "drive_until",
    "ServiceTestRunner",
    "cosmos_render",
    "SimulationWorld",
    "SimulationTick",
    "Send",
    "Expect",
    "SendStatus",
    "SendTaskRunning",
    "SendTaskFinished",
    "SendTaskFailed",
    "AddHost",
    "RemoveHost",
    "DrainHost",
    "HostUp",
    "MarkHostDown",
    "MarkHostUp",
    "PreemptHost",
    "AdvanceCycles",
    "PlanInterrupt",
    "PlanContinue",
    "PlanRestart",
    "PlanStart",
    "PlanForceComplete",
    "ExpectLaunchedTasks",
    "ExpectNoLaunches",
    "ExpectTaskKilled",
    "ExpectTaskNotKilled",
    "ExpectPlanStatus",
    "ExpectStepStatus",
    "ExpectDeploymentComplete",
    "ExpectAllPlansComplete",
    "ExpectRecoveryStep",
    "ExpectTaskEnv",
    "ExpectTaskStateStored",
    "ExpectReservationCount",
    "ExpectDistinctHosts",
    "ExpectSameHost",
    "ExpectDeclined",
    "AgentProcess",
    "SchedulerProcess",
    "ServiceClient",
    "WaitTimeout",
    "wait_for",
    "start_state_server",
    "promote_state_server",
    "reap_orphan_tasks",
    "dump_bundle",
]

_INTEGRATION = (
    "AgentProcess", "SchedulerProcess", "ServiceClient", "WaitTimeout",
    "wait_for", "start_state_server", "promote_state_server",
    "reap_orphan_tasks",
)


def __getattr__(name):
    # the process harness spawns servers over HTTP; import it lazily so
    # the simulation harness stays light
    if name in _INTEGRATION:
        from dcos_commons_tpu_torch.testing import integration

        return getattr(integration, name)
    if name == "dump_bundle":
        from dcos_commons_tpu_torch.testing.diagnostics import dump_bundle

        return dump_bundle
    raise AttributeError(name)

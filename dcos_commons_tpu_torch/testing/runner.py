"""ServiceTestRunner: boot the full scheduler stack and script it.

Reference: sdk/testing/.../ServiceTestRunner.java:38 — loads the real
service YAML (with env overrides), runs SchedulerBuilder against a
MemPersister and a mocked driver, then processes SimulationTicks.
Restart simulation: build a second runner over the same persister
(ServiceTest.java:57-77); the plans must resume mid-step.

Port of ``dcos_commons_tpu/testing/runner.py``, line for line but the imports; the default fleet
is three ``GpuHost``s.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from dcos_commons_tpu_torch.offer.inventory import SliceInventory, GpuHost
from dcos_commons_tpu_torch.scheduler.builder import SchedulerBuilder
from dcos_commons_tpu_torch.scheduler.config import SchedulerConfig
from dcos_commons_tpu_torch.scheduler.scheduler import DefaultScheduler
from dcos_commons_tpu_torch.specification.specs import ServiceSpec
from dcos_commons_tpu_torch.specification.yaml_spec import from_yaml
from dcos_commons_tpu_torch.storage import MemPersister, Persister
from dcos_commons_tpu_torch.testing.fake_agent import FakeAgent


@dataclass
class SimulationWorld:
    """Everything a tick can see/touch (reference: ClusterState +
    the runner internals Expect closures capture)."""

    scheduler: DefaultScheduler
    agent: FakeAgent
    inventory: SliceInventory
    persister: Persister
    # index into agent.launched already consumed by ExpectLaunchedTasks
    launch_watermark: int = 0
    # index into agent.kills already consumed by ExpectTaskKilled
    kill_watermark: int = 0
    extras: Dict[str, object] = field(default_factory=dict)

    @property
    def state_store(self):
        return self.scheduler.state_store

    def new_launches(self):
        return self.agent.launched[self.launch_watermark:]

    def new_kills(self):
        return self.agent.kills[self.kill_watermark:]


def cosmos_render(
    framework_dir: str,
    options: Optional[Dict] = None,
) -> Dict[str, str]:
    """CosmosRenderer analogue (sdk/testing/.../CosmosRenderer.java:24):
    render a framework's options.json defaults + user options into the
    env map its svc.yml interpolates, exactly as a package install
    would.  ServiceTest-style tests run from package options::

        env = cosmos_render("frameworks/helloworld",
                            {"world": {"count": 3}})
        runner = ServiceTestRunner(yaml_text, env=env)

    Raises tools.options.OptionsError on bad options — so a test can
    also assert that an invalid option set is rejected."""
    from dcos_commons_tpu_torch.tools.options import load_schema, render_options

    return render_options(load_schema(framework_dir), options)


class ServiceTestRunner:
    """Builds a scheduler from YAML/spec over a (shared) persister and
    runs scripted ticks against it synchronously."""

    def __init__(
        self,
        yaml_text: Optional[str] = None,
        spec: Optional[ServiceSpec] = None,
        hosts: Optional[List[GpuHost]] = None,
        persister: Optional[Persister] = None,
        scheduler_config: Optional[SchedulerConfig] = None,
        env: Optional[Dict[str, str]] = None,
        builder_hook=None,
    ):
        if spec is None:
            if yaml_text is None:
                raise ValueError("need yaml_text or spec")
            spec = from_yaml(yaml_text, env=env)
        self.spec = spec
        self.hosts = hosts if hosts is not None else [
            GpuHost(host_id=f"host-{i}") for i in range(3)
        ]
        self.persister = persister or MemPersister()
        # sim cycles run in microseconds: the revive token bucket would
        # throttle ordinary serial-deploy step boundaries that take
        # seconds of wall clock in production.  Tests of the throttle
        # itself install their own bucket.
        self.config = scheduler_config or SchedulerConfig(
            backoff_enabled=False, revive_capacity=1_000_000
        )
        self._builder_hook = builder_hook
        self.agent = FakeAgent()
        self.inventory = SliceInventory(self.hosts)
        self.world: Optional[SimulationWorld] = None

    def build(self) -> SimulationWorld:
        builder = SchedulerBuilder(self.spec, self.config, self.persister)
        builder.set_inventory(self.inventory)
        builder.set_agent(self.agent)
        if self._builder_hook is not None:
            self._builder_hook(builder)
        scheduler = builder.build()
        self.world = SimulationWorld(
            scheduler=scheduler,
            agent=self.agent,
            inventory=self.inventory,
            persister=self.persister,
            # watermarks start at "now": a restarted runner shares the
            # agent with its predecessor and must not re-observe old
            # launches/kills
            launch_watermark=len(self.agent.launched),
            kill_watermark=len(self.agent.kills),
        )
        return self.world

    def run(self, ticks: Sequence) -> SimulationWorld:
        """Process ticks in order.  The scheduler is built lazily on
        first use so a runner can be primed (hosts added, etc.) before
        the config-update pass runs."""
        world = self.world or self.build()
        for i, tick in enumerate(ticks):
            try:
                tick.apply(world)
            except AssertionError as e:
                raise AssertionError(
                    f"tick[{i}] {tick.describe()}: {e}\n{_dump(world)}"
                ) from e
        return world

    def restart(self) -> "ServiceTestRunner":
        """Simulate a scheduler process restart: same persister and
        fleet, same agent (tasks keep running), fresh scheduler."""
        runner = ServiceTestRunner(
            spec=self.spec,
            hosts=self.hosts,
            persister=self.persister,
            scheduler_config=self.config,
            builder_hook=self._builder_hook,
        )
        runner.agent = self.agent
        runner.inventory = self.inventory
        return runner


def _dump(world: SimulationWorld) -> str:
    """Debug dump appended to every failed Expect (reference: the
    harness logs plan trees on failure)."""
    lines = ["--- simulation state ---"]
    for name, plan in world.scheduler.plans().items():
        lines.append(f"plan {name}: {plan.get_status().value}")
        for phase in plan.phases:
            lines.append(f"  phase {phase.name}: {phase.get_status().value}")
            for step in phase.steps:
                lines.append(f"    step {step.name}: {step.get_status().value}")
    lines.append(f"launched: {[i.name for i in world.agent.launched]}")
    lines.append(f"kills: {world.agent.kills}")
    statuses = {
        n: s.state.value for n, s in world.state_store.fetch_statuses().items()
    }
    lines.append(f"stored statuses: {statuses}")
    return "\n".join(lines)

"""L2 plan engine: Plan -> Phase -> Step state machines + strategies.

Reference: sdk/scheduler/.../scheduler/plan/ — Element.java:18,
Plan.java:23, Phase.java:12, Step.java:15, Status.java:23-78,
DefaultPlanCoordinator.java:33-90, PlanScheduler.java:50-100,
DeploymentStep.java:122-193, strategy/ (SerialStrategy,
ParallelStrategy, CanaryStrategy.java:30-58, DependencyStrategy,
RandomStrategy), backoff/ExponentialBackoff.java:30-50.

Port of ``dcos_commons_tpu/plan/__init__.py``.
"""

from dcos_commons_tpu_torch.plan.status import Status
from dcos_commons_tpu_torch.plan.element import Element
from dcos_commons_tpu_torch.plan.step import DeploymentStep, PodInstanceRequirement, RecoveryType, Step
from dcos_commons_tpu_torch.plan.phase import Phase
from dcos_commons_tpu_torch.plan.plan import Plan
from dcos_commons_tpu_torch.plan.strategy import (
    CanaryStrategy,
    DependencyStrategy,
    ParallelStrategy,
    RandomStrategy,
    SerialStrategy,
    Strategy,
    strategy_for_name,
)
from dcos_commons_tpu_torch.plan.backoff import Backoff, DisabledBackoff, ExponentialBackoff
from dcos_commons_tpu_torch.plan.plan_manager import DefaultPlanManager, PlanManager
from dcos_commons_tpu_torch.plan.coordinator import DefaultPlanCoordinator
from dcos_commons_tpu_torch.plan.builders import DeployPlanFactory
from dcos_commons_tpu_torch.plan.generator import PlanGenerator

__all__ = [
    "Backoff",
    "CanaryStrategy",
    "DefaultPlanCoordinator",
    "DefaultPlanManager",
    "DependencyStrategy",
    "DeployPlanFactory",
    "DeploymentStep",
    "DisabledBackoff",
    "Element",
    "ExponentialBackoff",
    "ParallelStrategy",
    "Phase",
    "Plan",
    "PlanGenerator",
    "PlanManager",
    "PodInstanceRequirement",
    "RandomStrategy",
    "RecoveryType",
    "SerialStrategy",
    "Status",
    "Step",
    "Strategy",
    "strategy_for_name",
]

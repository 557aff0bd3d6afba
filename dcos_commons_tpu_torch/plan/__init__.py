"""L2 plan engine, the part the offer evaluator needs (port of
``dcos_commons_tpu/plan/``: status, element, backoff and step; phases,
plans, strategies, the coordinator and the generators come with the
deploy plan).

Reference: sdk/scheduler/.../scheduler/plan/ — Element.java:18,
Step.java:15, Status.java:23-78, DeploymentStep.java:122-193,
backoff/ExponentialBackoff.java:30-50.
"""

from dcos_commons_tpu_torch.plan.status import Status
from dcos_commons_tpu_torch.plan.element import Element
from dcos_commons_tpu_torch.plan.step import (
    DeploymentStep,
    PodInstanceRequirement,
    RecoveryType,
    Step,
)
from dcos_commons_tpu_torch.plan.backoff import (
    Backoff,
    DisabledBackoff,
    ExponentialBackoff,
)

__all__ = [
    "Backoff",
    "DeploymentStep",
    "DisabledBackoff",
    "Element",
    "ExponentialBackoff",
    "PodInstanceRequirement",
    "RecoveryType",
    "Status",
    "Step",
]

"""L4 specification: typed object model of a service + YAML front end
(port of ``dcos_commons_tpu/specification``).

Reference: sdk/scheduler/.../specification/ (ServiceSpec/PodSpec/
TaskSpec/ResourceSpec interfaces, DefaultServiceSpec.java) and
specification/yaml/ (RawServiceSpec beans, TemplateUtils mustache
rendering, YAMLToInternalMappers.java, 805 LoC).

GPU port: the resource vocabulary has a pod-level ``gpu:`` block
({generation, chips_per_host, topology, ...}, :class:`GpuSpec`) where the
JAX package has its ``tpu:`` block, and pods keep ``gang: true`` for
gang-wide scheduling.  The offer side (the inventory, the NVLink node as
the placement unit, admission, the launch path) is not ported yet.
"""

from dcos_commons_tpu_torch.specification.specs import (
    GoalState,
    GpuSpec,
    HealthCheckSpec,
    PodSpec,
    PortSpec,
    ReadinessCheckSpec,
    ReplacementFailurePolicy,
    ResourceSpec,
    ServiceSpec,
    SpecError,
    TaskSpec,
    UriSpec,
    VolumeSpec,
)
from dcos_commons_tpu_torch.specification.yaml_spec import (
    from_yaml,
    from_yaml_file,
    render_template,
)
from dcos_commons_tpu_torch.specification.validation import (
    ConfigValidationError,
    default_validators,
    validate_spec_change,
)

__all__ = [
    "ConfigValidationError",
    "GoalState",
    "GpuSpec",
    "HealthCheckSpec",
    "PodSpec",
    "PortSpec",
    "ReadinessCheckSpec",
    "ReplacementFailurePolicy",
    "ResourceSpec",
    "ServiceSpec",
    "SpecError",
    "TaskSpec",
    "UriSpec",
    "VolumeSpec",
    "default_validators",
    "from_yaml",
    "from_yaml_file",
    "render_template",
    "validate_spec_change",
]

"""Worker-side step telemetry (``steplog``).  The scheduler-side
tracing of the JAX package's ``trace/`` (spans, flight recorder,
exporters) belongs to the control plane and is not ported."""

from dcos_commons_tpu_torch.trace.steplog import (
    STEPLOG_NAME,
    InflightWindow,
    StepLog,
    read_steplog,
)

__all__ = ["STEPLOG_NAME", "InflightWindow", "StepLog", "read_steplog"]

"""Tracing: worker-side step telemetry (``steplog``), the control
plane's spans and flight recorder (``span``, ``recorder``; ports of the
JAX package's, which the offer evaluator records into) and their
exporters (``export``: plain text and Chrome trace JSON, served at
``GET /v1/debug/trace``), and the serving path's profiler ranges
(``ranges``: ``profiled``, read from a device trace)."""

from dcos_commons_tpu_torch.trace.export import chrome_json, to_chrome, to_text
from dcos_commons_tpu_torch.trace.recorder import (
    NULL_TRACER,
    LaunchRef,
    TraceRecorder,
)
from dcos_commons_tpu_torch.trace.ranges import profiled
from dcos_commons_tpu_torch.trace.span import NullSpan, Span
from dcos_commons_tpu_torch.trace.steplog import (
    STEPLOG_NAME,
    InflightWindow,
    StepLog,
    read_steplog,
)

__all__ = [
    "NULL_TRACER",
    "STEPLOG_NAME",
    "InflightWindow",
    "LaunchRef",
    "NullSpan",
    "Span",
    "StepLog",
    "TraceRecorder",
    "chrome_json",
    "profiled",
    "read_steplog",
    "to_chrome",
    "to_text",
]

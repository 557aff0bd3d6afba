"""X3: metrics — counters, gauges, Prometheus text exposition.

Reference: sdk/scheduler/.../metrics/Metrics.java:26-97 (Dropwizard
registry, StatsD push, Prometheus + codahale scrape endpoints; offer/
revive/decline/suppress/operation/status counters) and
PlanReporter.java (per-plan status gauges).
"""

from dcos_commons_tpu_torch.metrics.registry import (
    MetricHistory,
    Metrics,
    prometheus_name,
)

__all__ = ["MetricHistory", "Metrics", "prometheus_name"]

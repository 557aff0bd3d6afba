"""X9: the fleet health plane — metric history, event journal,
anomaly detectors.

Traceview (X4) answers "what just happened"; this package retains and
judges: bounded metric history rings (metrics/registry.py
MetricHistory) behind ``GET /v1/debug/health``, a durable
capacity-bounded event journal (operator verbs, plan transitions,
failovers, admission rejections, recovery actions, detector alerts)
behind ``GET /v1/debug/events?since=``, and per-cycle detectors —
straggler median-ratio scoring off merged steplogs, serving-SLO
watchers off the engine gauges, lease-churn watching off ha.* — whose
suspect-host output feeds placement as a soft sort-last signal.

The action engine closes the loop (health/actions.py): detector
episodes now drive audited, flap-proof, operator-interruptible
ACTIONS — SLO-breach scale-out, quiet-pod scale-in through the
decommission step family with a pre-kill router drain, and general
straggler remediation — all riding the plan engine and seeded from
the replayed journal across failovers.

Port of ``dcos_commons_tpu/health/__init__.py``, line for line but the imports.
"""

from dcos_commons_tpu_torch.health.actions import (
    ActionPolicy,
    HealthActionEngine,
    decide,
    remediation_allowed,
    scale_out_target,
    seed_latches,
)
from dcos_commons_tpu_torch.health.detectors import (
    LeaseChurnWatcher,
    QuietPodWatcher,
    ServingSloWatcher,
    StragglerDetector,
    median_ratio_scores,
)
from dcos_commons_tpu_torch.health.journal import (
    EventJournal,
    PersisterBackend,
    StatePropertyBackend,
)
from dcos_commons_tpu_torch.health.monitor import HealthMonitor

__all__ = [
    "ActionPolicy",
    "EventJournal",
    "HealthActionEngine",
    "HealthMonitor",
    "LeaseChurnWatcher",
    "PersisterBackend",
    "QuietPodWatcher",
    "ServingSloWatcher",
    "StatePropertyBackend",
    "StragglerDetector",
    "decide",
    "median_ratio_scores",
    "remediation_allowed",
    "scale_out_target",
    "seed_latches",
]

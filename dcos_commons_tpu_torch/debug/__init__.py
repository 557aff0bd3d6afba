"""X3: debug introspection — the "explain why" trackers.

Reference: sdk/scheduler/.../debug/ — OfferOutcomeTrackerV2 (ring
buffer of per-offer per-stage pass/fail reasons, fed from
OfferEvaluator.java:193-241, served at /v1/debug/offers),
PlansTracker, TaskStatusesTracker, TaskReservationsTracker.
SURVEY.md section 5.1 calls this the single most operator-loved
feature; it is first-class here.

Port of ``dcos_commons_tpu/debug/__init__.py``,
line for line but the imports.
"""

from dcos_commons_tpu_torch.debug.trackers import (
    OfferOutcomeTracker,
    PlansTracker,
    TaskReservationsTracker,
    TaskStatusesTracker,
)

__all__ = [
    "OfferOutcomeTracker",
    "PlansTracker",
    "TaskReservationsTracker",
    "TaskStatusesTracker",
]

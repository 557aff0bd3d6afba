"""Plan element status machine.

Reference: scheduler/plan/Status.java:23-78 — the full vocabulary
including the WAITING (operator interrupt) and DELAYED (launch
backoff) caveats called out in SURVEY.md section 7 hard part 5.

Port of ``dcos_commons_tpu/plan/status.py``,
line for line but the imports.
"""

from __future__ import annotations

import enum
from typing import Iterable


class Status(enum.Enum):
    ERROR = "ERROR"            # element has errors (bad spec / failed update)
    WAITING = "WAITING"        # operator interrupted; will not be offered work
    PENDING = "PENDING"        # no work started
    PREPARED = "PREPARED"      # placement evaluated, ops generated
    STARTING = "STARTING"      # tasks launched, awaiting RUNNING
    STARTED = "STARTED"        # tasks RUNNING, awaiting readiness/goal
    COMPLETE = "COMPLETE"      # goal reached
    IN_PROGRESS = "IN_PROGRESS"  # aggregate: some children done, some not
    DELAYED = "DELAYED"        # launch backoff after crash-loop

    @property
    def is_complete(self) -> bool:
        return self is Status.COMPLETE

    @property
    def is_running(self) -> bool:
        """Work actively underway (reference: Status.isRunning)."""
        return self in (
            Status.PREPARED,
            Status.STARTING,
            Status.STARTED,
            Status.IN_PROGRESS,
        )

    @property
    def is_working(self) -> bool:
        """Eligible for or doing work: not terminal, not parked."""
        return self in (
            Status.PENDING,
            Status.PREPARED,
            Status.STARTING,
            Status.STARTED,
            Status.IN_PROGRESS,
            Status.DELAYED,
        )


def aggregate(child_statuses: Iterable[Status], interrupted: bool = False) -> Status:
    """Roll child statuses up to a parent element.

    Reference: the aggregation rules in PlanUtils/Element.getStatus:
    ERROR dominates; all-complete is COMPLETE; an interrupt — the
    parent's own or ANY child's — shows WAITING while incomplete (the
    operator who parked a step must see it in ``plan show``, not a
    parent claiming IN_PROGRESS while nothing can move; plancheck's
    ``interrupt-visible`` invariant found the old child-WAITING-
    behind-IN_PROGRESS/DELAYED masking with a two-event trace);
    untouched is PENDING; otherwise IN_PROGRESS, with DELAYED
    surfaced when nothing else is moving.

    Every clause is an any()/all() over the multiset, so the result
    is permutation-invariant by construction — plancheck's
    ``aggregate-consistent`` invariant and the hypothesis property
    test (tests/test_plan_properties.py) both pin that down.
    """
    statuses = list(child_statuses)
    if not statuses:
        return Status.COMPLETE
    if any(s is Status.ERROR for s in statuses):
        return Status.ERROR
    if all(s is Status.COMPLETE for s in statuses):
        return Status.COMPLETE
    if interrupted or any(s is Status.WAITING for s in statuses):
        return Status.WAITING
    if all(s is Status.PENDING for s in statuses):
        return Status.PENDING
    moving = [s for s in statuses if s.is_running]
    if not moving and any(s is Status.DELAYED for s in statuses):
        return Status.DELAYED
    return Status.IN_PROGRESS

"""Debug trackers backing /v1/debug/*.

Reference: debug/OfferOutcomeTrackerV2.java (ring buffer of evaluation
outcomes), debug/PlansTracker.java, debug/TaskStatusesTracker.java,
debug/TaskReservationsTracker.java.

Port of ``dcos_commons_tpu/debug/trackers.py``,
line for line but the imports.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List

from dcos_commons_tpu_torch.offer.outcome import EvaluationOutcome


class OfferOutcomeTracker:
    """Ring buffer of per-requirement evaluation outcomes."""

    def __init__(self, capacity: int = 100):
        self._buffer = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()

    def record(self, requirement_name: str, outcome: EvaluationOutcome) -> None:
        with self._lock:
            self._buffer.append(
                {
                    "timestamp": time.time(),
                    "requirement": requirement_name,
                    "passed": outcome.passed,
                    "outcome": outcome.to_dict(),
                    "explanation": outcome.flatten(),
                }
            )

    def to_json(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._buffer)


class PlansTracker:
    """Serialized view of every plan tree (reference: PlansTracker)."""

    def __init__(self, scheduler):
        self._scheduler = scheduler

    def to_json(self) -> Dict[str, Any]:
        out = {}
        for name, plan in self._scheduler.plans().items():
            out[name] = serialize_plan(plan)
        return out


class TaskStatusesTracker:
    def __init__(self, state_store):
        self._state_store = state_store

    def to_json(self) -> List[Dict[str, Any]]:
        out = []
        for name, status in sorted(self._state_store.fetch_statuses().items()):
            out.append(
                {
                    "name": name,
                    "task_id": status.task_id,
                    "state": status.state.value,
                    "ready": status.ready,
                    "message": status.message,
                    "agent_id": status.agent_id,
                }
            )
        return out


class TaskReservationsTracker:
    def __init__(self, ledger):
        self._ledger = ledger

    def to_json(self) -> List[Dict[str, Any]]:
        return [r.to_dict() for r in self._ledger.all()]


def serialize_plan(plan) -> Dict[str, Any]:
    # plan-level errors aggregate every element's (reference:
    # PlansQueries surfacing step errors in the plan body — the
    # operator must see WHY a step is ERROR without spelunking)
    errors = list(plan.errors)
    for phase in plan.phases:
        errors.extend(phase.errors)
        for step in phase.steps:
            errors.extend(step.errors)
    return {
        "name": plan.name,
        "status": plan.get_status().value,
        "errors": errors,
        "phases": [
            {
                "id": phase.id,
                "name": phase.name,
                "status": phase.get_status().value,
                "steps": [
                    {
                        "id": step.id,
                        "name": step.name,
                        "status": step.get_status().value,
                        "assets": sorted(step.get_asset_names()),
                    }
                    for step in phase.steps
                ],
            }
            for phase in plan.phases
        ],
    }

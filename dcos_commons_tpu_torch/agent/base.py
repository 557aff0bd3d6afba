"""Agent contract between the scheduler and host-local executors.

Port of ``dcos_commons_tpu/agent/base.py``, line for line but the imports.
"""

from __future__ import annotations

from typing import List, Set

from dcos_commons_tpu_torch.common import TaskInfo, TaskStatus


class Agent:
    """What the scheduler needs from the thing that runs tasks.

    Reference analogues: launch = OfferAccepter LAUNCH operations,
    kill = TaskKiller -> driver.killTask, active_task_ids = the task
    reconciliation query (ImplicitReconciler / ExplicitReconciler).
    """

    # True when launch payloads cross a network (per-host daemons):
    # security validators demand an authed channel only then — a
    # local/sim agent writes cert material straight to disk
    is_remote = False

    def launch(self, task_infos: List[TaskInfo]) -> None:
        """Start the given tasks.  Must be idempotent per task_id."""
        raise NotImplementedError

    def kill(self, task_id: str, grace_period_s: float = 0.0) -> None:
        """Request termination; a terminal TaskStatus must follow."""
        raise NotImplementedError

    def active_task_ids(self) -> Set[str]:
        """Task ids currently known (running or starting) — the
        reconciliation source of truth."""
        raise NotImplementedError

    def poll(self) -> List[TaskStatus]:
        """Drain pending status transitions (RUNNING, FINISHED, ...)."""
        raise NotImplementedError

    def advertised_port_of(self, task_name: str, agent_id=None):
        """The HTTP port the task ACTUALLY bound, or None.

        Serving workers annotate their bound port into the servestats
        snapshot (serve/engine.py ``annotate_stats``): on a simulated
        fleet many "hosts" share one machine, so a worker whose
        scheduler-assigned port was taken binds an ephemeral one and
        advertises it here — /v1/endpoints lists what is DIALABLE,
        not what was reserved.  Default implementation
        reads the serving snapshot; agents without serving telemetry
        advertise nothing."""
        reader = getattr(self, "serving_stats_of", None)
        if not callable(reader):
            return None
        try:
            stats = reader(task_name, agent_id=agent_id)
        except TypeError:
            stats = reader(task_name)
        except OSError:
            return None
        port = stats.get("http_port") if isinstance(stats, dict) else None
        try:
            return int(port) if port else None
        except (TypeError, ValueError):
            return None

    # -- status listeners (event-driven scheduling) -------------------
    #
    # Agents that learn of a status asynchronously (monitor threads,
    # test fixtures injecting statuses) call _notify_status so the
    # scheduler loop can wake for an immediate poll instead of waiting
    # out its fallback heartbeat.  Purely advisory: an agent that only
    # discovers transitions inside poll() never notifies, and the
    # heartbeat still delivers everything.

    def add_status_listener(self, listener) -> None:
        """Register a no-arg callable invoked when a new status may be
        available.  Called from arbitrary threads; must not block."""
        if not hasattr(self, "_status_listeners"):
            self._status_listeners = []
        self._status_listeners.append(listener)

    def _notify_status(self) -> None:
        for listener in getattr(self, "_status_listeners", []):
            try:
                listener()
            except Exception:  # sdklint: disable=swallowed-exception — a broken listener must not break intake
                pass

"""HA control plane: leader election, fenced writes, re-hydration.

Reference: the reference SDK runs ONE scheduler behind a ZooKeeper
``CuratorLocker`` and survives scheduler death by restarting anywhere
and replaying the launch WAL plus stored statuses mid-plan
(SchedulerRestartServiceTest).  This package is that story end to end
for the GPU fleet:

* ``election.py`` — a TTL **leader lease** in the replicated state
  tree with a monotonic *lease epoch*; candidates poll and take over
  on expiry, and ``FencedPersister`` extends the replication layer's
  stream fencing to the scheduler's write path (a deposed leader's
  store mutations are rejected, not merely discouraged).
* ``rehydrate.py`` — deterministic scheduler re-hydration: plan state
  checkpoints (operator interrupts / force-completes survive a
  restart), and the WAL-replay report classifying every stored launch
  as adopted / re-issued / lost at takeover.

The chaos harness that kills a scheduler at every traceview
span-boundary kind and asserts convergence is the port's
``testing/chaos.py``.

Port of ``dcos_commons_tpu/ha/__init__.py``, line for line but the
imports.
"""

from dcos_commons_tpu_torch.ha.election import (  # noqa: F401
    FencedPersister,
    HAState,
    LeaderLease,
    LeaderLock,
    LeaseFencedError,
    LeaseState,
    read_lease,
)
from dcos_commons_tpu_torch.ha.rehydrate import (  # noqa: F401
    PlanCheckpointer,
    RehydrationReport,
    restore_plans,
)

__all__ = [
    "FencedPersister",
    "HAState",
    "LeaderLease",
    "LeaderLock",
    "LeaseFencedError",
    "LeaseState",
    "PlanCheckpointer",
    "RehydrationReport",
    "read_lease",
    "restore_plans",
]

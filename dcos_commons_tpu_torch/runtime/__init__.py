"""L1 runtime: event-loop plumbing around the scheduler.

Reference: sdk/scheduler/.../framework/ — OfferProcessor.java (the
single offer thread + bounded queue), TaskKiller.java (async kill with
retries until terminal status), TokenBucket.java (revive rate limit),
ImplicitReconciler.java / ExplicitReconciler.java (status
reconciliation gating offers, AbstractScheduler.java:163-184).

Port of ``dcos_commons_tpu/runtime/__init__.py``, line for line but the imports.
"""

from dcos_commons_tpu_torch.runtime.task_killer import TaskKiller
from dcos_commons_tpu_torch.runtime.token_bucket import TokenBucket
from dcos_commons_tpu_torch.runtime.reconciler import Reconciler

__all__ = ["Reconciler", "TaskKiller", "TokenBucket"]

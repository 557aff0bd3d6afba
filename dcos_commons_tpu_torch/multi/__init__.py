"""Multi-service: one framework hosting N services.

Reference: scheduler/multi/ — MultiServiceEventClient (fan-out of
offers/statuses to per-service clients, auto-uninstall of removed
services, MultiServiceEventClient.java:48,169-290),
MultiServiceManager (add/remove/lookup), ServiceStore (persisted specs
for dynamic add via HTTP), OfferDiscipline/ParallelFootprintDiscipline
(bound how many services grow footprint at once,
OfferDiscipline.java:11-33), MultiServiceRunner.

Port of ``dcos_commons_tpu/multi/__init__.py``.
"""

from dcos_commons_tpu_torch.multi.discipline import (
    AnyFootprintDiscipline,
    ParallelFootprintDiscipline,
)
from dcos_commons_tpu_torch.multi.scheduler import MultiServiceScheduler
from dcos_commons_tpu_torch.multi.store import ServiceStore

__all__ = [
    "AnyFootprintDiscipline",
    "ParallelFootprintDiscipline",
    "MultiServiceScheduler",
    "ServiceStore",
]

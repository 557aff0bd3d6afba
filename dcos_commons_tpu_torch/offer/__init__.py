"""L3 + L0-replacement: GPU inventory + evaluation + placement (port of
``dcos_commons_tpu/offer/``).

The reference consumes Mesos resource *offers* (sdk/scheduler/.../offer/:
MesosResourcePool, OfferEvaluator.java:65,113, evaluation stages,
placement rules).  A GPU fleet without Mesos needs the substrate the
reference outsourced, so this package *owns* it:

- inventory.py   the fleet model: GPU hosts (8-GPU NVLink nodes),
                 their cards and fabrics, and ResourceSnapshots (the
                 offer equivalent)
- ledger.py      the reservation ledger: WAL-backed, idempotent —
                 replaces Mesos reservation labels + resource ids
- nvlink.py      node-set search over one fabric (the JAX package's
                 torus.py: no contiguity, partial nodes admitted)
- multislice.py  gangs over several fabrics joined by one DCN pool
- placement.py   placement-rule DSL (max-per-host, zones, task-type
                 colocate/avoid, marathon-style JSON, same-fabric)
- evaluate.py    the evaluation pipeline: requirement + snapshots ->
                 reserve/launch recommendations, or per-stage reasons
- outcome.py     EvaluationOutcome + the "explain why placement
                 failed" record
"""

from dcos_commons_tpu_torch.offer.inventory import (
    GpuHost,
    ResourceSnapshot,
    SliceInventory,
)
from dcos_commons_tpu_torch.offer.ledger import Reservation, ReservationLedger
from dcos_commons_tpu_torch.offer.outcome import EvaluationOutcome
from dcos_commons_tpu_torch.offer.placement import PlacementRule, parse_placement
from dcos_commons_tpu_torch.offer.evaluate import (
    EvaluationContext,
    EvaluationResult,
    LaunchRecommendation,
    OfferEvaluator,
    ReserveRecommendation,
)

__all__ = [
    "EvaluationContext",
    "EvaluationOutcome",
    "EvaluationResult",
    "GpuHost",
    "LaunchRecommendation",
    "OfferEvaluator",
    "PlacementRule",
    "Reservation",
    "ReservationLedger",
    "ReserveRecommendation",
    "ResourceSnapshot",
    "SliceInventory",
    "parse_placement",
]

"""Multi-slice gang placement: the slice-set layer (port of
``dcos_commons_tpu/offer/multislice.py``: ``pod.gpu`` for ``pod.tpu``
and ``find_node_set`` for the torus search).

A ``gpu: slices: N`` gang spans N fabrics (``slice_id``: each a group
of NVLink nodes one NCCL gang can join) joined by the data-center
network, the ``dcn_pool`` the fabrics are plugged into.  This module
owns the SLICE-SET half of gang placement:

* :func:`eligible_slice_ids` — the fabric pre-filter: fabrics that
  cannot hold ONE ``topology`` gang (hosts_needed hosts with
  ``chips_per_host`` free cards each) are skipped before any node
  search (superset-sound — offer/nvlink.py takes exactly such hosts).
* :func:`place_slice_set` — pick N DISTINCT fabrics, one node set in
  each (``find_node_set``), all N reachable over one DCN pool (the
  ``dcn_pool`` host attribute; hosts that advertise none share the
  default pool).  Workers are numbered slice-major so
  ``worker_id // hosts_per_slice`` IS the slice index — the mesh
  layer's dcn axis falls exactly on the fabric boundary.
* :func:`slice_leaders` — the per-slice coordinator anchors: slice
  k's first worker hosts slice k's rendezvous endpoint, advertised to
  every worker as ``TPU_SLICE_COORDS`` (the global rendezvous stays
  on worker 0).

The evaluator (offer/evaluate.py ``_evaluate_gang``) calls this layer
for EVERY gang — a single-slice gang is the N=1 case — then claims
resources host by host.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Set, Tuple

from dcos_commons_tpu_torch.offer.outcome import EvaluationOutcome
from dcos_commons_tpu_torch.offer.nvlink import find_node_set

# fleet attribute naming the DCN fabric a slice is plugged into; a
# multi-slice gang's slices must share one pool (cross-pool traffic
# would transit a slower backbone the bandwidth model does not price).
# Hosts without the attribute share the DEFAULT ("") pool, so fleets
# that never set it behave as one flat fabric.
DCN_POOL_ATTRIBUTE = "dcn_pool"

# env var carrying the per-slice coordinator addresses, comma-joined
# slice-major ("host0:p0,host1:p1,..."): claim-time facts, injected by
# the evaluator next to TPU_SLICE_INDEX/TPU_NUM_SLICES
ENV_TPU_SLICE_COORDS = "TPU_SLICE_COORDS"

# reservation tag for the slice-local rendezvous port riding each
# slice leader's first task (mirrors COORDINATOR_PORT_NAME)
SLICE_COORDINATOR_PORT_NAME = "slice-coordinator"


def dcn_pool_of(host) -> str:
    """The DCN fabric a host belongs to ("" = the default pool)."""
    return (getattr(host, "attributes", None) or {}).get(
        DCN_POOL_ATTRIBUTE, ""
    )


def hosts_per_slice(gpu) -> int:
    """Hosts one ``topology`` gang occupies — the slice quantum
    every multi-slice size computation shares (admission, elastic
    shrink, trim, worker numbering)."""
    return max(1, gpu.total_chips // max(1, gpu.chips_per_host))


def eligible_slice_ids(index, hosts: Dict[str, object], total_chips: int,
                       generation: str = "",
                       chips_per_host: int = 1) -> Set[str]:
    """Fabrics that could hold ONE ``total_chips`` gang of
    ``generation`` hosts (any generation when "") at
    ``chips_per_host`` cards a host.

    The JAX package's pre-filter counts fully-free hosts against the
    hosts' own chip blocks, as its torus tiles by host block.
    ``find_node_set`` takes any host with ``chips_per_host`` free cards
    (the spec's, which the validators hold to one node's share), so
    that is what is counted here, from the view's free-card buckets.
    The "" bucket (GPU hosts registered without a fabric) is a
    searchable fabric like any other.
    """
    eligible: Set[str] = set()
    per_host = max(1, chips_per_host)
    need = max(1, -(-total_chips // per_host))
    for s, free in index.free_by_slice().items():
        if generation:
            # the spec's generation is a hard placement fact (the
            # fleet-sizing and admission formulas count per-generation
            # slices; the evaluator must agree or admission admits
            # specs that place on the wrong silicon)
            free = [
                h for h in free
                if h in hosts and hosts[h].generation == generation
            ]
        fits = 0
        for h in free:
            snap = index.snapshot(h)
            if snap is not None and len(snap.free_chips) >= per_host:
                fits += 1
        if fits >= need:
            eligible.add(s)
    return eligible


@dataclass
class SliceSetPlacement:
    """Result of :func:`place_slice_set`: slice-major ordered host
    snapshots (worker k lives on ``snapshots[k]``) or a failure
    outcome explaining every slice's refusal."""

    outcome: EvaluationOutcome
    snapshots: List = field(default_factory=list)
    slice_ids: Tuple[str, ...] = ()
    hosts_per_slice: int = 0

    @property
    def ok(self) -> bool:
        return bool(self.snapshots)


def place_slice_set(
    snapshots: List,
    gpu,
    eligible: Callable[[object], EvaluationOutcome],
) -> SliceSetPlacement:
    """Pick ``gpu.slices`` distinct fabrics, one ``topology`` node set
    each, all of the spec's ``generation``, all on one DCN pool.

    Greedy first-fit in scan order (deterministic, like every other
    placement path): the first sub-slice pins the gang's DCN pool,
    and subsequent searches only see hosts of that pool.  Greedy
    pool-pinning is sound for the fleets this models — pools partition
    slices, and scan order visits every pool's slices, so if ANY pool
    holds N free slices a permutation of the same greedy scan finds
    it; the failure outcome names the pinned pool so an operator can
    read why a half-free fleet refused.
    """
    n_slices = max(1, gpu.slices)
    generation = getattr(gpu, "generation", "") or ""
    ordered: List = []
    used_slices: Set[str] = set()
    pool: str = ""
    pool_pinned = False
    outcome = EvaluationOutcome.ok(
        "gang", f"{n_slices} slice(s) of {gpu.topology}"
    )
    for _ in range(n_slices):
        candidates = [
            s for s in snapshots
            if s.host.slice_id not in used_slices
            and (not generation or s.host.generation == generation)
            and (not pool_pinned or dcn_pool_of(s.host) == pool)
        ]
        placement = find_node_set(
            candidates, gpu.total_chips, gpu.chips_per_host, eligible
        )
        outcome.children.append(placement.outcome)
        if not placement.snapshots:
            outcome.passed = False
            where = (
                f" on dcn pool {pool or 'default'}" if pool_pinned else ""
            )
            outcome.reason = (
                f"no free slice for sub-gang "
                f"{len(used_slices) + 1}/{n_slices}{where} "
                f"(excluded: {sorted(used_slices) or 'none'})"
            )
            return SliceSetPlacement(outcome)
        anchor = placement.snapshots[0].host
        used_slices.add(anchor.slice_id)
        if n_slices > 1 and not pool_pinned:
            pool = dcn_pool_of(anchor)
            pool_pinned = True
        ordered.extend(placement.snapshots)
    return SliceSetPlacement(
        outcome,
        ordered,
        tuple(sorted(used_slices)),
        len(ordered) // n_slices,
    )


def slice_leaders(ordered: List, n_slices: int) -> List:
    """The slice-major leader snapshot of each sub-slice: worker
    ``k * hosts_per_slice`` anchors slice k's coordinator endpoint."""
    if n_slices <= 1 or not ordered:
        return []
    hps = len(ordered) // n_slices
    return [ordered[k * hps] for k in range(n_slices)]

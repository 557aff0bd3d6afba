"""Node-set search over one fabric of NVLink nodes: the port's
counterpart of ``dcos_commons_tpu/offer/torus.py``.

A gang pod requesting ``total_gpus`` cards at ``gpus_per_host`` a host
must land on ``total_gpus // gpus_per_host`` hosts of ONE fabric (the
``slice_id`` of its hosts: the nodes one NCCL gang can join over the
network), each with ``gpus_per_host`` free cards of the spec's
generation.  Inside a node every card hangs off NVSwitch, so any k of
its cards are equivalent; between nodes NCCL crosses the fabric, where
no pair of nodes is nearer than another.  So the search has no
contiguity and no wrap-around, where the torus needs an axis-aligned
rectangle of the ICI grid, and a partly reserved node still serves a
gang host with k free cards, where the torus needs a wholly free host.

Search: per fabric, in fabric order, take the first eligible hosts in
``node`` order (first-fit: simple and explainable; the outcome tree
records every refused host, as the torus records every rejected
anchor).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from dcos_commons_tpu_torch.offer.inventory import ResourceSnapshot
from dcos_commons_tpu_torch.offer.outcome import EvaluationOutcome


class NodeSetPlacement:
    def __init__(self, snapshots: List[ResourceSnapshot], outcome: EvaluationOutcome):
        self.snapshots = snapshots          # node order, instance order
        self.outcome = outcome


def find_node_set(
    snapshots: List[ResourceSnapshot],
    total_gpus: int,
    gpus_per_host: int,
    eligible: Callable[[ResourceSnapshot], EvaluationOutcome],
) -> NodeSetPlacement:
    """Find ``total_gpus // gpus_per_host`` hosts of one fabric, each
    with ``gpus_per_host`` free cards.

    ``eligible`` runs placement rules + scalar checks per host; its
    failures are recorded in the returned outcome tree.  Hosts without
    a generation (CPU-only) are never taken.
    """
    if gpus_per_host <= 0 or total_gpus <= 0 or total_gpus % gpus_per_host:
        return NodeSetPlacement(
            [],
            EvaluationOutcome.fail(
                "nvlink",
                f"{total_gpus} GPUs do not split into hosts of "
                f"{gpus_per_host}",
            ),
        )
    need = total_gpus // gpus_per_host

    outcome = EvaluationOutcome.ok(
        "nvlink", f"searching {need} node(s) of {gpus_per_host} GPUs"
    )
    by_slice: Dict[str, List[ResourceSnapshot]] = {}
    for snap in snapshots:
        if snap.host.generation:
            by_slice.setdefault(snap.host.slice_id, []).append(snap)

    if not by_slice:
        outcome.passed = False
        outcome.reason = "no GPU hosts in inventory"
        return NodeSetPlacement([], outcome)

    for slice_id, slice_snaps in sorted(by_slice.items()):
        placement = _search_slice(
            slice_id, slice_snaps, need, gpus_per_host, eligible, outcome
        )
        if placement is not None:
            return NodeSetPlacement(placement, outcome)

    outcome.passed = False
    outcome.reason = (
        f"no fabric has {need} node(s) with {gpus_per_host} free GPUs"
    )
    return NodeSetPlacement([], outcome)


def _search_slice(
    slice_id: str,
    snaps: List[ResourceSnapshot],
    need: int,
    gpus_per_host: int,
    eligible: Callable[[ResourceSnapshot], EvaluationOutcome],
    outcome: EvaluationOutcome,
) -> Optional[List[ResourceSnapshot]]:
    if len(snaps) < need:
        outcome.children.append(
            EvaluationOutcome.fail(
                f"slice:{slice_id}",
                f"fabric has {len(snaps)} node(s), fewer than required "
                f"{need}",
            )
        )
        return None
    taken: List[ResourceSnapshot] = []
    failures: List[EvaluationOutcome] = []
    # sorted() is stable: hosts sharing a node ordinal keep scan order
    for snap in sorted(snaps, key=lambda s: s.host.node):
        child = eligible(snap)
        if child.passed and len(snap.free_chips) < gpus_per_host:
            child = EvaluationOutcome.fail(
                f"host:{snap.host.host_id}",
                f"only {len(snap.free_chips)}/{snap.host.chips_per_host} "
                f"GPUs free, {gpus_per_host} needed",
            )
        if not child.passed:
            failures.append(child)
            continue
        taken.append(snap)
        if len(taken) == need:
            # the hosts passed over stay in the tree, as the torus
            # keeps every rejected anchor
            outcome.children.append(
                EvaluationOutcome(
                    True,
                    f"slice:{slice_id}",
                    f"nodes {[s.host.node for s in taken]}: {need} hosts",
                    failures,
                )
            )
            return taken
    outcome.children.append(
        EvaluationOutcome(
            False,
            f"slice:{slice_id}",
            f"{len(taken)}/{need} eligible node(s)",
            failures,
        )
    )
    return None

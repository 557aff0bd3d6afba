"""Property-based tests of the port's node-set search
(``dcos_commons_tpu_torch/offer/nvlink.py`` ``find_node_set``), in the
style of tests/test_torus_properties.py: over randomized fleets of
NVLink nodes, the search returns exactly ``total / k`` hosts of one
fabric and of the spec's generation, each with k free cards, or fails;
it finds a set whenever one exists (against a brute-force oracle); it
is deterministic; ``eligible`` refusals land in the outcome tree; and
gangs placed one after another on one ledger never share a card."""

import pytest

pytest.importorskip(
    "hypothesis", reason="property tests need the hypothesis package"
)
from hypothesis import given, settings, strategies as st  # noqa: E402

from dcos_commons_tpu_torch.offer.inventory import (  # noqa: E402
    GpuHost,
    ResourceSnapshot,
    SliceInventory,
)
from dcos_commons_tpu_torch.offer.multislice import (  # noqa: E402
    place_slice_set,
)
from dcos_commons_tpu_torch.offer.ledger import (  # noqa: E402
    Reservation,
    ReservationLedger,
    new_reservation_id,
)
from dcos_commons_tpu_torch.offer.nvlink import find_node_set  # noqa: E402
from dcos_commons_tpu_torch.offer.outcome import (  # noqa: E402
    EvaluationOutcome,
)
from dcos_commons_tpu_torch.specification import GpuSpec  # noqa: E402
from dcos_commons_tpu_torch.storage import MemPersister  # noqa: E402

GENERATIONS = ("h100", "a100", "")


@st.composite
def fleets(draw):
    """Hosts over 1-3 fabrics: each with a card count, a number of
    cards already taken, a generation, and whether ``eligible`` (the
    rules and scalars) refuses it."""
    n = draw(st.integers(1, 10))
    hosts = []
    for i in range(n):
        gpus = draw(st.sampled_from((0, 4, 8)))
        hosts.append(dict(
            host_id=f"h{i}",
            slice_id=draw(st.sampled_from(("fa", "fb", "fc"))),
            node=draw(st.integers(0, 9)),
            gpus=gpus,
            taken=draw(st.integers(0, gpus)),
            generation=draw(st.sampled_from(GENERATIONS)) if gpus else "",
            refused=draw(st.booleans()),
        ))
    return hosts


def snapshots(fleet):
    out = []
    for h in fleet:
        host = GpuHost(host_id=h["host_id"], slice_id=h["slice_id"],
                       generation=h["generation"], node=h["node"],
                       gpus=h["gpus"])
        free = set(host.chip_ids()[h["taken"]:])
        out.append(ResourceSnapshot(host, host.cpus, host.memory_mb,
                                    host.disk_mb, free, set()))
    return out


def eligible_of(fleet):
    refused = {h["host_id"] for h in fleet if h["refused"]}

    def eligible(snap):
        if snap.host.host_id in refused:
            return EvaluationOutcome.fail(f"host:{snap.host.host_id}",
                                          "refused by a rule")
        return EvaluationOutcome.ok(f"host:{snap.host.host_id}")
    return eligible


def fits(h, k):
    return (h["generation"] and not h["refused"]
            and h["gpus"] - h["taken"] >= k)


def oracle(fleet, need, k):
    """Does any fabric hold ``need`` hosts with ``k`` free cards that
    ``eligible`` admits?"""
    by_fabric = {}
    for h in fleet:
        if fits(h, k):
            by_fabric[h["slice_id"]] = by_fabric.get(h["slice_id"], 0) + 1
    return any(n >= need for n in by_fabric.values())


@settings(max_examples=300, deadline=None)
@given(fleet=fleets(), need=st.integers(1, 4),
       k=st.sampled_from((1, 2, 4, 8)))
def test_node_set_is_sound_complete_and_deterministic(fleet, need, k):
    snaps = snapshots(fleet)
    placement = find_node_set(snaps, need * k, k, eligible_of(fleet))
    by_id = {h["host_id"]: h for h in fleet}
    chosen = [s.host.host_id for s in placement.snapshots]
    if chosen:
        assert placement.outcome.passed
        assert len(chosen) == need == len(set(chosen))
        assert len({by_id[h]["slice_id"] for h in chosen}) == 1
        assert all(fits(by_id[h], k) for h in chosen)
        # node order within the fabric
        nodes = [by_id[h]["node"] for h in chosen]
        assert nodes == sorted(nodes)
    else:
        assert not placement.outcome.passed
    assert bool(chosen) == oracle(fleet, need, k)
    again = find_node_set(snapshots(fleet), need * k, k, eligible_of(fleet))
    assert [s.host.host_id for s in again.snapshots] == chosen
    assert again.outcome.to_dict() == placement.outcome.to_dict()


@settings(max_examples=200, deadline=None)
@given(fleet=fleets(), need=st.integers(1, 3), k=st.sampled_from((1, 4)),
       slices=st.integers(1, 2))
def test_gang_hosts_are_of_the_spec_generation(fleet, need, k, slices):
    """Through the slice-set layer (what the evaluator calls): every
    host of the spec's generation, each slice one fabric, the fabrics
    distinct; placed whenever enough fabrics can hold a set."""
    gpu = GpuSpec(generation="h100", chips_per_host=k,
                  topology=f"{need * k}", slices=slices)
    placement = place_slice_set(snapshots(fleet), gpu, eligible_of(fleet))
    by_id = {h["host_id"]: h for h in fleet}
    chosen = [by_id[s.host.host_id] for s in placement.snapshots]
    assert all(h["generation"] == "h100" and fits(h, k) for h in chosen)
    fabrics = [h["slice_id"] for h in chosen]
    assert fabrics == sorted(fabrics) or slices > 1
    assert len(set(fabrics)) == (slices if chosen else 0)
    holding = {h["slice_id"] for h in fleet
               if h["generation"] == "h100" and fits(h, k)}
    counts = {f: sum(1 for h in fleet if h["slice_id"] == f
                     and h["generation"] == "h100" and fits(h, k))
              for f in holding}
    assert placement.ok == (sum(n >= need for n in counts.values())
                            >= slices)


@settings(max_examples=200, deadline=None)
@given(fleet=fleets(), k=st.sampled_from((1, 4)))
def test_refusals_are_in_the_outcome_tree(fleet, k):
    """Every host ``eligible`` refused in a fabric the search walked
    (each fabric before the winner, and the winner's hosts before its
    last pick) is a FAIL line of the tree."""
    need = 2
    placement = find_node_set(snapshots(fleet), need * k, k,
                              eligible_of(fleet))
    flat = "\n".join(placement.outcome.flatten())
    gpu_hosts = {}
    for h in fleet:
        if h["generation"]:
            gpu_hosts[h["slice_id"]] = gpu_hosts.get(h["slice_id"], 0) + 1
    if not gpu_hosts:
        assert placement.outcome.reason == "no GPU hosts in inventory"
    chosen = placement.snapshots
    winner = chosen[0].host.slice_id if chosen else None
    last = max((s.host.node for s in chosen), default=None)
    for h in fleet:
        if not (h["refused"] and h["generation"]):
            continue
        if gpu_hosts[h["slice_id"]] < need:
            continue  # a fabric too small is refused as a whole
        if winner is not None and (h["slice_id"] > winner or (
                h["slice_id"] == winner and h["node"] >= last)):
            continue  # never reached
        assert f"FAIL host:{h['host_id']}: refused by a rule" in flat


@settings(max_examples=100, deadline=None)
@given(nodes=st.integers(1, 4), gpus=st.sampled_from((4, 8)),
       k=st.sampled_from((1, 2, 4)), rounds=st.integers(1, 12))
def test_successive_gangs_on_one_ledger_never_share_a_card(
        nodes, gpus, k, rounds):
    hosts = [GpuHost(host_id=f"n{i}", slice_id="fab", generation="h100",
                     node=i, gpus=gpus) for i in range(nodes)]
    inventory = SliceInventory(hosts)
    ledger = ReservationLedger(MemPersister())
    taken = []
    placed = 0
    for r in range(rounds):
        need = 1 + r % 2
        placement = find_node_set(inventory.snapshots(ledger), need * k, k,
                                  lambda s: EvaluationOutcome.ok("any"))
        if not placement.snapshots:
            continue
        claims = []
        for snap in placement.snapshots:
            cards = snap.try_consume_chips(k)
            assert cards is not None
            claims.append(Reservation(
                reservation_id=new_reservation_id(),
                host_id=snap.host.host_id, task_name=f"g{r}-0-w",
                chip_ids=cards))
        ledger.commit(claims)
        taken += [c for claim in claims for c in claim.chip_ids]
        placed += need * k
    assert len(taken) == len(set(taken)) == placed <= nodes * gpus


def test_invalid_shapes_fail_with_a_reason():
    snaps = snapshots([dict(host_id="h0", slice_id="f", node=0, gpus=8,
                            taken=0, generation="h100", refused=False)])
    for total, k in ((6, 4), (0, 4), (4, 0)):
        placement = find_node_set(snaps, total, k, eligible_of([]))
        assert placement.snapshots == []
        assert "do not split into hosts" in placement.outcome.reason

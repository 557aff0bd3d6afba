"""The port's offer engine (``dcos_commons_tpu_torch/offer``) against the
JAX package's, on the CPU: the same requirements on twin fleets through
both evaluators.

A TPU host with a (2, 2) chip block and its GPU twin with 4 cards share
host id, hostname, fabric/slice, cpus, memory, disk, ports, zone,
region and attributes (``gpu_fleet``).  Non-gang pods (the YAMLs of
tests/test_offer.py and the port's five YAMLs against frameworks/jax/)
must get the same decision, hosts, scalars, ports, outcome tree and
env, exactly, but the designed differences: the card id form, and
``CUDA_VISIBLE_DEVICES`` in place of ``TPU_CHIPS_PER_HOST_BOUNDS``.
Gangs must agree where the node-set search and the torus agree (a host
row, a whole grid, one host); where they differ by design (a free set
the torus finds non-contiguous, a half-reserved node) the port's
documented answer is asserted."""

import os
import time

import pytest

from dcos_commons_tpu.offer import evaluate as j_evaluate
from dcos_commons_tpu.offer import inventory as j_inventory
from dcos_commons_tpu.offer import ledger as j_ledger
from dcos_commons_tpu.plan import step as j_step
from dcos_commons_tpu.specification import yaml_spec as j_yaml
from dcos_commons_tpu.state import state_store as j_state
from dcos_commons_tpu.storage import MemPersister as JMemPersister
from dcos_commons_tpu.tools import options as j_options
from dcos_commons_tpu_torch.metrics import Metrics
from dcos_commons_tpu_torch.offer import evaluate as t_evaluate
from dcos_commons_tpu_torch.offer import inventory as t_inventory
from dcos_commons_tpu_torch.offer import ledger as t_ledger
from dcos_commons_tpu_torch.offer.inventory import (
    GpuHost,
    card_index,
    card_order,
    make_test_fleet,
)
from dcos_commons_tpu_torch.plan import step as t_step
from dcos_commons_tpu_torch.specification import yaml_spec as t_yaml
from dcos_commons_tpu_torch.state import state_store as t_state
from dcos_commons_tpu_torch.storage import MemPersister as TMemPersister
from dcos_commons_tpu_torch.tools import options as t_options
from test_offer import CPU_YAML, GANG_YAML, MULTISLICE_YAML

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FRAMEWORKS = os.path.join(REPO, "dcos_commons_tpu_torch", "frameworks")
JAX_FRAMEWORKS = os.path.join(REPO, "frameworks", "jax")
GENERATIONS = {"v5e": "h100", "v4": "a100", "": ""}
# env keys where the packages differ by design; each is checked apart
DESIGNED = ("TPU_CHIP_IDS", "TPU_CHIPS_PER_HOST_BOUNDS",
            "CUDA_VISIBLE_DEVICES", "TPU_GENERATION")

PARTIAL_YAML = """
name: partial
pods:
  worker:
    count: 1
    tpu:
      generation: v5e
      chips-per-host: 2
    tasks:
      main: {goal: RUNNING, cmd: "x", cpus: 0.5, memory: 64}
      side: {goal: ONCE, cmd: "y", cpus: 0.1, memory: 32}
"""

BOTH_YAML = PARTIAL_YAML.replace("chips-per-host: 2", "chips-per-host: 4")

# a 4-host gang laid as one row of (2, 2) hosts on the torus
ROW_GANG_YAML = GANG_YAML.replace("topology: 4x4", "topology: 8x2")
ONE_HOST_GANG_YAML = GANG_YAML.replace("count: 4", "count: 1").replace(
    "topology: 4x4", "topology: 2x2")


def gpu_fleet(tpu_hosts):
    """Each TPU host's GPU twin: ``gpus`` its chip count, ``node`` its
    row-major place in its slice's host grid, every other field its
    own."""
    width = {}
    for h in tpu_hosts:
        width[h.slice_id] = max(width.get(h.slice_id, 0), h.grid[0] + 1)
    return [
        GpuHost(
            host_id=h.host_id, hostname=h.hostname, slice_id=h.slice_id,
            generation=GENERATIONS[h.generation],
            node=h.grid[1] * width[h.slice_id] + h.grid[0],
            gpus=h.chips_per_host, cpus=h.cpus, memory_mb=h.memory_mb,
            disk_mb=h.disk_mb, ports=h.ports, attributes=dict(h.attributes),
            zone=h.zone, region=h.region,
        )
        for h in tpu_hosts
    ]


def gpu_yaml(text):
    return text.replace("tpu:", "gpu:").replace(
        "generation: v5e", "generation: h100")


class Side:
    """One package's evaluator, state store, ledger and inventory."""

    def __init__(self, spec, hosts, persister, state, ledger, evaluate,
                 inventory, step):
        self.spec = spec
        self.persister = persister
        self.store = state.StateStore(persister)
        self.ledger = ledger.ReservationLedger(persister)
        self.ev = evaluate.OfferEvaluator(self.store, self.ledger,
                                          spec.name, "cfg-1")
        self.inv = inventory.SliceInventory(hosts)
        self.step = step
        self.state = state

    def evaluate(self, pod_type, instances, tasks=(), recovery="NONE"):
        req = self.step.PodInstanceRequirement(
            pod=self.spec.pod(pod_type), instances=list(instances),
            tasks_to_launch=list(tasks),
            recovery_type=self.step.RecoveryType[recovery])
        return self.ev.evaluate(req, self.inv)

    def commit(self, result):
        self.ledger.commit(result.reservations)
        self.store.store_tasks(result.task_infos)

    def pause(self, task_name):
        self.store.store_goal_override(
            task_name, self.state.GoalStateOverride.PAUSED,
            self.state.OverrideProgress.PENDING)


class Pair:
    def __init__(self, j_spec, t_spec, tpu_hosts, cmd_fix=None):
        self.j = Side(j_spec, tpu_hosts, JMemPersister(), j_state,
                      j_ledger, j_evaluate, j_inventory, j_step)
        self.t = Side(t_spec, gpu_fleet(tpu_hosts), TMemPersister(),
                      t_state, t_ledger, t_evaluate, t_inventory, t_step)
        self.cmd_fix = cmd_fix or (lambda cmd: cmd)

    @classmethod
    def from_yaml(cls, text, tpu_hosts):
        return cls(j_yaml.from_yaml(text), t_yaml.from_yaml(gpu_yaml(text)),
                   tpu_hosts)

    def step(self, pod_type, instances, tasks=(), recovery="NONE",
             commit=True, gang=False):
        """The same requirement through both evaluators; their results
        held equal (``gang``: the outcome trees are the searches' own
        and are not compared).  Returns both results."""
        jr = self.j.evaluate(pod_type, instances, tasks, recovery)
        tr = self.t.evaluate(pod_type, instances, tasks, recovery)
        assert tr.passed == jr.passed, (jr.outcome.flatten(),
                                        tr.outcome.flatten())
        if not gang:
            assert tr.outcome.reason == jr.outcome.reason
            assert outcome_tree(tr.outcome) == outcome_tree(jr.outcome)
        assert [reservation_key(r) for r in tr.reservations] == [
            reservation_key(r) for r in jr.reservations]
        assert len(tr.task_infos) == len(jr.task_infos)
        launched = {i.name for i in tr.task_infos}
        for ji, ti in zip(jr.task_infos, tr.task_infos):
            assert info_key(ti) == info_key(ji, self.cmd_fix)
            assert rest_of_env(ti.env) == rest_of_env(ji.env, self.cmd_fix)
            check_designed_env(ji, ti, launched, self.t.ledger,
                               tr.task_infos)
        if commit and jr.passed:
            self.j.commit(jr)
            self.t.commit(tr)
        return jr, tr


def outcome_tree(o):
    return (o.source, o.passed, [outcome_tree(c) for c in o.children])


def reservation_key(r):
    return (r.host_id, r.task_name, r.role, r.cpus, r.memory_mb, r.disk_mb,
            len(r.chip_ids), tuple(r.ports), r.container_path,
            bool(r.volume_id), tuple(sorted(r.volumes)))


def info_key(info, cmd_fix=lambda cmd: cmd):
    return (info.name, info.agent_id, info.pod_type, info.pod_index,
            cmd_fix(info.command), info.labels, len(info.resource_ids),
            len(info.tpu_chip_ids), len(info.volume_ids),
            tuple(sorted(info.volumes)))


def rest_of_env(env, cmd_fix=lambda cmd: cmd):
    return {k: cmd_fix(v) for k, v in env.items() if k not in DESIGNED}


def check_designed_env(ji, ti, launched, ledger, launched_infos=()):
    """The designed differences, each its documented answer; ``ledger``
    holds what was committed before this evaluation, ``launched`` the
    task names it launches, ``launched_infos`` their TaskInfos."""
    jenv, tenv = ji.env, ti.env
    assert ("TPU_CHIP_IDS" in tenv) == ("TPU_CHIP_IDS" in jenv)
    if "TPU_CHIP_IDS" in tenv:
        cards = tenv["TPU_CHIP_IDS"].split(";")
        assert len(cards) == len(jenv["TPU_CHIP_IDS"].split(";"))
        assert cards == ti.tpu_chip_ids
        assert all(c.startswith(f"{ti.agent_id}/") for c in cards)
    assert "TPU_CHIPS_PER_HOST_BOUNDS" not in tenv
    if "TPU_GENERATION" in jenv:
        assert (jenv["TPU_GENERATION"], tenv["TPU_GENERATION"]) == (
            "v5e", "h100")
    # every task gets CUDA_VISIBLE_DEVICES: its own cards; a chip-less
    # task the cards of its instance, whether its card holder launches
    # with it or holds them already (a sidecar); a task of an instance
    # without cards none
    instance = f"{ti.pod_type}-{ti.pod_index}-"
    visible = ti.tpu_chip_ids or sorted(
        {c for r in ledger.all()
         if r.task_name.startswith(instance) and r.task_name not in launched
         for c in r.chip_ids}
        | {c for i in launched_infos if i.name.startswith(instance)
           for c in i.tpu_chip_ids}, key=card_order)
    assert tenv["CUDA_VISIBLE_DEVICES"] == ",".join(
        str(card_index(c)) for c in visible)


def cpu_host(host_id, zone="z1", **kw):
    return j_inventory.TpuHost(host_id=host_id, zone=zone, **kw)


# -- the fleet model ---------------------------------------------------------


def test_gpu_host_cards():
    host = GpuHost(host_id="fab-n3", slice_id="fab", generation="h100",
                   node=3, gpus=8)
    assert host.chips_per_host == 8
    assert host.chip_ids() == [f"fab-n3/{k}" for k in range(8)]
    assert [card_index(c) for c in host.chip_ids()] == list(range(8))
    big = GpuHost(host_id="h", gpus=16).chip_ids()
    assert sorted(big, key=card_order) == big
    assert sorted(big) != big  # a string sort puts "h/10" before "h/2"
    assert GpuHost(host_id="cpu").chip_ids() == []
    fleet = make_test_fleet("fab", nodes=3, gpus=4)
    assert [(h.host_id, h.node, h.gpus, h.generation) for h in fleet] == [
        (f"fab-n{n}", n, 4, "h100") for n in range(3)]


def test_snapshot_takes_cards_in_index_order():
    host = GpuHost(host_id="h", gpus=16, generation="h100")
    snap = t_inventory.ResourceSnapshot(host, 8.0, 1024, 1024,
                                        set(host.chip_ids()), set())
    assert snap.try_consume_chips(3) == ["h/0", "h/1", "h/2"]
    snap.free_chips -= {"h/3", "h/4", "h/5", "h/6", "h/7", "h/8"}
    assert snap.try_consume_chips(2) == ["h/9", "h/10"]
    assert snap.try_consume_chips(6) is None


def test_snapshots_subtract_reservations_as_the_reference_does():
    tpu_hosts = j_inventory.make_test_fleet()
    fleets = ((tpu_hosts, JMemPersister, j_ledger, j_inventory),
              (gpu_fleet(tpu_hosts), TMemPersister, t_ledger, t_inventory))
    views = []
    for hosts, persister, ledger_mod, inv_mod in fleets:
        persister = persister()
        ledger = ledger_mod.ReservationLedger(persister)
        ledger.commit([ledger_mod.Reservation(
            reservation_id=ledger_mod.new_reservation_id(),
            host_id=hosts[0].host_id, task_name="t-0-x", cpus=10.0,
            memory_mb=1000, chip_ids=hosts[0].chip_ids()[:2],
            ports=[10000])])
        inv = inv_mod.SliceInventory(hosts)
        inv.mark_down(hosts[3].host_id)
        views.append([(s.host.host_id, s.cpus, s.memory_mb, s.disk_mb,
                       len(s.free_chips), sorted(s.used_ports))
                      for s in inv.snapshots(ledger)])
        again = ledger_mod.ReservationLedger(persister)
        assert len(again.all()) == 1
        assert again.unexpected_reservations({"t-0-x"}) == []
    assert views[1] == views[0]


# -- decision parity, non-gang pods ------------------------------------------


def scenario_cpu_pods(pair):
    pair.step("hello", [0])
    pair.step("hello", [1])
    pair.step("hello", [0], recovery="TRANSIENT", commit=False)
    pair.step("hello", [0], recovery="PERMANENT", commit=False)


def scenario_cpu_full(pair):
    pair.step("hello", [0])
    pair.step("hello", [1])  # max-per-host refuses the one host


def scenario_reuse_host_down(pair):
    _, tr = pair.step("hello", [0])
    for side in (pair.j, pair.t):
        side.inv.mark_down(tr.task_infos[0].agent_id)
    pair.step("hello", [0], recovery="TRANSIENT")


def scenario_paused(pair):
    pair.step("hello", [0])
    pair.j.pause("hello-0-server")
    pair.t.pause("hello-0-server")
    jr, tr = pair.step("hello", [0], recovery="TRANSIENT", commit=False)
    assert tr.task_infos[0].command == t_evaluate.PAUSE_COMMAND
    assert tr.task_infos[0].labels[t_evaluate.Label.GOAL_STATE_OVERRIDE] \
        == "PAUSED"


def scenario_partial_and_sidecar(pair):
    _, tr = pair.step("worker", [0], tasks=["main"])
    assert tr.task_infos[0].env["CUDA_VISIBLE_DEVICES"] == "0,1"
    _, tr = pair.step("worker", [0], tasks=["side"])
    # the sidecar reserves no card but sees the instance's
    assert tr.task_infos[0].tpu_chip_ids == []
    assert tr.task_infos[0].env["CUDA_VISIBLE_DEVICES"] == "0,1"
    _, tr = pair.step("worker", [0], tasks=["side"], recovery="TRANSIENT",
                      commit=False)
    assert tr.task_infos[0].env["CUDA_VISIBLE_DEVICES"] == "0,1"
    # a second instance takes the node's other two cards
    _, tr = pair.step("worker", [1], tasks=["main"])
    assert tr.task_infos[0].env["CUDA_VISIBLE_DEVICES"] == "2,3"


def scenario_colaunched_sidecar(pair):
    _, tr = pair.step("worker", [0])
    env = {i.name: i.env["CUDA_VISIBLE_DEVICES"] for i in tr.task_infos}
    # the co-launched chip-less sibling reserves no card and sees the
    # instance's, at the launch and at the relaunch of both
    assert [i.tpu_chip_ids for i in tr.task_infos][1] == []
    assert env == {"worker-0-main": "0,1,2,3", "worker-0-side": "0,1,2,3"}
    _, tr = pair.step("worker", [0], recovery="TRANSIENT", commit=False)
    assert {i.name: i.env["CUDA_VISIBLE_DEVICES"]
            for i in tr.task_infos} == env


SCENARIOS = {
    "cpu-pods": (CPU_YAML, lambda: [cpu_host("h1"), cpu_host("h2")],
                 scenario_cpu_pods),
    "cpu-full": (CPU_YAML, lambda: [cpu_host("h1")], scenario_cpu_full),
    "reuse-host-down": (CPU_YAML, lambda: [cpu_host("h1"), cpu_host("h2")],
                        scenario_reuse_host_down),
    "paused": (CPU_YAML, lambda: [cpu_host("h1")], scenario_paused),
    "partial-and-sidecar": (
        PARTIAL_YAML,
        lambda: j_inventory.make_test_fleet(host_grid=(1, 1)),
        scenario_partial_and_sidecar),
    "colaunched-sidecar": (
        BOTH_YAML, lambda: j_inventory.make_test_fleet(host_grid=(1, 1)),
        scenario_colaunched_sidecar),
    "gpu-pod-on-cpu-hosts": (
        PARTIAL_YAML, lambda: [cpu_host("h1"), cpu_host("h2")],
        lambda pair: pair.step("worker", [0], tasks=["main"])),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_non_gang_decisions_match_the_reference(name):
    text, hosts, scenario = SCENARIOS[name]
    scenario(Pair.from_yaml(text, hosts()))


def _render(yaml_mod, options_mod, framework_dir, name):
    schema = options_mod.load_schema(framework_dir)
    env = options_mod.render_options(schema, {}) if schema else {}
    return yaml_mod.from_yaml_file(os.path.join(framework_dir, name), env)


def _port_cmd(cmd):
    return cmd.replace("frameworks/jax", "dcos_commons_tpu_torch/frameworks"
                       ).replace("dcos_commons_tpu.parallel",
                                 "dcos_commons_tpu_torch.parallel")


# each YAML's fleet: a host grid where the torus and the node set agree
PORT_YAMLS = {
    "svc.yml": dict(host_grid=(2, 2), chip_block=(2, 2)),
    "svc_mnist.yml": dict(host_grid=(3, 1), chip_block=(2, 2)),
    "svc_serve.yml": dict(host_grid=(3, 1), chip_block=(2, 2)),
    "svc_serve_gang.yml": dict(host_grid=(1, 2), chip_block=(1, 1)),
    "svc_router.yml": dict(host_grid=(3, 1), chip_block=(2, 2)),
}


@pytest.mark.parametrize("name", sorted(PORT_YAMLS))
def test_port_yamls_place_as_the_jax_ones(name):
    """Each pod's deploy (its first task, every instance), its sidecar
    tasks, and a relaunch in place, through both packages."""
    pair = Pair(_render(j_yaml, j_options, JAX_FRAMEWORKS, name),
                _render(t_yaml, t_options, PORT_FRAMEWORKS, name),
                j_inventory.make_test_fleet(**PORT_YAMLS[name]),
                cmd_fix=_port_cmd)
    for pod in pair.t.spec.pods:
        gang = bool(pod.gang and pod.gpu is not None and pod.gpu.topology)
        instances = list(range(pod.count))
        first, *rest = [t.name for t in pod.tasks]
        _, tr = pair.step(pod.type, instances, [first], gang=gang)
        assert tr.passed, tr.outcome.flatten()
        if rest:
            _, side = pair.step(pod.type, instances, rest, gang=gang)
            assert side.passed
            for held, joined in zip(tr.task_infos, side.task_infos[::len(rest)]):
                assert joined.env["CUDA_VISIBLE_DEVICES"] == \
                    held.env["CUDA_VISIBLE_DEVICES"]
        pair.step(pod.type, instances, [first], recovery="TRANSIENT",
                  commit=False, gang=gang)


# -- gangs --------------------------------------------------------------------


def scenario_row_gang(pair):
    _, tr = pair.step("trainer", [0, 1, 2, 3], gang=True)
    assert [i.agent_id for i in tr.task_infos] == [
        f"pod-0-h{x}-0" for x in range(4)]
    pair.step("trainer", [0, 1, 2, 3], recovery="TRANSIENT", commit=False,
              gang=True)


def scenario_row_gang_after_a_reserved_host(pair):
    for side in (pair.j, pair.t):
        host = side.inv.host("pod-0-h0-0")
        side.ledger.commit([_intruder(side, host, host.chip_ids())])
    _, tr = pair.step("trainer", [0, 1, 2, 3], gang=True)
    assert tr.task_infos[0].agent_id == "pod-0-h1-0"


def _intruder(side, host, chips):
    """A claim of another service on ``chips`` of ``host``."""
    mod = t_ledger if isinstance(side.ledger, t_ledger.ReservationLedger) \
        else j_ledger
    return mod.Reservation(reservation_id=mod.new_reservation_id(),
                           host_id=host.host_id, task_name="intruder-0-x",
                           chip_ids=list(chips))


def scenario_grid_gang(pair):
    _, tr = pair.step("trainer", [0, 1, 2, 3], gang=True)
    coords = {i.env["COORDINATOR_ADDRESS"] for i in tr.task_infos}
    assert coords == {"pod-0-h0-0:10000"}
    assert [i.env["CUDA_VISIBLE_DEVICES"] for i in tr.task_infos] == \
        ["0,1,2,3"] * 4


def scenario_one_host_gang(pair):
    pair.step("trainer", [0], gang=True)
    # the next host for a second gang of one on the same fleet
    _, tr = pair.step("trainer", [0], recovery="PERMANENT", commit=False,
                      gang=True)
    assert tr.task_infos[0].agent_id == "pod-0-h1-0"


def scenario_multislice(pair):
    _, tr = pair.step("trainer", [0, 1, 2, 3], gang=True)
    assert [i.env["TPU_SLICE_INDEX"] for i in tr.task_infos] == \
        ["0", "0", "1", "1"]
    _, again = pair.step("trainer", [0, 1, 2, 3], recovery="TRANSIENT",
                         commit=False, gang=True)
    assert [i.env["TPU_SLICE_COORDS"] for i in again.task_infos] == \
        [i.env["TPU_SLICE_COORDS"] for i in tr.task_infos]


def scenario_multislice_one_slice(pair):
    jr, tr = pair.step("trainer", [0, 1, 2, 3], gang=True)
    assert "no free slice for sub-gang 2/2" in tr.outcome.reason


def scenario_relaunch_without_coordinator(pair):
    pair.step("trainer", [0, 1, 2, 3], gang=True)
    for side, mod in ((pair.j, j_evaluate), (pair.t, t_evaluate)):
        for r in side.ledger.all():
            if r.container_path == mod.COORDINATOR_PORT_NAME:
                side.ledger.release(r.reservation_id)
    jr, tr = pair.step("trainer", [0, 1, 2, 3], gang=True)
    assert not tr.passed and "coordinator" in tr.outcome.reason


def scenario_gang_atomicity(pair):
    jr, tr = pair.step("trainer", [0, 1, 2, 3], gang=True)
    assert not tr.passed and tr.reservations == []
    assert pair.t.ledger.all() == []


GANG_SCENARIOS = {
    "row": (ROW_GANG_YAML, dict(host_grid=(6, 1)), scenario_row_gang),
    "row-after-reserved-host": (ROW_GANG_YAML, dict(host_grid=(6, 1)),
                                scenario_row_gang_after_a_reserved_host),
    "whole-grid": (GANG_YAML, dict(host_grid=(2, 2)), scenario_grid_gang),
    "one-host": (ONE_HOST_GANG_YAML, dict(host_grid=(3, 1)),
                 scenario_one_host_gang),
    "relaunch-without-coordinator": (GANG_YAML, dict(host_grid=(2, 2)),
                                     scenario_relaunch_without_coordinator),
    "atomicity": (GANG_YAML, dict(host_grid=(2, 2), cpus=1.0),
                  scenario_gang_atomicity),
}


@pytest.mark.parametrize("name", sorted(GANG_SCENARIOS))
def test_gang_decisions_match_where_the_searches_agree(name):
    text, fleet, scenario = GANG_SCENARIOS[name]
    scenario(Pair.from_yaml(text, j_inventory.make_test_fleet(**fleet)))


@pytest.mark.parametrize("slices", [3, 1])
def test_multislice_gang_matches_the_reference(slices):
    hosts = []
    for s in "abc"[:slices]:
        hosts += j_inventory.make_test_fleet(slice_id=f"pod-{s}",
                                             host_grid=(1, 2))
    scenario = scenario_multislice if slices > 1 else \
        scenario_multislice_one_slice
    scenario(Pair.from_yaml(MULTISLICE_YAML, hosts))


# -- designed differences ------------------------------------------------------


def _port_side(text, hosts):
    spec = t_yaml.from_yaml(gpu_yaml(text))
    return Side(spec, hosts, TMemPersister(), t_state, t_ledger, t_evaluate,
                t_inventory, t_step)


TWO_HOST_GANG_YAML = GANG_YAML.replace("count: 4", "count: 2").replace(
    "topology: 4x4", "topology: 4x2")


def test_non_contiguous_free_nodes_are_admitted():
    """The torus refuses r0 + r2 around a reserved r1 (no wrap); any two
    nodes of one fabric serve a gang, so the port places there."""
    tpu_hosts = j_inventory.make_test_fleet(slice_id="row",
                                            host_grid=(3, 1))
    pair = Pair.from_yaml(TWO_HOST_GANG_YAML, tpu_hosts)
    for side in (pair.j, pair.t):
        host = side.inv.host("row-h1-0")
        side.ledger.commit([_intruder(side, host, host.chip_ids())])
    jr = pair.j.evaluate("trainer", [0, 1])
    tr = pair.t.evaluate("trainer", [0, 1])
    assert not jr.passed
    assert tr.passed, tr.outcome.flatten()
    assert [i.agent_id for i in tr.task_infos] == ["row-h0-0", "row-h2-0"]
    text = "\n".join(tr.outcome.flatten())
    assert "FAIL host:row-h1-0: only 0/4 GPUs free" in text


def test_half_reserved_node_serves_a_gang_host():
    """A node with 2 of its 4 cards reserved gives a gang of 2-card
    hosts its other two; the torus needs wholly free hosts."""
    text = TWO_HOST_GANG_YAML.replace("chips-per-host: 4",
                                      "chips-per-host: 2")
    tpu_hosts = j_inventory.make_test_fleet(slice_id="row",
                                            host_grid=(2, 1),
                                            chip_block=(2, 2))
    # 2x2 chips a host on the torus: a 4x1 rectangle of 2-chip hosts
    # cannot tile (2, 2) blocks, so the reference refuses either way;
    # the port takes cards 2,3 of the half-reserved node and 0,1 of the
    # free one
    pair = Pair.from_yaml(text.replace("topology: 4x2", "topology: 2x2"),
                          tpu_hosts)
    for side in (pair.j, pair.t):
        host = side.inv.host("row-h0-0")
        side.ledger.commit([_intruder(side, host, host.chip_ids()[:2])])
    assert not pair.j.evaluate("trainer", [0, 1]).passed
    tr = pair.t.evaluate("trainer", [0, 1])
    assert tr.passed, tr.outcome.flatten()
    assert [(i.agent_id, i.env["CUDA_VISIBLE_DEVICES"])
            for i in tr.task_infos] == [("row-h0-0", "2,3"),
                                        ("row-h1-0", "0,1")]
    pair.t.commit(tr)
    cards = [c for r in pair.t.ledger.all() for c in r.chip_ids]
    assert len(cards) == len(set(cards)) == 6


def test_wrap_attributes_mean_nothing_on_a_fabric():
    """``ici_wrap``/``ring_x``/``ring_y`` have no counterpart: the
    node set is the same with and without them."""
    picks = []
    for attrs in ({}, {"ici_wrap": "x", "ring_x": "3", "ring_y": "1"}):
        hosts = [GpuHost(host_id=f"r{i}", slice_id="row", generation="h100",
                         node=i, gpus=4, attributes=attrs)
                 for i in range(3)]
        side = _port_side(TWO_HOST_GANG_YAML, hosts)
        side.ledger.commit([_intruder(side, hosts[0], hosts[0].chip_ids())])
        picks.append([i.agent_id for i in
                      side.evaluate("trainer", [0, 1]).task_infos])
    assert picks == [["r1", "r2"], ["r1", "r2"]]


@pytest.mark.parametrize("gang", [False, True])
def test_no_host_of_the_generation_fails(gang):
    """A pod never lands on a card of another generation, nor on a CPU
    host, gang or not; the outcome says why."""
    text = TWO_HOST_GANG_YAML if gang else PARTIAL_YAML
    pod = "trainer" if gang else "worker"
    instances = [0, 1] if gang else [0]
    hosts = (make_test_fleet("old", nodes=2, gpus=4, generation="a100")
             + [GpuHost(host_id=f"cpu{i}", cpus=64.0, memory_mb=1 << 20)
                for i in range(2)])
    side = _port_side(text, hosts)
    result = side.evaluate(pod, instances)
    assert not result.passed and result.reservations == []
    flat = "\n".join(result.outcome.flatten())
    if gang:
        assert "no GPU hosts in inventory" in flat
    else:
        # the CPU hosts hold no free card: the index never offers them
        assert "generation 'a100', pod needs 'h100'" in flat


def test_cpu_pod_tasks_see_no_card():
    hosts = make_test_fleet("fab", nodes=1, gpus=8)
    side = _port_side(CPU_YAML, hosts)
    result = side.evaluate("hello", [0])
    assert result.passed
    assert result.task_infos[0].env["CUDA_VISIBLE_DEVICES"] == ""
    assert "TPU_CHIP_IDS" not in result.task_infos[0].env


def test_two_pods_share_a_node_on_disjoint_cards():
    """Two 4-card pods on one 8-GPU node, placed one after the other
    against one ledger: cards 0-3 and 4-7."""
    text = PARTIAL_YAML.replace("count: 1", "count: 2").replace(
        "chips-per-host: 2", "chips-per-host: 4")
    side = _port_side(text, make_test_fleet("fab", nodes=1, gpus=8))
    seen = []
    for index in (0, 1):
        result = side.evaluate("worker", [index], ["main"])
        assert result.passed, result.outcome.flatten()
        side.commit(result)
        seen.append(result.task_infos[0].env["CUDA_VISIBLE_DEVICES"])
    assert seen == ["0,1,2,3", "4,5,6,7"]
    assert not side.evaluate("worker", [2], ["main"]).passed


def test_fleet_of_1024_nodes_places_a_gang_in_one_fabric():
    """The port's svc.yml trainer (4 hosts of 4 cards, topology 4x4) on
    64 fabrics of 16 8-GPU nodes: one fabric, no card twice, and a
    repeat failure short-circuits on the memo."""
    fleet = []
    for f in range(64):
        fleet += make_test_fleet(f"fabric-{f:02d}", nodes=16)
    spec = _render(t_yaml, t_options, PORT_FRAMEWORKS, "svc.yml")
    side = Side(spec, fleet, TMemPersister(), t_state, t_ledger, t_evaluate,
                t_inventory, t_step)
    cards = []
    for copy in range(3):
        result = side.evaluate("trainer", [0, 1, 2, 3], ["worker"],
                               recovery="PERMANENT" if copy else "NONE")
        assert result.passed
        assert len({side.inv.host(i.agent_id).slice_id
                    for i in result.task_infos}) == 1
        side.ledger.commit(result.reservations)
        cards += [c for r in result.reservations for c in r.chip_ids]
    assert len(cards) == len(set(cards)) == 3 * 16

    side.ev.metrics = Metrics()
    for host in fleet:
        side.inv.mark_down(host.host_id)
    t0 = time.perf_counter()
    assert not side.evaluate("trainer", [0, 1, 2, 3], ["worker"]).passed
    assert not side.evaluate("trainer", [0, 1, 2, 3], ["worker"]).passed
    assert side.ev.metrics.counters()["offers.eval.shortcircuit"] == 1
    assert time.perf_counter() - t0 < 30

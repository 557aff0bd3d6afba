"""The port's HA plane (``dcos_commons_tpu_torch/ha``) against the JAX
package's, on the CPU.

- ``PlanCheckpointer``: twin schedulers (``test_torch_scheduler``'s
  wiring) driven through the same deploy and operator interrupts write
  the same checkpoint bytes, and each package's ``restore_plans`` puts
  the other's checkpoint back onto freshly built plans with the same
  report and the same plan states.
- The leader lease on twin persisters with an injected clock: acquire,
  renew, a takeover at expiry, the deposed leader's ``renew`` and
  ``verify``, its fenced writes through ``FencedPersister``, and
  resign: the same results, errors, epochs and stored bytes at every
  step, and each package reads the other's lease record.
- ``find_remote_persister`` finds the ``RemotePersister`` under the
  ``FencedPersister`` and cache layers, as the JAX one finds its own,
  and ``HAState.replication_status`` reads the state server's
  replication status through it."""

import json
import os

import pytest

from dcos_commons_tpu.ha import election as j_election
from dcos_commons_tpu.ha import rehydrate as j_rehydrate
from dcos_commons_tpu.storage import MemPersister as JMem
from dcos_commons_tpu_torch.ha import election as t_election
from dcos_commons_tpu_torch.ha import rehydrate as t_rehydrate
from dcos_commons_tpu_torch.storage import MemPersister as TMem
from test_torch_scheduler import (
    PACKAGES,
    REPO,
    cpu_fleet,
    pinned,  # noqa: F401 — a fixture
    render,
    twins,
)

REHYDRATE = {"jax": j_rehydrate, "port": t_rehydrate}
ELECTION = {"jax": j_election, "port": t_election}
MEM = {"jax": JMem, "port": TMem}


def _specs(rel):
    return [render(pkg, os.path.join(REPO, "frameworks", rel))
            for pkg in PACKAGES]


def _checkpoints(side):
    store = side.sched.state_store
    return {key: store.fetch_property(key)
            for key in sorted(store.fetch_property_keys())
            if key.startswith(REHYDRATE[side.pkg.name].PLAN_CKPT_PREFIX)}


def _states(plans):
    return {name: REHYDRATE["jax"].serialize_plan_state(plan)
            for name, plan in sorted(plans.items())}


def _drive_with_verbs(side):
    """hdfs's deploy two cycles in, the deploy plan interrupted, the
    backup plan proceeded and its first phase interrupted, then cycles
    until idle."""
    for _ in range(2):
        side.cycle(fail_every=0)
    side.sched.plan("deploy").interrupt()
    backup = side.sched.plan("backup")
    backup.proceed()
    backup.phases[0].interrupt()
    side.sched.nudge()
    return side.drive(fail_every=0, proceed=False)


def test_plan_checkpoints_are_the_same_bytes(pinned, tmp_path):
    sides = twins(_specs("hdfs/svc.yml"), cpu_fleet(), tmp_path, pinned)
    traces = [_drive_with_verbs(side) for side in sides]
    assert traces[1] == traces[0]
    got = [_checkpoints(side) for side in sides]
    assert got[1] == got[0]
    prefix = REHYDRATE["jax"].PLAN_CKPT_PREFIX
    assert {"deploy", "backup", "recovery"} <= {
        key[len(prefix):] for key in got[0]}
    assert json.loads(got[0][prefix + "deploy"])["interrupted"] is True
    for side in sides:
        side.close()


@pytest.mark.parametrize("writer,reader", [(0, 1), (1, 0)],
                         ids=["jax-to-port", "port-to-jax"])
def test_plan_checkpoints_restore_across_packages(writer, reader, pinned,
                                                  tmp_path):
    """The writer's checkpoints restored by the reader onto plans built
    fresh from its own spec: the same report and plan states as the
    writer restoring its own."""
    sides = twins(_specs("hdfs/svc.yml"), cpu_fleet(), tmp_path, pinned)
    for side in sides:
        _drive_with_verbs(side)
    written = _checkpoints(sides[writer])
    want = _states(sides[writer].sched.plans())
    reports = []
    for index in (writer, reader):
        side = sides[index]
        mod = REHYDRATE[side.pkg.name]
        fresh = twins_fresh(side, tmp_path / f"fresh-{index}-{writer}")
        store = fresh.sched.state_store
        for key, value in written.items():
            store.store_property(key, value)
        report = mod.RehydrationReport()
        mod.restore_plans(store, fresh.sched.plans(), report)
        reports.append((report.to_dict(), _states(fresh.sched.plans())))
        fresh.close()
    assert reports[1] == reports[0]
    assert reports[0][0]["restored_plans"] >= 2
    states = reports[0][1]
    assert states["deploy"]["interrupted"] == want["deploy"]["interrupted"]
    assert states["backup"] == want["backup"]
    for side in sides:
        side.close()


def twins_fresh(side, directory):
    """The side's package wired anew over an empty WAL directory, with
    the same spec, fleet and clock."""
    from test_torch_scheduler import Twin

    return Twin(side.pkg, side.spec, cpu_fleet(), str(directory), side.clock)


# -- the leader lease ---------------------------------------------------


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _lease_script(pkg_name):
    """Two candidates on one store: the run of every verb and what the
    store holds after it."""
    election = ELECTION[pkg_name]
    persister = MEM[pkg_name]()
    clock = FakeClock()
    a = election.LeaderLease(persister, "svc", "sched-a", ttl_s=10.0,
                             clock=clock)
    b = election.LeaderLease(persister, "svc", "sched-b", ttl_s=10.0,
                             clock=clock)
    fenced_a = election.FencedPersister(persister, a)
    out = []

    def note(label, fn):
        try:
            result = fn()
        except election.LeaseFencedError as e:
            result = ("fenced", str(e))
        state = election.read_lease(persister, "svc")
        out.append((label, result, a.is_leader, a.epoch, b.is_leader,
                    b.epoch, state.owner, state.epoch, state.expires_at,
                    persister.get_or_none(
                        f"{election.LEADER_PREFIX}/svc")))

    note("a acquires", a.try_acquire)
    note("b refused", b.try_acquire)
    clock.t += 5
    note("a renews", a.renew)
    note("a writes", lambda: fenced_a.set("/data/x", b"1"))
    clock.t += 11
    note("b takes over", b.try_acquire)
    note("a renew deposed", a.renew)
    note("a verify", a.verify)
    note("a write fenced", lambda: fenced_a.set("/data/x", b"2"))
    note("b resigns", b.resign)
    clock.t += 1
    note("a re-acquires", a.try_acquire)
    out.append(("takeovers", a.takeovers, b.takeovers))
    out.append(("tree", sorted(persister.dump().items())))
    return out


def test_lease_acquire_renew_expire_fence_as_the_jax_package():
    jax_run, port_run = _lease_script("jax"), _lease_script("port")
    assert port_run == jax_run
    labels = {row[0]: row for row in jax_run}
    assert labels["a acquires"][1] is True
    assert labels["b takes over"][1] is True
    assert labels["a write fenced"][1][0] == "fenced"
    assert labels["tree"][1]


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_lease_record_reads_across_packages(writer, reader):
    persister = MEM[writer]()
    clock = FakeClock()
    lease = ELECTION[writer].LeaderLease(persister, "svc", "sched-a",
                                         ttl_s=10.0, clock=clock)
    assert lease.try_acquire()
    other = MEM[reader]()
    for path, value in persister.dump().items():
        if value is not None:
            other.set(path, value)
    got = ELECTION[reader].read_lease(other, "svc")
    want = ELECTION[writer].read_lease(persister, "svc")
    assert (got.owner, got.epoch, got.expires_at) == (
        want.owner, want.epoch, want.expires_at)
    # the reader's candidate sees a live lease and is refused, then
    # takes it over at expiry with the next epoch
    candidate = ELECTION[reader].LeaderLease(other, "svc", "sched-b",
                                             ttl_s=10.0, clock=clock)
    assert candidate.try_acquire() is False
    clock.t += 11
    assert candidate.try_acquire() is True
    assert candidate.epoch == want.epoch + 1


def test_find_remote_persister_finds_it():
    import importlib

    found = {}
    for pkg, election in ELECTION.items():
        root = election.__name__.rsplit(".ha.", 1)[0]
        remote = importlib.import_module(f"{root}.storage.remote")
        cache = importlib.import_module(f"{root}.storage.cache")
        server = remote.StateServer().start()
        try:
            client = remote.RemotePersister(server.url)
            lease = election.LeaderLock(client, name="svc", owner="a",
                                        ttl_s=30.0)
            assert lease.acquire()
            fenced = election.FencedPersister(
                cache.PersisterCache(client), lease)
            status = election.HAState(fenced, "svc", lease=lease) \
                .replication_status(refresh=True)
            found[pkg] = (
                election.find_remote_persister(fenced) is client,
                election.find_remote_persister(client) is client,
                election.find_remote_persister(MEM[pkg]()),
                sorted(status), status["role"], status["epoch"])
        finally:
            server.stop()
    assert found["port"] == found["jax"]
    assert found["jax"][:3] == (True, True, None)
    assert found["jax"][4:] == ("primary", 1)

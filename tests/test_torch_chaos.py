"""The port's chaos harness (testing/chaos.py) held against the JAX
package's.

Each scenario of the reference's chaos tests (tests/test_ha_failover.py,
tests/test_preemption.py, tests/test_multislice.py) runs on both
harnesses with the same seed: the single kill at each span-boundary
kind, the kill during the gang's rollout, the unkilled baseline, the
auto-derived matrix and its seed replay, and the preemption storms.
The port's report equals the reference's in killed, incarnations,
converged, the pre-kill COMPLETE steps, the rehydration counts and the
final task names; task ids are random, so they are compared by
structure (which names kept their id across the failover).  The
real-process matrix is in the chaos tier (``-m chaos``, also ``slow``);
``CHAOS_SEED=<seed>`` replays a schedule.
"""

import os

import pytest

from dcos_commons_tpu.testing import chaos as j_chaos
from dcos_commons_tpu_torch.testing import chaos as t_chaos

CHAOS_SEED = int(os.environ.get("CHAOS_SEED", "0"))
SIDES = (j_chaos, t_chaos)


def _counts(rehydration):
    if rehydration is None:
        return None
    return {k: v for k, v in rehydration.items() if isinstance(v, int)}


def report_shape(report):
    """What a report says, with the random task ids reduced to which
    names kept the id they had at the kill."""
    final = report.final_task_ids
    return {
        "killed": report.killed,
        "incarnations": report.incarnations,
        "converged": report.converged,
        "prekill_complete_steps": list(report.prekill_complete_steps),
        "rehydration": _counts(report.rehydration),
        "final_names": sorted(final),
        "kept_running_id": {
            name: final.get(name) == task_id
            for name, task_id in report.prekill_task_ids.items()
        },
        "kept_staging_id": {
            name: final.get(name) == task_id
            for name, task_id in report.prekill_staging_ids.items()
        },
    }


def twin_run(kill_of, timeout_s=30):
    """One harness run on each side; returns both reports."""
    reports = []
    for mod in SIDES:
        harness = mod.ChaosHarness(seed=CHAOS_SEED)
        try:
            reports.append(harness.run(kill_of(mod), timeout_s=timeout_s))
        finally:
            harness.shutdown()
    assert report_shape(reports[1]) == report_shape(reports[0])
    return reports


def test_same_kinds_and_fleets():
    assert t_chaos.CHAOS_KINDS == j_chaos.CHAOS_KINDS
    assert t_chaos.AUTO_CHAOS_KINDS == j_chaos.AUTO_CHAOS_KINDS
    fleet = t_chaos.chaos_fleet()
    assert [h.chips_per_host for h in fleet] == [4, 4, 4, 4]
    assert {h.slice_id for h in fleet} == {"fabric-0"}
    assert {h.generation for h in fleet} == {"h100"}
    storm = t_chaos.storm_fleet()
    assert len(storm) == 12 and len({h.slice_id for h in storm}) == 3
    gang = t_chaos.from_yaml(t_chaos.CHAOS_GANG_YAML).pod("trainer")
    assert (gang.gpu.generation, gang.gpu.chips_per_host,
            gang.gpu.topology, gang.count) == ("h100", 4, "4x4", 4)
    multi = t_chaos.from_yaml(t_chaos.CHAOS_MULTISLICE_YAML).pod("trainer")
    assert (multi.gpu.slices, multi.gpu.elastic, multi.gpu.min_hosts,
            multi.count) == (2, True, 4, 8)


@pytest.mark.parametrize("kind", t_chaos.CHAOS_KINDS)
def test_single_kill_twins(kind):
    """The reference's fast-tier single kill at each kind, on both
    harnesses, with the reference test's per-kind reconciliation."""
    _, report = twin_run(lambda mod: mod.KillPoint(kind, 1))
    assert report.killed and report.converged and \
        report.incarnations == 2, report.describe()
    rehydration = report.rehydration
    if kind == "post-evaluate":
        assert rehydration["reissued"] == 0 and \
            rehydration["adopted"] == 0, report.describe()
    elif kind == "post-wal":
        assert rehydration["reissued"] >= 1, report.describe()
        for name, staging_id in report.prekill_staging_ids.items():
            assert report.final_task_ids.get(name) != staging_id
    else:
        assert rehydration["adopted"] >= 1 and \
            rehydration["reissued"] == 0, report.describe()
    assert rehydration["double_reservations"] == 0


def test_kill_during_gang_rollout_twin():
    _, report = twin_run(lambda mod: mod.KillPoint("post-wal", 2))
    assert report.killed and report.converged, report.describe()
    assert ("deploy", "ctl", "ctl-0:[server]") in \
        report.prekill_complete_steps, report.describe()
    assert report.rehydration["reissued"] == 4, report.describe()


def test_unkilled_baseline_twin():
    _, report = twin_run(lambda mod: None)
    assert report.converged and not report.killed
    assert report.incarnations == 1


def test_kill_point_refuses_an_unknown_kind():
    with pytest.raises(ValueError):
        t_chaos.KillPoint("mid-nothing")
    with pytest.raises(ValueError):
        t_chaos.PreemptSpec(at="mid-nothing")


def _port_key(point):
    file, function = str(point["file"]), str(point["function"])
    if file.startswith("dcos_commons_tpu/"):
        file = "dcos_commons_tpu_torch/" + file.split("/", 1)[1]
        function = "dcos_commons_tpu_torch." + function.split(".", 1)[1]
    return (file, function, point["kind"])


def _auto(mod, budget):
    matrix = mod.AutoChaosMatrix(seed=CHAOS_SEED, budget=budget)
    return matrix.run(lambda seed: mod.ChaosHarness(seed=seed),
                      timeout_s=30)


def test_auto_matrix_twin():
    """The statically derived matrix: the same boundaries reached and
    unreached, the same budgeted targets in the same order, each
    crash converging with no unWAL'd effect, on both sides."""
    j, t = (_auto(mod, 6) for mod in SIDES)
    assert [_port_key(p) for p in t.all_points] == [
        _port_key(p) for p in j.all_points]
    assert [_port_key(p) for p in t.reached] == [
        _port_key(p) for p in j.reached]
    assert [_port_key(p) for p in t.targeted] == [
        _port_key(p) for p in j.targeted]
    assert len(t.reached) > len(t_chaos.CHAOS_KINDS), t.describe()
    keys = {t_chaos.point_key(p) for p in t.all_points}
    reached = {t_chaos.point_key(p) for p in t.reached}
    unreached = {t_chaos.point_key(p) for p in t.unreached}
    assert not reached & unreached and reached | unreached == keys
    assert len(t.reports) == len(t.targeted) == min(6, len(t.reached))
    for jb, tb in zip(j.reports, t.reports):
        assert report_shape(tb.report) == report_shape(jb.report)
        assert tb.report.killed and tb.report.converged
        assert tb.unwald_at_death == jb.unwald_at_death == []


def test_auto_matrix_seed_replays_the_same_subset():
    runs = [[_port_key(p) for p in _auto(t_chaos, 2).targeted]
            for _ in range(2)]
    assert runs[0] == runs[1] and len(runs[0]) == 2
    assert runs[0] == [_port_key(p) for p in _auto(j_chaos, 2).targeted]


def test_seeded_unwald_launch_bug_caught_at_runtime_twin():
    """The launch moved ahead of its WAL write: a crash at the
    store_launch boundary sees agent-active tasks the store never
    heard of, on both sides."""
    shapes = []
    for mod in SIDES:
        points = mod.auto_chaos_points()
        target = next(
            p for p in points
            if str(p["file"]).endswith("state/state_store.py")
            and str(p["function"]).endswith("store_launch")
        )
        harness = mod.ChaosHarness(seed=CHAOS_SEED)
        proxy = mod.PersisterCrashProxy(harness.persister, points,
                                        target=target)
        harness.persister = proxy
        try:
            scheduler = harness.build_scheduler()
            real_record = scheduler.launch_recorder.record

            def buggy_record(infos, parent=None, _agent=harness.agent,
                             _real=real_record):
                _agent.launch(infos)  # the effect escapes its WAL
                _real(infos, parent=parent)

            scheduler.launch_recorder.record = buggy_record
            boundary = harness.run_boundary(proxy, timeout_s=30)
        finally:
            harness.shutdown()
        assert boundary.report.killed and boundary.report.converged
        assert boundary.unwald_at_death, boundary.report.describe()
        shapes.append((report_shape(boundary.report),
                       len(boundary.unwald_at_death)))
    assert shapes[1] == shapes[0]


# -- preemption storms ---------------------------------------------------


def storm_shape(report):
    return {
        "preempted": len(report.preempted),
        "incarnations": report.incarnations,
        "converged": report.converged,
        "recoveries_seen": report.recoveries_seen,
        "final_names": sorted(report.final_task_ids),
        "final_fabrics": len(set(report.final_hosts.values())),
    }


STORMS = {
    "single": lambda m: [m.PreemptSpec(at=m.STORM_START, hosts=1)],
    "second-mid-recovery": lambda m: [
        m.PreemptSpec(at=m.STORM_START, hosts=1),
        m.PreemptSpec(at=m.RECOVERY_ACTIVE, occurrence=2, hosts=1),
    ],
    "with-scheduler-kill": lambda m: [
        m.PreemptSpec(at=m.STORM_START, hosts=1),
        m.PreemptSpec(at="post-wal", occurrence=1, hosts=1,
                      kill_scheduler=True),
    ],
}


@pytest.mark.parametrize("name", list(STORMS))
def test_storm_twins(name):
    reports = []
    for mod in SIDES:
        storm = mod.PreemptionStorm(STORMS[name](mod), seed=CHAOS_SEED)
        try:
            reports.append(storm.run(timeout_s=60.0))
        finally:
            storm.shutdown()
    assert storm_shape(reports[1]) == storm_shape(reports[0])
    report = reports[1]
    assert report.converged, report.describe()
    assert len(report.preempted) == (1 if name == "single" else 2)
    if name == "with-scheduler-kill":
        assert report.incarnations == 2


def test_whole_fabric_storm_twin():
    """A whole-slice preemption takes a whole fabric: all four of its
    nodes die together, and the two-fabric gang converges back to full
    width on the spare fabric."""
    from dcos_commons_tpu.offer.inventory import make_test_fleet as j_fleet
    from dcos_commons_tpu_torch.offer.inventory import (
        make_test_fleet as t_fleet,
    )

    fleets = (
        [h for s in ("gang-a", "gang-b", "gang-c")
         for h in j_fleet(slice_id=s)],
        [h for s in ("gang-a", "gang-b", "gang-c")
         for h in t_fleet(slice_id=s, nodes=4, gpus=4)],
    )
    reports = []
    for mod, hosts in zip(SIDES, fleets):
        storm = mod.PreemptionStorm(
            [mod.PreemptSpec(at=mod.STORM_START, hosts=1,
                             whole_slice=True)],
            yaml_text=mod.CHAOS_MULTISLICE_YAML, hosts=hosts,
            seed=CHAOS_SEED,
        )
        try:
            reports.append(storm.run(timeout_s=120.0))
        finally:
            storm.shutdown()
    assert storm_shape(reports[1]) == storm_shape(reports[0])
    report = reports[1]
    assert report.converged and len(report.preempted) == 4
    assert len({h.rsplit("-n", 1)[0] for h in report.preempted}) == 1


# -- the chaos tier: real task processes ---------------------------------


@pytest.mark.slow
@pytest.mark.chaos
def test_chaos_matrix_gang_deploy_local_processes(tmp_path):
    """The reference's acceptance matrix on the port: the 4-host gang
    deployed through a real ``LocalProcessAgent`` (task processes
    survive the scheduler's death), the scheduler killed at every kind
    x two occurrences, every run converging under the full invariant
    set, reissuing only after a post-wal death."""
    matrix = t_chaos.ChaosMatrix(occurrences=(1, 2), seed=CHAOS_SEED)
    run_dirs = iter(range(10_000))

    def factory(seed):
        return t_chaos.ChaosHarness(
            workdir=str(tmp_path / f"agent-{next(run_dirs)}"),
            seed=seed, task_cmd="sleep 120",
        )

    reports = matrix.run(factory, timeout_s=120)
    assert len(reports) == len(t_chaos.CHAOS_KINDS) * 2
    for report in reports:
        assert report.killed and report.converged, report.describe()
        rehydration = report.rehydration
        assert rehydration is not None, report.describe()
        if report.kill.kind == "post-wal":
            assert rehydration["reissued"] >= 1, report.describe()
        else:
            assert rehydration["reissued"] == 0, report.describe()
        assert rehydration["double_reservations"] == 0, report.describe()

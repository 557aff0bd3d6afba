"""The port's racecheck and lockcheck (analysis/racecheck.py,
analysis/lockcheck.py) held against the JAX package's.

Every test of tests/test_racecheck.py runs on the port: its static
fixtures go through both ``analyze_paths`` (the port's at the path
mapped under ``dcos_commons_tpu_torch/``) and must give the same rule
at the same line, the same probe set and the same thread roles; its
dynamic cases run on the port's vector clocks, the real-engine case on
the port's ``PagedEngine`` and ``migrate_session``.  The reference
gate's lockcheck cases (tests/test_lint_gate.py) run on the port's
lockcheck.  The port's ``install()`` neither wraps the reference
checker's locks nor leaves a factory behind, the port's threaded
modules run clean under it, and the port's tree passes the static gate
with an empty baseline.
"""

import inspect
import os
import sys
import textwrap
import threading
import time

import pytest

import test_lint_gate as gate
import test_racecheck as rc_tests
from dcos_commons_tpu.analysis import racecheck as j_race
from dcos_commons_tpu_torch.analysis import baseline as t_baseline
from dcos_commons_tpu_torch.analysis import lockcheck as t_lock
from dcos_commons_tpu_torch.analysis import racecheck as t_race
from test_torch_lint import port_rel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _shape(findings):
    return sorted((f.rule, f.line) for f in findings)


def _analyze(module, root, rel, source):
    path = root / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(source))
    return module.analyze_paths([str(path)], str(root))


def _twin_race_fixture(tmp_path, source, rule_id=None,
                       rel="dcos_commons_tpu/mod.py"):
    """tests/test_racecheck.py's ``_race_fixture`` through both
    analyzers; returns the port's (result, findings, suppressed)."""
    j = _analyze(j_race, tmp_path / "ref", rel, source)
    t = _analyze(t_race, tmp_path / "port", port_rel(rel), source)
    assert _shape(t.findings) == _shape(j.findings), rel
    assert _shape(t.suppressed) == _shape(j.suppressed), rel
    assert {f.file for f in t.findings + t.suppressed} <= {port_rel(rel)}
    assert t.shared_attrs == j.shared_attrs
    assert t.roles == j.roles
    _TWINNED.append(rel)
    pick = lambda fs: [f for f in fs if rule_id is None or f.rule == rule_id]  # noqa: E731
    return t, pick(t.findings), pick(t.suppressed)


_TWINNED: list = []

# tests/test_racecheck.py, every test: the static ones through both
# analyzers, the dynamic ones on the port's checker
RACE_TESTS = [
    "test_rule_unguarded_shared_write",
    "test_rule_unguarded_common_lock_is_clean",
    "test_rule_unguarded_handoff_annotation_exempts",
    "test_rule_unguarded_queue_handoff_is_clean",
    "test_rule_unguarded_locked_convention_is_clean",
    "test_rule_callback_thread",
    "test_rule_collective_offloop",
    "test_rule_check_then_act",
    "test_clean_threaded_module_has_zero_findings",
    "test_race_rule_catalog_lists_every_rule",
    "test_env_var_and_lockcheck_alias",
    "test_dynamic_seeded_two_thread_race_reports_both_stacks",
    "test_dynamic_ordering_edges_suppress_the_pair",
    "test_dynamic_lock_cycle_is_the_race_lock_cycle_rule",
    "test_pr16_prefix_shape_foreign_splice_races",
    "test_pr16_real_engine_splice_mid_tick_is_ordered",
]


def _call(fn, **fixtures):
    return fn(**{name: fixtures[name]
                 for name in inspect.signature(fn).parameters})


@pytest.mark.parametrize("name", RACE_TESTS)
def test_racecheck_twins(name, tmp_path, monkeypatch):
    from dcos_commons_tpu_torch.serve import engine, migration

    monkeypatch.setattr(rc_tests, "_race_fixture", _twin_race_fixture)
    monkeypatch.setattr(rc_tests, "racecheck", t_race)
    monkeypatch.setattr(rc_tests, "lockcheck", t_lock)
    monkeypatch.setattr(rc_tests, "race_rule_catalog",
                        t_race.race_rule_catalog)
    # the real-engine case imports the serving engine by name
    monkeypatch.setitem(sys.modules, "dcos_commons_tpu.serve.engine", engine)
    monkeypatch.setitem(sys.modules, "dcos_commons_tpu.serve.migration",
                        migration)
    del _TWINNED[:]
    _call(getattr(rc_tests, name), tmp_path=tmp_path,
          monkeypatch=monkeypatch)
    static = "tmp_path" in inspect.signature(
        getattr(rc_tests, name)).parameters
    assert bool(_TWINNED) == static, name


def test_every_test_of_the_reference_racecheck_is_twinned():
    names = {name for name, fn in vars(rc_tests).items()
             if name.startswith("test_") and callable(fn)}
    assert names == set(RACE_TESTS)


# the reference gate's lockcheck cases (tests/test_lint_gate.py)
LOCKCHECK_TESTS = [
    "test_lockcheck_reports_inverse_order_cycle",
    "test_lockcheck_consistent_order_is_clean",
    "test_lockcheck_rlock_reentry_no_self_edge",
    "test_lockcheck_watch_flags_cross_thread_unguarded_write",
    "test_lockcheck_uninstall_restores_factories",
    "test_lockcheck_watch_guarded_write_does_not_mask_unguarded",
]


@pytest.mark.parametrize("name", LOCKCHECK_TESTS)
def test_lockcheck_twins(name, tmp_path, monkeypatch):
    monkeypatch.setattr(gate, "lockcheck", t_lock)
    _call(getattr(gate, name), tmp_path=tmp_path)


def test_every_lockcheck_test_of_the_reference_gate_is_twinned():
    assert {name for name in vars(gate)
            if name.startswith("test_lockcheck")} == set(LOCKCHECK_TESTS)


def test_rule_catalogs_are_the_same_rules():
    for rid in (t_race.RULE_UNGUARDED, t_race.RULE_CALLBACK,
                t_race.RULE_COLLECTIVE, t_race.RULE_CHECK_THEN_ACT,
                t_race.RULE_LOCK_CYCLE, t_race.RULE_UNORDERED):
        assert rid in t_race.race_rule_catalog()
    assert sorted(t_race._RULE_DOCS) == sorted(j_race._RULE_DOCS)
    assert t_lock.ENV_VAR == "SDKLINT_LOCKCHECK"
    assert t_lock.install is t_race.install
    assert t_race.ENV_VAR == j_race.ENV_VAR


# -- the port's vocabulary ----------------------------------------------


_GANG_THREAD = """
import threading

import torch.distributed as dist


class Ticker:
    def start(self):
        t = threading.Thread(target=self._loop, name="tick-loop")
        t.start()

    def _loop(self):
        {call}
"""


@pytest.mark.parametrize("call,op", [
    ("dist.all_reduce(self.buf)", "all_reduce"),
    ("dist.broadcast(self.buf, src=0)", "broadcast"),
    ("dist.all_gather_into_tensor(self.out, self.buf)",
     "all_gather_into_tensor"),
    ("broadcast_int(self.n, self.mesh)", "broadcast_int"),
    ("reduce_gradients(self.grads, self.dims, self.mesh)",
     "reduce_gradients"),
])
def test_torch_collective_off_the_main_thread_is_flagged(tmp_path, call,
                                                          op):
    src = _GANG_THREAD.format(call=call)
    t = _analyze(t_race, tmp_path, "dcos_commons_tpu_torch/serve/mod.py",
                 src)
    found = [f for f in t.findings if f.rule == t_race.RULE_COLLECTIVE]
    assert len(found) == 1 and op in found[0].message
    assert "tick-loop" in found[0].message
    # the reference's vocabulary knows only the names jax shares
    j = _analyze(j_race, tmp_path / "ref", "dcos_commons_tpu/serve/mod.py",
                 src)
    assert bool([f for f in j.findings if f.rule == j_race.RULE_COLLECTIVE]
                ) == (op in j_race._COLLECTIVES)


def test_scope_is_the_port_package(tmp_path):
    src = _GANG_THREAD.format(call="dist.all_reduce(self.buf)")
    for rel in ("dcos_commons_tpu_torch/serve/mod.py",
                "dcos_commons_tpu/serve/mod.py"):
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(src))
    result = t_race.analyze_tree(str(tmp_path))
    assert {f.file for f in result.findings} == {
        "dcos_commons_tpu_torch/serve/mod.py"}


def test_repo_race_gate_with_an_empty_baseline():
    """Zero static race findings over the port's tree; the handoff notes
    the port carries are suppressions, not absences."""
    result = t_race.analyze_tree(REPO)
    assert result.findings == [], "\n".join(
        f.render() for f in result.findings)
    assert result.files_checked >= 150
    assert t_baseline.load_baseline(t_baseline.baseline_path(REPO)) == {}
    handoffs = sorted((f.file, f.message.split(" is written")[0].split()[-1])
                      for f in result.suppressed)
    assert handoffs == [
        ("dcos_commons_tpu_torch/multi/scheduler.py",
         "MultiServiceScheduler._orphan_index"),
        ("dcos_commons_tpu_torch/scheduler/scheduler.py",
         "DefaultScheduler._plan_dirty"),
        ("dcos_commons_tpu_torch/scheduler/scheduler.py",
         "DefaultScheduler._suppressed"),
        ("dcos_commons_tpu_torch/scheduler/scheduler.py",
         "DefaultScheduler._trace_ctx"),
        ("dcos_commons_tpu_torch/scheduler/scheduler.py",
         "DefaultScheduler.journal"),
    ]
    # the thread model is the reference's: the same classes share the
    # same attributes across threads, the set the dynamic probes watch
    shared = t_race.shared_write_map(REPO)
    assert shared == j_race.shared_write_map(REPO)
    for cls in ("SlotEngine", "AsyncCheckpointer", "DefaultScheduler",
                "HealthMonitor", "MultiServiceScheduler"):
        assert shared.get(cls), cls
    assert "fenced" in shared["AsyncCheckpointer"]


# -- install() beside the reference's checker ---------------------------


def _factories():
    return (threading.Lock, threading.RLock, threading.Condition,
            threading.Thread.start, threading.Thread.join)


def _raw_lock_types():
    import _thread

    return (type(_thread.allocate_lock()), type(_thread.RLock()))


def test_install_wraps_no_other_checkers_locks():
    """Installed over the reference's checker, the port's wraps the
    interpreter's locks, and each uninstall puts back what its install
    found; either checker can be taken off first."""
    before = _factories()
    if j_race.is_enabled() or t_race.is_enabled():
        pytest.skip("a race checker is already installed for the session")
    for order in ("lifo", "fifo"):
        j_race.install()
        between = _factories()
        t_race.install()
        try:
            for make, reentrant in ((threading.Lock, False),
                                    (threading.RLock, True)):
                lock = make()
                assert isinstance(lock, t_race.InstrumentedLock)
                assert isinstance(lock._inner, _raw_lock_types()), lock
                assert lock._reentrant is reentrant
            cond = threading.Condition()
            assert isinstance(cond._lock, t_race.InstrumentedLock)
            with cond:
                cond.notify()
        finally:
            if order == "lifo":
                t_race.uninstall()
                assert _factories() == between
                j_race.uninstall()
            else:
                j_race.uninstall()
                t_race.uninstall()
        assert _factories() == before, order
        assert not t_race.is_enabled() and not j_race.is_enabled()


def test_reference_install_over_the_port_restores_the_originals():
    if j_race.is_enabled() or t_race.is_enabled():
        pytest.skip("a race checker is already installed for the session")
    before = _factories()
    t_race.install()
    j_race.install()
    j_race.uninstall()
    t_race.uninstall()
    assert _factories() == before


def test_both_checkers_see_a_cycle_made_while_both_are_installed():
    if j_race.is_enabled() or t_race.is_enabled():
        pytest.skip("a race checker is already installed for the session")
    j_race.install()
    t_race.install()
    j_race.reset()
    t_race.reset()
    try:
        a = threading.Lock()
        b = threading.Lock()
        for first, second in ((a, b), (b, a)):
            t = threading.Thread(
                target=lambda x=first, y=second: _nest(x, y), daemon=True)
            t.start()
            t.join(timeout=5)
        rep = t_race.report()
        assert len(rep.cycles) == 1, rep.describe()
        # the port's locks wrap raw locks: the reference saw nothing
        assert j_race.report().cycles == []
    finally:
        t_race.uninstall()
        j_race.uninstall()
        t_race.reset()
        j_race.reset()


def _nest(outer, inner):
    with outer:
        with inner:
            pass


# -- the port's threaded modules under the port's checker -----------------


@pytest.fixture
def port_racecheck():
    """The port's dynamic checker around one test: the given classes'
    cross-thread attributes (the static pass's map) watched, and the
    test fails on any lock-order cycle or unordered write."""
    if t_race.is_enabled():
        pytest.skip("the port's checker is already installed")
    t_race.install()
    t_race.reset()

    def watch(*classes):
        shared = t_race.shared_write_map(REPO)
        watched = 0
        for cls in classes:
            attrs = shared.get(cls.__name__)
            if attrs:
                t_race.watch_type(cls, attrs)
                watched += 1
        return watched

    try:
        yield watch
        rep = t_race.report()
    finally:
        t_race.unwatch_types()
        t_race.uninstall()
        t_race.reset()
    assert not rep.cycles, rep.describe()
    assert not rep.races, rep.describe()


def test_replication_failover_runs_clean_under_the_checker(port_racecheck):
    from dcos_commons_tpu_torch.storage import remote, replication
    from dcos_commons_tpu_torch.storage.persister import MemPersister, SetOp

    # no class of these modules writes an attribute from two roles:
    # the run holds their locks' order and the stores' writes
    classes = [c for mod in (remote, replication)
               for c in vars(mod).values()
               if isinstance(c, type) and c.__module__ == mod.__name__]
    assert port_racecheck(*classes) == 0
    primary = remote.StateServer(MemPersister()).start()
    standby = None
    try:
        client = remote.RemotePersister(primary.url)
        client.set("/svc/a", b"1")
        client.apply([SetOp("/svc/b", b"2")])
        standby = remote.StateServer(
            MemPersister(), replicate_from=primary.url).start()
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            if standby._backend.get_or_none("/svc/b") == b"2":
                break
            time.sleep(0.02)
        assert standby._backend.get("/svc/b") == b"2"
        client.set("/svc/c", b"3")
        while time.monotonic() < deadline:
            if standby._backend.get_or_none("/svc/c") == b"3":
                break
            time.sleep(0.02)
        promoted = remote.RemotePersister(standby.url)
        assert promoted._call("/v1/repl/promote", {})["epoch"] >= 1
        assert promoted.get("/svc/c") == b"3"
        sites = {site for site in t_race._threads_per_site
                 if site.startswith("dcos_commons_tpu_torch/storage/")}
        assert len(sites) >= 2, sorted(t_race._threads_per_site)
    finally:
        for server in (standby, primary):
            if server is not None:
                server.stop()


def test_async_checkpointer_runs_clean_under_the_checker(port_racecheck,
                                                         tmp_path):
    import torch

    from dcos_commons_tpu_torch.utils import checkpoint

    assert port_racecheck(checkpoint.AsyncCheckpointer) == 1
    ckpt = checkpoint.AsyncCheckpointer(str(tmp_path), keep=2,
                                        incarnation=1)
    tree = {"w": torch.arange(6, dtype=torch.float32)}
    for step in range(4):
        tree["w"] += 1
        ckpt.save(step + 1, tree)
    assert ckpt.close() == []
    # a second writer claims a later incarnation: the first is fenced
    # by its own writer thread on its next save
    checkpoint.claim_incarnation(str(tmp_path))
    stale = checkpoint.AsyncCheckpointer(str(tmp_path), keep=2,
                                         incarnation=1)
    stale.save(9, tree)
    errors = stale.close()
    assert stale.fenced and errors

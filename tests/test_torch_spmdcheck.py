"""The port's spmdcheck (analysis/spmdcheck.py) held against the JAX
package's.

Every fixture of the reference gate's spmd tests (tests/test_lint_gate.py)
goes through both ``analyze_paths``, the port's at the path mapped under
``dcos_commons_tpu_torch/``: the findings and the suppressed findings
must be equal in rule, line and count.  The port's vocabulary is held
by fixtures of its own: ``torch.distributed`` calls and the port's
mesh wrappers are the collectives, the process group's rank, the card
and the rank env are host identity, and the gang helpers make a value
uniform.  The port's tree passes the gate with an empty baseline, and
the gate is not vacuous: its summaries see the port's collectives.
"""

import os
import textwrap

import pytest

import test_lint_gate as gate
from dcos_commons_tpu.analysis import spmdcheck as j_spmd
from dcos_commons_tpu_torch.analysis import baseline as t_baseline
from dcos_commons_tpu_torch.analysis import spmdcheck as t_spmd
from test_torch_lint import port_rel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _shape(findings):
    return sorted((f.rule, f.line) for f in findings)


def _files(source, extra_files, prefix):
    rels = [f"{prefix}/parallel/mod.py"] + [
        f"{prefix}/parallel/extra{i}.py" for i in range(len(extra_files))]
    return [(f"/fix/{rel}", rel, textwrap.dedent(src))
            for rel, src in zip(rels, [source, *extra_files])]


def _twin_spmd_fixture(source, rule_id, extra_files=()):
    """The reference gate's ``_spmd_fixture`` through both analyzers;
    returns the port's (findings, suppressed)."""
    j = j_spmd.analyze_paths(_files(source, extra_files, "dcos_commons_tpu"))
    t = t_spmd.analyze_paths(
        _files(source, extra_files, "dcos_commons_tpu_torch"))
    assert _shape(t.findings) == _shape(j.findings)
    assert _shape(t.suppressed) == _shape(j.suppressed)
    assert [port_rel(f.file) for f in j.findings] == [
        f.file for f in t.findings]
    assert [f.message for f in t.findings] == [f.message for f in j.findings]
    _TWINNED.append(rule_id)
    pick = lambda fs: [f for f in fs if f.rule == rule_id]  # noqa: E731
    return pick(t.findings), pick(t.suppressed)


_TWINNED: list = []

SPMD_FIXTURE_TESTS = [
    "test_spmd_rule_host_branch",
    "test_spmd_rule_host_branch_interprocedural",
    "test_spmd_rule_traced_cond",
    "test_spmd_rule_unknown_axis",
    "test_spmd_rule_unordered_iter",
    "test_spmd_rule_per_host_trip_count",
    "test_spmd_module_level_driver_analyzed",
]


@pytest.mark.parametrize("name", SPMD_FIXTURE_TESTS)
def test_spmd_fixture_twins(name, monkeypatch):
    monkeypatch.setattr(gate, "_spmd_fixture", _twin_spmd_fixture)
    del _TWINNED[:]
    getattr(gate, name)()
    assert _TWINNED, f"{name} ran no fixture through both analyzers"


def test_spmd_rule_catalogs_are_the_same_rules():
    assert [r.id for r in t_spmd.all_spmd_rules()] == [
        r.id for r in j_spmd.all_spmd_rules()]
    catalog = t_spmd.spmd_rule_catalog()
    for rule in t_spmd.all_spmd_rules():
        assert rule.id in catalog
    # the reference's vocabulary is kept, the port's added
    assert j_spmd.COLLECTIVE_OPS <= t_spmd.COLLECTIVE_OPS
    assert j_spmd.UNIFORMIZERS <= t_spmd.UNIFORMIZERS
    assert t_spmd.TRACER_ENTRY_POINTS == j_spmd.TRACER_ENTRY_POINTS


# -- the port's vocabulary ----------------------------------------------


def _port_fixture(source, rule_id, extra_files=()):
    result = t_spmd.analyze_paths(
        _files(source, extra_files, "dcos_commons_tpu_torch"))
    pick = lambda fs: [f for f in fs if f.rule == rule_id]  # noqa: E731
    return pick(result.findings), pick(result.suppressed)


_RANK_BRANCH = """
import torch.distributed as dist


def f(x):
    if dist.get_rank() == 0:
        dist.all_reduce(x)
    return x
"""


def test_rank_branch_around_all_reduce_is_flagged():
    """The twin of the reference's ``process_index`` branch around a
    psum: the rank of the process group around ``all_reduce``."""
    findings, _ = _port_fixture(_RANK_BRANCH, "spmd-host-branch")
    assert [(f.line, f.rule) for f in findings] == [(6, "spmd-host-branch")]
    assert "all_reduce" in findings[0].message
    suppressed_src = _RANK_BRANCH.replace(
        "if dist.get_rank() == 0:",
        "if dist.get_rank() == 0:  "
        "# sdklint: disable=spmd-host-branch — leader-only barrier",
    )
    findings, suppressed = _port_fixture(suppressed_src, "spmd-host-branch")
    assert not findings and len(suppressed) == 1
    # the reference's vocabulary has no get_rank: it sees nothing
    j = j_spmd.analyze_paths(_files(_RANK_BRANCH, (), "dcos_commons_tpu"))
    assert not [f for f in j.findings if f.rule == "spmd-host-branch"]


@pytest.mark.parametrize("test,collective", [
    ('int(os.environ["RANK"]) == 0', "dist.barrier()"),
    ('os.environ.get("LOCAL_RANK") == "0"', "dist.broadcast(x, src=0)"),
    ('os.environ.get("CUDA_VISIBLE_DEVICES") == "0"',
     "dist.all_gather_into_tensor(out, x)"),
    ("torch.cuda.current_device() == 0", "dist.reduce_scatter_tensor(out, x)"),
    ("gang_rank(contract, 0, 1)[0] == 0", "dist.all_to_all_single(out, x)"),
    ('contract["worker_id"] == 0', "broadcast_int(1, mesh)"),
    ("mesh.rank == 0", "barrier(mesh)"),
])
def test_port_sources_of_host_identity(test, collective):
    src = f"""
    import os

    import torch
    import torch.distributed as dist


    def f(x, out, mesh, contract):
        if {test}:
            {collective}
        return x
    """
    findings, _ = _port_fixture(src, "spmd-host-branch")
    assert [f.line for f in findings] == [9], (test, collective)


def test_mesh_wrapper_three_calls_away_is_flagged():
    helper = """
    from dcos_commons_tpu_torch.parallel.sharding import pmean

    def sync_all(x, mesh):
        return pmean(x, mesh, ("dp",))
    """
    src = """
    import torch.distributed as dist
    from dcos_commons_tpu_torch.parallel.extra0 import sync_all

    def f(x, mesh):
        rank = dist.get_rank()
        if rank != 0:
            return sync_all(x, mesh)
        return x
    """
    findings, _ = _port_fixture(src, "spmd-host-branch",
                                extra_files=[helper])
    assert len(findings) == 1 and "pmean" in findings[0].message
    findings, _ = _port_fixture(
        src, "spmd-host-branch",
        extra_files=[helper.replace('pmean(x, mesh, ("dp",))', "x + 1")])
    assert not findings


def test_gang_uniform_branch_is_clean():
    """A branch on the gang's size, or on a value a gang helper made
    uniform, meets every rank in the same collectives."""
    src = """
    import torch.distributed as dist
    from dcos_commons_tpu_torch.parallel.distributed import broadcast_int


    def f(x, mesh, contract):
        world = contract["worker_count"]
        if world > 1:
            dist.all_reduce(x)
        flag = broadcast_int(int(dist.get_rank() == 0), mesh)
        if flag:
            dist.barrier()
        return x
    """
    findings, _ = _port_fixture(src, "spmd-host-branch")
    assert not findings


def test_per_host_trip_count_from_the_card_count():
    src = """
    import torch
    import torch.distributed as dist
    from dcos_commons_tpu_torch.parallel.distributed import gather_ints


    def f(x, mesh):
        steps = torch.cuda.device_count()
        for i in range(steps):
            dist.all_reduce(x)
        return x
    """
    findings, _ = _port_fixture(src, "spmd-per-host-trip-count")
    assert [f.line for f in findings] == [9]
    agreed = src.replace(
        "        for i in range(steps):",
        "        steps = gather_ints(steps, mesh)[0]\n"
        "        for i in range(steps):")
    findings, _ = _port_fixture(agreed, "spmd-per-host-trip-count")
    assert not findings


def test_unknown_axis_in_a_wrapper_tuple():
    src = """
    from dcos_commons_tpu_torch.parallel.mesh import MeshSpec
    from dcos_commons_tpu_torch.parallel.sharding import gather


    def spec():
        return MeshSpec(dp=2, tp=2)


    def f(x, mesh):
        return gather(x, 0, mesh, ("dp", "model"))
    """
    findings, _ = _port_fixture(src, "spmd-unknown-axis")
    assert len(findings) == 1 and "'model'" in findings[0].message
    findings, _ = _port_fixture(src.replace('"model"', '"tp"'),
                                "spmd-unknown-axis")
    assert not findings


def test_unordered_set_of_ranks_feeds_a_collective():
    src = """
    import torch.distributed as dist


    def f(x, ranks):
        for r in set(ranks):
            dist.broadcast(x, src=r)
        return x
    """
    findings, _ = _port_fixture(src, "spmd-unordered-iter")
    assert len(findings) == 1
    findings, _ = _port_fixture(src.replace("set(ranks)",
                                            "sorted(set(ranks))"),
                                "spmd-unordered-iter")
    assert not findings


# -- the port's tree ------------------------------------------------------


def test_repo_spmd_gate_with_an_empty_baseline():
    result = t_spmd.analyze_tree(REPO)
    assert result.findings == [], "\n".join(
        f.render() for f in result.findings)
    assert result.files_checked >= 30
    assert t_baseline.load_baseline(t_baseline.baseline_path(REPO)) == {}
    assert {f.file.split("/")[1] for f in result.suppressed} <= {
        "frameworks"}


def test_the_gate_sees_the_port_collectives():
    """Not vacuous: the summaries hold the port's collectives, down the
    call graph into the workers, and the mesh's axes."""
    files = t_spmd._collect_files(REPO, t_spmd.SPMD_SUBDIRS)
    program = t_spmd.build_summary(files)
    assert program.axis_vocab == {"dcn", "dp", "fsdp", "ep", "pp", "sp",
                                  "tp"}
    collecting = {key for key, s in program.functions.items()
                  if s.collectives}
    assert len(collecting) >= 50
    for key in (
        "dcos_commons_tpu_torch.parallel.sharding.all_reduce",
        "dcos_commons_tpu_torch.parallel.sharding._gather_dim",
        "dcos_commons_tpu_torch.parallel.sharding.reduce_gradients",
        "dcos_commons_tpu_torch.parallel.distributed.broadcast_int",
        "dcos_commons_tpu_torch.parallel.ring.ring_attention",
        "dcos_commons_tpu_torch.frameworks.train_worker.train",
        "dcos_commons_tpu_torch.frameworks.serve_gang_worker.build_rank",
    ):
        assert key in collecting, key
    ops = {op for key in collecting
           for op, _ in program.functions[key].collectives}
    assert {"all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
            "all_to_all_single", "broadcast", "barrier",
            "init_process_group"} <= ops
    # the reference's scope holds none of the port's files
    assert not any(rel.startswith("dcos_commons_tpu/")
                   for _, rel, _ in files)

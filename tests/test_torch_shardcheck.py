"""The port's shardcheck (dcos_commons_tpu_torch/analysis/shardcheck.py)
against the JAX package's, on the CPU.

For each workload profile over the meshes the reference's tests use,
the port (the model built on the ``meta`` device) gives the reference
(``jax.eval_shape``) per-card bytes section by section and the same
leaves (path, shape, bytes an element, sharding) but the optimizer's:
the port counts torch's Adam/AdamW state (``exp_avg`` and
``exp_avg_sq`` a param, in its dtype and sharding, and one f32 ``step``
a param), optax one int32 ``count`` (none for the MNIST job, whose
reference profile counts only mu and nu), so the optimizer sections
differ by exactly those step counters' bytes.  The reference's rule
cases run on the port's YAML dialect (a ``gpu:`` block) and give the
same rule ids; the footprint arithmetic keeps the reference's
properties (tests/test_shard_properties.py) under hypothesis."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from dcos_commons_tpu.analysis import shardcheck as j_shard
from dcos_commons_tpu.parallel.mesh import MeshSpec as JMeshSpec
from dcos_commons_tpu.specification.specs import TpuSpec
from dcos_commons_tpu_torch.analysis import shardcheck as t_shard
from dcos_commons_tpu_torch.analysis.__main__ import main as shard_main
from dcos_commons_tpu_torch.parallel.mesh import MeshSpec
from dcos_commons_tpu_torch.specification.specs import GpuSpec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FLAGSHIP = {"VOCAB": "32768", "D_MODEL": "2048", "N_LAYERS": "12",
            "N_HEADS": "16", "N_KV_HEADS": "16", "D_FF": "8192",
            "SEQ_LEN": "2048"}
# (profile, model env, mesh fields of the resource block)
CASES = [
    ("train_worker.py", {}, dict(chips_per_host=4, topology="4x4")),
    ("train_worker.py", {}, dict(chips_per_host=4, topology="2x2")),
    ("train_worker.py", {}, dict(chips_per_host=1)),
    ("train_worker.py", FLAGSHIP, dict(chips_per_host=1)),
    ("train_worker.py", {"N_EXPERTS": "4"},
     dict(chips_per_host=4, topology="2x4")),
    ("train_worker.py", {"N_KV_HEADS": "2"},
     dict(chips_per_host=4, topology="2x2", slices=2)),
    ("train_mnist.py", {}, dict(chips_per_host=1)),
    ("serve_worker.py", {}, dict(chips_per_host=1)),
    ("serve_worker.py", {"KV_PAGE_TOKENS": "0", "SERVE_BATCH": "8"},
     dict(chips_per_host=1)),
    ("serve_worker.py", {"KV_DTYPE": "int8", "WEIGHT_DTYPE": "int8",
                         "KV_PAGES": "64"}, dict(chips_per_host=1)),
    ("serve_gang_worker.py", {"SERVE_BATCH": "4"},
     dict(chips_per_host=1, topology="1x2")),
    ("serve_gang_worker.py", {"N_KV_HEADS": "2", "KV_PAGE_TOKENS": "0"},
     dict(chips_per_host=2, topology="2x2")),
]


def _workloads(script, model_env, fields):
    tpu = TpuSpec(generation="v5e", **fields)
    gpu = GpuSpec(**fields)
    j_env = dict(model_env, **tpu.mesh_env())
    t_env = dict(model_env, **gpu.mesh_env())
    return (j_shard.PROFILES[script](j_env, tpu, None, None),
            t_shard.PROFILES[script](t_env, gpu, None, None))


def _sections(module, workload):
    reports, problems = module._check_workload(
        workload, frozenset(f for f in JMeshSpec().axes()))
    by = {}
    for r in reports:
        by[r.leaf.section] = by.get(r.leaf.section, 0) + r.per_chip_bytes
    return by, sorted(problems)


def _leaves(workload, skip="opt"):
    return sorted((l.path, l.shape, l.dtype_bytes, l.spec)
                  for l in workload.leaves if l.section != skip)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
def test_footprint_by_section_matches_the_reference(case):
    script, model_env, fields = case
    want, got = _workloads(script, model_env, fields)
    assert got.script == want.script and got.train == want.train
    assert got.mesh.axes() == want.mesh.axes()
    assert got.tp_act_bytes == want.tp_act_bytes
    assert _leaves(got) == _leaves(want)
    want_by, want_problems = _sections(j_shard, want)
    got_by, got_problems = _sections(t_shard, got)
    assert got_problems == want_problems
    steps = sum(1 for l in got.leaves if l.path.startswith("opt/step/"))
    # optax's int32 count: the one scalar of its state
    counts = sum(1 for l in want.leaves
                 if l.section == "opt" and l.shape == ())
    if got.train:
        params = sum(1 for l in got.leaves if l.section == "params")
        assert steps == params
        assert got_by.pop("opt") - want_by.pop("opt") == 4 * steps - 4 * counts
    assert got_by == want_by


def test_optimizer_state_inherits_each_params_sharding():
    _, got = _workloads("train_worker.py", {}, dict(chips_per_host=4,
                                                    topology="4x4"))
    params = {l.dedup_path: l for l in got.leaves if l.section == "params"}
    for leaf in got.leaves:
        if leaf.section != "opt":
            continue
        param = params[leaf.rule_path]
        if leaf.path.startswith("opt/step/"):
            assert leaf.shape == () and leaf.dtype_bytes == 4
        else:
            assert (leaf.shape, leaf.dtype_bytes, leaf.spec) == (
                param.shape, param.dtype_bytes, param.spec)


def test_train_profile_takes_another_callers_batch():
    env = dict(FLAGSHIP, TPU_CHIPS_PER_HOST="1")
    default = t_shard.PROFILES["train_worker.py"](env, GpuSpec(), None, None)
    twelve = t_shard.PROFILES["train_worker.py"](env, GpuSpec(), None, None,
                                                 batch=12)
    acts = {l.path: l.shape for l in twelve.leaves
            if l.section == "activations"}
    assert acts["act/layer-boundaries"] == (12, 12, 2048, 2048)
    assert acts["act/logits"] == (12, 2048, 32768)
    assert [l for l in default.leaves if l.section == "params"] == [
        l for l in twelve.leaves if l.section == "params"]


# -- the reference's rule cases on the port's YAML dialect -----------------

_TRAINER_YAML = """
name: fix
pods:
  trainer:{pod_comment}
    count: {count}
    gang: true
    {block}:
      generation: {generation}
      chips-per-host: {chips}
      topology: {topology}
    tasks:
      worker:
        goal: RUNNING
        cmd: "python {scripts}/train_worker.py"
        cpus: 4
        memory: {memory}
"""

_MNIST_YAML = """
name: fix
pods:
  mnist:
    count: 1
    {block}:
      generation: {generation}
      chips-per-host: 4
    tasks:
      train:
        goal: FINISH
        cmd: "python {scripts}/train_mnist.py"
        cpus: 2
        memory: 4096
"""

_MALFORMED_YAML = """
name: fix
pods:
  trainer:
    count: 1
    gang: true
    {block}:
      generation: {generation}
      chips-per-host: 4
      topology: 2x2
    tasks:
      worker:
        goal: RUNNING
        cmd: "python {scripts}/train_worker.py"
        cpus: 4
        memory: 8192
        env:
          VOCAB: "not-a-number"
"""

_FIXTURE_YAML = """
name: fix
pods:
  web:{pod_comment}
    count: 1
    {block}:
      generation: {generation}
      chips-per-host: 2
    tasks:
      server:
        goal: RUNNING
        cmd: "python fixture_worker.py"
        cpus: 1
        memory: 1024
"""

DIALECTS = {
    "jax": dict(block="tpu", generation="v5e", scripts="frameworks/jax"),
    "port": dict(block="gpu", generation="h100",
                 scripts="dcos_commons_tpu_torch/frameworks"),
}


def _trainer(chips=4, topology="4x4", memory=8192, pod_comment=""):
    return lambda d: _TRAINER_YAML.format(
        chips=chips, topology=topology, memory=memory, count=4,
        pod_comment=pod_comment, **d)


def _run(tmp_path, side, yaml, options=None, **kwargs):
    framework = tmp_path / side / "frameworks" / "fix"
    framework.mkdir(parents=True, exist_ok=True)
    (framework / "svc.yml").write_text(
        textwrap.dedent(yaml(DIALECTS[side])))
    if options is not None:
        (framework / "options.json").write_text(json.dumps(options))
    root = str(tmp_path / side)
    if side == "jax":
        return j_shard.analyze_all(root, **kwargs)
    return t_shard.analyze_framework(
        str(framework), root, t_shard.axis_vocabulary(), **kwargs)


def _fixture_profile(module, mesh_cls):
    def profile(env, block, pod, task):
        leaf = module.AbstractLeaf(
            "params/w", (8, 8), 2, (("model",), ("dp",)), "params")
        return module.Workload(script="fixture_worker.py",
                               mesh=mesh_cls(dp=2), leaves=[leaf])
    return profile


RULE_CASES = {
    "divisibility": (_trainer(chips=3, topology="2x3"), None, {}),
    "divisibility-suppressed": (_trainer(
        chips=3, topology="2x3",
        pod_comment="  # sdklint: disable=shard-divisibility,"
        "shard-hbm-overcommit — negative fixture"), None, {}),
    "declared-memory": (_trainer(memory=64), None, {}),
    "hbm-budget": (_trainer(), None, {"hbm_mb": 8}),
    "hbm-suppressed": (_trainer(
        memory=64,
        pod_comment="  # sdklint: disable=shard-hbm-overcommit — fixture"),
        None, {}),
    "mesh-underivable": (_trainer(chips=3, topology="2x2"), None, {}),
    "mesh-suppressed": (_trainer(
        chips=3, topology="2x2",
        pod_comment="  # sdklint: disable=shard-mesh — fixture"), None, {}),
    "idle-chips": (lambda d: _MNIST_YAML.format(**d), None, {}),
    "replicated-giant": (_trainer(), None, {"giant_mb": 1.0}),
    "giant-quiet": (_trainer(), None, {}),
    "giant-suppressed": (_trainer(
        pod_comment="  # sdklint: disable=shard-replicated-giant — dp"
        " replication is intentional at this size"), None,
        {"giant_mb": 1.0}),
    "unknown-axis": (lambda d: _FIXTURE_YAML.format(pod_comment="", **d),
                     None, {}),
    "unknown-axis-suppressed": (lambda d: _FIXTURE_YAML.format(
        pod_comment="  # sdklint: disable=shard-unknown-axis — fixture",
        **d), None, {}),
    "options-escape-hatch": (
        _trainer(chips=3, topology="2x3"),
        {"x-sdklint-disable": ["shard-divisibility",
                               "shard-hbm-overcommit"]}, {}),
    "malformed-env": (lambda d: _MALFORMED_YAML.format(**d), None, {}),
}


@pytest.mark.parametrize("name", sorted(RULE_CASES))
def test_rule_cases_give_the_reference_rule_ids(tmp_path, name,
                                                monkeypatch):
    yaml, options, kwargs = RULE_CASES[name]
    monkeypatch.setitem(j_shard.PROFILES, "fixture_worker.py",
                        _fixture_profile(j_shard, JMeshSpec))
    monkeypatch.setitem(t_shard.PROFILES, "fixture_worker.py",
                        _fixture_profile(t_shard, MeshSpec))
    want = _run(tmp_path, "jax", yaml, options, **kwargs)
    got = _run(tmp_path, "port", yaml, options, **kwargs)
    # the card's memory is another size: judge the footprint against
    # the same budget, and the generation leg apart
    assert sorted(f.rule for f in got.findings) == sorted(
        f.rule for f in want.findings
        if not (f.rule == "shard-hbm-overcommit"
                and "v5e HBM" in f.message and "hbm_mb" not in kwargs))
    assert sorted(f.rule for f in got.suppressed) == sorted(
        f.rule for f in want.suppressed
        if not (f.rule == "shard-hbm-overcommit"
                and "v5e HBM" in f.message and "hbm_mb" not in kwargs))
    assert [f.line for f in got.findings] == [
        f.line for f in want.findings
        if not (f.rule == "shard-hbm-overcommit"
                and "v5e HBM" in f.message and "hbm_mb" not in kwargs)]
    if name == "mesh-underivable":
        assert "'2x2'" in got.findings[0].message
    if name == "malformed-env":
        assert "not-a-number" in got.findings[0].message
    if name == "unknown-axis":
        assert "'model'" in got.findings[0].message
    if name == "idle-chips":
        assert "idle" in got.findings[0].message
        assert "4 chip(s)" in got.findings[0].message


def test_hbm_overcommit_at_the_h100s_capacity(tmp_path):
    """A model whose per-card state outgrows the H100's 81079 MB (the
    capacity the card reports) is flagged against the table, and one
    that fits the card is not."""
    big = {"D_MODEL": "8192", "N_LAYERS": "24", "N_HEADS": "64",
           "N_KV_HEADS": "64", "D_FF": "32768", "SEQ_LEN": "2048"}
    fits = {"D_MODEL": "4096", "N_LAYERS": "8", "N_HEADS": "32",
            "N_KV_HEADS": "32", "D_FF": "16384", "SEQ_LEN": "2048"}
    for env, over in ((big, True), (fits, False)):
        framework = tmp_path / ("over" if over else "fits")
        framework.mkdir()
        lines = "\n".join(f'          {k}: "{v}"' for k, v in env.items())
        (framework / "svc.yml").write_text(textwrap.dedent("""
        name: fix
        pods:
          trainer:
            count: 1
            gpu:
              generation: h100
              chips-per-host: 1
            tasks:
              worker:
                goal: RUNNING
                cmd: "python dcos_commons_tpu_torch/frameworks/train_worker.py"
                memory: 1000000
                env:
        """) + lines + "\n")
        result = t_shard.analyze_framework(
            str(framework), str(tmp_path), t_shard.axis_vocabulary())
        found = [f for f in result.findings
                 if f.rule == "shard-hbm-overcommit"]
        assert bool(found) == over, [f.render() for f in result.findings]
        footprint = result.reports[0].footprint
        assert footprint["hbm_budget_mb"] == 81079
        assert (footprint["per_chip_mb"] > 81079) == over
        if over:
            assert "h100 HBM (81079 MB)" in found[0].message


def test_repo_gate_checks_the_port_frameworks_clean():
    result = t_shard.analyze_all(REPO)
    assert not result.findings, "\n".join(f.render()
                                          for f in result.findings)
    assert result.files_checked == 4
    assert {r.script for r in result.reports} == {
        "train_worker.py", "train_mnist.py", "serve_worker.py",
        "serve_gang_worker.py"}
    want = {r.key.split(":", 1)[1] + r.script: r.footprint
            for r in j_shard.analyze_all(REPO).reports}
    for r in result.reports:
        footprint = dict(r.footprint)
        ref = dict(want[r.key.split(":", 1)[1] + r.script])
        assert footprint.pop("hbm_budget_mb") == 81079
        ref.pop("hbm_budget_mb")
        sections, ref_sections = (footprint.pop("sections_mb"),
                                  ref.pop("sections_mb"))
        # the step counters are a few hundred bytes: under 0.01 MB
        footprint.pop("per_chip_mb"), ref.pop("per_chip_mb")
        footprint.pop("per_host_mb"), ref.pop("per_host_mb")
        assert footprint == ref
        assert sections.keys() == ref_sections.keys()
        for key in sections:
            assert abs(sections[key] - ref_sections[key]) <= 0.01, key


def test_cost_model_rides_the_measured_nvlink_rate():
    env = dict(GpuSpec(chips_per_host=4).mesh_env())
    workload = t_shard.PROFILES["train_worker.py"](env, GpuSpec(), None,
                                                   None)
    assert workload.mesh.axes()["dp"] == 4
    reports, _ = t_shard._check_workload(workload,
                                         t_shard.axis_vocabulary())
    cost = t_shard._cost_model(workload, reports, "h100")
    (entry,) = cost["per_step"]
    grads = sum(r.per_chip_bytes for r in reports
                if r.leaf.section == "grads")
    assert entry["axis"] == "dp" and entry["op"] == "allreduce"
    ring_bytes = 2.0 * grads * 3 / 4
    assert entry["ring_us"] == round(ring_bytes / (220.2e9) * 1e6, 1)
    assert t_shard.NVLINK_GBPS == {"h100": 220.2}


STEPLOGS = [
    ([{"wall_s": 0.010, "blocked_s": 0.001}] * 20, None, 9000.0),
    ([{"wall_s": 0.010}] * 5 + [{"wall_s": "bad"}, {}], None, 7000.0),
    ([{"wall_s": 0.002 * i} for i in range(1, 30)],
     {"per_step": [{"axis": "dp", "ring_us": 500.0,
                    "allgather_us": 800.0},
                   {"axis": "dcn", "ring_us": 900.0,
                    "allgather_us": 700.0}]}, 0.0),
    ([], None, 100.0),
]


@pytest.mark.parametrize("case", range(len(STEPLOGS)))
def test_stepcompare_is_the_reference(case):
    records, cost, floor = STEPLOGS[case]
    assert (t_shard.stepcompare(cost, records, floor_us=floor)
            == j_shard.stepcompare(cost, records, floor_us=floor))


def test_cli_shard_subcommand_and_json(tmp_path, capsys):
    assert shard_main(["shard", "--root", REPO]) == 0
    out = capsys.readouterr().out
    assert "shard: 4 files, 0 finding(s)" in out
    assert shard_main(["shard", "--json", "--hbm-mb", "1",
                       "--root", REPO]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["exit_code"] == 1
    assert {f["rule"] for f in doc["shard"]["findings"]} == {
        "shard-hbm-overcommit"}
    assert "footprint" in doc["shard"] and "cost" in doc["shard"]
    assert shard_main(["--catalog"]) == 0
    assert "shard-replicated-giant" in capsys.readouterr().out
    steplog = tmp_path / "steplog.jsonl"
    steplog.write_text("\n".join(json.dumps({"step": i, "wall_s": 0.5})
                                 for i in range(4)))
    assert shard_main(["shard", "--json", "--root", REPO,
                       "--steplog", str(steplog)]) == 1
    doc = json.loads(capsys.readouterr().out)
    compared = doc["shard"]["stepcompare"]
    trainer = compared["dcos_commons_tpu_torch/frameworks/svc.yml:trainer"]
    assert trainer["regression"] is True and trainer["steps"] == 3


_NO_YAML = r"""
import sys

class _NoYaml:
    def find_spec(self, name, path=None, target=None):
        if name == "yaml" or name.startswith("yaml."):
            raise ImportError("yaml is blocked in this process")
        return None

sys.meta_path.insert(0, _NoYaml())
sys.path.insert(0, sys.argv[1])
from dcos_commons_tpu_torch.analysis import shardcheck
from dcos_commons_tpu_torch.specification import GpuSpec
gpu = GpuSpec(chips_per_host=1)
env = dict(gpu.mesh_env(), N_LAYERS="2")
for script in ("train_worker.py", "train_mnist.py", "serve_worker.py"):
    workload = shardcheck.PROFILES[script](env, gpu, None, None)
    reports, problems = shardcheck._check_workload(
        workload, shardcheck.axis_vocabulary())
    assert not problems, problems
assert "yaml" not in sys.modules
print("ok")
"""


def test_shardcheck_imports_and_runs_without_yaml():
    out = subprocess.run([sys.executable, "-c", _NO_YAML, REPO],
                         capture_output=True, text=True, timeout=300,
                         cwd=REPO)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip() == "ok"


# -- the footprint arithmetic's properties (tests/test_shard_properties.py)

hypothesis = pytest.importorskip(
    "hypothesis", reason="property tests need the hypothesis package")
from hypothesis import given, settings, strategies as st  # noqa: E402

AXES = ("dcn", "dp", "fsdp", "ep", "pp", "sp", "tp")


@st.composite
def mesh_and_leaf(draw, divisible=True):
    """A random MeshSpec plus one abstract leaf whose rule assigns each
    mesh axis to at most one dim.  With ``divisible`` every sharded dim
    is a multiple of its axis product; otherwise one sharded dim is
    bumped off the multiple."""
    sizes = {a: draw(st.integers(1, 4)) for a in AXES}
    mesh = MeshSpec(**sizes)
    rank = draw(st.integers(1, 4))
    dim_axes = [[] for _ in range(rank)]
    for axis in AXES:
        slot = draw(st.integers(-1, rank - 1))
        if slot >= 0:
            dim_axes[slot].append(axis)
    shape, spec = [], []
    for names in dim_axes:
        q = t_shard._prod(sizes[a] for a in names)
        shape.append(q * draw(st.integers(1, 3)))
        spec.append(tuple(names))
    bumped = None
    if not divisible:
        candidates = [i for i, names in enumerate(dim_axes)
                      if t_shard._prod(sizes[a] for a in names) > 1]
        if candidates:
            bumped = draw(st.sampled_from(candidates))
            q = t_shard._prod(sizes[a] for a in dim_axes[bumped])
            shape[bumped] += draw(st.integers(1, q - 1))
    leaf = t_shard.AbstractLeaf(
        path="params/leaf", shape=tuple(shape),
        dtype_bytes=draw(st.sampled_from([1, 2, 4])), spec=tuple(spec),
        section="params")
    return mesh, leaf, bumped


@settings(max_examples=300, deadline=None)
@given(mesh_and_leaf())
def test_footprint_is_exact_for_divisible_trees(case):
    mesh, leaf, _ = case
    report = t_shard.shard_leaf(leaf, mesh.axes())
    assert not report.problems, report.problems
    assert report.per_chip_bytes * mesh.total \
        == leaf.bytes * report.replication
    assert report.shard_product * report.replication == mesh.total
    assert report.per_chip_bytes * report.shard_product == leaf.bytes


@settings(max_examples=300, deadline=None)
@given(mesh_and_leaf(divisible=False))
def test_non_divisible_dims_report_and_overcount(case):
    mesh, leaf, bumped = case
    report = t_shard.shard_leaf(leaf, mesh.axes())
    assert report.per_chip_bytes * report.shard_product >= leaf.bytes
    if bumped is None:
        assert not report.problems
        return
    rules = {rule for rule, _, _ in report.problems}
    assert rules == {"shard-divisibility"}, report.problems
    assert f"dim {bumped}" in "\n".join(m for _, _, m in report.problems)


@settings(max_examples=200, deadline=None)
@given(mesh_and_leaf(), st.integers(0, 6))
def test_unknown_axis_vocabulary_contract(case, which):
    mesh, leaf, _ = case
    dim = which % len(leaf.shape)
    spec = list(leaf.spec)
    spec[dim] = spec[dim] + ("model",)
    poked = t_shard.AbstractLeaf(leaf.path, leaf.shape, leaf.dtype_bytes,
                                 tuple(spec), leaf.section)
    report = t_shard.shard_leaf(poked, mesh.axes())
    assert any(rule == "shard-unknown-axis"
               for rule, _, _ in report.problems), report.problems
    allowed = t_shard.shard_leaf(poked, mesh.axes(),
                                 vocab=frozenset({"model"}))
    assert not [p for p in allowed.problems if p[0] == "shard-unknown-axis"]
    base = t_shard.shard_leaf(leaf, mesh.axes())
    assert allowed.per_chip_bytes == base.per_chip_bytes
    assert allowed.replication == base.replication

"""The port's sdklint (analysis/linter.py, rules.py, baseline.py and the
analysis CLI) held against the JAX package's.

Every rule fixture of the reference gate (tests/test_lint_gate.py) goes
through both ``lint_paths``: the reference's at its own path, the
port's at the same path under ``dcos_commons_tpu_torch/``.  The
findings and the suppressed findings must be equal in rule, line and
count, and the reference test's own assertions still hold.  The port's
tree passes its own gate with an empty ``.sdklint-torch-baseline.json``.
"""

import json
import os
import textwrap

import pytest

import test_lint_gate as gate
from dcos_commons_tpu.analysis import baseline as j_baseline
from dcos_commons_tpu.analysis import rules as j_rules
from dcos_commons_tpu.analysis.linter import lint_paths as j_lint_paths
from dcos_commons_tpu_torch.analysis import baseline as t_baseline
from dcos_commons_tpu_torch.analysis import rules as t_rules
from dcos_commons_tpu_torch.analysis.__main__ import main as t_main
from dcos_commons_tpu_torch.analysis.linter import lint_paths as t_lint_paths
from dcos_commons_tpu_torch.analysis.linter import lint_tree as t_lint_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_rel(rel: str) -> str:
    """The port's path of a reference path: the package prefix mapped,
    the reference's top-level ``frameworks/`` into the package's."""
    if rel.startswith("dcos_commons_tpu/"):
        return "dcos_commons_tpu_torch/" + rel[len("dcos_commons_tpu/"):]
    if rel.startswith("frameworks/"):
        return "dcos_commons_tpu_torch/frameworks/" + rel.split("/", 2)[-1]
    return rel


def _shape(findings):
    return sorted((f.rule, f.line) for f in findings)


def _lint_one(lint_paths, root, rel, source):
    path = root / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(source))
    return lint_paths([str(path)], str(root))


def _twin_lint_fixture(tmp_path, source, rel="dcos_commons_tpu/mod.py",
                       rule_id=None):
    """The reference gate's ``_lint_fixture``, run through both linters;
    returns the reference's (findings, suppressed).  The reference test
    may set its rules' metric allowlist; the port's follows it."""
    j = _lint_one(j_lint_paths, tmp_path / "ref", rel, source)
    own = t_rules.METRIC_CARDINALITY_ALLOWLIST
    t_rules.METRIC_CARDINALITY_ALLOWLIST = j_rules.METRIC_CARDINALITY_ALLOWLIST
    try:
        t = _lint_one(t_lint_paths, tmp_path / "port", port_rel(rel), source)
    finally:
        t_rules.METRIC_CARDINALITY_ALLOWLIST = own
    pick = lambda fs: [f for f in fs if rule_id is None or f.rule == rule_id]  # noqa: E731
    assert _shape(t.findings) == _shape(j.findings), rel
    assert _shape(t.suppressed) == _shape(j.suppressed), rel
    assert {f.file for f in t.findings + t.suppressed} <= {port_rel(rel)}
    _TWINNED.append(rel)
    return pick(j.findings), pick(j.suppressed)


_TWINNED: list = []

# the reference gate's tests built on ``_lint_fixture``
RULE_FIXTURE_TESTS = [
    "test_rule_no_blocking_sleep",
    "test_rule_ledger_mutation",
    "test_rule_ledger_mutation_covers_index_maintenance",
    "test_rule_lock_discipline",
    "test_rule_no_gpus_resource",
    "test_rule_swallowed_exception",
    "test_rule_jit_tracer_cast",
    "test_rule_span_leak",
    "test_rule_lease_gated_mutation",
    "test_rule_health_plan_only",
    "test_rule_metric_cardinality",
    "test_rule_router_stats_staleness",
    "test_file_level_suppression",
    "test_suppression_accepts_plain_hyphen_rationale",
    "test_lock_discipline_sees_except_handler_writes",
]


@pytest.mark.parametrize("name", RULE_FIXTURE_TESTS)
def test_rule_fixture_twins(name, tmp_path, monkeypatch):
    monkeypatch.setattr(gate, "_lint_fixture", _twin_lint_fixture)
    del _TWINNED[:]
    getattr(gate, name)(tmp_path)
    assert _TWINNED, f"{name} ran no fixture through both linters"


def test_every_fixture_test_of_the_reference_gate_is_twinned():
    """A rule test added to the reference gate shows up here, for every
    analyzer: lint, dur, spmd, config and the lockcheck cases."""
    import ast
    import inspect

    from test_torch_configcheck import (
        CONFIG_FIXTURE_TESTS,
        CONFIG_FIXTURE_TESTS_COVERED,
    )
    from test_torch_durcheck import DUR_FIXTURE_TESTS
    from test_torch_racecheck import LOCKCHECK_TESTS
    from test_torch_spmdcheck import SPMD_FIXTURE_TESTS

    tree = ast.parse(inspect.getsource(gate))

    def users(fixture):
        return {
            node.name for node in tree.body
            if isinstance(node, ast.FunctionDef)
            and node.name.startswith("test_")
            and any(isinstance(n, ast.Name) and n.id == fixture
                    for n in ast.walk(node))
        }

    assert users("_lint_fixture") == set(RULE_FIXTURE_TESTS)
    assert users("_dur_fixture") == set(DUR_FIXTURE_TESTS)
    assert users("_spmd_fixture") == set(SPMD_FIXTURE_TESTS)
    assert users("_config_fixture") == set(CONFIG_FIXTURE_TESTS) | set(
        CONFIG_FIXTURE_TESTS_COVERED)
    assert users("lockcheck") == set(LOCKCHECK_TESTS)


def test_rule_catalogs_are_the_same_rules():
    assert [r.id for r in t_rules.all_rules()] == [
        r.id for r in j_rules.all_rules()]
    assert [r.description for r in t_rules.all_rules()] == [
        r.description for r in j_rules.all_rules()]
    catalog = t_rules.rule_catalog()
    for rule in t_rules.all_rules():
        assert rule.id in catalog
    # the gpu vocabulary: the message names the pod-level gpu: block
    assert "``gpu:`` block" in t_rules.NoGpusVocabularyRule.__doc__
    assert "torch.compile" in t_rules.TracerUnsafeCastRule.__doc__


# (reference rel, port rel, rule): the package-wide rules skip the
# workers, which the reference keeps in its top-level frameworks/
WORKER_SCOPES = [
    ("frameworks/jax/train_worker.py",
     "dcos_commons_tpu_torch/frameworks/train_worker.py",
     "no-blocking-sleep",
     "import time\n\ndef wait():\n    time.sleep(1)\n"),
    ("frameworks/jax/serve_worker.py",
     "dcos_commons_tpu_torch/frameworks/serve_worker.py",
     "metric-cardinality",
     "def f(metrics, task_id):\n    metrics.incr(f'req.{task_id}')\n"),
]


@pytest.mark.parametrize("ref_rel,port_rel_,rule,source", WORKER_SCOPES)
def test_workers_are_out_of_the_package_wide_scopes(
        tmp_path, ref_rel, port_rel_, rule, source):
    j = _lint_one(j_lint_paths, tmp_path / "ref", ref_rel, source)
    t = _lint_one(t_lint_paths, tmp_path / "port", port_rel_, source)
    assert [f for f in j.findings if f.rule == rule] == []
    assert [f for f in t.findings if f.rule == rule] == []
    # ...and the same source in the library is a finding on both sides
    lib = "dcos_commons_tpu/offer/mod.py"
    j = _lint_one(j_lint_paths, tmp_path / "ref", lib, source)
    t = _lint_one(t_lint_paths, tmp_path / "port", port_rel(lib), source)
    assert _shape(t.findings) == _shape(j.findings)
    assert [f.rule for f in t.findings] == [rule]


def test_the_port_scopes_are_not_the_reference_prefix(tmp_path):
    """A rule scoped to the reference's ``dcos_commons_tpu/`` would run
    on nothing in the port: each scoped rule fires at the port path."""
    sleeps = "import time\n\ndef f():\n    time.sleep(1)\n"
    t = _lint_one(t_lint_paths, tmp_path,
                  "dcos_commons_tpu_torch/scheduler/mod.py", sleeps)
    assert [f.rule for f in t.findings] == ["no-blocking-sleep"]
    t = _lint_one(t_lint_paths, tmp_path, "dcos_commons_tpu/scheduler/m.py",
                  sleeps)
    assert t.findings == []


def test_new_gpus_identifiers_still_fail(tmp_path):
    """The rule is not narrowed: only the annotated sites pass."""
    src = "def cards(host):\n    return host.gpus\n"
    t = _lint_one(t_lint_paths, tmp_path,
                  "dcos_commons_tpu_torch/offer/extra.py", src)
    assert [(f.rule, f.line) for f in t.findings] == [
        ("no-gpus-resource", 2)]
    assert "gpu: block" in t.findings[0].message


def test_repo_lint_gate_with_an_empty_baseline():
    """Zero lint findings across the port's tree, with an empty port
    baseline; the annotated sites are suppressed, not absent."""
    result = t_lint_tree(REPO)
    assert result.findings == [], "\n".join(
        f.render() for f in result.findings)
    assert result.files_checked >= 150
    path = t_baseline.baseline_path(REPO)
    assert os.path.basename(path) == ".sdklint-torch-baseline.json"
    assert t_baseline.load_baseline(path) == {}
    with open(path) as f:
        assert json.load(f)["entries"] == {}
    gpus = sorted((f.file, f.line) for f in result.suppressed
                  if f.rule == "no-gpus-resource")
    files = {f for f, _ in gpus}
    # rules.py names the token to detect it (its file-level disable)
    assert {"dcos_commons_tpu_torch/analysis/rules.py",
            "dcos_commons_tpu_torch/offer/inventory.py",
            "dcos_commons_tpu_torch/runtime/runner.py",
            "dcos_commons_tpu_torch/testing/chaos.py"} == files
    assert sum(f == "dcos_commons_tpu_torch/offer/inventory.py"
               for f, _ in gpus) == 6
    assert any(f.rule == "swallowed-exception"
               and f.file == "dcos_commons_tpu_torch/analysis/shardcheck.py"
               for f in result.suppressed)


def test_baseline_round_trip_and_one_more_violation_fails(tmp_path):
    """The reference's baseline mechanics on both modules, with the
    port's own file name."""
    src = "import time\n\ndef a():\n    time.sleep(1)\n"
    more = src + "\n\ndef b():\n    time.sleep(2)\n"
    seen = []
    for lint_paths, mod, rel in (
        (j_lint_paths, j_baseline, "dcos_commons_tpu/legacy.py"),
        (t_lint_paths, t_baseline, "dcos_commons_tpu_torch/legacy.py"),
    ):
        root = tmp_path / mod.__name__
        result = _lint_one(lint_paths, root, rel, src)
        bl_path = mod.baseline_path(str(root))
        counts = mod.save_baseline(bl_path, result.findings)
        assert sum(counts.values()) == 1
        known = mod.load_baseline(bl_path)
        fresh, absorbed = mod.apply_baseline(result.findings, known)
        assert not fresh and len(absorbed) == 1
        result = _lint_one(lint_paths, root, rel, more)
        fresh, absorbed = mod.apply_baseline(result.findings, known)
        assert len(fresh) == 1 and len(absorbed) == 1
        seen.append((os.path.basename(bl_path),
                     {k.split("::")[1]: v for k, v in known.items()}))
    assert seen[0][0] == ".sdklint-baseline.json"
    assert seen[1][0] == ".sdklint-torch-baseline.json"
    assert seen[0][1] == seen[1][1] == {"no-blocking-sleep": 1}
    with open(t_baseline.baseline_path(str(tmp_path / t_baseline.__name__))) as f:
        assert "dcos_commons_tpu_torch.analysis" in json.load(f)["comment"]


# -- the CLI -----------------------------------------------------------


@pytest.mark.parametrize("command", ["lint", "dur"])
def test_cli_gates_exit_zero_on_the_port_tree(command, capsys):
    assert t_main([command, "--root", REPO]) == 0
    out = capsys.readouterr().out
    assert f"{command}: " in out and " 0 finding(s)" in out


def test_cli_all_exits_zero_on_the_port_tree(capsys):
    rc = t_main(["all", "--json", "--root", REPO,
                 "--plan-max-states", "800"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0 and doc["exit_code"] == 0
    assert set(doc) == {"lint", "specs", "spmd", "plan", "shard", "race",
                        "config", "dur", "exit_code"}
    for name in ("lint", "specs", "spmd", "shard", "race", "config", "dur"):
        assert doc[name]["findings"] == [], name
    assert doc["race"]["shared_attrs"] > 0 and doc["race"]["roles"] > 0
    assert doc["config"]["env_vars"] >= 100 and doc["config"]["flows"] >= 30
    assert doc["plan"]["violations"] == []
    assert doc["plan"]["states_explored"] >= 800
    assert doc["dur"]["persistence_points"] > 50
    assert sum(doc["dur"]["per_rule"].values()) == doc["dur"]["suppressed"]
    # no command is `all`
    assert t_main(["--root", REPO, "--plan-max-states", "50"]) == 0
    out = capsys.readouterr().out
    for name in ("lint:", "specs:", "spmd:", "plan:", "shard:", "race:",
                 "config:", "dur:"):
        assert name in out


def test_cli_flag_spelling_and_plan(capsys):
    assert t_main(["--lint", "--dur", "--root", REPO]) == 0
    out = capsys.readouterr().out
    assert "lint:" in out and "dur:" in out and "specs:" not in out
    assert t_main(["plan", "--plan-max-states", "800"]) == 0
    out = capsys.readouterr().out
    assert "plan:" in out and "states explored" in out
    assert "lint:" not in out


@pytest.mark.parametrize("command", ["spmd", "race", "config"])
def test_cli_analyzers_not_ported_exit_two(command, capsys):
    """``spmd``, ``race`` and ``config`` run on the port's tree, alone
    and beside another analyzer, and exit 0 with no finding."""
    assert t_main([command, "--root", REPO]) == 0
    captured = capsys.readouterr()
    assert captured.err == ""
    assert f"{command}: " in captured.out
    assert " 0 finding(s), 0 baselined" in captured.out
    assert "lint:" not in captured.out
    assert t_main(["--lint", f"--{command}", "--root", REPO]) == 0
    out = capsys.readouterr().out
    assert "lint:" in out and f"{command}:" in out


def test_cli_catalog_lists_every_rule(capsys):
    from dcos_commons_tpu_torch.analysis import durcheck, shardcheck

    assert t_main(["--catalog"]) == 0
    out = capsys.readouterr().out
    for rule in t_rules.all_rules():
        assert rule.id in out
    for rule in durcheck.all_dur_rules():
        assert rule.id in out
    assert "shard-replicated-giant" in out
    assert shardcheck.shard_rule_catalog() in out
    from dcos_commons_tpu_torch.analysis import (
        configcheck,
        racecheck,
        spmdcheck,
    )

    for rule in spmdcheck.all_spmd_rules():
        assert rule.id in out
    for rule_id in racecheck._RULE_DOCS:
        assert rule_id in out
    for rule_id, _ in configcheck.CONFIG_RULES:
        assert rule_id in out


def test_cli_update_baseline_ownership(tmp_path, capsys):
    """Each pass owns its own entries: a dur-only rewrite keeps the
    lint debt it never recomputed, and the gate is clean against it."""
    pkg = tmp_path / "dcos_commons_tpu_torch" / "utils"
    pkg.mkdir(parents=True)
    (tmp_path / "dcos_commons_tpu_torch" / "legacy.py").write_text(
        "import time\n\ndef poll():\n    time.sleep(1)\n")
    (pkg / "writer.py").write_text(textwrap.dedent("""
        import os

        def save(path, data):
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                f.write(data)
            os.replace(tmp, path)
    """))
    root = str(tmp_path)
    assert t_main(["--lint", "--dur", "--root", root]) == 1
    assert t_main(["--lint", "--dur", "--update-baseline",
                   "--root", root]) == 0
    both = t_baseline.load_baseline(t_baseline.baseline_path(root))
    assert any("dur-file-discipline" in k for k in both)
    assert any("no-blocking-sleep" in k for k in both)
    assert t_main(["--dur", "--update-baseline", "--root", root]) == 0
    assert t_baseline.load_baseline(t_baseline.baseline_path(root)) == both
    assert t_main(["--lint", "--dur", "--root", root]) == 0
    assert t_main(["--specs", "--update-baseline", "--root", root]) == 0
    assert t_baseline.load_baseline(t_baseline.baseline_path(root)) == both
    assert "nothing to update" in capsys.readouterr().out


def test_top_level_analyze_runs_the_analysis_cli(capsys):
    from dcos_commons_tpu_torch.__main__ import main

    assert main(["analyze", "lint", "--root", REPO]) == 0
    assert "lint: " in capsys.readouterr().out
    assert main(["analyze", "race"]) == 0
    assert "race: " in capsys.readouterr().out

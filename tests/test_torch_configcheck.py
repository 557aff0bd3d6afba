"""The port's configcheck (analysis/configcheck.py) held against the JAX
package's.

Every fixture of the reference gate's config tests (tests/test_lint_gate.py)
is laid out twice under one root: the reference's framework at
``frameworks/fix/`` and the port's at ``dcos_commons_tpu_torch/frameworks/``
(the port keeps its one framework inside the package).  Both analyzers
run over the root, each reading only its own layout; the findings and
the suppressed findings must be equal in rule, line and file (mapped),
and the reference test's assertions then hold on the port's result.
The port's tree passes the gate with an empty baseline, its launch path
provides ``CUDA_VISIBLE_DEVICES``, and ``--docs`` writes the port's own
``docs/config-reference-torch.md``, which is kept current.
"""

import json
import os
import textwrap
from dataclasses import replace

import pytest

import test_lint_gate as gate
from dcos_commons_tpu.analysis import configcheck as j_config
from dcos_commons_tpu_torch.analysis import baseline as t_baseline
from dcos_commons_tpu_torch.analysis import configcheck as t_config
from dcos_commons_tpu_torch.analysis.__main__ import main as t_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FW = "dcos_commons_tpu_torch/frameworks"


def ref_rel(rel: str) -> str:
    """The reference fixture's path of a port fixture path."""
    if rel.startswith(PORT_FW + "/"):
        return "frameworks/fix/" + rel[len(PORT_FW) + 1:]
    return rel


def _shape(findings, rel=lambda r: r):
    return sorted((f.rule, f.line, rel(f.file)) for f in findings)


def _twin_config_fixture(tmp_path, yaml=None, worker=None, options=None):
    """The reference gate's ``_config_fixture``, with the port's layout
    beside the reference's; returns the port's result, its files named
    as the reference's."""
    j_result = _REF_CONFIG_FIXTURE(
        tmp_path, yaml=yaml, worker=worker, options=options)
    framework = tmp_path / PORT_FW
    framework.mkdir(parents=True, exist_ok=True)
    (framework / "svc.yml").write_text(textwrap.dedent(
        yaml if yaml is not None else gate._config_yaml()))
    (framework / "worker.py").write_text(textwrap.dedent(
        worker if worker is not None
        else gate._CONFIG_WORKER.format(extra="")))
    if options is not None:
        (framework / "options.json").write_text(json.dumps(options))
    t_result = t_config.analyze_all(str(tmp_path))
    assert _shape(t_result.findings, ref_rel) == _shape(j_result.findings)
    assert _shape(t_result.suppressed, ref_rel) == _shape(
        j_result.suppressed)
    assert t_result.per_rule == j_result.per_rule
    assert sorted(t_result.env_vars) == sorted(j_result.env_vars)
    assert len(t_result.flows) == len(j_result.flows)
    _TWINNED.append(t_result)
    t_result.findings = [replace(f, file=ref_rel(f.file))
                         for f in t_result.findings]
    t_result.suppressed = [replace(f, file=ref_rel(f.file))
                           for f in t_result.suppressed]
    return t_result


_TWINNED: list = []
_REF_CONFIG_FIXTURE = gate._config_fixture

CONFIG_FIXTURE_TESTS = [
    "test_config_rule_undeclared_read",
    "test_config_rule_dead_var",
    "test_config_dead_var_spares_shell_consumers",
    "test_config_rule_type_mismatch",
    "test_config_rule_default_drift_code",
    "test_config_rule_default_drift_template",
    "test_config_rule_options_orphan",
    "test_config_cli_subcommand_and_json",
]
# reference tests on ``_config_fixture`` that a port test of its own
# covers: the baseline ownership case lints a file of the reference's
# package, which the port's lint does not read
CONFIG_FIXTURE_TESTS_COVERED = {
    "test_config_baseline_ownership": "test_config_baseline_ownership_port",
}


@pytest.mark.parametrize("name", CONFIG_FIXTURE_TESTS)
def test_config_fixture_twins(name, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(gate, "_config_fixture", _twin_config_fixture)
    monkeypatch.setattr(gate, "analysis_main", t_main)
    del _TWINNED[:]
    fn = getattr(gate, name)
    if "capsys" in fn.__code__.co_varnames[:fn.__code__.co_argcount]:
        fn(tmp_path, capsys)
    else:
        fn(tmp_path)
    assert _TWINNED, f"{name} ran no fixture through both analyzers"


def test_config_rule_catalogs_are_the_same_rules():
    assert t_config.CONFIG_RULES == j_config.CONFIG_RULES
    catalog = t_config.config_rule_catalog()
    for rule_id, _ in t_config.CONFIG_RULES:
        assert rule_id in catalog


def test_config_baseline_ownership_port(tmp_path):
    """config- baseline entries survive a `--lint --update-baseline`
    that never recomputed them, with the port's lint debt in the port's
    package."""
    framework = tmp_path / PORT_FW
    framework.mkdir(parents=True)
    (framework / "svc.yml").write_text(textwrap.dedent(gate._config_yaml(
        env_block='\n          DEAD_KEY: "1"\n          STEPS: "3"')))
    (framework / "worker.py").write_text(textwrap.dedent(
        gate._CONFIG_WORKER.format(extra="")))
    (tmp_path / "dcos_commons_tpu_torch" / "legacy.py").write_text(
        "import time\n\ndef poll():\n    time.sleep(1)\n")
    root = str(tmp_path)
    assert t_main(["--lint", "--config", "--root", root]) == 1
    assert t_main(["--lint", "--config", "--update-baseline",
                   "--root", root]) == 0
    both = t_baseline.load_baseline(t_baseline.baseline_path(root))
    assert any("config-dead-var" in k for k in both)
    assert any("no-blocking-sleep" in k for k in both)
    assert t_main(["--lint", "--update-baseline", "--root", root]) == 0
    assert t_baseline.load_baseline(t_baseline.baseline_path(root)) == both
    assert t_main(["--lint", "--config", "--root", root]) == 0


def test_every_config_fixture_test_of_the_reference_gate_is_twinned():
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(gate))
    users = {
        node.name for node in tree.body
        if isinstance(node, ast.FunctionDef)
        and node.name.startswith("test_")
        and any(isinstance(n, ast.Name) and n.id == "_config_fixture"
                for n in ast.walk(node))
    }
    assert users == set(CONFIG_FIXTURE_TESTS) | set(
        CONFIG_FIXTURE_TESTS_COVERED)
    for port_test in CONFIG_FIXTURE_TESTS_COVERED.values():
        assert callable(globals()[port_test])


# -- the port's tree ------------------------------------------------------


def test_repo_config_gate_with_an_empty_baseline():
    """Zero config findings over the port's package and its framework;
    the deliberate default splits carry the reference's annotations at
    the port's twins of the reference's sites."""
    result = t_config.analyze_all(REPO)
    assert result.findings == [], "\n".join(
        f.render() for f in result.findings)
    assert t_baseline.load_baseline(t_baseline.baseline_path(REPO)) == {}
    assert result.files_checked >= 100
    assert len(result.env_vars) >= 100
    assert len(result.flows) >= 30
    ref = j_config.analyze_all(REPO)

    def site(f):
        name = os.path.basename(f.file)
        var = f.message.split(" for ")[-1].split(" ")[0] \
            if "in-code default" in f.message else f.message.split(
                "{{")[1].split(":-")[0]
        return (f.rule, name, var)

    assert sorted(map(site, result.suppressed)) == sorted(
        map(site, ref.suppressed))
    # the port's own knobs are in the graph, joined to its workers
    assert {"TORCH_DEVICE", "TRAIN_STEPS", "SERVE_BATCH", "N_EXPERTS",
            "CHECKPOINT_DIR"} <= set(result.env_vars)
    scripts = {flow["script"] for flow in result.flows}
    assert {f"{PORT_FW}/train_worker.py", f"{PORT_FW}/serve_worker.py",
            f"{PORT_FW}/serve_gang_worker.py"} <= scripts


def test_launch_path_provides_the_card_env():
    runtime = t_config.runtime_provided_vars(REPO)
    assert "CUDA_VISIBLE_DEVICES" in runtime
    assert {"TPU_WORKER_ID", "TPU_WORKER_COUNT", "COORDINATOR_ADDRESS",
            "POD_INSTANCE_INDEX"} <= runtime
    assert "CUDA_VISIBLE_DEVICES" not in j_config.runtime_provided_vars(REPO)


def test_config_reference_doc_is_current():
    """docs/config-reference-torch.md is generated; the committed copy
    must match what `analysis config --docs` would write today."""
    result = t_config.analyze_all(REPO)
    path = os.path.join(REPO, "docs", "config-reference-torch.md")
    with open(path, "r", encoding="utf-8") as f:
        committed = f.read()
    assert committed == t_config.render_config_reference(result), (
        "docs/config-reference-torch.md is stale — regenerate with "
        "`python -m dcos_commons_tpu_torch.analysis config --docs`")
    assert "`TORCH_DEVICE`" in committed


def test_docs_flag_writes_only_the_port_reference(tmp_path, capsys):
    framework = tmp_path / PORT_FW
    framework.mkdir(parents=True)
    (framework / "svc.yml").write_text(textwrap.dedent(gate._config_yaml()))
    (framework / "worker.py").write_text(textwrap.dedent(
        gate._CONFIG_WORKER.format(extra="")))
    (tmp_path / "docs").mkdir()
    (tmp_path / "docs" / "config-reference.md").write_text("frozen\n")
    assert t_main(["--docs", "--root", str(tmp_path)]) == 0
    assert "docs: wrote" in capsys.readouterr().out
    assert (tmp_path / "docs" / "config-reference.md").read_text() == \
        "frozen\n"
    written = (tmp_path / "docs" / "config-reference-torch.md").read_text()
    assert "`STEPS`" in written

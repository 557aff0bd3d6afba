"""The port's durcheck held against the JAX package's.

Every fixture of the reference gate's durcheck tests goes through both
``analyze_paths``, the port's at the path mapped under
``dcos_commons_tpu_torch/``: the findings and the suppressed findings
must be equal in rule, line and count.  Over the two trees, the
persistence-point maps are equal by file (prefix mapped), function and
kind, and the port's tree passes the gate.
"""

import collections
import json
import os
import textwrap

import pytest

import test_lint_gate as gate
from dcos_commons_tpu.analysis import durcheck as j_dur
from dcos_commons_tpu_torch.analysis import durcheck as t_dur
from dcos_commons_tpu_torch.analysis.__main__ import main as t_main
from test_torch_lint import port_rel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _shape(findings):
    return sorted((f.rule, f.line) for f in findings)


def _twin_dur_fixture(files, rule_id):
    """The reference gate's ``_dur_fixture`` through both analyzers;
    returns the reference's (findings, suppressed)."""
    sources = [(rel, textwrap.dedent(src)) for rel, src in files]
    j = j_dur.analyze_paths([(f"/fix/{rel}", rel, src)
                             for rel, src in sources])
    t = t_dur.analyze_paths([(f"/fix/{port_rel(rel)}", port_rel(rel), src)
                             for rel, src in sources])
    assert _shape(t.findings) == _shape(j.findings)
    assert _shape(t.suppressed) == _shape(j.suppressed)
    assert [port_rel(f.file) for f in j.findings] == [
        f.file for f in t.findings]
    assert [(p.kind, p.line) for p in t.persistence_points] == [
        (p.kind, p.line) for p in j.persistence_points]
    _TWINNED.append(rule_id)
    pick = lambda fs: [f for f in fs if f.rule == rule_id]  # noqa: E731
    return pick(j.findings), pick(j.suppressed)


_TWINNED: list = []

DUR_FIXTURE_TESTS = [
    "test_dur_rule_effect_before_wal",
    "test_dur_effect_before_wal_is_path_sensitive",
    "test_dur_effect_before_wal_interprocedural_effects",
    "test_dur_rule_replay_parity",
    "test_dur_replay_parity_journal_kinds",
    "test_dur_rule_unfenced_write",
    "test_dur_rule_nonatomic_pair",
    "test_dur_rule_file_discipline",
]


@pytest.mark.parametrize("name", DUR_FIXTURE_TESTS)
def test_dur_fixture_twins(name, monkeypatch):
    monkeypatch.setattr(gate, "_dur_fixture", _twin_dur_fixture)
    del _TWINNED[:]
    getattr(gate, name)()
    assert _TWINNED, f"{name} ran no fixture through both analyzers"


def test_every_dur_fixture_test_of_the_reference_gate_is_twinned():
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(gate))
    users = {
        node.name for node in tree.body
        if isinstance(node, ast.FunctionDef)
        and node.name.startswith("test_")
        and any(isinstance(n, ast.Name) and n.id == "_dur_fixture"
                for n in ast.walk(node))
    }
    assert users == set(DUR_FIXTURE_TESTS)


def test_seeded_unwald_launch_fixture_twin():
    """The static half of the reference's seeded unWAL'd-launch bug."""
    fixture = (
        "class BuggyRecorder:\n"
        "    def record(self, infos, parent=None):\n"
        "        self.agent.launch(infos)\n"
        "        self._state_store.store_launch(infos)\n"
    )
    j = j_dur.analyze_paths(
        [("/fix/rec.py", "dcos_commons_tpu/state/rec.py", fixture)])
    t = t_dur.analyze_paths(
        [("/fix/rec.py", "dcos_commons_tpu_torch/state/rec.py", fixture)])
    assert [f.rule for f in t.findings] == [f.rule for f in j.findings] \
        == ["dur-effect-before-wal"]
    assert _shape(t.findings) == _shape(j.findings)
    assert "launch" in t.findings[0].message


def test_rule_catalogs_are_the_same_rules():
    assert [r.id for r in t_dur.all_dur_rules()] == [
        r.id for r in j_dur.all_dur_rules()]
    catalog = t_dur.dur_rule_catalog()
    for rule in t_dur.all_dur_rules():
        assert rule.id in catalog
    assert t_dur.TRIGGER_KINDS == j_dur.TRIGGER_KINDS
    assert t_dur.PERSIST_KINDS == j_dur.PERSIST_KINDS
    assert t_dur.EFFECT_KINDS == j_dur.EFFECT_KINDS
    assert [port_rel(d) for d in j_dur.DUR_SUBDIRS] == list(
        t_dur.DUR_SUBDIRS)


def _point_key(point, ref):
    file, function = point["file"], point["function"]
    if ref:
        file = port_rel(file)
        function = "dcos_commons_tpu_torch." + function.split(".", 1)[1]
    return (file, function, point["kind"])


def test_point_maps_of_the_two_trees_are_equal():
    """The chaos harness's crash boundaries: the port's tree yields the
    reference's persistence points, by file, function and kind."""
    j = j_dur.persistence_point_map(REPO)
    t = t_dur.persistence_point_map(REPO)
    assert len(t) == len(j) == 113
    assert collections.Counter(_point_key(p, False) for p in t) == \
        collections.Counter(_point_key(p, True) for p in j)
    assert all(p["file"].startswith("dcos_commons_tpu_torch/") for p in t)


def test_repo_durcheck_gate_on_the_port_tree():
    """Zero findings on the port's tree; the reference's annotated
    in-tree debts are the port's too, rule for rule."""
    j = j_dur.analyze_tree(REPO)
    t = t_dur.analyze_tree(REPO)
    assert t.findings == [], "\n".join(f.render() for f in t.findings)
    assert t.files_checked >= 50
    assert t.per_rule == j.per_rule
    assert sorted((port_rel(f.file), f.rule) for f in j.suppressed) == \
        sorted((f.file, f.rule) for f in t.suppressed)
    kinds = {p.kind for p in t.persistence_points}
    assert {"wal", "store", "property", "persister", "file"} <= kinds


def test_cli_points_matches_the_reference(capsys):
    assert t_main(["dur", "--points", "--root", REPO]) == 0
    doc = json.loads(capsys.readouterr().out)
    j = j_dur.persistence_point_map(REPO)
    per_kind = collections.Counter(p["kind"] for p in j)
    assert doc["per_kind"] == dict(per_kind)
    assert all({"file", "line", "end_line", "kind", "function"} <= set(p)
               for p in doc["persistence_points"])
    assert t_main(["dur", "--json", "--root", REPO]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["dur"]["findings"] == []
    assert doc["dur"]["persistence_points"] == len(j)
    assert doc["dur"]["per_kind"] == dict(per_kind)

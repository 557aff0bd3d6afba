"""The port's ahead-of-time spec analyzer
(``dcos_commons_tpu_torch/analysis/speccheck.py``) against the JAX
package's, on the CPU.

Both analyzers walk the same framework directories (frameworks/
helloworld, hdfs and cassandra) and one fabricated YAML a rule, the
port's through ``gpu_yaml``: their findings are equal by file,
file-relative line, rule and count, and by message but for the
designed wording (the ``gpu:`` block for the ``tpu:`` block, the
declared node set for the declared torus, the generation's name).  The
port's CLI, ``python -m dcos_commons_tpu_torch.analysis specs``, gives
on the port's five YAMLs what the reference gives on frameworks/jax/'s
five."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from dcos_commons_tpu.analysis import speccheck as j_speccheck
from dcos_commons_tpu_torch.analysis import speccheck as t_speccheck
from test_torch_offer import gpu_yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the port's wording -> the reference's, each a designed difference
WORDING = (("gpu:", "tpu:"), ("gpu block", "tpu block"),
           ("declared node set", "declared torus"), ("'h100'", "'v5e'"))


def as_reference(message):
    for port, reference in WORDING:
        message = message.replace(port, reference)
    return message


def key(finding, fix=lambda m: m):
    return (finding.file, finding.line, finding.rule, fix(finding.message))


def both(framework_dir, root):
    want = [key(f) for f in j_speccheck.analyze_framework(framework_dir,
                                                          root)]
    got = [key(f, as_reference)
           for f in t_speccheck.analyze_framework(framework_dir, root)]
    return want, got


@pytest.mark.parametrize("name", ["helloworld", "hdfs", "cassandra"])
def test_reference_frameworks_give_the_same_findings(name):
    want, got = both(os.path.join(REPO, "frameworks", name), REPO)
    assert got == want


def test_host_model_is_a_gpu_hosts_shape():
    from dcos_commons_tpu_torch.offer.inventory import GpuHost

    host, model = GpuHost(host_id="h"), t_speccheck.HostModel()
    assert (model.cpus, model.memory_mb, model.disk_mb) == (
        host.cpus, host.memory_mb, host.disk_mb)


GANG = """
name: svc
pods:
  trainer:
    count: 4
    gang: true
    placement: '{placement}'
    tpu:
      generation: v5e
      chips-per-host: 4
      topology: 4x4
    tasks:
      worker:
        goal: RUNNING
        cmd: "train"
"""

TRIGGERS = {
    "clean": ("""
name: clean
pods:
  web:
    count: 2
    tasks:
      server: {goal: RUNNING, cmd: "serve", cpus: 1, memory: 1024}
""", None, set()),
    "spec-options": ("""
name: svc
pods:
  web:
    count: 1
    tasks:
      server: {goal: RUNNING, cmd: "serve"}
""", {"properties": {"web": {"properties": {
        "count": {"type": "integer"}}}}}, {"spec-options"}),
    "spec-render": ("""
name: svc
pods:
  web:
    count: 1
    tasks:
      server: {goal: RUNNING, cmd: "serve", cpus: not-a-number}
""", None, {"spec-render"}),
    "spec-render-yaml": ("name: svc\npods: [unclosed\n", None,
                         {"spec-render"}),
    "spec-validators": ("""
name: bad__name
pods:
  web:
    count: 1
    tasks:
      server: {goal: RUNNING, cmd: "serve"}
""", None, {"spec-validators"}),
    "spec-placement-max-per": (GANG.format(placement="max-per-host:0"),
                               None, {"spec-placement"}),
    "spec-placement-hosts": (
        GANG.format(placement="max-per-host:1").replace(
            "count: 4", "count: 8"), None,
        {"spec-validators", "spec-placement"}),
    "spec-placement-generation": (GANG.format(placement="generation:v4"),
                                  None, {"spec-placement"}),
    "spec-placement-satisfiable": (GANG.format(placement="max-per-host:1"),
                                   None, set()),
    "spec-ports": ("""
name: svc
pods:
  web:
    count: 1
    tasks:
      a: {goal: RUNNING, cmd: "a", ports: {http: {port: 8080}}}
      b: {goal: RUNNING, cmd: "b", ports: {admin: {port: 8080}}}
""", None, {"spec-ports"}),
    "spec-ports-count": ("""
name: svc
pods:
  web:
    count: 3
    tasks:
      a: {goal: RUNNING, cmd: "a", ports: {http: {port: 8080}}}
""", None, {"spec-ports"}),
    "spec-plan": ("""
name: svc
pods:
  web:
    count: 2
    tasks:
      server: {goal: RUNNING, cmd: "serve"}
plans:
  deploy:
    strategy: zigzag
    phases:
      one: {pod: nonexistent}
      two: {pod: web, dependencies: [three]}
      three: {pod: web, dependencies: [two]}
      four:
        pod: web
        dependencies: [nowhere]
        steps:
          - 7: [[server]]
          - 0: [[bogus]]
          - x: [[server]]
          - {0: [[server]], 1: [[server]]}
""", None, {"spec-plan"}),
    "spec-resources": ("""
name: svc
pods:
  web:
    count: 1
    tasks:
      server: {goal: RUNNING, cmd: "serve", cpus: 64, memory: 262144, disk: 999999}
""", None, {"spec-resources"}),
    "no-gpus-resource": ("""
name: svc
pods:
  web:
    count: 1
    tasks:
      server:
        goal: RUNNING
        cmd: "serve"
        gpus: 2
""", None, {"no-gpus-resource"}),
    "no-gpus-resource-suppressed": (
        "# sdklint: disable-file=no-gpus-resource — negative example\n"
        "name: svc\npods:\n  web:\n    count: 1\n    tasks:\n"
        "      server: {goal: RUNNING, cmd: serve}\n"
        "      side:\n        goal: RUNNING\n        cmd: side\n"
        "        gpus: 1\n", None, set()),
}


def _framework(tmp_path, sub, text, options):
    framework = tmp_path / sub
    framework.mkdir(parents=True)
    (framework / "svc.yml").write_text(textwrap.dedent(text))
    if options is not None:
        (framework / "options.json").write_text(json.dumps(options))
    return str(framework)


@pytest.mark.parametrize("case", sorted(TRIGGERS))
def test_rule_triggers_give_the_same_findings(case, tmp_path):
    text, options, rules = TRIGGERS[case]
    j_dir = _framework(tmp_path, "jax/fix", text, options)
    t_dir = _framework(tmp_path, "port/fix", gpu_yaml(text), options)
    want = [key(f) for f in j_speccheck.analyze_framework(
        j_dir, str(tmp_path / "jax"))]
    got = [key(f, as_reference) for f in t_speccheck.analyze_framework(
        t_dir, str(tmp_path / "port"))]
    assert got == want
    assert {k[2] for k in want} == rules
    if case == "spec-plan":
        assert len(want) >= 6


def test_the_gpus_rule_spares_the_gpu_block(tmp_path):
    """``no-gpus-resource`` matches a ``gpus:`` key and not the port's
    ``gpu:`` block."""
    text = gpu_yaml(GANG.format(placement="max-per-host:1"))
    assert "    gpu:\n" in text
    t_dir = _framework(tmp_path, "port/fix", text, None)
    assert t_speccheck.analyze_framework(t_dir, str(tmp_path / "port")) == []


def test_cli_specs_on_the_port_yamls_matches_the_reference():
    out = subprocess.run(
        [sys.executable, "-m", "dcos_commons_tpu_torch.analysis", "specs",
         "--json"], capture_output=True, text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stdout + out.stderr
    doc = json.loads(out.stdout)
    assert doc["exit_code"] == 0
    want = j_speccheck.analyze_framework(
        os.path.join(REPO, "frameworks", "jax"), REPO)
    assert [(f["line"], f["rule"]) for f in doc["specs"]["findings"]] == [
        (f.line, f.rule) for f in want]
    assert doc["specs"]["findings"] == []
    plain = subprocess.run(
        [sys.executable, "-m", "dcos_commons_tpu_torch.analysis", "specs"],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert plain.returncode == 0
    assert plain.stdout.strip().splitlines()[-1] == "specs: 0 finding(s)"


def test_cli_specs_fails_on_a_finding(tmp_path):
    """A framework directory with a finding exits 1 and names it."""
    framework = tmp_path / "dcos_commons_tpu_torch" / "frameworks"
    framework.mkdir(parents=True)
    (framework / "svc.yml").write_text(textwrap.dedent(gpu_yaml(
        TRIGGERS["spec-ports"][0])))
    out = subprocess.run(
        [sys.executable, "-m", "dcos_commons_tpu_torch.analysis", "specs",
         "--root", str(tmp_path)],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert out.returncode == 1
    assert "spec-ports" in out.stdout
    assert out.stdout.strip().splitlines()[-1] == "specs: 1 finding(s)"

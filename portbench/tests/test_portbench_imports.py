"""Nothing the benchmark runs imports JAX or the JAX package, by the
top-level name of each module compared whole (the port's
``dcos_commons_tpu_torch`` begins with ``dcos_commons_tpu``), and the
reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest

from portbench.lib import harness

PB = os.path.join(harness.ROOT, "portbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "dcos_commons_tpu"}


def _sources():
    for dirpath, dirs, files in os.walk(PB):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def _top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, PB))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not set(_top_level_imports(path)) & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(PB, "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            tops = set(_top_level_imports(os.path.join(ref, name)))
            assert "dcos_commons_tpu_torch" not in tops, name
    # nor through the benchmark's own modules it uses
    for lib in ("counts.py", "weights.py"):
        assert "dcos_commons_tpu_torch" not in set(
            _top_level_imports(os.path.join(PB, "lib", lib)))


def test_whole_names_are_compared():
    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax", "dcos_commons_tpu")
    assert harness.forbidden_in(
        ["dcos_commons_tpu_torch", "dcos_commons_tpu_torch.models.moe",
         "jaxtyping", "numpy"]) == []
    assert harness.forbidden_in(
        ["dcos_commons_tpu.serve", "jaxlib.xla_client", "flax"]) == \
        ["dcos_commons_tpu", "flax", "jaxlib"]


def test_a_run_loads_none_of_them():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench.lib import harness\n"
        "from portbench.tests.tiny import tiny_context\n"
        "for w in [c['name'] for c in harness.load_benchmark()['workloads']]:\n"
        "    harness.execute(tiny_context(w, trace=True))\n"
        "print(harness.forbidden_modules())\n" % harness.ROOT)
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=harness.ROOT)
    assert run.returncode == 0, run.stderr[-2000:]
    assert run.stdout.strip().splitlines()[-1] == "[]"

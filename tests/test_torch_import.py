"""The port stands alone: no module of dcos_commons_tpu_torch, and not
chip_smoke.py, imports jax or anything of the JAX package
(dcos_commons_tpu), nor triton (every kernel is CUDA C++ built with
nvcc), and its entry points run on the card unless the caller asks for
the CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "dcos_commons_tpu_torch")


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, dirs, files in os.walk(PKG):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _modules():
    for path in _port_sources():
        if not path.startswith(PKG):
            continue
        mod = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
        yield mod[: -len(".__init__")] if mod.endswith(".__init__") else mod


_BLOCKED_IMPORT = r"""
import importlib, sys

class _NoJax:
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith("jax."):
            raise ImportError("jax is blocked in this process")
        return None

sys.meta_path.insert(0, _NoJax())
sys.path.insert(0, sys.argv[1])
for mod in sys.argv[2:]:
    importlib.import_module(mod)
leaked = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.")
    or m == "dcos_commons_tpu" or m.startswith("dcos_commons_tpu.")
)
assert not leaked, leaked
print("imported", len(sys.argv) - 2)
"""


def test_every_port_module_imports_without_jax():
    mods = sorted(_modules())
    assert {
        "dcos_commons_tpu_torch.frameworks.serve_worker",
        "dcos_commons_tpu_torch.frameworks.train_worker",
        "dcos_commons_tpu_torch.models.moe",
        "dcos_commons_tpu_torch.utils.checkpoint",
        "dcos_commons_tpu_torch.utils.data",
        "dcos_commons_tpu_torch.trace.steplog",
        "dcos_commons_tpu_torch.data.loader",
        "dcos_commons_tpu_torch.parallel.distributed",
        "dcos_commons_tpu_torch.parallel.mesh",
        "dcos_commons_tpu_torch.parallel.pipeline",
        "dcos_commons_tpu_torch.parallel.sharding",
        "dcos_commons_tpu_torch.parallel.ring",
        "dcos_commons_tpu_torch.parallel.ulysses",
        "dcos_commons_tpu_torch.parallel.collectives",
        "dcos_commons_tpu_torch.frameworks.serve_gang_worker",
        "dcos_commons_tpu_torch.frameworks.router_worker",
        "dcos_commons_tpu_torch.router",
        "dcos_commons_tpu_torch.router.affinity",
        "dcos_commons_tpu_torch.router.core",
        "dcos_commons_tpu_torch.router.frontdoor",
        "dcos_commons_tpu_torch.router.telemetry",
        "dcos_commons_tpu_torch.security.auth",
        "dcos_commons_tpu_torch.models.mlp",
        "dcos_commons_tpu_torch.frameworks.train_mnist",
        "dcos_commons_tpu_torch.specification",
        "dcos_commons_tpu_torch.specification.specs",
        "dcos_commons_tpu_torch.specification.yaml_spec",
        "dcos_commons_tpu_torch.specification.validation",
        "dcos_commons_tpu_torch.offer.placement",
        "dcos_commons_tpu_torch.tools.options",
        "dcos_commons_tpu_torch.analysis.linter",
        "dcos_commons_tpu_torch.analysis.shardcheck",
        "dcos_commons_tpu_torch.analysis.__main__",
    } <= set(mods)
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT, REPO, *mods],
        capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert f"imported {len(mods)}" in out.stdout


def _imports(path):
    """(line, top-level module) of every import statement in ``path``."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            yield node.lineno, name.split(".")[0]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_source_imports_jax_or_the_jax_package(path):
    for line, top in _imports(path):
        assert top not in ("jax", "jaxlib", "dcos_commons_tpu"), (
            f"{os.path.relpath(path, REPO)}:{line} imports {top}"
        )


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_source_imports_triton(path):
    """K1-K4 are CUDA C++: the port needs no triton, on the card or
    here."""
    for line, top in _imports(path):
        assert top != "triton", (
            f"{os.path.relpath(path, REPO)}:{line} imports triton"
        )


def test_entry_points_default_to_the_card():
    from dcos_commons_tpu_torch.device import resolve_device
    from dcos_commons_tpu_torch.frameworks.serve_gang_worker import (
        build_rank,
    )
    from dcos_commons_tpu_torch.frameworks.serve_worker import build_server
    from dcos_commons_tpu_torch.frameworks.train_worker import train
    from dcos_commons_tpu_torch.models import (
        MlpConfig,
        TransformerConfig,
        init_kv_cache,
        init_params,
        mlp_init,
        params_from_jax,
    )
    from dcos_commons_tpu_torch.utils import synthetic_mnist

    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    config = TransformerConfig(vocab=16, d_model=16, n_layers=1,
                               n_heads=2, d_ff=16)
    for call in (
        lambda: resolve_device(),
        lambda: init_params(config),
        lambda: mlp_init(MlpConfig()),
        lambda: synthetic_mnist(4),
        lambda: init_kv_cache(config, 1, 8),
        lambda: params_from_jax({"layers": {}}),
        lambda: build_server({"VOCAB": "16"}, ready_file=""),
        lambda: build_rank({"VOCAB": "16"}, ready_file=""),
        lambda: train({"VOCAB": "16", "TRAIN_STEPS": "1"}),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_library_path_follows_the_shared_headers(tmp_path, monkeypatch):
    """A kernel library is named by a hash of its .cu and of every
    csrc/*.cuh, so an edit to a shared header (hopper.cuh) gives every
    library a new path and never loads a stale build, also one that
    does not include it (rmsnorm.cu).  Needs no nvcc."""
    import shutil

    from dcos_commons_tpu_torch import device

    for name in os.listdir(device.CSRC_DIR):
        if name.endswith((".cu", ".cuh")):
            shutil.copy(os.path.join(device.CSRC_DIR, name), tmp_path)
    monkeypatch.setattr(device, "CSRC_DIR", str(tmp_path))
    names = ("flash_fwd", "flash_bwd", "rmsnorm")
    before = {n: device._library_path(n) for n in names}
    assert before == {n: device._library_path(n) for n in names}
    header = tmp_path / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: device._library_path(n) for n in names}
    assert all(after[n] != before[n] for n in names)
    assert all(os.path.dirname(after[n]) == device.BUILD_DIR for n in names)
    (tmp_path / "extra.cuh").write_text("#pragma once\n")
    assert all(device._library_path(n) != after[n] for n in names)


@pytest.mark.parametrize("n_experts", [0, 4])
def test_meta_device_builds_shapes_without_values(n_experts):
    """``meta`` is admitted: the trees shardcheck reads are built with
    no generator and no storage, in the shapes and dtypes the CPU
    builds."""
    from dcos_commons_tpu_torch.device import generator, resolve_device
    from dcos_commons_tpu_torch.models import (
        TransformerConfig,
        init_kv_cache,
        init_paged_kv_cache,
        init_params,
    )
    from dcos_commons_tpu_torch.utils.tree import tree_leaves

    meta = resolve_device("meta")
    assert meta.type == "meta" and generator(meta, 0) is None
    assert generator(resolve_device("cpu"), 0) is not None
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("xpu")
    config = TransformerConfig(vocab=32, d_model=16, n_layers=2, n_heads=2,
                               n_kv_heads=2, d_ff=32, n_experts=n_experts)
    shapes = init_params(config, 0, "meta")
    real = init_params(config, 0, "cpu")
    for a, b in zip(tree_leaves(shapes), tree_leaves(real)):
        assert a.device.type == "meta"
        assert (a.shape, a.dtype) == (b.shape, b.dtype)
    for kv_dtype in ("native", "int8"):
        for cache, want in (
            (init_kv_cache(config, 3, 8, kv_dtype, device="meta"),
             init_kv_cache(config, 3, 8, kv_dtype, device="cpu")),
            (init_paged_kv_cache(config, 5, 4, kv_dtype, device="meta"),
             init_paged_kv_cache(config, 5, 4, kv_dtype, device="cpu")),
        ):
            assert {k: (v.shape, v.dtype, v.device.type)
                    for k, v in cache.items()} == {
                k: (v.shape, v.dtype, "meta") for k, v in want.items()}

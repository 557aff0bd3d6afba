"""The port stands alone: no module of dcos_commons_tpu_torch, and not
chip_smoke.py, imports jax or anything of the JAX package
(dcos_commons_tpu), nor triton (every kernel is CUDA C++ built with
nvcc), and its entry points run on the card unless the caller asks for
the CPU.  The distributed control plane (the agent daemon and the
remote fleet, the state server, packaging, multi-service) imports no
torch, and its entry points run."""

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
        "dcos_commons_tpu_torch.common",
        "dcos_commons_tpu_torch.storage",
        "dcos_commons_tpu_torch.storage.persister",
        "dcos_commons_tpu_torch.storage.file_persister",
        "dcos_commons_tpu_torch.storage.cache",
        "dcos_commons_tpu_torch.state",
        "dcos_commons_tpu_torch.state.state_store",
        "dcos_commons_tpu_torch.trace.span",
        "dcos_commons_tpu_torch.trace.recorder",
        "dcos_commons_tpu_torch.plan",
        "dcos_commons_tpu_torch.plan.status",
        "dcos_commons_tpu_torch.plan.element",
        "dcos_commons_tpu_torch.plan.backoff",
        "dcos_commons_tpu_torch.plan.step",
        "dcos_commons_tpu_torch.offer",
        "dcos_commons_tpu_torch.offer.outcome",
        "dcos_commons_tpu_torch.offer.inventory",
        "dcos_commons_tpu_torch.offer.nvlink",
        "dcos_commons_tpu_torch.offer.multislice",
        "dcos_commons_tpu_torch.offer.ledger",
        "dcos_commons_tpu_torch.offer.evaluate",
        "dcos_commons_tpu_torch.plan.strategy",
        "dcos_commons_tpu_torch.plan.phase",
        "dcos_commons_tpu_torch.plan.plan",
        "dcos_commons_tpu_torch.plan.plan_manager",
        "dcos_commons_tpu_torch.plan.coordinator",
        "dcos_commons_tpu_torch.plan.builders",
        "dcos_commons_tpu_torch.plan.generator",
        "dcos_commons_tpu_torch.state.config_store",
        "dcos_commons_tpu_torch.state.framework_store",
        "dcos_commons_tpu_torch.state.launch_recorder",
        "dcos_commons_tpu_torch.state.schema",
        "dcos_commons_tpu_torch.recovery",
        "dcos_commons_tpu_torch.recovery.monitor",
        "dcos_commons_tpu_torch.recovery.elastic",
        "dcos_commons_tpu_torch.recovery.manager",
        "dcos_commons_tpu_torch.decommission",
        "dcos_commons_tpu_torch.decommission.factory",
        "dcos_commons_tpu_torch.debug",
        "dcos_commons_tpu_torch.debug.trackers",
        "dcos_commons_tpu_torch.analysis",
        "dcos_commons_tpu_torch.analysis.speccheck",
        "dcos_commons_tpu_torch.health",
        "dcos_commons_tpu_torch.health.journal",
        "dcos_commons_tpu_torch.health.detectors",
        "dcos_commons_tpu_torch.health.monitor",
        "dcos_commons_tpu_torch.health.actions",
        "dcos_commons_tpu_torch.ha",
        "dcos_commons_tpu_torch.ha.rehydrate",
        "dcos_commons_tpu_torch.ha.election",
        "dcos_commons_tpu_torch.runtime",
        "dcos_commons_tpu_torch.runtime.token_bucket",
        "dcos_commons_tpu_torch.runtime.task_killer",
        "dcos_commons_tpu_torch.runtime.reconciler",
        "dcos_commons_tpu_torch.agent",
        "dcos_commons_tpu_torch.agent.base",
        "dcos_commons_tpu_torch.agent.local",
        "dcos_commons_tpu_torch.testing",
        "dcos_commons_tpu_torch.testing.fake_agent",
        "dcos_commons_tpu_torch.scheduler",
        "dcos_commons_tpu_torch.scheduler.config",
        "dcos_commons_tpu_torch.scheduler.scheduler",
        "dcos_commons_tpu_torch.native",
        "dcos_commons_tpu_torch.__main__",
        "dcos_commons_tpu_torch.security",
        "dcos_commons_tpu_torch.security.secrets",
        "dcos_commons_tpu_torch.security.tls",
        "dcos_commons_tpu_torch.uninstall",
        "dcos_commons_tpu_torch.uninstall.scheduler",
        "dcos_commons_tpu_torch.scheduler.builder",
        "dcos_commons_tpu_torch.testing.runner",
        "dcos_commons_tpu_torch.testing.ticks",
        "dcos_commons_tpu_torch.trace.export",
        "dcos_commons_tpu_torch.http",
        "dcos_commons_tpu_torch.http.api",
        "dcos_commons_tpu_torch.http.server",
        "dcos_commons_tpu_torch.cli",
        "dcos_commons_tpu_torch.cli.__main__",
        "dcos_commons_tpu_torch.cli.client",
        "dcos_commons_tpu_torch.cli.commands",
        "dcos_commons_tpu_torch.runtime.runner",
        "dcos_commons_tpu_torch.agent.daemon",
        "dcos_commons_tpu_torch.agent.remote",
        "dcos_commons_tpu_torch.storage.replication",
        "dcos_commons_tpu_torch.storage.remote",
        "dcos_commons_tpu_torch.testing.integration",
        "dcos_commons_tpu_torch.testing.diagnostics",
        "dcos_commons_tpu_torch.tools",
        "dcos_commons_tpu_torch.tools.packaging",
        "dcos_commons_tpu_torch.tools.registry",
        "dcos_commons_tpu_torch.multi",
        "dcos_commons_tpu_torch.multi.discipline",
        "dcos_commons_tpu_torch.multi.store",
        "dcos_commons_tpu_torch.multi.admission",
        "dcos_commons_tpu_torch.multi.scheduler",
        "dcos_commons_tpu_torch.analysis.racecheck",
        "dcos_commons_tpu_torch.analysis.lockcheck",
        "dcos_commons_tpu_torch.analysis.spmdcheck",
        "dcos_commons_tpu_torch.analysis.configcheck",
        "dcos_commons_tpu_torch.entry",
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
    from dcos_commons_tpu_torch.entry import entry
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
        lambda: entry(),
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


_NO_TORCH = r"""
import importlib, sys

class _NoTorch:
    def find_spec(self, name, path=None, target=None):
        if name == "torch" or name.startswith("torch."):
            raise ImportError("torch is blocked in this process")
        return None

sys.meta_path.insert(0, _NoTorch())
sys.path.insert(0, sys.argv[1])
for mod in sys.argv[2:]:
    importlib.import_module(mod)
print("imported", len(sys.argv) - 2)
"""

# the scheduler process, its API, CLI, agents, state server, multi
# mode and packaging: control plane only
CONTROL_PLANE = (
    "dcos_commons_tpu_torch.__main__", "dcos_commons_tpu_torch.cli",
    "dcos_commons_tpu_torch.http", "dcos_commons_tpu_torch.runtime.runner",
    "dcos_commons_tpu_torch.scheduler", "dcos_commons_tpu_torch.uninstall",
    "dcos_commons_tpu_torch.agent.local", "dcos_commons_tpu_torch.security",
    "dcos_commons_tpu_torch.testing", "dcos_commons_tpu_torch.trace",
    "dcos_commons_tpu_torch.agent.daemon",
    "dcos_commons_tpu_torch.agent.remote",
    "dcos_commons_tpu_torch.storage.remote",
    "dcos_commons_tpu_torch.storage.replication",
    "dcos_commons_tpu_torch.multi", "dcos_commons_tpu_torch.multi.admission",
    "dcos_commons_tpu_torch.tools.packaging",
    "dcos_commons_tpu_torch.tools.registry",
    "dcos_commons_tpu_torch.testing.integration",
    "dcos_commons_tpu_torch.testing.diagnostics",
)


def test_control_plane_imports_without_torch():
    """``serve``, ``cli``, ``agent``, ``state-server`` and ``package``
    need no card and no torch: a host without it runs the scheduler
    process, an agent daemon or a state server."""
    out = subprocess.run(
        [sys.executable, "-c", _NO_TORCH, REPO, *CONTROL_PLANE],
        capture_output=True, text=True, timeout=120, cwd=REPO,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert f"imported {len(CONTROL_PLANE)}" in out.stdout


SERVICE = ("name: s\npods:\n  p:\n    count: 1\n    tasks:\n"
           "      t:\n        goal: RUNNING\n        cmd: x\n"
           "        cpus: 0.1\n        memory: 32\n")


def _serve_multi_put(tmp_path):
    """PUT an admitted and a refused service through an ``ApiServer``
    over a real ``MultiServiceScheduler``: the status codes and the
    services stored."""
    import urllib.error
    import urllib.request

    from dcos_commons_tpu_torch.http import ApiServer
    from dcos_commons_tpu_torch.multi import MultiServiceScheduler
    from dcos_commons_tpu_torch.offer.inventory import GpuHost, SliceInventory
    from dcos_commons_tpu_torch.scheduler.config import SchedulerConfig
    from dcos_commons_tpu_torch.storage import MemPersister
    from dcos_commons_tpu_torch.testing import FakeAgent

    multi = MultiServiceScheduler(
        persister=MemPersister(),
        inventory=SliceInventory([GpuHost(host_id="h0")]),
        agent=FakeAgent(), scheduler_config=SchedulerConfig())
    server = ApiServer(multi=multi).start()
    codes = []
    try:
        for name, body in (("s", SERVICE), ("bad", SERVICE)):
            req = urllib.request.Request(server.url + f"/v1/multi/{name}",
                                         method="PUT", data=body.encode())
            try:
                with urllib.request.urlopen(req, timeout=30) as resp:
                    codes.append(resp.status)
            except urllib.error.HTTPError as e:
                codes.append(e.code)
    finally:
        server.stop()
    return codes, multi.service_names()


def _runner_entry(entry, tmp_path):
    from dcos_commons_tpu_torch.offer.inventory import GpuHost
    from dcos_commons_tpu_torch.runtime import runner
    from dcos_commons_tpu_torch.scheduler.config import SchedulerConfig
    from dcos_commons_tpu_torch.specification.yaml_spec import from_yaml
    from dcos_commons_tpu_torch.storage.remote import StateServer

    spec = from_yaml(SERVICE)
    config = SchedulerConfig(state_dir=str(tmp_path / "state"),
                             sandbox_root=str(tmp_path / "sbx"))
    if entry == "multi":
        built = runner.MultiFrameworkRunner([spec], config)
        built.build()
        return type(built.multi).__name__, built.multi.service_names()
    if entry == "agent_url":
        built = runner.FrameworkRunner(
            spec, config, topology_hosts=[GpuHost(host_id="h0")],
            agent_urls={"h0": "http://127.0.0.1:1"})
        built._build_infra()
        return type(built._agent).__name__, sorted(built._agent._clients)
    server = StateServer().start()
    try:
        config.state_url = server.url
        lock = runner.make_instance_lock(config, "scheduler-s")
        acquired = lock.acquire()
        lock.release()
        return type(lock).__name__, acquired
    finally:
        server.stop()


def _main(command, tmp_path, capsys):
    from dcos_commons_tpu_torch.__main__ import main

    with pytest.raises(SystemExit) as done:
        main([command, "--help"])
    usage = capsys.readouterr().out
    return done.value.code, usage.split()[1:3]


DISTRIBUTED = {
    "main agent": (lambda t, c: _main("agent", t, c),
                   (0, ["dcos_commons_tpu_torch", "agent"])),
    "main state-server": (lambda t, c: _main("state-server", t, c),
                          (0, ["dcos_commons_tpu_torch", "state-server"])),
    "main package": (lambda t, c: _main("package", t, c),
                     (0, ["dcos_commons_tpu_torch", "package"])),
    "runner --multi": (lambda t, c: _runner_entry("multi", t),
                       ("MultiServiceScheduler", ["s"])),
    "runner agent_url": (lambda t, c: _runner_entry("agent_url", t),
                         ("RemoteFleet", ["h0"])),
    "runner state_url": (lambda t, c: _runner_entry("state_url", t),
                         ("RemoteLocker", True)),
    "server multi dispatch": (lambda t, c: _serve_multi_put(t),
                              ([200, 422], ["s"])),
}


@pytest.mark.parametrize("entry", sorted(DISTRIBUTED))
def test_distributed_entry_runs(entry, tmp_path, capsys):
    """The entry points of the distributed control plane run: the
    ``agent``, ``state-server`` and ``package`` commands print their
    usage and exit 0; the runner builds a real ``MultiServiceScheduler``,
    ``RemoteFleet`` and ``RemoteLocker``; the API's ``/v1/multi``
    dispatch admits a service (200) and refuses one whose name is not
    the URL's (422)."""
    call, expected = DISTRIBUTED[entry]
    assert call(tmp_path, capsys) == expected

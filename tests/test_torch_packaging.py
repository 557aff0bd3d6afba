"""The port's packaging and registry (``tools/packaging.py``,
``tools/registry.py``) and the package flow into its multi scheduler,
against the JAX package's, on the CPU.

Each case is a scenario of ``tests/test_packaging.py`` written once and
run on both packages: the same framework directory built, extracted,
linted, published, fetched, pruned and installed by the JAX package's
tools, then by the port's.  A scenario returns what it observed
(manifests, digests, refusals, findings, registry indexes, plan
statuses, rendered templates), and the two packages' observations must
be equal.  A package one package builds extracts with the other.  The
CLI case runs ``package build``, ``serve --multi`` and ``package
install`` of each package as subprocesses, each with a deadline, and
kills them in a ``finally``.  The port's own frameworks directory lints
clean, as the JAX package's do."""

import importlib
import io
import json
import os
import re
import signal
import subprocess
import sys
import tarfile
import time
import types
import urllib.request
from contextlib import redirect_stdout

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def package(root, host):
    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    common = mod("common")
    tools = mod("tools")
    return types.SimpleNamespace(
        root=root, tools=tools, packaging=mod("tools.packaging"),
        registry=mod("tools.registry"),
        PackageError=tools.PackageError,
        MultiServiceScheduler=mod("multi").MultiServiceScheduler,
        TaskState=common.TaskState, TaskStatus=common.TaskStatus,
        Host=getattr(mod("offer.inventory"), host),
        SliceInventory=mod("offer.inventory").SliceInventory,
        SchedulerConfig=mod("scheduler").SchedulerConfig,
        SpecError=mod("specification.specs").SpecError,
        MemPersister=mod("storage").MemPersister,
        FakeAgent=mod("testing").FakeAgent,
    )


JAX = package("dcos_commons_tpu", "TpuHost")
PORT = package("dcos_commons_tpu_torch", "GpuHost")


def twin(scenario, tmp_path, *args):
    """Run ``scenario`` on both packages, each under a directory of its
    own; the observations must be equal.  Returns the port's."""
    runs = []
    for P in (JAX, PORT):
        root = tmp_path / P.root
        root.mkdir()
        runs.append(scenario(P, root, *args))
    assert runs[1] == runs[0]
    return runs[1]


def make_framework(root, name="pkgsvc"):
    d = root / name
    d.mkdir()
    (d / "svc.yml").write_text(f"""
name: {name}
pods:
  app:
    count: 1
    tasks:
      main:
        goal: RUNNING
        cmd: "cat app.cfg && sleep 100"
        cpus: 0.1
        memory: 32
        configs:
          cfg:
            template: app.cfg.mustache
            dest: app.cfg
""")
    (d / "app.cfg.mustache").write_text("task={{TASK_NAME}}\n")
    return str(d)


def raised(P, call):
    """The ``PackageError`` or ``SpecError`` text ``call`` raises, the
    package's own directory in a path named ``<pkg>``."""
    try:
        call()
    except (P.PackageError, P.SpecError) as e:
        return type(e).__name__, re.sub(r"/dcos_commons_tpu(_torch)?\b",
                                        "/<pkg>", str(e))
    raise AssertionError("nothing raised")


def members(path):
    with tarfile.open(path, "r:gz") as tar:
        return {m.name: tar.extractfile(m).read() for m in tar.getmembers()}


def test_build_gives_the_jax_manifest_and_members(tmp_path):
    """One framework directory built by both packages: the same manifest
    (name, version, every file's sha256) and the same member bytes; each
    package extracts the other's build."""
    framework = make_framework(tmp_path)
    built = {}
    for P in (JAX, PORT):
        out = str(tmp_path / f"{P.root}.tgz")
        manifest = P.tools.build_package(framework, out, version="1.2.3")
        built[P.root] = (manifest, members(out), P.tools.read_manifest(out))
    assert built["dcos_commons_tpu_torch"] == built["dcos_commons_tpu"]
    manifest = built["dcos_commons_tpu"][0]
    assert manifest["name"] == "pkgsvc"
    assert set(manifest["files"]) == {"svc.yml", "app.cfg.mustache"}
    for builder, extractor in ((JAX, PORT), (PORT, JAX)):
        with open(tmp_path / f"{builder.root}.tgz", "rb") as f:
            payload = f.read()
        dest = tmp_path / f"x-{builder.root}"
        assert extractor.tools.extract_package(payload, str(dest)) == manifest
        assert (dest / "svc.yml").read_text() == open(
            os.path.join(framework, "svc.yml")).read()


def scenario_digests(P, root):
    framework = make_framework(root)
    out = str(root / "pkgsvc.tgz")
    P.tools.build_package(framework, out)
    with open(out, "rb") as f:
        manifest = P.tools.extract_package(f.read(), str(root / "x"))
    observed = [sorted(manifest["files"]), (root / "x" / "svc.yml").exists()]
    bad_dir = root / "bad"
    bad_dir.mkdir()
    with tarfile.open(out, "r:gz") as tar:
        tar.extractall(bad_dir, filter="data")
    (bad_dir / "svc.yml").write_text("name: tampered\npods: {}\n")
    bad_out = str(root / "bad.tgz")
    with tarfile.open(bad_out, "w:gz") as tar:
        for name in ("package.json", "svc.yml", "app.cfg.mustache"):
            tar.add(str(bad_dir / name), arcname=name)
    with open(bad_out, "rb") as f:
        bad_payload = f.read()
    observed.append(raised(P, lambda: P.tools.extract_package(
        bad_payload, str(root / "y"))))
    return observed


def test_extract_verifies_digests(tmp_path):
    out = twin(scenario_digests, tmp_path)
    assert out[2] == ("PackageError", "digest mismatch for 'svc.yml'")


def scenario_traversal(P, root):
    evil = io.BytesIO()
    with tarfile.open(fileobj=evil, mode="w:gz") as tar:
        manifest = json.dumps({"name": "evil", "files": {
            "../escape": "0" * 64, "svc.yml": "0" * 64}}).encode()
        member = tarfile.TarInfo("package.json")
        member.size = len(manifest)
        tar.addfile(member, io.BytesIO(manifest))
        data = b"pwned"
        member = tarfile.TarInfo("../escape")
        member.size = len(data)
        tar.addfile(member, io.BytesIO(data))
    (root / "t").mkdir()
    return [raised(P, lambda: P.tools.extract_package(
        evil.getvalue(), str(root / "t"))), (root / "escape").exists()]


def test_extract_rejects_traversal(tmp_path):
    out = twin(scenario_traversal, tmp_path)
    assert out == [("PackageError",
                    "package member escapes target: '../escape'"), False]


def make_multi(P, root):
    return P.MultiServiceScheduler(
        persister=P.MemPersister(),
        inventory=P.SliceInventory([P.Host(host_id="h0")]),
        agent=P.FakeAgent(),
        scheduler_config=P.SchedulerConfig(
            backoff_enabled=False, revive_capacity=1_000_000,
            state_dir=str(root / "state")),
    )


def scenario_install(P, root):
    framework = make_framework(root)
    out = str(root / "pkgsvc.tgz")
    P.tools.build_package(framework, out)
    multi = make_multi(P, root)
    with open(out, "rb") as f:
        multi.install_package("pkgsvc", f.read())
    svc = multi.get_service("pkgsvc")
    template = svc.spec.pod("app").task("main").config_templates[0][0]
    observed = [multi.service_names(),
                os.path.relpath(template, root).split(os.sep)[:3],
                os.path.isfile(template)]
    multi.run_cycle()
    agent = multi.agent
    observed.append(agent.task_id_of("app-0-main") is not None)
    agent.send(P.TaskStatus(task_id=agent.task_id_of("app-0-main"),
                            state=P.TaskState.RUNNING, ready=True))
    multi.run_cycle()
    observed.append(svc.deploy_manager.get_plan().is_complete)
    return observed


def test_install_package_into_multi_scheduler(tmp_path):
    assert twin(scenario_install, tmp_path) == [
        ["pkgsvc"], ["state", "packages", "pkgsvc"], True, True, True]


def scenario_bad_names(P, root):
    multi = make_multi(P, root)
    framework = make_framework(root, name="okpkg")
    out = str(root / "okpkg.tgz")
    P.tools.build_package(framework, out)
    with open(out, "rb") as f:
        payload = f.read()
    refused = [raised(P, lambda: multi.install_package(bad, payload))
               for bad in ("..", ".", "a/b", "", ".hidden")]
    return [refused, (root / "state" / "svc.yml").exists()]


def test_install_rejects_traversal_service_name(tmp_path):
    out = twin(scenario_bad_names, tmp_path)
    assert {kind for kind, _ in out[0]} == {"SpecError"} and not out[1]


def drive_until_complete(P, multi):
    agent = multi.agent
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        multi.run_cycle()
        task_id = agent.task_id_of("app-0-main")
        if task_id is not None and task_id in agent.active_task_ids():
            agent.send(P.TaskStatus(task_id=task_id,
                                    state=P.TaskState.RUNNING, ready=True))
        svc = multi.get_service("pkgsvc")
        plans = svc.plans()
        rollout = plans.get("update") or plans.get("deploy")
        if rollout.is_complete:
            return svc
    raise AssertionError("rollout did not complete")


def scenario_upgrade(P, root):
    framework = make_framework(root)
    v1 = str(root / "v1.tgz")
    P.tools.build_package(framework, v1)
    multi = make_multi(P, root)
    with open(v1, "rb") as f:
        payload_v1 = f.read()
    observed = [raised(P, lambda: multi.install_package(
        "pkgsvc", payload_v1, upgrade=True))]
    multi.install_package("pkgsvc", payload_v1)
    svc = drive_until_complete(P, multi)
    first = svc.state_store.fetch_task("app-0-main")
    observed.append(raised(P, lambda: multi.install_package(
        "pkgsvc", payload_v1)))
    with open(os.path.join(framework, "svc.yml")) as f:
        yaml_v2 = f.read().replace("sleep 100", "sleep 200")
    with open(os.path.join(framework, "svc.yml"), "w") as f:
        f.write(yaml_v2)
    v2 = str(root / "v2.tgz")
    P.tools.build_package(framework, v2, version="0.2.0")
    with open(v2, "rb") as f:
        multi.install_package("pkgsvc", f.read(), upgrade=True)
    svc = drive_until_complete(P, multi)
    info = svc.state_store.fetch_task("app-0-main")
    observed.append([info.task_id != first.task_id,
                     "sleep 200" in info.command,
                     "sleep 200" in first.command, sorted(svc.plans())])
    return observed


def test_package_upgrade_rolls_running_service(tmp_path):
    out = twin(scenario_upgrade, tmp_path)
    assert out[0] == ("SpecError", "no service 'pkgsvc' to upgrade") or \
        "no service" in out[0][1]
    assert "already exists" in out[1][1]
    assert out[2][:3] == [True, True, False]


def scenario_prune_versions(P, root):
    framework = make_framework(root)
    v1 = str(root / "v1.tgz")
    P.tools.build_package(framework, v1, version="0.1.0")
    multi = make_multi(P, root)
    with open(v1, "rb") as f:
        multi.install_package("pkgsvc", f.read())
    pkg_root = root / "state" / "packages" / "pkgsvc"

    def versions():
        return sorted(d.split("-")[0] for d in os.listdir(pkg_root)
                      if not d.startswith("."))

    observed = [versions()]
    for n, ver in enumerate(("0.2.0", "0.3.0", "0.4.0"), start=2):
        with open(os.path.join(framework, "svc.yml")) as f:
            yaml_n = f.read().replace(f"sleep {(n - 1) * 100}",
                                      f"sleep {n * 100}")
        with open(os.path.join(framework, "svc.yml"), "w") as f:
            f.write(yaml_n)
        tgz = str(root / f"v{n}.tgz")
        P.tools.build_package(framework, tgz, version=ver)
        with open(tgz, "rb") as f:
            multi.install_package("pkgsvc", f.read(), upgrade=True)
        observed.append(versions())
    svc = multi.get_service("pkgsvc")
    referenced = set()
    for cfg_id in svc.config_store.list_ids():
        blob = json.dumps(svc.config_store.fetch(cfg_id))
        for part in blob.split("packages/pkgsvc/")[1:]:
            referenced.add(part.split("/")[0].split('"')[0].split("-")[0])
    observed.append(sorted(referenced))
    return observed


def test_package_upgrade_prunes_superseded_version_dirs(tmp_path):
    out = twin(scenario_prune_versions, tmp_path)
    assert "0.1.0" not in out[3] and "0.4.0" in out[3] and len(out[3]) <= 3
    assert set(out[4]) <= set(out[3])


def airgap_fixture(root):
    d = root / "fw"
    d.mkdir()
    (d / "svc.yml").write_text(
        "name: x\n"
        "# comment with https://example.com is fine\n"
        "pods:\n"
        "  app:\n"
        "    count: 1\n"
        "    image: registry.example.com/app:1\n"
        "    tasks:\n"
        "      main:\n"
        "        goal: RUNNING\n"
        '        cmd: "curl https://artifacts.example.com/blob '
        '&& curl http://127.0.0.1:8080/ok && sleep 1"\n'
        "        cpus: 0.1\n"
        "        memory: 32\n")
    (d / "run.sh").write_text(
        "case $1 in\n"
        "*) curl https://sneaky.example.com/payload ;;\n"
        "esac\n"
        "echo http://[::1]:9000/metrics\n")
    (d / ".git").mkdir()
    (d / ".git" / "config").write_text("url = https://github.com/x/y\n")
    return str(d)


def scenario_airgap(P, root):
    lint = P.packaging.lint_airgap
    observed = [lint(airgap_fixture(root))]
    observed.append(raised(P, lambda: lint(str(root / "not-here"))))
    observed.append({name: lint(os.path.join(REPO, "frameworks", name))
                     for name in ("helloworld", "hdfs", "jax")})
    return observed


def test_airgap_lint(tmp_path):
    """The same findings on the fixture (external URLs and registry
    image pulls; not loopback, comments or unshipped files), the same
    refusal of a missing dir, and every shipped framework clean."""
    out = twin(scenario_airgap, tmp_path)
    assert len(out[0]) == 3
    assert any("sneaky.example.com" in f for f in out[0])
    assert out[1][1].startswith("no such framework dir: ")
    assert out[2] == {"helloworld": [], "hdfs": [], "jax": []}


def test_port_frameworks_dir_lints_clean():
    """The port's frameworks directory (its YAMLs, options and workers)
    bakes in no external URL or image pull, by either package's lint."""
    frameworks = os.path.join(REPO, "dcos_commons_tpu_torch", "frameworks")
    assert PORT.packaging.lint_airgap(frameworks) == []
    assert JAX.packaging.lint_airgap(frameworks) == []


def test_port_frameworks_dir_packages_the_trainer(tmp_path):
    """``package build`` of the port's frameworks directory ships the
    trainer's svc.yml and options.json with the workers, and the bundle
    extracts; the JAX package's build of the same directory gives the
    same manifest."""
    frameworks = os.path.join(REPO, "dcos_commons_tpu_torch", "frameworks")
    out = {}
    for P in (JAX, PORT):
        path = str(tmp_path / f"{P.root}.tgz")
        out[P.root] = P.tools.build_package(frameworks, path,
                                            name="torch-trainer")
    manifest = out["dcos_commons_tpu_torch"]
    assert manifest == out["dcos_commons_tpu"]
    assert {"svc.yml", "options.json", "train_worker.py"} <= set(
        manifest["files"])
    assert not any("__pycache__" in f for f in manifest["files"])
    with open(tmp_path / "dcos_commons_tpu_torch.tgz", "rb") as f:
        assert PORT.tools.extract_package(f.read(), str(tmp_path / "x"))


# -- registry ------------------------------------------------------------


def scenario_registry(P, root):
    framework = make_framework(root)
    registry = str(root / "registry")
    v1 = str(root / "pkgsvc-1.tgz")
    P.tools.build_package(framework, v1, version="1.0.0")
    first = P.tools.publish_package(v1, registry)
    observed = [first["version"],
                P.tools.publish_package(v1, registry)["sha256"]
                == first["sha256"]]
    (root / "pkgsvc" / "extra.txt").write_text("changed\n")
    mutated = str(root / "pkgsvc-1b.tgz")
    P.tools.build_package(framework, mutated, version="1.0.0")
    observed.append(raised(P, lambda: P.tools.publish_package(
        mutated, registry)))
    v2 = str(root / "pkgsvc-2.tgz")
    P.tools.build_package(framework, v2, version="1.10.0")
    P.tools.publish_package(v2, registry)
    index = P.tools.registry_index(registry)
    observed.append(sorted(index["packages"]["pkgsvc"]))
    version, payload = P.tools.fetch_package(registry, "pkgsvc")
    observed += [version, payload == open(v2, "rb").read()]
    observed.append(P.tools.fetch_package(registry, "pkgsvc",
                                          version="1.0.0")[0])
    observed.append(raised(P, lambda: P.tools.fetch_package(registry,
                                                            "nope")))
    return observed


def test_registry_publish_resolve_and_immutability(tmp_path):
    out = twin(scenario_registry, tmp_path)
    assert out[:2] == ["1.0.0", True] and "immutable" in out[2][1]
    assert out[3:7] == [["1.0.0", "1.10.0"], "1.10.0", True, "1.0.0"]


def scenario_registry_http(P, root):
    framework = make_framework(root)
    pkg = str(root / "pkgsvc.tgz")
    P.tools.build_package(framework, pkg, version="2.0.0")
    registry = str(root / "registry")
    server = P.tools.RegistryServer(registry, auth_token="hunter2").start()
    try:
        observed = [raised(P, lambda: P.tools.publish_package(
            pkg, server.url))]
        observed.append(P.tools.publish_package(pkg, server.url,
                                                token="hunter2")["version"])
        version, payload = P.tools.fetch_package(server.url, "pkgsvc")
        observed += [version, payload == open(pkg, "rb").read()]
        artifact = os.path.join(registry, "artifacts",
                                "pkgsvc-2.0.0.tar.gz")
        with open(artifact, "ab") as f:
            f.write(b"tamper")
        observed.append(raised(P, lambda: P.tools.fetch_package(
            server.url, "pkgsvc")))
        return observed
    finally:
        server.stop()


def test_registry_http_server_and_digest_verification(tmp_path):
    out = twin(scenario_registry_http, tmp_path)
    assert "token" in out[0][1] and out[1:4] == ["2.0.0", "2.0.0", True]
    assert "digest mismatch" in out[4][1]


def test_registry_server_serves_the_other_packages_client(tmp_path):
    """A port client publishes to and fetches from a JAX
    ``RegistryServer``, and the reverse: the registry's wire is the
    same."""
    framework = make_framework(tmp_path)
    pkg = str(tmp_path / "pkgsvc.tgz")
    JAX.tools.build_package(framework, pkg, version="4.0.0")
    for server_pkg, client_pkg in ((JAX, PORT), (PORT, JAX)):
        registry = str(tmp_path / f"registry-{server_pkg.root}")
        server = server_pkg.tools.RegistryServer(
            registry, auth_token="t").start()
        try:
            out = client_pkg.tools.publish_package(pkg, server.url,
                                                   token="t")
            assert out["version"] == "4.0.0"
            version, payload = client_pkg.tools.fetch_package(server.url,
                                                              "pkgsvc")
            assert version == "4.0.0" and payload == open(pkg, "rb").read()
            assert client_pkg.tools.registry_index(server.url) == \
                server_pkg.tools.registry_index(registry)
        finally:
            server.stop()


def scenario_version_order(P, root):
    framework = make_framework(root)
    registry = str(root / "registry")
    for version in ("1.0.0-rc1", "1.0.0", "0.9.9"):
        out = str(root / f"p-{version}.tgz")
        P.tools.build_package(framework, out, version=version)
        P.tools.publish_package(out, registry)
    return [P.tools.fetch_package(registry, "pkgsvc")[0],
            P.tools.fetch_package(registry, "pkgsvc",
                                  version="1.0.0-rc1")[0]]


def test_registry_version_ordering_release_beats_prerelease(tmp_path):
    assert twin(scenario_version_order, tmp_path) == ["1.0.0", "1.0.0-rc1"]


def scenario_prune_grace(P, root):
    framework = make_framework(root)
    registry = str(root / "registry")
    for version in ("1.0.0", "1.1.0"):
        artifact = str(root / f"p-{version}.tgz")
        P.tools.build_package(framework, artifact, version=version)
        P.tools.publish_package(artifact, registry)
    observed = [P.registry.prune_registry(registry, keep=1, grace_s=3600.0),
                sorted(P.tools.registry_index(registry)["packages"][
                    "pkgsvc"])]
    artifact_dir = os.path.join(registry, "artifacts")
    parked = [n for n in os.listdir(artifact_dir)
              if n.startswith("pkgsvc-1.0.0") and ".trash-" in n]
    observed.append(len(parked))
    observed.append(P.registry.prune_registry(registry, keep=1,
                                              grace_s=3600.0))
    observed.append(parked[0] in os.listdir(artifact_dir))
    observed.append(P.registry.prune_registry(registry, keep=1))
    observed.append(parked[0] in os.listdir(artifact_dir))
    aged = parked[0].rsplit(".trash-", 1)[0] + ".trash-1000-60"
    os.rename(os.path.join(artifact_dir, parked[0]),
              os.path.join(artifact_dir, aged))
    observed.append(P.registry.prune_registry(registry, keep=1,
                                              grace_s=3600.0))
    observed.append(sorted(os.listdir(artifact_dir)))
    return observed


def test_registry_prune_grace_window_parks_artifacts(tmp_path):
    assert twin(scenario_prune_grace, tmp_path) == [
        {"pkgsvc": ["1.0.0"]}, ["1.1.0"], 1, {}, True, {}, True, {},
        ["pkgsvc-1.1.0.tar.gz"]]


def scenario_prune_retire(P, root):
    framework = make_framework(root)
    other = make_framework(root, name="othersvc")
    registry = str(root / "registry")
    for version in ("1.0.0", "1.1.0", "1.2.0", "1.10.0"):
        artifact = str(root / f"p-{version}.tgz")
        P.tools.build_package(framework, artifact, version=version)
        P.tools.publish_package(artifact, registry)
    artifact = str(root / "other-1.tgz")
    P.tools.build_package(other, artifact, version="0.1.0")
    P.tools.publish_package(artifact, registry)
    prune = P.registry.prune_registry
    observed = [prune(registry, keep=2, name="pkgsvc")]
    index = P.tools.registry_index(registry)
    observed.append({name: sorted(versions) for name, versions
                     in index["packages"].items()})
    observed.append(sorted(os.listdir(os.path.join(registry, "artifacts"))))
    observed.append(P.tools.fetch_package(registry, "pkgsvc")[0])
    observed.append(prune(registry, keep=2))
    observed += [raised(P, lambda: prune("http://reg:8081", keep=2)),
                 raised(P, lambda: prune(registry, keep=0)),
                 raised(P, lambda: prune(registry, keep=1, name="ghost")),
                 raised(P, lambda: prune(str(root / "typo"), keep=1))]
    (root / "pkgsvc" / "mutated.txt").write_text("different\n")
    remut = str(root / "p-1.0.0-mut.tgz")
    P.tools.build_package(framework, remut, version="1.0.0")
    observed.append(raised(P, lambda: P.tools.publish_package(
        remut, registry)))
    observed.append(P.tools.publish_package(
        str(root / "p-1.0.0.tgz"), registry)["version"])
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = P.packaging.main(["registry-prune", "--dir", registry,
                               "--keep", "1"])
    observed += [rc, json.loads(buf.getvalue())["pruned"],
                 sorted(P.tools.registry_index(registry)["packages"][
                     "pkgsvc"])]
    return observed


def test_registry_prune_retires_old_releases(tmp_path):
    out = twin(scenario_prune_retire, tmp_path)
    assert out[0] == {"pkgsvc": ["1.0.0", "1.1.0"]}
    assert out[1] == {"othersvc": ["0.1.0"], "pkgsvc": ["1.10.0", "1.2.0"]}
    assert "tombstoned" in out[9][1] and out[10] == "1.0.0"
    assert out[11:] == [0, {"pkgsvc": ["1.0.0", "1.2.0"]}, ["1.10.0"]]


# -- the CLI over processes ----------------------------------------------


def scenario_cli_install(P, root):
    """``package build``, ``serve --multi`` and ``package install`` of
    one package as processes; the packaged template is rendered into
    the task's sandbox."""
    framework = make_framework(root)
    out = str(root / "pkgsvc.tgz")
    built = subprocess.run(
        [sys.executable, "-m", P.root, "package", "build", framework,
         "-o", out], cwd=REPO, capture_output=True, text=True, timeout=60)
    assert built.returncode == 0, built.stderr
    topology = root / "topology.yml"
    topology.write_text(
        "hosts:\n  - host_id: h0\n    cpus: 8\n    memory_mb: 8192\n")
    announce = root / "announce"
    sandbox = root / "sbx"
    proc = subprocess.Popen(
        [sys.executable, "-m", P.root, "serve", "--multi", "--topology",
         str(topology), "--port", "0", "--state-dir", str(root / "state"),
         "--sandbox-root", str(sandbox), "--announce-file", str(announce)],
        cwd=REPO, start_new_session=True, stdout=subprocess.DEVNULL,
        stderr=open(root / "serve.log", "w"))
    try:
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not announce.exists():
            assert proc.poll() is None, (root / "serve.log").read_text()
            time.sleep(0.1)
        url = announce.read_text().strip()
        installed = subprocess.run(
            [sys.executable, "-m", P.root, "package", "install", out,
             "--url", url],
            cwd=REPO, capture_output=True, text=True, timeout=60)
        observed = [installed.returncode]

        def get(path):
            with urllib.request.urlopen(url + path, timeout=5) as r:
                return json.loads(r.read())

        status = None
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and status != "COMPLETE":
            try:
                status = get("/v1/multi/pkgsvc/v1/plans/deploy")["status"]
            except OSError:
                pass
            time.sleep(0.3)
        observed += [status, get("/v1/multi"),
                     (sandbox / "app-0-main" / "app.cfg").read_text()]
        return observed
    finally:
        try:
            os.killpg(proc.pid, signal.SIGTERM)
            proc.wait(timeout=20)
        except (ProcessLookupError, subprocess.TimeoutExpired):
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=20)
        for dirpath, _dirs, files in os.walk(sandbox):
            for name in ("child.pid", "task.pid"):
                if name in files:
                    try:
                        with open(os.path.join(dirpath, name)) as f:
                            os.killpg(int(f.read()), signal.SIGKILL)
                    except (OSError, ValueError):
                        pass


def test_package_cli_build_and_wire_install(tmp_path):
    assert twin(scenario_cli_install, tmp_path) == [
        0, "COMPLETE", ["pkgsvc"], "task=app-0-main\n"]

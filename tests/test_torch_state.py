"""The port's state stores (``dcos_commons_tpu_torch/state``: the config,
options, framework and schema-version stores and the launch recorder)
against the JAX package's, on the CPU.

tests/test_state.py's cases run on the port.  Then the same operations
through both packages' stores, over ``MemPersister`` and over
``FileWalPersister``, leave the same bytes, and what either package
wrote reads back equal in the other: the control-plane state a
deployment carries from the JAX package to the port, and back.  Config
and framework ids are uuid4s: each side draws them from the same pinned
sequence, and the status timestamps the launch recorder seeds from the
same pinned clock."""

import itertools
import os
import types

import pytest

from dcos_commons_tpu import common as j_common
from dcos_commons_tpu import state as j_state
from dcos_commons_tpu.specification import yaml_spec as j_yaml
from dcos_commons_tpu.state import config_store as j_config_store
from dcos_commons_tpu.state import framework_store as j_framework_store
from dcos_commons_tpu.storage import FileWalPersister as JFileWalPersister
from dcos_commons_tpu.storage import MemPersister as JMemPersister
from dcos_commons_tpu.tools import options as j_options
from dcos_commons_tpu_torch import common as t_common
from dcos_commons_tpu_torch import state as t_state
from dcos_commons_tpu_torch.specification import yaml_spec as t_yaml
from dcos_commons_tpu_torch.state import config_store as t_config_store
from dcos_commons_tpu_torch.state import framework_store as t_framework_store
from dcos_commons_tpu_torch.storage import FileWalPersister
from dcos_commons_tpu_torch.storage import MemPersister as TMemPersister
from dcos_commons_tpu_torch.tools import options as t_options
from test_torch_plan import PinnedUuid

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
HELLO = os.path.join(REPO, "frameworks", "helloworld")


def _port_cases():
    """tests/test_state.py with its imports pointed at the port."""
    with open(os.path.join(HERE, "test_state.py")) as f:
        source = f.read()
    source = source.replace("from dcos_commons_tpu.",
                            "from dcos_commons_tpu_torch.")
    assert "dcos_commons_tpu." not in source
    module = types.ModuleType("port_state_cases")
    module.__file__ = os.path.join(HERE, "test_state.py")
    exec(compile(source, module.__file__, "exec"), module.__dict__)
    return module


PORT_CASES = _port_cases()
CASES = sorted(n for n in vars(PORT_CASES) if n.startswith("test_"))


def test_every_state_case_is_run():
    assert len(CASES) == 13, CASES


@pytest.mark.parametrize("name", CASES)
def test_state_case_on_the_port(name):
    getattr(PORT_CASES, name)()


JAX = types.SimpleNamespace(
    name="jax", common=j_common, state=j_state, yaml=j_yaml,
    options=j_options, config_store=j_config_store,
    framework_store=j_framework_store, mem=JMemPersister,
    wal=JFileWalPersister,
)
PORT = types.SimpleNamespace(
    name="port", common=t_common, state=t_state, yaml=t_yaml,
    options=t_options, config_store=t_config_store,
    framework_store=t_framework_store, mem=TMemPersister,
    wal=FileWalPersister,
)
PACKAGES = (JAX, PORT)


class PinnedClock:
    """A stand-in for the ``time`` module whose clock counts seconds."""

    def __init__(self):
        self._next = itertools.count(1_700_000_000)

    def time(self):
        return float(next(self._next))


@pytest.fixture
def pinned(monkeypatch):
    """Ids and status timestamps from per-package pinned sequences."""
    for pkg in PACKAGES:
        monkeypatch.setattr(pkg.config_store, "uuid_mod", PinnedUuid())
        monkeypatch.setattr(pkg.framework_store, "uuid", PinnedUuid())
        monkeypatch.setattr(pkg.common, "time", PinnedClock())


def _spec(pkg, name):
    schema = pkg.options.load_schema(HELLO)
    env = pkg.options.render_options(schema, {}) if schema else {}
    return pkg.yaml.from_yaml_file(os.path.join(HELLO, name), env)


def _infos(pkg, config_id):
    common = pkg.common
    return [
        common.TaskInfo(
            name=f"hello-{i}-server", task_id=f"hello-{i}-server__{i:032x}",
            agent_id=f"host-{i}", pod_type="hello", pod_index=i,
            command="echo hi", env={"FOO": "bar"},
            labels={common.Label.TARGET_CONFIG: config_id},
        )
        for i in range(2)
    ]


def write_all(pkg, persister, spec_pkg=None):
    """The same operations through each of the package's stores, the
    configs two helloworld specs as ``spec_pkg`` (default: ``pkg``)
    encodes them.  Returns what the stores report."""
    state = pkg.state
    configs = state.ConfigStore(persister)
    spec_pkg = spec_pkg or pkg
    old = configs.store(_spec(spec_pkg, "simple.yml").to_dict())
    target = configs.store(_spec(spec_pkg, "svc.yml").to_dict())
    configs.set_target_config(old)
    configs.set_target_config(target)
    options = pkg.config_store.OptionsStore(persister)
    options.store({"hello.count": "3", "world.cpus": "0.5"})
    frameworks = state.FrameworkStore(persister)
    framework_id = frameworks.get_or_create_framework_id()
    frameworks.store_coordinator_address("trainer", "10.0.0.1:8476")
    frameworks.store_coordinator_address("serve", "10.0.0.2:8476")
    schema = state.SchemaVersionStore(persister)
    schema.check()
    store = state.StateStore(persister)
    state.PersistentLaunchRecorder(store).record(_infos(pkg, target))
    return {"config_ids": [old, target], "framework_id": framework_id}


def read_all(pkg, persister):
    """Everything the stores hold, as plain data."""
    state = pkg.state
    configs = state.ConfigStore(persister)
    store = state.StateStore(persister)
    frameworks = state.FrameworkStore(persister)
    target = configs.get_target_config()
    spec = pkg.yaml.ServiceSpec.from_dict(configs.fetch_target())
    return {
        "config_ids": sorted(configs.list_ids()),
        "target": target,
        "configs": {cid: configs.fetch(cid) for cid in configs.list_ids()},
        "spec": (spec.name, [(p.type, p.count) for p in spec.pods]),
        "options": pkg.config_store.OptionsStore(persister).fetch(),
        "framework_id": frameworks.fetch_framework_id(),
        "coordinators": [frameworks.fetch_coordinator_address(p)
                         for p in ("trainer", "serve", "other")],
        "schema": state.SchemaVersionStore(persister).fetch(),
        "tasks": [info.to_dict() for info in store.fetch_tasks()],
        "statuses": {name: status.to_dict()
                     for name, status in store.fetch_statuses().items()},
    }


# A spec's dict names its pods' resource block ``tpu`` in the JAX
# package and ``gpu`` in the port (both null for a helloworld pod), so
# the byte comparisons store the JAX package's dicts on both sides; the
# crossings below store each writer's own.


def test_mem_stores_write_the_same_bytes(pinned):
    dumps, reports = [], []
    for pkg in PACKAGES:
        persister = pkg.mem()
        reports.append(write_all(pkg, persister, spec_pkg=JAX))
        dumps.append(persister.dump())
    assert reports[0] == reports[1]
    assert dumps[0] == dumps[1]
    assert sum(k.startswith("/configurations/") for k in dumps[0]) == 2
    assert {"/service_options", "/framework-id", "/coordinator-address",
            "/schema-version", "/config-target"} <= set(dumps[0])


def test_wal_stores_write_the_same_bytes(pinned, tmp_path):
    blobs = []
    for pkg in PACKAGES:
        directory = str(tmp_path / pkg.name)
        persister = pkg.wal(directory, fsync=False, compact_every=4)
        write_all(pkg, persister, spec_pkg=JAX)
        persister.close()
        blobs.append({name: open(os.path.join(directory, name), "rb").read()
                      for name in sorted(os.listdir(directory))})
    assert blobs[0] == blobs[1]
    assert "wal.log" in blobs[0]


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax-to-port", "port-to-jax"])
def test_wal_stores_cross_between_packages(writer, reader, pinned, tmp_path,
                                           monkeypatch):
    directory = str(tmp_path)
    persister = writer.wal(directory, fsync=False)
    written = write_all(writer, persister)
    want = read_all(writer, persister)
    persister.close()
    assert want["config_ids"] == sorted(written["config_ids"])
    assert want["target"] == written["config_ids"][1]
    assert want["schema"] == 1
    assert [s["state"] for s in want["statuses"].values()] == [
        "TASK_STAGING", "TASK_STAGING"]
    persister = reader.wal(directory, fsync=False)
    assert read_all(reader, persister) == want
    # the reader's writes land in the same log, and the writer reads
    # them back: a config update (its id drawn past the writer's), a
    # prune and a status
    monkeypatch.setattr(reader.config_store, "uuid_mod", PinnedUuid(100))
    configs = reader.state.ConfigStore(persister)
    new = configs.store(_spec(reader, "simple.yml").to_dict())
    configs.set_target_config(new)
    assert configs.prune(referenced_ids=[want["target"]]) == [
        written["config_ids"][0]]
    store = reader.state.StateStore(persister)
    store.store_status("hello-0-server", reader.common.TaskStatus(
        task_id="hello-0-server__" + "0" * 32,
        state=reader.common.TaskState.RUNNING, ready=True))
    after = read_all(reader, persister)
    persister.close()
    persister = writer.wal(directory, fsync=False)
    assert read_all(writer, persister) == after
    assert after["target"] == new
    assert after["statuses"]["hello-0-server"]["state"] == "TASK_RUNNING"
    persister.close()


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax-to-port", "port-to-jax"])
def test_schema_guard_crosses_between_packages(writer, reader):
    persister = writer.mem()
    writer.state.SchemaVersionStore(persister).store(99)
    blob = persister.dump()
    other = reader.mem()
    for path, value in blob.items():
        if value is not None:
            other.set(path, value)
    with pytest.raises(RuntimeError) as got:
        reader.state.SchemaVersionStore(other).check()
    with pytest.raises(RuntimeError) as want:
        writer.state.SchemaVersionStore(persister).check()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("pkg", PACKAGES, ids=lambda p: p.name)
def test_options_store_snapshot_restores_exact_bytes(pkg):
    """``OptionsStore``'s raw snapshot/restore and its tolerant fetch,
    as each package has them; the bytes are compared across packages in
    the tests above."""
    persister = pkg.mem()
    options = pkg.config_store.OptionsStore(persister)
    assert options.fetch() == {}
    assert options.snapshot_raw() is None
    options.store({"b": "2", "a": "1"})
    raw = options.snapshot_raw()
    assert raw == b'{"a": "1", "b": "2"}'
    options.store({"a": "9"})
    options.restore_raw(raw)
    assert options.fetch() == {"a": "1", "b": "2"}
    options.restore_raw(None)
    assert options.fetch() == {} and options.snapshot_raw() is None
    persister.set(pkg.config_store.OptionsStore.NODE, b"not json")
    assert options.fetch() == {}

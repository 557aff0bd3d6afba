"""The port's storage, state store and reservation ledger against the
JAX package's, on the CPU.

The cases of tests/test_storage.py run on the port's persisters (the
remote persister's run in tests/test_torch_state_server.py),
the torn-tail probe appends garbage to ``wal.log`` and committed
records survive, and a ``FileWalPersister`` directory holding a
``StateStore`` and a ``ReservationLedger`` written by either package
reads back equal in the other: the state a deployment carries across
from the JAX package to the port, and back."""

import os
import types

import pytest

from dcos_commons_tpu import common as j_common
from dcos_commons_tpu.offer import ledger as j_ledger
from dcos_commons_tpu.state import state_store as j_state
from dcos_commons_tpu.storage import FileWalPersister as JFileWalPersister
from dcos_commons_tpu_torch import common as t_common
from dcos_commons_tpu_torch.offer import ledger as t_ledger
from dcos_commons_tpu_torch.state import state_store as t_state
from dcos_commons_tpu_torch.storage import FileWalPersister

HERE = os.path.dirname(os.path.abspath(__file__))


def _port_cases():
    """tests/test_storage.py with its imports pointed at the port."""
    with open(os.path.join(HERE, "test_storage.py")) as f:
        source = f.read()
    source = source.replace("from dcos_commons_tpu.storage import",
                            "from dcos_commons_tpu_torch.storage import")
    assert "dcos_commons_tpu." not in source.split("# -- remote")[0]
    module = types.ModuleType("port_storage_cases")
    module.__file__ = os.path.join(HERE, "test_storage.py")
    exec(compile(source, module.__file__, "exec"), module.__dict__)
    return module


PORT_CASES = _port_cases()
CASES = sorted(
    name for name in vars(PORT_CASES)
    if name.startswith("test_") and "remote" not in name
    and "scheduler" not in name
)


def test_every_local_case_is_run():
    assert len(CASES) == 11, CASES


@pytest.mark.parametrize("name", CASES)
def test_storage_case_on_the_port(name, tmp_path):
    fn = getattr(PORT_CASES, name)
    if fn.__code__.co_argcount:
        fn(tmp_path)
    else:
        fn()


def test_torn_tail_keeps_committed_records(tmp_path):
    """Garbage appended to wal.log (a crash mid-append): every record
    committed before it reads back, and the log takes new appends."""
    p = FileWalPersister(str(tmp_path), fsync=False)
    for i in range(5):
        p.set(f"/committed/{i}", f"v{i}".encode())
    p.close()
    with open(os.path.join(str(tmp_path), "wal.log"), "ab") as f:
        f.write(b"\x00\x00\x10\x00garbage-tail\xde\xad")
    p = FileWalPersister(str(tmp_path), fsync=False)
    assert [p.get(f"/committed/{i}") for i in range(5)] == [
        f"v{i}".encode() for i in range(5)]
    p.set("/after", b"ok")
    p.close()
    p = FileWalPersister(str(tmp_path), fsync=False)
    assert p.get("/after") == b"ok"
    p.close()


JAX = types.SimpleNamespace(persister=JFileWalPersister, state=j_state,
                            ledger=j_ledger, common=j_common)
PORT = types.SimpleNamespace(persister=FileWalPersister, state=t_state,
                             ledger=t_ledger, common=t_common)


def _write(pkg, directory):
    """Tasks, a status, a goal override, properties and reservations
    (one a gang's coordinator port), through ``pkg``'s own classes.
    Returns what was written, as plain data."""
    p = pkg.persister(directory, fsync=False)
    store = pkg.state.StateStore(p)
    ledger = pkg.ledger.ReservationLedger(p)
    infos = [
        pkg.common.TaskInfo(
            name=f"trainer-{i}-worker", task_id=f"trainer-{i}-worker__id{i}",
            agent_id=f"fabric-0-n{i}", pod_type="trainer", pod_index=i,
            command="python train_worker.py",
            env={"TPU_WORKER_ID": str(i), "CUDA_VISIBLE_DEVICES": "0,1,2,3"},
            resource_ids=[f"r{i}"],
            tpu_chip_ids=[f"fabric-0-n{i}/{k}" for k in range(4)],
            labels={"target_configuration": "cfg-1"},
        )
        for i in range(2)
    ]
    store.store_tasks(infos)
    store.store_status("trainer-0-worker", pkg.common.TaskStatus(
        task_id=infos[0].task_id, state=pkg.common.TaskState.RUNNING,
        message="up"))
    store.store_goal_override("trainer-1-worker",
                              pkg.state.GoalStateOverride.PAUSED,
                              pkg.state.OverrideProgress.PENDING)
    store.store_property("last-completed-update-type", b"DEPLOY")
    reservations = [
        pkg.ledger.Reservation(
            reservation_id=f"r{i}", host_id=f"fabric-0-n{i}",
            task_name=f"trainer-{i}-worker", role="jax-trainer", cpus=4.0,
            memory_mb=8192, disk_mb=0,
            chip_ids=[f"fabric-0-n{i}/{k}" for k in range(4)],
            ports=[10001 + i], volumes={"/data": f"vol{i}"})
        for i in range(2)
    ] + [pkg.ledger.Reservation(
        reservation_id="coord", host_id="fabric-0-n0",
        task_name="trainer-0-worker", ports=[10000],
        container_path="coordinator")]
    ledger.commit(reservations)
    ledger.release("r1")
    p.close()
    return _read(pkg, directory)


def _read(pkg, directory):
    p = pkg.persister(directory, fsync=False)
    store = pkg.state.StateStore(p)
    ledger = pkg.ledger.ReservationLedger(p)
    status = store.fetch_status("trainer-0-worker")
    override, progress = store.fetch_goal_override("trainer-1-worker")
    out = dict(
        tasks=sorted((t.to_dict() for t in store.fetch_tasks()),
                     key=lambda d: d["name"]),
        status=(status.task_id, status.state.value, status.message),
        override=(override.value, progress.value),
        prop=store.fetch_property("last-completed-update-type"),
        reservations=sorted((r.to_dict() for r in ledger.all()),
                            key=lambda d: d["reservation_id"]),
        on_host=sorted(r.reservation_id
                       for r in ledger.reserved_on("fabric-0-n0")),
        for_task=sorted(r.reservation_id
                        for r in ledger.for_task("trainer-0-worker")),
    )
    p.close()
    return out


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax-to-port", "port-to-jax"])
def test_wal_directory_crosses_between_packages(writer, reader, tmp_path):
    written = _write(writer, str(tmp_path))
    assert written["on_host"] == ["coord", "r0"]
    assert [t["name"] for t in written["tasks"]] == [
        "trainer-0-worker", "trainer-1-worker"]
    assert _read(reader, str(tmp_path)) == written
    # the reader's commits append to the same log, and the writer reads
    # them back
    p = reader.persister(str(tmp_path), fsync=False)
    reader.ledger.ReservationLedger(p).release("coord")
    p.close()
    after = _read(writer, str(tmp_path))
    assert [r["reservation_id"] for r in after["reservations"]] == ["r0"]


def test_wal_bytes_are_the_same(tmp_path):
    """The same operations give the same wal.log and snapshot bytes in
    both packages."""
    blobs = []
    for pkg, sub in ((JAX, "jax"), (PORT, "port")):
        d = str(tmp_path / sub)
        p = pkg.persister(d, fsync=False, compact_every=3)
        for i in range(5):
            p.set(f"/k/{i}", bytes([i]) * 3)
        p.recursive_delete("/k/1")
        p.close()
        blobs.append({name: open(os.path.join(d, name), "rb").read()
                      for name in sorted(os.listdir(d))})
    assert blobs[0] == blobs[1]
    assert "wal.log" in blobs[0]

"""The port's state server and its replication (``storage/remote.py``,
``storage/replication.py``) against the JAX package's, on the CPU.

Each case is a scenario of ``tests/test_ha_state.py`` written once and
run on twin objects: the JAX package's ``StateServer``,
``RemotePersister``, ``RemoteLocker``, ``ReplicationLog`` and
``StandbyTail``, then the port's.  A scenario returns what it observed
(return values, roles, epochs, sequence numbers, refusals, trees), and
the two packages' observations must be equal.  Trees are compared with
``dump_tree``, across packages too.  Cross-package cases put a port
client on a JAX server and the reverse, and a port standby on a JAX
primary, so the wire is shown to be the same.  The process cases spawn
``state-server`` and ``serve`` of each package, every one with a
deadline, and reap them in a ``finally``."""

import importlib
import json
import os
import threading
import time
import types
import urllib.request

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def package(root):
    """The modules a scenario needs, from one package."""
    remote = importlib.import_module(f"{root}.storage.remote")
    replication = importlib.import_module(f"{root}.storage.replication")
    persister = importlib.import_module(f"{root}.storage.persister")
    files = importlib.import_module(f"{root}.storage.file_persister")
    return types.SimpleNamespace(
        root=root, remote=remote, replication=replication,
        StateServer=remote.StateServer,
        RemotePersister=remote.RemotePersister,
        RemoteLocker=remote.RemoteLocker,
        ReplicationLog=replication.ReplicationLog,
        StandbyTail=replication.StandbyTail,
        dump_tree=replication.dump_tree,
        Mem=persister.MemPersister, SetOp=persister.SetOp,
        PersisterError=persister.PersisterError,
        Wal=files.FileWalPersister,
    )


JAX = package("dcos_commons_tpu")
PORT = package("dcos_commons_tpu_torch")


def twin(scenario, *args):
    """Run ``scenario`` on both packages; their observations must be
    equal.  Returns the port's."""
    want = scenario(JAX, *args)
    got = scenario(PORT, *args)
    assert got == want
    return got


def wait_until(check, timeout_s=10.0, interval_s=0.05, what="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if check():
            return
        time.sleep(interval_s)
    raise AssertionError(f"timed out waiting for {what}")


def user_tree(P, persister):
    """``dump_tree`` (values base64) minus the server-internal
    /__cluster__ namespace."""
    return [(path, value) for path, value in P.dump_tree(persister)
            if not path.startswith("/__cluster__")]


def refusal(P, call):
    """The message of the ``PersisterError`` that ``call`` raises."""
    try:
        call()
    except P.PersisterError as e:
        return str(e)
    raise AssertionError("no PersisterError")


def status_view(status):
    """The deterministic part of a ``/v1/repl/status`` body: its keys,
    role, epoch and sequence numbers (stream ids and urls differ by
    run)."""
    return {
        "keys": sorted(status),
        "role": status["role"],
        "epoch": status["epoch"],
        "seq": status.get("seq"),
        "standby_count": status.get("standby_count"),
    }


def stop_all(*servers):
    for server in servers:
        if server is not None:
            try:
                server.stop()
            except OSError:
                pass


# -- in-process replication semantics ---------------------------------


def scenario_replicate_and_promote(P):
    out = []
    primary = P.StateServer(P.Mem()).start()
    standby = None
    try:
        client = P.RemotePersister(primary.url)
        client.set("/svc/a", b"1")
        client.apply([P.SetOp("/svc/b", b"2"), P.SetOp("/svc/c/d", b"3")])
        standby = P.StateServer(P.Mem(), replicate_from=primary.url).start()
        wait_until(lambda: user_tree(P, standby._backend)
                   == user_tree(P, primary._backend),
                   what="snapshot bootstrap")
        out.append(user_tree(P, standby._backend))
        client.set("/svc/e", b"4")
        client.recursive_delete("/svc/a")
        wait_until(lambda: user_tree(P, standby._backend)
                   == user_tree(P, primary._backend), what="live tail")
        out.append(user_tree(P, standby._backend))
        promoted = P.RemotePersister(standby.url)
        out.append(promoted._call("/v1/repl/promote", {})["epoch"])
        out.append([promoted.get("/svc/e"), promoted.get_or_none("/svc/a"),
                    promoted.get("/svc/c/d")])
        out.append(status_view(promoted._call("/v1/repl/status", {})))
        out.append(user_tree(P, standby._backend))
    finally:
        stop_all(standby, primary)
    return out


def test_standby_replicates_and_promote_serves_identical_tree():
    out = twin(scenario_replicate_and_promote)
    assert out[2] == 2
    assert out[3] == [b"4", None, b"3"]
    assert out[4]["role"] == "primary"


def scenario_standby_rejects_kv(P):
    primary = P.StateServer(P.Mem()).start()
    standby = P.StateServer(P.Mem(), replicate_from=primary.url).start()
    try:
        refused = refusal(
            P, lambda: P.RemotePersister(standby.url).set("/x", b"1"))
        multi = P.RemotePersister(f"{standby.url},{primary.url}")
        multi.set("/x", b"1")
        return ["not primary" in refused, multi.get("/x")]
    finally:
        stop_all(standby, primary)


def test_standby_rejects_kv_and_clients_rotate():
    assert twin(scenario_standby_rejects_kv) == [True, b"1"]


def scenario_bounded_sync(P):
    out = []
    log = P.ReplicationLog(sync_timeout_s=0.2)

    def timed_wait(seq):
        t0 = time.monotonic()
        replicated = log.wait_replicated(seq)
        took = time.monotonic() - t0
        return replicated, ("quick" if took < 0.1 else
                            "timeout" if 0.15 <= took < 1.0 else took)

    seq = log.append([{"op": "set", "path": "/a", "value": ""}])
    out.append(timed_wait(seq))
    pulled = log.pull(from_seq=1, wait_s=0)
    out.append([e["seq"] for e in pulled["entries"]])
    out.append(log.status()["standby_lagging"])
    seq2 = log.append([{"op": "set", "path": "/b", "value": ""}])
    out.append(timed_wait(seq2))
    log.pull(from_seq=seq2 + 1, wait_s=0)
    out.append(log.status()["standby_lagging"])
    seq3 = log.append([{"op": "set", "path": "/c", "value": ""}])
    out.append(timed_wait(seq3))
    out.append(log.status()["standby_lagging"])
    seq4 = log.append([{"op": "set", "path": "/d", "value": ""}])
    out.append(timed_wait(seq4))
    log.pull(from_seq=seq4 + 1, wait_s=0)
    out.append(log.status()["standby_lagging"])
    seq5 = log.append([{"op": "set", "path": "/e", "value": ""}])
    threading.Timer(0.05, lambda: log.pull(seq5 + 1, 0)).start()
    out.append(log.wait_replicated(seq5))
    out.append(sorted(log.status()))
    return out


def test_bounded_sync_log_semantics():
    out = twin(scenario_bounded_sync)
    assert out[:10] == [
        (False, "quick"), [1], True, (False, "quick"), False,
        (False, "timeout"), True, (False, "quick"), False, True]


def scenario_ring_trim(P):
    log = P.ReplicationLog(max_entries=4)
    for i in range(10):
        log.append([{"op": "set", "path": f"/k{i}", "value": ""}])
    fresh = P.ReplicationLog()
    return [
        log.pull(from_seq=2, wait_s=0).get("snapshot_needed"),
        [e["seq"] for e in log.pull(from_seq=8, wait_s=0)["entries"]],
        fresh.pull(from_seq=501, wait_s=0).get("snapshot_needed"),
    ]


def test_ring_trim_and_fresh_primary_force_resnapshot():
    assert twin(scenario_ring_trim) == [True, [8, 9, 10], True]


def scenario_overshooting_pull(P):
    log = P.ReplicationLog(sync_timeout_s=0.2)
    out = [log.pull(from_seq=106, wait_s=0).get("snapshot_needed"),
           log.status()["acked_seq"]]
    seq = log.append([{"op": "set", "path": "/a", "value": ""}])
    out += [log.wait_replicated(seq), log.status()["standby_lagging"]]
    return out


def test_overshooting_pull_never_inflates_ack_watermark():
    assert twin(scenario_overshooting_pull) == [True, 0, False, True]


def scenario_promote_refusals(P):
    out = []
    primary = P.StateServer(P.Mem()).start()
    try:
        P.RemotePersister(primary.url).set("/a", b"v1")
        dead = P.StateServer(
            P.Mem(), replicate_from="http://127.0.0.1:9").start()
        try:
            client = P.RemotePersister(dead.url)
            out.append("never replicated" in refusal(
                P, lambda: client._call("/v1/repl/promote", {})))
            out.append(client._call("/v1/repl/promote",
                                    {"epoch": 7})["epoch"])
        finally:
            dead.stop()
        primary.check_fence(9)
        out.append(primary._role)
        out.append("only promote a standby" in refusal(P, primary.promote))
    finally:
        primary.stop()
    return out


def test_promote_refuses_never_synced_standby_and_fenced_server():
    assert twin(scenario_promote_refusals) == [True, 7, "fenced", True]


def scenario_stale_primary_fences(P):
    out = []
    primary = P.StateServer(P.Mem()).start()
    standby = P.StateServer(P.Mem(), replicate_from=primary.url).start()
    try:
        P.RemotePersister(primary.url).set("/a", b"v1")
        wait_until(lambda: user_tree(P, standby._backend)
                   == user_tree(P, primary._backend), what="replication")
        P.RemotePersister(standby.url)._call("/v1/repl/promote", {})
        client = P.RemotePersister(f"{standby.url},{primary.url}")
        out.append(client.get("/a"))
        standby.stop()
        refusal(P, lambda: client.set("/a", b"v2"))
        out.append(primary._role)
        out.append("not primary" in refusal(
            P, lambda: P.RemotePersister(primary.url).set("/a", b"v3")))
    finally:
        primary.stop()
    return out


def test_stale_primary_fences_itself_on_rotation():
    assert twin(scenario_stale_primary_fences) == [b"v1", "fenced", True]


def scenario_fenced_restart(P, tmp_path):
    data = str(tmp_path / P.root)
    server = P.StateServer(P.Wal(data)).start()
    P.RemotePersister(server.url).set("/a", b"v1")
    server.check_fence(5)
    out = [server._role]
    server.stop()
    reborn = P.StateServer(P.Wal(data)).start()
    try:
        out.append(reborn._role)
        out.append("not primary" in refusal(
            P, lambda: P.RemotePersister(reborn.url).set("/a", b"v2")))
        out.append(P.dump_tree(reborn._backend))
    finally:
        reborn.stop()
    return out


def test_fenced_primary_stays_fenced_across_restart(tmp_path):
    out = twin(scenario_fenced_restart, tmp_path)
    assert out[:3] == ["fenced", "fenced", True]


def scenario_divergence_repair(P):
    primary = P.StateServer(P.Mem()).start()
    standby = P.StateServer(P.Mem(), replicate_from=primary.url).start()
    try:
        client = P.RemotePersister(primary.url)
        client.set("/svc/x", b"1")
        client.set("/svc/y", b"2")
        wait_until(lambda: standby._backend.get_or_none("/svc/y") == b"2",
                   what="initial replication")
        standby._backend.recursive_delete("/svc/x")
        client.recursive_delete("/svc/x")
        client.set("/svc/z", b"3")
        wait_until(lambda: user_tree(P, standby._backend)
                   == user_tree(P, primary._backend), timeout_s=15.0,
                   what="snapshot repair")
        return user_tree(P, standby._backend)
    finally:
        stop_all(standby, primary)


def test_divergence_triggers_snapshot_repair():
    assert twin(scenario_divergence_repair) == [
        ("/svc", None), ("/svc/y", "Mg=="), ("/svc/z", "Mw==")]


def scenario_lease_failover(P):
    primary = P.StateServer(P.Mem()).start()
    standby = P.StateServer(P.Mem(), replicate_from=primary.url).start()
    lost = []
    locker = P.RemoteLocker(f"{primary.url},{standby.url}", name="svc",
                            owner="sched-a", ttl_s=3.0)
    locker.on_lost = lost.append
    try:
        out = [locker.acquire()]
        wait_until(lambda: standby._backend.exists("/__cluster__/leases/svc"),
                   what="lease replication")
        primary.stop()
        P.RemotePersister(standby.url)._call("/v1/repl/promote", {})
        time.sleep(2.5)
        out.append(lost)
        rival = P.RemoteLocker(f"{primary.url},{standby.url}", name="svc",
                               owner="sched-b", ttl_s=3.0)
        out.append(rival.acquire())
        return out
    finally:
        locker.release()
        standby.stop()


def test_lease_survives_failover():
    assert twin(scenario_lease_failover) == [True, [], False]


def scenario_standby_restart(P, tmp_path):
    root = tmp_path / P.root
    primary = P.StateServer(P.Wal(str(root / "primary"))).start()
    try:
        client = P.RemotePersister(primary.url)
        client.set("/svc/a", b"1")
        standby = P.StateServer(P.Wal(str(root / "standby")),
                                replicate_from=primary.url).start()
        wait_until(lambda: standby._backend.get_or_none("/svc/a") == b"1",
                   what="first replication")
        applied = standby._tail.applied_seq
        standby.stop()
        client.set("/svc/b", b"2")
        again = P.StateServer(P.Wal(str(root / "standby")),
                              replicate_from=primary.url).start()
        try:
            out = [applied, again._tail.applied_seq]
            wait_until(lambda: again._backend.get_or_none("/svc/b") == b"2",
                       what="catch-up after restart")
            out.append(user_tree(P, again._backend))
            return out
        finally:
            again.stop()
    finally:
        primary.stop()


def test_standby_restart_resumes_from_persisted_seq(tmp_path):
    out = twin(scenario_standby_restart, tmp_path)
    assert out[0] == out[1] >= 1


def scenario_per_puller_watermarks(P):
    out = []
    log = P.ReplicationLog(sync_timeout_s=0.2)
    window = P.replication.ATTACH_WINDOW_S

    def standby(name):
        return log.status()["standbys"][name]

    log.append([{"op": "set", "path": "/a", "value": ""}])
    for name in ("standby-a", "standby-b"):
        pulled = log.pull(from_seq=1, wait_s=0, puller_id=name)
        out.append([e["seq"] for e in pulled["entries"]])
    out.append(log.status()["standby_count"])
    out.append([standby("standby-a")["lagging"],
                standby("standby-b")["lagging"]])
    log.pull(from_seq=2, wait_s=0, puller_id="standby-a")
    out.append([log.status()["acked_seq"], standby("standby-a")["acked"],
                standby("standby-a")["lagging"]])
    log.pull(from_seq=2, wait_s=0, puller_id="standby-b")
    out.append(standby("standby-b")["lagging"])
    seq = log.append([{"op": "set", "path": "/b", "value": ""}])
    log.pull(from_seq=seq + 1, wait_s=0, puller_id="standby-a")
    out.append([log.wait_replicated(seq), standby("standby-a")["lagging"],
                standby("standby-b")["lagging"]])
    seq2 = log.append([{"op": "set", "path": "/c", "value": ""}])
    log.pull(from_seq=seq2 + 1, wait_s=0, puller_id="standby-a")
    out.append(log.wait_replicated(seq2))
    log.pull(from_seq=seq2 + 1, wait_s=0, puller_id="standby-b")
    out.append([standby("standby-b")["lagging"], log.status()["acked_seq"]])
    log.pull(from_seq=1, wait_s=0, puller_id="standby-a")
    out.append([standby("standby-a")["acked"],
                standby("standby-a")["lagging"]])
    log._pullers["standby-a"]["last_pull"] -= window + 1.0
    out.append(log.status()["standby_count"])
    log.pull(from_seq=1, wait_s=0, puller_id="standby-a")
    out.append([standby("standby-a")["acked"],
                standby("standby-a")["lagging"]])
    return out


def test_per_puller_watermarks_never_cross():
    assert twin(scenario_per_puller_watermarks) == [
        [1], [1], 2, [True, True], [0, 1, False], False,
        [False, False, True], True, [False, 3], [0, True], 1, [0, True]]


def scenario_two_standbys(P):
    primary = P.StateServer(P.Mem()).start()
    first = P.StateServer(P.Mem(), replicate_from=primary.url).start()
    second = P.StateServer(P.Mem(), replicate_from=primary.url).start()
    try:
        client = P.RemotePersister(primary.url)
        client.set("/svc/a", b"1")
        for standby in (first, second):
            wait_until(lambda s=standby: user_tree(P, s._backend)
                       == user_tree(P, primary._backend),
                       what="both standbys bootstrap")
        out = [client._call("/v1/repl/status", {})["standby_count"]]
        client.set("/svc/b", b"2")
        for standby in (first, second):
            wait_until(lambda s=standby: s._backend.get_or_none("/svc/b")
                       == b"2", what="both standbys stream")
        promoted = P.RemotePersister(second.url)
        out.append(promoted._call("/v1/repl/promote", {})["epoch"])
        out.append([promoted.get("/svc/a"), promoted.get("/svc/b")])
        out.append(user_tree(P, first._backend))
        return out
    finally:
        stop_all(second, first, primary)


def test_two_live_standbys_both_replicate_and_either_promotes():
    out = twin(scenario_two_standbys)
    assert out[:3] == [2, 2, [b"1", b"2"]]


def scenario_ex_primary_rejoins(P, tmp_path):
    out = []
    b_dir = str(tmp_path / P.root / "b")
    a = P.StateServer(P.Mem()).start()
    try:
        P.RemotePersister(a.url).set("/svc/a", b"1")
        b = P.StateServer(P.Wal(b_dir), replicate_from=a.url).start()
        # the tail applies an entry, then records its seq: wait for both
        wait_until(lambda: b._backend.get_or_none("/svc/a") == b"1"
                   and b._backend.exists(P.StandbyTail.APPLIED_NODE),
                   what="standby sync")
        out.append(b._backend.exists(P.StandbyTail.APPLIED_NODE))
        P.RemotePersister(b.url)._call("/v1/repl/promote", {})
        out.append(b._backend.get_or_none(P.StandbyTail.APPLIED_NODE))
        P.RemotePersister(b.url).set("/svc/divergent", b"x")
        b.check_fence(9)
        b.stop()
    finally:
        a.stop()
    c = P.StateServer(P.Mem()).start()
    try:
        client = P.RemotePersister(c.url)
        client.set("/svc/a", b"1")
        client.set("/svc/c", b"3")
        b2 = P.StateServer(P.Wal(b_dir), replicate_from=c.url).start()
        try:
            wait_until(lambda: user_tree(P, b2._backend)
                       == user_tree(P, c._backend),
                       what="full-snapshot rejoin")
            out.append(user_tree(P, b2._backend))
        finally:
            b2.stop()
    finally:
        c.stop()
    return out


def test_ex_primary_rejoins_via_full_snapshot(tmp_path):
    out = twin(scenario_ex_primary_rejoins, tmp_path)
    assert out == [True, None,
                   [("/svc", None), ("/svc/a", "MQ=="), ("/svc/c", "Mw==")]]


def scenario_pull_requires_id(P):
    primary = P.StateServer(P.Mem()).start()
    try:
        return "standby_id" in refusal(
            P, lambda: P.RemotePersister(primary.url)._call(
                "/v1/repl/pull", {"from_seq": 1, "wait_s": 0}))
    finally:
        primary.stop()


def test_pull_route_requires_standby_id():
    assert twin(scenario_pull_requires_id) is True


def scenario_tail_distrusts_fenced_tree(P, tmp_path):
    backend = P.Wal(str(tmp_path / P.root / "tree"))
    backend.set(P.StandbyTail.APPLIED_NODE, b"17")
    backend.set(P.remote.FENCED_NODE, b"9")
    tail = P.StandbyTail(backend, threading.Lock(), "http://127.0.0.1:9")
    return tail.applied_seq


def test_standby_tail_distrusts_applied_seq_on_fenced_tree(tmp_path):
    assert twin(scenario_tail_distrusts_fenced_tree, tmp_path) == 0


def scenario_stream_mismatch(P):
    log = P.ReplicationLog(sync_timeout_s=0.2)
    for i in range(3):
        log.append([{"op": "set", "path": f"/k{i}", "value": ""}])
    out = [log.pull(from_seq=3, wait_s=0, puller_id="s",
                    stream_id="other-ring").get("snapshot_needed"),
           log.status()["acked_seq"]]
    seq = log.append([{"op": "set", "path": "/k3", "value": ""}])
    out.append(log.wait_replicated(seq))
    pulled = log.pull(from_seq=3, wait_s=0, puller_id="s",
                      stream_id=log.stream_id)
    out += ["entries" in pulled, log.status()["acked_seq"]]
    return out


def test_primary_refuses_ack_on_stream_mismatch():
    assert twin(scenario_stream_mismatch) == [True, 0, False, True, 2]


def scenario_repl_status_verb(P, capsys):
    out = []
    primary = P.StateServer(P.Mem()).start()
    standby = P.StateServer(P.Mem(), replicate_from=primary.url).start()
    try:
        P.RemotePersister(primary.url).set("/k", b"v")
        wait_until(lambda: P.RemotePersister(primary.url)._call(
            "/v1/repl/status", {})["standby_attached"],
            what="standby attach")
        out.append(P.remote.main(["--repl-status", primary.url]))
        status = json.loads(capsys.readouterr().out)
        out.append([status_view(status), len(status["standbys"])])
    finally:
        stop_all(standby, primary)
    out.append(P.remote.main(["--repl-status", primary.url]))
    out.append("repl-status failed" in capsys.readouterr().err)
    out.append(P.remote.main(["--repl-status", "host:1234"]))
    out.append("repl-status failed" in capsys.readouterr().err)
    return out


def test_repl_status_cli_verb(capsys):
    out = twin(scenario_repl_status_verb, capsys)
    assert out[0] == 0 and out[2:] == [1, True, 1, True]
    assert out[1][0]["role"] == "primary" and out[1][1] == 1


# -- the wire across packages -----------------------------------------


def write_tree(P, client):
    """The same writes through any package's client."""
    client.set("/svc/a", b"1")
    client.apply([P.SetOp("/svc/b", b"2"), P.SetOp("/svc/c/d", b"3")])
    client.set("/svc/e", b"\x00\xffbinary")
    client.recursive_delete("/svc/c")
    return [client.get("/svc/a"), client.get_or_none("/svc/c/d"),
            client.get_children("/svc"), client.get("/svc/e")]


@pytest.mark.parametrize("server_pkg,client_pkg",
                         [("jax", "port"), ("port", "jax")])
def test_remote_persister_crosses_packages(server_pkg, client_pkg):
    """A port ``RemotePersister`` over a JAX ``StateServer``, and the
    reverse, read and write the same tree as a client of the server's
    own package; the leases cross too."""
    pkgs = {"jax": JAX, "port": PORT}
    S, C = pkgs[server_pkg], pkgs[client_pkg]
    trees = []
    for client_of in (S, C):
        server = S.StateServer(S.Mem()).start()
        try:
            reads = write_tree(client_of,
                               client_of.RemotePersister(server.url))
            locker = client_of.RemoteLocker(server.url, name="svc",
                                            owner="a", ttl_s=5.0)
            rival = client_of.RemoteLocker(server.url, name="svc",
                                           owner="b", ttl_s=5.0)
            leases = [locker.acquire(), rival.acquire()]
            locker.release()
            leases.append(rival.acquire())
            rival.release()
            trees.append((reads, leases, user_tree(S, server._backend)))
        finally:
            server.stop()
    assert trees[1] == trees[0]
    assert trees[0][1] == [True, False, True]


@pytest.mark.parametrize("primary_pkg,standby_pkg",
                         [("jax", "port"), ("port", "jax")])
def test_standby_tails_a_primary_of_the_other_package(primary_pkg,
                                                      standby_pkg):
    """Replication is one protocol: a port standby bootstraps from and
    tails a JAX primary (and the reverse), is promoted, and serves a
    tree equal, by ``dump_tree`` of either package, to the primary's."""
    pkgs = {"jax": JAX, "port": PORT}
    A, B = pkgs[primary_pkg], pkgs[standby_pkg]
    primary = A.StateServer(A.Mem()).start()
    standby = None
    try:
        client = A.RemotePersister(primary.url)
        client.set("/svc/pre", b"0")
        standby = B.StateServer(B.Mem(), replicate_from=primary.url).start()
        client.set("/svc/live", b"1")
        client.recursive_delete("/svc/pre")
        wait_until(lambda: user_tree(B, standby._backend)
                   == user_tree(A, primary._backend), what="cross tail")
        assert user_tree(A, standby._backend) == user_tree(
            B, primary._backend) == [("/svc", None), ("/svc/live", "MQ==")]
        out = B.RemotePersister(standby.url)._call("/v1/repl/promote", {})
        assert out["epoch"] == 2
        assert B.RemotePersister(standby.url).get("/svc/live") == b"1"
    finally:
        stop_all(standby, primary)


# -- process-level failover -------------------------------------------


def spawn_state_server(P, workdir, standby_of=""):
    integration = importlib.import_module(f"{P.root}.testing.integration")
    return integration.start_state_server(workdir, REPO,
                                          standby_of=standby_of)


def reap(*entries):
    for proc, log in entries:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        if log is not None:
            log.close()


def scenario_promote_verb(P, tmp_path):
    integration = importlib.import_module(f"{P.root}.testing.integration")
    root = tmp_path / P.root
    a = b = (None, None)
    try:
        proc_a, url_a, log_a = spawn_state_server(P, str(root / "state-a"))
        a = (proc_a, log_a)
        proc_b, url_b, log_b = spawn_state_server(
            P, str(root / "state-b"), standby_of=url_a)
        b = (proc_b, log_b)
        P.RemotePersister(url_a).set("/k", b"v")
        wait_until(lambda: P.RemotePersister(url_b)._call(
            "/v1/repl/status", {})["applied_seq"] >= 1, what="replication")
        proc_a.kill()
        proc_a.wait(timeout=10)
        integration.promote_state_server(url_b, fence_old=url_a,
                                         repo_root=REPO)
        promoted = P.RemotePersister(url_b)
        out = [promoted.get("/k")]
        promoted.set("/k2", b"v2")
        out.append(status_view(promoted._call("/v1/repl/status", {})))
        return out
    finally:
        reap(a, b)


def test_promote_cli_verb(tmp_path):
    """``state-server --promote URL --fence-old URL`` of each package
    promotes its standby over a dead primary."""
    out = twin(scenario_promote_verb, tmp_path)
    assert out[0] == b"v"
    assert out[1]["role"] == "primary" and out[1]["epoch"] >= 2


HA_SVC_YAML = """
name: hasvc
pods:
  app:
    count: 3
    placement: 'max-per-host:1'
    tasks:
      server:
        goal: RUNNING
        cmd: "echo serving > out.txt && sleep 180"
        cpus: 0.1
        memory: 32
"""


def _post(url, route, body=None):
    req = urllib.request.Request(
        url + route, data=json.dumps(body or {}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=10) as resp:
        return json.loads(resp.read())


def scenario_failover_mid_deploy(P, tmp_path):
    """Agent daemons, a primary and a standby state server and a
    ``serve`` on ``--state-url primary,standby``, all processes of one
    package: the primary is SIGKILLed while the deploy plan is
    interrupted, the standby promoted, and the same ``serve`` finishes
    the plan."""
    integration = importlib.import_module(f"{P.root}.testing.integration")
    root = tmp_path / P.root
    root.mkdir()
    agents = [integration.AgentProcess(f"h{i}", str(root / f"agent-{i}"),
                                       REPO) for i in range(3)]
    a = b = (None, None)
    sched = None
    out = {}
    try:
        (root / "svc.yml").write_text(HA_SVC_YAML)
        lines = ["hosts:"]
        for agent in agents:
            lines += [f"  - host_id: {agent.host_id}",
                      f"    agent_url: {agent.url}",
                      "    cpus: 4.0", "    memory_mb: 8192"]
        (root / "topology.yml").write_text("\n".join(lines) + "\n")
        proc_a, url_a, log_a = spawn_state_server(P, str(root / "state-a"))
        a = (proc_a, log_a)
        proc_b, url_b, log_b = spawn_state_server(
            P, str(root / "state-b"), standby_of=url_a)
        b = (proc_b, log_b)
        sched = integration.SchedulerProcess(
            str(root / "svc.yml"), str(root / "topology.yml"),
            str(root / "sched"),
            env={"ENABLE_BACKOFF": "false", "STATE_LEASE_TTL_S": "10"},
            repo_root=REPO, extra_args=["--state-url", f"{url_a},{url_b}"])
        client = sched.client()
        client.wait_for_task_state("app-0-server", "TASK_RUNNING",
                                   timeout_s=60)
        client.post("/v1/plans/deploy/interrupt")
        out["interrupted"] = client.plan_status("deploy") != "COMPLETE"
        proc_a.kill()
        proc_a.wait(timeout=10)
        out["promoted epoch"] = _post(url_b, "/v1/repl/promote")["epoch"]
        client.post("/v1/plans/deploy/continue")
        out["deploy"] = client.wait_for_completed_deployment(
            timeout_s=120)["status"]
        out["same serve"] = sched.process.poll() is None
        status = _post(url_b, "/v1/repl/status")
        out["status"] = [status["role"], status["epoch"] >= 2]
        out["tasks"] = sorted(client.task_ids())
        out["hosts"] = sorted(client.get(f"/v1/pod/app-{i}/info")[0][
            "agent_id"] for i in range(3))
    finally:
        if sched is not None:
            sched.terminate()
        integration.reap_orphan_tasks(agents)
        for agent in agents:
            agent.stop()
        reap(a, b)
    return out


def test_primary_death_mid_deploy_promote_plan_completes(tmp_path):
    out = twin(scenario_failover_mid_deploy, tmp_path)
    assert out == {
        "interrupted": True, "promoted epoch": 2, "deploy": "COMPLETE",
        "same serve": True, "status": ["primary", True],
        "tasks": ["app-0-server", "app-1-server", "app-2-server"],
        "hosts": ["h0", "h1", "h2"],
    }

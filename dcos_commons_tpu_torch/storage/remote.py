"""Networked persistence: a state server + remote Persister client.

Reference: curator/CuratorPersister.java:43-110 — the reference keeps
ALL scheduler state in ZooKeeper with atomic multi-op transactions so
a scheduler process is disposable: kill it anywhere, restart it
anywhere, and plans resume mid-step.  CuratorLocker (taken in
SchedulerRunner.run) guarantees one active scheduler per service.

This module is that pair for the GPU fleet, ZooKeeper replaced by a
small HTTP state server (one per cluster / control-plane host):

* ``StateServer`` — hierarchical KV over any local Persister
  (FileWalPersister for durability), every mutation under one lock so
  ``apply`` batches stay atomic, plus TTL leases for the scheduler
  instance lock.
* ``RemotePersister`` — the Persister contract over HTTP; network or
  server failures surface as PersisterError, which fails the scheduler
  cycle and (after the crash-to-restart threshold) the process —
  exactly how the reference treats a ZK outage.
* ``RemoteLocker`` — acquire/renew/release of a named TTL lease; the
  renewal thread keeps the lease while the process lives, and a dead
  scheduler's lease expires so a standby can take over (failover).

Protocol (JSON over HTTP):

    POST /v1/kv/get       {path}                -> {found, value?}
    POST /v1/kv/set       {path, value}
    POST /v1/kv/children  {path}                -> {found, children}
    POST /v1/kv/delete    {path}                -> {found}
    POST /v1/kv/apply     {ops: [{op, path, value?}]}   (atomic)
    POST /v1/lock/acquire {name, owner, ttl_s}  -> {acquired, owner}
    POST /v1/lock/release {name, owner}         -> {released}

High availability (see storage/replication.py for the design):

    POST /v1/repl/snapshot {}                   -> {seq, epoch, nodes}
    POST /v1/repl/pull     {from_seq, wait_s}   -> {entries | snapshot_needed}
    POST /v1/repl/promote  {epoch?}             -> {epoch}   (standby -> primary)
    POST /v1/repl/fence    {epoch}              -> {role}    (demote stale primary)
    POST /v1/repl/status   {}                   -> {role, epoch, seq, ...}

Every response carries ``epoch`` and ``role``; every client request
may carry ``_fence`` (the highest epoch the client has seen) — a
primary below that token has been superseded and fences itself.
Standbys answer kv/lock routes with 503 so clients rotate to the
primary.  Values travel base64-encoded.

Port of ``dcos_commons_tpu/storage/remote.py``, line for line but the
imports.
"""

from __future__ import annotations

import base64
import json
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Iterable, List, Optional, Tuple

from dcos_commons_tpu_torch.storage.persister import (
    DeleteOp,
    MemPersister,
    Persister,
    PersisterError,
    SetOp,
    TransactionOp,
)


LEASE_PREFIX = "/__cluster__/leases"
EPOCH_NODE = "/__cluster__/epoch"
# durable fenced marker: a superseded primary must stay fenced across
# process restarts, or a supervisor's auto-restart would resurrect it
# as a primary at the ADOPTED epoch — equal to the new primary's, so
# clients could not tell them apart
FENCED_NODE = "/__cluster__/fenced"

ROLE_PRIMARY = "primary"
ROLE_STANDBY = "standby"
ROLE_FENCED = "fenced"


class NotPrimaryError(PersisterError):
    """Raised on kv/lock routes by a non-primary; maps to HTTP 503 so
    clients rotate servers instead of failing the operation."""


class StateServer:
    """HTTP front end over one local Persister (the cluster's ZK).

    Leases are persisted through the backend (wall-clock expiry), so a
    state-server restart does NOT silently drop the scheduler instance
    lock — the reference's ZK ephemerals survive a ZK follower bounce
    the same way (CuratorLocker over a ZK ensemble)."""

    def __init__(
        self,
        backend: Optional[Persister] = None,
        port: int = 0,
        bind: str = "127.0.0.1",
        auth_token: str = "",
        tls=None,
        advertise_host: str = "",
        replicate_from: str = "",
        ca_file: str = "",
        sync_timeout_s: float = 2.0,
    ):
        from dcos_commons_tpu_torch.security import auth as _auth
        from dcos_commons_tpu_torch.storage.replication import (
            ReplicationLog,
            StandbyTail,
        )

        self._backend = backend or MemPersister()
        self._lock = threading.RLock()
        # lease name -> (owner, wall-clock expiry); mirrored to the
        # backend under LEASE_PREFIX on every mutation
        self._leases: Dict[str, Tuple[str, float]] = self._load_leases()
        self.advertise_host = advertise_host
        self._scheme = _auth.url_scheme(tls)
        # -- HA role + fencing epoch (storage/replication.py) ---------
        self._role = ROLE_STANDBY if replicate_from else ROLE_PRIMARY
        self._epoch = self._load_epoch()
        if self._role == ROLE_PRIMARY and self._backend.exists(FENCED_NODE):
            # a fenced primary restarted by its supervisor must come
            # back FENCED: it adopted the new primary's epoch, so as a
            # primary it would be indistinguishable from the real one.
            # It rejoins by being restarted with --standby-of (the
            # snapshot restore clears the marker).
            self._role = ROLE_FENCED
        self._log = ReplicationLog(sync_timeout_s=sync_timeout_s)
        self._tail: Optional[StandbyTail] = None
        if self._role == ROLE_PRIMARY:
            if self._epoch == 0:
                # fresh cluster: epoch 1 (clients default to fence 0,
                # which never fences anybody)
                self._set_epoch(1)
            # continue the stream where the durable tree left off:
            # a restarted primary has an empty ring, and a standby
            # whose applied seq predates it will be told to snapshot
        else:
            self._tail = StandbyTail(
                self._backend, self._lock, replicate_from,
                auth_token=auth_token, ca_file=ca_file,
                on_epoch=self._adopt_epoch,
            )
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _reply(self, code: int, body: dict) -> None:
                # a copy: the body may be shared (a 401 replies with
                # security/auth.py's module-level UNAUTHORIZED)
                body = dict(body)
                body.setdefault("epoch", server._epoch)
                body.setdefault("role", server._role)
                payload = json.dumps(body).encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def do_POST(self):
                # ALL state routes are mutating or state-revealing:
                # with a token set there is no anonymous surface
                if not _auth.check_bearer(self.headers, auth_token):
                    self._reply(*_auth.UNAUTHORIZED)
                    return
                length = int(self.headers.get("Content-Length", 0))
                try:
                    body = json.loads(self.rfile.read(length) or b"{}")
                    server.check_fence(int(body.get("_fence", 0) or 0))
                    if self.path.startswith("/v1/repl/"):
                        # replication routes manage their own locking
                        # (pull long-polls must not hold the kv lock)
                        self._reply(200, server.handle_repl(
                            self.path, body
                        ))
                        return
                    if server._role != ROLE_PRIMARY:
                        # kv/lock surface exists only on the primary;
                        # 503 tells the client to rotate servers
                        self._reply(503, {
                            "error": f"not primary ({server._role})",
                        })
                        return
                    out = server.handle(self.path, body)
                    seq = out.pop("_sync_seq", None)
                    if seq is not None:
                        # bounded-sync barrier OUTSIDE the kv lock: an
                        # attached, caught-up standby must have pulled
                        # this mutation before the client is acked
                        server._log.wait_replicated(seq)
                    self._reply(200, out)
                except NotPrimaryError as e:
                    self._reply(503, {"error": str(e)})
                except PersisterError as e:
                    self._reply(409, {"error": str(e), "path": e.path})
                except Exception as e:
                    self._reply(500, {"error": repr(e)})

        self._server = _auth.wrap_http_server(
            ThreadingHTTPServer((bind, port), Handler), tls
        )
        self._thread: Optional[threading.Thread] = None

    # -- epoch / fencing ----------------------------------------------

    def _load_epoch(self) -> int:
        raw = self._backend.get_or_none(EPOCH_NODE)
        try:
            return int((raw or b"0").decode())
        except ValueError:
            return 0

    def _set_epoch(self, epoch: int) -> None:
        with self._lock:
            self._epoch = epoch
            self._backend.set(EPOCH_NODE, str(epoch).encode())

    def _adopt_epoch(self, epoch: int) -> None:
        """Standby tail learned the primary's epoch from a pull."""
        with self._lock:
            if epoch > self._epoch:
                self._epoch = epoch
                self._backend.set(EPOCH_NODE, str(epoch).encode())

    def check_fence(self, token: int) -> None:
        """A request carrying an epoch above ours proves a newer
        primary exists: if we are (or think we are) the primary, we
        have been superseded and must never accept another write —
        the fencing half of split-brain prevention."""
        if token <= self._epoch:
            return
        with self._lock:
            if token <= self._epoch:
                return
            if self._role == ROLE_PRIMARY:
                self._role = ROLE_FENCED
                try:
                    # durable: fencing must survive a process restart
                    self._backend.set(FENCED_NODE, str(token).encode())
                except PersisterError:
                    pass
            self._epoch = token
            try:
                self._backend.set(EPOCH_NODE, str(token).encode())
            except PersisterError:
                pass

    # -- lease persistence --------------------------------------------

    def _load_leases(self) -> Dict[str, Tuple[str, float]]:
        leases: Dict[str, Tuple[str, float]] = {}
        try:
            names = self._backend.get_children(LEASE_PREFIX)
        except PersisterError:
            return leases
        for name in names:
            try:
                raw = self._backend.get(f"{LEASE_PREFIX}/{name}")
                entry = json.loads(raw or b"{}")
                leases[name] = (entry["owner"], float(entry["expires_at"]))
            except (PersisterError, KeyError, ValueError):
                continue
        return leases

    def _store_lease(self, name: str, owner: str, expires_at: float) -> int:
        return self._mutate([SetOp(
            f"{LEASE_PREFIX}/{name}",
            json.dumps({"owner": owner, "expires_at": expires_at}).encode(),
        )])

    def _drop_lease(self, name: str) -> Optional[int]:
        path = f"{LEASE_PREFIX}/{name}"
        if not self._backend.exists(path):
            return None
        return self._mutate([DeleteOp(path)])

    # -- mutation funnel ----------------------------------------------

    def _mutate(self, ops: List[TransactionOp]) -> int:
        """Every write goes through here: apply to the backend, then
        append to the replication log.  Caller holds self._lock, so
        log order == apply order.  Returns the log seq (the caller's
        bounded-sync barrier)."""
        from dcos_commons_tpu_torch.storage.replication import encode_ops

        self._backend.apply(ops)
        return self._log.append(encode_ops(ops))

    # -- request handling ---------------------------------------------

    def handle(self, route: str, body: dict) -> dict:
        with self._lock:
            if self._role != ROLE_PRIMARY:
                # authoritative re-check UNDER the lock: the unlocked
                # gate in do_POST can race a concurrent fence — once
                # fenced, not one more write may be applied or acked
                raise NotPrimaryError(f"not primary ({self._role})")
            if route == "/v1/kv/get":
                value = None
                try:
                    value = self._backend.get(body["path"])
                    found = True
                except PersisterError:
                    found = False
                return {
                    "found": found,
                    "value": base64.b64encode(value).decode()
                    if value is not None else None,
                }
            if route == "/v1/kv/set":
                seq = self._mutate([SetOp(
                    body["path"], base64.b64decode(body["value"] or "")
                )])
                return {"ok": True, "_sync_seq": seq}
            if route == "/v1/kv/children":
                try:
                    return {
                        "found": True,
                        "children": self._backend.get_children(body["path"]),
                    }
                except PersisterError:
                    return {"found": False, "children": []}
            if route == "/v1/kv/delete":
                if not self._backend.exists(body["path"]):
                    return {"found": False}
                seq = self._mutate([DeleteOp(body["path"])])
                return {"found": True, "_sync_seq": seq}
            if route == "/v1/kv/apply":
                from dcos_commons_tpu_torch.storage.replication import decode_ops

                raw_ops = body.get("ops", [])
                for raw in raw_ops:
                    if raw.get("op") not in ("set", "delete"):
                        raise PersisterError(
                            f"unknown op {raw.get('op')!r}"
                        )
                ops = decode_ops(raw_ops)
                seq = self._mutate(ops)
                return {"ok": True, "applied": len(ops), "_sync_seq": seq}
            if route == "/v1/lock/acquire":
                return self._acquire_locked(
                    body["name"], body["owner"],
                    float(body.get("ttl_s", 15.0)),
                )
            if route == "/v1/lock/release":
                return self._release_locked(body["name"], body["owner"])
            raise PersisterError(f"no route {route}")

    def _acquire_locked(self, name: str, owner: str, ttl_s: float) -> dict:
        # wall-clock expiry (not monotonic): leases must survive a
        # state-server restart via the backend, and monotonic clocks
        # don't cross processes
        now = time.time()
        held = self._leases.get(name)
        if held is not None and held[1] > now and held[0] != owner:
            return {
                "acquired": False,
                "owner": held[0],
                "expires_in": round(held[1] - now, 1),
            }
        # fresh acquire or renewal by the current owner
        self._leases[name] = (owner, now + ttl_s)
        seq = self._store_lease(name, owner, now + ttl_s)
        return {"acquired": True, "owner": owner, "_sync_seq": seq}

    def _release_locked(self, name: str, owner: str) -> dict:
        held = self._leases.get(name)
        if held is not None and held[0] == owner:
            del self._leases[name]
            seq = self._drop_lease(name)
            out = {"released": True}
            if seq is not None:
                out["_sync_seq"] = seq
            return out
        return {"released": False}

    # -- replication routes (storage/replication.py design) -----------

    def handle_repl(self, route: str, body: dict) -> dict:
        if route == "/v1/repl/status":
            out = {"role": self._role, "epoch": self._epoch}
            out.update(self._log.status())
            if self._tail is not None:
                out.update(self._tail.status())
            return out
        if route == "/v1/repl/promote":
            return self.promote(int(body.get("epoch", 0) or 0))
        if route == "/v1/repl/fence":
            # operator verb: demote a stale primary directly (used by
            # `state-server --promote` when the old primary is still
            # reachable, closing the partition window by hand)
            self.check_fence(int(body.get("epoch", 0) or 0))
            return {"role": self._role}
        if self._role != ROLE_PRIMARY:
            raise PersisterError(f"not primary ({self._role}): {route}")
        if route == "/v1/repl/snapshot":
            from dcos_commons_tpu_torch.storage.replication import dump_tree

            with self._lock:
                status = self._log.status()
                return {
                    "seq": status["seq"],
                    "stream_id": self._log.stream_id,
                    "nodes": dump_tree(self._backend),
                }
        if route == "/v1/repl/pull":
            standby_id = str(body.get("standby_id", ""))
            if not standby_id:
                # anonymous pullers would collide as "" and bypass the
                # single-puller guard entirely
                raise PersisterError("pull requires a standby_id")
            # long-poll OUTSIDE the kv lock: the log has its own
            return self._log.pull(
                int(body.get("from_seq", 1)),
                float(body.get("wait_s", 0.0)),
                standby_id,
                str(body.get("stream_id", "")),
            )
        raise PersisterError(f"no route {route}")

    def promote(self, epoch: int = 0) -> dict:
        """Standby -> primary with a fresh fencing epoch.  The log
        continues at the replicated seq so a future standby of THIS
        server starts cleanly; leases are reloaded from the replicated
        tree, so the scheduler's instance lease survives failover."""
        with self._lock:
            if self._role != ROLE_STANDBY:
                # a FENCED server must never be promoted: it carries a
                # pre-failover stale tree, and promoting it would fence
                # the good primary and converge the cluster on stale
                # state.  It rejoins by restarting with --standby-of.
                raise PersisterError(
                    f"can only promote a standby (role={self._role})"
                )
            tail = self._tail
            if (self._epoch == 0
                    and (tail is None or tail.applied_seq == 0)
                    and epoch == 0):
                # never synced: promoting would serve an EMPTY tree at
                # epoch 1 — colliding with the old primary's bootstrap
                # epoch, so fencing could not even tell them apart.
                # An operator who really means it passes an explicit
                # epoch.
                raise PersisterError(
                    "standby never replicated from the primary; "
                    "refusing to promote an empty tree (pass an "
                    "explicit epoch to override)"
                )
            self._tail = None
            if tail is not None:
                # non-blocking: the tail may sit in a long-poll against
                # the dead primary for seconds — failover latency must
                # not pay for that.  signal_stop + the flip below under
                # ONE lock hold guarantees no late entry applies after
                # we start acting as primary.
                tail.signal_stop()
            new_epoch = max(epoch, self._epoch + 1)
            base_seq = tail.applied_seq if tail is not None else 0
            self._role = ROLE_PRIMARY
            self._set_epoch(new_epoch)
            from dcos_commons_tpu_torch.storage.replication import StandbyTail

            # best-effort cleanup of stale cluster markers: the fenced
            # marker must not re-fence this server on restart, and the
            # applied-seq/stream markers describe a standby life that
            # primary-life writes will never update — if this server is
            # later fenced and rejoins with --standby-of, a surviving
            # stale applied value could line up with the new primary's
            # ring and skip snapshot repair, silently keeping divergent
            # unreplicated writes.
            for node in (
                FENCED_NODE,
                StandbyTail.APPLIED_NODE,
                StandbyTail.STREAM_NODE,
            ):
                try:
                    self._backend.recursive_delete(node)
                except PersisterError:
                    pass
            self._log.reset(base_seq)
            self._leases = self._load_leases()
        if tail is not None:
            # reap the thread off the critical path
            threading.Thread(target=tail.stop, daemon=True).start()
        return {"promoted": True, "epoch": new_epoch}

    # -- lifecycle ----------------------------------------------------

    @property
    def url(self) -> str:
        host, port = self._server.server_address[:2]
        if self.advertise_host:
            host = self.advertise_host
        elif host in ("0.0.0.0", "::"):
            # announce files must carry a dialable address
            import socket

            host = socket.gethostname()
        return f"{self._scheme}://{host}:{port}"

    def start(self) -> "StateServer":
        if self._tail is not None:
            self._tail.start()
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="state-server", daemon=True
        )
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        if self._tail is not None:
            self._tail.start()
        self._server.serve_forever()

    def stop(self) -> None:
        tail = self._tail
        if tail is not None:
            tail.stop()
        self._server.shutdown()
        self._server.server_close()
        self._backend.close()


class RemotePersister(Persister):
    """Persister over one or more StateServers.  Failures raise
    PersisterError — the scheduler treats a dead state backend like
    the reference treats a ZK outage: fail the cycle, crash to
    restart.

    HA: ``base_url`` may be a comma-separated list (primary +
    standbys).  Calls rotate to the next server when the current one
    is unreachable or answers 503 (not primary).  The client tracks
    the highest fencing ``epoch`` it has seen, sends it with every
    request (``_fence`` — a superseded primary fences itself on
    receipt), and refuses responses from servers whose epoch is below
    that high-water mark (stale primary)."""

    def __init__(self, base_url: str, timeout_s: float = 10.0,
                 auth_token: str = "", ca_file: str = ""):
        from dcos_commons_tpu_torch.security import auth as _auth

        self._urls = [
            u.strip().rstrip("/")
            for u in base_url.split(",") if u.strip()
        ]
        self._cur = 0
        self._max_epoch = 0
        self._epoch_lock = threading.Lock()
        self._timeout_s = timeout_s
        self._headers = {"Content-Type": "application/json",
                         **_auth.auth_headers(auth_token)}
        self._ssl_ctx = (
            _auth.client_ssl_context(ca_file)
            if any(u.startswith("https") for u in self._urls) else None
        )

    def _note_epoch(self, out: dict) -> None:
        try:
            epoch = int(out.get("epoch", 0) or 0)
        except (TypeError, ValueError):
            return
        with self._epoch_lock:
            if epoch > self._max_epoch:
                self._max_epoch = epoch

    def _call(self, route: str, body: dict) -> dict:
        last_err: Optional[PersisterError] = None
        n = len(self._urls)
        for attempt in range(n):
            idx = (self._cur + attempt) % n
            url = self._urls[idx]
            payload = dict(body)
            payload["_fence"] = self._max_epoch
            data = json.dumps(payload).encode("utf-8")
            req = urllib.request.Request(
                f"{url}{route}", data=data,
                headers=dict(self._headers), method="POST",
            )
            try:
                with urllib.request.urlopen(
                    req, timeout=self._timeout_s,
                    context=self._ssl_ctx if url.startswith("https")
                    else None,
                ) as resp:
                    out = json.loads(resp.read().decode("utf-8"))
            except urllib.error.HTTPError as e:
                try:
                    detail = json.loads(e.read().decode("utf-8"))
                except Exception:
                    detail = {"error": str(e)}
                self._note_epoch(detail)
                if e.code == 503:
                    # standby/fenced server: rotate to find the primary
                    last_err = PersisterError(
                        f"{url}: {detail.get('error', 'not primary')}"
                    )
                    continue
                raise PersisterError(
                    detail.get("error", str(e)), detail.get("path", "")
                )
            except (urllib.error.URLError, OSError) as e:
                last_err = PersisterError(
                    f"state server unreachable: {url}: {e}"
                )
                continue
            epoch = int(out.get("epoch", 0) or 0)
            if epoch and epoch < self._max_epoch:
                # a stale primary's answers must never be trusted: a
                # newer epoch exists, so this server missed a failover
                last_err = PersisterError(
                    f"{url}: stale epoch {epoch} < {self._max_epoch}"
                )
                continue
            self._note_epoch(out)
            self._cur = idx
            return out
        raise last_err or PersisterError("no state servers configured")

    def get(self, path: str) -> Optional[bytes]:
        out = self._call("/v1/kv/get", {"path": path})
        if not out["found"]:
            raise PersisterError(f"path not found: {path}", path)
        value = out.get("value")
        return base64.b64decode(value) if value is not None else None

    def set(self, path: str, value: bytes) -> None:
        self._call(
            "/v1/kv/set",
            {"path": path, "value": base64.b64encode(value).decode()},
        )

    def get_children(self, path: str) -> List[str]:
        out = self._call("/v1/kv/children", {"path": path})
        if not out["found"]:
            raise PersisterError(f"path not found: {path}", path)
        return out["children"]

    def recursive_delete(self, path: str) -> None:
        if not self._call("/v1/kv/delete", {"path": path})["found"]:
            raise PersisterError(f"path not found: {path}", path)

    def apply(self, ops: Iterable[TransactionOp]) -> None:
        from dcos_commons_tpu_torch.storage.replication import encode_ops

        self._call("/v1/kv/apply", {"ops": encode_ops(list(ops))})


class RemoteLocker:
    """Named TTL lease on the state server: the CuratorLocker analogue.

    ``acquire`` takes (or renews) the lease and starts a renewal thread
    at a third of the TTL; if the holder dies, the lease expires and a
    standby scheduler's next acquire succeeds — real failover, not a
    per-host file lock.

    Lease LOSS is fatal to the holder: if a renewal comes back
    ``acquired=false`` (someone else took the lease — we stalled past
    the TTL) or the server stays unreachable beyond the TTL, the
    renewal thread fires ``on_lost`` exactly once and stops.  The
    runner wires ``on_lost`` to crash the scheduler — the reference's
    CuratorLocker exits the process on ZK lock loss for the same
    reason: two active schedulers over one state tree corrupt plans.
    """

    def __init__(
        self,
        base_url: str,
        name: str,
        owner: str,
        ttl_s: float = 15.0,
        timeout_s: float = 5.0,
        auth_token: str = "",
        ca_file: str = "",
    ):
        self._persister = RemotePersister(
            base_url, timeout_s, auth_token=auth_token, ca_file=ca_file
        )
        self.name = name
        self.owner = owner
        self.ttl_s = ttl_s
        # callable(reason: str); set before or after acquire()
        self.on_lost = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _acquire_once(self) -> bool:
        out = self._persister._call(
            "/v1/lock/acquire",
            {"name": self.name, "owner": self.owner, "ttl_s": self.ttl_s},
        )
        return bool(out.get("acquired"))

    def acquire(self) -> bool:
        try:
            if not self._acquire_once():
                return False
        except PersisterError:
            return False
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._renew_loop, name=f"lease-{self.name}", daemon=True
        )
        self._thread.start()
        return True

    def _renew_loop(self) -> None:
        last_renewed = time.monotonic()
        while not self._stop.wait(self.ttl_s / 3.0):
            try:
                if self._acquire_once():
                    last_renewed = time.monotonic()
                    continue
                # someone else holds OUR lease: we stalled past the
                # TTL and a standby took over — we are no longer the
                # instance and must not keep mutating state
                self._lost("lease taken by another scheduler instance")
                return
            except PersisterError as e:
                # transient hiccups are survivable while the lease is
                # still live; once we cannot renew for a full TTL the
                # lease has lapsed server-side and a standby may hold
                # it — same outcome as above
                if time.monotonic() - last_renewed > self.ttl_s:
                    self._lost(f"state server unreachable past TTL: {e}")
                    return

    def _lost(self, reason: str) -> None:
        callback = self.on_lost
        if callback is not None:
            callback(reason)

    def release(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.ttl_s)
        try:
            self._persister._call(
                "/v1/lock/release", {"name": self.name, "owner": self.owner}
            )
        except PersisterError:
            pass  # lease will expire on its own


def main(argv: Optional[list] = None) -> int:
    """``python -m dcos_commons_tpu_torch state-server`` — run the cluster
    state server over a durable file WAL."""
    import argparse

    from dcos_commons_tpu_torch.storage.file_persister import FileWalPersister

    parser = argparse.ArgumentParser(prog="dcos_commons_tpu_torch state-server")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--bind", default="127.0.0.1")
    parser.add_argument(
        "--advertise-host", default="",
        help="hostname/IP to announce instead of the bind address "
             "(required when binding 0.0.0.0 on a multi-host fleet)",
    )
    parser.add_argument("--data-dir", default="./state-server")
    parser.add_argument(
        "--announce-file", default="",
        help="write the URL here once listening (ephemeral ports)",
    )
    parser.add_argument(
        "--auth-token-file", default="",
        help="cluster bearer token file; also $AUTH_TOKEN(_FILE)",
    )
    parser.add_argument("--tls-cert", default="", help="serve HTTPS: cert PEM")
    parser.add_argument("--tls-key", default="", help="serve HTTPS: key PEM")
    parser.add_argument(
        "--ca-file", default="",
        help="CA bundle for talking to an HTTPS primary (standby mode)",
    )
    parser.add_argument(
        "--standby-of", default="",
        help="run as a hot standby replicating from this primary URL; "
             "promote with --promote when the primary dies",
    )
    parser.add_argument(
        "--sync-timeout-s", type=float, default=2.0,
        help="bounded-sync barrier: how long a write waits for the "
             "attached standby before marking it lagging",
    )
    parser.add_argument(
        "--promote", default="", metavar="STANDBY_URL",
        help="operator verb: promote the standby at this URL to "
             "primary (mints a new fencing epoch) and exit",
    )
    parser.add_argument(
        "--fence-old", default="", metavar="OLD_PRIMARY_URL",
        help="with --promote: also demote the old primary if it is "
             "still reachable (closes the partition window)",
    )
    parser.add_argument(
        "--repl-status", default="", metavar="SERVER_URL",
        help="operator verb: print the server's replication status "
             "(role, epoch, seq, per-standby acks) as JSON and exit — "
             "on a primary this is what to alert on; with several "
             "standbys, promote the one whose applied_seq is highest",
    )
    args = parser.parse_args(argv)
    from dcos_commons_tpu_torch.security.auth import load_token

    token = load_token(token_file=args.auth_token_file)
    if args.repl_status:
        import sys

        try:
            out = RemotePersister(
                args.repl_status, timeout_s=5.0,
                auth_token=token, ca_file=args.ca_file,
            )._call("/v1/repl/status", {})
        except (PersisterError, ValueError) as e:
            # ValueError: a scheme-less URL ("host:port") from a
            # hand-typed command — an error message, not a traceback
            print(f"repl-status failed: {e}", file=sys.stderr)
            return 1
        print(json.dumps(out, indent=2, sort_keys=True))
        return 0
    if args.promote:
        import sys

        client = RemotePersister(
            args.promote, auth_token=token, ca_file=args.ca_file
        )
        try:
            out = client._call("/v1/repl/promote", {})
        except (PersisterError, ValueError) as e:
            # ValueError: scheme-less URL — message, not traceback
            print(f"promote failed: {e}", file=sys.stderr)
            return 1
        epoch = out.get("epoch")
        print(f"promoted {args.promote} to primary at epoch {epoch}")
        if args.fence_old:
            try:
                out = RemotePersister(
                    args.fence_old, timeout_s=5.0,
                    auth_token=token, ca_file=args.ca_file,
                )._call("/v1/repl/fence", {"epoch": epoch})
                role = out.get("role")
                if role == ROLE_PRIMARY:
                    # fence token didn't demote it (epoch collision?):
                    # this is a split-brain hazard, say so loudly
                    print(
                        f"WARNING: {args.fence_old} still reports "
                        f"role=primary after fence at epoch {epoch} — "
                        "shut it down manually before serving traffic",
                        file=sys.stderr,
                    )
                    return 1
                print(f"fenced old primary {args.fence_old} (role={role})")
            except PersisterError as e:
                print(
                    f"old primary not fenced ({e}) — it will fence "
                    "itself on first client contact",
                    file=sys.stderr,
                )
        return 0
    if not token and args.bind not in ("127.0.0.1", "localhost", "::1"):
        import sys

        print(
            "WARNING: state server bound on a non-loopback address with NO "
            "auth token — anyone who can reach this port can clobber all "
            "cluster state. Pass --auth-token-file.",
            file=sys.stderr,
        )
    from dcos_commons_tpu_torch.agent.daemon import _tls_pair_or_die

    server = StateServer(
        FileWalPersister(args.data_dir), port=args.port, bind=args.bind,
        auth_token=token,
        tls=_tls_pair_or_die(args.tls_cert, args.tls_key),
        advertise_host=args.advertise_host,
        replicate_from=args.standby_of,
        ca_file=args.ca_file,
        sync_timeout_s=args.sync_timeout_s,
    )
    if args.announce_file:
        from dcos_commons_tpu_torch.common import atomic_write_text

        atomic_write_text(args.announce_file, server.url + "\n")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

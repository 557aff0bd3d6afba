"""State-server replication: op log, standby tail, fencing epochs.

Reference: the reference's durability story is a ZooKeeper *ensemble*
behind CuratorPersister (curator/CuratorPersister.java:43-110 — atomic
multi-op transactions against a replicated quorum), so the state
backend itself has no single point of failure.  This module gives the
GPU fleet's StateServer the same property with a primary plus N hot
standbys:

* every mutation the primary applies is appended to a seq-numbered
  **replication log**; each standby tails it over long-poll HTTP
  (``/v1/repl/pull``) and applies entries to its own durable backend
  in order — bootstrap (or divergence repair) is a full-tree
  ``/v1/repl/snapshot``.  Standbys carry independent per-puller
  watermarks: one standby's acks never stand in for another's;
* writes are **bounded-sync**: while standbys are attached and caught
  up, the primary acks a mutation only after EVERY in-sync standby
  has pulled it (so promotion may pick any of them without losing an
  acked write — zero-loss failover in the healthy case); a standby
  that stalls past ``sync_timeout_s`` is marked lagging and writes
  continue (availability over strict sync — the lag is repaired by
  the tail and the scheduler's reconciliation-on-restart covers the
  window);
* failover is an explicit **promotion** (``/v1/repl/promote``) that
  mints a new fencing **epoch** (monotonic, persisted).  Every client
  request carries the highest epoch its sender has seen; a primary
  that receives a token above its own epoch has been superseded and
  **fences itself** (refuses all further writes) — a partitioned
  stale primary cannot split-brain the state tree once any client
  has talked to the new one.  Clients reject servers whose epoch is
  below their high-water mark for the same reason.

The scheduler side needs no new machinery: ``RemotePersister`` takes a
comma-separated server list and rotates to the next server when the
current one is unreachable or not primary, and the (already
lease-driven) scheduler keeps running because leases live IN the
replicated tree.

Port of ``dcos_commons_tpu/storage/replication.py``, line for line but
the imports.
"""

from __future__ import annotations

import base64
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from dcos_commons_tpu_torch.storage.persister import (
    DeleteOp,
    Persister,
    SetOp,
    TransactionOp,
)

# how long after the last pull a standby still counts as attached
# (long-poll wait below must be shorter, so an idle-but-healthy
# standby re-pulls well within the window)
ATTACH_WINDOW_S = 10.0
# server-side cap on one long-poll
MAX_PULL_WAIT_S = 5.0


def encode_ops(ops: List[TransactionOp]) -> List[dict]:
    """Wire form of a transaction (shared with /v1/kv/apply)."""
    out = []
    for op in ops:
        if isinstance(op, SetOp):
            out.append({
                "op": "set", "path": op.path,
                "value": base64.b64encode(op.value).decode()
                if op.value is not None else None,
            })
        else:
            out.append({"op": "delete", "path": op.path})
    return out


def decode_ops(raw: List[dict]) -> List[TransactionOp]:
    ops: List[TransactionOp] = []
    for item in raw:
        if item["op"] == "set":
            value = item.get("value")
            ops.append(SetOp(
                item["path"],
                base64.b64decode(value) if value is not None else b"",
            ))
        else:
            ops.append(DeleteOp(item["path"]))
    return ops


def dump_tree(persister: Persister) -> List[Tuple[str, Optional[str]]]:
    """Flat [(path, b64-value-or-None)] of the whole tree, for
    snapshot shipping.  Works over any Persister via children/get."""
    out: List[Tuple[str, Optional[str]]] = []

    def walk(path: str) -> None:
        for name in persister.get_children_or_empty(path):
            child = f"{path}/{name}" if path != "/" else f"/{name}"
            value = persister.get_or_none(child)
            out.append((
                child,
                base64.b64encode(value).decode() if value is not None
                else None,
            ))
            walk(child)

    walk("/")
    return out


def restore_tree(
    persister: Persister, nodes: List[Tuple[str, Optional[str]]]
) -> None:
    """Replace the persister's contents with a shipped snapshot."""
    persister.clear_all_data()
    ops = [
        SetOp(path, base64.b64decode(value))
        for path, value in nodes
        if value is not None  # value-less inner nodes re-appear via children
    ]
    if ops:
        persister.apply(ops)


class ReplicationLog:
    """Seq-numbered ring of mutation batches with long-poll + acks.

    The ring is in-memory only: the durable log IS the primary's file
    WAL.  A standby asking for a seq the ring no longer holds (primary
    restarted, or the standby fell too far behind) is told to
    re-snapshot — the same repair path as initial bootstrap.

    N standbys may attach (the ZooKeeper-ensemble analogue is a
    quorum, not a pair): each puller carries its OWN watermark, and
    bounded-sync waits on EVERY attached non-lagging standby — so
    "replicated" means any of them can be promoted without losing an
    acked write.  A standby that stalls is marked lagging (excluded
    from the barrier, repaired by its own tail); one that stops
    pulling past the attach window is pruned entirely.
    """

    def __init__(self, max_entries: int = 8192,
                 sync_timeout_s: float = 2.0):
        import uuid

        self._entries: deque = deque()  # (seq, [op dicts])
        self._cv = threading.Condition()
        self._next_seq = 1
        # puller_id -> {"acked": int, "last_pull": float, "lagging": bool}
        self._pullers: Dict[str, dict] = {}
        self._max_entries = max_entries
        self.sync_timeout_s = sync_timeout_s
        # identifies THIS ring of seq numbers: seqs are only comparable
        # within one stream.  A standby whose persisted applied seq came
        # from a DIFFERENT stream (old primary, pre-promotion life) must
        # re-snapshot even when the raw numbers happen to line up.
        self.stream_id = uuid.uuid4().hex

    def _attached_locked(self, now: float) -> Dict[str, dict]:
        """Live pullers; prunes ones silent past the attach window (a
        dead standby must stop gating the write barrier)."""
        for pid in [
            pid for pid, st in self._pullers.items()
            if now - st["last_pull"] > ATTACH_WINDOW_S
        ]:
            del self._pullers[pid]
        return self._pullers

    # -- primary write path -------------------------------------------

    def append(self, ops_payload: List[dict]) -> int:
        with self._cv:
            seq = self._next_seq
            self._next_seq += 1
            self._entries.append((seq, ops_payload))
            while len(self._entries) > self._max_entries:
                self._entries.popleft()
            self._cv.notify_all()
            return seq

    def wait_replicated(self, seq: int) -> bool:
        """Block until EVERY attached, non-lagging standby has acked
        ``seq`` (the bounded-sync barrier) — all-of, not any-of, so
        promotion may pick ANY in-sync standby without losing an acked
        write.  Returns immediately when no standby is in sync; on
        timeout the stragglers are marked lagging (they repair via
        their own tails and re-earn the barrier by catching up).
        True = replicated to every in-sync standby."""
        deadline = time.monotonic() + self.sync_timeout_s
        with self._cv:
            while True:
                now = time.monotonic()
                live = [
                    st for st in self._attached_locked(now).values()
                    if not st["lagging"]
                ]
                if not live:
                    return False  # nobody in sync to wait for
                pending = [st for st in live if st["acked"] < seq]
                if not pending:
                    return True
                if now >= deadline:
                    for st in pending:
                        st["lagging"] = True
                    return False
                self._cv.wait(timeout=min(0.05, deadline - now))

    # -- standby pull path --------------------------------------------

    def pull(self, from_seq: int, wait_s: float,
             puller_id: str = "", stream_id: str = "") -> dict:
        """Entries at/after ``from_seq``; pulling acks ``from_seq-1``
        for THIS puller.  ``snapshot_needed`` when continuity from
        ``from_seq`` cannot be proven (ring trimmed, a fresh/restarted
        primary, or a seq from another stream).

        Each puller_id owns an independent watermark: a fast standby's
        acks never stand in for a slow one's (promoting the slow one
        after an any-of ack would lose writes the primary reported
        replicated).  A RETURNING puller_id restarts at acked 0 — its
        previous watermark may describe a tree that has since been
        wiped — and re-earns the barrier by pulling."""
        wait_s = max(0.0, min(wait_s, MAX_PULL_WAIT_S))
        deadline = time.monotonic() + wait_s
        with self._cv:
            now = time.monotonic()
            self._attached_locked(now)  # prune the silent
            st = self._pullers.get(puller_id)
            if st is None:
                # fresh attach (new standby, or one returning after a
                # silence prune): LAGGING until its ack reaches the tip
                # — otherwise a newcomer whose from_seq still proves
                # continuity (young primary, log replay from 1) joins
                # the bounded-sync barrier at acked 0 and every live
                # write stalls up to sync_timeout_s while it replays.
                # The standard lagging-clear below flips it in-sync the
                # moment it catches up (same pull, if already at tip).
                st = {"acked": 0, "last_pull": now, "lagging": True}
                self._pullers[puller_id] = st
            st["last_pull"] = now
            if stream_id and stream_id != self.stream_id:
                # the standby's applied seq is from a DIFFERENT ring:
                # acking from it would falsely mark this stream's
                # writes replicated even when the raw numbers line up
                # (a reattaching ex-standby after promotion).  Verified
                # HERE, before the ack — the standby-side check alone
                # runs after the primary has already released
                # wait_replicated() waiters.
                st["lagging"] = True
                return {
                    "snapshot_needed": True,
                    "seq": self._next_seq - 1,
                    "stream_id": self.stream_id,
                }
            first = self._entries[0][0] if self._entries else self._next_seq
            if not (first <= from_seq <= self._next_seq):
                # continuity unproven: the standby is behind this ring
                # (or ahead of a restarted primary).  It must NOT ack
                # anything — a from_seq above the ring would otherwise
                # inflate the watermark and bounded-sync would pass
                # writes the standby never copied.  It IS attached but
                # behind: mark lagging so writers don't block on it
                # while it snapshots.
                st["lagging"] = True
                return {
                    "snapshot_needed": True,
                    "seq": self._next_seq - 1,
                    "stream_id": self.stream_id,
                }
            ack = min(from_seq - 1, self._next_seq - 1)
            if ack < st["acked"]:
                # the puller moved BACKWARDS (a standby with a stable
                # id restarted after wiping its tree): its old
                # watermark no longer describes that tree — drop to
                # what this pull actually proves, re-earn the rest,
                # and leave the barrier while replaying (same rule as
                # a fresh attach: bootstrap never gates live writes)
                st["acked"] = max(ack, 0)
                st["lagging"] = True
            elif ack > st["acked"]:
                st["acked"] = ack
            if st["lagging"] and st["acked"] >= self._next_seq - 1:
                st["lagging"] = False
            self._cv.notify_all()
            while self._next_seq <= from_seq:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cv.wait(timeout=remaining)
                st["last_pull"] = time.monotonic()
            entries = [
                {"seq": seq, "ops": ops}
                for seq, ops in self._entries if seq >= from_seq
            ]
            return {"entries": entries, "stream_id": self.stream_id}

    # -- introspection ------------------------------------------------

    def status(self) -> dict:
        with self._cv:
            now = time.monotonic()
            live = self._attached_locked(now)
            return {
                "seq": self._next_seq - 1,
                # the conservative watermark: everything at or below
                # this has reached EVERY attached standby (lagging
                # ones included — their trees are still behind it)
                "acked_seq": (
                    min(st["acked"] for st in live.values())
                    if live else 0
                ),
                "standby_attached": bool(live),
                "standby_lagging": any(
                    st["lagging"] for st in live.values()
                ),
                "standby_count": len(live),
                "standbys": {
                    pid: {
                        "acked": st["acked"],
                        "lagging": st["lagging"],
                        "age_s": round(now - st["last_pull"], 3),
                    }
                    for pid, st in live.items()
                },
            }

    def reset(self, base_seq: int) -> None:
        """Adopt a seq base after promotion: the new primary's log
        continues where its replica stream left off."""
        import uuid

        with self._cv:
            self._entries.clear()
            self._next_seq = base_seq + 1
            self._pullers.clear()
            # a NEW stream: the promoted server's ring is not the old
            # primary's, even though the seq numbering continues
            self.stream_id = uuid.uuid4().hex


class StandbyTail:
    """The standby's replication client: snapshot, then tail.

    Runs as a daemon thread inside a standby StateServer.  All state
    it writes goes through the standby's own (durable) backend, so a
    standby restart resumes from its persisted applied-seq instead of
    re-snapshotting.  A divergence (an entry that fails to apply) or
    a trimmed ring triggers snapshot repair.
    """

    APPLIED_NODE = "/__cluster__/repl_applied"
    # the stream the applied seq belongs to: seqs from one primary's
    # ring say nothing about another's, so a stream mismatch on pull
    # forces snapshot repair even when the numbers line up
    STREAM_NODE = "/__cluster__/repl_stream"

    def __init__(
        self,
        backend: Persister,
        backend_lock,
        primary_url: str,
        auth_token: str = "",
        ca_file: str = "",
        on_epoch=None,
    ):
        import uuid

        from dcos_commons_tpu_torch.storage.remote import RemotePersister

        self._backend = backend
        self._lock = backend_lock
        # identifies THIS standby to the primary's single-puller guard
        self._standby_id = uuid.uuid4().hex
        # reuse the HTTP plumbing; repl endpoints are server-to-server
        self._client = RemotePersister(
            primary_url, timeout_s=MAX_PULL_WAIT_S + 5.0,
            auth_token=auth_token, ca_file=ca_file,
        )
        self._on_epoch = on_epoch  # callable(int) -> None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.last_error: str = ""
        self.applied_seq = self._load_applied()
        self.stream_id = (
            self._backend.get_or_none(self.STREAM_NODE) or b""
        ).decode()
        from dcos_commons_tpu_torch.storage.remote import FENCED_NODE

        if self.applied_seq and backend.exists(FENCED_NODE):
            # belt-and-braces vs promote()'s applied-seq reset: a tree
            # that carries a fenced marker lived a primary (or fenced-
            # primary) life after this applied seq was written, so the
            # value no longer describes the tree — bootstrap from a
            # full snapshot instead of resuming the tail
            self.applied_seq = 0

    def _load_applied(self) -> int:
        raw = self._backend.get_or_none(self.APPLIED_NODE)
        try:
            return int((raw or b"0").decode())
        except ValueError:
            return 0

    def start(self) -> "StandbyTail":
        self._thread = threading.Thread(
            target=self._run, name="repl-tail", daemon=True
        )
        self._thread.start()
        return self

    def signal_stop(self) -> None:
        """Non-blocking stop: after this returns no further entry is
        applied (checked under the backend lock), even though the tail
        thread may still be blocked in a long-poll.  Promotion uses
        this so failover latency is not bounded by an in-flight pull
        against a dead primary."""
        self._stop.set()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=MAX_PULL_WAIT_S + 10.0)

    # -- the tail loop ------------------------------------------------

    def _run(self) -> None:
        need_snapshot = self.applied_seq == 0
        while not self._stop.is_set():
            try:
                if need_snapshot:
                    self._snapshot()
                    need_snapshot = False
                out = self._client._call("/v1/repl/pull", {
                    "from_seq": self.applied_seq + 1,
                    "wait_s": MAX_PULL_WAIT_S,
                    "standby_id": self._standby_id,
                    # lets the PRIMARY refuse (and not ack) a seq from
                    # another ring before wait_replicated() passes it
                    "stream_id": self.stream_id,
                })
                if self._stop.is_set():
                    return  # promoted mid-pull: nothing more applies
                self._note_epoch(out)
                stream = out.get("stream_id", "")
                if stream and stream != self.stream_id:
                    # a DIFFERENT ring (repointed standby, restarted
                    # or promoted primary): our applied seq is from
                    # another stream and proves nothing even when the
                    # primary's continuity check happens to pass
                    need_snapshot = True
                    continue
                if out.get("snapshot_needed"):
                    need_snapshot = True
                    continue
                if not self._apply_entries(out.get("entries", [])):
                    need_snapshot = True
                self.last_error = ""
            except Exception as e:  # noqa: BLE001 — keep tailing
                self.last_error = str(e)
                self._stop.wait(0.5)

    def _snapshot(self) -> None:
        out = self._client._call("/v1/repl/snapshot", {})
        self._note_epoch(out)
        with self._lock:
            if self._stop.is_set():
                return
            restore_tree(self._backend, [
                tuple(node) for node in out.get("nodes", [])
            ])
            self.applied_seq = int(out["seq"])
            self.stream_id = out.get("stream_id", "")
            self._store_applied()

    def _apply_entries(self, entries: List[dict]) -> bool:
        """Apply in seq order; False = divergence, re-snapshot."""
        for entry in entries:
            seq = int(entry["seq"])
            if seq <= self.applied_seq:
                continue  # replayed tail of a previous pull
            if seq != self.applied_seq + 1:
                return False  # gap — ring moved under us
            ops = decode_ops(entry["ops"])
            with self._lock:
                if self._stop.is_set():
                    # promote() flips role under this same lock AFTER
                    # signal_stop(): once flipped, a late entry must
                    # never clobber the new primary's writes
                    return True
                try:
                    self._backend.apply(ops)
                except Exception:
                    # a DeleteOp for a path we do not have, etc.: the
                    # trees have diverged — repair from snapshot
                    return False
                self.applied_seq = seq
                self._store_applied()
        return True

    def _store_applied(self) -> None:
        self._backend.apply([
            SetOp(self.APPLIED_NODE, str(self.applied_seq).encode()),
            SetOp(self.STREAM_NODE, self.stream_id.encode()),
        ])

    def _note_epoch(self, out: dict) -> None:
        epoch = out.get("epoch")
        if epoch and self._on_epoch is not None:
            self._on_epoch(int(epoch))

    def status(self) -> Dict[str, object]:
        return {
            "applied_seq": self.applied_seq,
            "last_error": self.last_error,
        }

"""Write-ahead-logged file persister.

The durability substrate replacing the reference's ZooKeeper
(curator/CuratorPersister.java:43-110).  ZooKeeper gives the reference
atomic multi-op transactions + durability; we get the same from a
single fsync'd append-only log with CRC-framed records and periodic
snapshot compaction.  A GPU fleet's control plane runs on one admin host,
so a local WAL (optionally on replicated storage) is the idiomatic
equivalent; the Persister interface stays pluggable for etcd.

Record framing:  [u32 len][u32 crc32][payload]  where payload is a
JSON-encoded transaction (list of set/delete ops, values hex-encoded).
A torn final record (crash mid-append) is detected by length/CRC and
discarded on replay — the same "WAL before accept" crash-consistency
the reference gets from ZK (state/PersistentLaunchRecorder.java flow,
DefaultScheduler.java:454-455).

Port of ``dcos_commons_tpu/storage/file_persister.py``,
line for line but the imports.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import zlib
from typing import Iterable, List, Optional

from dcos_commons_tpu_torch.storage.persister import (
    DeleteOp,
    MemPersister,
    Persister,
    PersisterError,
    SetOp,
    TransactionOp,
    normalize_path,
)

_HEADER = struct.Struct("<II")  # (length, crc32)


class FileWalPersister(Persister):
    """Durable Persister over <dir>/wal.log + <dir>/snapshot.json."""

    SNAPSHOT = "snapshot.json"
    WAL = "wal.log"

    def __init__(self, directory: str, fsync: bool = True,
                 compact_every: int = 4096) -> None:
        self._dir = directory
        self._fsync = fsync
        self._compact_every = compact_every
        self._lock = threading.RLock()
        self._mem = MemPersister()  # authoritative in-RAM image
        self._records_since_compact = 0
        os.makedirs(directory, exist_ok=True)
        with self._lock:
            # sets _records_since_compact to the replayed count
            self._replay_locked()
        self._wal = open(self._wal_path, "ab")
        # a crash-restart loop must not defer compaction forever: if the
        # replayed WAL already exceeds the threshold, compact at boot
        self._maybe_compact()

    @property
    def _wal_path(self) -> str:
        return os.path.join(self._dir, self.WAL)

    @property
    def _snap_path(self) -> str:
        return os.path.join(self._dir, self.SNAPSHOT)

    # recovery --------------------------------------------------------

    def _replay_locked(self) -> None:
        if os.path.exists(self._snap_path):
            with open(self._snap_path, "rb") as f:
                snap = json.loads(f.read().decode("utf-8"))
            for path, hexval in snap.items():
                if hexval is not None:
                    self._mem.set(path, bytes.fromhex(hexval))
                else:
                    # valueless nodes keep the tree shape across restart
                    self._mem.ensure_node(path)
        if not os.path.exists(self._wal_path):
            return
        with open(self._wal_path, "rb") as f:
            data = f.read()
        offset, good = 0, 0
        while offset + _HEADER.size <= len(data):
            length, crc = _HEADER.unpack_from(data, offset)
            start = offset + _HEADER.size
            end = start + length
            if end > len(data):
                break  # torn tail record: crash mid-append
            payload = data[start:end]
            if zlib.crc32(payload) != crc:
                break  # corrupt tail record
            # Replay must be idempotent: a crash inside compact() after
            # the snapshot rename but before the WAL truncation leaves a
            # WAL whose deletes may reference paths the snapshot no
            # longer has.  Deletes of missing paths are no-ops here.
            for op in _decode_txn(payload):
                if isinstance(op, SetOp):
                    self._mem.set(op.path, op.value)
                else:
                    try:
                        self._mem.recursive_delete(op.path)
                    except PersisterError:
                        pass
            self._records_since_compact += 1
            offset, good = end, end
        if good < len(data):
            # truncate the torn tail so future appends are clean
            with open(self._wal_path, "r+b") as f:
                f.truncate(good)

    # write path ------------------------------------------------------

    def _append_locked(self, ops: List[TransactionOp]) -> None:
        payload = _encode_txn(ops)
        self._wal.write(_HEADER.pack(len(payload), zlib.crc32(payload)))
        self._wal.write(payload)
        self._wal.flush()
        if self._fsync:
            os.fsync(self._wal.fileno())
        self._records_since_compact += 1

    def _maybe_compact(self) -> None:
        # called after the RAM image reflects the appended record, so
        # the snapshot never loses the write that triggered compaction
        if self._records_since_compact >= self._compact_every:
            self.compact()

    def compact(self) -> None:
        """Snapshot the tree and truncate the WAL."""
        with self._lock:
            snap = {
                path: (value.hex() if value is not None else None)
                for path, value in self._mem.dump().items()
            }
            tmp = self._snap_path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(json.dumps(snap).encode("utf-8"))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._snap_path)
            if self._fsync:
                # the rename is durable only once the directory entry is
                # on disk; truncating the WAL before that loses every
                # write since the previous snapshot on power failure
                dir_fd = os.open(self._dir, os.O_RDONLY)
                try:
                    os.fsync(dir_fd)
                finally:
                    os.close(dir_fd)
            self._wal.close()
            self._wal = open(self._wal_path, "wb")
            if self._fsync:
                os.fsync(self._wal.fileno())
            self._records_since_compact = 0

    # Persister -------------------------------------------------------

    def get(self, path: str) -> Optional[bytes]:
        with self._lock:
            return self._mem.get(path)

    def set(self, path: str, value: bytes) -> None:
        with self._lock:
            if normalize_path(path) == "/":
                raise PersisterError("cannot store a value at '/'", path)
            self._append_locked([SetOp(path, value)])
            self._mem.set(path, value)
            self._maybe_compact()

    def get_children(self, path: str) -> List[str]:
        with self._lock:
            return self._mem.get_children(path)

    def recursive_delete(self, path: str) -> None:
        with self._lock:
            self._mem.get_children(path)  # raise if absent, before logging
            self._append_locked([DeleteOp(path)])
            self._mem.recursive_delete(path)
            self._maybe_compact()

    def apply(self, ops: Iterable[TransactionOp]) -> None:
        with self._lock:
            ops = list(ops)
            # validate against the RAM image first: WAL must never
            # contain a transaction that fails when applied below
            for op in ops:
                if isinstance(op, DeleteOp) and not self._mem.exists(op.path):
                    raise PersisterError(f"path not found: {op.path}", op.path)
                if isinstance(op, SetOp) and normalize_path(op.path) == "/":
                    raise PersisterError("cannot store a value at '/'", op.path)
            self._append_locked(ops)
            self._mem.apply(ops)
            self._maybe_compact()

    def close(self) -> None:
        with self._lock:
            self._wal.close()


def _encode_txn(ops: List[TransactionOp]) -> bytes:
    encoded = []
    for op in ops:
        if isinstance(op, SetOp):
            encoded.append({"op": "set", "path": op.path, "value": op.value.hex()})
        else:
            encoded.append({"op": "del", "path": op.path})
    return json.dumps(encoded).encode("utf-8")


def _decode_txn(payload: bytes) -> List[TransactionOp]:
    ops: List[TransactionOp] = []
    for entry in json.loads(payload.decode("utf-8")):
        if entry["op"] == "set":
            ops.append(SetOp(entry["path"], bytes.fromhex(entry["value"])))
        else:
            ops.append(DeleteOp(entry["path"]))
    return ops

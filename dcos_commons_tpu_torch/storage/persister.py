"""Persister contract + in-memory implementation.

Reference: sdk/scheduler/.../storage/Persister.java:15-99 (get/set/
setMany/getChildren/recursiveDelete/close), MemPersister.java,
PersisterUtils path helpers.

Port of ``dcos_commons_tpu/storage/persister.py``,
line for line but the imports.
"""

from __future__ import annotations

import threading
from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Union


class StorageError(Exception):
    """Base class for storage failures."""


class PersisterError(StorageError):
    """A path was missing or an operation conflicted."""

    def __init__(self, message: str, path: str = ""):
        super().__init__(message)
        self.path = path


def normalize_path(path: str) -> str:
    """Canonical form: leading '/', no trailing '/', no empty segments.

    Reference: storage/PersisterUtils.java path math.
    """
    parts = [p for p in path.split("/") if p]
    return "/" + "/".join(parts)


def parent_of(path: str) -> str:
    path = normalize_path(path)
    head, _, _ = path.rpartition("/")
    return head or "/"


def child_of(path: str, *names: str) -> str:
    return normalize_path("/".join([path, *names]))


def namespace_root(namespace: str) -> str:
    """Root prefix for a (possibly multi-segment) service namespace.

    Reference: SchedulerBuilder namespacing for multi-service mode.
    """
    return f"/{namespace.strip('/')}" if namespace else ""


def validate_key(key: str, what: str = "key") -> str:
    """Reject keys that would traverse or collapse storage paths."""
    if not key or "/" in key:
        raise PersisterError(f"invalid {what}: {key!r}")
    return key


@dataclass(frozen=True)
class SetOp:
    path: str
    value: bytes


@dataclass(frozen=True)
class DeleteOp:
    path: str  # recursive


TransactionOp = Union[SetOp, DeleteOp]


class Persister(ABC):
    """Hierarchical path -> bytes store with atomic transactions.

    Intermediate nodes are created implicitly on set (as the reference's
    CuratorPersister does via creatingParentsIfNeeded) and may hold data
    themselves.
    """

    @abstractmethod
    def get(self, path: str) -> Optional[bytes]:
        """Value at ``path``; raises PersisterError if path absent."""

    @abstractmethod
    def set(self, path: str, value: bytes) -> None: ...

    @abstractmethod
    def get_children(self, path: str) -> List[str]:
        """Immediate child names (not full paths); PersisterError if absent."""

    @abstractmethod
    def recursive_delete(self, path: str) -> None:
        """Delete subtree; PersisterError if absent."""

    @abstractmethod
    def apply(self, ops: Iterable[TransactionOp]) -> None:
        """Apply all ops atomically (all-or-nothing).

        Reference: CuratorPersister.java:86-110 atomic multi-op
        transactions; this is what makes launch WAL + status writes
        crash-consistent.
        """

    def close(self) -> None:  # pragma: no cover - trivial default
        pass

    # convenience -----------------------------------------------------

    def get_or_none(self, path: str) -> Optional[bytes]:
        """Value at ``path``, or None when the path is absent."""
        try:
            return self.get(path)
        except PersisterError:
            return None

    def exists(self, path: str) -> bool:
        try:
            self.get(path)
            return True
        except PersisterError:
            return False

    def get_children_or_empty(self, path: str) -> List[str]:
        try:
            return self.get_children(path)
        except PersisterError:
            return []

    def clear_all_data(self) -> None:
        """Reference: storage/PersisterUtils.java clearAllData (uninstall)."""
        for child in self.get_children_or_empty("/"):
            self.recursive_delete("/" + child)


def wipe_namespace(persister: Persister, namespace: str = "") -> None:
    """Delete every node a service owns: its namespace subtree, or —
    for a standalone service — the whole tree MINUS cluster
    infrastructure.  The storage-layer home for the uninstall
    teardown's raw mutation (scheduler paths must not mutate
    persisters directly — sdklint lease-gated-mutation).

    ``/__ha__`` (the leader-lease records) is never wiped: an HA
    uninstaller writes through the lease-fenced persister, and
    deleting its own lease mid-wipe would fence every remaining
    delete — the uninstall could never finish.  The lease expires on
    its own once the process exits."""
    root = namespace_root(namespace)
    if root:
        try:
            persister.recursive_delete(root)
        except PersisterError:
            pass  # already gone
    else:
        for child in persister.get_children_or_empty("/"):
            if child == "__ha__":
                continue
            try:
                persister.recursive_delete(f"/{child}")
            except PersisterError:
                pass  # concurrent cleanup: already gone


class _Node:
    __slots__ = ("value", "children")

    def __init__(self) -> None:
        self.value: Optional[bytes] = None
        self.children: Dict[str, "_Node"] = {}


class MemPersister(Persister):
    """In-memory tree store (reference: storage/MemPersister.java).

    Used by unit tests and the simulation harness exactly as the
    reference uses MemPersister in place of ZooKeeper.
    """

    def __init__(self) -> None:
        self._root = _Node()
        self._lock = threading.RLock()

    # tree walking ----------------------------------------------------

    def _find(self, path: str) -> Optional[_Node]:
        node = self._root
        for part in normalize_path(path).split("/"):
            if not part:
                continue
            node = node.children.get(part)  # type: ignore[assignment]
            if node is None:
                return None
        return node

    def _ensure(self, path: str) -> _Node:
        node = self._root
        for part in normalize_path(path).split("/"):
            if not part:
                continue
            node = node.children.setdefault(part, _Node())
        return node

    # Persister -------------------------------------------------------

    def get(self, path: str) -> Optional[bytes]:
        with self._lock:
            node = self._find(path)
            if node is None:
                raise PersisterError(f"path not found: {path}", path)
            return node.value

    def set(self, path: str, value: bytes) -> None:
        if normalize_path(path) == "/":
            # the root carries no value: dump()/snapshots only cover
            # children, so a root value would silently vanish across
            # compaction — forbid it outright
            raise PersisterError("cannot store a value at '/'", path)
        with self._lock:
            self._ensure(path).value = value

    def ensure_node(self, path: str) -> None:
        """Create an empty node (tree shape without a value)."""
        with self._lock:
            self._ensure(path)

    def get_children(self, path: str) -> List[str]:
        with self._lock:
            node = self._find(path)
            if node is None:
                raise PersisterError(f"path not found: {path}", path)
            return sorted(node.children)

    def recursive_delete(self, path: str) -> None:
        with self._lock:
            norm = normalize_path(path)
            if norm == "/":
                self._root = _Node()
                return
            parent = self._find(parent_of(norm))
            name = norm.rsplit("/", 1)[1]
            if parent is None or name not in parent.children:
                raise PersisterError(f"path not found: {path}", path)
            del parent.children[name]

    def apply(self, ops: Iterable[TransactionOp]) -> None:
        with self._lock:
            ops = list(ops)
            # validate up front so the transaction is all-or-nothing
            for op in ops:
                if isinstance(op, DeleteOp) and self._find(op.path) is None:
                    raise PersisterError(f"path not found: {op.path}", op.path)
                if isinstance(op, SetOp) and normalize_path(op.path) == "/":
                    raise PersisterError("cannot store a value at '/'", op.path)
            for op in ops:
                if isinstance(op, SetOp):
                    self._ensure(op.path).value = op.value
                else:
                    try:
                        self.recursive_delete(op.path)
                    except PersisterError:
                        pass  # deleted by an earlier op in this txn

    # debugging -------------------------------------------------------

    def dump(self) -> Dict[str, Optional[bytes]]:
        """Flat {path: value} view of the whole tree (tests)."""
        out: Dict[str, Optional[bytes]] = {}

        def walk(node: _Node, path: str) -> None:
            for name, child in node.children.items():
                child_path = f"{path}/{name}" if path != "/" else f"/{name}"
                out[child_path] = child.value
                walk(child, child_path)

        with self._lock:
            walk(self._root, "/")
        return out

"""Write-through full-tree RAM cache over any Persister.

Reference: storage/PersisterCache.java — the reference wraps its
ZooKeeper persister in a full-tree cache to cut read round-trips;
disabled via DISABLE_STATE_CACHE (scheduler/SchedulerConfig.java).
Our FileWalPersister is already RAM-backed, but the cache matters for
future remote persisters (etcd) and preserves the reference contract.

Port of ``dcos_commons_tpu/storage/cache.py``,
line for line but the imports.
"""

from __future__ import annotations

import threading
from typing import Iterable, List, Optional

from dcos_commons_tpu_torch.storage.persister import (
    MemPersister,
    Persister,
    TransactionOp,
)


class PersisterCache(Persister):
    def __init__(self, backend: Persister) -> None:
        self._backend = backend
        self._lock = threading.RLock()
        self._cache = MemPersister()
        self._load()

    def _load(self) -> None:
        # Load errors must propagate and fail the boot: a partially
        # warmed cache would authoritatively answer "path not found"
        # for state that exists, making a running service look like a
        # fresh install.
        def walk(path: str) -> None:
            if path != "/":
                value = self._backend.get(path)
                if value is not None:
                    self._cache.set(path, value)
                else:
                    self._cache.ensure_node(path)
            for child in self._backend.get_children(path):
                walk(path.rstrip("/") + "/" + child)

        walk("/")

    def get(self, path: str) -> Optional[bytes]:
        with self._lock:
            return self._cache.get(path)

    def set(self, path: str, value: bytes) -> None:
        with self._lock:
            self._backend.set(path, value)
            self._cache.set(path, value)

    def get_children(self, path: str) -> List[str]:
        with self._lock:
            return self._cache.get_children(path)

    def recursive_delete(self, path: str) -> None:
        with self._lock:
            self._backend.recursive_delete(path)
            self._cache.recursive_delete(path)

    def apply(self, ops: Iterable[TransactionOp]) -> None:
        with self._lock:
            ops = list(ops)
            self._backend.apply(ops)
            self._cache.apply(ops)

    def close(self) -> None:
        self._backend.close()

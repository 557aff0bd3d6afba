"""L5 storage: pluggable hierarchical KV persistence (port of
``dcos_commons_tpu/storage/``: the persister interface, the in-memory
and the WAL-backed file persister, and the write-through cache).

Reference: sdk/scheduler/.../storage/Persister.java:15-99 (interface),
MemPersister.java (test impl), PersisterCache.java (write-through RAM
cache), curator/CuratorPersister.java:43-110 (ZooKeeper impl with
atomic multi-op transactions).

The WAL's bytes are the JAX package's: a directory written by either
package reads back in the other.  The remote persister, the state
server and its hot standbys are ``storage/remote.py`` and
``storage/replication.py``.
"""

from dcos_commons_tpu_torch.storage.persister import (
    DeleteOp,
    MemPersister,
    Persister,
    PersisterError,
    SetOp,
    StorageError,
)
from dcos_commons_tpu_torch.storage.file_persister import FileWalPersister
from dcos_commons_tpu_torch.storage.cache import PersisterCache

__all__ = [
    "DeleteOp",
    "FileWalPersister",
    "MemPersister",
    "Persister",
    "PersisterCache",
    "PersisterError",
    "SetOp",
    "StorageError",
]

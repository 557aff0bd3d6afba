"""Schema versioning for the persisted tree.

Reference: state/SchemaVersionStore.java — a stored integer checked at
startup; an unsupported version aborts before any writes happen.

Port of ``dcos_commons_tpu/state/schema.py``,
line for line but the imports.
"""

from __future__ import annotations

from dcos_commons_tpu_torch.storage import Persister


class SchemaVersionStore:
    PATH = "/schema-version"
    CURRENT = 1

    def __init__(self, persister: Persister) -> None:
        self._persister = persister

    def fetch(self) -> int:
        raw = self._persister.get_or_none(self.PATH)
        return int(raw.decode("utf-8")) if raw else 0

    def store(self, version: int) -> None:
        self._persister.set(self.PATH, str(version).encode("utf-8"))

    def check(self) -> None:
        """Initialize on first boot; abort on incompatible schema."""
        existing = self.fetch()
        if existing == 0:
            self.store(self.CURRENT)
        elif existing != self.CURRENT:
            raise RuntimeError(
                f"unsupported schema version {existing} "
                f"(supported: {self.CURRENT}); refusing to start"
            )

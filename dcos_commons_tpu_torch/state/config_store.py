"""ConfigStore: UUID -> serialized ServiceSpec, plus target pointer.

Reference: state/ConfigStore.java — configs are content-addressed by
UUID; a separate "target" pointer names the config tasks should be
running.  Config updates store a new UUID then flip the pointer
(config/DefaultConfigurationUpdater.java:159).

Port of ``dcos_commons_tpu/state/config_store.py``,
line for line but the imports.
"""

from __future__ import annotations

import json
import uuid as uuid_mod
from typing import Any, Dict, List, Optional

from dcos_commons_tpu_torch.storage import Persister
from dcos_commons_tpu_torch.storage.persister import namespace_root, validate_key


class ConfigStore:
    """Stores configs as JSON dicts; the spec layer provides codecs."""

    def __init__(self, persister: Persister, namespace: str = "") -> None:
        self._persister = persister
        self._root = namespace_root(namespace)

    def _path(self, leaf: str) -> str:
        return f"{self._root}/{leaf}"

    def _config_path(self, config_id: str) -> str:
        validate_key(config_id, "config id")
        return self._path(f"configurations/{config_id}")

    def store(self, config: Dict[str, Any]) -> str:
        config_id = str(uuid_mod.uuid4())
        # NO sort_keys: plan phase order is semantic (journal -> name
        # -> data) and json round-trips preserve insertion order
        self._persister.set(
            self._config_path(config_id),
            json.dumps(config).encode("utf-8"),
        )
        return config_id

    def fetch(self, config_id: str) -> Optional[Dict[str, Any]]:
        raw = self._persister.get_or_none(self._config_path(config_id))
        return json.loads(raw.decode("utf-8")) if raw is not None else None

    def list_ids(self) -> List[str]:
        return self._persister.get_children_or_empty(self._path("configurations"))

    def clear(self, config_id: str) -> None:
        from dcos_commons_tpu_torch.storage import PersisterError

        path = self._config_path(config_id)  # validates the id
        try:
            self._persister.recursive_delete(path)
        except PersisterError:
            pass  # missing config: already cleared

    # -- target pointer ----------------------------------------------

    def set_target_config(self, config_id: str) -> None:
        validate_key(config_id, "config id")
        self._persister.set(
            self._path("config-target"), config_id.encode("utf-8")
        )

    def get_target_config(self) -> Optional[str]:
        raw = self._persister.get_or_none(self._path("config-target"))
        return raw.decode("utf-8") if raw is not None else None

    def fetch_target(self) -> Optional[Dict[str, Any]]:
        target = self.get_target_config()
        return self.fetch(target) if target else None

    # -- GC (reference: DefaultConfigurationUpdater cleanup of configs
    #    no longer referenced by any task) ---------------------------

    def prune(self, referenced_ids: List[str]) -> List[str]:
        keep = set(referenced_ids)
        target = self.get_target_config()
        if target:
            keep.add(target)
        removed = []
        for config_id in self.list_ids():
            if config_id not in keep:
                self.clear(config_id)
                removed.append(config_id)
        return removed


class OptionsStore:
    """Persisted operator option overrides (the live `update` flow).

    Reference: the Cosmos options JSON a package `update` pushes onto
    a running scheduler.  A store class so the runner's option writes
    flow through the same wired (lease-fenced, in HA mode) persister
    as every other scheduler-path mutation — sdklint's
    ``lease-gated-mutation`` rule bans raw persister writes there.
    """

    NODE = "service_options"

    def __init__(self, persister: Persister) -> None:
        self._persister = persister

    def fetch(self) -> Dict[str, str]:
        raw = self._persister.get_or_none(self.NODE)
        if not raw:
            return {}
        try:
            data = json.loads(raw.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            return {}
        return {
            str(k): str(v) for k, v in data.items()
        } if isinstance(data, dict) else {}

    def store(self, options: Dict[str, str]) -> None:
        self._persister.set(
            self.NODE,
            json.dumps(options, sort_keys=True).encode("utf-8"),
        )

    # raw snapshot/restore: the runner's rebuild-failure rollback must
    # reproduce the EXACT pre-update bytes (or absence)

    def snapshot_raw(self) -> Optional[bytes]:
        return self._persister.get_or_none(self.NODE)

    def restore_raw(self, raw: Optional[bytes]) -> None:
        from dcos_commons_tpu_torch.storage import PersisterError

        if raw is None:
            try:
                self._persister.recursive_delete(self.NODE)
            except PersisterError:
                pass  # nothing to roll back
        else:
            self._persister.set(self.NODE, raw)

"""ServiceStore: persisted specs of dynamically added services.

Reference: scheduler/multi/ServiceStore.java + ServiceFactory — raw
spec payloads stored per service name so a restarted multi-scheduler
re-creates every service, including ones mid-uninstall.

Port of ``dcos_commons_tpu/multi/store.py``, line for line but the
imports.
"""

from __future__ import annotations

import json
from typing import List, Optional

from dcos_commons_tpu_torch.storage import Persister, PersisterError
from dcos_commons_tpu_torch.storage.persister import validate_key

ROOT = "/multi/services"


class ServiceStore:
    def __init__(self, persister: Persister):
        self._persister = persister

    def _path(self, name: str) -> str:
        validate_key(name, "service name")
        return f"{ROOT}/{name}"

    def store(self, name: str, spec_dict: dict, uninstalling: bool = False,
              options: Optional[dict] = None) -> None:
        # options = the operator's raw user-options JSON (the Cosmos
        # plane): kept so upgrades re-render with prior choices when
        # none are passed, exactly like `dcos package update`
        payload = json.dumps(
            {
                "spec": spec_dict,
                "uninstalling": uninstalling,
                "options": options or {},
            },
            sort_keys=True,
        ).encode("utf-8")
        self._persister.set(self._path(name), payload)

    def fetch(self, name: str) -> Optional[dict]:
        raw = self._persister.get_or_none(self._path(name))
        return json.loads(raw.decode("utf-8")) if raw is not None else None

    def list_names(self) -> List[str]:
        return sorted(self._persister.get_children_or_empty(ROOT))

    def remove(self, name: str) -> None:
        try:
            self._persister.recursive_delete(self._path(name))
        except PersisterError:
            pass

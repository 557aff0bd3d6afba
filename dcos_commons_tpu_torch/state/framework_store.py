"""FrameworkStore: the control plane's own registration identity.

Reference: state/FrameworkStore.java — stores the Mesos FrameworkID so
a restarted scheduler re-registers as the same framework.  In the
rebuild the analogue is the framework instance id plus the coordinator
address it allocated for the process-group rendezvous — both must
survive scheduler restart so running pods keep their rendezvous point.

Port of ``dcos_commons_tpu/state/framework_store.py``,
line for line but the imports.
"""

from __future__ import annotations

import json
import uuid
from typing import Optional

from dcos_commons_tpu_torch.storage import Persister, PersisterError


class FrameworkStore:
    ID_PATH = "/framework-id"
    COORD_PATH = "/coordinator-address"

    def __init__(self, persister: Persister) -> None:
        self._persister = persister

    def store_framework_id(self, framework_id: str) -> None:
        self._persister.set(self.ID_PATH, framework_id.encode("utf-8"))

    def fetch_framework_id(self) -> Optional[str]:
        raw = self._persister.get_or_none(self.ID_PATH)
        return raw.decode("utf-8") if raw is not None else None

    def get_or_create_framework_id(self) -> str:
        existing = self.fetch_framework_id()
        if existing:
            return existing
        framework_id = uuid.uuid4().hex
        self.store_framework_id(framework_id)
        return framework_id

    def clear_framework_id(self) -> None:
        """Reference: uninstall DeregisterStep clears the FrameworkID."""
        try:
            self._persister.recursive_delete(self.ID_PATH)
        except PersisterError:
            pass

    # -- coordinator addresses (per pod-type) ------------------------

    def store_coordinator_address(self, pod_type: str, address: str) -> None:
        addrs = self._fetch_addrs()
        addrs[pod_type] = address
        self._persister.set(
            self.COORD_PATH, json.dumps(addrs, sort_keys=True).encode("utf-8")
        )

    def fetch_coordinator_address(self, pod_type: str) -> Optional[str]:
        return self._fetch_addrs().get(pod_type)

    def _fetch_addrs(self) -> dict:
        raw = self._persister.get_or_none(self.COORD_PATH)
        return json.loads(raw.decode("utf-8")) if raw is not None else {}

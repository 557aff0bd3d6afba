"""Element: the common contract of Plan/Phase/Step.

Reference: scheduler/plan/Element.java:18 (name/status/errors),
Interruptible.java (interrupt/proceed), ParentElement.

Port of ``dcos_commons_tpu/plan/element.py``,
line for line but the imports.
"""

from __future__ import annotations

import threading
import uuid
from typing import List

from dcos_commons_tpu_torch.plan.status import Status


class Element:
    def __init__(self, name: str):
        self.id = uuid.uuid4().hex
        self.name = name
        self.errors: List[str] = []
        self._lock = threading.RLock()

    # Status ----------------------------------------------------------

    def get_status(self) -> Status:  # pragma: no cover - abstract
        raise NotImplementedError

    @property
    def is_complete(self) -> bool:
        return self.get_status().is_complete

    @property
    def is_pending(self) -> bool:
        return self.get_status() is Status.PENDING

    @property
    def is_running(self) -> bool:
        return self.get_status().is_running

    def has_errors(self) -> bool:
        return bool(self.errors)

    # Interruptible ---------------------------------------------------
    # (reference: Interruptible.java; plans/phases park work via
    #  /v1/plans/<plan>/interrupt, PlansQueries.java:47-231)

    def interrupt(self) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def proceed(self) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def is_interrupted(self) -> bool:
        return False

    # Restart / force-complete ---------------------------------------

    def restart(self) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def force_complete(self) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

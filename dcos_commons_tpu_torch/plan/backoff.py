"""Launch backoff for crash-looping pods.

Reference: scheduler/plan/backoff/ — ExponentialBackoff.java:30-50
(initial * factor^attempts, capped at max; cleared on success) and
DisabledBackoff.java.  A backed-off step reads DELAYED
(DeploymentStep.java:176-182).

Port of ``dcos_commons_tpu/plan/backoff.py``,
line for line but the imports.
"""

from __future__ import annotations

import threading
from typing import Dict


class Backoff:
    def next_delay(self, key: str) -> float:
        """Record a failure for ``key``; return seconds to delay."""
        raise NotImplementedError

    def clear(self, key: str) -> None:
        raise NotImplementedError

    def current_delay(self, key: str) -> float:
        raise NotImplementedError


class DisabledBackoff(Backoff):
    def next_delay(self, key: str) -> float:
        return 0.0

    def clear(self, key: str) -> None:
        pass

    def current_delay(self, key: str) -> float:
        return 0.0


class ExponentialBackoff(Backoff):
    def __init__(
        self,
        initial_s: float = 1.0,
        factor: float = 1.15,
        max_s: float = 300.0,
    ):
        if initial_s <= 0 or factor < 1.0 or max_s < initial_s:
            raise ValueError("bad backoff parameters")
        self._initial = initial_s
        self._factor = factor
        self._max = max_s
        self._attempts: Dict[str, int] = {}
        self._lock = threading.Lock()

    def next_delay(self, key: str) -> float:
        with self._lock:
            attempts = self._attempts.get(key, 0)
            self._attempts[key] = attempts + 1
            return min(self._initial * (self._factor ** attempts), self._max)

    def clear(self, key: str) -> None:
        with self._lock:
            self._attempts.pop(key, None)

    def current_delay(self, key: str) -> float:
        with self._lock:
            attempts = self._attempts.get(key, 0)
            if attempts == 0:
                return 0.0
            return min(self._initial * (self._factor ** (attempts - 1)), self._max)

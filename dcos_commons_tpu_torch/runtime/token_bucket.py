"""Token bucket rate limiter.

Reference: framework/TokenBucket.java — bounds revive calls so a
flapping work-set cannot hammer the master; we use it to bound
full-inventory rescans and log storms.

Port of ``dcos_commons_tpu/runtime/token_bucket.py``, line for line but the imports.
"""

from __future__ import annotations

import threading
import time


class TokenBucket:
    def __init__(self, capacity: int = 256, refill_interval_s: float = 5.0,
                 clock=time.monotonic):
        if capacity < 1 or refill_interval_s <= 0:
            raise ValueError("bad token bucket parameters")
        self._capacity = capacity
        self._tokens = capacity
        self._interval = refill_interval_s
        self._clock = clock
        self._last_refill = clock()
        self._lock = threading.Lock()

    def try_acquire(self) -> bool:
        with self._lock:
            now = self._clock()
            refills = int((now - self._last_refill) / self._interval)
            if refills > 0:
                self._tokens = min(self._capacity, self._tokens + refills)
                self._last_refill += refills * self._interval
            if self._tokens > 0:
                self._tokens -= 1
                return True
            return False

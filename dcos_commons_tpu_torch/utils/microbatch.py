"""Dispatch-per-group serving micro-batcher (LEGACY for serving).

One decode step costs nearly the same wall time for 1 or N rows, so
concurrent clients that would otherwise serialize behind the chip are
collected into ONE generate dispatch.  Grouping is by temperature
only (one traced scalar per batch); prompt LENGTHS mix freely because
the compiled function takes a per-row true_len vector
(models/decode.py).

The serve workers no longer use this path: the continuous-batching
slot engine (dcos_commons_tpu/serve/) subsumed it — per-step
admission into a persistent KV slot pool instead of whole-generate
dispatches — and inherits the liveness rules below (FIFO admission,
queue-timeout removal, idle callback).  This class remains as the
honest baseline ``bench_continuous_serve`` measures against, the
generic micro-batching utility, and the home of ``QueueTimeoutError``
(the saturation signal both paths raise and HTTP handlers map to
503).

Liveness rules this class guarantees (the engine inherits them —
the two servers previously diverged and each copy had its own bug):

* FIFO with head-always-dispatches: the oldest pending item is ALWAYS
  in the dispatched group, so a request whose key matches nothing
  (or that repeatedly loses capacity races) cannot starve behind a
  stream of mergeable peers.
* Abandoned work never reaches the chip: a submit() that times out
  removes its item from the queue — a wedged dispatch must not leave
  a backlog of dead requests consuming group capacity on recovery.
* Idle callback: an SPMD gang must keep meeting in collectives even
  with no traffic (followers park in the broadcast); ``on_idle``
  fires every ``idle_every_s`` while the queue is empty, OUTSIDE the
  queue lock.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional

import numpy as np


class QueueTimeoutError(RuntimeError):
    """A request expired waiting for chip capacity (the batcher's
    queue timeout, or the serving engine's admission queue).  This
    is server SATURATION, not caller error: HTTP handlers map it to
    503 so load generators and clients can tell overload apart from a
    400 bad request.

    ``kind`` names the starved resource so operators can tell
    saturation-by-memory from saturation-by-compute in the 503 body
    and the split timeout counters (serve/engine.py stats):

    * ``kv-page-budget`` — the request's worst-case KV page need
      never fit the paged arena's budget (memory saturation: add
      pages/HBM, shrink MAX_LEN, or rely on prefix caching);
    * ``kv-slot`` — no decode row freed up (concurrency saturation);
    * ``stalled`` — admitted but the pool produced no new token for a
      full window (compute saturation or a wedged device).
    """

    def __init__(self, message: str = "", kind: str = "kv-slot"):
        super().__init__(message)
        self.kind = kind


class WorkItem:
    __slots__ = ("rows", "n", "temp", "done", "result", "error")

    def __init__(self, rows, n, temp):
        self.rows = rows          # list[list[int]], already validated
        self.n = n                # per-item reply slice length
        self.temp = temp
        self.done = threading.Event()
        self.result = None        # list[list[int]] once served
        self.error = None


class MicroBatcher:
    """Collect concurrent requests into one dispatch.

    ``run_group(items)`` fills each item's ``result`` (or raises — the
    error fans out to the whole group).  A window (seconds) after the
    first arrival lets concurrent clients join the batch; a FULL batch
    dispatches immediately.
    """

    def __init__(
        self,
        run_group: Callable[[List[WorkItem]], None],
        capacity: int,
        window_s: float,
        queue_timeout_s: float = 600.0,
        on_idle: Optional[Callable[[], None]] = None,
        idle_every_s: float = 0.05,
    ):
        self._run_group = run_group
        self._capacity = capacity
        self._window_s = window_s
        self._queue_timeout_s = queue_timeout_s
        self._on_idle = on_idle
        self._idle_every_s = idle_every_s
        self._cv = threading.Condition()
        self._pending: List[WorkItem] = []
        self._thread = threading.Thread(
            target=self._loop, name="microbatch", daemon=True
        )
        self._thread.start()

    def submit(self, item: WorkItem):
        with self._cv:
            self._pending.append(item)
            self._cv.notify()
        if not item.done.wait(timeout=self._queue_timeout_s):
            with self._cv:
                # abandoned work must not reach the chip later: a
                # wedged dispatch would otherwise leave a backlog of
                # dead requests ahead of live ones on recovery
                try:
                    self._pending.remove(item)
                except ValueError:
                    pass  # already grouped: the result will be dropped
            raise QueueTimeoutError(
                "generate timed out in the batch queue"
            )
        if item.error is not None:
            raise item.error
        return item.result

    def _rows_pending(self) -> int:
        return sum(len(item.rows) for item in self._pending)

    def _loop(self):
        while True:
            with self._cv:
                while not self._pending:
                    if self._on_idle is None:
                        self._cv.wait()
                    else:
                        self._cv.wait(timeout=self._idle_every_s)
                        if not self._pending:
                            break  # fire on_idle OUTSIDE the lock
                if not self._pending:
                    idle = True
                    group = []
                else:
                    idle = False
                    if self._window_s > 0:
                        # recruit peers for up to the window — but a
                        # FULL batch dispatches immediately (the window
                        # is only paid when it can still buy merging)
                        import time

                        deadline = time.monotonic() + self._window_s
                        while self._rows_pending() < self._capacity:
                            remaining = deadline - time.monotonic()
                            if remaining <= 0:
                                break
                            self._cv.wait(timeout=remaining)
                    if not self._pending:
                        continue  # sole item timed out and removed itself
                    # the head ALWAYS dispatches: grouping by key
                    # equality alone would starve a head whose key
                    # never equals itself (e.g. a NaN temperature that
                    # slipped past validation) and stall every request
                    # queued behind it.  Rejected peers KEEP their
                    # positions — they become the head soon.
                    head = self._pending[0]
                    group, rest, used = [head], [], len(head.rows)
                    for item in self._pending[1:]:
                        if (
                            item.temp == head.temp
                            and used + len(item.rows) <= self._capacity
                        ):
                            group.append(item)
                            used += len(item.rows)
                        else:
                            rest.append(item)
                    self._pending = rest
            if idle:
                try:
                    self._on_idle()
                except Exception:  # noqa: BLE001, sdklint: disable=swallowed-exception — idle hook must not kill serving
                    pass
                continue
            try:
                self._run_group(group)
            except Exception as e:  # noqa: BLE001 — fan the error out
                for item in group:
                    item.error = e
            for item in group:
                item.done.set()


def pack_mixed_rows(group: List[WorkItem], batch: int, prompt_len: int):
    """Right-pad a group's rows into one [batch, prompt_len] prompt
    plus the per-row true_len vector (unused slots get length 1 so
    their discarded computation stays well-formed).  Returns
    (prompt, lens, rows_used)."""
    prompt = np.zeros((batch, prompt_len), np.int32)
    lens = np.ones((batch,), np.int32)
    i = 0
    for item in group:
        for row in item.rows:
            prompt[i, : len(row)] = row
            lens[i] = len(row)
            i += 1
    return prompt, lens, i


def unpack_results(group: List[WorkItem], out) -> None:
    """De-interleave one dispatch's [batch, new_tokens] output back
    into each item's result, sliced to its requested length."""
    i = 0
    for item in group:
        item.result = [
            [int(t) for t in out[i + r, : item.n]]
            for r in range(len(item.rows))
        ]
        i += len(item.rows)

"""Worker-side step telemetry: append-only JSONL in the sandbox (port of
``dcos_commons_tpu/trace/steplog.py``).

The scheduler's flight recorder sees the control plane; the worker's
step loop is invisible to it.  ``StepLog`` closes that gap from
the task side: each training/serving step appends one JSON line
(step index, wall seconds, tokens, seconds blocked waiting for the
gang before the step's first collective) to ``steplog.jsonl`` in the
task sandbox.  The agent's sandbox plumbing (``LocalProcessAgent.
steplog_of``) surfaces the file and the scheduler's ``/v1/debug/trace``
exporters merge it into the same timeline — per-host step lanes make
gang skew directly visible (host 3's ``blocked_s`` IS the skew the
other hosts imposed on it).

Telemetry must never take a worker down: write failures are counted
(``errors``) and otherwise ignored.

What differs from the JAX module is readiness.  A JAX result is a
future: blocking on step N-k's result waits for step N-k alone.  A
torch tensor is not: ``.item()`` on step N-k's loss enqueues its copy
behind everything already on the stream, step N included.  So the
window marks each result when it is PUSHED (``_default_mark``: a
non-blocking copy of the loss into pinned host memory and a CUDA event
behind it, both enqueued right after the step) and, when it drains the
step, waits on that event alone (``_default_ready``).  It never blocks
on the step just dispatched.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, List, Optional, Tuple

import torch

STEPLOG_NAME = "steplog.jsonl"


class StepLog:
    """Appends one JSON record per step; flushes per record so a gang
    worker killed mid-run leaves a readable log."""

    def __init__(self, path: Optional[str] = None):
        # the scheduler's env contract puts every task in a sandbox
        # ($SANDBOX, agent/local.py); outside one, log to cwd
        self.path = path or os.path.join(
            os.environ.get("SANDBOX", "."), STEPLOG_NAME
        )
        self.errors = 0
        self._fh = None

    def record(self, step: int, **fields) -> None:
        entry = {"step": int(step), "t": time.time()}
        entry.update(fields)
        try:
            if self._fh is None:
                self._fh = open(self.path, "a", encoding="utf-8")
            self._fh.write(json.dumps(entry) + "\n")
            self._fh.flush()
        except (OSError, ValueError, TypeError):
            # telemetry is best-effort: a full disk or closed handle
            # must not kill the training step that produced the record
            self.errors += 1

    def close(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                self.errors += 1
            self._fh = None


class _Marked:
    """A CUDA result copied to pinned host memory, and the event
    recorded behind that copy."""

    __slots__ = ("host", "event")

    def __init__(self, host: torch.Tensor, event: "torch.cuda.Event"):
        self.host = host
        self.event = event


def _default_mark(result: Any) -> Any:
    """At dispatch: start a CUDA tensor's copy to the host and record an
    event behind it.  Anything else is returned as it is."""
    if not (isinstance(result, torch.Tensor) and result.is_cuda):
        return result
    host = torch.empty(result.shape, dtype=result.dtype, pin_memory=True)
    host.copy_(result.detach(), non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return _Marked(host, event)


def _default_ready(marked: Any) -> Any:
    """Block until a marked result is on the host and return it there
    (the pushed step's work and nothing after it)."""
    if isinstance(marked, _Marked):
        marked.event.synchronize()
        return marked.host
    return marked


class InflightWindow:
    """Bounded async-dispatch window with per-step wall accounting.

    Under async dispatch the host runs ahead of the devices: step N's
    jit call returns in microseconds and the host only blocks when the
    window is full — on step N−k's result, not step N's.  Naive timing
    then records dispatch time as ``wall_s`` and the NEXT step's
    barrier probe absorbs this step's compute and reports it as gang
    skew (the trap PR 5 already hit once, solved then by blocking
    every step — which is exactly the serialization this window
    removes).  The books stay straight by billing each step the wall
    time between ITS result becoming ready and the previous step's:
    in a saturated pipeline that is precisely the device time the step
    added to the run, and during pipeline fill the first step absorbs
    the fill cost it incurred.  ``blocked_s`` stays whatever the
    caller measured BEFORE dispatching the step (the barrier probe
    meets the gang at dispatch order, so its wait is still the skew
    the slow host imposed at that point).

    ``window=0`` degenerates to the synchronous loop: every ``push``
    drains immediately and ``wall_s`` spans dispatch start to ready —
    byte-identical accounting to the pre-overlap worker.

    ``mark_fn`` runs on each result as it is pushed, ``ready_fn`` on
    the marked result as it drains; the drained result handed back is
    what ``ready_fn`` returns (for a CUDA loss, its host copy).
    """

    def __init__(
        self,
        steplog: StepLog,
        window: int = 2,
        ready_fn: Callable[[Any], Any] = _default_ready,
        mark_fn: Callable[[Any], Any] = _default_mark,
    ):
        self.steplog = steplog
        self.window = max(0, int(window))
        self._ready = ready_fn
        self._mark = mark_fn
        self._pending: List[Tuple[int, Any, float, float, dict]] = []
        self._last_ready: Optional[float] = None
        self.drained = 0

    def push(
        self, step: int, result: Any, dispatched_t: float,
        blocked_s: float = 0.0, **fields,
    ) -> List[Tuple[int, Any]]:
        """Admit a dispatched step; drains (blocks on) the oldest
        steps beyond the window.  ``dispatched_t`` is when the step
        STARTED on the host (before its data fetch + dispatch), so the
        degenerate window=0 spelling times what the old synchronous
        loop timed.  Returns the [(step, ready result)] drained now.
        """
        self._pending.append(
            (int(step), self._mark(result), float(dispatched_t),
             float(blocked_s), fields)
        )
        out: List[Tuple[int, Any]] = []
        while len(self._pending) > self.window:
            out.append(self._drain_one())
        return out

    def drain(self) -> List[Tuple[int, Any]]:
        """Drain every in-flight step (end of loop, or a fence before
        an action that must see the loop quiesced)."""
        out = []
        while self._pending:
            out.append(self._drain_one())
        return out

    def _drain_one(self) -> Tuple[int, Any]:
        step, marked, t0, blocked_s, fields = self._pending.pop(0)
        result = self._ready(marked)
        t_ready = time.time()
        # bill THIS step the wall clock since the previous step's
        # result was ready (or since its own dispatch, whichever is
        # later — an idle gap between steps is nobody's device time)
        since = t0 if self._last_ready is None else max(
            self._last_ready, t0
        )
        self._last_ready = t_ready
        self.steplog.record(
            step,
            wall_s=round(t_ready - since, 6),
            blocked_s=round(blocked_s, 6),
            **fields,
        )
        self.drained += 1
        return step, result


def read_steplog(path: str) -> List[dict]:
    """Parse a steplog file; malformed/truncated lines (a worker killed
    mid-write) are skipped, valid records around them survive."""
    out: List[dict] = []
    try:
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    record = json.loads(line)
                except ValueError:
                    continue
                if isinstance(record, dict):
                    out.append(record)
    except OSError:
        return []
    return out

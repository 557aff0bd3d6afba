"""TraceRecorder: a bounded in-memory flight recorder for spans.

The recorder is the one shared object of the tracing subsystem: spans
are minted here (``span()``/``event()``), finished spans land in a
thread-safe fixed-capacity ring buffer (drop-oldest — the recorder is
a FLIGHT recorder, not an archive), and the launch registry maps task
ids to the launch span that created them so a status arriving many
cycles later still joins its launch's correlation chain.

Overhead is bounded by design: a span is one small object + one
deque append under a leaf lock; a disabled recorder (``capacity=0``)
hands out a shared no-op span, so ``bench_trace_overhead`` can fence
the enabled-vs-disabled delta (<5% of the offer-cycle figure).
Ring overflow is observable: every evicted span increments the
``trace.dropped`` Metrics counter and the recorder's ``dropped``
count, which the exporters surface.

Port of ``dcos_commons_tpu/trace/recorder.py``,
line for line but the imports.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import List, NamedTuple, Optional

from dcos_commons_tpu_torch.trace.span import NullSpan, Span, new_id

DEFAULT_CAPACITY = 2048
# launch registry bound: old entries fall off; a status for a launch
# evicted here degrades to an uncorrelated event, never an error
LAUNCH_REGISTRY_CAP = 4096


class LaunchRef(NamedTuple):
    """Where a task id's launch lives in the trace."""

    trace_id: int
    span_id: int
    track: str


class TraceRecorder:
    def __init__(
        self,
        capacity: int = DEFAULT_CAPACITY,
        metrics=None,
        service: str = "",
    ):
        self.capacity = max(0, int(capacity))
        self.metrics = metrics
        self.service = service
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity or 1)
        self._dropped = 0
        self._launches: "OrderedDict[str, LaunchRef]" = OrderedDict()
        self._null = NullSpan()
        # wall/monotonic anchor pair: spans stamp time.monotonic()
        # (immune to clock steps); exporters add the offset back to
        # align with wall-clock sources like worker steplogs
        self.t0_wall = time.time()
        self.t0_mono = time.monotonic()

    @property
    def enabled(self) -> bool:
        return self.capacity > 0

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def wall_of(self, monotonic_s: float) -> float:
        """Convert a span stamp to wall seconds for export alignment."""
        return self.t0_wall + (monotonic_s - self.t0_mono)

    # -- minting ------------------------------------------------------

    def new_trace_id(self) -> int:
        return new_id()

    def span(
        self,
        name: str,
        parent: Optional[Span] = None,
        trace_id: int = 0,
        parent_id: int = 0,
        track: str = "",
        **attrs,
    ) -> Span:
        """Open a span.  ``parent`` (explicit, never ambient) supplies
        the trace id and parent span id; ``trace_id``/``parent_id``
        override it for cross-cycle correlation (status -> launch).
        The returned span MUST be closed via ``with`` or ``end()``."""
        if not self.enabled:
            return self._null
        if parent is not None and parent is not self._null:
            trace_id = trace_id or parent.trace_id
            parent_id = parent_id or parent.span_id
            track = track or parent.track
        return Span(
            name,
            trace_id=trace_id or self.new_trace_id(),
            parent_id=parent_id,
            track=track,
            attrs=attrs,  # stringified lazily at export (str_attrs)
            recorder=self,
        )

    def event(
        self,
        name: str,
        parent: Optional[Span] = None,
        trace_id: int = 0,
        parent_id: int = 0,
        track: str = "",
        **attrs,
    ) -> Span:
        """An instantaneous span (status arrival, step transition):
        opened and closed in one call, so it can never leak."""
        span = self.span(
            name, parent=parent, trace_id=trace_id, parent_id=parent_id,
            track=track, **attrs,
        )
        span.end()
        return span

    # -- the ring -----------------------------------------------------

    def _record(self, span: Span) -> None:
        overflowed = False
        with self._lock:
            if self.capacity and len(self._ring) >= self.capacity:
                self._dropped += 1
                overflowed = True
            self._ring.append(span)
        if overflowed and self.metrics is not None:
            self.metrics.incr("trace.dropped")

    def snapshot(self) -> List[Span]:
        """Recorded spans, oldest first (a copy; spans are settled —
        only finished spans enter the ring)."""
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._dropped = 0

    # -- launch registry ----------------------------------------------

    def register_launch(
        self, task_id: str, span: Span, track: str = ""
    ) -> None:
        """Remember which launch span created ``task_id`` so later
        status arrivals (and the plan-step transitions they trigger)
        join the launch's correlation chain."""
        if not self.enabled or span is self._null:
            return
        ref = LaunchRef(span.trace_id, span.span_id, track or span.track)
        with self._lock:
            self._launches[task_id] = ref
            self._launches.move_to_end(task_id)
            while len(self._launches) > LAUNCH_REGISTRY_CAP:
                self._launches.popitem(last=False)

    def launch_ref(self, task_id: str) -> Optional[LaunchRef]:
        with self._lock:
            return self._launches.get(task_id)


# the shared disabled recorder: layers that may be wired without a
# tracer (hand-built evaluators in tests) default to this and stay
# branch-free at every call site
NULL_TRACER = TraceRecorder(capacity=0)

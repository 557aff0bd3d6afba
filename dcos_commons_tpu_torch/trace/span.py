"""Span: one timed region of the control plane's causal timeline.

A span is created by ``TraceRecorder.span()`` with an EXPLICIT parent
(``trace.span("evaluate", parent=cycle_span)``) — there is no implicit
thread-local/contextvar ambient context to thread through the
JIT-adjacent layers, so a span's lineage is always visible at the call
site.  Spans carry:

* ``trace_id`` — the correlation id shared by everything one offer
  cycle caused (minted by the root span, inherited through parents and
  the launch registry);
* ``span_id``/``parent_id`` — the tree within a trace;
* monotonic start/end stamps (exporters convert to wall time);
* string key/value ``attrs`` (failing requirement, task ids, states);
* ``track`` — the export lane (Chrome ``tid``): "scheduler", a pod
  instance like "trainer-2", or "plan".

Spans must be CLOSED on every path — ``with`` or an explicit
``end()`` — or the flight recorder never sees them and their children
dangle; sdklint's ``span-leak`` rule enforces this.

Port of ``dcos_commons_tpu/trace/span.py``,
line for line but the imports.
"""

from __future__ import annotations

import itertools
import os
import time
from typing import Dict, Optional

# span/trace ids: process-random prefix + monotonic counter.  uuid4
# reads os.urandom per call (tens of µs on syscall-bound kernels) —
# 40µs x ~8 spans/cycle would blow the recorder's <5% overhead bound
# all by itself.  One urandom read at import keeps ids unique across
# processes; the counter keeps them unique within one.  The hot path
# hands out the cheap counter value; the prefix is applied when an id
# is RENDERED for export (render_id) — live spans compare ids, they
# never print them.
_ID_PREFIX = os.urandom(4).hex()
_ID_COUNTER = itertools.count(1)


def new_id() -> int:
    return next(_ID_COUNTER)


def render_id(span_or_trace_id) -> str:
    """Export-time form of an id: stable, process-unique hex."""
    if not span_or_trace_id:
        return ""
    return f"{_ID_PREFIX}{span_or_trace_id:08x}"


class Span:
    """A live span; recorded into the recorder's ring buffer on end().

    Context-manager use is the norm::

        with tracer.span("evaluate", parent=cycle) as span:
            span.set_attr("pod", pod.type)
    """

    __slots__ = (
        "name", "trace_id", "span_id", "parent_id", "track",
        "start_s", "end_s", "attrs", "_recorder", "_dropped",
    )

    def __init__(
        self,
        name: str,
        trace_id: int,
        parent_id: int = 0,
        track: str = "",
        attrs: Optional[Dict[str, object]] = None,
        recorder=None,
    ):
        self.name = name
        self.trace_id = trace_id
        self.span_id = new_id()
        self.parent_id = parent_id
        self.track = track
        self.start_s = time.monotonic()
        self.end_s: Optional[float] = None
        # NOT copied: the recorder hands over a per-call kwargs dict
        self.attrs: Dict[str, object] = attrs if attrs is not None else {}
        self._recorder = recorder
        self._dropped = False

    # -- lifecycle ----------------------------------------------------

    def set_attr(self, key: str, value) -> "Span":
        # values stringify lazily at export (attrs_text/to_chrome):
        # the hot path pays one dict store, not a str() per attribute
        self.attrs[key] = value
        return self

    def str_attrs(self) -> Dict[str, str]:
        """Attrs with values stringified — the export-time form."""
        return {k: str(v) for k, v in self.attrs.items()}

    def drop(self) -> None:
        """Mark this span uninteresting (an idle heartbeat cycle): it
        still closes normally but is not recorded, keeping the bounded
        flight recorder for cycles that did work."""
        self._dropped = True

    def end(self) -> None:
        """Idempotent close; records into the ring buffer once."""
        if self.end_s is not None:
            return
        self.end_s = time.monotonic()
        if not self._dropped and self._recorder is not None:
            self._recorder._record(self)

    @property
    def duration_s(self) -> float:
        end = self.end_s if self.end_s is not None else time.monotonic()
        return end - self.start_s

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> bool:
        self.end()
        return False

    def __repr__(self) -> str:  # debugging aid, not an export format
        state = "open" if self.end_s is None else f"{self.duration_s:.6f}s"
        return (
            f"Span({self.name!r}, trace={render_id(self.trace_id)}, "
            f"track={self.track!r}, {state})"
        )


class NullSpan(Span):
    """The no-op span a disabled recorder hands out: every operation is
    safe and free, so call sites never branch on tracing-enabled."""

    def __init__(self):
        super().__init__("", trace_id=0, recorder=None)
        self.end_s = self.start_s

    def set_attr(self, key: str, value) -> "Span":
        return self

    def drop(self) -> None:
        pass

    def end(self) -> None:
        pass

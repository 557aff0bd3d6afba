"""Profiler ranges with fixed names in the serving path: the engine's
loop (``engine.*``), the pool's entry points (``pool.*``) and the
decode trunk's phases (``trunk.*``).

``with profiled("pool.decode"): ...`` opens a record-function range
while a profiler records on the calling thread, so the range lands in
the Kineto trace beside the kernels it launched, on their clock.  The
control plane's ``Span`` and ``TraceRecorder`` stamp the host's
monotonic clock into a ring buffer and have no device lane; these
ranges are for reading a device trace.

Cost with no profiler running: one check, no range.  An unguarded
``torch.profiler.record_function`` costs ~9-14 us on a host CPU even
then, and a decode step passes ~170 range sites.  With a profiler
running the range is the profiler's fast record function (~2 us a
range, where ``record_function`` takes ~15 us through two dispatcher
calls); it is recorded as a ``cpu_op`` event rather than a
``user_annotation``.  A torch without that private class gets
``record_function`` instead.  Where ``torch`` was never imported no profiler
can run, so the engine and the scheduler (which imports this package)
never load torch for it.

A range decides at entry: one entered while no profiler recorded stays
closed to its exit, even if profiling starts inside it.

Every name is a fixed string (no index, no layer number), so a trace's
readers sum a range's time across ticks and layers.
"""

from __future__ import annotations

import sys
from contextlib import nullcontext

_CLOSED = nullcontext()


_open = None  # the range's constructor, resolved at the first range


def _constructor(torch):
    global _open
    if _open is None:
        _open = getattr(torch._C._profiler, "_RecordFunctionFast",
                        torch.profiler.record_function)
    return _open


def profiled(name: str):
    """A record-function range named ``name`` if a profiler records on
    this thread now, else a shared null context."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd._profiler_enabled():
        return _CLOSED
    return _constructor(torch)(name)

"""The port's own profiler ranges in a traced window: ``engine.*`` (the
serving loop), ``pool.*`` (the pool's entry points and its sampling)
and ``trunk.*`` (the decode trunk's phases), which
``dcos_commons_tpu_torch/trace/ranges.py`` opens while a profiler
records.  A program without them (an older commit) gives none, and
each reading here is then None.

All times in the trace's microseconds; ranges nest by time on their
thread, as ``lib/trace.py`` reads them.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

Interval = Tuple[float, float]


def spans(trace, names: Sequence[str]) -> List[dict]:
    """The host ranges of ``trace`` (a ``lib.trace.Trace``) named
    ``names``, or whose name starts with one ending in ``.``."""
    exact = {n for n in names if not n.endswith(".")}
    prefixes = tuple(n for n in names if n.endswith("."))
    return [e for e in trace.host if e["name"] in exact
            or (prefixes and e["name"].startswith(prefixes))]


def _clipped(trace, events) -> List[Interval]:
    """The events' intervals within the window, merged."""
    out: List[List[float]] = []
    for a, b in sorted((max(float(e["ts"]), trace.t0),
                        min(float(e["ts"] + e["dur"]), trace.t1))
                       for e in events):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _overlap(xs: List[Interval], ys: List[Interval]) -> float:
    """Length of the intersection of two sorted, merged interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_split(trace) -> Optional[Tuple[float, float]]:
    """(idle us outside every ``pool.*`` range, idle us inside one) of
    the window: the card runs nothing, and the loop thread is in the
    engine's own code or in the pool's.  They sum to the window's idle
    time.  None without device work or without ``pool.*`` ranges."""
    if trace is None or not trace.device:
        return None
    pool = _clipped(trace, spans(trace, ["pool."]))
    if not pool:
        return None
    edges = [trace.t0] + [x for ab in trace.busy_intervals for x in ab] \
        + [trace.t1]
    idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    in_pool = _overlap(idle, pool)
    return sum(b - a for a, b in idle) - in_pool, in_pool


def share_of_window(trace, us: float) -> float:
    return 100.0 * us / (trace.t1 - trace.t0)


def within(inner: dict, outers: List[dict]) -> bool:
    """Whether ``inner`` lies wholly in one of ``outers`` on its thread."""
    a, b = inner["ts"], inner["ts"] + inner["dur"]
    return any(o["tid"] == inner["tid"] and o["ts"] <= a
               and b <= o["ts"] + o["dur"] for o in outers)


class _Starts:
    """Ranges of one kind that do not overlap on a thread, by thread,
    to find the one a host op starts in."""

    def __init__(self, events: List[dict]):
        self.by_tid: Dict[int, List[Interval]] = defaultdict(list)
        for e in events:
            self.by_tid[e["tid"]].append((e["ts"], e["ts"] + e["dur"]))
        for spans_ in self.by_tid.values():
            spans_.sort()
        self.starts = {tid: [a for a, _b in s]
                       for tid, s in self.by_tid.items()}

    def holds(self, op: dict) -> bool:
        spans_ = self.by_tid.get(op["tid"])
        if not spans_:
            return False
        i = bisect.bisect_right(self.starts[op["tid"]], op["ts"]) - 1
        return i >= 0 and op["ts"] < spans_[i][1]


def device_us_launched_in(trace, outer: str, inner: Sequence[str]
                          ) -> Optional[Tuple[float, float]]:
    """(device us of the work launched inside ``outer`` ranges and
    inside one of the ``inner`` ranges too, device us of all the work
    launched inside ``outer`` ranges), over the window's device work: a
    device operation is launched where the host op of its
    ``External id`` starts.  None without ``outer`` ranges."""
    outers = spans(trace, [outer]) if trace is not None else []
    if not outers:
        return None
    in_outer, in_inner = _Starts(outers), _Starts(spans(trace, inner))
    host_of = {}
    for e in trace.host:
        xid = e.get("args", {}).get("External id")
        if xid is not None and e.get("cat") == "cpu_op":
            host_of.setdefault(xid, e)
    part, whole = 0.0, 0.0
    for e in trace.device:
        op = host_of.get(e.get("args", {}).get("External id"))
        if op is None or not in_outer.holds(op):
            continue
        whole += e["dur"]
        if in_inner.holds(op):
            part += e["dur"]
    return part, whole

"""Reading a ``torch.profiler`` (Kineto) trace of the card.

``Scopes``, ``MOE_PARTS`` and ``time_by_part`` are frozen copies of
``chip_smoke.py``'s; ``Trace`` adds what the benchmark's readers need:
the traced window, the device's busy time in it, device time by kernel
name and by the benchmark's own ranges, and the idle gaps named by what
the host was doing.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

# device work in a Kineto trace, and the host spans that nest host ops
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_SPANS = ("cpu_op", "user_annotation")
# the range the benchmark opens around the traced window
WINDOW = "portbench.window"
# the port's kernels by a mark in their names
PORT_KERNELS = {"K1": "rms_norm_rows", "K2": "flash_fwd_",
                "K3": "flash_dq_", "K4": "flash_dkv_"}
WORK_KINDS = (
    ("port kernels (K1-K4)", tuple(PORT_KERNELS.values())),
    ("matmuls", ("gemm", "nvjet", "xmma", "cutlass")),
    ("elementwise and reductions (aten)", ("at::native",)),
)
# the MoE FFN's parts, by the function of models/moe.py that computes them
MOE_PARTS = {
    "_routing": "moe.routing",
    "_dispatch": "moe.dispatch_combine",
    "_combine": "moe.dispatch_combine",
    "_expert_ffn": "moe.expert_ffn",
}
# the f32 head and its loss, by the functions of models/transformer.py
HEAD_PARTS = {"_logits": "head", "_nll": "head"}


class Scopes:
    """While installed, each target ``(module, function name, part)``
    runs inside a profiler range named ``part.<part>``; the port's own
    code carries no ranges."""

    def __init__(self, targets):
        self.targets = list(targets)
        self.saved = []

    def __enter__(self):
        for module, name, part in self.targets:
            fn = getattr(module, name)
            self.saved.append((module, name, fn))
            setattr(module, name, self.scoped("part." + part, fn))
        return self

    def __exit__(self, *exc):
        for module, name, fn in reversed(self.saved):
            setattr(module, name, fn)
        self.saved = []

    @staticmethod
    def scoped(label, fn):
        import torch

        def run(*args, **kw):
            with torch.profiler.record_function(label):
                return fn(*args, **kw)
        return run


def part_scopes(n_experts: int):
    """The head's parts and, for an MoE model, the MoE's, as ``Scopes``
    targets."""
    from dcos_commons_tpu_torch.models import moe, transformer

    targets = [(transformer, name, part) for name, part in HEAD_PARTS.items()]
    if n_experts:
        targets += [(moe, name, part) for name, part in MOE_PARTS.items()]
    return targets


def time_by_part(trace) -> Dict[str, float]:
    """Device ms of a Kineto trace (the dict ``export_chrome_trace``
    writes) by part (``Scopes``), forward and backward, and the rest by
    kind of kernel (``WORK_KINDS``).  A device operation belongs to the
    host op of its ``External id``; that op belongs to a part when it
    ran inside the part's range (the forward, and remat's recompute of
    it), or inside the ``evaluate_function`` of an autograd node that a
    forward op in the range made: both carry the node's ``Sequence
    number``.  Host ops nest by time on their thread."""
    host = sorted((e for e in trace["traceEvents"] if e.get("ph") == "X"
                   and e.get("cat") in HOST_SPANS),
                  key=lambda e: (e["tid"], e["ts"], -e["dur"]))
    where, part_of_seq, stack = {}, {}, []
    for e in host:
        while stack and (stack[-1][0]["tid"] != e["tid"] or e["ts"]
                         >= stack[-1][0]["ts"] + stack[-1][0]["dur"]):
            stack.pop()
        ctx, in_bwd = stack[-1][1:] if stack else (None, False)
        args = e.get("args", {})
        if e["name"].startswith("part."):
            ctx = ("part", e["name"][5:])
        elif e["name"].startswith("autograd::engine::evaluate_function"):
            ctx, in_bwd = ("node", args.get("Sequence number")), True
        if ctx and ctx[0] == "part" and not in_bwd \
                and args.get("Sequence number", -1) >= 0:
            part_of_seq[args["Sequence number"]] = ctx[1]
        where[args.get("External id")] = ctx
        stack.append((e, ctx, in_bwd))
    split = {}
    for e in trace["traceEvents"]:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_WORK:
            continue
        ctx = where.get(e.get("args", {}).get("External id"))
        kind = None
        if ctx:
            kind = ctx[1] if ctx[0] == "part" else part_of_seq.get(ctx[1])
        kind = kind or next((kind for kind, marks in WORK_KINDS
                             if any(m in e["name"] for m in marks)), "other")
        split[kind] = split.get(kind, 0.0) + e["dur"] / 1e3
    return split


def load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Trace:
    """One traced window of a run (times in the trace's microseconds)."""

    def __init__(self, trace: dict):
        self.raw = trace
        events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
        windows = [e for e in events if e.get("name") == WINDOW
                   and e.get("cat") in HOST_SPANS]
        if not windows:
            raise ValueError(f"no {WINDOW!r} range in the trace")
        w = max(windows, key=lambda e: e["dur"])
        self.t0, self.t1 = float(w["ts"]), float(w["ts"] + w["dur"])
        self.device = [
            e for e in events if e.get("cat") in DEVICE_WORK
            and self.t0 <= e["ts"] < self.t1
        ]
        self.host = [e for e in events if e.get("cat") in HOST_SPANS
                     and e.get("name") != WINDOW]
        self.busy_intervals = _merge([
            (max(e["ts"], self.t0), min(e["ts"] + e["dur"], self.t1))
            for e in self.device])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals) / 1e6

    def by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for e in self.device:
            out[e["name"]] += e["dur"] / 1e6
        return dict(out)

    def kernels(self, mark: str) -> Tuple[int, float]:
        """(launches, device seconds) of the kernels whose name holds
        ``mark``."""
        hits = [e for e in self.device
                if e.get("cat") == "kernel" and mark in e["name"]]
        return len(hits), sum(e["dur"] for e in hits) / 1e6

    def top_ops(self, n: int = 10) -> List[list]:
        ranked = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:n]
        return [[name[:120], secs] for name, secs in ranked]

    def _host_of_device(self) -> Dict[int, dict]:
        ids = {e.get("args", {}).get("External id") for e in self.device}
        return {e["args"]["External id"]: e for e in self.host
                if e.get("args", {}).get("External id") in ids}

    def device_s_in_ranges(self, prefix: str) -> Dict[str, float]:
        """Device seconds of the work launched inside each host range
        whose name starts with ``prefix``, by the range's name (ranges
        and the ops in them nest by time on their thread)."""
        ranges = defaultdict(list)
        for e in self.host:
            if e["name"].startswith(prefix):
                ranges[e["tid"]].append((e["ts"], e["ts"] + e["dur"],
                                         e["name"]))
        for spans in ranges.values():
            spans.sort()
        starts = {tid: [s[0] for s in spans] for tid, spans in ranges.items()}
        host_of = self._host_of_device()
        out: Dict[str, float] = defaultdict(float)
        for e in self.device:
            op = host_of.get(e.get("args", {}).get("External id"))
            if op is None or op["tid"] not in ranges:
                continue
            spans = ranges[op["tid"]]
            i = bisect.bisect_right(starts[op["tid"]], op["ts"]) - 1
            if i >= 0 and op["ts"] < spans[i][1]:
                out[spans[i][2]] += e["dur"] / 1e6
        return dict(out)

    def idle_gaps(self, n: int = 10, min_us: float = 20.0) -> List[list]:
        """Idle seconds of the window by what the host was doing: each
        gap between device operations (of at least ``min_us``) is named
        by the innermost host range open at its middle on a thread that
        launches device work; the ``n`` names with the most seconds."""
        launchers = {op["tid"] for op in self._host_of_device().values()}
        by_tid = defaultdict(list)
        for e in self.host:
            if e["tid"] in launchers:
                by_tid[e["tid"]].append(e)
        for spans in by_tid.values():
            spans.sort(key=lambda e: e["ts"])
        starts = {tid: [e["ts"] for e in spans]
                  for tid, spans in by_tid.items()}
        edges = [self.t0] + [x for ab in self.busy_intervals for x in ab] \
            + [self.t1]
        out: Dict[str, float] = defaultdict(float)
        for a, b in zip(edges[0::2], edges[1::2]):
            if b - a < min_us:
                continue
            mid = 0.5 * (a + b)
            best: Optional[dict] = None
            for tid, spans in by_tid.items():
                i = bisect.bisect_right(starts[tid], mid) - 1
                # walk back to the innermost range open at ``mid``
                for j in range(i, max(i - 400, -1), -1):
                    e = spans[j]
                    if e["ts"] + e["dur"] > mid:
                        if best is None or e["ts"] > best["ts"]:
                            best = e
                        break
            name = best["name"][:80] if best else "no host range"
            out[name] += (b - a) / 1e6
        ranked = sorted(out.items(), key=lambda kv: -kv[1])[:n]
        return [[name, secs] for name, secs in ranked]

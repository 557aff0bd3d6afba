"""The harness: one cell of ``BENCHMARK.json`` run once.

Everything specific is found by name in files of its own:
- ``portbench/configs/<config>.json``: a model configuration;
- ``portbench/mixes/<traffic>.json``: a traffic mix, whose ``driver``
  names ``portbench/drivers/<driver>.py``;
- ``portbench/limits/<workload>.json``: the cell's limits on the
  numbers that decide ``correct``;
- ``portbench/metrics/<metric>.py``: a per-layer metric's reader,
  ``read(ctx, rec) -> float | None``.

A driver's ``run(ctx)`` returns a ``Record``; the harness turns it into
the result line.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from portbench.lib.counts import Geometry

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PATHS = "portbench"
# top-level module names that may not be loaded when the result prints
FORBIDDEN = ("jax", "jaxlib", "flax", "dcos_commons_tpu")
_T_IMPORT = time.monotonic()


def process_age() -> float:
    """Seconds since this process started (the kernel's start time),
    or since this module was imported where that is not readable."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start
    except (OSError, ValueError, IndexError, AttributeError):
        return time.monotonic() - _T_IMPORT


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


class Spans:
    """The benchmark's own spans around its calls into the port, kept in
    memory: (name, start, end, args) on the host's monotonic clock.
    While ``traced`` is set each span is also a profiler range named
    ``portbench.<name>#<index>``."""

    def __init__(self):
        self.items: List[Tuple[str, float, float, dict]] = []
        self.traced = False
        self._count: Dict[str, int] = {}

    @contextmanager
    def span(self, name: str, **args):
        i = self._count.get(name, 0)
        self._count[name] = i + 1
        t0 = time.perf_counter()
        if self.traced:
            import torch

            with torch.profiler.record_function(f"portbench.{name}#{i}"):
                yield args
        else:
            yield args
        self.items.append((name, t0, time.perf_counter(), args))

    def of(self, name: str, t0: float = -math.inf, t1: float = math.inf):
        """Spans of ``name`` that started in [t0, t1)."""
        return [s for s in self.items if s[0] == name and t0 <= s[1] < t1]


@dataclass
class Context:
    root: str
    workload: str
    cell: dict
    config: dict
    geometry: Geometry
    traffic: str
    mix: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    scratch: str = ""
    spans: Spans = field(default_factory=Spans)


@dataclass
class Record:
    """What a driver measured and checked in one run."""
    e2e: Dict[str, float]
    attempted: int
    failed: int
    checks: Dict[str, Tuple[float, Optional[float]]]
    correct: bool
    memory_peak: int
    window: Tuple[float, float] = (0.0, 0.0)
    counters: dict = field(default_factory=dict)
    trace: object = None            # lib.trace.Trace of a traced run
    notes: List[str] = field(default_factory=list)


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
    return _load_json(os.path.join(root, "BENCHMARK.json"))


def build_context(workload: str, seed: int, seconds: float, trace: bool,
                  root: str = ROOT, device: str = "cuda",
                  bench: Optional[dict] = None) -> Context:
    bench = bench or load_benchmark(root)
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[cell["config"]]
    config = _load_json(os.path.join(root, cfg_entry["file"]))
    here = os.path.join(root, PATHS)
    mix = _load_json(os.path.join(here, "mixes", cell["traffic"] + ".json"))
    limits_path = os.path.join(here, "limits", workload + ".json")
    limits = _load_json(limits_path) if os.path.exists(limits_path) else {}
    return Context(
        root=root, workload=workload, cell=cell,
        config=config, geometry=Geometry.from_config(config),
        traffic=cell["traffic"], mix=mix, limits=limits, seed=int(seed),
        seconds=float(seconds), trace=bool(trace), device=device,
    )


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver_of(ctx: Context):
    kind = ctx.mix["driver"]
    return load_module(os.path.join(ctx.root, PATHS, "drivers", kind + ".py"),
                       f"portbench_driver_{kind}")


def end_to_end_names(bench: dict, workload: str) -> List[str]:
    return [m["name"] for m in bench["end_to_end"]
            if "workloads" not in m or workload in m["workloads"]]


def per_layer_entries(bench: dict, workload: str) -> List[dict]:
    """The per-layer metrics this cell reports: those that list it, and
    those with no list whose end-to-end metric the cell reports."""
    e2e = set(end_to_end_names(bench, workload))
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def reader_of(name: str, root: str = ROOT) -> Callable:
    module = load_module(os.path.join(root, PATHS, "metrics", name + ".py"),
                         "portbench_metric_" + name.replace(".", "_"))
    return module.read


def forbidden_in(names) -> List[str]:
    """The ``FORBIDDEN`` top-level names among module ``names``, each
    compared whole: ``dcos_commons_tpu_torch`` is not ``dcos_commons_tpu``."""
    tops = {name.split(".", 1)[0] for name in names}
    return sorted(tops.intersection(FORBIDDEN))


def forbidden_modules() -> List[str]:
    return forbidden_in(list(sys.modules))


def device_info(ctx: Context) -> dict:
    import torch

    if ctx.device == "cuda":
        kind = torch.cuda.get_device_name(0)
        platform = "gpu"
    else:
        kind, platform = "cpu", "cpu"
    return {"platform": platform, "kind": kind,
            "count": int(ctx.cell.get("chips", 1))}


def power_limit() -> Optional[str]:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def execute(ctx: Context, bench: Optional[dict] = None) -> Tuple[dict, Record]:
    """Run the cell once: (the result object, the driver's record)."""
    bench = bench or load_benchmark(ctx.root)
    own_scratch = not ctx.scratch
    if own_scratch:
        ctx.scratch = tempfile.mkdtemp(prefix="portbench-")
    try:
        rec = driver_of(ctx).run(ctx)
    finally:
        if own_scratch:
            shutil.rmtree(ctx.scratch, ignore_errors=True)
    if ctx.trace:
        metrics = {}
        for entry in per_layer_entries(bench, ctx.workload):
            value = reader_of(entry["name"], ctx.root)(ctx, rec)
            if value is not None:
                metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    else:
        units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
        metrics = {name: {"value": rec.e2e[name], "unit": units[name]}
                   for name in end_to_end_names(bench, ctx.workload)}
    device = device_info(ctx)
    device["memory_peak_bytes"] = int(rec.memory_peak)
    if ctx.trace and rec.trace is not None:
        device["busy_s"] = rec.trace.busy_s
        device["window_s"] = rec.trace.window_s
    result = {
        "correct": bool(rec.correct),
        "attempted": int(rec.attempted),
        "failed": int(rec.failed),
        "metrics": metrics,
        "device": device,
    }
    if ctx.trace and rec.trace is not None:
        result["breakdown"] = {"device_ops": rec.trace.top_ops(10),
                               "idle_gaps": rec.trace.idle_gaps(10)}
    result["checks"] = {
        name: {"value": value, "limit": limit}
        for name, (value, limit) in rec.checks.items()
    }
    return result, rec


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = load_benchmark()
    ctx = build_context(args.workload, args.seed, args.seconds,
                        bool(args.trace), bench=bench)
    import torch

    chips = int(ctx.cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"this cell needs {chips} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    log(f"{ctx.workload} seed {ctx.seed} seconds {ctx.seconds} trace "
        f"{int(ctx.trace)} on {torch.cuda.get_device_name(0)} "
        f"[{power_limit()}]")
    result, rec = execute(ctx, bench)
    found = forbidden_modules()
    if found:
        log(f"modules of JAX or of the JAX package are loaded: {found}")
        return 3
    for note in rec.notes:
        log(note)
    for name, check in result["checks"].items():
        log(f"check {name} = {check['value']!r} (limit {check['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0

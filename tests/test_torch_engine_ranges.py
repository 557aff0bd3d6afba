"""The serving path's profiler ranges (``trace/ranges.py`` ``profiled``):
a tiny ``PagedEngine`` over ``PagedPoolModel`` serves under a CPU
profiler started on its loop thread, and the exported trace holds the
ranges with their fixed names, nested as the engine, the pool and the
decode trunk call each other.  With no profiler running no range is
opened, and the tokens are the same either way."""

import ast
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dcos_commons_tpu_torch.models import transformer as t_tf
from dcos_commons_tpu_torch.serve import engine as t_engine
from dcos_commons_tpu_torch.serve import pool as t_pool
from dcos_commons_tpu_torch.trace import profiled
from dcos_commons_tpu_torch.trace import ranges

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=64, max_seq=64, remat=False)
SLOTS, MAX_LEN, PAGE, CHUNK = 3, 40, 4, 8
PAGES = SLOTS * (MAX_LEN // PAGE)
# a prompt of three chunks and one of one, then a late short one
PROMPTS = [[int(t) for t in np.random.default_rng(s).integers(1, 64, n)]
           for s, n in ((1, 19), (2, 5), (3, 3))]
NEW = 6
TRUNK = ("trunk.project", "trunk.kv_write", "trunk.kv_gather",
         "trunk.attend", "trunk.ffn")


@pytest.fixture(scope="module")
def model():
    config = t_tf.TransformerConfig(dtype=torch.float32, **DIMS)
    return config, t_tf.init_params(config, seed=0, device="cpu")


class _LoopProfiler:
    """A CPU profiler started and stopped on the engine's loop thread
    by its idle hook (a profiler records the thread that starts it),
    between ticks, with no range open."""

    def __init__(self):
        self.want = None
        self.prof = None
        self.started = threading.Event()
        self.stopped = threading.Event()

    def __call__(self):
        if self.want == "start" and self.prof is None:
            self.prof = profile(activities=[ProfilerActivity.CPU])
            self.prof.start()
            self.started.set()
        elif self.want == "stop" and self.prof is not None \
                and not self.stopped.is_set():
            self.prof.stop()
            self.stopped.set()


def _paged_engine(model, **kw):
    config, params = model
    pool = t_pool.PagedPoolModel(config, params, SLOTS, MAX_LEN, PAGE,
                                 PAGES, CHUNK)
    return t_engine.PagedEngine(
        pool.prefill_chunk, pool.decode, SLOTS, MAX_LEN, MAX_LEN - NEW,
        page_tokens=PAGE, pages=PAGES, chunk_tokens=CHUNK,
        prefix_cache=False, idle_every_s=0.01, **kw)


def _serve(engine):
    """The prompts, the first two at once and the third after them."""
    out = {}

    def send(i):
        out[i] = engine.submit([PROMPTS[i]], NEW, temperature=0.0)[0]

    threads = [threading.Thread(target=send, args=(i,)) for i in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(60)
    send(2)
    return [out[i] for i in range(len(PROMPTS))]


def _ranges(prof, tmp_path):
    """(name, start, end, tid) of every range of the port's in the
    exported trace (a ``cpu_op`` event from the profiler's fast record
    function, a ``user_annotation`` from ``record_function``)."""
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]),
             e["tid"]) for e in events
            if e.get("ph") == "X"
            and e.get("cat") in ("cpu_op", "user_annotation")
            and e["name"].split(".")[0] in ("engine", "pool", "trunk")]


def _traced_run(engine, tmp_path):
    hook = _LoopProfiler()
    engine._on_idle = hook
    hook.want = "start"
    assert hook.started.wait(30)
    tokens = _serve(engine)
    hook.want = "stop"
    assert hook.stopped.wait(30)
    engine.stop()
    return tokens, _ranges(hook.prof, tmp_path)


@pytest.fixture(scope="module")
def traced(model, tmp_path_factory):
    engine = _paged_engine(model, on_idle=lambda: None)
    return _traced_run(engine, tmp_path_factory.mktemp("ranges"))


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _within(inner, outers):
    """The outer range that holds ``inner`` on its thread, or None."""
    return next((o for o in outers if o[3] == inner[3] and o[1] <= inner[1]
                 and inner[2] <= o[2]), None)


def test_trace_holds_the_serving_ranges(traced):
    _tokens, spans = traced
    names = {s[0] for s in spans}
    assert {"engine.schedule", "engine.tick", "engine.prefill",
            "engine.decode", "pool.prefill_chunk", "pool.decode",
            "pool.sample", "trunk.head", *TRUNK} <= names
    # fixed names only: no index, no layer number
    assert not any(c.isdigit() for n in names for c in n)


def test_prefill_chunks_nest_in_the_tick(traced):
    _tokens, spans = traced
    ticks = _named(spans, "engine.tick")
    prefills = _named(spans, "engine.prefill")
    chunks = _named(spans, "pool.prefill_chunk")
    # 3 + 1 + 1 chunks of 8
    assert len(chunks) == 5
    for chunk in chunks:
        phase = _within(chunk, prefills)
        assert phase is not None and _within(phase, ticks) is not None
        inside = [s for s in spans if s[0] in TRUNK
                  and _within(s, [chunk])]
        assert len(inside) == len(TRUNK) * DIMS["n_layers"]
        assert len([s for s in _named(spans, "trunk.head")
                    if _within(s, [chunk])]) == 1
        assert len([s for s in _named(spans, "pool.sample")
                    if _within(s, [chunk])]) == 1


def test_decode_steps_nest_in_the_tick(traced):
    _tokens, spans = traced
    ticks = _named(spans, "engine.tick")
    decodes = _named(spans, "engine.decode")
    steps = _named(spans, "pool.decode")
    assert len(steps) >= NEW - 1
    for step in steps:
        phase = _within(step, decodes)
        assert phase is not None and _within(phase, ticks) is not None
        for name in TRUNK:
            assert len([s for s in _named(spans, name)
                        if _within(s, [step])]) == DIMS["n_layers"]
        for name in ("trunk.head", "pool.sample"):
            assert len([s for s in _named(spans, name)
                        if _within(s, [step])]) == 1
    # the loop's admission picks lie outside every tick
    for pick in _named(spans, "engine.schedule"):
        assert _within(pick, ticks) is None


def test_greedy_tokens_identical_with_and_without_the_profiler(model,
                                                              traced):
    tokens, _spans = traced
    engine = _paged_engine(model)
    try:
        assert _serve(engine) == tokens
    finally:
        engine.stop()
    assert all(len(t) == NEW for t in tokens)


def test_no_range_is_opened_with_the_profiler_off(model, monkeypatch):
    entered = []

    def counting(real):
        def opened(name, *args):
            entered.append(name)
            return real(name, *args)
        return opened

    monkeypatch.setattr(torch.profiler, "record_function",
                        counting(torch.profiler.record_function))
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        counting(torch._C._profiler._RecordFunctionFast))
    monkeypatch.setattr(ranges, "_open", None)  # resolved anew: counted
    engine = _paged_engine(model)
    try:
        _serve(engine)
    finally:
        engine.stop()
    assert entered == []
    assert profiled("pool.decode") is profiled("engine.tick")
    # the count sees ranges where a profiler records
    config, params = model
    pool = t_pool.PagedPoolModel(config, params, SLOTS, MAX_LEN, PAGE,
                                 PAGES, CHUNK)
    with profile(activities=[ProfilerActivity.CPU]):
        pool.warm()
    assert {"pool.prefill_chunk", "pool.decode", "pool.sample",
            "trunk.head", *TRUNK} <= set(entered)


def test_slot_engine_ranges(model, tmp_path):
    """The slot engine's loop opens the same tick and schedule ranges;
    its pool's whole-prompt prefill and decode open only the trunk's
    ranges and the sampling, inside a tick."""
    config, params = model
    pool = t_pool.PoolModel(config, params, SLOTS, MAX_LEN)
    engine = t_engine.SlotEngine(
        pool.prefill, pool.decode, SLOTS, MAX_LEN, MAX_LEN - NEW,
        on_idle=lambda: None, idle_every_s=0.01)
    tokens, spans = _traced_run(engine, tmp_path)
    assert all(len(t) == NEW for t in tokens)
    ticks = _named(spans, "engine.tick")
    assert ticks and _named(spans, "engine.schedule")
    assert {s[0] for s in spans} <= {"engine.schedule", "engine.tick",
                                     "pool.sample", "trunk.head", *TRUNK}
    for s in spans:
        if s[0] != "engine.schedule":
            assert _within(s, ticks) is not None, s
    # a whole prompt or a decode step samples once
    assert len(_named(spans, "pool.sample")) == len(
        _named(spans, "trunk.head"))


def test_a_torch_without_the_fast_range_falls_back(monkeypatch):
    """Where torch has no fast record function the ranges are
    ``record_function``'s, in the trace under the same names."""
    monkeypatch.delattr(torch._C._profiler, "_RecordFunctionFast")
    monkeypatch.setattr(ranges, "_open", None)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiled("pool.decode"):
            torch.ones(2).add_(1.0)
    assert ranges._open is torch.profiler.record_function
    assert "pool.decode" in {e.name for e in prof.events()}


def test_a_range_entered_before_profiling_stays_closed():
    outer = profiled("engine.tick")
    with outer:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with profiled("pool.decode"):
                torch.ones(2).add_(1.0)
            assert profiled("pool.sample") is not ranges._CLOSED
    names = {e.name for e in prof.events()}
    assert "pool.decode" in names and "engine.tick" not in names
    assert outer is ranges._CLOSED


def test_profiled_loads_no_torch():
    """Where torch was never imported no profiler runs: the tracing
    package (the scheduler imports it) loads without torch and a range
    is the shared null context; neither the ranges nor the engine
    import torch themselves."""
    code = (
        "import sys\n"
        "from dcos_commons_tpu_torch.trace import profiled, ranges\n"
        "with profiled('engine.tick'):\n"
        "    pass\n"
        "assert profiled('pool.decode') is ranges._CLOSED\n"
        "assert 'torch' not in sys.modules, 'torch loaded'\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr
    for module in (ranges, t_engine):
        with open(module.__file__) as f:
            tree = ast.parse(f.read())
        imported = {a.name.split(".")[0] for n in ast.walk(tree)
                    if isinstance(n, ast.Import) for a in n.names}
        imported |= {n.module.split(".")[0] for n in ast.walk(tree)
                     if isinstance(n, ast.ImportFrom) and n.module}
        assert "torch" not in imported, module.__name__

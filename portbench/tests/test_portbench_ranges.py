"""The readers of the port's own profiler ranges (``lib/ranges.py`` and
the four metrics that read it) on a small Kineto-shaped trace built by
hand, with known ranges, launches and gaps; and on the same trace with
the port's ranges taken out, as an older commit's trace has none.  The
ranges come as ``user_annotation`` events (``record_function``) or as
``cpu_op`` events with External ids of their own (the profiler's fast
record function, which the port opens)."""

import types

import pytest

from portbench.lib import harness
from portbench.lib.trace import Trace

LOOP, STREAM = 11, 7
NEW = ("loop_idle_share.serve", "pool_idle_share.serve",
       "prefill_tick_share.serve", "decode_attn_share.serve")


def _host(name, ts, end, cat="user_annotation", xid=None):
    e = {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": LOOP,
         "ts": ts, "dur": end - ts, "args": {}}
    if xid is not None:
        e["args"]["External id"] = xid
    return e


def _work(xid, ts, end, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": f"kernel_{xid}", "pid": 0,
            "tid": STREAM, "ts": ts, "dur": end - ts,
            "args": {"External id": xid}}


def _events(cat="user_annotation"):
    """The window [100, 1100] us.  A tick that starts before it, two
    wholly inside it (B: a prefill chunk, then a decode step; C: a short
    prefill phase, then a decode step) and one that runs past its end.
    Launches: (External id, the range the op starts in, device
    interval).  The port's ranges are events of category ``cat``."""
    ranges = [
        ("portbench.window", 100, 1100),
        ("engine.tick", 40, 400), ("pool.decode", 50, 150),
        ("engine.schedule", 405, 418),
        ("engine.tick", 420, 800), ("engine.prefill", 430, 530),
        ("pool.prefill_chunk", 440, 520), ("engine.decode", 540, 790),
        ("pool.decode", 550, 780), ("trunk.kv_gather", 560, 600),
        ("trunk.attend", 600, 650), ("trunk.ffn", 650, 700),
        ("trunk.head", 700, 760), ("pool.sample", 760, 780),
        ("engine.tick", 810, 1000), ("engine.prefill", 815, 835),
        ("engine.decode", 840, 990), ("pool.decode", 850, 980),
        ("trunk.kv_gather", 860, 870), ("trunk.attend", 870, 900),
        ("trunk.ffn", 900, 950),
        ("engine.tick", 1010, 1150), ("engine.prefill", 1015, 1100),
    ]
    launches = [
        (8, 60, (120, 140)),             # pool.decode, clipped by the window
        (5, 445, (450, 500)),            # the prefill chunk
        (1, 565, (570, 620)),            # trunk.kv_gather
        (2, 605, (620, 700)),            # trunk.attend
        (3, 655, (700, 740)),            # trunk.ffn
        (4, 765, (740, 775), "gpu_memcpy"),  # pool.sample's copy
        (6, 875, (880, 960)),            # trunk.attend
        (7, 905, (960, 975)),            # trunk.ffn
    ]
    events = [_host(*r) if r[0] == "portbench.window" or cat != "cpu_op"
              else _host(*r, cat, 100 + i) for i, r in enumerate(ranges)]
    for xid, at, (a, b), *cat in launches:
        events.append(_host("aten::op", at, at + 2, "cpu_op", xid))
        events.append(_work(xid, a, b, *cat))
    return events


def _record(events):
    return types.SimpleNamespace(trace=Trace({"traceEvents": events}))


def _read(name, rec):
    return harness.reader_of(name)(None, rec)


@pytest.mark.parametrize("cat", ["user_annotation", "cpu_op"])
def test_each_reader_reads_the_hand_made_trace(cat):
    rec = _record(_events(cat))
    # busy 20 + 50 + 205 + 95 of 1000 us; idle inside pool ranges:
    # 30 + 30 + 25 + 35
    assert _read("pool_idle_share.serve", rec) == pytest.approx(12.0)
    assert _read("loop_idle_share.serve", rec) == pytest.approx(51.0)
    # ticks B (380 us) and C (190 us); their prefill phases 100 + 20
    assert _read("prefill_tick_share.serve", rec) == \
        pytest.approx(100.0 * 120 / 570)
    # gather and attention 50 + 80 + 80 us of the decode steps' 320 us
    assert _read("decode_attn_share.serve", rec) == \
        pytest.approx(100.0 * 210 / 320)


@pytest.mark.parametrize("cat", ["user_annotation", "cpu_op"])
def test_the_idle_split_sums_to_the_device_idle_share(cat):
    rec = _record(_events(cat))
    device = _read("device_idle_share.serve", rec)
    assert device == pytest.approx(63.0)
    assert _read("loop_idle_share.serve", rec) \
        + _read("pool_idle_share.serve", rec) == pytest.approx(device)


@pytest.mark.parametrize("name", NEW)
def test_a_trace_without_the_ports_ranges_reads_none(name):
    bare = [e for e in _events()
            if not e["name"].startswith(("engine.", "pool.", "trunk."))]
    rec = _record(bare)
    assert _read("device_idle_share.serve", rec) == pytest.approx(63.0)
    assert _read(name, rec) is None
    assert _read(name, types.SimpleNamespace(trace=None)) is None


def test_the_new_metrics_are_the_chat_cells_and_lower_is_better():
    bench = harness.load_benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    # the layers the benchmark named before these metrics came
    layers = {m["layer"] for m in bench["per_layer"] if m["name"] not in NEW}
    for name in NEW:
        m = entries[name]
        assert m["workloads"] == ["mistral-7b-v0.3.serve.chat"]
        assert (m["unit"], m["better"], m["source"], m["moves"]) == \
            ("%", "lower", "device_trace", "serve_latency_p95_s")
        assert m["layer"] in layers and m["layer"].split(":")[0] in (
            "engine", "pool")

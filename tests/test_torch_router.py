"""The port's request router (dcos_commons_tpu_torch/router, a line-for-
line copy) against the JAX package's (dcos_commons_tpu/router).

Each scenario drives one router through one set of fake backends and
records what it did: every pick (the pod each send went to), the
router's log lines, its counters after each phase (the deterministic
keys of ``stats()``: every one but the clock ``t`` and the latency
percentiles) and every error it raised.  The port's router and the
reference's run the same scenario and must record the same events in
the same order.  The scenarios cover tests/test_router.py's
behaviours: least-loaded placement, the staleness gate, drain,
affinity and its yield to load, the failover budget and application
errors, the generation-stamped refresh, the sticky operator drain, a
migrated session followed by a collect, and a pod killed mid-stream
(concurrent clients: there the outcome is compared, as the
interleaving is the scheduler's).  Over HTTP: each package's
``RouterServer`` in front of the same two fake pods, and the port's in
front of two of the port's serve workers on the CPU, whose routed
greedy replies equal the replies the pods give directly.
"""

import json
import threading
import time
import types
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

import dcos_commons_tpu.router as j_router
import dcos_commons_tpu.router.frontdoor as j_frontdoor
import dcos_commons_tpu.serve.migration as j_migration
import dcos_commons_tpu_torch.router as t_router
import dcos_commons_tpu_torch.router.frontdoor as t_frontdoor
import dcos_commons_tpu_torch.serve.migration as t_migration
from dcos_commons_tpu_torch.serve.engine import SlotEngine


def _package(router, frontdoor, migration):
    return types.SimpleNamespace(
        RequestRouter=router.RequestRouter,
        PodTransportError=router.PodTransportError,
        NoPodAvailableError=router.NoPodAvailableError,
        RouterServer=frontdoor.RouterServer,
        SessionMigratedError=migration.SessionMigratedError,
    )


PACKAGES = {
    "jax": _package(j_router, j_frontdoor, j_migration),
    "port": _package(t_router, t_frontdoor, t_migration),
}

# -- the deterministic chain model of tests/test_router.py ---------------

_V = 97


def _chain_first(prompt):
    return (sum(prompt) * 31 + len(prompt)) % _V


def _chain_next(tok, pos):
    return (tok * 7 + pos * 3 + 1) % _V


def _chain_oracle(prompt, n):
    out, pos = [_chain_first(prompt)], len(prompt)
    while len(out) < n:
        out.append(_chain_next(out[-1], pos))
        pos += 1
    return out


class FakeModel:
    def prefill(self, padded, slot, true_len, temp, seed):
        return _chain_first([int(t) for t in padded[0, :true_len]])

    def decode(self, tok, pos, temps, seeds, n_active):
        return np.asarray([_chain_next(int(t), int(p))
                           for t, p in zip(tok, pos)], np.int32)


class Trace:
    """What a router did, in order."""

    def __init__(self):
        self.events = []
        self.lock = threading.Lock()

    def add(self, *event):
        with self.lock:
            self.events.append(event)

    def log(self, msg):
        self.add("log", msg)

    def stats(self, router, label):
        snap = router.stats()
        self.add("stats", label, {k: v for k, v in sorted(snap.items())
                                  if k != "t" and not k.startswith("ttft")})

    def expect(self, exc_type, fn, *args):
        try:
            fn(*args)
        except exc_type as e:
            self.add("raised", type(e).__name__, str(e))
            return
        raise AssertionError(f"{fn} did not raise {exc_type.__name__}")


def _fresh(queue_depth=0, active=0, **kw):
    out = {"queue_depth": queue_depth, "active_slots": active,
           "free_slots": 8, "stats_age_s": 0.0}
    out.update(kw)
    return out


def _router(R, trace, send, pods=("a", "b"), policy="affinity", **kw):
    r = R.RequestRouter(send, page_tokens=4, policy=policy,
                        stale_after_s=5.0, log=trace.log, **kw)
    r.update_pods({n: {"address": f"host-{n}:80"} for n in pods},
                  generation="g1")
    return r


def _recording_send(trace, reply=((0,),)):
    def send(name, address, request):
        trace.add("send", name, address, request["tokens"][0])
        return [list(r) for r in reply]
    return send


# -- the scenarios ---------------------------------------------------------


def least_loaded(R, trace):
    r = _router(R, trace, _recording_send(trace), policy="least-loaded")
    r.observe_stats("a", _fresh(queue_depth=5, active=3))
    r.observe_stats("b", _fresh(queue_depth=0, active=1))
    trace.add("route", r.route([1, 2, 3]))
    r.observe_stats("b", _fresh(queue_depth=9, active=8))
    trace.add("route", r.route([1, 2, 3]))
    r.submit([1, 2, 3], 2)
    trace.stats(r, "end")
    assert [e[1] for e in trace.events if e[0] == "route"] == ["b", "a"]


def staleness(R, trace):
    r = _router(R, trace, _recording_send(trace), policy="least-loaded")
    r.observe_stats("a", _fresh(stats_age_s=60.0))
    r.observe_stats("b", _fresh(queue_depth=6, active=8))
    trace.add("route", r.route([1, 2, 3]))
    trace.stats(r, "wedged")
    r2 = _router(R, trace, _recording_send(trace), policy="least-loaded")
    r2.observe_stats("a", _fresh(), now=time.monotonic() - 60)
    r2.observe_stats("b", _fresh(queue_depth=6))
    trace.add("route", r2.route([1]))
    assert [e[1] for e in trace.events if e[0] == "route"] == ["b", "b"]


def drain(R, trace):
    r = _router(R, trace, _recording_send(trace))
    r.observe_stats("a", _fresh())
    r.observe_stats("b", _fresh())
    trace.add("drain", r.drain("a"))
    for i in range(4):
        r.submit([1, 2, i], 2)
    trace.stats(r, "drained")
    r.undrain("a")
    r.observe_stats("a", _fresh(queue_depth=0))
    r.observe_stats("b", _fresh(queue_depth=9))
    r.submit([1, 2], 2)
    r.drain("a"), r.drain("b")
    trace.expect(R.NoPodAvailableError, r.submit, [1, 2], 2)
    trace.stats(r, "all drained")
    sends = [e[1] for e in trace.events if e[0] == "send"]
    assert sends == ["b"] * 4 + ["a"]


def affinity(R, trace):
    r = _router(R, trace, _recording_send(trace), affinity_slack=4.0)
    r.observe_stats("a", _fresh())
    r.observe_stats("b", _fresh())
    prefix = list(range(1, 9))
    r.submit(prefix + [50], 2)
    owner = trace.events[-1][1]
    for i in range(5):
        r.submit(prefix + [60 + i], 2)
    trace.stats(r, "followed")
    other = "b" if owner == "a" else "a"
    r.observe_stats(owner, _fresh(queue_depth=20, active=8))
    r.observe_stats(other, _fresh(queue_depth=0))
    r.submit(prefix + [99], 2)
    trace.stats(r, "overridden")
    sends = [e[1] for e in trace.events if e[0] == "send"]
    assert sends == [owner] * 6 + [other]


def failover(R, trace):
    def send(name, address, request):
        trace.add("send", name)
        if name == "a":
            raise R.PodTransportError("connection reset")
        return [[7, 7]]

    r = _router(R, trace, send, retry_budget=2)
    r.observe_stats("a", _fresh(queue_depth=0))
    r.observe_stats("b", _fresh(queue_depth=5))
    trace.add("reply", r.submit([1, 2], 2))
    trace.stats(r, "failed over")
    trace.add("route", r.route([1, 2]))
    r.observe_stats("a", _fresh())
    trace.stats(r, "readmitted")

    def dead(name, address, request):
        trace.add("send", name)
        raise R.PodTransportError("down")

    r2 = _router(R, trace, dead, retry_budget=1)
    r2.observe_stats("a", _fresh())
    r2.observe_stats("b", _fresh())
    trace.expect(R.PodTransportError, r2.submit, [1, 2], 2)

    def app_error(name, address, request):
        trace.add("send", name)
        raise ValueError("prompt too long")

    r3 = _router(R, trace, app_error, retry_budget=2)
    r3.observe_stats("a", _fresh())
    r3.observe_stats("b", _fresh())
    trace.expect(ValueError, r3.submit, [1, 2], 2)
    trace.stats(r3, "app error")
    assert ("reply", [7, 7]) in trace.events


def refresh(R, trace):
    r = R.RequestRouter(_recording_send(trace), page_tokens=4,
                        log=trace.log)
    trace.add("rebuilt", r.update_pods({"a": {"address": "h:1"}},
                                       generation="g1"))
    trace.add("rebuilt", r.update_pods({"a": {"address": "h:1"}},
                                       generation="g1"))
    trace.add("rebuilt", r.update_pods({"a": {"address": "h:1"},
                                        "b": {"address": "h:2"}},
                                       generation="g2"))
    trace.add("pods", r.pods())
    r.update_pods({"a": {"address": "h:1", "draining": True},
                   "b": {"address": "h:2"}}, generation="g3")
    r.observe_stats("a", _fresh())
    r.observe_stats("b", _fresh())
    trace.add("route", r.route([1]))
    r.update_pods({"b": {"address": "h:2"}}, generation="g4")
    trace.add("pods", r.pods())
    trace.stats(r, "end")
    assert [e[1] for e in trace.events if e[0] == "rebuilt"] == \
        [True, False, True]


def operator_drain(R, trace):
    r = _router(R, trace, _recording_send(trace))
    r.observe_stats("a", _fresh())
    r.observe_stats("b", _fresh())
    r.drain("a")
    r.update_pods({"a": {"address": "host-a:80", "draining": False},
                   "b": {"address": "host-b:80"}}, generation="g2")
    r.observe_stats("a", _fresh())
    trace.add("route", r.route([1, 2]))
    r.update_pods({"a": {"address": "host-a:80"},
                   "b": {"address": "host-b:80"}})
    trace.add("route", r.route([1, 2]))
    r.undrain("a")
    r.observe_stats("a", _fresh(queue_depth=0))
    r.observe_stats("b", _fresh(queue_depth=9))
    trace.add("route", r.route([1, 2]))
    trace.stats(r, "end")
    assert [e[1] for e in trace.events if e[0] == "route"] == \
        ["b", "b", "a"]


def migration_follow(R, trace):
    def send(name, address, request):
        trace.add("send", name, request.get("collect"))
        if "collect" in request:
            return [[5, 6, 7]]
        raise R.SessionMigratedError(3, "b", 11)

    r = _router(R, trace, send)
    r.observe_stats("a", _fresh(queue_depth=0))
    r.observe_stats("b", _fresh(queue_depth=4))
    trace.add("reply", r.submit([1, 2, 3], 3))
    trace.stats(r, "followed")
    assert ("send", "b", 11) in trace.events


SCENARIOS = {f.__name__: f for f in (
    least_loaded, staleness, drain, affinity, failover, refresh,
    operator_drain, migration_follow)}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_port_router_makes_the_reference_routers_picks(scenario):
    traces = {}
    for name, R in PACKAGES.items():
        trace = Trace()
        SCENARIOS[scenario](R, trace)
        traces[name] = trace.events
    assert traces["port"] == traces["jax"]


# -- a pod killed mid-stream (test_router.py's satellite) -----------------


class EnginePod:
    """An in-process serve pod over the chain model that can be killed
    mid-stream."""

    def __init__(self, name, R):
        self.name, self.R = name, R
        self.engine = SlotEngine(FakeModel().prefill, FakeModel().decode, 4,
                                 64, 32, queue_timeout_s=60)
        self.killed = threading.Event()
        self.admitted = self.completed = 0
        self.lock = threading.Lock()

    def send(self, request):
        if self.killed.is_set():
            raise self.R.PodTransportError(f"{self.name} is dead")
        with self.lock:
            self.admitted += 1
        result = self.engine.submit(request["tokens"],
                                    request["max_new_tokens"])
        if self.killed.is_set():
            raise self.R.PodTransportError(f"{self.name} died mid-stream")
        with self.lock:
            self.completed += 1
        return result


def _kill_mid_stream(R):
    pods = {name: EnginePod(name, R) for name in ("a", "b", "c")}
    router = R.RequestRouter(lambda name, addr, req: pods[name].send(req),
                             page_tokens=4, stale_after_s=5.0,
                             retry_budget=2)
    router.update_pods({n: {"address": f"{n}:80"} for n in pods},
                       generation="g1")
    for name, pod in pods.items():
        router.observe_stats(name, pod.engine.stats())
    n_requests = 24
    jobs = [([i + 1, i + 2, i + 3], 6) for i in range(n_requests)]
    results, errors = [None] * n_requests, []
    kill_at = threading.Event()

    def client(i):
        if i == n_requests // 2:
            kill_at.set()
        try:
            results[i] = router.submit(*jobs[i])
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append((i, repr(e)))

    def killer():
        kill_at.wait(30)
        pods["a"].killed.set()

    threads = [threading.Thread(target=killer)] + [
        threading.Thread(target=client, args=(i,)) for i in range(n_requests)]
    try:
        for t in threads:
            t.start()
            time.sleep(0.002)
        for t in threads:
            t.join(timeout=60)
        at_kill = pods["a"].admitted
        completed = sum(p.completed for p in pods.values())
        after = [router.submit([90 + i], 3) for i in range(4)]
        stats = router.stats()
        return dict(
            errors=errors,
            correct=[r == _chain_oracle(p, n)
                     for (p, n), r in zip(jobs, results)],
            completed=completed,
            after=after, dead_admitted_after=pods["a"].admitted - at_kill,
            failed_over=stats["router_failovers"] >= 1,
            requests_completed=stats["requests_completed"],
        )
    finally:
        for pod in pods.values():
            pod.engine.stop()


def test_kill_mid_stream_completes_on_survivors_in_both():
    out = {name: _kill_mid_stream(R) for name, R in PACKAGES.items()}
    assert out["port"] == out["jax"]
    assert out["port"]["errors"] == []
    assert all(out["port"]["correct"])
    assert out["port"]["completed"] == 24
    assert out["port"]["dead_admitted_after"] == 0
    assert out["port"]["failed_over"]
    assert out["port"]["requests_completed"] == 28


# -- the HTTP front door --------------------------------------------------


class HttpPod:
    """A minimal real-socket serve pod: /generate and /stats."""

    def __init__(self, name):
        self.name = name
        self.engine = SlotEngine(FakeModel().prefill, FakeModel().decode, 4,
                                 64, 32, queue_timeout_s=30)
        engine = self.engine

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _reply(self, code, body):
                payload = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def do_GET(self):
                self._reply(200, engine.stats())

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length))
                try:
                    out = engine.submit(body["tokens"],
                                        body["max_new_tokens"])
                except ValueError as e:
                    self._reply(400, {"error": str(e)})
                    return
                self._reply(200, {"tokens": out})

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()

    @property
    def address(self):
        host, port = self.server.server_address[:2]
        return f"{host}:{port}"

    def stop(self):
        self.server.shutdown()
        self.server.server_close()
        self.engine.stop()


def _discovery(pods, generation="gen-1"):
    return lambda: {
        "name": "vip:inference", "generation": generation,
        "address": sorted(p.address for p in pods),
        "backends": [{"address": p.address, "task": p.name,
                      "state": "TASK_RUNNING", "ready": True,
                      "draining": False} for p in pods],
    }


def _http(method, url, body=None, timeout=60):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _front_door_run(R, tmp_path):
    pods = [HttpPod("pod-0"), HttpPod("pod-1")]
    server = R.RouterServer(
        "http://unused", discover=_discovery(pods), port=0,
        host="127.0.0.1", poll_interval_s=0.2,
        stats_path=str(tmp_path / "servestats.json"), page_tokens=4,
        log=None)
    server.start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        out = [_http("POST", f"{base}/generate",
                     {"tokens": [[1, 2, 3], [4, 5]], "max_new_tokens": 5})]
        status, stats = _http("GET", f"{base}/stats")
        out.append((status, {k: stats[k] for k in (
            "router_pods", "requests_completed", "router_generation")}))
        out.append(_http("POST", f"{base}/generate",
                         {"tokens": [[1] * 99], "max_new_tokens": 5})[0])
        out.append(_http("POST", f"{base}/drain?pod=pod-0"))
        status, body = _http("GET", f"{base}/pods")
        out.append((status, {n: row["draining"]
                             for n, row in body["pods"].items()}))
        return out
    finally:
        server.stop()
        for pod in pods:
            pod.stop()


def test_front_doors_answer_alike_over_http(tmp_path):
    out = {}
    for name, R in PACKAGES.items():
        (tmp_path / name).mkdir()
        out[name] = _front_door_run(R, tmp_path / name)
    assert out["port"] == out["jax"]
    assert out["port"][0] == (200, {"tokens": [_chain_oracle([1, 2, 3], 5),
                                               _chain_oracle([4, 5], 5)]})
    assert out["port"][2] == 400


def test_router_fronts_two_port_serve_workers(tmp_path):
    """The port's RouterServer in front of two of the port's serve
    workers (TORCH_DEVICE=cpu): routed greedy replies equal direct ones,
    and with one pod killed the rest complete on the other."""
    from dcos_commons_tpu_torch.frameworks.serve_worker import build_server

    env = dict(TORCH_DEVICE="cpu", VOCAB="64", D_MODEL="32", N_LAYERS="2",
               N_HEADS="4", N_KV_HEADS="2", D_FF="64", MAX_LEN="32",
               MAX_NEW_TOKENS="8", SERVE_BATCH="2", PORT_HTTP="0",
               KV_PAGE_TOKENS="4")
    served = []
    for i in range(2):
        (tmp_path / f"pod{i}").mkdir()
        s = build_server(dict(env, SANDBOX=str(tmp_path / f"pod{i}")),
                         log=lambda msg: None, ready_file="")
        threading.Thread(target=s.server.serve_forever, daemon=True).start()
        served.append(s)
    pods = [types.SimpleNamespace(name=f"pod-{i}",
                                  address=f"127.0.0.1:{s.port}")
            for i, s in enumerate(served)]
    router = t_frontdoor.RouterServer(
        "http://unused", discover=_discovery(pods), port=0,
        host="127.0.0.1", poll_interval_s=0.2, page_tokens=4, log=None)
    router.start()
    prompts = [[1, 2, 3, 4, 5, 6, 7, 8, 9], [9, 8], [5, 6, 7, 2, 1],
               [1, 2, 3, 4, 5, 6, 7, 8, 11]]
    try:
        direct = [_http("POST", f"http://{pods[0].address}/generate",
                        {"tokens": [p], "max_new_tokens": 6})[1]["tokens"]
                  for p in prompts]
        assert direct == [_http("POST", f"http://{pods[1].address}/generate",
                                {"tokens": [p], "max_new_tokens": 6}
                                )[1]["tokens"] for p in prompts]
        base = f"http://127.0.0.1:{router.port}"
        routed = [_http("POST", f"{base}/generate",
                        {"tokens": [p], "max_new_tokens": 6})
                  for p in prompts]
        assert routed == [(200, {"tokens": d}) for d in direct]
        # one pod gone: the router fails over and the replies hold
        served[0].server.shutdown()
        served[0].server.server_close()
        routed = [_http("POST", f"{base}/generate",
                        {"tokens": [p], "max_new_tokens": 6})
                  for p in prompts]
        assert routed == [(200, {"tokens": d}) for d in direct]
    finally:
        router.stop()
        for s in served:
            s.engine.stop()
        served[1].server.shutdown()
        served[1].server.server_close()

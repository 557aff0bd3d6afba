"""The port's HTTP API (``dcos_commons_tpu_torch/http``: ``SchedulerApi``
and ``ApiServer``) against the JAX package's, on the CPU, over real
loopback sockets.

Twin ``ApiServer``s serve twin schedulers that the simulation harness
brought to the same state (a two-instance service with a port and a
sidecar plan, deployed):

- every GET route of ``build_routes`` gives the same status code and
  body (JSON, or text for ids, properties, Prometheus and the trace),
  a task's card env (``CUDA_VISIBLE_DEVICES``) mapped out as
  test_torch_scheduler's ``designed`` maps it;
- every verb (interrupt, continue, forceComplete, restart, start and
  stop on plans; restart, replace, pause and resume on pods) gives the
  same reply and leaves the same plan and pod statuses, before and
  after a scheduler cycle;
- an unknown route gives the same 404, and the bearer token is
  enforced the same way (401 without it, ``/v1/health`` open);
- ``/v1/debug/trace`` in both formats, through ``trace/export.py``.

Ids are pinned (``pinned`` of test_torch_scheduler, the span ids'
prefix and counter, and the stores' change-stamp epochs).  The bodies carry wall-clock values (the offer
outcomes' timestamps, the trace's span times, the metrics' timers):
every clock those read is frozen at one instant in both packages, so
they compare exactly; nothing is stripped."""

import itertools
import json
import time
import types
import urllib.error
import uuid
import urllib.request

import pytest

import dcos_commons_tpu.debug.trackers as j_trackers
import dcos_commons_tpu.metrics.registry as j_registry
import dcos_commons_tpu.trace.recorder as j_recorder
import dcos_commons_tpu.trace.span as j_span
from dcos_commons_tpu import http as j_http
from dcos_commons_tpu import testing as j_testing
from dcos_commons_tpu.http import server as j_server
from dcos_commons_tpu.security import auth as j_auth
import dcos_commons_tpu_torch.debug.trackers as t_trackers
import dcos_commons_tpu_torch.metrics.registry as t_registry
import dcos_commons_tpu_torch.trace.recorder as t_recorder
import dcos_commons_tpu_torch.trace.span as t_span
from dcos_commons_tpu_torch import http as t_http
from dcos_commons_tpu_torch import testing as t_testing
from dcos_commons_tpu_torch.http import server as t_server
from dcos_commons_tpu_torch.security import auth as t_auth
from test_torch_plan import PinnedUuid
from test_torch_scheduler import designed, pinned  # noqa: F401

JAX = types.SimpleNamespace(name="jax", http=j_http, server=j_server,
                            testing=j_testing, span=j_span,
                            clocked=(j_trackers, j_registry, j_recorder,
                                     j_span))
PORT = types.SimpleNamespace(name="port", http=t_http, server=t_server,
                             testing=t_testing, span=t_span,
                             clocked=(t_trackers, t_registry, t_recorder,
                                      t_span))
PACKAGES = (JAX, PORT)

YAML = """
name: api-svc
pods:
  web:
    count: 2
    tasks:
      srv:
        goal: RUNNING
        cmd: "serve"
        cpus: 0.1
        memory: 32
        ports:
          http:
            env-key: PORT_HTTP
      once:
        goal: ONCE
        cmd: "backup"
        cpus: 0.1
        memory: 32
plans:
  deploy:
    strategy: serial
    phases:
      web:
        strategy: serial
        pod: web
        steps:
          - default: [[srv]]
  backup:
    strategy: serial
    phases:
      backup-phase:
        strategy: serial
        pod: web
        steps:
          - default: [[once]]
"""

TOKEN = "s3cret-token"


class FrozenClock:
    """``time`` with its clocks stopped at one instant."""

    def time(self):
        return 1_700_000_000.0

    def monotonic(self):
        return 5_000.0

    def perf_counter(self):
        return 5_000.0

    def __getattr__(self, name):
        return getattr(time, name)


class Twin:
    def __init__(self, pkg, token=""):
        t = pkg.testing
        self.pkg = pkg
        self.runner = t.ServiceTestRunner(YAML)
        self.runner.run([
            t.AdvanceCycles(1), t.SendTaskRunning("web-0-srv"),
            t.AdvanceCycles(1), t.SendTaskRunning("web-1-srv"),
            t.ExpectDeploymentComplete(),
        ])
        self.sched = self.runner.world.scheduler
        self.server = pkg.http.ApiServer(self.sched, auth_token=token).start()
        self.token = token

    def call(self, method, path, body=None, token=None):
        token = self.token if token is None else token
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(
            self.server.url + path, method=method,
            data=data if data is not None else (b"" if method != "GET"
                                                else None),
            headers={"Authorization": f"Bearer {token}"} if token else {})
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                code, raw = resp.status, resp.read()
        except urllib.error.HTTPError as e:
            code, raw = e.code, e.read()
        text = raw.decode("utf-8")
        try:
            return code, json.loads(text)
        except json.JSONDecodeError:
            return code, text

    def cycle(self):
        """One scheduler cycle, its launches then reaching their goal
        (the sidecar's ONCE task FINISHED, the server RUNNING), and one
        more cycle to take the statuses."""
        self.sched.run_cycle()
        world = self.runner.world
        t = self.pkg.testing
        ticks = [t.SendTaskFinished(info.name) if info.name.endswith("-once")
                 else t.SendTaskRunning(info.name)
                 for info in world.new_launches()]
        world.launch_watermark = len(world.agent.launched)
        for tick in ticks:
            tick.mutate(world)
        self.sched.run_cycle()

    def stop(self):
        self.server.stop()


def freeze(monkeypatch, clocks):
    """Every clock the API's bodies read stopped at one instant, in both
    packages (``clocks``: the ``pinned`` fixture's)."""
    for pkg in PACKAGES:
        for module in pkg.clocked:
            monkeypatch.setattr(module, "time", FrozenClock())
    for clock in clocks.values():
        clock.t = 1_700_000_000.0


def restart_ids(monkeypatch):
    """The span ids, and the stores' change-stamp epochs (drawn from
    ``uuid`` itself when a store is made), from their first value
    again: a twin made next draws what its sibling drew."""
    for pkg in PACKAGES:
        monkeypatch.setattr(pkg.span, "_ID_PREFIX", "00000000")
        monkeypatch.setattr(pkg.span, "_ID_COUNTER", itertools.count(1))
    monkeypatch.setattr(uuid, "uuid4", PinnedUuid(1 << 40).uuid4)


@pytest.fixture
def twins(pinned, monkeypatch):
    """Both packages' servers over deployed twin schedulers, every clock
    frozen and the ids pinned.  Both packages' 401 body is the module's
    literal for the test: the reference's state server adds keys to its
    shared body, so a test run before this one may have changed it."""
    freeze(monkeypatch, pinned)
    for auth in (j_auth, t_auth):
        monkeypatch.setattr(auth, "UNAUTHORIZED", (
            401, {"message": "missing or invalid bearer token"}))
    made = []

    def make(token=""):
        pair = []
        for pkg in PACKAGES:
            restart_ids(monkeypatch)
            pair.append(Twin(pkg, token))
        made.extend(pair)
        return pair

    yield make
    for twin in made:
        twin.stop()


def both(pair, method, path, body=None, token=None):
    """The reply of both servers, equal once ``designed`` maps the
    port's designed differences out (a task's card env)."""
    out = [twin.call(method, path, body, token) for twin in pair]
    assert (out[1][0], designed(out[1][1], True)) == (
        out[0][0], designed(out[0][1], False)), f"{method} {path}"
    return out[0]


def get_paths(sched):
    """A concrete path for every GET pattern of ``build_routes``."""
    target = sched.config_store.get_target_config()
    return {
        r"/v1/health": ["/v1/health"],
        r"/v1/plans": ["/v1/plans"],
        r"/v1/plans/([^/]+)": ["/v1/plans/deploy", "/v1/plans/backup",
                               "/v1/plans/nope"],
        r"/v1/pod": ["/v1/pod"],
        r"/v1/pod/status": ["/v1/pod/status"],
        r"/v1/pod/([^/]+)/status": ["/v1/pod/web-0/status",
                                    "/v1/pod/web-9/status"],
        r"/v1/pod/([^/]+)/info": ["/v1/pod/web-1/info"],
        r"/v1/configs": ["/v1/configs"],
        r"/v1/configs/targetId": ["/v1/configs/targetId"],
        r"/v1/configs/target": ["/v1/configs/target"],
        r"/v1/configs/([^/]+)": [f"/v1/configs/{target}",
                                 "/v1/configs/missing"],
        r"/v1/state/properties": ["/v1/state/properties"],
        r"/v1/state/properties/([^/]+)": [
            "/v1/state/properties/deployment-completed",
            "/v1/state/properties/missing"],
        r"/v1/state/frameworkId": ["/v1/state/frameworkId"],
        r"/v1/state/zones": ["/v1/state/zones"],
        r"/v1/state/files": ["/v1/state/files"],
        r"/v1/state/files/([^/]+)": ["/v1/state/files/notes.txt",
                                     "/v1/state/files/missing"],
        r"/v1/hosts": ["/v1/hosts"],
        r"/v1/endpoints": ["/v1/endpoints"],
        r"/v1/endpoints/([^/]+)": ["/v1/endpoints/http",
                                   "/v1/endpoints/missing"],
        r"/v1/artifacts/template/([^/]+)/([^/]+)/([^/]+)/([^/]+)": [
            f"/v1/artifacts/template/{target}/web/srv/missing"],
        r"/v1/debug/offers": ["/v1/debug/offers"],
        r"/v1/debug/plans": ["/v1/debug/plans"],
        r"/v1/debug/taskStatuses": ["/v1/debug/taskStatuses"],
        r"/v1/debug/reservations": ["/v1/debug/reservations"],
        r"/v1/debug/trace": ["/v1/debug/trace", "/v1/debug/trace?fmt=chrome",
                             "/v1/debug/trace?fmt=bogus"],
        r"/v1/debug/ha": ["/v1/debug/ha"],
        r"/v1/debug/serving": ["/v1/debug/serving"],
        r"/v1/debug/router": ["/v1/debug/router"],
        r"/v1/debug/health": ["/v1/debug/health",
                              "/v1/debug/health?metric=nope"],
        r"/v1/debug/events": ["/v1/debug/events",
                              "/v1/debug/events?since=1&kind=health",
                              "/v1/debug/events?since=x"],
        r"/v1/metrics/prometheus": ["/v1/metrics/prometheus"],
        r"/v1/metrics": ["/v1/metrics"],
    }


def test_every_get_route_answers_as_the_jax_api(twins):
    pair = twins()
    # an operator file, so the files routes have one to list and read
    both(pair, "PUT", "/v1/state/files/notes.txt", {"content": "hello"})
    paths = get_paths(pair[0].sched)
    for pkg, twin in zip(PACKAGES, pair):
        patterns = [p.pattern[1:-1] for m, p, _, _ in
                    pkg.server.build_routes(twin.server.api) if m == "GET"]
        assert sorted(patterns) == sorted(paths)
    codes = {}
    for path in itertools.chain.from_iterable(paths.values()):
        codes[path] = both(pair, "GET", path)[0]
    assert codes["/v1/plans/deploy"] == 200
    assert codes["/v1/plans/nope"] == 404
    assert codes["/v1/debug/trace?fmt=bogus"] == 400


VERBS = [
    ("POST", "/v1/plans/deploy/interrupt"),
    ("POST", "/v1/plans/deploy/continue"),
    ("POST", "/v1/plans/deploy/restart?phase=web&step=web-1:%5Bsrv%5D"),
    ("POST", "/v1/plans/deploy/forceComplete?phase=web&step=web-1:%5Bsrv%5D"),
    ("POST", "/v1/plans/deploy/restart"),
    ("POST", "/v1/plans/backup/start"),
    ("POST", "/v1/plans/backup/stop"),
    ("POST", "/v1/plans/backup/start"),
    ("POST", "/v1/plans/nope/interrupt"),
    ("POST", "/v1/pod/web-0/restart"),
    ("POST", "/v1/pod/web-1/replace"),
    ("POST", "/v1/pod/web-1/pause"),
    ("POST", "/v1/pod/web-1/pause"),
    ("POST", "/v1/pod/web-1/resume"),
    ("POST", "/v1/pod/web-0/resume"),
    ("POST", "/v1/pod/nope-0/restart"),
    ("POST", "/v1/pod/bogus-x/restart"),
]


def statuses(pair):
    return (both(pair, "GET", "/v1/debug/plans"),
            both(pair, "GET", "/v1/pod/status"))


def test_every_verb_leaves_the_same_statuses(twins):
    pair = twins()
    trace = []
    for method, path in VERBS:
        trace.append((path, both(pair, method, path), statuses(pair)))
        for twin in pair:
            twin.cycle()
        trace.append(("cycle", statuses(pair)))
    replies = {path: reply[0] for path, reply, _ in trace[::2]}
    assert replies["/v1/plans/nope/interrupt"] == 404
    assert replies["/v1/pod/nope-0/restart"] == 404
    assert replies["/v1/pod/web-1/resume"] == 200


def test_unknown_route_is_the_same_404(twins):
    pair = twins()
    for method, path in (("GET", "/v1/nope"), ("POST", "/v1/plans"),
                         ("DELETE", "/v1/plans/deploy"), ("GET", "/")):
        code, body = both(pair, method, path)
        assert code == 404 and body == {
            "message": f"no route {method} {path}"}


def test_bearer_token_is_enforced_the_same_way(twins):
    pair = twins(TOKEN)
    assert both(pair, "GET", "/v1/plans", token="")[0] == 401
    assert both(pair, "GET", "/v1/plans", token="wrong")[0] == 401
    assert both(pair, "POST", "/v1/pod/web-0/restart", token="")[0] == 401
    assert both(pair, "GET", "/v1/health", token="")[0] == 200
    assert both(pair, "GET", "/v1/plans")[0] == 200


def test_state_server_401_leaves_the_api_401_body_alone(twins):
    """In one process the port's state server answers a 401 (its reply
    adds its epoch and role), then the port's API answers one: the
    API's body is still ``UNAUTHORIZED``'s, and so is the module's."""
    from dcos_commons_tpu_torch.storage.persister import MemPersister
    from dcos_commons_tpu_torch.storage.remote import StateServer

    literal = {"message": "missing or invalid bearer token"}
    state = StateServer(MemPersister(), auth_token=TOKEN).start()
    try:
        req = urllib.request.Request(state.url + "/v1/repl/status",
                                     method="POST", data=b"{}")
        with pytest.raises(urllib.error.HTTPError) as denied:
            urllib.request.urlopen(req, timeout=30)
        assert denied.value.code == 401
        body = json.loads(denied.value.read().decode("utf-8"))
        assert set(body) == {"message", "epoch", "role"}
    finally:
        state.stop()
    assert t_auth.UNAUTHORIZED == (401, literal)
    port = twins(TOKEN)[1]
    assert port.call("GET", "/v1/plans", token="") == (401, literal)
    assert port.call("GET", "/v1/plans", token="wrong") == (401, literal)


def test_debug_trace_formats_match_through_the_exporters(twins):
    """The trace routes' bodies are ``trace/export.py``'s text and Chrome
    JSON of the same recorder contents, in both packages."""
    pair = twins()
    text = both(pair, "GET", "/v1/debug/trace")[1]
    chrome = both(pair, "GET", "/v1/debug/trace?fmt=chrome")[1]
    assert isinstance(text, str) and "launch.wal" in text
    assert chrome["traceEvents"]
    from dcos_commons_tpu_torch.trace import export as t_export

    sched = pair[1].sched
    assert t_export.to_chrome(sched.tracer, service="api-svc",
                              steplogs={}) == chrome
    assert t_export.to_text(sched.tracer, service="api-svc", steplogs={},
                            events=sched.journal.events()) == text

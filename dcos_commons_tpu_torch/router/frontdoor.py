"""The HTTP front door: RequestRouter behind real sockets.

Wires the transport-free ``RequestRouter`` (router/core.py) to the
world:

* **discovery** — polls the scheduler's ``GET /v1/endpoints/<name>``
  (the reference's EndpointsResource/VIP surface) for the serve
  pods' live addresses.  The response carries a ``generation`` stamp
  (ledger + task-store mutation counters, http/api.py): an unchanged
  generation costs one compare and NO pod-set rebuild — the
  quiet-fleet discipline applied to discovery.  Backends arrive with
  their scheduler-side state, so a pod entering pause/decommission
  flips to draining here without waiting for its /stats to go dark.
* **stats polling** — each pod's ``GET /stats`` feeds the router's
  staleness-gated telemetry; an unreachable pod simply stops
  refreshing and ages out (router/telemetry.py), it is never scored
  on last-good numbers.
* **the client surface** — ``POST /generate`` routes one request
  (pod errors pass through with their original status; pod deaths
  fail over under the retry budget and 502 only when it is
  exhausted; an empty pod set is 503).  ``GET /stats`` serves the
  router's own watcher-compatible gauges, ``GET /pods`` the per-pod
  debug rows, and ``POST /drain?pod=`` / ``POST /undrain?pod=`` the
  drain runbook's verbs.

The router's gauges mirror to ``servestats.json`` in the sandbox on
the poll cadence, so a router task feeds the scheduler's
/v1/debug/serving, /v1/debug/router, and the ServingSloWatcher
through the exact plumbing serve pods already use.
"""

from __future__ import annotations

import json
import os
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

from dcos_commons_tpu_torch.router.core import (
    ROUTERSTATS_NAME,
    NoPodAvailableError,
    PodTransportError,
    RequestRouter,
)
from dcos_commons_tpu_torch.serve.migration import SessionMigratedError


class PodHttpError(RuntimeError):
    """The pod ANSWERED with an HTTP error — an application verdict,
    passed through to the client verbatim, never retried."""

    def __init__(self, code: int, body: bytes):
        super().__init__(f"pod answered {code}")
        self.code = code
        self.body = body


def http_send(name: str, address: str, request: dict,
              timeout_s: float = 630.0) -> list:
    """POST /generate to one pod.  Connection-level failures raise
    ``PodTransportError`` (no response was produced: safe to fail
    over); HTTP error responses raise ``PodHttpError`` (the pod's
    verdict: pass through).  ``timeout_s`` must sit STRICTLY above
    the pods' SERVE_QUEUE_TIMEOUT_S: a saturated pod answers 503 at
    that mark, and the socket timer firing first would misread
    saturation as pod death (failover storm under load)."""
    payload = json.dumps(request).encode("utf-8")
    req = urllib.request.Request(
        f"http://{address}/generate", data=payload,
        headers={"Content-Type": "application/json"}, method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            body = json.loads(resp.read().decode("utf-8"))
    except urllib.error.HTTPError as e:
        raw = e.read()
        if e.code == 409:
            # the pod moved the session mid-flight (serve/migration.py):
            # 409 {"migrated_to", "dest_rid"} tells the router WHERE to
            # collect the finished tokens — a redirect, not a failure
            try:
                verdict = json.loads(raw.decode("utf-8"))
            except (ValueError, UnicodeDecodeError):
                verdict = {}
            moved_to = verdict.get("migrated_to")
            if isinstance(moved_to, str) and moved_to:
                raise SessionMigratedError(
                    int(verdict.get("rid", -1)), moved_to,
                    int(verdict.get("dest_rid", -1)),
                ) from e
        raise PodHttpError(e.code, raw) from e
    except (urllib.error.URLError, OSError, json.JSONDecodeError) as e:
        raise PodTransportError(f"{name} ({address}): {e}") from e
    tokens = body.get("tokens")
    if not isinstance(tokens, list):
        raise PodTransportError(f"{name} returned a bodiless reply")
    return tokens


def migrate_drain(router: RequestRouter, pod: str, dest: str,
                  timeout_s: float = 120.0) -> dict:
    """Drive the cache-preserving half of ``/drain?pod=X&to=Y``: ask
    the SOURCE pod to migrate its live sessions to ``dest`` (the serve
    worker's one-shot drain verb, serve/migration.py).  Best-effort by
    design — any failure leaves the legacy wait-out drain in charge
    and is reported, never raised (the drain itself already took)."""
    state = router.describe()["pods"]
    src_row, dest_row = state.get(pod), state.get(dest)
    if src_row is None or dest_row is None:
        return {"error": f"unknown pod {pod if src_row is None else dest}"}
    payload = json.dumps({
        "verb": "drain", "dests": {dest: dest_row["address"]},
    }).encode("utf-8")
    req = urllib.request.Request(
        f"http://{src_row['address']}/migrate", data=payload,
        headers={"Content-Type": "application/json"}, method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            return json.loads(resp.read().decode("utf-8"))
    except (urllib.error.URLError, OSError, ValueError) as e:
        return {"error": f"migration drain failed: {e}"}


def fetch_endpoint(scheduler_url: str, endpoint: str,
                   timeout_s: float = 5.0,
                   auth_token: str = "") -> dict:
    """One discovery poll: the scheduler's endpoint body ({name,
    address, generation, backends})."""
    from dcos_commons_tpu_torch.security import auth as _auth

    req = urllib.request.Request(
        f"{scheduler_url}/v1/endpoints/{endpoint}",
        headers=_auth.auth_headers(auth_token),
    )
    with urllib.request.urlopen(req, timeout=timeout_s) as resp:
        return json.loads(resp.read().decode("utf-8"))


def fetch_pod_stats(address: str, timeout_s: float = 5.0) -> dict:
    with urllib.request.urlopen(
        f"http://{address}/stats", timeout=timeout_s
    ) as resp:
        body = json.loads(resp.read().decode("utf-8"))
    return body if isinstance(body, dict) else {}


class RouterServer:
    """The deployable front door: discovery + stats poll loop + the
    client HTTP surface over one ``RequestRouter``."""

    def __init__(
        self,
        scheduler_url: str,
        endpoint: str = "vip:inference",
        port: int = 0,
        host: str = "0.0.0.0",
        poll_interval_s: float = 1.0,
        stats_path: Optional[str] = None,
        auth_token: str = "",
        request_timeout_s: float = 630.0,
        discover: Optional[Callable[[], dict]] = None,
        pod_stats: Optional[Callable[[str], dict]] = None,
        log: Optional[Callable[[str], None]] = print,
        **router_kw,
    ):
        self._scheduler_url = scheduler_url.rstrip("/")
        self._endpoint = endpoint
        self._poll_interval_s = float(poll_interval_s)
        self._stats_path = stats_path
        self._auth_token = auth_token
        self._log = log
        self._discover = discover or (lambda: fetch_endpoint(
            self._scheduler_url, self._endpoint,
            auth_token=self._auth_token,
        ))
        self._pod_stats = pod_stats or fetch_pod_stats
        self.router = RequestRouter(
            send=lambda name, address, request: http_send(
                name, address, request, timeout_s=request_timeout_s,
            ),
            log=log,
            **router_kw,
        )
        self._stop = threading.Event()
        self._poll_thread: Optional[threading.Thread] = None
        # set by refresh_once from BOTH the starting caller and the
        # router-poll thread; an Event gives the flip a memory fence
        # instead of relying on a benign torn bool
        self._refreshed = threading.Event()
        router = self.router

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _reply(self, code: int, body) -> None:
                payload = body if isinstance(body, bytes) else \
                    json.dumps(body).encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/stats":
                    self._reply(200, router.stats())
                elif path == "/pods":
                    self._reply(200, router.describe())
                elif path == "/rebalance":
                    # advisory only: the operator (or remediation)
                    # reads the suggestion and drives the migration
                    self._reply(200, {
                        "suggestion": router.rebalance_suggestion(),
                    })
                else:
                    self._reply(404, {"error": f"no route {path}"})

            def do_POST(self):
                from urllib.parse import parse_qs, urlparse

                parsed = urlparse(self.path)
                if parsed.path in ("/drain", "/undrain"):
                    query = parse_qs(parsed.query)
                    pod = (query.get("pod") or [""])[0]
                    body = {"pod": pod,
                            "draining": parsed.path == "/drain"}
                    if parsed.path == "/drain":
                        # ?to= names the migration destination: the
                        # pod's live sessions move there WITH their
                        # pages (the worker's drain verb) and its
                        # chain claims re-point instead of being
                        # dropped (cache-preserving drain)
                        dest = (query.get("to") or [""])[0]
                        ok = router.drain(pod, migrated_to=dest or None)
                        if ok and dest:
                            body["report"] = migrate_drain(
                                router, pod, dest
                            )
                    else:
                        ok = router.undrain(pod)
                    if ok:
                        self._reply(200, body)
                    else:
                        self._reply(404, {"error": f"no pod {pod}"})
                    return
                if parsed.path != "/generate":
                    self._reply(404, {"error": f"no route {parsed.path}"})
                    return
                length = int(self.headers.get("Content-Length", 0))
                try:
                    body = json.loads(self.rfile.read(length))
                    rows = body["tokens"]
                    if not isinstance(rows, list) or not rows:
                        raise ValueError("tokens must be non-empty")
                    # each row routes independently: sibling rows of
                    # one request may land on DIFFERENT pods (the
                    # router's unit of placement is the row/session)
                    out = [
                        router.submit(
                            row,
                            int(body.get("max_new_tokens", 32)),
                            temperature=float(
                                body.get("temperature", 0.0)
                            ),
                            eos=body.get("eos"),
                        )
                        for row in rows
                    ]
                    self._reply(200, {"tokens": out})
                except PodHttpError as e:
                    self._reply(e.code, e.body)  # the pod's verdict
                except NoPodAvailableError as e:
                    self._reply(503, {"error": str(e)})
                except PodTransportError as e:
                    self._reply(502, {"error": str(e)})
                except Exception as e:  # noqa: BLE001 — caller error
                    self._reply(400, {"error": str(e)})

        try:
            self._server = ThreadingHTTPServer((host, port), Handler)
        except OSError:
            # assigned port taken on a shared machine: bind ephemeral
            # and ADVERTISE it (the endpoints `advertise: true` flow)
            self._server = ThreadingHTTPServer((host, 0), Handler)
            if log is not None:
                log(f"router: port {port} in use; bound "
                    f"{self._server.server_address[1]} instead")
        self.router.annotate_stats(
            http_port=int(self._server.server_address[1])
        )
        self._serve_thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    # -- the poll loop ------------------------------------------------

    def refresh_once(self) -> None:
        """One discovery + stats round (also the deterministic test
        surface).  Discovery failures leave the last-known pod set
        serving — a scheduler failover must not blind the front door;
        stats failures age the pod out through the staleness gate."""
        try:
            body = self._discover()
        except Exception as e:  # noqa: BLE001 — keep serving on last-known
            if self._log is not None:
                self._log(f"router: discovery failed: {e}")
        else:
            backends: Dict[str, dict] = {}
            for entry in body.get("backends", []):
                backends[entry.get("task", entry["address"])] = entry
            if not backends:
                # bare address lists (older scheduler): synthesize
                backends = {
                    addr: {"address": addr}
                    for addr in body.get("address", [])
                }
            self.router.update_pods(
                backends, generation=body.get("generation")
            )
        state = self.router.describe()
        for name, row in state["pods"].items():
            if row["discovery_draining"]:
                # scheduler-side drain: the pod is pausing/replacing
                # and its stats are going away.  An OPERATOR-drained
                # pod keeps being polled — its gauges show the drain
                # progressing, and undrain needs them fresh.
                continue
            try:
                stats = self._pod_stats(row["address"])
            except Exception:  # noqa: BLE001, sdklint: disable=swallowed-exception — an unreachable pod ages out through the staleness gate; liveness is the scheduler's job
                continue
            self.router.observe_stats(name, stats)
        if self._stats_path is not None:
            self.router.write_stats(self._stats_path)
        self._refreshed.set()

    def _poll_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.refresh_once()
            except Exception as e:  # noqa: BLE001 — the loop must survive
                if self._log is not None:
                    self._log(f"router: poll round failed: {e}")
            self._stop.wait(self._poll_interval_s)

    def _start_polling(self) -> None:
        """One shared startup sequence for both entry points: the
        first request must see a pod set (skip the refresh only when
        the caller already ran one, e.g. a readiness gate)."""
        if not self._refreshed.is_set():
            self.refresh_once()
        self._poll_thread = threading.Thread(
            target=self._poll_loop, name="router-poll", daemon=True
        )
        self._poll_thread.start()

    def start(self) -> "RouterServer":
        self._start_polling()
        self._serve_thread = threading.Thread(
            target=self._server.serve_forever, name="router-http",
            daemon=True,
        )
        self._serve_thread.start()
        return self

    def serve_forever(self) -> None:
        self._start_polling()
        self._server.serve_forever()

    def stop(self) -> None:
        self._stop.set()
        self._server.shutdown()
        self._server.server_close()
        if self._poll_thread is not None:
            self._poll_thread.join(timeout=10)


def default_stats_path() -> str:
    return os.path.join(os.environ.get("SANDBOX", "."), ROUTERSTATS_NAME)

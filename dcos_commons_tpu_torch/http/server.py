"""Threaded HTTP server mapping /v1 routes onto SchedulerApi.

Reference: framework/ApiServer.java — the Jetty server started before
offers are accepted (FrameworkRunner.java:130-138).  Stdlib-only:
ThreadingHTTPServer + a small regex router; JSON in/out.

Port of ``dcos_commons_tpu/http/server.py``, line for line but the imports.
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from dcos_commons_tpu_torch.http.api import SchedulerApi

Route = Tuple[str, re.Pattern, Callable, bool]


def compile_route(method: str, pattern: str, handler: Callable,
                  wants_body: bool = False) -> Route:
    """The one anchoring rule for every route, built-in or custom.
    ``wants_body`` handlers receive a third argument: the request's
    parsed JSON body (``{}`` when absent/invalid)."""
    return (method, re.compile(f"^{pattern}$"), handler, wants_body)


def build_routes(api: SchedulerApi) -> List[Route]:
    r = compile_route

    # handlers receive (match, query) and return (code, body)
    return [
        r("GET", r"/v1/health", lambda m, q: api.health()),
        # plans (verbs accept ?phase= & ?step=, as the reference's POST
        # bodies/params do — PlansQueries.java:47-231)
        r("GET", r"/v1/plans", lambda m, q: api.list_plans()),
        r("GET", r"/v1/plans/([^/]+)", lambda m, q: api.get_plan(m.group(1))),
        r("POST", r"/v1/plans/([^/]+)/interrupt",
          lambda m, q: api.plan_interrupt(m.group(1), _one(q, "phase"),
                                          _one(q, "step"))),
        r("POST", r"/v1/plans/([^/]+)/continue",
          lambda m, q: api.plan_continue(m.group(1), _one(q, "phase"),
                                         _one(q, "step"))),
        r("POST", r"/v1/plans/([^/]+)/forceComplete",
          lambda m, q: api.plan_force_complete(m.group(1), _one(q, "phase"),
                                               _one(q, "step"))),
        r("POST", r"/v1/plans/([^/]+)/restart",
          lambda m, q: api.plan_restart(m.group(1), _one(q, "phase"),
                                        _one(q, "step"))),
        r("POST", r"/v1/plans/([^/]+)/start",
          lambda m, q, body: api.plan_start(m.group(1), body.get("env")),
          True),
        r("POST", r"/v1/plans/([^/]+)/stop",
          lambda m, q: api.plan_stop(m.group(1))),
        # pods
        r("GET", r"/v1/pod", lambda m, q: api.list_pods()),
        r("GET", r"/v1/pod/status", lambda m, q: api.pod_statuses()),
        r("GET", r"/v1/pod/([^/]+)/status",
          lambda m, q: api.pod_status(m.group(1))),
        r("GET", r"/v1/pod/([^/]+)/info",
          lambda m, q: api.pod_info(m.group(1))),
        r("POST", r"/v1/pod/([^/]+)/restart",
          lambda m, q: api.pod_restart(m.group(1))),
        r("POST", r"/v1/pod/([^/]+)/replace",
          lambda m, q: api.pod_replace(m.group(1))),
        r("POST", r"/v1/pod/([^/]+)/pause",
          lambda m, q: api.pod_pause(m.group(1), q.get("task"))),
        r("POST", r"/v1/pod/([^/]+)/resume",
          lambda m, q: api.pod_resume(m.group(1), q.get("task"))),
        # manual scale: {"count": N} — rides the autoscale
        # plan machinery, honoring the single-flight rule; /abandon
        # drops an in-flight action, settling the count to deployed
        # reality
        r("POST", r"/v1/pod/([^/]+)/scale/abandon",
          lambda m, q: api.pod_scale_abandon(m.group(1))),
        r("POST", r"/v1/pod/([^/]+)/scale",
          lambda m, q, body: api.pod_scale(m.group(1), body), True),
        # configs
        r("GET", r"/v1/configs", lambda m, q: api.list_configs()),
        r("GET", r"/v1/configs/targetId", lambda m, q: api.target_config_id()),
        r("GET", r"/v1/configs/target", lambda m, q: api.target_config()),
        r("GET", r"/v1/configs/([^/]+)",
          lambda m, q: api.get_config(m.group(1))),
        # state
        r("GET", r"/v1/state/properties",
          lambda m, q: api.state_properties()),
        r("GET", r"/v1/state/properties/([^/]+)",
          lambda m, q: api.state_property(m.group(1))),
        r("GET", r"/v1/state/frameworkId",
          lambda m, q: api.state_framework_id()),
        r("GET", r"/v1/state/zones", lambda m, q: api.state_zones()),
        # operator files in the state store (StateQueries.java:78)
        r("GET", r"/v1/state/files", lambda m, q: api.state_files()),
        r("GET", r"/v1/state/files/([^/]+)",
          lambda m, q: api.state_file_get(m.group(1))),
        r("PUT", r"/v1/state/files/([^/]+)",
          lambda m, q, body: api.state_file_put(m.group(1), body),
          True),
        # hosts: preemption & maintenance lifecycle — the
        # drain verb excludes the host from placement and flips its
        # serve backends to draining BEFORE anything is killed;
        # preempt surfaces an involuntary capacity loss (tasks LOST,
        # gang recovery synthesized); up returns the host to service
        r("GET", r"/v1/hosts", lambda m, q: api.list_hosts()),
        r("POST", r"/v1/hosts/([^/]+)/drain",
          lambda m, q, body: api.host_drain(m.group(1), body), True),
        r("POST", r"/v1/hosts/([^/]+)/preempt",
          lambda m, q: api.host_preempt(m.group(1))),
        r("POST", r"/v1/hosts/([^/]+)/up",
          lambda m, q: api.host_up(m.group(1))),
        # endpoints
        r("GET", r"/v1/endpoints", lambda m, q: api.list_endpoints()),
        r("GET", r"/v1/endpoints/([^/]+)",
          lambda m, q: api.get_endpoint(m.group(1))),
        # artifacts
        r("GET", r"/v1/artifacts/template/([^/]+)/([^/]+)/([^/]+)/([^/]+)",
          lambda m, q: api.artifact_template(
              m.group(1), m.group(2), m.group(3), m.group(4))),
        # debug
        r("GET", r"/v1/debug/offers", lambda m, q: api.debug_offers()),
        r("GET", r"/v1/debug/plans", lambda m, q: api.debug_plans()),
        r("GET", r"/v1/debug/taskStatuses",
          lambda m, q: api.debug_task_statuses()),
        r("GET", r"/v1/debug/reservations",
          lambda m, q: api.debug_reservations()),
        # traceview: text timeline, or ?fmt=chrome for Perfetto
        r("GET", r"/v1/debug/trace",
          lambda m, q: api.debug_trace(_one(q, "fmt"))),
        # HA: leader lease, fencing epoch, standby watermarks, the
        # last re-hydration report (the failover runbook's dashboard)
        r("GET", r"/v1/debug/ha",
          lambda m, q: api.debug_ha()),
        # serving load: per-pod slot-engine gauges (queue depth,
        # active slots, KV occupancy, tokens/s) merged from sandboxes
        r("GET", r"/v1/debug/serving",
          lambda m, q: api.debug_serving()),
        # serving front door: per-router gauge snapshots (pod set,
        # affinity hit rate, failovers) + the endpoint generation
        r("GET", r"/v1/debug/router",
          lambda m, q: api.debug_router()),
        # fleet health plane: detector states, suspect hosts, metric
        # history (?metric=<name> for one full series)
        r("GET", r"/v1/debug/health",
          lambda m, q: api.debug_health(_one(q, "metric"))),
        # durable event journal (?since=<seq> cursor, ?kind= filter)
        r("GET", r"/v1/debug/events",
          lambda m, q: api.debug_events(_one(q, "since"),
                                        _one(q, "kind"))),
        # metrics
        r("GET", r"/v1/metrics/prometheus",
          lambda m, q: api.metrics_prometheus()),
        r("GET", r"/v1/metrics", lambda m, q: api.metrics_json()),
    ]


def _one(query: dict, key: str) -> Optional[str]:
    values = query.get(key)
    return values[0] if values else None


def _multi_health(multi) -> tuple:
    """Aggregate /v1/health for multi-service mode: unhealthy when the
    multi loop flagged fatal or any service's plans carry errors."""
    fatal = getattr(multi, "fatal_error", None)
    services = {}
    has_errors = False
    for name, svc in multi.services().items():
        plans = svc.plans()
        errors = any(p.has_errors() for p in plans.values())
        has_errors = has_errors or errors
        services[name] = {
            "plans": {n: p.get_status().value for n, p in plans.items()},
            "errors": errors,
        }
    healthy = fatal is None and not has_errors
    body = {"healthy": healthy, "services": services}
    if fatal is not None:
        body["fatal_error"] = fatal
    return (200 if healthy else 503), body


class ApiServer:
    """Reference: framework/ApiServer.java — started before the event
    loop accepts work; ``port=0`` binds an ephemeral port (tests).

    Multi-service mode (``multi=``): /v1/multi lists/adds/removes
    services, and /v1/multi/<name>/v1/... routes any single-service
    path to that service (reference: http/endpoints/Multi*.java route
    per-service by name)."""

    def __init__(self, scheduler=None, port: int = 0, host: str = "127.0.0.1",
                 multi=None, extra_routes=None, auth_token: str = "",
                 tls=None):
        # cluster bearer token (security/auth.py): when set, every
        # route but /v1/health requires Authorization — the reference
        # fronts its API with admin-router auth; tls=(cert, key) files
        # serve HTTPS issued by the in-repo CA
        from dcos_commons_tpu_torch.security import auth as _auth
        # frameworks may register CUSTOM endpoints (reference:
        # Cassandra's SeedsResource, wired in each Main.java):
        # extra_routes is [(method, pattern, handler(match, query))],
        # compiled like the built-ins and matched FIRST
        routes = [compile_route(*entry) for entry in (extra_routes or [])]
        # the api object is long-lived and swappable: a live options
        # update (POST /v1/update) rebuilds the scheduler in-process
        # and repoints this server at it via set_scheduler(); custom
        # routes (which close over the scheduler) are refreshed via
        # set_extra_routes at the same time
        self.api = SchedulerApi(scheduler) if scheduler else None
        routes += build_routes(self.api) if self.api else []
        self._routes = routes
        self._extra_count = len(extra_routes or [])
        multi_scheduler = multi

        class Handler(BaseHTTPRequestHandler):
            # quiet request logging (structured logs belong to the app)
            def log_message(self, fmt, *args):
                pass

            def _dispatch(self, method: str) -> None:
                parsed = urlparse(self.path)
                query = parse_qs(parsed.query)
                if parsed.path != "/v1/health" and not _auth.check_bearer(
                    self.headers, auth_token
                ):
                    self._reply(*_auth.UNAUTHORIZED)
                    return
                if multi_scheduler is not None and \
                        parsed.path.startswith("/v1/multi"):
                    code, body = self._dispatch_multi(
                        method, parsed.path, query
                    )
                    self._reply(code, body)
                    return
                # snapshot: set_extra_routes may splice concurrently
                for route_method, pattern, handler, wants_body in list(routes):
                    if route_method != method:
                        continue
                    match = pattern.match(parsed.path)
                    if match is None:
                        continue
                    try:
                        if wants_body:
                            code, body = handler(match, query,
                                                 self._json_body())
                        else:
                            code, body = handler(match, query)
                    except Exception as e:  # surface, don't kill the server
                        code, body = 500, {"message": f"internal error: {e}"}
                    self._reply(code, body)
                    return
                if multi_scheduler is not None and method == "GET" and \
                        parsed.path == "/v1/health":
                    # aggregate health in multi-only mode (per-service
                    # health is /v1/multi/<name>/v1/health)
                    self._reply(*_multi_health(multi_scheduler))
                    return
                self._reply(404, {"message": f"no route {method} {parsed.path}"})

            def _dispatch_multi(self, method: str, path: str, query):
                rest = path[len("/v1/multi"):].strip("/")
                if not rest:
                    if method == "GET":
                        return 200, multi_scheduler.service_names()
                    return 405, {"message": "use GET /v1/multi"}
                if rest == "events" and method == "GET":
                    # the fleet-level event journal (admission
                    # rejections, service add/uninstall); per-service
                    # journals live at /v1/multi/<name>/v1/debug/events
                    journal = getattr(multi_scheduler, "journal", None)
                    if journal is None:
                        return 200, {"events": [], "seq": 0}
                    try:
                        since = int((query.get("since") or ["0"])[0])
                    except ValueError:
                        return 400, {"message": "bad since cursor"}
                    return 200, {
                        "events": journal.events(since=since),
                        "seq": journal.last_seq,
                        "journal": journal.describe(),
                    }
                if rest == "hosts" and method == "GET":
                    # fleet host states (the shared inventory)
                    inv = getattr(multi_scheduler, "inventory", None)
                    if inv is None or not hasattr(inv, "host_states"):
                        return 200, {"hosts": {}}
                    return 200, {"hosts": inv.host_states()}
                if rest.startswith("hosts/") and method == "POST":
                    # fleet-level host lifecycle: one inventory mark,
                    # preemption stamping fanned out to every service
                    parts = rest.split("/")
                    if len(parts) == 3:
                        _, host_id, verb = parts
                        try:
                            if verb == "drain":
                                body = self._json_body()
                                window_s = float(
                                    body.get("window_s", 0) or 0
                                )
                                changed = multi_scheduler.drain_host(
                                    host_id, window_s=window_s
                                )
                                return 200, {
                                    "host": host_id,
                                    "state": "maintenance",
                                    "changed": changed,
                                }
                            if verb == "preempt":
                                lost = multi_scheduler.preempt_host(
                                    host_id
                                )
                                return 200, {
                                    "host": host_id,
                                    "state": "preempted",
                                    "tasks_lost": lost,
                                }
                            if verb == "up":
                                changed = multi_scheduler.undrain_host(
                                    host_id
                                )
                                return 200, {
                                    "host": host_id,
                                    "state": "up",
                                    "changed": changed,
                                }
                        except KeyError:
                            return 404, {
                                "message": f"no host {host_id}"
                            }
                        except (TypeError, ValueError) as e:
                            return 400, {"message": str(e)}
                    return 404, {
                        "message": f"no route {method} /v1/multi/{rest}"
                    }
                name, _, sub = rest.partition("/")
                if name in ("events", "hosts") and method == "PUT" \
                        and not sub:
                    # reserved: GET /v1/multi/events is the fleet
                    # journal and /v1/multi/hosts the fleet host
                    # surface — a service deployed under either name
                    # would have its bare-name routes shadowed
                    return 400, {
                        "message": f"service name {name!r} is reserved "
                                   "(fleet route)"
                    }
                if method == "PUT" and not sub:
                    # body: service YAML, or a framework package
                    # tarball (Content-Type: application/gzip — the
                    # Cosmos install flow; reference: dynamic add via
                    # MultiServiceResource / ServiceStore).  With
                    # ?upgrade=true an existing service takes the new
                    # package version (Cosmos `update`): validated
                    # config diff -> rolling update over live state
                    length = int(self.headers.get("Content-Length", 0))
                    body = self.rfile.read(length)
                    ctype = self.headers.get("Content-Type", "")
                    upgrade = (query.get("upgrade") or ["false"])[0] \
                        .lower() in ("1", "true", "yes")
                    # operator options ride a header (the body is the
                    # tarball): base64 of the Cosmos-style options JSON
                    options = None
                    opts_header = self.headers.get("X-Service-Options")
                    if opts_header:
                        import base64 as _b64

                        try:
                            options = json.loads(
                                _b64.b64decode(opts_header)
                            )
                        except (ValueError, TypeError) as e:
                            return 400, {
                                "message": f"bad X-Service-Options: {e}"
                            }
                    from dcos_commons_tpu_torch.multi.admission import (
                        AdmissionError,
                        validate_service_yaml,
                    )

                    try:
                        if "gzip" in ctype or body[:2] == b"\x1f\x8b":
                            multi_scheduler.install_package(
                                name, body, upgrade=upgrade,
                                options=options,
                            )
                            return 200, {
                                "message": f"package {name} "
                                f"{'upgraded' if upgrade else 'installed'}"
                            }
                        if options is not None:
                            # silently ignoring operator options would
                            # contradict the plane's whole point
                            return 400, {
                                "message": "options apply to package "
                                           "installs (gzip body) only",
                            }
                        # admission control: the CI analyzers run as
                        # production guardrails BEFORE ServiceStore
                        # persists anything; a rejected spec returns
                        # 422 with line-anchored findings, an admitted
                        # one is stored unchanged
                        spec, findings = validate_service_yaml(
                            body.decode("utf-8"), name,
                            inventory=getattr(
                                multi_scheduler, "inventory", None
                            ),
                        )
                        if findings:
                            raise AdmissionError(findings)
                        multi_scheduler.add_service(spec)
                    except AdmissionError as e:
                        # journal the rejection: the operator who
                        # PUT a bad spec is not always the operator
                        # who later asks "why did nothing deploy?"
                        journal = getattr(
                            multi_scheduler, "journal", None
                        )
                        if journal is not None:
                            journal.append(
                                "admission",
                                service=name,
                                findings=len(e.findings),
                                message=(
                                    f"spec for {name!r} rejected: "
                                    + "; ".join(
                                        f.message for f in e.findings[:3]
                                    )
                                ),
                            )
                            journal.flush()
                        return 422, {
                            "message": f"spec rejected by admission "
                                       f"control ({len(e.findings)} "
                                       "finding(s))",
                            "findings": [
                                f.to_dict() for f in e.findings
                            ],
                        }
                    except Exception as e:
                        return 400, {"message": str(e)}
                    return 200, {"message": f"service {name} added"}
                if method == "DELETE" and not sub:
                    try:
                        multi_scheduler.uninstall_service(name)
                    except KeyError:
                        return 404, {"message": f"no service {name}"}
                    return 200, {"message": f"service {name} uninstalling"}
                service = multi_scheduler.get_service(name)
                if service is None:
                    return 404, {"message": f"no service {name}"}
                sub_path = f"/{sub}" if sub.startswith("v1") else f"/v1/{sub}"
                sub_routes = build_routes(SchedulerApi(service))
                for route_method, pattern, handler, wants_body in sub_routes:
                    if route_method != method:
                        continue
                    match = pattern.match(sub_path)
                    if match is None:
                        continue
                    try:
                        if wants_body:
                            return handler(match, query, self._json_body())
                        return handler(match, query)
                    except Exception as e:
                        return 500, {"message": f"internal error: {e}"}
                return 404, {"message": f"no route {method} {sub_path}"}

            def _json_body(self) -> dict:
                length = int(self.headers.get("Content-Length", 0))
                if not length:
                    return {}
                raw = self.rfile.read(length)
                try:
                    parsed_body = json.loads(raw.decode("utf-8"))
                except (ValueError, UnicodeDecodeError):
                    return {}
                return parsed_body if isinstance(parsed_body, dict) else {}

            def _reply(self, code: int, body) -> None:
                if isinstance(body, str):
                    payload = body.encode("utf-8")
                    content_type = "text/plain; charset=utf-8"
                else:
                    payload = json.dumps(body, indent=2).encode("utf-8")
                    content_type = "application/json"
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def do_GET(self):
                self._dispatch("GET")

            def do_POST(self):
                self._dispatch("POST")

            def do_PUT(self):
                self._dispatch("PUT")

            def do_DELETE(self):
                self._dispatch("DELETE")

        self._server = _auth.wrap_http_server(
            ThreadingHTTPServer((host, port), Handler), tls
        )
        self._scheme = _auth.url_scheme(tls)
        self._thread: Optional[threading.Thread] = None

    def set_scheduler(self, scheduler) -> None:
        """Repoint every route at a freshly-rebuilt scheduler (live
        config update — the process and its listening socket survive)."""
        if self.api is not None:
            self.api.set_scheduler(scheduler)

    def set_extra_routes(self, extra_routes) -> None:
        """Replace the CUSTOM route block (framework endpoints close
        over the scheduler object, so a live update must rebuild them
        too or they would keep serving the pre-update scheduler)."""
        compiled = [compile_route(*entry) for entry in extra_routes]
        self._routes[: self._extra_count] = compiled
        self._extra_count = len(compiled)

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    @property
    def url(self) -> str:
        host, port = self._server.server_address[:2]
        return f"{self._scheme}://{host}:{port}"

    def start(self) -> "ApiServer":
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="api-server", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()

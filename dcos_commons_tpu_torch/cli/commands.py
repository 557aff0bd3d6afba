"""argparse command tree mirroring the reference CLI's sections.

Reference: cli/commands.go:39,56 (HandleDefaultSections: config,
debug, endpoints, plan, pod, state, update) and the verb sets in
cli/commands/{plan,pod,config,state,endpoints,debug}.go.

Port of ``dcos_commons_tpu/cli/commands.py``, line for line but the imports; its ``prog``, help
and JSON output are the reference's, so the two CLIs are
interchangeable on the wire.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, List, Optional

from dcos_commons_tpu_torch.cli.client import ApiClient, CliError


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="tpusvc",
        description="Operator CLI for a tpu-service-sdk scheduler",
    )
    parser.add_argument(
        "--url",
        default=os.environ.get("SCHEDULER_API_URL", "http://127.0.0.1:8080"),
        help="scheduler API base URL (default: $SCHEDULER_API_URL)",
    )
    parser.add_argument(
        "--auth-token-file",
        default="",
        help="cluster bearer token file; also $AUTH_TOKEN(_FILE)",
    )
    parser.add_argument(
        "--tls-ca",
        default=os.environ.get("TLS_CA_FILE", ""),
        help="CA bundle for verifying an HTTPS scheduler "
             "(default: $TLS_CA_FILE)",
    )
    sections = parser.add_subparsers(dest="section", required=True)

    # plan (reference: cli/commands/plan.go:51-90)
    plan = sections.add_parser("plan").add_subparsers(dest="verb", required=True)
    plan.add_parser("list")
    for verb in ("show", "status"):
        p = plan.add_parser(verb)
        p.add_argument("plan")
    p = plan.add_parser("pause")   # = interrupt
    p.add_argument("plan")
    p.add_argument("phase", nargs="?")
    p = plan.add_parser("resume")  # = continue
    p.add_argument("plan")
    p.add_argument("phase", nargs="?")
    p = plan.add_parser("force-restart")
    p.add_argument("plan")
    p.add_argument("phase", nargs="?")
    p.add_argument("step", nargs="?")
    p = plan.add_parser("force-complete")
    p.add_argument("plan")
    p.add_argument("phase")
    p.add_argument("step")
    p = plan.add_parser("start")
    p.add_argument("plan")
    p.add_argument(
        "-p", "--param", action="append", default=[], metavar="KEY=VALUE",
        help="env override launched into every task of the plan "
             "(reference: `plan start <plan> -p KEY=VALUE`)",
    )
    p = plan.add_parser("stop")
    p.add_argument("plan")

    # pod (reference: cli/commands/pod.go)
    pod = sections.add_parser("pod").add_subparsers(dest="verb", required=True)
    pod.add_parser("list")
    p = pod.add_parser("status")
    p.add_argument("pod", nargs="?")
    for verb in ("info", "restart", "replace"):
        p = pod.add_parser(verb)
        p.add_argument("pod")
    for verb in ("pause", "resume"):
        p = pod.add_parser(verb)
        p.add_argument("pod")
        p.add_argument("-t", "--tasks", action="append")
    # manual scale: rides the autoscale plan machinery,
    # single-flight with any automated action on the same pod;
    # scale-abandon drops an in-flight action (count settles to
    # deployed reality, the direction's cooldown latches)
    p = pod.add_parser("scale")
    p.add_argument("pod", help="pod TYPE (not an instance)")
    p.add_argument("count", type=int)
    p = pod.add_parser("scale-abandon")
    p.add_argument("pod", help="pod TYPE (not an instance)")

    # config
    config = sections.add_parser("config").add_subparsers(
        dest="verb", required=True
    )
    config.add_parser("list")
    p = config.add_parser("show")
    p.add_argument("config_id")
    config.add_parser("target")
    config.add_parser("target_id")

    # state
    state = sections.add_parser("state").add_subparsers(
        dest="verb", required=True
    )
    state.add_parser("properties")
    p = state.add_parser("property")
    p.add_argument("key")
    state.add_parser("framework_id")
    state.add_parser("zones")

    # endpoints
    p = sections.add_parser("endpoints")
    p.add_argument("name", nargs="?")

    # hosts: preemption & maintenance lifecycle
    host = sections.add_parser("host").add_subparsers(
        dest="verb", required=True
    )
    host.add_parser("list")
    p = host.add_parser("drain")
    p.add_argument("host_id")
    p.add_argument(
        "--window-s", type=float, default=0.0, metavar="SECONDS",
        help="maintenance window length; a finite window makes elastic "
             "gang recovery wait for the capacity instead of shrinking",
    )
    for verb in ("preempt", "up"):
        p = host.add_parser(verb)
        p.add_argument("host_id")

    # debug
    p = sections.add_parser("debug")
    p.add_argument(
        "tracker",
        choices=["offers", "plans", "taskStatuses", "reservations",
                 "health", "events", "router", "serving"],
    )
    p.add_argument(
        "--metric", default=None, metavar="NAME",
        help="(health) return one metric's full timestamped history "
             "series instead of the summary rows",
    )
    p.add_argument(
        "--since", default=None, metavar="SEQ",
        help="(events) resume the journal cursor past this sequence "
             "number (seqs survive scheduler failovers)",
    )
    p.add_argument(
        "--kind", default=None, metavar="KIND",
        help="(events) filter to one event kind, e.g. alert, operator, "
             "plan, election, recovery, admission",
    )

    # update (reference: cli/commands/update.go — `update start
    # --options=...` pushes new options to the RUNNING scheduler,
    # `update status` watches the resulting rolling update plan)
    update = sections.add_parser("update").add_subparsers(
        dest="verb", required=True
    )
    p = update.add_parser("start")
    p.add_argument(
        "-p", "--param", action="append", default=[], metavar="KEY=VALUE",
        help="service option override (svc.yml template env), e.g. "
             "-p SLEEP_DURATION=30",
    )
    update.add_parser("status")

    sections.add_parser("metrics")
    sections.add_parser("health")
    return parser


def run(args: argparse.Namespace) -> Any:
    from dcos_commons_tpu_torch.security.auth import load_token

    client = ApiClient(
        args.url,
        auth_token=load_token(token_file=getattr(args, "auth_token_file", "")),
        ca_file=getattr(args, "tls_ca", ""),
    )
    section = args.section
    if section == "plan":
        return _plan(client, args)
    if section == "pod":
        return _pod(client, args)
    if section == "config":
        return _config(client, args)
    if section == "state":
        return _state(client, args)
    if section == "endpoints":
        if args.name:
            return client.get(f"/v1/endpoints/{args.name}")
        return client.get("/v1/endpoints")
    if section == "host":
        return _host(client, args)
    if section == "debug":
        return _debug(client, args)
    if section == "update":
        return _update(client, args)
    if section == "metrics":
        return client.get("/v1/metrics")
    if section == "health":
        return client.get("/v1/health")
    raise CliError(0, f"unknown section {section}")


def _host(client: ApiClient, args) -> Any:
    if args.verb == "list":
        return client.get("/v1/hosts")
    if args.verb == "drain":
        return client.post(
            f"/v1/hosts/{args.host_id}/drain",
            body={"window_s": args.window_s},
        )
    return client.post(f"/v1/hosts/{args.host_id}/{args.verb}")


def _debug(client: ApiClient, args) -> Any:
    from urllib.parse import urlencode

    params = {}
    if args.tracker == "health" and args.metric:
        params["metric"] = args.metric
    if args.tracker == "events":
        if args.since:
            params["since"] = args.since
        if args.kind:
            params["kind"] = args.kind
    path = f"/v1/debug/{args.tracker}"
    if params:
        path = f"{path}?{urlencode(params)}"
    return client.get(path)


def _update(client: ApiClient, args) -> Any:
    if args.verb == "start":
        env = _parse_params(getattr(args, "param", None))
        if not env:
            raise CliError(0, "update start needs at least one -p KEY=VALUE")
        return client.post("/v1/update", body={"env": env})
    if args.verb == "status":
        # the rolling update runs as the deploy/update plan
        plans = client.get("/v1/plans")
        name = "update" if "update" in plans else "deploy"
        return client.get(f"/v1/plans/{name}")
    raise CliError(0, f"unknown update verb {args.verb}")


def _parse_params(pairs) -> dict:
    env = {}
    for pair in pairs or []:
        key, sep, value = pair.partition("=")
        if not sep or not key:
            raise CliError(0, f"bad --param {pair!r}; want KEY=VALUE")
        env[key] = value
    return env


def _plan(client: ApiClient, args) -> Any:
    verb = args.verb
    if verb == "list":
        return client.get("/v1/plans")
    if verb in ("show", "status"):
        return client.get(f"/v1/plans/{args.plan}")
    params = {"phase": getattr(args, "phase", None),
              "step": getattr(args, "step", None)}
    if verb == "pause":
        return client.post(f"/v1/plans/{args.plan}/interrupt", params)
    if verb == "resume":
        return client.post(f"/v1/plans/{args.plan}/continue", params)
    if verb == "force-restart":
        return client.post(f"/v1/plans/{args.plan}/restart", params)
    if verb == "force-complete":
        return client.post(f"/v1/plans/{args.plan}/forceComplete", params)
    if verb == "start":
        env = _parse_params(getattr(args, "param", None))
        return client.post(
            f"/v1/plans/{args.plan}/start",
            body={"env": env} if env else None,
        )
    if verb == "stop":
        return client.post(f"/v1/plans/{args.plan}/stop")
    raise CliError(0, f"unknown plan verb {verb}")


def _pod(client: ApiClient, args) -> Any:
    verb = args.verb
    if verb == "list":
        return client.get("/v1/pod")
    if verb == "status":
        if args.pod:
            return client.get(f"/v1/pod/{args.pod}/status")
        return client.get("/v1/pod/status")
    if verb == "info":
        return client.get(f"/v1/pod/{args.pod}/info")
    if verb in ("restart", "replace"):
        return client.post(f"/v1/pod/{args.pod}/{verb}")
    if verb == "scale":
        return client.post(
            f"/v1/pod/{args.pod}/scale", body={"count": args.count}
        )
    if verb == "scale-abandon":
        return client.post(f"/v1/pod/{args.pod}/scale/abandon")
    if verb in ("pause", "resume"):
        params = {}
        if args.tasks:
            params["task"] = args.tasks
        return client.post(f"/v1/pod/{args.pod}/{verb}", params or None)
    raise CliError(0, f"unknown pod verb {verb}")


def _config(client: ApiClient, args) -> Any:
    verb = args.verb
    if verb == "list":
        return client.get("/v1/configs")
    if verb == "show":
        return client.get(f"/v1/configs/{args.config_id}")
    if verb == "target":
        return client.get("/v1/configs/target")
    if verb == "target_id":
        return client.get("/v1/configs/targetId")
    raise CliError(0, f"unknown config verb {verb}")


def _state(client: ApiClient, args) -> Any:
    verb = args.verb
    if verb == "properties":
        return client.get("/v1/state/properties")
    if verb == "property":
        return client.get(f"/v1/state/properties/{args.key}")
    if verb == "framework_id":
        return client.get("/v1/state/frameworkId")
    if verb == "zones":
        return client.get("/v1/state/zones")
    raise CliError(0, f"unknown state verb {verb}")


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    try:
        result = run(args)
    except CliError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if isinstance(result, str):
        print(result)
    else:
        print(json.dumps(result, indent=2, sort_keys=True))
    return 0

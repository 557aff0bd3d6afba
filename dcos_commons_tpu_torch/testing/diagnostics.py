"""Failure diagnostics bundles: capture everything an operator needs.

Reference: testing/sdk_diag.py (568 LoC) — on integration-test failure
the harness harvests plans, pod statuses, task logs and scheduler
state into a per-test bundle directory.  Same shape here: one call
pulls every observable surface of a served scheduler over HTTP plus
process/sandbox logs into a directory of JSON + text files.

Port of ``dcos_commons_tpu/testing/diagnostics.py``, line for line but
the imports.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, Optional

# every GET surface worth capturing, bundled file name -> path
_SURFACES = {
    "health.json": "/v1/health",
    "plans.json": "/v1/plans",
    "pod_status.json": "/v1/pod/status",
    "debug_offers.json": "/v1/debug/offers",
    "debug_reservations.json": "/v1/debug/reservations",
    "debug_plans.json": "/v1/debug/plans",
    "metrics.json": "/v1/metrics",
    "configs.json": "/v1/configs",
    "endpoints.json": "/v1/endpoints",
}


def dump_bundle(
    url: str,
    out_dir: str,
    scheduler_log: str = "",
    agent_logs: Optional[Dict[str, str]] = None,
    sandbox_roots: Optional[Iterable[str]] = None,
    log_tail_lines: int = 200,
) -> Dict[str, str]:
    """Harvest a served scheduler into ``out_dir``.

    Every surface is captured independently — one broken endpoint (or
    a dead scheduler) never voids the rest of the bundle; failures are
    recorded in the bundle itself.  Returns {bundle file: status}.
    """
    import urllib.request

    os.makedirs(out_dir, exist_ok=True)
    results: Dict[str, str] = {}

    def write(name: str, content: str) -> None:
        with open(os.path.join(out_dir, name), "w") as f:
            f.write(content)

    for name, path in _SURFACES.items():
        try:
            with urllib.request.urlopen(
                url.rstrip("/") + path, timeout=5
            ) as resp:
                body = json.loads(resp.read().decode("utf-8"))
            write(name, json.dumps(body, indent=2, default=str))
            results[name] = "ok"
        except Exception as e:  # capture-everything tool: record + move on
            write(name, json.dumps({"bundle_error": repr(e)}))
            results[name] = f"error: {e}"

    # per-plan detail, reusing the plan list already captured above;
    # each plan fetch fails independently so one wedged plan endpoint
    # never voids the others
    detail = {}
    try:
        with open(os.path.join(out_dir, "plans.json")) as f:
            plan_names = json.load(f)
        assert isinstance(plan_names, list)
    except Exception as e:
        plan_names = []
        detail["_list_error"] = repr(e)
    for plan in plan_names:
        try:
            with urllib.request.urlopen(
                url.rstrip("/") + f"/v1/plans/{plan}", timeout=5
            ) as resp:
                detail[plan] = json.loads(resp.read().decode("utf-8"))
        except Exception as e:
            detail[plan] = {"bundle_error": repr(e)}
    write("plan_trees.json", json.dumps(detail, indent=2, default=str))
    if "_list_error" in detail:
        results["plan_trees.json"] = f"error: {detail['_list_error']}"
    elif any("bundle_error" in str(v) for v in detail.values()):
        results["plan_trees.json"] = f"error: partial {sorted(detail)}"
    else:
        results["plan_trees.json"] = "ok"

    def capture_log(name: str, path: str) -> None:
        try:
            with open(path, errors="replace") as f:
                write(
                    name,
                    "\n".join(f.read().splitlines()[-log_tail_lines:]),
                )
            results[name] = "ok"
        except OSError as e:
            write(name, f"<unreadable: {e}>")
            results[name] = f"error: {e}"

    if scheduler_log:
        capture_log("scheduler.log", scheduler_log)
    for host_id, path in (agent_logs or {}).items():
        capture_log(f"agent-{host_id}.log", path)

    # task sandbox stdout/stderr tails
    for root in sandbox_roots or ():
        try:
            names = os.listdir(root)
        except OSError:
            continue
        for task_name in names:
            for stream in ("stdout", "stderr"):
                path = os.path.join(root, task_name, stream)
                if os.path.isfile(path):
                    capture_log(f"task-{task_name}.{stream}", path)
    write("MANIFEST.json", json.dumps(results, indent=2))
    return results

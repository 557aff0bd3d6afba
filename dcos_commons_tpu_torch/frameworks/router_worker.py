"""Serving front door task: the multi-pod request router (the port's
copy of ``frameworks/jax/router_worker.py``).

Deployed like any other task: discovers the serve pods (the port's
``serve_worker`` and ``serve_gang_worker`` rank 0s) through the
scheduler's ``GET /v1/endpoints/<vip>`` (generation-stamped — a quiet
fleet costs one compare per poll), polls each pod's ``GET /stats`` for
the load gauges, and serves ``POST /generate`` on the
scheduler-assigned port with least-loaded + prefix-affinity +
drain-aware placement (dcos_commons_tpu_torch/router/).

The router's own gauges mirror to ``servestats.json`` in the sandbox,
so the scheduler's /v1/debug/serving, /v1/debug/router, and the
ServingSloWatcher (SERVE_TTFT_SLO_S / SERVE_QUEUE_DEPTH_SLO on this
task's env) all see the front door through the plumbing serve pods
already use.  Readiness gates on the first discovery round having
run: the deploy plan completes only when the router can place a
request.

Host-side scheduling only, jax-free and running no model: it deploys
onto a CPU-only node in front of the GPU serve fleet.

Run: ``python -m dcos_commons_tpu_torch.frameworks.router_worker`` from
the repo root (or the file path).
"""

import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
)

from dcos_commons_tpu_torch.router.frontdoor import (  # noqa: E402
    RouterServer,
    default_stats_path,
)
from dcos_commons_tpu_torch.security.auth import load_token  # noqa: E402


def main() -> int:
    scheduler_url = os.environ.get(
        "SCHEDULER_API_URL", "http://127.0.0.1:8080"
    )
    endpoint = os.environ.get("ROUTER_ENDPOINT", "vip:inference")
    port = int(os.environ.get("PORT_HTTP", "0"))
    # the affinity hash must mirror the pods' paging intern geometry:
    # both sides render the same KV_PAGE_TOKENS option
    page_tokens = int(os.environ.get("KV_PAGE_TOKENS") or "16")
    server = RouterServer(
        scheduler_url,
        endpoint=endpoint,
        port=port,
        poll_interval_s=float(
            os.environ.get("ROUTER_POLL_INTERVAL_S", "1.0")
        ),
        stats_path=default_stats_path(),
        auth_token=load_token(),
        # STRICTLY above the pods' queue timeout: a saturated pod
        # answers its 503 at SERVE_QUEUE_TIMEOUT_S, and the router's
        # socket timer must lose that race — a timeout here reads as
        # pod DEATH (failover + affinity eviction), and saturation
        # must never be misclassified as death exactly when the
        # fleet is loaded
        request_timeout_s=float(
            os.environ.get("SERVE_QUEUE_TIMEOUT_S", "600")
        ) + 30.0,
        page_tokens=max(1, page_tokens),
        policy=os.environ.get("ROUTER_POLICY", "affinity"),
        stale_after_s=float(
            os.environ.get("ROUTER_STALE_AFTER_S", "10")
        ),
        retry_budget=int(os.environ.get("ROUTER_RETRY_BUDGET", "2")),
        log=lambda msg: print(msg, flush=True),
    )
    # a RELAUNCH reuses the sandbox: drop the stale readiness marker
    try:
        os.remove("ready")
    except OSError:
        pass
    # readiness gates on the FIRST discovery round: the deploy plan
    # completes only when the router has a pod set to place into
    server.refresh_once()
    with open("ready", "w") as f:
        f.write("routing\n")
    print(
        f"router: fronting {endpoint} via {scheduler_url} on port "
        f"{server.port} (policy "
        f"{os.environ.get('ROUTER_POLICY', 'affinity')}, "
        f"{len(server.router.pods())} pod(s) discovered)",
        flush=True,
    )
    server.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Cassandra-analogue scheduler customizations + entrypoint.

Reference: frameworks/cassandra/src/main/java/.../Main.java and its
two distinctive pieces —

* **SeedsResource** (api/SeedsResource.java, registered at
  Main.java:88): the ring's contact points as a service endpoint.
  Here GET /v1/seeds lists the first ``min(2, count)`` node instances
  (the reference's local-seed computation) with placement + liveness,
  merged with ``TASKCFG_ALL_REMOTE_SEEDS`` for multi-datacenter rings.
* **CassandraRecoveryPlanOverrider** (:38-67): a PERMANENT node
  replace must not be a bare relaunch — the replacement must know the
  address it is taking over (the ``-Dcassandra.replace_address``
  launch option).  Here the overrider phase relaunches the server
  with ``REPLACE_ADDRESS=<its own ring name>`` injected via the
  requirement's env overrides.

Run as a service process:

    python dcos_commons_tpu_torch/frameworks/cassandra_scheduler.py svc.yml --topology fleet.yml

The port of ``frameworks/cassandra/scheduler.py``: line for line but the
imports.  It reads the same ``frameworks/cassandra/svc.yml``, which is also
its default.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, _ROOT)

from dcos_commons_tpu_torch.plan.phase import Phase
from dcos_commons_tpu_torch.plan.step import (
    DeploymentStep,
    PodInstanceRequirement,
    RecoveryType,
)
from dcos_commons_tpu_torch.plan.strategy import SerialStrategy
from dcos_commons_tpu_torch.specification.specs import (
    ServiceSpec,
    task_full_name,
)

N_LOCAL_SEEDS = 2  # reference: Main.java local seed computation


def ring_name(spec: ServiceSpec, index: int) -> str:
    """The stable ring address of node ``index`` (the discovery name
    tasks advertise under — see /v1/endpoints "dns")."""
    return f"node-{index}.{spec.name}.{spec.service_tld}"


def make_node_replace_overrider(spec: ServiceSpec):
    """RecoveryPlanOverrider: PERMANENT node replaces carry the
    replace_address; everything else keeps default recovery."""

    def overrider(
        pod_type: str, instances: List[int], recovery_type: RecoveryType
    ) -> Optional[Phase]:
        if pod_type != "node" or recovery_type is not RecoveryType.PERMANENT:
            return None
        pod = spec.pod("node")
        steps = [
            DeploymentStep(
                f"replace-node-{index}",
                PodInstanceRequirement(
                    pod=pod, instances=[index],
                    tasks_to_launch=["server"],
                    recovery_type=RecoveryType.PERMANENT,
                    # the replacement takes over its predecessor's ring
                    # position (reference: replace_address appended to
                    # the launch command)
                    env_overrides={
                        "REPLACE_ADDRESS": ring_name(spec, index),
                    },
                ),
            )
            for index in instances
        ]
        return Phase(
            f"replace-node-{'-'.join(map(str, instances))}",
            steps,
            SerialStrategy(),
        )

    return overrider


def make_seeds_routes(scheduler):
    """GET /v1/seeds — the SeedsResource analogue: local seeds (first
    min(2, count) instances) with host + liveness, plus any configured
    remote seeds (TASKCFG_ALL_REMOTE_SEEDS, the multi-DC contract)."""

    def seeds(_match, _query):
        spec = scheduler.spec
        statuses = scheduler.state_store.fetch_statuses()
        count = spec.pod("node").count
        local = []
        for index in range(min(N_LOCAL_SEEDS, count)):
            full = task_full_name("node", index, "server")
            info = scheduler.state_store.fetch_task(full)
            status = statuses.get(full)
            local.append({
                "seed": ring_name(spec, index),
                "host": info.agent_id if info else None,
                "state": status.state.value if status else None,
            })
        remote = [
            s for s in os.environ.get(
                "TASKCFG_ALL_REMOTE_SEEDS", ""
            ).split(",") if s
        ]
        return 200, {"seeds": local, "remote_seeds": remote}

    return [("GET", r"/v1/seeds", seeds)]


def main(argv: Optional[List[str]] = None) -> int:
    from dcos_commons_tpu_torch.runtime.runner import serve_main

    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0].startswith("-"):
        argv.insert(0, os.path.join(_ROOT, "frameworks", "cassandra", "svc.yml"))
    return serve_main(
        argv,
        builder_hook=lambda builder, spec: builder.add_recovery_overrider(
            make_node_replace_overrider(spec)
        ),
        routes_hook=make_seeds_routes,
    )


if __name__ == "__main__":
    raise SystemExit(main())

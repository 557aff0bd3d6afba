"""HDFS-analogue scheduler customizations + entrypoint.

Reference: frameworks/hdfs/src/main/java/.../Main.java (framework-
specific scheduler wiring) and HdfsRecoveryPlanOverrider — a name-node
PERMANENT replace must NOT be a bare relaunch: the replacement has an
empty volume, so the recovery phase re-runs the bootstrap task (pull
the namespace image from the other name node) before starting the
node task.  The cassandra analogue restarts seeds on node replace
(CassandraRecoveryPlanOverrider.java:38-67); both are consumers of the
RecoveryPlanOverrider hook (recovery/manager.py).

Run as a service process:

    python dcos_commons_tpu_torch/frameworks/hdfs_scheduler.py svc.yml --topology fleet.yml

The port of ``frameworks/hdfs/scheduler.py``: line for line but the
imports.  It reads the same ``frameworks/hdfs/svc.yml``, which is also
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
from dcos_commons_tpu_torch.specification.specs import ServiceSpec


def make_name_node_overrider(spec: ServiceSpec):
    """RecoveryPlanOverrider: custom choreography for name-pod
    PERMANENT replaces; everything else keeps default recovery."""

    def overrider(
        pod_type: str, instances: List[int], recovery_type: RecoveryType
    ) -> Optional[Phase]:
        if pod_type != "name" or recovery_type is not RecoveryType.PERMANENT:
            return None
        pod = spec.pod("name")
        steps = []
        for index in instances:
            # re-seed the empty replacement volume, then start the node
            steps.append(DeploymentStep(
                f"bootstrap-name-{index}",
                PodInstanceRequirement(
                    pod=pod, instances=[index],
                    tasks_to_launch=["bootstrap"],
                    recovery_type=RecoveryType.PERMANENT,
                ),
            ))
            steps.append(DeploymentStep(
                f"relaunch-name-{index}",
                PodInstanceRequirement(
                    pod=pod, instances=[index],
                    tasks_to_launch=["node"],
                    recovery_type=RecoveryType.PERMANENT,
                ),
            ))
        return Phase(
            f"recover-name-{'-'.join(map(str, instances))}",
            steps,
            SerialStrategy(),
        )

    return overrider


def make_name_nodes_routes(scheduler):
    """Custom framework endpoint (reference: Cassandra's SeedsResource
    — Main.java registers a service-specific HTTP resource next to the
    SDK's): GET /v1/namenodes lists the name-node fleet with host
    placement and liveness, the discovery surface HDFS clients use."""

    def name_nodes(_match, _query):
        statuses = scheduler.state_store.fetch_statuses()
        nodes = []
        for index in range(scheduler.spec.pod("name").count):
            full = f"name-{index}-node"
            info = scheduler.state_store.fetch_task(full)
            status = statuses.get(full)
            nodes.append({
                "name": full,
                "host": info.agent_id if info else None,
                "state": status.state.value if status else None,
            })
        return 200, {"namenodes": nodes}

    return [("GET", r"/v1/namenodes", name_nodes)]


def main(argv: Optional[List[str]] = None) -> int:
    from dcos_commons_tpu_torch.runtime.runner import serve_main

    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0].startswith("-"):
        argv.insert(0, os.path.join(_ROOT, "frameworks", "hdfs", "svc.yml"))
    return serve_main(
        argv,
        builder_hook=lambda builder, spec: builder.add_recovery_overrider(
            make_name_node_overrider(spec)
        ),
        routes_hook=make_name_nodes_routes,
    )


if __name__ == "__main__":
    raise SystemExit(main())

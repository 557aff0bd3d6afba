"""Serving front door: multi-pod request routing with
load-, prefix-cache- and drain-aware placement.

* ``core``       — the transport-free ``RequestRouter``
* ``telemetry``  — staleness-gated pod gauges (the only raw-stats
                   touchpoint; sdklint ``router-stats-staleness``)
* ``affinity``   — page-aligned prefix chain keys (the paging intern
                   shape) + the bounded affinity map
* ``frontdoor``  — the HTTP server, discovery + stats poll loops
"""

from dcos_commons_tpu_torch.router.affinity import (
    AffinityMap,
    prefix_chain_keys,
)
from dcos_commons_tpu_torch.router.core import (
    ROUTERSTATS_NAME,
    NoPodAvailableError,
    PodTransportError,
    RequestRouter,
)
from dcos_commons_tpu_torch.router.telemetry import (
    DEFAULT_STALE_AFTER_S,
    PodTelemetry,
)

__all__ = [
    "AffinityMap",
    "DEFAULT_STALE_AFTER_S",
    "NoPodAvailableError",
    "PodTelemetry",
    "PodTransportError",
    "ROUTERSTATS_NAME",
    "RequestRouter",
    "prefix_chain_keys",
]

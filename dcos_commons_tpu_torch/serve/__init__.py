"""Continuous-batching serving engine (the serve data plane's core).

``engine.py`` is the model-agnostic half: an admission loop that
admits waiting requests at EVERY decode step and retires finished
rows immediately (per-row EOS / max-token), so a batch never pads out
to its longest row and a new request's time-to-first-token is one
decode tick + its own prefill instead of a whole preceding
generation.  Two engines share that loop:

* ``SlotEngine`` — the original SLOTS x MAX_LEN slot pool (one
  contiguous KV row per request);
* ``PagedEngine`` — the paged arena: block-granular KV
  with per-request page tables (``paging.py``: free-list allocator,
  admission-time page budgeting, refcounted prefix cache), chunked
  prefill interleaved with decode ticks, and read-only shared prompt
  pages — the serving default.

``pool.py`` is the device half: the jitted prefill/decode pair over
the persistent cache (models/decode.py), shared by the single-chip
server and the multi-host gang driver.

``migration.py`` makes the KV page the unit of MOBILITY:
live sessions move pod-to-pod mid-generation under a fenced cutover
protocol — the primitive behind drain-with-migration, prefix-hotspot
rebalancing, and prefill/decode disaggregation.
"""

from dcos_commons_tpu_torch.serve.engine import (
    SERVESTATS_NAME,
    PagedEngine,
    SlotEngine,
    read_servestats,
)
from dcos_commons_tpu_torch.serve.migration import (
    HttpEngineClient,
    InProcessTransport,
    MigrationError,
    MigrationRecord,
    PrefillHandoff,
    ReleasePendingError,
    SessionMigratedError,
    SessionSnapshot,
    SimulatedDcnTransport,
    drain_sessions,
    migrate_session,
)
from dcos_commons_tpu_torch.serve.paging import (
    PageAllocator,
    PagedServeConfig,
    paged_config_from_env,
)

__all__ = [
    "SERVESTATS_NAME",
    "HttpEngineClient",
    "InProcessTransport",
    "MigrationError",
    "MigrationRecord",
    "PageAllocator",
    "PagedEngine",
    "PagedServeConfig",
    "PrefillHandoff",
    "ReleasePendingError",
    "SessionMigratedError",
    "SessionSnapshot",
    "SimulatedDcnTransport",
    "SlotEngine",
    "drain_sessions",
    "migrate_session",
    "paged_config_from_env",
    "read_servestats",
]

"""Workload utilities: the serving micro-batcher and tree math."""

from dcos_commons_tpu_torch.utils.microbatch import (
    MicroBatcher,
    QueueTimeoutError,
    WorkItem,
    pack_mixed_rows,
    unpack_results,
)
from dcos_commons_tpu_torch.utils.tree import param_bytes, param_count

__all__ = [
    "MicroBatcher",
    "QueueTimeoutError",
    "WorkItem",
    "pack_mixed_rows",
    "param_bytes",
    "param_count",
    "unpack_results",
]

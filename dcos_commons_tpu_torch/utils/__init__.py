"""Workload utilities: the serving micro-batcher, synthetic data,
checkpointing and tree math."""

from dcos_commons_tpu_torch.utils.checkpoint import (
    AsyncCheckpointer,
    StaleWriterError,
    claim_incarnation,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from dcos_commons_tpu_torch.utils.data import synthetic_mnist, synthetic_tokens
from dcos_commons_tpu_torch.utils.microbatch import (
    MicroBatcher,
    QueueTimeoutError,
    WorkItem,
    pack_mixed_rows,
    unpack_results,
)
from dcos_commons_tpu_torch.utils.tree import param_bytes, param_count

__all__ = [
    "AsyncCheckpointer",
    "MicroBatcher",
    "QueueTimeoutError",
    "StaleWriterError",
    "WorkItem",
    "claim_incarnation",
    "latest_step",
    "pack_mixed_rows",
    "param_bytes",
    "param_count",
    "restore_checkpoint",
    "save_checkpoint",
    "synthetic_mnist",
    "synthetic_tokens",
    "unpack_results",
]

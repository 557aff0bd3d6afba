"""The microbatch split of ``dcos_commons_tpu/parallel/pipeline.py``,
which the train step's gradient accumulation uses (the GPipe schedule
itself is not ported: ROADMAP queue 1, "MoE and long-context")."""

from __future__ import annotations

import torch


def split_microbatches(batch: torch.Tensor, n_micro: int) -> torch.Tensor:
    """[B, ...] -> [M, B/M, ...]; B must divide evenly."""
    b = batch.shape[0]
    if b % n_micro:
        raise ValueError(
            f"batch {b} not divisible into {n_micro} microbatches"
        )
    return batch.reshape((n_micro, b // n_micro) + tuple(batch.shape[1:]))


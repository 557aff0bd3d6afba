"""Synthetic data (port of ``dcos_commons_tpu/utils/data.py``): feeds
the train worker and the benches without host-side IO in the measured
loop.  The draws come from a ``torch.Generator`` and differ from the
JAX package's for the same seed; tests pass arrays across instead.
``synthetic_mnist`` waits for the MNIST path (ROADMAP queue 1)."""

from __future__ import annotations

from typing import Tuple

import torch


def synthetic_tokens(
    batch: int, seq: int, vocab: int, generator: torch.Generator
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tokens, next-token targets) [batch, seq] int64 — a fixed random
    corpus slice, made on the generator's device."""
    tokens = torch.randint(
        0, vocab, (batch, seq + 1), generator=generator,
        device=generator.device,
    )
    return tokens[:, :-1], tokens[:, 1:]

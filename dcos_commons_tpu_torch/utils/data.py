"""Synthetic data (port of ``dcos_commons_tpu/utils/data.py``): feeds
the train worker and the benches without host-side IO in the measured
loop.  The draws come from a ``torch.Generator`` and differ from the
JAX package's for the same seed; tests pass arrays across instead.
``synthetic_mnist`` waits for the MNIST path (ROADMAP queue 1)."""

from __future__ import annotations

from typing import Tuple

import torch

from dcos_commons_tpu_torch.device import generator, resolve_device


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


def synthetic_mnist(batch: int, seed: int = 0, device=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x [batch, 784] f32 uniform in [0, 1), y [batch] int64 classes
    0-9), made on ``device`` (default ``cuda``) from ``seed``."""
    dev = resolve_device(device)
    gen = generator(dev, seed)
    x = torch.rand((batch, 784), generator=gen, device=dev,
                   dtype=torch.float32)
    y = torch.randint(0, 10, (batch,), generator=gen, device=dev)
    return x, y

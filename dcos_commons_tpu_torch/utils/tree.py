"""Parameter-tree accounting on the port's params (nested dicts of
tensors, int8 ``{"q", "scale"}`` leaves included)."""

from __future__ import annotations

from typing import Iterator

import torch


def _leaves(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, dict):
        for sub in tree.values():
            yield from _leaves(sub)
    else:
        yield tree


def param_count(tree) -> int:
    return sum(leaf.numel() for leaf in _leaves(tree))


def param_bytes(tree) -> int:
    return sum(leaf.numel() * leaf.element_size() for leaf in _leaves(tree))

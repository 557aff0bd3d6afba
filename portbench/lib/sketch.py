"""A random sketch of a gradient: its products with ``K`` random
directions, drawn from the seed, per leaf.

A gap of norms moves only at second order under random errors in the
elements; the sketch moves at first order: ``|S(a) - S(b)| / |S(b)|``
estimates ``|a - b| / |b|``.  The program's side takes it from AdamW's
first moment, the reference's from its f32 gradient, each a layer's
slice at a time with the same directions.
"""

from __future__ import annotations

from typing import Optional

K = 16


def _seed(seed: int, path: str, layer: Optional[int], k: int) -> int:
    h = 1469598103934665603
    for part in (str(seed), path, str(layer), str(k)):
        for ch in part.encode() + b"\0":
            h = ((h ^ ch) * 1099511628211) & ((1 << 64) - 1)
    return h & ((1 << 63) - 1)


def sketch(t, seed: int, path: str, layer: Optional[int] = None):
    """``[K]`` f32 products of ``t`` (a leaf, or layer ``layer``'s slice
    of a stacked leaf) with directions drawn on its device."""
    import torch

    flat = t.detach().reshape(-1).float()
    out = torch.empty(K, dtype=torch.float64)
    for k in range(K):
        gen = torch.Generator(device=flat.device).manual_seed(
            _seed(seed, path, layer, k))
        r = torch.randn(flat.shape, generator=gen, device=flat.device,
                        dtype=torch.float32)
        out[k] = float(torch.dot(flat, r))
    return out


def leaf_sketch(t, seed: int, path: str, stacked: bool):
    """The sketch of a whole leaf: the sum of its layers' sketches."""
    if not stacked:
        return sketch(t, seed, path)
    return sum(sketch(t[i], seed, path, i) for i in range(t.shape[0]))

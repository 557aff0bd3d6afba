"""Ulysses attention: all-to-all sequence parallelism over the ``sp``
mesh axis (port of ``dcos_commons_tpu/parallel/ulysses.py``).

Where ring attention keeps the sequence split and rotates K/V, Ulysses
regroups it with two all-to-alls:

    [b, H, s/P, d]  --all_to_all-->  [b, H/P, s, d]
         (sequence split)                (heads split)

Each rank then runs full-sequence flash attention over its H/P heads
(``ops.attention.flash_attention``: kernel K2 forward, K3/K4 backward on
the card, the plain version on the CPU), and a second all-to-all splits
the sequence again.  The causal mask needs no cross-chunk bookkeeping:
every rank sees the whole sequence of its heads.

The reference's ``lax.all_to_all(tiled=True)`` is the port's
``all_to_all`` over ``sp`` (dimension 0 in equal chunks, chunk j to
rank j, the received chunks concatenated in rank order), with the
reshapes that send head chunk j to rank j and put the received
sequence chunks in rank order.
"""

from __future__ import annotations

from typing import Optional

import torch

from dcos_commons_tpu_torch.ops.attention import flash_attention
from dcos_commons_tpu_torch.parallel.mesh import Mesh
from dcos_commons_tpu_torch.parallel.sharding import all_to_all


def _seq_to_heads(x: torch.Tensor, mesh: Mesh, axes, n: int
                  ) -> torch.Tensor:
    """[b, H, c, d] (this rank's chunk) -> [b, H/P, P*c, d] (its heads)."""
    b, h, c, d = x.shape
    chunks = x.reshape(b, n, h // n, c, d).movedim(1, 0)
    got = all_to_all(chunks, mesh, axes)  # [P (source chunk), b, H/P, c, d]
    return got.movedim(0, 2).reshape(b, h // n, n * c, d)


def _heads_to_seq(x: torch.Tensor, mesh: Mesh, axes, n: int
                  ) -> torch.Tensor:
    """[b, H/P, P*c, d] -> [b, H, c, d]: the inverse regrouping."""
    b, hl, s, d = x.shape
    chunks = x.reshape(b, hl, n, s // n, d).movedim(2, 0)
    got = all_to_all(chunks, mesh, axes)  # [P (source heads), b, H/P, c, d]
    return got.movedim(0, 1).reshape(b, n * hl, s // n, d)


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Optional[Mesh],
    axis: str = "sp",
    causal: bool = True,
) -> torch.Tensor:
    """Attention over a sequence sharded on ``axis`` of ``mesh`` (None:
    an axis of one rank).  Per-rank shapes: q/k/v ``[batch, heads,
    chunk, head_dim]`` with every head and chunk = seq / axis size;
    returns the same shape (the sequence split again)."""
    axes = (axis,)
    n = 1 if mesh is None else mesh.size(axes)
    if n == 1:
        return flash_attention(q, k, v, causal=causal)
    heads = q.shape[1]
    if heads % n != 0:
        raise ValueError(
            f"ulysses needs heads ({heads}) divisible by the sp axis "
            f"size ({n})"
        )
    q_h, k_h, v_h = (_seq_to_heads(t, mesh, axes, n) for t in (q, k, v))
    out = flash_attention(q_h, k_h, v_h, causal=causal)
    return _heads_to_seq(out, mesh, axes, n)

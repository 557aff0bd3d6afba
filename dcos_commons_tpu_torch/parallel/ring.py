"""Ring attention: context parallelism over the ``sp`` mesh axis (port
of ``dcos_commons_tpu/parallel/ring.py``).

Each rank holds one contiguous sequence chunk of Q/K/V; the K/V chunks
rotate around the ring (``parallel.sharding.ppermute``, rank j to rank
j+1) while every rank accumulates an online-softmax partial result, as
the reference's ``fori_loop`` does.  The arithmetic is the reference's,
line for line, in plain PyTorch: f32 scores of a pre-scaled q, the
``-1e30`` sentinel, causality by global position (``src * chunk +
k_off``), the output cast back to q's dtype.  It launches no attention
kernel (the reference's ring is plain einsums too); on the card its f32
products run with TF32 as the caller set it.

The reference rotates once more after the last hop, which gives every
chunk back to its owner and is free under XLA; here that hop would be a
real transfer whose result nothing reads, so the loop stops after
``axis_size - 1`` hops.  The values are the same.

Autograd differentiates the loop: each hop's gradient goes back the
reverse way round the ring, so every rank of the axis runs the backward
together (each rank's graph holds the same hops).

``overlap=True`` posts the hop of ``k_cur`` and ``v_cur`` for block i+1
before block i's products and waits for it before the next iteration
(``sharding.ppermute_start``).  In the backward the reverse hop is
posted when autograd reaches the wait and waited on at the post, so it
travels while block i's backward runs.  The values and the gradients
are the synchronous loop's, bit for bit: the same products, and each
K/V chunk's gradient is the same two terms.
"""

from __future__ import annotations

from typing import Optional

import torch

# the reference module's dense oracle, whose copy lives beside K2
from dcos_commons_tpu_torch.ops.attention import reference_attention  # noqa
from dcos_commons_tpu_torch.parallel.mesh import Mesh
from dcos_commons_tpu_torch.parallel.sharding import ppermute, ppermute_start

_NEG = -1e30


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Optional[Mesh],
    axis: str = "sp",
    causal: bool = True,
    overlap: bool = False,
) -> torch.Tensor:
    """Attention over a sequence sharded on ``axis`` of ``mesh`` (None:
    an axis of one rank).  Shapes (per rank): q/k/v ``[batch, heads,
    chunk, head_dim]``, this rank's chunk ``mesh.index((axis,))``.
    ``overlap`` posts each hop before the block it overlaps."""
    axes = (axis,)
    size = 1 if mesh is None else mesh.size(axes)
    my_idx = 0 if mesh is None else mesh.index(axes)
    chunk = q.shape[-2]
    scale = q.shape[-1] ** -0.5

    q32 = q.float() * scale
    o = q32.new_zeros(q.shape[:-1] + (v.shape[-1],))
    m = q32.new_full(q.shape[:-1], _NEG)
    l = q32.new_zeros(q.shape[:-1])

    rows = torch.arange(chunk, device=q.device)
    q_pos = my_idx * chunk + rows[:, None]
    k_off = rows[None, :]
    k_cur, v_cur = k, v
    for i in range(size):
        src = (my_idx - i) % size  # the chunk this rank holds now
        hops = None
        if overlap and i < size - 1:
            hops = (ppermute_start(k_cur, mesh, axes),
                    ppermute_start(v_cur, mesh, axes))
        s = torch.einsum("bhqd,bhkd->bhqk", q32, k_cur.float())
        if causal:
            masked = q_pos < src * chunk + k_off
            s = s.masked_fill(masked, _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        if causal:
            p = p.masked_fill(masked, 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p, v_cur.float())
        m = m_new
        if hops is not None:
            k_cur, v_cur = hops[0].wait(), hops[1].wait()
        elif i < size - 1:
            k_cur = ppermute(k_cur, mesh, axes)
            v_cur = ppermute(v_cur, mesh, axes)
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)


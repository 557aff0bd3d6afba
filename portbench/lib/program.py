"""The program under test, as the drivers build it: the port's
``TransformerConfig`` of a configuration file, and readings taken from
the port's state."""

from __future__ import annotations

import gc
import math

from portbench.lib.counts import Geometry


def transformer_config(g: Geometry, max_seq: int, remat: bool):
    """The port's config of geometry ``g``; raises where the port would
    compute another model than the file states."""
    import torch

    from dcos_commons_tpu_torch.models.transformer import TransformerConfig
    from dcos_commons_tpu_torch.ops.rmsnorm import EPS

    if g.d_model // g.n_heads != g.head_dim:
        raise ValueError(f"the port derives head_dim {g.d_model // g.n_heads}"
                         f", the configuration states {g.head_dim}")
    if EPS != g.eps:
        raise ValueError(f"the port's RMSNorm eps is {EPS}, the "
                         f"configuration states {g.eps}")
    moe = {}
    if g.n_experts:
        moe = dict(n_experts=g.n_experts, moe_top_k=g.top_k,
                   moe_capacity_factor=g.capacity_factor,
                   moe_aux_weight=g.aux_coef, moe_group_size=g.group_size)
    return TransformerConfig(
        vocab=g.vocab, d_model=g.d_model, n_layers=g.n_layers,
        n_heads=g.n_heads, n_kv_heads=g.n_kv_heads, d_ff=g.d_ff,
        max_seq=max_seq, rope_theta=g.rope_theta,
        dtype=getattr(torch, g.dtype), remat=remat, **moe)


def leaf_norm(t) -> float:
    """The f32 norm of a leaf, a layer's slice at a time (a whole
    stacked leaf in f32 would double the memory it takes)."""
    t = t.detach()
    if t.dim() < 3:
        return float(t.float().norm())
    total = 0.0
    for i in range(t.shape[0]):
        total += float(t[i].float().pow(2).sum())
    return math.sqrt(total)


def diff_norm(a, b) -> float:
    """``leaf_norm(a - b)`` with the same care for memory."""
    a, b = a.detach(), b.detach()
    if a.dim() < 3:
        return float((a.float() - b.float()).norm())
    total = 0.0
    for i in range(a.shape[0]):
        total += float((a[i].float() - b[i].float()).pow(2).sum())
    return math.sqrt(total)


def release() -> None:
    """Give the freed device memory back before the reference runs."""
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def read_peak(device: str) -> int:
    import torch

    if device == "cuda":
        torch.cuda.synchronize()
        return int(torch.cuda.max_memory_allocated())
    return 0


def sync(device: str) -> None:
    import torch

    if device == "cuda":
        torch.cuda.synchronize()

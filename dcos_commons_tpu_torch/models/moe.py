"""Mixture-of-Experts FFN (port of ``dcos_commons_tpu/models/moe.py``),
single device.

Top-k routing with the probabilities renormalised over the chosen k, a
STATIC per-expert capacity, and the switch-transformer load-balancing
auxiliary loss, as the reference.  Two dispatches with the same drop
semantics (choice-major priority: every token's 1st choice outranks any
token's 2nd choice, ties broken by token order):

- ``"onehot"``: dense one-hot ``dispatch``/``combine`` tensors
  ``[t, E, C]`` and two einsums around the expert FFN;
- ``"sorted"``: a stable argsort of the choice-major routing entries and
  a row gather/scatter, no ``[t, E, C]`` tensors.

Every function takes ``x [..., t, d]``: the leading axes are groups that
route independently (the reference ``vmap``s ``moe_ffn`` over them), and
the aux loss comes back per group, ``[...]``.

Routing, top-k and the slot positions are plain PyTorch, as they are
plain ``jnp`` in the reference (there is no Pallas kernel on this path);
the positions are integer cumsums, exact and equal to the reference's
f32 cumsum of 0/1 values.  Every op on the routing path is
deterministic, so the recompute of a rematerialised layer routes as its
forward did.

Expert parallelism comes two ways, as in the reference:

- ``moe_ffn(axis_name="ep")``, the explicit path (the reference's
  ``shard_map`` case): tokens are split over the ``ep`` ranks of the
  current mesh (``with mesh:``), the router is replicated, each rank
  holds ``n_experts / ep`` experts (``expert_shard_spec``), and the
  expert slots travel ``[E, C, d] -> [E/ep, ep*C, d]`` and back by
  ``all_to_all``; ``aux`` is averaged over ep;
- ``moe_ffn(mesh=...)``, the train step's path, which follows the
  reference's GSPMD semantics (``moe_sharding_rules``: experts over ep,
  then fsdp and tp within each expert): the tokens are the same on
  every ep rank, each rank dispatches to, computes and combines its own
  experts, and the combined output is summed over ep.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from dcos_commons_tpu_torch.models.quantize import dequantize_weight as dq
from dcos_commons_tpu_torch.parallel.mesh import Mesh, current_mesh
from dcos_commons_tpu_torch.parallel.sharding import (
    EP,
    TP,
    P,
    all_to_all,
    copy_to,
    pmean,
    reduce_from,
)

MoEParams = Dict[str, Any]


@dataclass(frozen=True)
class MoEConfig:
    d_model: int = 512
    d_ff: int = 1024            # per-expert SwiGLU hidden
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.5
    dtype: Any = torch.bfloat16

    def capacity(self, n_tokens: int) -> int:
        """Static per-expert slot count for an n_tokens group."""
        cap = int(self.capacity_factor * self.top_k * n_tokens
                  / self.n_experts)
        return max(cap, 1)


def init_moe_params(config: MoEConfig,
                    generator: Optional[torch.Generator],
                    device: torch.device, lead: Tuple[int, ...] = ()
                    ) -> MoEParams:
    """Router and expert weights, random from ``generator``, with the
    ``lead`` axes in front (``(n_layers,)`` for the stacked tree).  The
    router stays f32 whatever ``config.dtype`` is: routing decisions are
    precision-sensitive."""
    d, f, e = config.d_model, config.d_ff, config.n_experts

    def normal(shape, scale, dtype):
        w = torch.randn(lead + shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (w * scale).to(dtype)

    return {
        "router": normal((d, e), d ** -0.5, torch.float32),
        "w_gate": normal((e, d, f), d ** -0.5, config.dtype),
        "w_up": normal((e, d, f), d ** -0.5, config.dtype),
        "w_down": normal((e, f, d), f ** -0.5, config.dtype),
    }


def _route(config: MoEConfig, params: MoEParams, x: torch.Tensor):
    """x [..., t, d] -> (renormalised gates [..., t, k], expert indices
    [..., t, k] best first, router probabilities [..., t, E], aux [...])."""
    e, k = config.n_experts, config.top_k
    probs = torch.softmax(x.float() @ params["router"], dim=-1)
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    # switch load-balance loss: fraction-of-tokens * mean-prob per expert
    top1_hot = F.one_hot(expert_idx[..., 0], e).float()
    aux = e * (top1_hot.mean(-2) * probs.mean(-2)).mean(-1)
    return gate_vals, expert_idx, probs, aux


def _routing(config: MoEConfig, params: MoEParams, x: torch.Tensor,
             capacity: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Token -> expert-slot assignment as dense one-hot tensors:
    (dispatch [..., t, E, C], combine [..., t, E, C], aux [...]), f32.

    The k choices claim capacity in priority order, carried by ``used``,
    so a token's 2nd choice never evicts another token's 1st choice.  A
    token picks an expert at most once, so ``pos_te`` (a token's
    position in an expert's queue, -1 where it did not pick it) and the
    gate of that pick hold the reference's per-choice sums exactly."""
    gate_vals, expert_idx, probs, aux = _route(config, params, x)
    e = config.n_experts
    pos_te = torch.full(probs.shape, -1, dtype=torch.long, device=x.device)
    used = torch.zeros(probs.shape[:-2] + (1, e), dtype=torch.long,
                       device=x.device)
    for slot_k in range(config.top_k):
        hot = F.one_hot(expert_idx[..., slot_k], e)            # [..., t, E]
        pos = hot.cumsum(-2) - 1 + used
        keep = (hot > 0) & (pos < capacity)
        pos_te = torch.where(keep, pos, pos_te)
        used = used + keep.sum(-2, keepdim=True)
    slots = torch.arange(capacity, device=x.device)
    dispatch = (pos_te[..., None] == slots).float()
    gates = torch.zeros_like(probs).scatter(-1, expert_idx, gate_vals)
    return dispatch, dispatch * gates[..., None], aux


def _routing_sorted(config: MoEConfig, params: MoEParams, x: torch.Tensor,
                    capacity: int):
    """Sort-based token -> slot assignment: no [t, E, C] tensors.

    Returns (slot, token, weight, keep), each [..., t*k], and aux [...].
    The routing entries are flattened CHOICE-MAJOR and stably sorted by
    expert, so an expert's queue holds every 1st choice before any 2nd
    choice, in token order; entries past the capacity are dropped: the
    one-hot path's drop semantics."""
    gate_vals, expert_idx, _, aux = _route(config, params, x)
    t = x.shape[-2]
    e, k = config.n_experts, config.top_k
    lead = expert_idx.shape[:-2]
    flat_expert = expert_idx.transpose(-1, -2).reshape(lead + (k * t,))
    flat_gate = gate_vals.transpose(-1, -2).reshape(lead + (k * t,))
    flat_token = torch.arange(t, device=x.device).repeat(k)
    order = torch.argsort(flat_expert, dim=-1, stable=True)
    se = flat_expert.gather(-1, order)
    st = flat_token[order]
    sg = flat_gate.gather(-1, order)
    counts = F.one_hot(flat_expert, e).sum(-2)                   # [..., E]
    offsets = counts.cumsum(-1) - counts
    pos = torch.arange(k * t, device=x.device) - offsets.gather(-1, se)
    keep = pos < capacity
    slot = se * capacity + pos.clamp(0, capacity - 1)
    return slot, st, sg, keep, aux


def _moe_sorted(config: MoEConfig, params: MoEParams, x: torch.Tensor,
                capacity: int, mesh: Optional[Mesh] = None,
                ep_mesh: Optional[Mesh] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """moe_ffn's body over the sorted dispatch (see _routing_sorted);
    ``mesh`` and ``ep_mesh`` as in ``_experts``.

    Both scatter-adds are ``index_add``, which sums with atomics on the
    card: a slot receives exactly one nonzero row (dropped entries are
    zeroed BEFORE the scatter, so the clipped slot they alias gains
    nothing), and a token at most ``top_k`` weighted rows plus zeros.
    Two addends sum the same in either order, so at k <= 2 both sums are
    exact functions of their inputs, on every run and every recompute."""
    *lead, t, d = x.shape
    e, dt = config.n_experts, config.dtype
    xg = x.reshape(-1, t, d)
    g = xg.shape[0]
    slot, st, sg, keep, aux = _routing_sorted(config, params, xg, capacity)
    # each ep rank reads the tokens and gates for its own experts
    xg, sg = copy_to(xg, mesh, EP), copy_to(sg, mesh, EP)
    rows = xg.gather(1, st[..., None].expand(-1, -1, d)).to(dt)
    rows = rows * keep[..., None].to(dt)
    group = torch.arange(g, device=x.device)[:, None]
    expert_in = xg.new_zeros((g * e * capacity, d), dtype=dt).index_add(
        0, (group * e * capacity + slot).reshape(-1), rows.reshape(-1, d)
    ).reshape(g, e, capacity, d)
    first, last = _local_experts(config, mesh)
    expert_out = _experts(config, params, expert_in[:, first:last], mesh,
                          ep_mesh)
    if last - first < e:
        # the other ep ranks' experts contribute zeros here
        expert_out = F.pad(expert_out, (0, 0, 0, 0, first, e - last))
    out_rows = expert_out.reshape(g, e * capacity, d).gather(
        1, slot[..., None].expand(-1, -1, d))
    weight = (sg * keep).float()[..., None]
    y = xg.new_zeros((g * t, d), dtype=torch.float32).index_add(
        0, (group * t + st).reshape(-1),
        (out_rows.float() * weight).reshape(-1, d),
    )
    y = reduce_from(y, mesh, EP)
    if ep_mesh is not None:
        aux = pmean(aux, ep_mesh, EP)
    return y.to(x.dtype).reshape(x.shape), aux.reshape(lead)


def _expert_ffn(config: MoEConfig, params: MoEParams, h: torch.Tensor,
                mesh: Optional[Mesh] = None) -> torch.Tensor:
    """h [..., E, slots, d] -> [..., E, slots, d]: batched SwiGLU.
    Expert weights may be weight-only int8 (models/quantize.py): the
    [E, d, f] layout contracts axis -2 like the dense path.  With a
    ``mesh`` the hidden width is split over tp (Megatron: the input
    enters every tp rank, the down projection's partial sums are
    all-reduced before the combine reads them)."""
    dt = config.dtype
    h = copy_to(h.to(dt), mesh, TP)
    gate = F.silu(torch.einsum("...ecd,edf->...ecf", h,
                               dq(params["w_gate"], dt)))
    up = torch.einsum("...ecd,edf->...ecf", h, dq(params["w_up"], dt))
    out = torch.einsum("...ecf,efd->...ecd", gate * up,
                       dq(params["w_down"], dt))
    return reduce_from(out, mesh, TP)


def _local_experts(config: MoEConfig, mesh: Optional[Mesh]
                   ) -> Tuple[int, int]:
    """The first and one past the last expert an ep rank holds (all of
    them without a mesh)."""
    if mesh is None:
        return 0, config.n_experts
    ep = mesh.size(EP)
    if config.n_experts % ep:
        raise ValueError(
            f"n_experts {config.n_experts} not divisible by ep={ep}"
        )
    e_local = config.n_experts // ep
    first = mesh.index(EP) * e_local
    return first, first + e_local


def _experts(config: MoEConfig, params: MoEParams, expert_in: torch.Tensor,
             mesh: Optional[Mesh] = None, ep_mesh: Optional[Mesh] = None
             ) -> torch.Tensor:
    """expert_in [..., E, C, d] -> expert_out [..., E, C, d] for the
    experts this rank holds.

    ``ep_mesh`` (the explicit path): the slots travel to the ranks that
    hold their experts, ``[E, C, d] -> [E/ep, ep*C, d]`` (a rank's slots
    for an expert in rank order), and back.  ``mesh`` (the train step):
    ``expert_in`` holds this rank's experts only, their hidden width
    split over tp."""
    if ep_mesh is not None:
        return _exchange_back(
            _expert_ffn(config, params, _exchange(expert_in, ep_mesh)),
            ep_mesh)
    return _expert_ffn(config, params, expert_in, mesh)


def _exchange(expert_in: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """[..., E, C, d] -> [..., E/ep, ep*C, d] by ``all_to_all`` over ep:
    each rank receives every rank's slots for the experts it holds."""
    *lead, e, c, d = expert_in.shape
    ep = mesh.size(EP)
    if e % ep:
        raise ValueError(f"n_experts {e} not divisible by ep={ep}")
    sends = expert_in.reshape(-1, ep, e // ep, c, d).transpose(0, 1)
    got = all_to_all(sends, mesh, EP)              # [src, G, E/ep, C, d]
    return got.permute(1, 2, 0, 3, 4).reshape(*lead, e // ep, ep * c, d)


def _exchange_back(expert_out: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """[..., E/ep, ep*C, d] -> [..., E, C, d]: the reverse trip."""
    *lead, e_local, slots, d = expert_out.shape
    ep = mesh.size(EP)
    c = slots // ep
    sends = expert_out.reshape(-1, e_local, ep, c, d).permute(2, 0, 1, 3, 4)
    got = all_to_all(sends, mesh, EP)              # [src, G, E/ep, C, d]
    return got.transpose(0, 1).reshape(*lead, ep * e_local, c, d)


def _dispatch(dispatch: torch.Tensor, x: torch.Tensor, dt) -> torch.Tensor:
    """Tokens into expert slots: [..., t, E, C] x [..., t, d] ->
    [..., E, C, d], in the compute dtype (the one-hot values are exact in
    bf16, and the expert FFN consumes bf16 anyway)."""
    return torch.einsum("...tec,...td->...ecd", dispatch.to(dt), x.to(dt))


def _combine(combine: torch.Tensor, expert_out: torch.Tensor, dt
             ) -> torch.Tensor:
    """Gate-weighted expert outputs back to tokens: [..., t, E, C] x
    [..., E, C, d] -> [..., t, d], in the compute dtype."""
    return torch.einsum("...tec,...ecd->...td", combine.to(dt),
                        expert_out.to(dt))


def moe_ffn(
    config: MoEConfig,
    params: MoEParams,
    x: torch.Tensor,
    axis_name: Optional[str] = None,
    capacity: Optional[int] = None,
    impl: str = "onehot",
    mesh: Optional[Mesh] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN on x [..., tokens, d_model] -> (y like x, aux [...]).

    Without ``axis_name`` or ``mesh``: all experts on this device.  With
    ``axis_name="ep"`` (inside ``with mesh:``): x holds this rank's
    tokens, and each rank holds ``n_experts / ep`` experts laid out by
    ``expert_shard_spec``; the slots travel by ``all_to_all`` and
    ``aux`` is averaged over ep.  With ``mesh`` (the train step, under
    ``moe_sharding_rules``): x and the router are the same on every ep
    and tp rank, ``params`` hold this rank's experts with their fsdp
    dimension gathered and their hidden width split over tp; the routing
    runs whole on every rank, each rank dispatches to, computes and
    combines its own experts, and the output is summed over ep.  ``aux``
    is then the whole routing's, the same on every rank.

    ``capacity`` overrides the factor-derived per-expert slot count;
    decode passes capacity = tokens so NO token is ever dropped.
    ``impl`` picks the dispatch: "onehot" or "sorted" (see the module
    doc)."""
    ep_mesh = None
    if axis_name is not None:
        if axis_name != "ep":
            raise ValueError(f"expert parallelism runs over 'ep', not "
                             f"{axis_name!r}")
        ep_mesh = current_mesh()
        if ep_mesh is None:
            raise ValueError("moe_ffn(axis_name='ep') needs a mesh: call "
                             "it inside `with mesh:`")
    capacity = (capacity if capacity is not None
                else config.capacity(x.shape[-2]))
    if impl == "sorted":
        return _moe_sorted(config, params, x, capacity, mesh, ep_mesh)
    dispatch, combine, aux = _routing(config, params, x, capacity)
    first, last = _local_experts(config, mesh)
    dt = config.dtype
    # the routing's consumers on this rank see only its experts: the
    # copies make the router's and the tokens' gradients whole again
    x_in, combine = copy_to(x, mesh, EP), copy_to(combine, mesh, EP)
    expert_in = _dispatch(dispatch[..., first:last, :], x_in, dt)
    expert_out = _experts(config, params, expert_in, mesh, ep_mesh)
    y = reduce_from(_combine(combine[..., first:last, :], expert_out, dt),
                    mesh, EP)
    if ep_mesh is not None:
        aux = pmean(aux, ep_mesh, EP)
    return y.to(x.dtype), aux


def expert_shard_spec():
    """Per-dimension rules of the expert params for the explicit ep
    path: experts over ep, the router replicated."""
    return {
        "router": P(None, None),
        "w_gate": P("ep", None, None),
        "w_up": P("ep", None, None),
        "w_down": P("ep", None, None),
    }


def moe_sharding_rules(prefix: str = "", stacked: bool = False):
    """Param path -> per-dimension rule for the train step: experts over
    ``ep``, then the scaling-book fsdp/tp split within each expert
    (``stacked=True`` prepends the layer axis).  The router stays fully
    replicated — routing logits are f32 and tiny, and every rank needs
    them before dispatch."""
    lead = (None,) if stacked else ()
    return {
        f"{prefix}router": P(*lead, None, None),
        f"{prefix}w_gate": P(*lead, "ep", "fsdp", "tp"),
        f"{prefix}w_up": P(*lead, "ep", "fsdp", "tp"),
        f"{prefix}w_down": P(*lead, "ep", "tp", "fsdp"),
    }

"""A configuration's geometry, and the operations and bytes its kernels
and steps need, worked out from shapes alone.

Conventions (the ones ``chip_smoke.py``'s kernel table uses):
- a product of ``[m, k] x [k, n]`` is ``2 m k n`` operations;
- causal attention counts the lower triangle: the forward (K2) is two
  products over ``s^2 / 2`` pairs, ``2 bh s^2 hd``; K3 (dq) recomputes
  the scores and forms dP and dQ, ``3 bh s^2 hd``; K4 (dk, dv) four
  products, ``4 bh s^2 hd``;
- bytes count each input read once and each output written once;
- model FLOPs of training are ``6 x`` the matmul parameters a token
  uses (active experts only, the head counted, the embedding lookup
  not) plus causal attention forward and backward (``3 x`` the
  forward), with no recompute.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable

ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


@dataclass(frozen=True)
class Geometry:
    vocab: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 0.0
    group_size: int = 0
    aux_coef: float = 0.0
    rope_theta: float = 10000.0
    eps: float = 1e-6
    dtype: str = "bfloat16"

    @classmethod
    def from_config(cls, cfg: dict) -> "Geometry":
        """From a ``portbench/configs/<name>.json`` file (Hugging Face
        key names; the port's own settings under ``port``)."""
        port = cfg.get("port", {})
        experts = int(cfg.get("num_local_experts", 0) or 0)
        return cls(
            vocab=int(cfg["vocab_size"]),
            d_model=int(cfg["hidden_size"]),
            n_layers=int(cfg["num_hidden_layers"]),
            n_heads=int(cfg["num_attention_heads"]),
            n_kv_heads=int(cfg["num_key_value_heads"]),
            head_dim=int(cfg["head_dim"]),
            d_ff=int(cfg["intermediate_size"]),
            n_experts=experts,
            top_k=int(cfg.get("num_experts_per_tok", 0) or 0),
            capacity_factor=float(port.get("moe_capacity_factor", 0.0)),
            group_size=int(port.get("moe_group_size", 0)),
            aux_coef=float(cfg.get("router_aux_loss_coef", 0.0) or 0.0),
            rope_theta=float(cfg["rope_theta"]),
            eps=float(cfg["rms_norm_eps"]),
            dtype=str(cfg["torch_dtype"]),
        )

    @property
    def itemsize(self) -> int:
        return ITEMSIZE[self.dtype]

    # -- parameters ----------------------------------------------------

    def attn_params(self) -> int:
        """wq, wk, wv and wo of one layer."""
        q = self.n_heads * self.head_dim
        kv = self.n_kv_heads * self.head_dim
        return self.d_model * (2 * q + 2 * kv)

    def ffn_params_active(self) -> int:
        """The FFN parameters one token uses in one layer: the dense
        SwiGLU, or its top-k experts and the router."""
        one = 3 * self.d_model * self.d_ff
        if self.n_experts:
            return self.top_k * one + self.d_model * self.n_experts
        return one

    def ffn_params(self) -> int:
        """All the FFN parameters of one layer."""
        one = 3 * self.d_model * self.d_ff
        if self.n_experts:
            return self.n_experts * one + self.d_model * self.n_experts
        return one

    def head_params(self) -> int:
        return self.vocab * self.d_model

    def matmul_params_per_token(self) -> int:
        """Trunk and head parameters a token multiplies with."""
        return (self.n_layers * (self.attn_params() + self.ffn_params_active())
                + self.head_params())

    def param_count(self) -> int:
        norms = self.n_layers * 2 * self.d_model + self.d_model
        return (self.head_params() + norms
                + self.n_layers * (self.attn_params() + self.ffn_params()))

    def weight_bytes(self) -> int:
        """Every parameter once: the router in f32, the rest in the
        configuration's dtype."""
        router = self.n_layers * self.d_model * self.n_experts
        return (self.param_count() - router) * self.itemsize + router * 4

    def kv_bytes_per_position(self) -> int:
        """K and V of one position over every layer."""
        return (self.n_layers * 2 * self.n_kv_heads * self.head_dim
                * self.itemsize)

    # -- model FLOPs ---------------------------------------------------

    def attn_fwd_flops_causal(self, batch: int, seq: int) -> float:
        """Causal attention of one layer: two products over the lower
        triangle, all heads."""
        return 2.0 * batch * self.n_heads * seq * seq * self.head_dim

    def train_flops(self, batch: int, seq: int) -> float:
        """Model FLOPs of one training step (no recompute)."""
        tokens = batch * seq
        return (6.0 * tokens * self.matmul_params_per_token()
                + 3.0 * self.n_layers * self.attn_fwd_flops_causal(batch, seq))

    def token_flops(self, position: int, with_head: bool) -> float:
        """Forward FLOPs of one token at ``position`` attending to the
        positions before it and itself."""
        trunk = self.n_layers * (self.attn_params() + self.ffn_params_active())
        attn = (4.0 * self.n_layers * self.n_heads * self.head_dim
                * (position + 1))
        head = 2.0 * self.head_params() if with_head else 0.0
        return 2.0 * trunk + attn + head

    def prefill_chunk_flops(self, start: int, length: int) -> float:
        """A prompt chunk of ``length`` tokens from ``start``; the head
        only at its last position, as the paged prefill computes it."""
        n = length
        trunk = self.n_layers * (self.attn_params() + self.ffn_params_active())
        # positions start .. start+n-1, each attending to pos + 1 keys
        keys = n * start + n * (n + 1) // 2
        return (2.0 * trunk * n
                + 4.0 * self.n_layers * self.n_heads * self.head_dim * keys
                + 2.0 * self.head_params())

    def decode_flops(self, positions: Iterable[int]) -> float:
        """One decode step over the rows at ``positions``."""
        return sum(self.token_flops(p, with_head=True) for p in positions)

    # -- bytes a serving step needs -----------------------------------

    def decode_bytes(self, positions: Iterable[int]) -> float:
        """The least bytes one paged decode step moves: every weight
        once, the K/V of each active row's real positions once, the new
        K/V written, the f32 logits written."""
        positions = list(positions)
        kv = self.kv_bytes_per_position()
        return (self.weight_bytes()
                + sum(p + 1 for p in positions) * kv
                + len(positions) * kv
                + len(positions) * self.vocab * 4)


# -- the port's kernels (one launch) ------------------------------------

def rmsnorm_bytes(rows: int, d: int, itemsize: int) -> float:
    """K1: x read, w read, y written."""
    return 2.0 * rows * d * itemsize + d * itemsize


def flash_fwd_flops(bh: int, seq: int, head_dim: int) -> float:
    """K2, causal, seq_q == seq_k."""
    return 2.0 * bh * seq * seq * head_dim


def flash_dq_flops(bh: int, seq: int, head_dim: int) -> float:
    """K3, causal."""
    return 3.0 * bh * seq * seq * head_dim


def flash_dkv_flops(bh: int, seq: int, head_dim: int) -> float:
    """K4, causal."""
    return 4.0 * bh * seq * seq * head_dim


def flash_fwd_bytes(bh: int, seq: int, head_dim: int, itemsize: int) -> float:
    """K2: q, k, v read; o and the f32 lse written."""
    return 4.0 * bh * seq * head_dim * itemsize + 4.0 * bh * seq


def flash_dq_bytes(bh: int, seq: int, head_dim: int, itemsize: int) -> float:
    """K3: q, k, v, do, lse and di read; dq written."""
    return 5.0 * bh * seq * head_dim * itemsize + 8.0 * bh * seq


def flash_dkv_bytes(bh: int, seq: int, head_dim: int, itemsize: int) -> float:
    """K4: q, k, v, do, lse and di read; dk and dv written."""
    return 6.0 * bh * seq * head_dim * itemsize + 8.0 * bh * seq


# -- the head and the MoE parts, forward ---------------------------------

def head_flops(tokens: int, d: int, vocab: int) -> float:
    """The tied head's f32 logits."""
    return 2.0 * tokens * d * vocab


def moe_routing_flops(tokens: int, d: int, experts: int) -> float:
    """The f32 router's logits."""
    return 2.0 * tokens * d * experts


def moe_onehot_flops(tokens: int, experts: int, capacity: int, d: int
                     ) -> float:
    """One one-hot dispatch or combine einsum, ``[t, E, C] x [t, d]``
    summed over the group's tokens, as the port computes it."""
    return 2.0 * tokens * experts * capacity * d


def moe_expert_flops(experts: int, capacity: int, d: int, d_ff: int
                     ) -> float:
    """The expert SwiGLU over every capacity slot of every expert."""
    return 6.0 * experts * capacity * d * d_ff


def moe_capacity(group: int, top_k: int, experts: int, factor: float) -> int:
    """The port's static per-expert slot count of a routing group."""
    return max(int(factor * top_k * group / experts), 1)

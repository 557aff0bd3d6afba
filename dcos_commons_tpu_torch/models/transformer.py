"""The flagship decoder-only transformer LM (port of
``dcos_commons_tpu/models/transformer.py``), single device.

Same configuration fields and defaults, same env contract, same param
tree: ``embed [vocab, d]``, ``layers`` — a dict of per-layer tensors
STACKED on a leading ``n_layers`` axis — and ``final_norm [d]``, so
``models/bridge.py`` carries the JAX package's weights across leaf by
leaf.  The JAX ``lax.scan`` over layers is a Python loop over that
axis.  Numerics follow the reference: activations in ``config.dtype``
(bf16 on the card), RMSNorm statistics in f32 (``ops.rms_norm``, kernel
K1), half-split RoPE, GQA by ``repeat_interleave`` (``jnp.repeat``),
flash attention (kernel K2), SwiGLU, tied f32-logit head.

Not in this slice, and raising ``NotImplementedError``: MoE layers
(``n_experts > 0``), ring and Ulysses sequence parallelism (ROADMAP
queue 1, "MoE and long-context").
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from dcos_commons_tpu_torch.device import resolve_device
from dcos_commons_tpu_torch.models.quantize import dequantize_weight as dq
from dcos_commons_tpu_torch.ops.attention import flash_attention
from dcos_commons_tpu_torch.ops.rmsnorm import rms_norm

Params = Dict[str, Any]


@dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 32768
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 8          # < n_heads => GQA
    d_ff: int = 1408             # SwiGLU hidden
    max_seq: int = 2048
    rope_theta: float = 10000.0
    dtype: Any = torch.bfloat16
    # training-side fields, kept so both packages read one config;
    # the training slice gives them their meaning here
    remat: bool = True
    remat_policy: str = "full"
    no_remat_layers: int = 0

    def __post_init__(self) -> None:
        if self.remat_policy not in ("full", "save-attn"):
            raise ValueError(
                f"remat_policy {self.remat_policy!r} not in "
                "('full', 'save-attn')"
            )
        if self.use_ring_attention and self.use_ulysses_attention:
            raise ValueError(
                "pick ONE sequence-parallel recipe: ring or ulysses"
            )
    use_ring_attention: bool = False
    use_ulysses_attention: bool = False
    sp_axis: str = "sp"
    n_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.5
    moe_aux_weight: float = 0.01
    moe_group_size: int = 1024
    moe_impl: str = "onehot"
    loss_chunk: int = 0
    # the TPU kernel's VMEM tile sizes, kept for parity of the config;
    # the port's kernel K2 picks its own tile (64 x 64) and ignores them
    attn_block_q: int = 128
    attn_block_k: int = 128

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def config_from_env(env: Dict[str, str], **overrides) -> TransformerConfig:
    """The scheduler-env -> TransformerConfig contract: the same env
    names and defaults as the JAX package's ``config_from_env``."""
    fields = dict(
        vocab=int(env.get("VOCAB", "8192")),
        d_model=int(env.get("D_MODEL", "512")),
        n_layers=int(env.get("N_LAYERS", "4")),
        n_heads=int(env.get("N_HEADS", "8")),
        n_kv_heads=int(env.get("N_KV_HEADS", "8")),
        d_ff=int(env.get("D_FF", "1408")),
        max_seq=int(env.get("SEQ_LEN", "1024")),
        n_experts=int(env.get("N_EXPERTS", "0")),
    )
    fields.update(overrides)
    return TransformerConfig(**fields)


def check_supported(config: TransformerConfig) -> None:
    """Raise for what this slice of the port does not run."""
    if config.n_experts > 0:
        raise NotImplementedError(
            "MoE layers (n_experts > 0) are not ported yet: ROADMAP "
            "queue 1, 'MoE and long-context'"
        )
    if config.use_ring_attention or config.use_ulysses_attention:
        raise NotImplementedError(
            "ring/Ulysses sequence parallelism is not ported yet: "
            "ROADMAP queue 1, 'MoE and long-context'"
        )


def init_params(config: TransformerConfig, seed: int = 0,
                device=None) -> Params:
    """Stacked-layer param tree, random from ``seed``, made on
    ``device`` (default ``cuda``) with a generator of that device.
    The draws differ from the JAX package's for the same seed; carry
    JAX weights across with ``models.bridge.params_from_jax``."""
    check_supported(config)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, h, kv, hd, f = (
        config.d_model, config.n_heads, config.n_kv_heads,
        config.head_dim, config.d_ff,
    )
    n = config.n_layers
    dt = config.dtype

    def normal(shape, scale):
        w = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.float32)
        return (w * scale).to(dt)

    embed = normal((config.vocab, d), d ** -0.5)
    layers = {
        "attn_norm": torch.ones((n, d), dtype=dt, device=dev),
        "wq": normal((n, d, h * hd), d ** -0.5),
        "wk": normal((n, d, kv * hd), d ** -0.5),
        "wv": normal((n, d, kv * hd), d ** -0.5),
        "wo": normal((n, h * hd, d), (h * hd) ** -0.5),
        "mlp_norm": torch.ones((n, d), dtype=dt, device=dev),
        "w_gate": normal((n, d, f), d ** -0.5),
        "w_up": normal((n, d, f), d ** -0.5),
        "w_down": normal((n, f, d), f ** -0.5),
    }
    return {
        "embed": embed,
        "layers": layers,
        "final_norm": torch.ones((d,), dtype=dt, device=dev),
    }


def layer_params(layers: Params, i: int) -> Params:
    """Layer ``i``'s slice of the stacked tree (int8 leaves keep their
    ``{"q", "scale"}`` form)."""
    return {
        name: ({k: t[i] for k, t in leaf.items()}
               if isinstance(leaf, dict) else leaf[i])
        for name, leaf in layers.items()
    }


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float
          ) -> torch.Tensor:
    """Rotary embeddings, half-split (halves concatenated, not
    interleaved); x [b, s, heads, head_dim], positions [b, s]."""
    half = x.shape[-1] // 2
    freqs = theta ** (
        -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    )
    angles = positions[:, :, None, None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)


def _attention_block(config: TransformerConfig, layer, x, positions):
    b, s, d = x.shape
    h, kv, hd = config.n_heads, config.n_kv_heads, config.head_dim
    normed = rms_norm(x, layer["attn_norm"])
    q = (normed @ dq(layer["wq"], x.dtype)).reshape(b, s, h, hd)
    k = (normed @ dq(layer["wk"], x.dtype)).reshape(b, s, kv, hd)
    v = (normed @ dq(layer["wv"], x.dtype)).reshape(b, s, kv, hd)
    q = _rope(q, positions, config.rope_theta)
    k = _rope(k, positions, config.rope_theta)
    if kv != h:
        k = k.repeat_interleave(h // kv, dim=2)
        v = v.repeat_interleave(h // kv, dim=2)
    attn = flash_attention(
        *(t.transpose(1, 2) for t in (q, k, v)), causal=True
    )
    attn = attn.transpose(1, 2).reshape(b, s, h * hd)
    return x + attn @ dq(layer["wo"], x.dtype)


def _mlp_block(layer, x):
    normed = rms_norm(x, layer["mlp_norm"])
    gate = F.silu(normed @ dq(layer["w_gate"], x.dtype))
    up = normed @ dq(layer["w_up"], x.dtype)
    return x + (gate * up) @ dq(layer["w_down"], x.dtype)


def _ffn_block(config: TransformerConfig, layer, x):
    """The per-layer FFN: dense SwiGLU.  The JAX package's MoE branch
    (and its aux loss) is not ported; ``check_supported`` refuses it."""
    check_supported(config)
    return _mlp_block(layer, x)


def _logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Final norm and the tied head, in f32."""
    x = rms_norm(x, params["final_norm"])
    return x.float() @ params["embed"].float().T


def forward(
    config: TransformerConfig,
    params: Params,
    tokens: torch.Tensor,
    positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """tokens [b, s] -> logits [b, s, vocab] (f32), on tokens' device."""
    check_supported(config)
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = params["embed"][tokens].to(config.dtype)
    for i in range(config.n_layers):
        layer = layer_params(params["layers"], i)
        x = _attention_block(config, layer, x, positions)
        x = _ffn_block(config, layer, x)
    return _logits(params, x)

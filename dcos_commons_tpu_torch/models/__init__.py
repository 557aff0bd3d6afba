"""The flagship transformer in PyTorch: forward, KV-cache decode (slot
pool and paged arena), int8 weights, and the bridge that carries the
JAX package's weights across."""

from dcos_commons_tpu_torch.models.bridge import params_from_jax
from dcos_commons_tpu_torch.models.decode import (
    decode_step,
    generate,
    init_kv_cache,
    init_paged_kv_cache,
    paged_decode_step,
    paged_prefill_chunk,
    prefill,
    prefill_into_slot,
    sample_token,
)
from dcos_commons_tpu_torch.models.quantize import (
    dequantize_weight,
    quantize_params_int8,
    quantize_weight,
)
from dcos_commons_tpu_torch.models.transformer import (
    TransformerConfig,
    config_from_env,
    forward,
    init_params,
)

__all__ = [
    "TransformerConfig",
    "config_from_env",
    "decode_step",
    "dequantize_weight",
    "forward",
    "generate",
    "init_kv_cache",
    "init_paged_kv_cache",
    "init_params",
    "paged_decode_step",
    "paged_prefill_chunk",
    "params_from_jax",
    "prefill",
    "prefill_into_slot",
    "quantize_params_int8",
    "quantize_weight",
    "sample_token",
]

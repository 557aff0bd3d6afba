"""The flagship transformer in PyTorch: forward, KV-cache decode (slot
pool and paged arena), int8 weights, the train step (loss, remat,
gradient accumulation, AdamW) on one device or sharded over a mesh
(``sharding_rules``; ring or Ulysses attention over ``sp``), the GPipe
pipeline over ``pp`` (``pipeline_loss_fn``), the mixture of experts,
and the bridge that carries weights and train state between the JAX
package and the port."""

from dcos_commons_tpu_torch.models.bridge import (
    params_from_jax,
    params_to_jax,
    train_state_to_jax,
)
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
from dcos_commons_tpu_torch.models.moe import (
    MoEConfig,
    expert_shard_spec,
    init_moe_params,
    moe_ffn,
    moe_sharding_rules,
)
from dcos_commons_tpu_torch.models.quantize import (
    dequantize_weight,
    quantize_params_int8,
    quantize_weight,
)
from dcos_commons_tpu_torch.models.transformer import (
    TransformerConfig,
    adamw,
    config_from_env,
    forward,
    init_params,
    load_train_state,
    loss_fn,
    make_train_step,
    param_shardings,
    pipeline_forward,
    pipeline_loss_fn,
    pipeline_param_specs,
    pipeline_value_and_grad,
    shard_params,
    sharding_rules,
    train_state,
    unshard_params,
)

__all__ = [
    "MoEConfig",
    "TransformerConfig",
    "adamw",
    "config_from_env",
    "decode_step",
    "dequantize_weight",
    "expert_shard_spec",
    "forward",
    "generate",
    "init_kv_cache",
    "init_moe_params",
    "init_paged_kv_cache",
    "init_params",
    "load_train_state",
    "loss_fn",
    "make_train_step",
    "moe_ffn",
    "moe_sharding_rules",
    "paged_decode_step",
    "paged_prefill_chunk",
    "param_shardings",
    "params_from_jax",
    "params_to_jax",
    "pipeline_forward",
    "pipeline_loss_fn",
    "pipeline_param_specs",
    "pipeline_value_and_grad",
    "prefill",
    "prefill_into_slot",
    "quantize_params_int8",
    "quantize_weight",
    "sample_token",
    "shard_params",
    "sharding_rules",
    "train_state",
    "train_state_to_jax",
    "unshard_params",
]

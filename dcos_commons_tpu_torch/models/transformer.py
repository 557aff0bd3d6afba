"""The flagship decoder-only transformer LM (port of
``dcos_commons_tpu/models/transformer.py``).

Same configuration fields and defaults, same env contract, same param
tree: ``embed [vocab, d]``, ``layers`` — a dict of per-layer tensors
STACKED on a leading ``n_layers`` axis — and ``final_norm [d]``, so
``models/bridge.py`` carries the JAX package's weights across leaf by
leaf.  The JAX ``lax.scan`` over layers is a Python loop over that
axis.  Numerics follow the reference: activations in ``config.dtype``
(bf16 on the card), RMSNorm statistics in f32 (``ops.rms_norm``, kernel
K1), half-split RoPE, GQA by ``repeat_interleave`` (``jnp.repeat``),
flash attention (kernel K2 forward, K3/K4 backward), SwiGLU, tied
f32-logit head.

The training half: ``loss_fn`` (with the sequence-chunked loss),
layer remat through ``torch.utils.checkpoint`` with the reference's
``remat_policy`` and ``no_remat_layers`` semantics, ``make_train_step``
with gradient accumulation, and ``adamw``, the counterpart of
``optax.adamw(3e-4)``.  ``adamw_state`` and ``load_adamw_state`` lay the
optimizer's state out as optax's, so checkpoints cross between the
packages.

``n_experts > 0`` swaps every layer's dense SwiGLU for a mixture of
experts (``models/moe.py``: an f32 router, per-expert SwiGLU, the
switch load-balancing aux loss, which ``loss_fn`` adds as the reference
does); the expert leaves sit in the same stacked tree.

The multi-GPU step: ``sharding_rules`` are the reference's, entry for
entry, as per-dimension rules (``parallel/sharding.py``), and
``make_train_step(mesh=...)`` runs them on each rank's shard of the
params and of the batch, with the collectives GSPMD would insert made
explicit: tp splits heads and the FFN's hidden width Megatron-style
(the norms' outputs enter every tp rank through ``copy_to``, ``wo``'s
and ``w_down``'s partial sums are all-reduced) and the vocabulary of
the tied embedding (a vocab-parallel lookup and cross entropy); fsdp
stores a dimension of each big leaf split and gathers it per layer,
inside the remat region, so the recompute gathers again; ep holds each
rank's experts (``models/moe.py`` ``moe_ffn(mesh=...)``); the batch axes
average the gradients.  Each rank computes the full seeded init and
keeps its block (``shard_params``), so a gang starts from the
single-device init bit for bit; AdamW runs on the blocks.

Long context: with ``use_ring_attention`` or ``use_ulysses_attention``
every attention runs its recipe over the mesh's ``sp`` ranks
(``parallel/ring.py``, ``parallel/ulysses.py``), each rank on its chunk
of the sequence, RoPE at the chunk's global positions; the train step
averages the loss and the gradients over ``sp`` as over the batch
axes.  Pipeline parallelism is ``pipeline_loss_fn`` (GPipe over ``pp``,
``parallel/pipeline.py``), as in the reference, whose
``make_train_step`` has no pipeline either.

``make_train_step(..., overlap=True)`` overlaps the sharded step's
collectives with its compute, as the reference's XLA flags have its
compiler do (``parallel/overlap.py``): every leaf is aliased by one
leaf a layer, whose gradient hook launches its bucket's reduction;
``_ShardedLayer`` takes its fsdp leaves from gathers launched a layer
ahead; the ring posts each hop before its block.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from dcos_commons_tpu_torch.device import generator, resolve_device
from dcos_commons_tpu_torch.models.moe import (
    MoEConfig,
    init_moe_params,
    moe_ffn,
    moe_sharding_rules,
)
from dcos_commons_tpu_torch.models.quantize import dequantize_weight as dq
from dcos_commons_tpu_torch.ops.attention import flash_attention
from dcos_commons_tpu_torch.ops.rmsnorm import rms_norm
from dcos_commons_tpu_torch.parallel.mesh import DATA_AXES, Mesh
from dcos_commons_tpu_torch.parallel.overlap import (
    GradReducer,
    OverlapRun,
    accumulated_mean,
    applicable,
    current_run,
    resolve,
)
from dcos_commons_tpu_torch.parallel.pipeline import (
    last_stage_value,
    merge_microbatches,
    pipeline_apply,
    split_microbatches,
)
from dcos_commons_tpu_torch.parallel.ring import ring_attention
from dcos_commons_tpu_torch.parallel.sharding import (
    TP,
    Dims,
    P,
    all_reduce,
    batch_mean,
    copy_to,
    gather_fsdp,
    reduce_from,
    reduce_gradients,
    shard,
    unshard,
    vocab_parallel_embed,
    vocab_parallel_nll,
    wait_scatters,
)
from dcos_commons_tpu_torch.parallel.ulysses import ulysses_attention
from dcos_commons_tpu_torch.utils.tree import (
    tree_flatten,
    tree_leaves,
    tree_map,
    tree_unflatten,
)

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
    remat: bool = True
    # remat granularity: "full" recomputes the whole layer in backward;
    # "save-attn" keeps each layer's attention (its output and the
    # flash kernel's own residuals) and recomputes the rest, so the
    # flash forward never re-runs (see _layer_scan)
    remat_policy: str = "full"
    # mixed remat: the last k layers store activations instead of
    # recomputing
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
    # MoE variant: n_experts > 0 swaps the dense SwiGLU for a mixture of
    # experts (models/moe.py).  Tokens route in groups of up to
    # moe_group_size (see _ffn_block); moe_impl is "onehot" or "sorted"
    n_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.5
    moe_aux_weight: float = 0.01
    moe_group_size: int = 1024
    moe_impl: str = "onehot"
    # sequence-chunked cross entropy: only [b, chunk, vocab] f32 logits
    # are ever live, each chunk recomputed in backward.  0 = unchunked.
    loss_chunk: int = 0
    # the TPU kernels' VMEM tile sizes, kept for parity of the config;
    # the port's kernels K2-K4 pick their own tile (64 x 64) and ignore
    # them
    attn_block_q: int = 128
    attn_block_k: int = 128

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def sequence_parallel(self) -> bool:
        """Whether attention runs a sequence-parallel recipe."""
        return self.use_ring_attention or self.use_ulysses_attention


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


def check_mesh(config: TransformerConfig, mesh: Mesh) -> None:
    """Raise for a mesh the sharded step does not run: pipeline
    parallelism (``pipeline_loss_fn``), a sequence split with no recipe
    to attend across it, or a tp that does not split the heads into
    whole blocks of each rank's own KV heads, or one Ulysses cannot
    split further over sp."""
    spec = mesh.spec
    if spec.pp > 1:
        raise NotImplementedError(
            f"a mesh with pp={spec.pp}: make_train_step has no pipeline, "
            "as the reference's has none; pipelined training takes the "
            "gradients of pipeline_loss_fn (pipeline_value_and_grad)"
        )
    if spec.sp > 1 and not config.sequence_parallel:
        raise NotImplementedError(
            f"a mesh with sp={spec.sp} and no sequence-parallel recipe: "
            "set use_ring_attention or use_ulysses_attention (the "
            "reference's GSPMD would gather the sequence instead)"
        )
    if config.n_kv_heads % spec.tp or config.n_heads % spec.tp:
        raise ValueError(
            f"tp={spec.tp} must divide n_kv_heads={config.n_kv_heads} "
            f"and n_heads={config.n_heads}: each tp rank holds whole KV "
            "heads and the query heads that read them"
        )
    if config.n_experts > 0 and config.n_experts % spec.ep:
        raise ValueError(
            f"n_experts {config.n_experts} not divisible by ep={spec.ep}"
        )
    if config.use_ulysses_attention and (config.n_heads // spec.tp) % spec.sp:
        raise ValueError(
            f"ulysses needs each tp rank's heads ({config.n_heads // spec.tp})"
            f" divisible by the sp axis size ({spec.sp})"
        )


def init_params(config: TransformerConfig, seed: int = 0,
                device=None) -> Params:
    """Stacked-layer param tree, random from ``seed``, made on
    ``device`` (default ``cuda``) with a generator of that device
    (``meta``: shapes and dtypes only).  The draws differ from the JAX
    package's for the same seed; carry JAX weights across with
    ``models.bridge.params_from_jax``."""
    dev = resolve_device(device)
    gen = generator(dev, seed)
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
    }
    if config.n_experts > 0:
        # the router stays f32 under a bf16 config (init_moe_params)
        layers.update(init_moe_params(_moe_config(config), gen, dev,
                                      lead=(n,)))
    else:
        layers.update({
            "w_gate": normal((n, d, f), d ** -0.5),
            "w_up": normal((n, d, f), d ** -0.5),
            "w_down": normal((n, f, d), f ** -0.5),
        })
    return {
        "embed": embed,
        "layers": layers,
        "final_norm": torch.ones((d,), dtype=dt, device=dev),
    }


def _moe_config(config: TransformerConfig) -> MoEConfig:
    return MoEConfig(
        d_model=config.d_model, d_ff=config.d_ff,
        n_experts=config.n_experts, top_k=config.moe_top_k,
        capacity_factor=config.moe_capacity_factor, dtype=config.dtype,
    )


def sharding_rules(config: TransformerConfig) -> Dict[str, Dims]:
    """Param path -> per-dimension rule (the reference's scaling-book
    layout): heads/ffn over tp, the other big axis over fsdp; MoE expert
    axes over ep."""
    rules = {
        "embed": P("tp", "fsdp"),
        "layers/attn_norm": P(None, None),
        "layers/wq": P(None, "fsdp", "tp"),
        "layers/wk": P(None, "fsdp", "tp"),
        "layers/wv": P(None, "fsdp", "tp"),
        "layers/wo": P(None, "tp", "fsdp"),
        "layers/mlp_norm": P(None, None),
        "final_norm": P(None),
    }
    if config.n_experts > 0:
        rules.update(moe_sharding_rules(prefix="layers/", stacked=True))
    else:
        rules.update({
            "layers/w_gate": P(None, "fsdp", "tp"),
            "layers/w_up": P(None, "fsdp", "tp"),
            "layers/w_down": P(None, "tp", "fsdp"),
        })
    return rules


def _path_tree(config: TransformerConfig) -> Params:
    """The param tree's layout with each leaf's path as the leaf."""
    tree: Params = {}
    for path in sharding_rules(config):
        *parents, name = path.split("/")
        node = tree
        for parent in parents:
            node = node.setdefault(parent, {})
        node[name] = path
    return tree


def param_shardings(config: TransformerConfig) -> Params:
    """The param tree with each leaf's rule in its place (the
    reference's tree of ``NamedSharding``s, without the mesh).  A rule
    is a tuple, which ``tree_leaves`` would walk into: take leaves in
    tree order from ``leaf_rules``."""
    rules = sharding_rules(config)

    def walk(node):
        if isinstance(node, dict):
            return {name: walk(sub) for name, sub in node.items()}
        return rules[node]

    return walk(_path_tree(config))


def leaf_rules(config: TransformerConfig, train_state: bool = False,
               rules: Optional[Dict[str, Dims]] = None) -> List[Dims]:
    """The rule of every leaf of the param tree, in ``tree_leaves``
    order, by ``rules`` (default ``sharding_rules``); with
    ``train_state``, of every leaf of ``train_state``'s tree (AdamW's
    moments laid out as their params, the step count replicated: the
    reference's ``opt_leaf_sharding``)."""
    rules = rules or sharding_rules(config)
    paths = _path_tree(config)
    tree = paths if not train_state else {
        "params": paths, "opt_state": ((None, paths, paths), (), ()),
    }
    # the count's None is an empty subtree to tree_leaves: put it back
    leaves = [rules[p] for p in tree_leaves(tree)]
    return [()] + leaves if train_state else leaves


def shard_params(params: Params, config: TransformerConfig, mesh: Mesh,
                 rules: Optional[Dict[str, Dims]] = None) -> Params:
    """This rank's block of every leaf of a full param tree, as tensors
    of its own (what ``device_put`` with the rule's ``NamedSharding``
    leaves on one device), by ``rules`` (default ``sharding_rules``;
    ``pipeline_param_specs`` for a pipeline stage).

    Two cases only a serving gang meets (``check_mesh`` refuses the
    second for training):
    - a weight-only int8 leaf (``quantize_params_int8`` of the FULL
      weight, as the reference quantizes the placed global arrays):
      ``q`` takes the weight's rule and ``scale`` the rule without its
      contraction axis -2, where the scale has one row, so a row split
      over tp (``wo``, ``w_down``) keeps the amax of the whole column;
    - tp not dividing ``n_kv_heads``: ``wk`` and ``wv`` are held whole
      by every rank, as the reference's ``kv_spec`` replicates the
      cache, and each rank computes every KV head."""
    rules = dict(rules or sharding_rules(config))
    if config.n_kv_heads % mesh.size(TP):
        for name in ("layers/wk", "layers/wv"):
            rules[name] = P(None, "fsdp", None)

    def walk(node, path):
        if isinstance(node, dict) and set(node) != {"q", "scale"}:
            return {k: walk(v, f"{path}/{k}" if path else k)
                    for k, v in node.items()}
        dims = rules[path]
        if isinstance(node, dict):
            return {"q": shard(node["q"], dims, mesh),
                    "scale": shard(node["scale"],
                                   dims[:-2] + ((),) + dims[-1:], mesh)}
        return shard(node, dims, mesh)

    return walk(params, "")


def unshard_params(params: Params, config: TransformerConfig, mesh: Mesh,
                   rules: Optional[Dict[str, Dims]] = None) -> Params:
    """The full param tree from every rank's blocks, laid out by
    ``rules`` (default ``sharding_rules``; collective: every rank calls
    it)."""
    leaves, structure = tree_flatten(params)
    return tree_unflatten(structure, [
        unshard(t, dims, mesh)
        for t, dims in zip(leaves, leaf_rules(config, rules=rules))
    ])


def layer_params(layers: Params, i: int) -> Params:
    """Layer ``i``'s slice of the stacked tree (int8 leaves keep their
    ``{"q", "scale"}`` form)."""
    return {
        name: ({k: t[i] for k, t in leaf.items()}
               if isinstance(leaf, dict) else leaf[i])
        for name, leaf in layers.items()
    }


class _ShardedLayer:
    """Layer ``i`` of a rank's stacked blocks: a leaf is sliced and its
    fsdp dimension all-gathered when first read (so a remat region
    gathers only the leaves it uses, and its recompute gathers them
    again)."""

    def __init__(self, config: TransformerConfig, layers: Params, i: int,
                 mesh: Mesh):
        self.rules = sharding_rules(config)
        self.layers, self.i, self.mesh = layers, i, mesh
        self.cache: Dict[str, torch.Tensor] = {}

    def __getitem__(self, name: str) -> torch.Tensor:
        if name not in self.cache:
            run = current_run()
            if run is not None and run.prefetch is not None:
                self.cache[name] = run.prefetch.read(self.layers, self.rules,
                                                     self.i, name)
            else:
                self.cache[name] = gather_fsdp(
                    self.layers[name][self.i],
                    self.rules["layers/" + name][1:], self.mesh)
        return self.cache[name]


def _layer(config: TransformerConfig, layers: Params, i: int,
           mesh: Optional[Mesh]):
    return (layer_params(layers, i) if mesh is None
            else _ShardedLayer(config, layers, i, mesh))


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


def _project(config: TransformerConfig, layer, x, positions, mesh=None):
    """Norm, projections and RoPE: q ``[b, s, heads, head_dim]``, k and
    v ``[b, s, kv_heads, head_dim]``, the heads being the columns of wq,
    wk and wv the rank holds (under a mesh its block of each; where tp
    does not divide the KV heads a serving rank holds wk and wv whole,
    see ``shard_params``, and k and v carry every KV head)."""
    b, s, _ = x.shape
    hd = config.head_dim
    normed = copy_to(rms_norm(x, layer["attn_norm"]), mesh, TP)
    q = (normed @ dq(layer["wq"], x.dtype)).reshape(b, s, -1, hd)
    k = (normed @ dq(layer["wk"], x.dtype)).reshape(b, s, -1, hd)
    v = (normed @ dq(layer["wv"], x.dtype)).reshape(b, s, -1, hd)
    q = _rope(q, positions, config.rope_theta)
    k = _rope(k, positions, config.rope_theta)
    return q, k, v


def _qkv(config: TransformerConfig, layer, x, positions, mesh=None):
    """``_project`` and the GQA repeat: q, k, v in the kernels' ``[b,
    heads, s, head_dim]`` layout (a tp rank's own heads under a mesh)."""
    q, k, v = _project(config, layer, x, positions, mesh)
    h, kv = q.shape[2], k.shape[2]
    if kv != h:
        k = k.repeat_interleave(h // kv, dim=2)
        v = v.repeat_interleave(h // kv, dim=2)
    return tuple(t.transpose(1, 2) for t in (q, k, v))


def _attn_residual(config: TransformerConfig, layer, x, attn, mesh=None):
    """The output projection of ``attn [b, heads, s, head_dim]`` onto
    the residual stream (under a mesh, wo's rows of this rank's heads,
    the partial sums all-reduced over tp)."""
    b, s, _ = x.shape
    attn = attn.transpose(1, 2).reshape(b, s, attn.shape[1] * attn.shape[3])
    return x + reduce_from(attn @ dq(layer["wo"], x.dtype), mesh, TP)


def _attention(config: TransformerConfig, q, k, v, mesh=None):
    """Causal attention of ``[b, heads, s, head_dim]`` operands: the
    config's sequence-parallel recipe over the mesh's sp ranks (none: an
    axis of one rank), or flash attention."""
    if config.use_ring_attention:
        run = current_run()
        return ring_attention(q, k, v, mesh, config.sp_axis,
                              overlap=run is not None and run.ring)
    if config.use_ulysses_attention:
        return ulysses_attention(q, k, v, mesh, config.sp_axis)
    return flash_attention(q, k, v, causal=True)


def _attention_block(config: TransformerConfig, layer, x, positions,
                     mesh=None):
    attn = _attention(config, *_qkv(config, layer, x, positions, mesh),
                      mesh)
    return _attn_residual(config, layer, x, attn, mesh)


def _mlp_block(layer, x, mesh=None):
    normed = copy_to(rms_norm(x, layer["mlp_norm"]), mesh, TP)
    gate = F.silu(normed @ dq(layer["w_gate"], x.dtype))
    up = normed @ dq(layer["w_up"], x.dtype)
    return x + reduce_from((gate * up) @ dq(layer["w_down"], x.dtype), mesh,
                           TP)


def _ffn_block(config: TransformerConfig, layer, x, decode: bool = False,
               mesh=None):
    """The per-layer FFN: dense SwiGLU or MoE.  Returns (x, aux): the
    MoE aux loss, the mean over routing groups (0.0 when dense).

    MoE: tokens route in groups of ``s`` positions when ``s <=
    moe_group_size``, else of ``moe_group_size`` when it divides ``s``,
    else of ``s`` (groups never straddle batch rows).  In ``decode`` the
    capacity covers every token of the group: a server never drops a
    token, and drop-free routing is what makes cached decode equal a
    full forward."""
    if config.n_experts <= 0:
        return _mlp_block(layer, x, mesh), 0.0
    b, s, d = x.shape
    normed = rms_norm(x, layer["mlp_norm"])
    gs = config.moe_group_size
    group = s if s <= gs else (gs if s % gs == 0 else s)
    moe_params = {key: layer[key]
                  for key in ("router", "w_gate", "w_up", "w_down")}
    tokens = normed.reshape(b * s // group, group, d)
    capacity = group if decode else None
    y, aux = moe_ffn(_moe_config(config), moe_params, tokens,
                     capacity=capacity, impl=config.moe_impl, mesh=mesh)
    return x + y.reshape(b, s, d), aux.mean()


def _layer_fn(config: TransformerConfig, layers, i: int, x, positions,
              mesh=None):
    """One layer: (x, the FFN's aux)."""
    layer = _layer(config, layers, i, mesh)
    x = _attention_block(config, layer, x, positions, mesh)
    return _ffn_block(config, layer, x, mesh=mesh)


def _checkpointed(fn, *args):
    # no layer draws random numbers, so the RNG state need not be
    # saved for the recompute; non-reentrant, so tensors the function
    # closes over (the stacked params) get their gradients
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _save_attn_layer(config: TransformerConfig, layers, i: int, x,
                     positions, mesh=None):
    """One layer under ``remat_policy="save-attn"``: the checkpointed
    region is split around attention, so the attention's output and
    the flash kernel's own residuals (q, k, v, o, lse) are kept and the
    rest of the layer (norms, projections, RoPE, the MLP) is recomputed
    in backward.  The flash forward never re-runs."""

    def qkv(x):
        return _qkv(config, _layer(config, layers, i, mesh), x, positions,
                    mesh)

    def rest(x, attn):
        layer = _layer(config, layers, i, mesh)
        return _ffn_block(config, layer,
                          _attn_residual(config, layer, x, attn, mesh),
                          mesh=mesh)

    attn = _attention(config, *_checkpointed(qkv, x), mesh)
    return _checkpointed(rest, x, attn)


def _layer_scan(config: TransformerConfig, layers, x, positions,
                mesh=None):
    """Run x through the stack of layers: (x, the aux summed over
    layers).

    Remat (``config.remat``, only while autograd records): each layer
    runs under ``torch.utils.checkpoint`` — ``"full"`` recomputes the
    whole layer in backward, ``"save-attn"`` keeps the attention (see
    ``_save_attn_layer``).  Mixed remat (``no_remat_layers`` = k > 0):
    the LAST k layers run without checkpointing, storing their
    activations instead of recomputing them — those activations die
    first in backward.  Remat never changes a value: the recompute runs
    the same deterministic kernels on the same inputs."""
    n_layers = len(layers["attn_norm"])
    remat = config.remat and torch.is_grad_enabled()
    k = config.no_remat_layers if config.remat else 0
    first_stored = n_layers - min(max(k, 0), n_layers)
    aux_total = 0.0
    for i in range(n_layers):
        if not remat or i >= first_stored:
            x, aux = _layer_fn(config, layers, i, x, positions, mesh)
        elif config.remat_policy == "save-attn":
            x, aux = _save_attn_layer(config, layers, i, x, positions, mesh)
        else:
            x, aux = _checkpointed(
                lambda x, i=i: _layer_fn(config, layers, i, x, positions,
                                         mesh), x
            )
        aux_total = aux_total + aux
    return x, aux_total


def _logits(config: TransformerConfig, params: Params, x: torch.Tensor,
            mesh=None, embed=None) -> torch.Tensor:
    """Final norm and the tied head, in f32.  Under a mesh ``embed`` is
    this rank's block of the vocabulary (fsdp gathered), and so are the
    logits."""
    x = copy_to(rms_norm(x, params["final_norm"]), mesh, TP)
    embed = params["embed"] if embed is None else embed
    return x.float() @ embed.float().T


def _nll(logits: torch.Tensor, targets: torch.Tensor, mesh=None
         ) -> torch.Tensor:
    if mesh is not None and mesh.size(TP) > 1:
        return vocab_parallel_nll(logits, targets, mesh)
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets.long()[..., None])[..., 0]


def _embed_block(params: Params, mesh: Mesh) -> torch.Tensor:
    """This rank's vocabulary rows of the embedding, fsdp gathered."""
    return gather_fsdp(params["embed"], P("tp", "fsdp"), mesh)


def _trunk(
    config: TransformerConfig,
    params: Params,
    tokens: torch.Tensor,
    positions: Optional[torch.Tensor] = None,
    mesh=None,
    embed=None,
):
    """tokens [b, s] -> (final hidden states [b, s, d], MoE aux summed
    over layers; 0.0 when dense).  Under a mesh, ``embed`` is
    ``_embed_block``'s and the lookup is vocab-parallel over tp; under a
    sequence-parallel recipe ``tokens`` are the rank's chunk of the
    sequence, whose RoPE positions start at its global offset."""
    b, s = tokens.shape
    if positions is None:
        start = 0
        if config.sequence_parallel and mesh is not None:
            start = mesh.index((config.sp_axis,)) * s
        positions = torch.arange(start, start + s,
                                 device=tokens.device).expand(b, s)
    if mesh is None:
        x = params["embed"][tokens]
    elif mesh.size(TP) > 1:
        x = vocab_parallel_embed(embed, tokens, mesh)
    else:
        x = embed[tokens]
    return _layer_scan(config, params["layers"], x.to(config.dtype),
                       positions, mesh)


def forward(
    config: TransformerConfig,
    params: Params,
    tokens: torch.Tensor,
    positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """tokens [b, s] -> logits [b, s, vocab] (f32), on tokens' device."""
    x, _aux = _trunk(config, params, tokens, positions)
    return _logits(config, params, x)


def _nll_mean(
    config: TransformerConfig,
    params: Params,
    x: torch.Tensor,
    targets: torch.Tensor,
    mesh=None,
    embed=None,
) -> torch.Tensor:
    """Mean NLL over [b, s] positions from final hidden states.

    With ``loss_chunk`` set, walks the sequence in chunks so only
    [b, chunk, vocab] f32 logits are ever live; each chunk is
    checkpointed, so the backward recomputes its logits instead of
    saving them.  Under a mesh the logits of a chunk are this rank's
    block of the vocabulary, and ``_nll`` reduces over tp."""
    b, s, _ = x.shape
    chunk = config.loss_chunk
    if chunk <= 0 or s % chunk != 0 or s == chunk:
        return _nll(_logits(config, params, x, mesh, embed), targets,
                    mesh).mean()

    def chunk_sum(xc, tc):
        return _nll(_logits(config, params, xc, mesh, embed), tc,
                    mesh).sum()

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(0, s, chunk):
        xc, tc = x[:, c:c + chunk], targets[:, c:c + chunk]
        if torch.is_grad_enabled():
            total = total + _checkpointed(chunk_sum, xc, tc)
        else:
            total = total + chunk_sum(xc, tc)
    return total / (b * s)


def loss_fn(
    config: TransformerConfig, params: Params, tokens: torch.Tensor,
    targets: torch.Tensor, mesh: Optional[Mesh] = None,
) -> torch.Tensor:
    """Mean NLL (plus the MoE aux term).  Under a mesh: ``params`` are
    this rank's blocks and ``tokens``/``targets`` its rows (and under a
    sequence-parallel recipe its chunk of the sequence), and the loss is
    the mean over them, the same on every tp and ep rank."""
    embed = None if mesh is None else _embed_block(params, mesh)
    x, aux = _trunk(config, params, tokens, mesh=mesh, embed=embed)
    loss = _nll_mean(config, params, x, targets, mesh, embed)
    if config.n_experts > 0:
        # switch-transformer load-balancing term, averaged per layer
        loss = loss + config.moe_aux_weight * aux / config.n_layers
    return loss


def pipeline_param_specs(config: TransformerConfig) -> Dict[str, Dims]:
    """Param path -> rule of a pipeline stage: every ``layers`` leaf split
    over pp on its leading (layer) axis, everything else replicated
    (the reference's ``pipeline_param_specs``, keyed as
    ``sharding_rules``; ``shard_params(..., rules=)`` takes it)."""
    return {
        path: (("pp",) if path.startswith("layers/") else (),)
        + ((),) * (len(rule) - 1)
        for path, rule in sharding_rules(config).items()
    }


def _pipeline_trunk(config: TransformerConfig, params: Params,
                    tokens: torch.Tensor, n_micro: int, mesh: Optional[Mesh],
                    axis: str) -> torch.Tensor:
    """Embedding and the pipelined layer stack: ``[n_micro, b/n_micro, s,
    d]``, the outputs on the last pp rank (zeros elsewhere)."""
    if config.n_experts > 0:
        raise NotImplementedError(
            "MoE layers are not pipelined yet: run ep x dp/fsdp/tp "
            "meshes for the MoE flagship"
        )
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b // n_micro, s)
    micro = split_microbatches(params["embed"][tokens].to(config.dtype),
                               n_micro)
    return pipeline_apply(
        lambda layers, x: _layer_scan(config, layers, x, positions)[0],
        params["layers"], micro, mesh, axis)


def pipeline_forward(config: TransformerConfig, params: Params,
                     tokens: torch.Tensor, n_micro: int,
                     mesh: Optional[Mesh], axis: str = "pp") -> torch.Tensor:
    """Logits ``[b, s, vocab]`` (f32) with the layers pipelined over
    ``axis`` in ``n_micro`` GPipe microbatches, on every rank (one
    activation-sized all-reduce; training wants ``pipeline_loss_fn``).
    ``params`` is this rank's stage (``shard_params`` with
    ``pipeline_param_specs``)."""
    out = _pipeline_trunk(config, params, tokens, n_micro, mesh, axis)
    out = last_stage_value(out, mesh, axis)
    return _logits(config, params, merge_microbatches(out))


def pipeline_loss_fn(config: TransformerConfig, params: Params,
                     tokens: torch.Tensor, targets: torch.Tensor,
                     n_micro: int, mesh: Optional[Mesh], axis: str = "pp"
                     ) -> torch.Tensor:
    """Mean NLL of ``tokens``/``targets`` (this rank's rows) with the
    layers pipelined over ``axis``, the same on every pp rank.  Only the
    last rank computes the logits and the loss; the others read their
    zeros (which keeps the pipeline's backward hops in their graphs,
    ``parallel/pipeline.py``), and the loss is summed over ``axis`` with
    an identity backward: one scalar all-reduce."""
    out = merge_microbatches(
        _pipeline_trunk(config, params, tokens, n_micro, mesh, axis))
    n = 1 if mesh is None else mesh.size((axis,))
    if n == 1 or mesh.index((axis,)) == n - 1:
        local = _nll(_logits(config, params, out), targets).mean()
    else:
        local = out.float().sum() * 0.0
    return reduce_from(local, mesh, (axis,))


def pipeline_value_and_grad(config: TransformerConfig, params: Params,
                            tokens: torch.Tensor, targets: torch.Tensor,
                            n_micro: int, mesh: Mesh, axis: str = "pp"):
    """(loss, gradients) of ``pipeline_loss_fn`` over the global batch:
    the counterpart of ``jax.value_and_grad`` of the reference's
    ``shard_map`` of ``pipeline_loss_fn`` with the loss ``pmean``-ed over
    the batch axes.  Every rank calls it with its stage and its rows.
    The replicated leaves (the tied ``embed``, read by rank 0's lookup
    and the last rank's head, and ``final_norm``) have their gradients
    summed over ``axis``; every gradient is then averaged over the data
    axes.  The gradients come back in a tree shaped like ``params``."""
    leaves, structure = tree_flatten(params)
    loss = pipeline_loss_fn(config, params, tokens, targets, n_micro, mesh,
                            axis)
    # final_norm is read on the last rank only
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
        leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
    staged = [key == "layers" for key in sorted(params)
              for _ in tree_leaves(params[key])]
    n = mesh.size(DATA_AXES)
    for j, (g, in_stage) in enumerate(zip(grads, staged)):
        if not in_stage:
            g = all_reduce(g.contiguous(), mesh.group((axis,)))
        g = all_reduce(g.contiguous(), mesh.group(DATA_AXES))
        grads[j] = g / n if n > 1 else g
    return batch_mean(loss.detach(), mesh), tree_unflatten(structure, grads)


def adamw(params: Params, lr: float = 3e-4) -> torch.optim.AdamW:
    """The counterpart of ``optax.adamw(lr)``: b1 0.9, b2 0.999, eps
    1e-8 and weight decay 1e-4 (optax's default; torch's is 0.01) on
    every leaf, as optax has no mask by default.  torch's AdamW decays
    ``p`` by ``lr * wd * p`` before the moment update, optax adds
    ``wd * p`` to the update: the same step.  Every leaf becomes a
    trainable tensor (``requires_grad``); the optimizer's param order
    is the tree's (``tree_leaves``)."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    return torch.optim.AdamW(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def adamw_layout(params: Params, fill: Any):
    """optax.adamw's state layout over ``params`` with every leaf
    ``fill``: a template for a restore that reads only the params of a
    train-state checkpoint (``fill`` = ``utils.checkpoint.SKIP``)."""
    moments = tree_map(lambda _: fill, params)
    return ((fill, moments, moments), (), ())


def adamw_state(optimizer: torch.optim.AdamW, params: Params):
    """The optimizer's state laid out as optax.adamw's,
    ``(ScaleByAdamState(count, mu, nu), EmptyState(), EmptyState())``:
    ``((count, mu, nu), (), ())`` with ``mu``/``nu`` trees shaped like
    ``params`` and ``count`` an int32 scalar, so a train-state tree
    ``{"params": ..., "opt_state": ...}`` flattens to the leaves of the
    JAX train worker's checkpoint in its order.  A moment the optimizer
    has not made yet (no step taken) is a zero tensor, as optax's init
    is; the tensors are the optimizer's own, not copies."""
    leaves, structure = tree_flatten(params)
    mu, nu, count = [], [], 0
    for p in leaves:
        state = optimizer.state.get(p, {})
        mu.append(state.get("exp_avg", torch.zeros_like(p)))
        nu.append(state.get("exp_avg_sq", torch.zeros_like(p)))
        if "step" in state:
            count = int(state["step"])
    device = leaves[0].device
    return ((torch.tensor(count, dtype=torch.int32, device=device),
             tree_unflatten(structure, mu), tree_unflatten(structure, nu)),
            (), ())


def load_adamw_state(optimizer: torch.optim.AdamW, params: Params,
                     opt_state) -> None:
    """Set the optimizer's state from an ``adamw_state`` layout (for
    example a restored checkpoint's): the moments by tree position,
    optax's ``count`` as torch's ``step``."""
    (count, mu, nu), _, _ = opt_state
    for p, m, v in zip(tree_leaves(params), tree_leaves(mu),
                       tree_leaves(nu)):
        if m.shape != p.shape or v.shape != p.shape:
            raise ValueError(
                f"moment shapes {tuple(m.shape)}/{tuple(v.shape)} do not "
                f"match the param {tuple(p.shape)}"
            )
        optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": m.to(device=p.device, dtype=p.dtype),
            "exp_avg_sq": v.to(device=p.device, dtype=p.dtype),
        }


def train_state(params: Params, optimizer: torch.optim.AdamW) -> Params:
    """The trainer's checkpoint tree, ``{"params", "opt_state"}``, as
    the JAX train worker saves it (the tensors are the live ones)."""
    return {"params": params, "opt_state": adamw_state(optimizer, params)}


def load_train_state(params: Params, optimizer: torch.optim.AdamW,
                     state: Params) -> None:
    """Copy a restored ``train_state`` tree into the live params (in
    place: the optimizer holds them) and the optimizer's state."""
    with torch.no_grad():
        for p, value in zip(tree_leaves(params),
                            tree_leaves(state["params"])):
            p.copy_(value)
    load_adamw_state(optimizer, params, state["opt_state"])


def make_train_step(
    config: TransformerConfig,
    optimizer: torch.optim.Optimizer,
    mesh: Optional[Mesh] = None,
    grad_accum: int = 1,
    overlap: bool = False,
) -> Callable[[Params, torch.Tensor, torch.Tensor], torch.Tensor]:
    """Build a (params, tokens, targets) -> loss step, on one device or,
    with a ``mesh``, on this rank of a gang.

    The params (the optimizer's own leaves) and the optimizer state are
    updated IN PLACE: the step is the counterpart of the JAX package's
    jitted step with donated buffers (``donate`` has no torch meaning).
    The loss comes back as a 0-d f32 tensor on the params' device,
    without waiting for the card.

    ``grad_accum`` > 1 splits the batch into that many equal
    microbatches; their gradients accumulate in f32 and are applied as
    ``(sum / k).to(p.dtype)`` in ONE optimizer update; the loss is the
    mean of the microbatch losses.  A batch that does not split evenly
    raises ``ValueError``.  Remat (``config.remat``) composes per
    microbatch.

    With a ``mesh`` every rank calls the step together: ``params`` (and
    the optimizer's leaves) are this rank's blocks (``shard_params``),
    ``tokens``/``targets`` its rows of the global batch (rows
    ``[i * B/n, (i + 1) * B/n)`` for its index i of n over
    ``BATCH_AXES``) and, under a sequence-parallel recipe, its chunk of
    the sequence (positions ``[j * S/m, (j + 1) * S/m)`` for its index
    j of m over ``sp``: the reference's ``batch_spec``).  The gradients
    of the global mean loss come back on each rank's blocks
    (``reduce_gradients``), AdamW steps the blocks, and the returned
    loss is the global batch's.  A mesh whose axes are all 1 runs
    exactly the single-device step.  ``check_mesh`` says which meshes
    it refuses.

    ``overlap=True`` overlaps the step's collectives with its compute
    (``parallel/overlap.py``): it engages every mechanism the mesh makes
    a collective for (``overlap_mechanisms``), or raises
    ``OverlapError`` where there is none.  The values are the
    synchronous step's.  Each gradient is reduced
    from the backward as soon as autograd has made it (with
    ``grad_accum`` > 1, from the last microbatch's backward, each the
    same ``(sum / k).to(p.dtype)``); the step's ``overlap`` attribute
    names what engaged and ``stats`` counts it (``OverlapRun``)."""
    grad_accum = max(1, int(grad_accum))
    rules = None
    if mesh is not None:
        check_mesh(config, mesh)
        rules = leaf_rules(config)
    mechanisms = resolve(overlap, mesh, _ring_axis(config))

    def grads_of(tree, inputs, tokens, targets, run, reducer):
        """One microbatch's (loss, gradients of ``inputs``); its graph
        dies here, before the optimizer steps.  With a ``reducer`` its
        hooks take each gradient as autograd makes it."""
        if run:
            run.phase(backward=False)
        loss = loss_fn(config, tree, tokens, targets, mesh)
        if run:
            run.phase(backward=True)
        if reducer is not None:
            reducer.hooks(inputs)
        return loss.detach(), torch.autograd.grad(loss, inputs)

    def step(params, tokens, targets):
        leaves = tree_leaves(params)
        micro = ([(tokens, targets)] if grad_accum == 1 else list(zip(
            split_microbatches(tokens, grad_accum),
            split_microbatches(targets, grad_accum))))
        acc = None if grad_accum == 1 else [
            torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in leaves]
        loss, reducer = None, None
        run = OverlapRun(mechanisms, mesh) if mechanisms else None
        with run or contextlib.nullcontext():
            for m, (mb_tokens, mb_targets) in enumerate(micro):
                last = m == len(micro) - 1
                # overlapped, each layer's gradients are their own leaves
                tree, inputs, slots = (
                    _split_layers(params, leaves) if run else
                    (params, leaves, [(j, None) for j in range(len(leaves))]))
                if run and last:
                    # its hooks launch each bucket's reduction
                    reducer = GradReducer(mesh, leaves, rules, slots, acc,
                                          grad_accum)
                mb_loss, got = grads_of(tree, inputs, mb_tokens, mb_targets,
                                        run, reducer)
                loss = mb_loss if loss is None else loss + mb_loss
                if reducer is not None:
                    # the hooks kept what they need of ``got``: drop it
                    # before ``finish`` makes the leaves' gradients
                    del got
                    grads = reducer.finish()
                    run.count(reducer)
                    continue
                wait_scatters()
                if acc is None:
                    grads = list(got)
                elif last:
                    grads = [accumulated_mean(a, g, grad_accum)
                             for a, g in zip(acc, got)]
                else:
                    for (j, i), g in zip(slots, got):
                        (acc[j] if i is None else acc[j][i]).add_(g.float())
                del got
            if acc is not None:
                loss = loss / grad_accum
            if mesh is not None:
                if reducer is None:
                    grads = reduce_gradients(grads, rules, mesh)
                loss = batch_mean(loss, mesh)
        if run:
            stats.update(run.stats)
        for p, g in zip(leaves, grads):
            p.grad = g
        optimizer.step()
        for p in leaves:
            p.grad = None
        return loss

    # a dict of its own, not ``step.stats`` set inside ``step``: a
    # function that names itself is a reference cycle, which would keep
    # the optimizer and its state alive until the cycle collector runs
    stats: Dict[str, int] = {}
    step.overlap, step.stats = mechanisms, stats
    return step


def _ring_axis(config: TransformerConfig) -> Optional[str]:
    return config.sp_axis if config.use_ring_attention else None


def overlap_mechanisms(config: TransformerConfig, mesh: Optional[Mesh]
                       ) -> tuple:
    """What ``make_train_step(..., overlap=True)`` engages on ``mesh``
    (``overlap.applicable`` with this config's ring axis): empty where
    it would raise ``OverlapError``."""
    return applicable(mesh, _ring_axis(config))


def _split_layers(params: Params, leaves: List[torch.Tensor]):
    """The tree an overlapped step differentiates: every leaf aliased by
    a leaf of its own and each stacked ``layers`` leaf by one a layer
    (a view of its row), so each layer's gradients exist as soon as
    that layer's backward is done.  Returns (the tree, the new leaves,
    and for each the (leaf index, row or None) it aliases)."""
    index = {id(p): j for j, p in enumerate(leaves)}
    inputs, slots = [], []

    def alias(p, i=None):
        t = (p.detach() if i is None else p.detach()[i]).requires_grad_(True)
        inputs.append(t)
        slots.append((index[id(p)], i))
        return t

    tree = {key: (alias(value) if key != "layers" else {
        name: [alias(leaf, i) for i in range(leaf.shape[0])]
        for name, leaf in value.items()}) for key, value in params.items()}
    return tree, inputs, slots

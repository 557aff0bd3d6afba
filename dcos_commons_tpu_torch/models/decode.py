"""KV-cache autoregressive inference for the flagship transformer
(port of ``dcos_commons_tpu/models/decode.py``).

Layout as the reference: cache k/v are ``[n_layers, batch, max_len,
n_kv_heads, head_dim]`` (GQA heads stored unexpanded), the paged arena
``[n_layers, n_pages, page_tokens, n_kv_heads, head_dim]`` with page 0
the TRASH page and page-table entry 0 meaning "unallocated".  int8
caches add per-vector f32 scales (``k_scale``/``v_scale``, trailing
dim 1).

Differences from the reference, none visible in the outputs:
- The ``lax.scan`` over layers is a Python loop.
- Cache writes are IN PLACE: every function that takes a cache
  updates its tensors and returns the same dict.
- The slot pool's prefill attends with kernel K2 (``flash_attention``);
  decode steps and the paged path attend with a masked softmax over
  the cache in f32, as the reference does (no kernel there).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from dcos_commons_tpu_torch.device import resolve_device
from dcos_commons_tpu_torch.models.quantize import dequantize_weight as dq
from dcos_commons_tpu_torch.models.transformer import (
    TransformerConfig,
    _ffn_block,
    _logits,
    _rope,
    check_supported,
    layer_params,
)
from dcos_commons_tpu_torch.ops.attention import flash_attention
from dcos_commons_tpu_torch.ops.rmsnorm import rms_norm

Params = Dict[str, Any]
Cache = Dict[str, torch.Tensor]
_NEG = -1e30


def _empty_cache(config: TransformerConfig, shape, kv_dtype: str,
                 device) -> Cache:
    dev = resolve_device(device)
    if kv_dtype == "int8":
        scale_shape = shape[:-1] + (1,)
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=dev),
            "v": torch.zeros(shape, dtype=torch.int8, device=dev),
            "k_scale": torch.zeros(scale_shape, dtype=torch.float32,
                                   device=dev),
            "v_scale": torch.zeros(scale_shape, dtype=torch.float32,
                                   device=dev),
        }
    if kv_dtype != "native":
        raise ValueError(f"kv_dtype {kv_dtype!r} not in ('native', 'int8')")
    return {
        "k": torch.zeros(shape, dtype=config.dtype, device=dev),
        "v": torch.zeros(shape, dtype=config.dtype, device=dev),
    }


def init_kv_cache(config: TransformerConfig, batch: int, max_len: int,
                  kv_dtype: str = "native", device=None) -> Cache:
    shape = (config.n_layers, batch, max_len, config.n_kv_heads,
             config.head_dim)
    return _empty_cache(config, shape, kv_dtype, device)


def init_paged_kv_cache(config: TransformerConfig, n_pages: int,
                        page_tokens: int, kv_dtype: str = "native",
                        device=None) -> Cache:
    """The paged arena: ``n_pages`` pages of ``page_tokens`` positions
    (page 0 is the trash page; see the module doc)."""
    shape = (config.n_layers, n_pages, page_tokens, config.n_kv_heads,
             config.head_dim)
    return _empty_cache(config, shape, kv_dtype, device)


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-vector symmetric int8: each [head_dim] slice gets its own
    max-abs scale."""
    x32 = x.float()
    scale = (x32.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-8)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def _project_kv(config, layer, normed, positions):
    """normed [b, s, d] -> roped q, k, v in [b, s, heads, hd]."""
    b, s, _ = normed.shape
    h, kv, hd = config.n_heads, config.n_kv_heads, config.head_dim
    q = (normed @ dq(layer["wq"], normed.dtype)).reshape(b, s, h, hd)
    k = (normed @ dq(layer["wk"], normed.dtype)).reshape(b, s, kv, hd)
    v = (normed @ dq(layer["wv"], normed.dtype)).reshape(b, s, kv, hd)
    q = _rope(q, positions, config.rope_theta)
    k = _rope(k, positions, config.rope_theta)
    return q, k, v


def _kv_entries(cache: Cache, k: torch.Tensor, v: torch.Tensor):
    """(cache key, value to store) for new K/V, quantized when the
    cache is int8."""
    if "k_scale" in cache:
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        return (("k", kq), ("v", vq), ("k_scale", ks), ("v_scale", vs))
    return (("k", k), ("v", v))


def _last_logits(params, x, true_len) -> torch.Tensor:
    """Logits [b, vocab] f32 at each row's last real position."""
    b, s, _ = x.shape
    if true_len is None:
        x_last = x[:, s - 1]
    else:
        last = torch.as_tensor(true_len, device=x.device).long() - 1
        if last.dim() == 0:
            x_last = x[:, last]
        else:
            x_last = x[torch.arange(b, device=x.device), last]
    return _logits(params, x_last)


def _prefill_trunk(config, params, tokens, write):
    """Run the prompt through the trunk with causal flash attention
    (kernel K2 on the card); ``write(i, k, v)`` stores layer i's
    captured K/V [b, s, kv, hd].  Returns the final hidden states
    [b, s, d]."""
    check_supported(config)
    b, s = tokens.shape
    h, kv = config.n_heads, config.n_kv_heads
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = params["embed"][tokens].to(config.dtype)
    for i in range(config.n_layers):
        layer = layer_params(params["layers"], i)
        normed = rms_norm(x, layer["attn_norm"])
        q, k, v = _project_kv(config, layer, normed, positions)
        k_full, v_full = k, v
        if kv != h:
            k_full = k.repeat_interleave(h // kv, dim=2)
            v_full = v.repeat_interleave(h // kv, dim=2)
        attn = flash_attention(
            *(t.transpose(1, 2) for t in (q, k_full, v_full)), causal=True
        )
        attn = attn.transpose(1, 2).reshape(b, s, -1)
        x = x + attn @ dq(layer["wo"], x.dtype)
        x = _ffn_block(config, layer, x)
        write(i, k, v)
    return x


def prefill(
    config: TransformerConfig,
    params: Params,
    tokens: torch.Tensor,
    max_len: int,
    true_len=None,
    kv_dtype: str = "native",
) -> Tuple[torch.Tensor, Cache]:
    """tokens [b, s] (s <= max_len) -> (logits of the last real
    position [b, vocab] f32, a new cache filled for positions [0, s)).

    ``true_len`` (a scalar, or a [b] vector of per-row lengths) serves
    right-padded prompts: causal attention keeps positions < true_len
    blind to the padding, and the logits are read at true_len - 1."""
    b, s = tokens.shape
    if s > max_len:
        raise ValueError(f"prompt {s} exceeds cache max_len {max_len}")
    cache = init_kv_cache(config, b, max_len, kv_dtype, tokens.device)

    def write(i, k, v):
        for name, val in _kv_entries(cache, k, v):
            cache[name][i, :, :s] = val

    x = _prefill_trunk(config, params, tokens, write)
    return _last_logits(params, x, true_len), cache


def prefill_into_slot(
    config: TransformerConfig,
    params: Params,
    cache: Cache,
    tokens: torch.Tensor,
    slot: Union[int, torch.Tensor],
    true_len=None,
) -> Tuple[torch.Tensor, Cache]:
    """Prefill prompt(s) ``tokens [nb, s]`` into rows of a persistent
    slot-pool cache: ``nb`` consecutive rows from ``slot`` (an int) or
    the rows of a [nb] index tensor.  The whole row is overwritten
    (positions >= s zeroed), so nothing of a previous occupant
    survives.  Returns (last-real-position logits [nb, vocab] f32, the
    cache, updated in place)."""
    nb, s = tokens.shape
    max_len = cache["k"].shape[2]
    if s > max_len:
        raise ValueError(f"prompt {s} exceeds cache max_len {max_len}")
    if isinstance(slot, int):
        rows: Any = slice(slot, slot + nb)
    else:
        rows = torch.as_tensor(slot, device=tokens.device).long()
        if rows.dim() == 0:
            rows = slice(int(rows), int(rows) + nb)

    def write(i, k, v):
        for name, val in _kv_entries(cache, k, v):
            buf = cache[name]
            buf[i, rows, :s] = val.to(buf.dtype)
            buf[i, rows, s:] = 0

    x = _prefill_trunk(config, params, tokens, write)
    return _last_logits(params, x, true_len), cache


def sample_token(logits: torch.Tensor, temperature: float,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """Greedy when ``temperature`` == 0, else softmax sampling from
    ``generator`` (on logits' device).  One row [vocab] or a batch
    [b, vocab] sharing the generator; returns int64 token ids."""
    temp = float(temperature)
    if temp <= 0.0:
        return logits.argmax(dim=-1)
    if generator is None:
        raise ValueError("sampling (temperature > 0) needs a generator")
    probs = torch.softmax(logits.float() / max(temp, 1e-6), dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    picked = torch.multinomial(flat, 1, generator=generator)[:, 0]
    return picked.reshape(probs.shape[:-1])


def _attend(config, q, k_all, v_all, valid, ks_all=None, vs_all=None):
    """Masked-softmax attention of new queries over cached keys, in
    f32, GQA-grouped against the unexpanded cache.  q [b, c, h, hd];
    k_all/v_all [b, L, kv, hd]; valid broadcastable to [b, c, L];
    int8 scales [b, L, kv] fold into scores and probabilities."""
    b, c = q.shape[:2]
    h, kv, hd = config.n_heads, config.n_kv_heads, config.head_dim
    reps = h // kv
    qg = (q.float() * hd ** -0.5).reshape(b, c, kv, reps, hd)
    scores = torch.einsum("bqkrd,blkd->bqkrl", qg, k_all.float())
    if ks_all is not None:
        scores = scores * ks_all.permute(0, 2, 1)[:, None, :, None, :]
    valid = valid[:, :, None, None, :]
    scores = torch.where(valid, scores, torch.full_like(scores, _NEG))
    probs = torch.softmax(scores, dim=-1)
    if vs_all is not None:
        probs = probs * vs_all.permute(0, 2, 1)[:, None, :, None, :]
    attn = torch.einsum("bqkrl,blkd->bqkrd", probs, v_all.float())
    return attn.to(config.dtype).reshape(b, c, h * hd)


def _decode_trunk(config, params, cache, x, positions, store, gather,
                  valid):
    """Shared layer loop of the cached paths: project, ``store(i, name,
    value)`` the new K/V, ``gather(i, name)`` the attended [b, L, ...]
    cache view, attend, FFN.  Returns the final hidden states."""
    check_supported(config)
    quantized = "k_scale" in cache
    for i in range(config.n_layers):
        layer = layer_params(params["layers"], i)
        normed = rms_norm(x, layer["attn_norm"])
        q, k_new, v_new = _project_kv(config, layer, normed, positions)
        for name, val in _kv_entries(cache, k_new, v_new):
            store(i, name, val)
        scales = (
            (gather(i, "k_scale")[..., 0], gather(i, "v_scale")[..., 0])
            if quantized else (None, None)
        )
        attn = _attend(config, q, gather(i, "k"), gather(i, "v"), valid,
                       *scales)
        x = x + attn @ dq(layer["wo"], x.dtype)
        x = _ffn_block(config, layer, x)
    return x


def decode_step(
    config: TransformerConfig,
    params: Params,
    cache: Cache,
    token: torch.Tensor,
    pos,
) -> Tuple[torch.Tensor, Cache]:
    """One autoregressive step: token [b] at position ``pos`` (an int
    shared by the batch, or a [b] tensor of per-row positions) ->
    (logits [b, vocab] f32, the cache, updated in place)."""
    b = token.shape[0]
    dev = token.device
    max_len = cache["k"].shape[2]
    x = params["embed"][token][:, None, :].to(config.dtype)
    pos_t = torch.as_tensor(pos, device=dev).long()
    per_row = pos_t.dim() == 1
    positions = pos_t[:, None] if per_row else pos_t.expand(b, 1)
    idx = torch.arange(max_len, device=dev)
    valid = (idx[None, :] <= positions)[:, None, :]  # [b, 1, max_len]
    rows = torch.arange(b, device=dev)

    def store(i, name, val):
        if per_row:
            cache[name][i, rows, pos_t] = val[:, 0].to(cache[name].dtype)
        else:
            cache[name][i, :, int(pos_t)] = val[:, 0].to(cache[name].dtype)

    x = _decode_trunk(config, params, cache, x, positions, store,
                      lambda i, name: cache[name][i], valid)
    return _logits(params, x[:, 0]), cache


def paged_prefill_chunk(
    config: TransformerConfig,
    params: Params,
    cache: Cache,
    tokens: torch.Tensor,
    table: torch.Tensor,
    start: int,
    true_len: int,
) -> Tuple[torch.Tensor, Cache]:
    """One chunk of a prompt through the trunk into a paged arena.

    ``tokens [1, C]`` carries up to C prompt tokens at virtual
    positions ``[start, start + true_len)`` of one request whose page
    table is ``table [M]`` (0 = unallocated).  The chunk's K/V is
    scattered through the table (pad positions into the trash page),
    then each query attends to every earlier virtual position gathered
    through the same table.  Returns (logits at the chunk's last real
    position [1, vocab] f32, the arena, updated in place)."""
    b, c = tokens.shape
    if b != 1:
        raise ValueError(f"prefill chunks are per-request, got batch {b}")
    dev = tokens.device
    p_tok = cache["k"].shape[2]
    table = torch.as_tensor(table, device=dev).long()
    m = table.shape[0]
    length = m * p_tok
    start, true_len = int(start), int(true_len)
    offs = torch.arange(c, device=dev)
    abs_pos = start + offs
    positions = abs_pos[None, :]
    vpage = torch.clamp(abs_pos // p_tok, max=m - 1)
    phys = torch.where(offs < true_len, table[vpage],
                       torch.zeros_like(vpage))
    slot_off = abs_pos % p_tok
    valid = (torch.arange(length, device=dev)[None, :]
             <= abs_pos[:, None])[None]              # [1, c, L]
    x = params["embed"][tokens].to(config.dtype)

    def store(i, name, val):
        cache[name][i][phys, slot_off] = val[0].to(cache[name].dtype)

    def gather(i, name):
        pages = cache[name][i][table]                 # [M, P, ...]
        return pages.reshape(1, length, *pages.shape[2:])

    x = _decode_trunk(config, params, cache, x, positions, store, gather,
                      valid)
    return _logits(params, x[:, true_len - 1]), cache


def paged_decode_step(
    config: TransformerConfig,
    params: Params,
    cache: Cache,
    token: torch.Tensor,
    pos: torch.Tensor,
    tables: torch.Tensor,
) -> Tuple[torch.Tensor, Cache]:
    """One step over the whole pool through per-row page tables:
    ``token [S]`` at positions ``pos [S]``, ``tables [S, M]`` ->
    (logits [S, vocab] f32, the arena, updated in place).  Inactive
    rows (all-zero tables) write into the trash page."""
    b = token.shape[0]
    dev = token.device
    p_tok = cache["k"].shape[2]
    tables = torch.as_tensor(tables, device=dev).long()
    m = tables.shape[1]
    length = m * p_tok
    pos = torch.as_tensor(pos, device=dev).long()
    positions = pos[:, None]
    rows = torch.arange(b, device=dev)
    vpage = torch.clamp(pos // p_tok, max=m - 1)
    phys = tables[rows, vpage]
    slot_off = pos % p_tok
    valid = (torch.arange(length, device=dev)[None, :]
             <= positions)[:, None, :]               # [b, 1, L]
    x = params["embed"][token][:, None, :].to(config.dtype)

    def store(i, name, val):
        cache[name][i][phys, slot_off] = val[:, 0].to(cache[name].dtype)

    def gather(i, name):
        pages = cache[name][i][tables]                # [b, M, P, ...]
        return pages.reshape(b, length, *pages.shape[3:])

    x = _decode_trunk(config, params, cache, x, positions, store, gather,
                      valid)
    return _logits(params, x[:, 0]), cache


def generate(
    config: TransformerConfig,
    params: Params,
    prompt: torch.Tensor,
    max_new_tokens: int,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    max_len: Optional[int] = None,
    true_len=None,
    kv_dtype: str = "native",
) -> torch.Tensor:
    """Autoregressive continuation: prompt [b, s] -> tokens
    [b, max_new_tokens] (int64).  temperature 0 = greedy; otherwise
    softmax sampling from ``generator``.  ``true_len`` (scalar or [b])
    serves right-padded mixed-length prompts."""
    b, s = prompt.shape
    total = max_len if max_len is not None else s + max_new_tokens
    if total < s + max_new_tokens:
        raise ValueError(
            f"max_len {total} cannot hold prompt {s} + "
            f"{max_new_tokens} new tokens"
        )
    if float(temperature) > 0.0 and generator is None:
        raise ValueError("sampling (temperature > 0) needs a generator")
    logits, cache = prefill(config, params, prompt, total, true_len,
                            kv_dtype=kv_dtype)
    token = sample_token(logits, temperature, generator)
    pos = (torch.as_tensor(true_len, device=prompt.device).long()
           if true_len is not None else s)
    out = [token]
    for _ in range(max_new_tokens - 1):
        logits, cache = decode_step(config, params, cache, token, pos)
        token = sample_token(logits, temperature, generator)
        out.append(token)
        pos = pos + 1
    return torch.stack(out, dim=1)

"""The port's model and decode functions (dcos_commons_tpu_torch/
models) against the JAX package's, on a tiny f32 config (2 layers,
d_model 32, 4 heads over 2 KV heads so GQA is covered, vocab 64).
JAX weights come from its own ``init_params`` and reach the port
through ``params_from_jax``; token inputs are numpy from a seed.
Logits agree to 1e-4 (f32, different summation orders); greedy tokens
are equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcos_commons_tpu.models import decode as j_decode
from dcos_commons_tpu.models import transformer as j_tf
from dcos_commons_tpu.models.quantize import quantize_params_int8
from dcos_commons_tpu.utils import tree as j_tree
from dcos_commons_tpu_torch.models import decode as t_decode
from dcos_commons_tpu_torch.models import transformer as t_tf
from dcos_commons_tpu_torch.models.bridge import params_from_jax
from dcos_commons_tpu_torch.models.quantize import (
    quantize_params_int8 as t_quantize_params_int8,
)
from dcos_commons_tpu_torch.utils import tree as t_tree

ATOL = 1e-4
J_CONFIG = j_tf.TransformerConfig(
    vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64,
    max_seq=64, dtype=jnp.float32, remat=False,
)
T_CONFIG = t_tf.TransformerConfig(
    vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64,
    max_seq=64, dtype=torch.float32, remat=False,
)


# one compile per function instead of one per eager op
_j_init = jax.jit(j_tf.init_params, static_argnums=0)
_j_forward = jax.jit(j_tf.forward, static_argnums=0)
_j_prefill = jax.jit(j_decode.prefill, static_argnums=(0, 3),
                     static_argnames="kv_dtype")
_j_decode_step = jax.jit(j_decode.decode_step, static_argnums=0)
_j_paged_chunk = jax.jit(j_decode.paged_prefill_chunk, static_argnums=0)
_j_paged_decode = jax.jit(j_decode.paged_decode_step, static_argnums=0)
_j_prefill_into_slot = jax.jit(j_decode.prefill_into_slot,
                               static_argnums=0)
_j_generate = jax.jit(j_decode.generate, static_argnums=(0, 3),
                      static_argnames="kv_dtype")


@pytest.fixture(scope="module")
def params():
    j_params = _j_init(J_CONFIG, jax.random.key(0))
    return j_params, params_from_jax(j_params, "cpu", torch.float32)


def _tokens(seed, *shape):
    return np.random.default_rng(seed).integers(0, 64, shape).astype(
        np.int32
    )


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(
        np.asarray(got.float() if isinstance(got, torch.Tensor) else got),
        np.asarray(want, np.float32), atol=atol, rtol=atol,
    )


def test_bridge_keeps_the_tree(params):
    j_params, t_params = params
    assert set(t_params) == set(j_params)
    assert set(t_params["layers"]) == set(j_params["layers"])
    for name, leaf in j_params["layers"].items():
        assert tuple(t_params["layers"][name].shape) == leaf.shape
    for tree in (j_params, quantize_params_int8(j_params)):
        ported = params_from_jax(tree, "cpu", torch.float32)
        assert t_tree.param_count(ported) == j_tree.param_count(tree)
        assert t_tree.param_bytes(ported) == j_tree.param_bytes(tree)


def test_init_params_matches_the_tree_shape():
    j_params = _j_init(J_CONFIG, jax.random.key(1))
    t_params = t_tf.init_params(T_CONFIG, seed=1, device="cpu")
    for name, leaf in j_params["layers"].items():
        assert tuple(t_params["layers"][name].shape) == leaf.shape
    assert tuple(t_params["embed"].shape) == j_params["embed"].shape


def test_forward_logits(params):
    j_params, t_params = params
    tokens = _tokens(0, 2, 24)
    want = _j_forward(J_CONFIG, j_params, jnp.asarray(tokens))
    got = t_tf.forward(T_CONFIG, t_params, _t(tokens))
    assert got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_prefill_logits_and_cache(params, kv_dtype):
    j_params, t_params = params
    tokens = _tokens(1, 2, 12)
    true_len = np.array([12, 7], np.int32)
    want_logits, want_cache = _j_prefill(
        J_CONFIG, j_params, jnp.asarray(tokens), 20,
        jnp.asarray(true_len), kv_dtype=kv_dtype,
    )
    got_logits, got_cache = t_decode.prefill(
        T_CONFIG, t_params, _t(tokens), 20, torch.from_numpy(true_len),
        kv_dtype=kv_dtype,
    )
    _close(got_logits, want_logits)
    assert set(got_cache) == set(want_cache)
    for name, arr in want_cache.items():
        got = got_cache[name]
        assert tuple(got.shape) == arr.shape
        if got.dtype == torch.int8:
            # int8 codes may differ by one step where rounding ties
            assert np.abs(got.numpy().astype(np.int32)
                          - np.asarray(arr, np.int32)).max() <= 1
        else:
            _close(got, arr)


@pytest.mark.parametrize("per_row", [False, True])
def test_decode_step(params, per_row):
    j_params, t_params = params
    tokens = _tokens(2, 3, 10)
    _, j_cache = _j_prefill(J_CONFIG, j_params, jnp.asarray(tokens),
                                  16)
    _, t_cache = t_decode.prefill(T_CONFIG, t_params, _t(tokens), 16)
    nxt = _tokens(3, 3)
    pos = np.array([10, 8, 9], np.int32) if per_row else 10
    for step in range(3):
        want, j_cache = _j_decode_step(
            J_CONFIG, j_params, j_cache, jnp.asarray(nxt), jnp.asarray(pos)
        )
        got, t_cache = t_decode.decode_step(
            T_CONFIG, t_params, t_cache, _t(nxt), _t(pos)
        )
        _close(got, want)
        nxt = np.asarray(want).argmax(-1).astype(np.int32)
        pos = pos + 1
    _close(t_cache["k"], j_cache["k"])
    _close(t_cache["v"], j_cache["v"])


def _paged_setup(kv_dtype="native"):
    j_cache = j_decode.init_paged_kv_cache(J_CONFIG, 9, 4, kv_dtype)
    t_cache = t_decode.init_paged_kv_cache(T_CONFIG, 9, 4, kv_dtype,
                                           device="cpu")
    return j_cache, t_cache


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_paged_prefill_chunks_and_decode(params, kv_dtype):
    """A 13-token prompt in staggered chunks of 5 (pad in the last),
    then a second request that reuses the first's two full pages (a
    prefix hit: its prefill starts at 8), then decode steps of both
    rows through their tables."""
    j_params, t_params = params
    j_cache, t_cache = _paged_setup(kv_dtype)
    prompt = _tokens(4, 13)
    table_a = np.array([1, 2, 3, 4, 0], np.int32)
    table_b = np.array([1, 2, 5, 6, 0], np.int32)

    def chunk(j_cache, t_cache, toks, table, start, n):
        pad = np.zeros((1, 5), np.int32)
        pad[0, :n] = toks
        want, j_cache = _j_paged_chunk(
            J_CONFIG, j_params, j_cache, jnp.asarray(pad),
            jnp.asarray(table), start, n,
        )
        got, t_cache = t_decode.paged_prefill_chunk(
            T_CONFIG, t_params, t_cache, _t(pad), _t(table), start, n,
        )
        _close(got, want)
        return want, j_cache, t_cache

    for start in (0, 5, 10):
        n = min(5, 13 - start)
        _, j_cache, t_cache = chunk(j_cache, t_cache,
                                    prompt[start:start + n], table_a,
                                    start, n)
    prompt_b = np.concatenate([prompt[:8], _tokens(5, 3)])
    last_b, j_cache, t_cache = chunk(j_cache, t_cache, prompt_b[8:],
                                     table_b, 8, 3)

    tok = np.array([7, int(np.asarray(last_b).argmax())], np.int32)
    pos = np.array([13, 11], np.int32)
    tables = np.stack([table_a, table_b])
    for _ in range(3):
        want, j_cache = _j_paged_decode(
            J_CONFIG, j_params, j_cache, jnp.asarray(tok), jnp.asarray(pos),
            jnp.asarray(tables),
        )
        got, t_cache = t_decode.paged_decode_step(
            T_CONFIG, t_params, t_cache, _t(tok), _t(pos), _t(tables),
        )
        _close(got, want)
        tok = np.asarray(want).argmax(-1).astype(np.int32)
        pos = pos + 1


def test_int8_weights(params):
    j_params, _ = params
    jq = quantize_params_int8(j_params)
    tq = params_from_jax(jq, "cpu", torch.float32)
    assert tq["layers"]["wq"]["q"].dtype == torch.int8
    tokens = _tokens(6, 2, 9)
    _close(t_tf.forward(T_CONFIG, tq, _t(tokens)),
           _j_forward(J_CONFIG, jq, jnp.asarray(tokens)))
    # the port's own quantizer gives the JAX package's codes and scales
    tq_own = t_quantize_params_int8(params_from_jax(j_params, "cpu"))
    for name in ("wq", "w_down"):
        np.testing.assert_array_equal(
            tq_own["layers"][name]["q"].numpy(),
            np.asarray(jq["layers"][name]["q"]),
        )
        _close(tq_own["layers"][name]["scale"],
               jq["layers"][name]["scale"], atol=1e-7)


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_generate_greedy_tokens_equal(params, kv_dtype):
    j_params, t_params = params
    prompt = _tokens(7, 2, 8)
    true_len = np.array([8, 5], np.int32)
    want = _j_generate(
        J_CONFIG, j_params, jnp.asarray(prompt), 10,
        true_len=jnp.asarray(true_len), kv_dtype=kv_dtype,
    )
    got = t_decode.generate(
        T_CONFIG, t_params, _t(prompt), 10,
        true_len=torch.from_numpy(true_len), kv_dtype=kv_dtype,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prefill_into_slot_overwrites_the_whole_row(params):
    j_params, t_params = params
    j_cache = j_decode.init_kv_cache(J_CONFIG, 3, 16)
    t_cache = t_decode.init_kv_cache(T_CONFIG, 3, 16, device="cpu")
    t_cache["k"].fill_(5.0)   # a previous occupant's K
    # one row at slot 1, then two rows at slots [2, 0] in one call
    for slot, seed, shape in ((1, 8, (1, 11)), ([2, 0], 9, (2, 6))):
        tokens = _tokens(seed, *shape)
        want, j_cache = _j_prefill_into_slot(
            J_CONFIG, j_params, j_cache, jnp.asarray(tokens),
            jnp.asarray(slot, jnp.int32),
        )
        got, t_cache = t_decode.prefill_into_slot(
            T_CONFIG, t_params, t_cache, _t(tokens),
            slot if isinstance(slot, int) else torch.tensor(slot),
        )
        _close(got, want)
    _close(t_cache["k"], j_cache["k"])
    _close(t_cache["v"], j_cache["v"])


def test_sampling_needs_a_generator():
    with pytest.raises(ValueError, match="generator"):
        t_decode.sample_token(torch.zeros(4), 0.5)
    g = torch.Generator().manual_seed(3)
    logits = torch.tensor([0.0, 0.0, 50.0, 0.0])
    assert int(t_decode.sample_token(logits, 1.0, g)) == 2
    assert int(t_decode.sample_token(logits, 0.0)) == 2


def test_moe_config_runs():
    """``n_experts > 0`` runs on one device: init, forward, loss and a
    greedy continuation (tests/test_torch_moe.py holds it against the
    JAX package)."""
    cfg = t_tf.TransformerConfig(n_experts=4, d_model=32, n_heads=4,
                                 n_kv_heads=4, vocab=64, n_layers=1,
                                 d_ff=32, dtype=torch.float32)
    params = t_tf.init_params(cfg, device="cpu")
    assert params["layers"]["w_gate"].shape == (1, 4, 32, 32)
    tokens = torch.from_numpy(_tokens(10, 2, 6)).long()
    assert t_tf.forward(cfg, params, tokens).shape == (2, 6, 64)
    assert torch.isfinite(t_tf.loss_fn(cfg, params, tokens, tokens))
    assert t_decode.generate(cfg, params, tokens, 3).shape == (2, 3)


def test_moe_and_sequence_parallel_raise():
    """What the train step does not run raises: a mesh with sequence
    parallelism (sp) and no recipe to attend across the split, and one
    with pipeline parallelism (pp), which takes ``pipeline_loss_fn``;
    the MoE's ``axis_name`` needs a mesh to reduce over
    (tests/test_torch_parallel.py runs it on one).  A recipe with no
    mesh attends over a sequence of one chunk: the plain forward."""
    from dcos_commons_tpu_torch.models.moe import MoEConfig, moe_ffn
    from dcos_commons_tpu_torch.parallel.mesh import Mesh, MeshSpec

    with pytest.raises(ValueError, match="needs a mesh"):
        moe_ffn(MoEConfig(d_model=32, d_ff=32, n_experts=4,
                          dtype=torch.float32), {}, torch.zeros(4, 32),
                axis_name="ep")
    cfg = t_tf.TransformerConfig(d_model=32, n_heads=4, n_kv_heads=4,
                                 vocab=64, n_layers=1, dtype=torch.float32)
    params = t_tf.init_params(cfg, device="cpu")
    tokens = torch.arange(6).reshape(1, 6)
    ring = t_tf.TransformerConfig(use_ring_attention=True, d_model=32,
                                  n_heads=4, n_kv_heads=4, vocab=64,
                                  n_layers=1, dtype=torch.float32)
    torch.testing.assert_close(t_tf.forward(ring, params, tokens),
                               t_tf.forward(cfg, params, tokens))
    with pytest.raises(NotImplementedError, match="no sequence-parallel"):
        t_tf.make_train_step(cfg, None, mesh=Mesh(MeshSpec(sp=2)))
    with pytest.raises(NotImplementedError, match="pipeline_loss_fn"):
        t_tf.make_train_step(cfg, None, mesh=Mesh(MeshSpec(pp=2)))
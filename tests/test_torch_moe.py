"""The port's mixture of experts (dcos_commons_tpu_torch/models/moe.py and
the MoE branch of the transformer) against the JAX package's, on the CPU
in f32 unless a test says otherwise.  Inputs are numpy from a seed; JAX
weights reach the port through ``params_from_jax``.

Tolerances: ``moe_ffn`` outputs within 1e-5 and its gradients within
1e-5 + 1e-4 relative (f32 sums in another order); routing (top-k
indices, the one-hot dispatch, the sorted slots and keep masks) equal
exactly; logits within 1e-4; the loss of three AdamW steps within 1e-5;
greedy tokens equal; checkpoints bit for bit.  The transformer cases
route in two groups a row (seq 16, ``moe_group_size`` 8), so a sum over
groups where the reference takes a mean shows in the loss."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dcos_commons_tpu.models import decode as j_decode
from dcos_commons_tpu.models import moe as j_moe
from dcos_commons_tpu.models import transformer as j_tf
from dcos_commons_tpu.models.quantize import quantize_params_int8
from dcos_commons_tpu.serve import pool as j_pool
from dcos_commons_tpu.utils import checkpoint as j_ckpt
from dcos_commons_tpu_torch.frameworks.serve_worker import build_server
from dcos_commons_tpu_torch.frameworks.train_worker import train
from dcos_commons_tpu_torch.models import decode as t_decode
from dcos_commons_tpu_torch.models import moe as t_moe
from dcos_commons_tpu_torch.models import transformer as t_tf
from dcos_commons_tpu_torch.models.bridge import (
    params_from_jax,
    params_to_jax,
    train_state_to_jax,
)
from dcos_commons_tpu_torch.models.quantize import (
    quantize_params_int8 as t_quantize_params_int8,
)
from dcos_commons_tpu_torch.serve import pool as t_pool
from dcos_commons_tpu_torch.utils import checkpoint as t_ckpt
from dcos_commons_tpu_torch.utils.tree import tree_leaves, tree_map

# -- moe_ffn ---------------------------------------------------------------

# (n_experts, top_k, capacity_factor): drop-free, and two tight
# capacities where the drop priority decides which entries survive
REGIMES = {
    "drop-free": (8, 2, 8.0),
    "tight-top2": (4, 2, 0.5),
    "tight-top1": (8, 1, 0.25),
}


def _moe_configs(regime, dtype=(jnp.float32, torch.float32)):
    e, k, cf = REGIMES[regime]
    kw = dict(d_model=32, d_ff=64, n_experts=e, top_k=k, capacity_factor=cf)
    return (j_moe.MoEConfig(**kw, dtype=dtype[0]),
            t_moe.MoEConfig(**kw, dtype=dtype[1]))


def _moe_params(j_config, seed=0):
    j_params = j_moe.init_moe_params(j_config, jax.random.key(seed))
    return j_params, {n: torch.from_numpy(np.asarray(v).copy())
                      for n, v in j_params.items()}


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("impl", ["onehot", "sorted"])
@pytest.mark.parametrize("regime", list(REGIMES))
def test_moe_ffn_matches_jax(regime, impl):
    """Three groups of 64 tokens, routed independently (the reference
    vmaps moe_ffn over them): outputs within 1e-5, aux per group."""
    j_config, t_config = _moe_configs(regime)
    j_params, t_params = _moe_params(j_config)
    x = _x(1, 3, 64, 32)
    want_y, want_aux = jax.vmap(
        lambda g: j_moe.moe_ffn(j_config, j_params, g, impl=impl)
    )(jnp.asarray(x))
    got_y, got_aux = t_moe.moe_ffn(t_config, t_params, torch.from_numpy(x),
                                   impl=impl)
    assert got_y.shape == x.shape and got_aux.shape == (3,)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_aux.numpy(), np.asarray(want_aux),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("regime", list(REGIMES))
def test_routing_matches_jax_exactly(regime):
    """The top-k choices, the one-hot dispatch (which tokens each
    expert keeps, in which slot) and the sorted path's slots, tokens and
    keep masks are the reference's, bit for bit."""
    j_config, t_config = _moe_configs(regime)
    j_params, t_params = _moe_params(j_config)
    x = _x(2, 64, 32)
    cap = j_config.capacity(64)
    assert cap == t_config.capacity(64)
    probs = jax.nn.softmax(jnp.asarray(x) @ j_params["router"], axis=-1)
    want_idx = np.asarray(jax.lax.top_k(probs, j_config.top_k)[1])
    _, got_idx, _, _ = t_moe._route(t_config, t_params, torch.from_numpy(x))
    np.testing.assert_array_equal(got_idx.numpy(), want_idx)

    want_d, want_c, want_aux = j_moe._routing(j_config, j_params,
                                              jnp.asarray(x), cap)
    got_d, got_c, got_aux = t_moe._routing(t_config, t_params,
                                           torch.from_numpy(x), cap)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-6)
    if regime != "drop-free":
        assert float(want_d.sum()) < 64 * j_config.top_k   # something drops

    want = j_moe._routing_sorted(j_config, j_params, jnp.asarray(x), cap)
    got = t_moe._routing_sorted(t_config, t_params, torch.from_numpy(x), cap)
    for name, w, g in zip(("slot", "token", "gate", "keep", "aux"), want,
                          got):
        if name in ("gate", "aux"):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                       rtol=1e-6)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=name)


@pytest.mark.parametrize("impl", ["onehot", "sorted"])
@pytest.mark.parametrize("regime", ["drop-free", "tight-top2"])
def test_moe_ffn_gradients_match_jax(regime, impl):
    """Gradients of (y^2).mean() + 0.01 aux into the router, the three
    expert stacks and the tokens."""
    j_config, t_config = _moe_configs(regime)
    j_params, t_params = _moe_params(j_config)
    x = _x(3, 2, 64, 32)

    def j_loss(p, x):
        y, aux = jax.vmap(lambda g: j_moe.moe_ffn(j_config, p, g,
                                                  impl=impl))(x)
        return (y ** 2).mean() + 0.01 * aux.mean()

    want_p, want_x = jax.grad(j_loss, argnums=(0, 1))(j_params,
                                                       jnp.asarray(x))
    leaves = {n: t.clone().requires_grad_(True) for n, t in t_params.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = t_moe.moe_ffn(t_config, leaves, tx, impl=impl)
    got = torch.autograd.grad((y ** 2).mean() + 0.01 * aux.mean(),
                              [*leaves.values(), tx])
    for name, g in zip([*leaves, "x"], got):
        w = want_x if name == "x" else want_p[name]
        assert float(np.abs(np.asarray(w)).max()) > 0, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-4, err_msg=name)


def test_moe_ffn_bf16_matches_jax():
    """bf16 compute (the dispatch and combine products in bf16, the
    router f32): within 2 bf16 ulps of the output's scale."""
    j_config, t_config = _moe_configs(
        "drop-free", (jnp.bfloat16, torch.bfloat16))
    j_params = j_moe.init_moe_params(j_config, jax.random.key(0))
    assert j_params["router"].dtype == jnp.float32
    t_params = {n: torch.from_numpy(np.asarray(v).astype(np.float32)).to(
        torch.float32 if n == "router" else torch.bfloat16)
        for n, v in j_params.items()}
    x = _x(4, 64, 32)
    for impl in ("onehot", "sorted"):
        want, _ = j_moe.moe_ffn(j_config, j_params,
                                jnp.asarray(x, jnp.bfloat16), impl=impl)
        got, _ = t_moe.moe_ffn(t_config, t_params,
                               torch.from_numpy(x).to(torch.bfloat16),
                               impl=impl)
        assert got.dtype == torch.bfloat16
        want = np.asarray(want).astype(np.float32)
        np.testing.assert_allclose(got.float().numpy(), want,
                                   atol=2 * 2 ** -8 * np.abs(want).max())


def test_moe_ffn_expert_parallelism_raises():
    """``axis_name`` outside a mesh, or over another axis than ep,
    raises; on a mesh the ep path matches the reference's shard_map
    case (tests/test_torch_parallel.py), and its layouts are the
    reference's (tests/test_torch_mesh.py)."""
    from dcos_commons_tpu_torch.parallel.mesh import Mesh, MeshSpec

    _, t_config = _moe_configs("drop-free")
    _, t_params = _moe_params(_moe_configs("drop-free")[0])
    with pytest.raises(ValueError, match="needs a mesh"):
        t_moe.moe_ffn(t_config, t_params, torch.zeros(8, 32),
                      axis_name="ep")
    with Mesh(MeshSpec()):
        with pytest.raises(ValueError, match="runs over 'ep'"):
            t_moe.moe_ffn(t_config, t_params, torch.zeros(8, 32),
                          axis_name="tp")
        # an ep axis of one rank is the single-device path
        x = torch.from_numpy(_x(3, 8, 32))
        for impl in ("onehot", "sorted"):
            got, aux = t_moe.moe_ffn(t_config, t_params, x, axis_name="ep",
                                     impl=impl)
            want, want_aux = t_moe.moe_ffn(t_config, t_params, x, impl=impl)
            assert torch.equal(got, want) and torch.equal(aux, want_aux)


# -- the MoE transformer ---------------------------------------------------

DIMS = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=64, max_seq=64, n_experts=4, moe_top_k=2,
            moe_group_size=8)


def _configs(dtype=(jnp.float32, torch.float32), **fields):
    kw = dict(DIMS, **{"remat": False, **fields})
    return (j_tf.TransformerConfig(**kw, dtype=dtype[0]),
            t_tf.TransformerConfig(**kw, dtype=dtype[1]))


J_CONFIG, T_CONFIG = _configs()


def _tokens(seed, *shape):
    return np.random.default_rng(seed).integers(0, 64, shape).astype(
        np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.fixture(scope="module")
def params():
    j_params = jax.jit(j_tf.init_params, static_argnums=0)(
        J_CONFIG, jax.random.key(0))
    return j_params, params_from_jax(j_params, "cpu", torch.float32)


def test_init_params_matches_the_tree_and_keeps_the_router_f32():
    j_config, t_config = _configs((jnp.bfloat16, torch.bfloat16))
    j_params = j_tf.init_params(j_config, jax.random.key(1))
    t_params = t_tf.init_params(t_config, seed=1, device="cpu")
    assert set(t_params["layers"]) == set(j_params["layers"])
    for name, leaf in j_params["layers"].items():
        assert tuple(t_params["layers"][name].shape) == leaf.shape, name
        want = torch.float32 if leaf.dtype == jnp.float32 else torch.bfloat16
        assert t_params["layers"][name].dtype == want, name
    assert t_params["layers"]["router"].dtype == torch.float32
    assert t_params["layers"]["w_gate"].dtype == torch.bfloat16
    # the bridge keeps the router f32 whatever dtype is asked, both ways
    bridged = params_from_jax(j_params, "cpu", torch.bfloat16)
    assert bridged["layers"]["router"].dtype == torch.float32
    assert params_to_jax(bridged)["layers"]["router"].dtype == np.float32
    quantized = t_quantize_params_int8(t_params)
    assert quantized["layers"]["router"] is t_params["layers"]["router"]


def test_forward_logits_match_jax(params):
    j_params, t_params = params
    tokens = _tokens(0, 2, 16)
    want = jax.jit(j_tf.forward, static_argnums=0)(J_CONFIG, j_params,
                                                   jnp.asarray(tokens))
    got = t_tf.forward(T_CONFIG, t_params, _t(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("seq", [16, 8, 12])
def test_aux_is_the_mean_over_groups_summed_over_layers(params, seq):
    """seq 16: two groups of 8 a row; 8: one group; 12: not a multiple
    of the group size, so one group of 12 a row."""
    j_params, t_params = params
    tokens = _tokens(1, 3, seq)
    _, want = j_tf._trunk(J_CONFIG, j_params, jnp.asarray(tokens))
    _, got = t_tf._trunk(T_CONFIG, t_params, _t(tokens))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


TRAIN_CASES = {
    "remat-off": {},
    "remat-full": dict(remat=True),
    "remat-save-attn": dict(remat=True, remat_policy="save-attn"),
    "no-remat-layers-1": dict(remat=True, no_remat_layers=1),
    "sorted": dict(remat=True, moe_impl="sorted"),
}


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_moe_train_steps_match_jax(case):
    """Three AdamW steps (optax.adamw(3e-4) on the JAX side), batch 4,
    seq 16: two routing groups a row, capacity 6 of 8 tokens an expert
    (factor 1.5), so the training path drops tokens."""
    fields = dict(TRAIN_CASES[case], max_seq=16)
    j_config, t_config = _configs(**fields)
    j_params = j_tf.init_params(j_config, jax.random.key(0))
    t_params = params_from_jax(j_params, "cpu", torch.float32)
    optimizer = optax.adamw(3e-4)
    j_state = optimizer.init(j_params)
    j_step = j_tf.make_train_step(j_config, optimizer, donate=False)
    t_step = t_tf.make_train_step(t_config, t_tf.adamw(t_params))
    toks = _tokens(2, 3, 4, 17)
    for batch in toks:
        j_params, j_state, j_loss = j_step(j_params, j_state, batch[:, :-1],
                                           batch[:, 1:])
        t_loss = t_step(t_params, _t(batch[:, :-1]), _t(batch[:, 1:]))
        np.testing.assert_allclose(float(t_loss), float(j_loss), atol=1e-5,
                                   rtol=1e-5)
    for want, got in zip(jax.tree.leaves(j_params), tree_leaves(t_params)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)
    assert t_params["layers"]["router"].dtype == torch.float32


def test_remat_recomputes_the_same_routing(params):
    """Full remat recomputes each layer's routing in backward: the
    gradients equal those of the stored forward."""
    _, t_params = params
    tokens = _tokens(3, 2, 16)
    grads = []
    for remat in (False, True):
        config = dataclasses.replace(T_CONFIG, remat=remat, max_seq=16)
        tree = tree_map(lambda p: p.detach().clone().requires_grad_(True),
                        t_params)
        leaves = tree_leaves(tree)
        loss = t_tf.loss_fn(config, tree, _t(tokens), _t(tokens))
        grads.append(torch.autograd.grad(loss, leaves))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_generate_greedy_tokens_equal(params):
    j_params, t_params = params
    prompt = _tokens(4, 2, 10)
    true_len = np.array([10, 6], np.int32)
    want = jax.jit(j_decode.generate, static_argnums=(0, 3))(
        J_CONFIG, j_params, jnp.asarray(prompt), 8,
        true_len=jnp.asarray(true_len))
    got = t_decode.generate(T_CONFIG, t_params, _t(prompt), 8,
                            true_len=torch.from_numpy(true_len))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _prompt(seed, n, width):
    out = np.zeros((1, width), np.int32)
    out[0, :n] = _tokens(seed, n)
    return out


def test_pools_greedy_tokens_equal_jax(params):
    """The slot pool and the paged pool (chunks of 5, a prefix-sharing
    second row) of both packages: the same greedy tokens at every step,
    and the port's two paths agree with each other."""
    j_params, t_params = params
    zeros_f, zeros_i = np.zeros(2, np.float32), np.zeros(2, np.int32)
    slot = [j_pool.PoolModel(J_CONFIG, j_params, 2, 24),
            t_pool.PoolModel(T_CONFIG, t_params, 2, 24)]
    args = (2, 24, 4, 12, 5)    # slots, max_len, page, pages, chunk
    paged = [j_pool.PagedPoolModel(J_CONFIG, j_params, *args),
             t_pool.PagedPoolModel(T_CONFIG, t_params, *args)]
    tables = np.zeros((2, 6), np.int32)
    tables[0, :4] = [1, 2, 3, 4]
    tables[1, :4] = [1, 2, 5, 6]
    prompts = [_prompt(5, 11, 11)[0]]
    prompts.append(np.concatenate([prompts[0][:8], _prompt(6, 3, 3)[0]]))
    streams = {}
    for name, pools in (("slot", slot), ("paged", paged)):
        tok = np.zeros(2, np.int32)
        for row, start in ((0, 0), (1, 8 if name == "paged" else 0)):
            if name == "slot":
                firsts = [p.prefill(prompts[row][None], row, 11, 0.0, 0)
                          for p in pools]
            while name == "paged" and start < 11:
                n = min(5, 11 - start)
                chunk = np.zeros((1, 5), np.int32)
                chunk[0, :n] = prompts[row][start:start + n]
                firsts = [p.prefill_chunk(chunk, row, tables[row], start, n,
                                          0.0, 0) for p in pools]
                start += n
            assert firsts[0] == firsts[1]
            tok[row] = firsts[0]
        pos = np.array([11, 11], np.int32)
        out = [tok.copy()]
        for _ in range(4):
            extra = (tables,) if name == "paged" else ()
            outs = [p.decode(tok, pos, zeros_f, zeros_i, *extra)
                    for p in pools]
            np.testing.assert_array_equal(outs[1], outs[0])
            tok = outs[0].astype(np.int32)
            out.append(tok)
            pos = pos + 1
        streams[name] = np.stack(out)
    np.testing.assert_array_equal(streams["slot"], streams["paged"])


def test_int8_experts(params):
    """The counterpart of tests/test_quantize.py's quantized MoE decode:
    the expert stacks quantize over their axis -2 under the same leaf
    names, the router stays as it was, and the port's codes are the
    JAX package's."""
    j_params, t_params = params
    jq = quantize_params_int8(j_params)
    tq = t_quantize_params_int8(t_params)
    assert tq["layers"]["router"] is t_params["layers"]["router"]
    for name in ("w_gate", "w_up", "w_down"):
        q, scale = tq["layers"][name]["q"], tq["layers"][name]["scale"]
        assert q.dtype == torch.int8 and q.dim() == 4
        assert scale.shape[-2] == 1
        np.testing.assert_array_equal(q.numpy(),
                                      np.asarray(jq["layers"][name]["q"]))
        np.testing.assert_allclose(scale.numpy(),
                                   np.asarray(jq["layers"][name]["scale"]),
                                   atol=1e-7, rtol=1e-7)
    prompt = _tokens(7, 2, 6)
    want = jax.jit(j_decode.generate, static_argnums=(0, 3))(
        J_CONFIG, jq, jnp.asarray(prompt), 4)
    got = t_decode.generate(T_CONFIG, tq, _t(prompt), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), t_decode.generate(T_CONFIG, t_params, _t(prompt),
                                       4).numpy())
    bridged = params_from_jax(jq, "cpu", torch.float32)
    np.testing.assert_allclose(
        t_tf.forward(T_CONFIG, bridged, _t(prompt)).numpy(),
        t_tf.forward(T_CONFIG, tq, _t(prompt)).numpy(), atol=1e-6)


# -- checkpoints and the workers ---------------------------------------------

J_BF16, T_BF16 = _configs((jnp.bfloat16, torch.bfloat16), max_seq=16)


def _batch(seed):
    toks = _tokens(seed, 2, 17)
    return toks[:, :-1], toks[:, 1:]


def _jax_state(steps):
    params = j_tf.init_params(J_BF16, jax.random.key(0))
    optimizer = optax.adamw(3e-4)
    state = optimizer.init(params)
    step = j_tf.make_train_step(J_BF16, optimizer, donate=False)
    for i in range(steps):
        params, state, _ = step(params, state, *_batch(i))
    return {"params": params, "opt_state": state}


def _port_state(steps):
    params = params_from_jax(j_tf.init_params(J_BF16, jax.random.key(0)),
                             "cpu", torch.bfloat16)
    optimizer = t_tf.adamw(params)
    step = t_tf.make_train_step(T_BF16, optimizer)
    for i in range(steps):
        step(params, *(_t(a) for a in _batch(i)))
    return params, optimizer


def _bits(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.kind in ("f", "V") else a


def _dtypes(leaves):
    return [str(np.asarray(a).dtype) for a in leaves]


def test_train_state_leaves_are_in_jax_order():
    """Sorted keys put ``router`` between ``mlp_norm`` and ``w_down`` in
    both packages; its AdamW moments are f32 as the router is."""
    j_leaves = jax.tree.leaves(_jax_state(0))
    params, optimizer = _port_state(1)
    state = t_tf.train_state(params, optimizer)
    t_leaves = tree_leaves(state)
    assert len(t_leaves) == len(j_leaves) == 1 + 3 * 10 + 3 * 2
    for t, j in zip(t_leaves, j_leaves):
        assert tuple(t.shape) == j.shape
    assert _dtypes(jax.tree.leaves(train_state_to_jax(params, optimizer))) \
        == _dtypes(j_leaves)
    (_, mu, nu), _, _ = state["opt_state"]
    assert mu["layers"]["router"].dtype == torch.float32
    assert nu["layers"]["router"].dtype == torch.float32
    assert mu["layers"]["w_gate"].dtype == torch.bfloat16


def test_jax_checkpoint_restores_into_the_port_bit_for_bit(tmp_path):
    j_state = _jax_state(2)
    j_ckpt.save_checkpoint(str(tmp_path), 2, j_state)
    params, optimizer = _port_state(0)
    state, step = t_ckpt.restore_checkpoint(
        str(tmp_path), t_tf.train_state(params, optimizer))
    assert step == 2
    t_tf.load_train_state(params, optimizer, state)
    assert params["layers"]["router"].dtype == torch.float32
    got = jax.tree.leaves(train_state_to_jax(params, optimizer))
    for want, have in zip(jax.tree.leaves(j_state), got):
        assert have.dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(_bits(have), _bits(want))


def test_port_checkpoint_restores_into_jax_bit_for_bit(tmp_path):
    params, optimizer = _port_state(2)
    t_ckpt.save_checkpoint(str(tmp_path), 2,
                           t_tf.train_state(params, optimizer))
    restored, step = j_ckpt.restore_checkpoint(str(tmp_path), _jax_state(0))
    assert step == 2
    assert restored["params"]["layers"]["router"].dtype == jnp.float32
    want = jax.tree.leaves(train_state_to_jax(params, optimizer))
    for have, w in zip(jax.tree.leaves(restored), want):
        assert np.asarray(have).dtype == w.dtype
        np.testing.assert_array_equal(_bits(have), _bits(w))


WORKER_ENV = {
    "TORCH_DEVICE": "cpu", "VOCAB": "64", "D_MODEL": "32", "N_LAYERS": "2",
    "N_HEADS": "4", "N_KV_HEADS": "2", "D_FF": "64", "SEQ_LEN": "16",
    "N_EXPERTS": "4", "KEEPALIVE_S": "0",
}


def test_workers_run_the_moe_config(tmp_path):
    """``N_EXPERTS=4``: the train worker trains, checkpoints and
    resumes to the uninterrupted run's params (the router f32 under the
    worker's bf16 config); the serve worker serves that checkpoint, and
    with ``WEIGHT_DTYPE=int8`` keeps the router f32."""
    env = dict(WORKER_ENV, TRAIN_STEPS="3", SANDBOX=str(tmp_path),
               TRAIN_ASYNC_CKPT="0")
    whole = train(dict(env, CHECKPOINT_DIR=str(tmp_path / "a")),
                  log=lambda m: None)
    assert whole.params["layers"]["router"].dtype == torch.float32
    assert whole.params["layers"]["w_gate"].shape == (2, 4, 32, 64)
    train(dict(env, TRAIN_STEPS="1", CHECKPOINT_DIR=str(tmp_path / "b")),
          log=lambda m: None)
    resumed = train(dict(env, CHECKPOINT_DIR=str(tmp_path / "b")),
                    log=lambda m: None)
    assert resumed.start == 1 and resumed.losses[2] == whole.losses[2]
    for a, b in zip(tree_leaves(whole.params), tree_leaves(resumed.params)):
        assert torch.equal(a, b)
    for weights in ("native", "int8"):
        logs = []
        served = build_server(
            dict(WORKER_ENV, PORT_HTTP="0", MAX_LEN="24", MAX_NEW_TOKENS="4",
                 SANDBOX=str(tmp_path), WEIGHT_DTYPE=weights,
                 CHECKPOINT_DIR=str(tmp_path / "a")),
            log=logs.append, ready_file="",
        )
        try:
            assert "restored checkpoint step 3" in logs
            router = served.pool.params["layers"]["router"]
            assert router.dtype == torch.float32
            assert torch.equal(router,
                               whole.params["layers"]["router"].float())
            reply = served.engine.submit([[1, 2, 3]], 4)
            assert len(reply[0]) == 4
        finally:
            served.server.server_close()
            served.engine.stop()

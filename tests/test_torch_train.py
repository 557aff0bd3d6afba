"""The port's train step (dcos_commons_tpu_torch/models/transformer.py
``loss_fn``, remat, ``make_train_step``, ``adamw``) against the JAX
package's ``make_train_step`` with ``optax.adamw(3e-4)``, on a tiny f32
config (2 layers, d_model 32, 4 heads, vocab 64, seq 16).  JAX weights
reach the port through ``params_from_jax``; token batches are numpy
from a seed.  Three steps each; the loss sequence and the final params
agree within 1e-5 (f32 on both sides, sums in another order; three
AdamW steps move a param by about 1e-3).  Beside a default case
(remat off, no accumulation, unchunked loss, MHA), one case per
option: remat "full", "save-attn", ``no_remat_layers=1``,
``grad_accum=2``, ``loss_chunk=8``, GQA with 2 KV heads.  Also here:
AdamW against optax alone, remat saving memory without changing a
value, the microbatch split, the steplog window and the token loader
against their JAX counterparts."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dcos_commons_tpu.data.loader import TokenDataset as JTokenDataset
from dcos_commons_tpu.data.loader import write_token_shard
from dcos_commons_tpu.models import transformer as j_tf
from dcos_commons_tpu.trace.steplog import InflightWindow as JWindow
from dcos_commons_tpu_torch.data import DevicePrefetcher, TokenDataset
from dcos_commons_tpu_torch.models import transformer as t_tf
from dcos_commons_tpu_torch.models.bridge import (
    params_from_jax,
    params_to_jax,
)
from dcos_commons_tpu_torch.parallel.pipeline import split_microbatches
from dcos_commons_tpu_torch.trace.steplog import InflightWindow
from dcos_commons_tpu_torch.utils import synthetic_tokens
from dcos_commons_tpu_torch.utils.tree import tree_leaves, tree_map

ATOL = 1e-5
BASE = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=4,
            d_ff=64, max_seq=16, remat=False)
CASES = {
    "default": ({}, 1),
    "remat-full": (dict(remat=True), 1),
    "remat-save-attn": (dict(remat=True, remat_policy="save-attn"), 1),
    "no-remat-layers-1": (dict(remat=True, no_remat_layers=1), 1),
    "grad-accum-2": ({}, 2),
    "loss-chunk-8": (dict(loss_chunk=8), 1),
    "gqa-2-kv-heads": (dict(n_kv_heads=2), 1),
}


def _configs(**fields):
    kw = dict(BASE, **fields)
    return (j_tf.TransformerConfig(**kw, dtype=jnp.float32),
            t_tf.TransformerConfig(**kw, dtype=torch.float32))


def _batches(steps, batch=4, seq=16, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 64, (steps, batch, seq + 1)).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("case", list(CASES))
def test_train_steps_match_jax(case):
    fields, grad_accum = CASES[case]
    j_config, t_config = _configs(**fields)
    j_params = j_tf.init_params(j_config, jax.random.key(0))
    t_params = params_from_jax(j_params, "cpu", torch.float32)
    optimizer = optax.adamw(3e-4)
    j_state = optimizer.init(j_params)
    j_step = j_tf.make_train_step(j_config, optimizer, donate=False,
                                  grad_accum=grad_accum)
    t_step = t_tf.make_train_step(t_config, t_tf.adamw(t_params),
                                  grad_accum=grad_accum)
    for toks in _batches(3):
        j_params, j_state, j_loss = j_step(j_params, j_state, toks[:, :-1],
                                           toks[:, 1:])
        t_loss = t_step(t_params, _t(toks[:, :-1]), _t(toks[:, 1:]))
        np.testing.assert_allclose(float(t_loss), float(j_loss), atol=ATOL,
                                   rtol=ATOL)
    for want, got in zip(jax.tree.leaves(j_params), tree_leaves(t_params)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=ATOL, rtol=ATOL)


def test_adamw_matches_optax():
    """Three updates of a two-leaf tree from the same gradients: torch
    decays p before the moment update, optax adds wd * p to the update
    — the same step, to f32 rounding."""
    rng = np.random.default_rng(3)
    tree = {"a": rng.standard_normal((5, 7)).astype(np.float32),
            "b": {"c": rng.standard_normal(11).astype(np.float32)}}
    grads = [jax.tree.map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), tree)
        for _ in range(3)]
    optimizer = optax.adamw(3e-4)
    j_params, j_state = tree, optimizer.init(tree)
    t_params = jax.tree.map(lambda x: torch.from_numpy(x.copy()), tree)
    t_opt = t_tf.adamw(t_params)
    group = t_opt.param_groups[0]
    assert (group["betas"], group["eps"], group["weight_decay"]) == (
        (0.9, 0.999), 1e-8, 1e-4)
    for g in grads:
        updates, j_state = optimizer.update(g, j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        for p, gi in zip(tree_leaves(t_params), jax.tree.leaves(g)):
            p.grad = torch.from_numpy(gi)
        t_opt.step()
    for want, got in zip(jax.tree.leaves(j_params), tree_leaves(t_params)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-6, rtol=1e-6)


def _saved_bytes_and_grads(config, params, toks):
    """Bytes autograd keeps for backward during the forward, and the
    loss and gradients."""
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    tree = tree_map(lambda p: p.detach().clone().requires_grad_(True),
                    params)
    leaves = tree_leaves(tree)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = t_tf.loss_fn(config, tree, _t(toks[:, :-1]), _t(toks[:, 1:]))
    grads = torch.autograd.grad(loss, leaves)
    return sum(saved), loss, grads


def test_remat_saves_memory_and_changes_no_value():
    j_config, _ = _configs(n_layers=3)
    t_params = params_from_jax(j_tf.init_params(j_config, jax.random.key(1)),
                               "cpu", torch.float32)
    toks = _batches(1, seed=5)[0]
    runs = {}
    for name, fields in (
        ("off", dict(remat=False)),
        ("full", dict(remat=True)),
        ("save-attn", dict(remat=True, remat_policy="save-attn")),
        ("no-remat-2", dict(remat=True, no_remat_layers=2)),
    ):
        _, config = _configs(n_layers=3, **fields)
        runs[name] = _saved_bytes_and_grads(config, t_params, toks)
    saved = {name: run[0] for name, run in runs.items()}
    assert saved["full"] < saved["save-attn"] < saved["off"], saved
    assert saved["full"] < saved["no-remat-2"] < saved["off"], saved
    for name, (_, loss, grads) in runs.items():
        assert torch.equal(loss, runs["off"][1]), name
        for g, want in zip(grads, runs["off"][2]):
            assert torch.equal(g, want), name


def test_chunked_loss_equals_unchunked():
    """loss_chunk 8 of seq 16 walks two checkpointed chunks; 5 (does
    not divide) and 16 (the whole sequence) compute unchunked, as the
    JAX rule says: all four give the mean NLL."""
    j_config, _ = _configs()
    params = params_from_jax(j_tf.init_params(j_config, jax.random.key(2)),
                             "cpu", torch.float32)
    toks = _batches(1, seed=6)[0]
    losses = []
    for chunk in (0, 8, 5, 16):
        _, config = _configs(loss_chunk=chunk)
        losses.append(float(t_tf.loss_fn(config, params, _t(toks[:, :-1]),
                                         _t(toks[:, 1:]))))
    np.testing.assert_allclose(losses, losses[0], atol=1e-6, rtol=1e-6)


def test_grad_accum_rejects_indivisible_batch():
    _, config = _configs()
    params = params_from_jax(
        j_tf.init_params(_configs()[0], jax.random.key(0)), "cpu",
        torch.float32)
    step = t_tf.make_train_step(config, t_tf.adamw(params), grad_accum=3)
    tokens = torch.zeros((4, 16), dtype=torch.int64)
    with pytest.raises(ValueError, match="not divisible"):
        step(params, tokens, tokens)
    assert split_microbatches(torch.arange(12).reshape(6, 2), 3).shape == (
        3, 2, 2)


def test_bridge_round_trips_params():
    j_params = j_tf.init_params(
        dataclasses.replace(_configs()[0], dtype=jnp.bfloat16),
        jax.random.key(4))
    back = params_to_jax(params_from_jax(j_params, "cpu", torch.bfloat16))
    for want, got in zip(jax.tree.leaves(j_params), jax.tree.leaves(back)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(np.asarray(got, np.float32),
                                      np.asarray(want, np.float32))


def test_synthetic_tokens_are_next_token_pairs():
    gen = torch.Generator().manual_seed(1)
    tokens, targets = synthetic_tokens(3, 10, 50, gen)
    assert tokens.shape == targets.shape == (3, 10)
    assert tokens.dtype == torch.int64
    assert torch.equal(tokens[:, 1:], targets[:, :-1])
    assert int(tokens.max()) < 50 and int(tokens.min()) >= 0


def test_inflight_window_drains_like_jax():
    """The same pushes through both windows, with an immediate ready
    function: the same steps drain at the same pushes, and each step
    is billed once."""
    class Recorder:
        def __init__(self):
            self.steps = []

        def record(self, step, **fields):
            self.steps.append(step)

    out = []
    for window_cls in (JWindow, InflightWindow):
        rec = Recorder()
        window = window_cls(rec, 2, ready_fn=lambda r: r)
        drained = [[s for s, _ in window.push(i, i * 10, 0.0)]
                   for i in range(5)]
        drained.append([s for s, _ in window.drain()])
        out.append((drained, rec.steps))
    assert out[0] == out[1]
    assert out[1][1] == list(range(5))


def test_inflight_window_passes_cpu_results_through():
    """Off the card the default mark and ready functions hand the
    result back as it is."""
    class Recorder:
        def record(self, step, **fields):
            pass

    window = InflightWindow(Recorder(), 0)
    loss = torch.tensor(2.5)
    ((step, ready),) = window.push(7, loss, 0.0)
    assert step == 7 and ready is loss


def test_token_dataset_and_prefetcher_match_jax(tmp_path):
    rng = np.random.default_rng(7)
    for i in range(3):
        write_token_shard(str(tmp_path / f"s{i}.tokens"),
                          rng.integers(0, 100, 500))
    want = JTokenDataset(str(tmp_path), 16, seed=3).batches(4, start_step=5)
    got = DevicePrefetcher(
        TokenDataset(str(tmp_path), 16, seed=3).batches(4, start_step=5),
        "cpu",
    )
    try:
        for _ in range(4):
            (wt, wy), (gt, gy) = next(want), next(got)
            assert gt.dtype == torch.int64 and gt.device.type == "cpu"
            np.testing.assert_array_equal(gt.numpy(), wt)
            np.testing.assert_array_equal(gy.numpy(), wy)
    finally:
        got.close()

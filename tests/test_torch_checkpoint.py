"""The port's checkpoints (dcos_commons_tpu_torch/utils/checkpoint.py)
against the JAX package's: a train state written by either package
restores into the other bit for bit (bf16 params, both AdamW moments,
the step count), the incarnation fencing of the JAX module's own tests,
and the port's workers on the CPU — the train worker writes checkpoints
and resumes from them to the same params as an uninterrupted run, and
the serve worker serves the params of a train checkpoint.  Tiny bf16
config (2 layers, d_model 32, 4 heads over 2 KV heads, vocab 64)."""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dcos_commons_tpu.models import transformer as j_tf
from dcos_commons_tpu.utils import checkpoint as j_ckpt
from dcos_commons_tpu_torch.frameworks.serve_worker import build_server
from dcos_commons_tpu_torch.frameworks.train_worker import train
from dcos_commons_tpu_torch.models import transformer as t_tf
from dcos_commons_tpu_torch.models.bridge import (
    params_from_jax,
    train_state_to_jax,
)
from dcos_commons_tpu_torch.utils import checkpoint as t_ckpt
from dcos_commons_tpu_torch.utils.tree import tree_leaves

KW = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
          d_ff=64, max_seq=16, remat=False)
J_CONFIG = j_tf.TransformerConfig(**KW, dtype=jnp.bfloat16)
T_CONFIG = t_tf.TransformerConfig(**KW, dtype=torch.bfloat16)
WORKER_ENV = {
    "TORCH_DEVICE": "cpu", "VOCAB": "64", "D_MODEL": "32", "N_LAYERS": "2",
    "N_HEADS": "4", "N_KV_HEADS": "2", "D_FF": "64", "SEQ_LEN": "16",
    "KEEPALIVE_S": "0",
}


def _batch(seed):
    toks = np.random.default_rng(seed).integers(0, 64, (2, 17))
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


def _bits(a):
    """A leaf's exact value: bf16 widens to f32 exactly."""
    return np.asarray(a).astype(np.float32) if np.asarray(a).dtype.kind in (
        "f", "V") else np.asarray(a)


def _jax_state(steps):
    params = j_tf.init_params(J_CONFIG, jax.random.key(0))
    optimizer = optax.adamw(3e-4)
    state = optimizer.init(params)
    step = j_tf.make_train_step(J_CONFIG, optimizer, donate=False)
    for i in range(steps):
        params, state, _ = step(params, state, *_batch(i))
    return {"params": params, "opt_state": state}


def _port_state(steps):
    params = params_from_jax(j_tf.init_params(J_CONFIG, jax.random.key(0)),
                             "cpu", torch.bfloat16)
    optimizer = t_tf.adamw(params)
    step = t_tf.make_train_step(T_CONFIG, optimizer)
    for i in range(steps):
        step(params, *(torch.from_numpy(a).long() for a in _batch(i)))
    return params, optimizer


def test_train_state_leaves_are_in_jax_order():
    """leaf i of the port's train state is leaf i of the JAX worker's
    (optax count, mu, nu, then params, as sorted keys put them)."""
    j_state = _jax_state(0)
    params, optimizer = _port_state(0)
    t_leaves = tree_leaves(t_tf.train_state(params, optimizer))
    j_leaves = jax.tree.leaves(j_state)
    assert len(t_leaves) == len(j_leaves) == 1 + 3 * 9 + 3 * 2
    for t, j in zip(t_leaves, j_leaves):
        assert tuple(t.shape) == j.shape
    assert t_leaves[0].dtype == torch.int32 and j_leaves[0].dtype == jnp.int32


def test_jax_checkpoint_restores_into_the_port_bit_for_bit(tmp_path):
    j_state = _jax_state(2)
    j_ckpt.save_checkpoint(str(tmp_path), 2, j_state)
    params, optimizer = _port_state(0)
    state, step = t_ckpt.restore_checkpoint(
        str(tmp_path), t_tf.train_state(params, optimizer))
    assert step == 2
    t_tf.load_train_state(params, optimizer, state)
    got = jax.tree.leaves(train_state_to_jax(params, optimizer))
    for want, have in zip(jax.tree.leaves(j_state), got):
        assert have.dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(_bits(have), _bits(want))
    assert all(float(s["step"]) == 2.0 for s in optimizer.state.values())


def test_port_checkpoint_restores_into_jax_bit_for_bit(tmp_path):
    params, optimizer = _port_state(2)
    t_ckpt.save_checkpoint(str(tmp_path), 2,
                           t_tf.train_state(params, optimizer))
    like = _jax_state(0)
    restored, step = j_ckpt.restore_checkpoint(str(tmp_path), like)
    assert step == 2
    want = jax.tree.leaves(train_state_to_jax(params, optimizer))
    for have, w in zip(jax.tree.leaves(restored), want):
        np.testing.assert_array_equal(_bits(have), _bits(w))
    assert int(restored["opt_state"][0].count) == 2


def test_restored_port_state_trains_on_like_jax(tmp_path):
    """A JAX train state carried into the port takes one more step to
    the params JAX's next step gives (f32 rounding apart: bf16 is the
    storage type, the update math differs in order)."""
    j_state = _jax_state(2)
    j_ckpt.save_checkpoint(str(tmp_path), 2, j_state)
    params, optimizer = _port_state(0)
    state, _ = t_ckpt.restore_checkpoint(
        str(tmp_path), t_tf.train_state(params, optimizer))
    t_tf.load_train_state(params, optimizer, state)
    t_tf.make_train_step(T_CONFIG, optimizer)(
        params, *(torch.from_numpy(a).long() for a in _batch(2)))
    step = j_tf.make_train_step(J_CONFIG, optax.adamw(3e-4), donate=False)
    j_params, _, _ = step(j_state["params"], j_state["opt_state"],
                          *_batch(2))
    for want, have in zip(jax.tree.leaves(j_params), tree_leaves(params)):
        # within one bf16 ulp (2^-7 relative at most): the two
        # updates may round to neighbouring bf16 values
        np.testing.assert_allclose(have.detach().float().numpy(),
                                   _bits(want), atol=2 ** -16, rtol=2 ** -7)


def test_restore_refuses_a_mismatched_template(tmp_path):
    tree = {"w": torch.ones(2, 2)}
    t_ckpt.save_checkpoint(str(tmp_path), 1, tree)
    with pytest.raises(ValueError, match="shape"):
        t_ckpt.restore_checkpoint(str(tmp_path), {"w": torch.ones(3)})
    with pytest.raises(ValueError, match="leaves"):
        t_ckpt.restore_checkpoint(str(tmp_path),
                                  {"w": torch.ones(2, 2), "x": torch.ones(1)})


def test_async_checkpointer_snapshot_isolated_from_in_place_update(tmp_path):
    """save() must capture the state AT SAVE TIME although the loop
    keeps training (updating those tensors in place) while the writer
    drains: the snapshot is a device-side clone, not a reference."""
    params, optimizer = _port_state(0)
    step_fn = t_tf.make_train_step(T_CONFIG, optimizer)
    checkpointer = t_ckpt.AsyncCheckpointer(str(tmp_path), keep=0)
    saved_at = {}
    for i in range(4):
        step_fn(params, *(torch.from_numpy(a).long() for a in _batch(i)))
        if i in (1, 3):
            checkpointer.save(i + 1, t_tf.train_state(params, optimizer))
            saved_at[i + 1] = [p.detach().clone()
                               for p in tree_leaves(params)]
    assert checkpointer.close() == []
    for step in (2, 4):
        fresh, opt = _port_state(0)
        restored, got = t_ckpt.restore_checkpoint(
            str(tmp_path), t_tf.train_state(fresh, opt), step=step)
        assert got == step
        for want, have in zip(saved_at[step],
                              tree_leaves(restored["params"])):
            assert torch.equal(want, have)


def test_zombie_writer_cannot_destroy_newer_frontier(tmp_path):
    """Recovery relaunches a trainer (new incarnation) while the
    superseded one still has a save in flight: the zombie's save must
    refuse, and the live writer's newer checkpoint survives."""
    d = str(tmp_path)
    tree = {"w": torch.ones(2, 2)}
    zombie_inc = t_ckpt.claim_incarnation(d)
    live_inc = t_ckpt.claim_incarnation(d)
    assert live_inc > zombie_inc
    live_path = t_ckpt.save_checkpoint(d, 120, tree, keep=3,
                                       incarnation=live_inc)
    with pytest.raises(t_ckpt.StaleWriterError):
        t_ckpt.save_checkpoint(d, 100, tree, keep=3, incarnation=zombie_inc)
    assert os.path.exists(live_path)
    _, step = t_ckpt.restore_checkpoint(d, tree)
    assert step == 120

    checkpointer = t_ckpt.AsyncCheckpointer(d, keep=3,
                                            incarnation=zombie_inc)
    checkpointer.save(101, tree)
    errors = checkpointer.wait()
    assert errors and "superseded" in errors[0]
    assert checkpointer.fenced is True
    checkpointer.save(102, tree)  # dropped, not raised
    assert checkpointer.close() == errors
    assert os.path.exists(live_path)
    _, step = t_ckpt.restore_checkpoint(d, tree)
    assert step == 120


def test_fenced_prune_scopes_to_own_incarnation(tmp_path):
    d = str(tmp_path)
    tree = {"w": torch.ones(2, 2)}
    t_ckpt.save_checkpoint(d, 5, tree)  # legacy, incarnation 0
    inc = t_ckpt.claim_incarnation(d)
    t_ckpt.save_checkpoint(d, 7, tree, keep=2, incarnation=inc)
    t_ckpt.save_checkpoint(d, 9, tree, keep=2, incarnation=inc)
    names = sorted(n for n in os.listdir(d) if n.startswith("step_"))
    assert names == [
        "step_0000000007.inc_%010d.npz" % inc,
        "step_0000000009.inc_%010d.npz" % inc,
    ]
    t_ckpt.save_checkpoint(d, 3, tree, keep=1, incarnation=inc)
    _, step = t_ckpt.restore_checkpoint(d, tree)
    assert step == 3


def test_claim_incarnation_is_race_free(tmp_path):
    d = str(tmp_path)
    claimed = []
    lock = threading.Lock()

    def claim():
        inc = t_ckpt.claim_incarnation(d)
        with lock:
            claimed.append(inc)

    threads = [threading.Thread(target=claim) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(set(claimed)) == 8


def test_restore_prefers_newest_incarnation_at_same_step(tmp_path):
    d = str(tmp_path)
    old = {"w": torch.ones(2, 2)}
    new = {"w": torch.full((2, 2), 7.0)}
    t_ckpt.save_checkpoint(d, 10, old, incarnation=1)
    t_ckpt.save_checkpoint(d, 10, new, incarnation=2)
    restored, step = t_ckpt.restore_checkpoint(d, old)
    assert step == 10
    assert torch.equal(restored["w"], new["w"])
    assert t_ckpt.latest_step(d) == 10


def test_worker_checkpoints_and_resumes_to_the_same_params(tmp_path):
    env = dict(WORKER_ENV, TRAIN_STEPS="4", SANDBOX=str(tmp_path))
    whole = train(dict(env, CHECKPOINT_DIR=str(tmp_path / "a")),
                  log=lambda m: None)
    assert whole.start == 0 and sorted(whole.losses) == [0, 3]
    assert all(np.isfinite(v) for v in whole.losses.values())
    names = sorted(os.listdir(tmp_path / "a"))
    assert [n for n in names if n.startswith("step_")] == [
        "step_0000000001.inc_0000000001.npz",
        "step_0000000004.inc_0000000001.npz",
    ]
    first = train(dict(env, TRAIN_STEPS="2", TRAIN_ASYNC_CKPT="0",
                       CHECKPOINT_DIR=str(tmp_path / "b")),
                  log=lambda m: None)
    assert first.start == 0
    resumed = train(dict(env, CHECKPOINT_DIR=str(tmp_path / "b")),
                    log=lambda m: None)
    assert resumed.start == 2
    assert resumed.losses[3] == whole.losses[3]
    for a, b in zip(tree_leaves(whole.params), tree_leaves(resumed.params)):
        assert torch.equal(a, b)
    # the resume claimed a new writer incarnation
    incs = {n.split(".inc_")[1] for n in os.listdir(tmp_path / "b")
            if ".inc_" in n}
    assert len(incs) == 2


def test_worker_stored_layers_change_no_value(tmp_path):
    """``no_remat_layers`` (bench.py's flagship stores one layer) moves
    only memory: the same steps give the same losses and params."""
    env = dict(WORKER_ENV, TRAIN_STEPS="2", TRAIN_ASYNC_CKPT="0",
               SANDBOX=str(tmp_path))
    runs = [train(dict(env, CHECKPOINT_DIR=str(tmp_path / str(k))),
                  log=lambda m: None, no_remat_layers=k) for k in (0, 1)]
    assert runs[0].losses == runs[1].losses
    for a, b in zip(tree_leaves(runs[0].params),
                    tree_leaves(runs[1].params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("gang", [{"TPU_WORKER_COUNT": "2"},
                                  {"TPU_NUM_SLICES": "2",
                                   "TPU_WORKER_COUNT": "2"}])
def test_worker_refuses_a_gang(tmp_path, gang):
    """A gang contract without a ``COORDINATOR_ADDRESS`` has nowhere to
    meet: the worker refuses it rather than train alone.  (A gang that
    can meet trains: tests/test_torch_mesh.py.)"""
    env = dict(WORKER_ENV, TRAIN_STEPS="1",
               CHECKPOINT_DIR=str(tmp_path), **gang)
    with pytest.raises(ValueError, match="no COORDINATOR_ADDRESS"):
        train(env, log=lambda m: None)


def test_serve_worker_serves_the_trained_params(tmp_path):
    """The serve worker reads the params of a train checkpoint at
    their true offsets (the optimizer state's leaves come first)."""
    trained = train(dict(WORKER_ENV, TRAIN_STEPS="2", SANDBOX=str(tmp_path),
                         CHECKPOINT_DIR=str(tmp_path / "ckpt")),
                    log=lambda m: None)
    logs = []
    served = build_server(
        dict(WORKER_ENV, PORT_HTTP="0", MAX_LEN="24", MAX_NEW_TOKENS="4",
             SANDBOX=str(tmp_path), CHECKPOINT_DIR=str(tmp_path / "ckpt")),
        log=logs.append, ready_file="",
    )
    try:
        assert "restored checkpoint step 2" in logs
        for want, have in zip(tree_leaves(trained.params),
                              tree_leaves(served.pool.params)):
            assert have.dtype == torch.float32
            assert torch.equal(have, want.float())
    finally:
        served.server.server_close()
        served.engine.stop()

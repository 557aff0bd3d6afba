"""The port's mesh (dcos_commons_tpu_torch/parallel/mesh.py), its layout
rules, and the gang train worker, against the JAX package.

- ``derive``, ``elastic_reshard_ok`` and the spec of ``mesh_from_env``
  equal the reference's on one grid of env contracts and device counts,
  ``SpecError`` cases included (same message); the ranks of each
  process group are the devices the reference's mesh puts on that axis.
- ``sharding_rules`` (dense and MoE), ``moe_sharding_rules`` and
  ``expert_shard_spec`` equal the reference's ``PartitionSpec``s entry
  by entry, and every rank's block of a tensor tiles it.
- The ``TPU_TOPOLOGY`` guard on one CPU device: a 4-chip host contract
  refuses one device as the reference's ``derive`` does; a declared
  2x2 topology without a host size raises the mesh mismatch, and with
  ``TRAIN_ELASTIC_DP=1`` trains at batch 2 and logs the elastic resume.
- The gang worker as 2 CPU ranks (gloo, a file store of its own, a
  join deadline and a process-group timeout): 2 steps, a checkpoint
  and a resume to 4 equal 4 steps in one go bit for bit; the result
  matches one device's ``make_train_step`` at the same global batch
  and tokens within bf16 rounding (``_gang_misfits``: the loss at each
  logged step within 1e-3 relative, AdamW's moments within 3e-2
  relative a leaf, each param's movement from the init within a fifth
  of its size), a check that refuses planted faults (ranks on the same
  rows, no gradient mean, no update); the gang's checkpoint
  restores bit for bit in the single-device port and in the JAX
  package; two workers that disagree on the resume step refuse to
  train.
"""

import json
import multiprocessing
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dcos_commons_tpu.models import moe as j_moe
from dcos_commons_tpu.models import transformer as j_tf
from dcos_commons_tpu.parallel import mesh as j_mesh
from dcos_commons_tpu.specification.specs import SpecError as JSpecError
from dcos_commons_tpu.utils import checkpoint as j_ckpt
from dcos_commons_tpu_torch.frameworks import train_worker
from dcos_commons_tpu_torch.frameworks.train_worker import train, train_gang
from dcos_commons_tpu_torch.models import moe as t_moe
from dcos_commons_tpu_torch.models import transformer as t_tf
from dcos_commons_tpu_torch.parallel import mesh as t_mesh
from dcos_commons_tpu_torch.parallel import sharding
from dcos_commons_tpu_torch.utils import checkpoint as t_ckpt
from dcos_commons_tpu_torch.utils import synthetic_tokens
from dcos_commons_tpu_torch.utils.tree import tree_leaves

ENVS = {
    "empty": {},
    "host-4": {"TPU_CHIPS_PER_HOST": "4"},
    "host-4-topo-2x2": {"TPU_CHIPS_PER_HOST": "4", "TPU_TOPOLOGY": "2x2"},
    "host-4-topo-4x4": {"TPU_CHIPS_PER_HOST": "4", "TPU_TOPOLOGY": "4x4"},
    "host-2-topo-2x2": {"TPU_CHIPS_PER_HOST": "2", "TPU_TOPOLOGY": "2x2"},
    "host-3-topo-2x2": {"TPU_CHIPS_PER_HOST": "3", "TPU_TOPOLOGY": "2x2"},
    "topo-2x2": {"TPU_TOPOLOGY": "2x2"},
    "topo-bad": {"TPU_TOPOLOGY": "2xq"},
    "topo-zero": {"TPU_TOPOLOGY": "0x2"},
    "slices-2-host-2": {"TPU_NUM_SLICES": "2", "TPU_CHIPS_PER_HOST": "2"},
    "slices-2-host-4-topo-2x2": {"TPU_NUM_SLICES": "2",
                                 "TPU_CHIPS_PER_HOST": "4",
                                 "TPU_TOPOLOGY": "2x2"},
    "slices-2-host-3-topo-2x3": {"TPU_NUM_SLICES": "2",
                                 "TPU_CHIPS_PER_HOST": "3",
                                 "TPU_TOPOLOGY": "2x3"},
}
DEVICE_COUNTS = (None, 1, 2, 3, 4, 8, 16)


def _derive_both(env, n):
    out = []
    for derive, error in ((j_mesh.derive, JSpecError),
                          (t_mesh.derive, t_mesh.SpecError)):
        try:
            out.append(("spec", derive(env, n).axes()))
        except error as e:
            out.append(("SpecError", str(e)))
    return out


@pytest.mark.parametrize("name", list(ENVS))
def test_derive_matches_the_reference(name):
    for n in DEVICE_COUNTS:
        want, got = _derive_both(ENVS[name], n)
        assert got == want, (name, n)


def test_elastic_reshard_ok_matches_the_reference():
    fields = ("dp", "fsdp", "tp", "sp", "pp", "ep", "dcn")
    rng = np.random.default_rng(0)
    pairs = [({}, {"dp": 4}), ({"dcn": 2}, {"dcn": 1, "dp": 2}),
             ({"tp": 4}, {"tp": 2}), ({"fsdp": 2}, {"dp": 2})]
    pairs += [tuple({f: int(v) for f, v in zip(fields, rng.integers(1, 3, 7))}
                    for _ in range(2)) for _ in range(40)]
    for old, new in pairs:
        assert t_mesh.elastic_reshard_ok(
            t_mesh.MeshSpec(**old), t_mesh.MeshSpec(**new)
        ) == j_mesh.elastic_reshard_ok(j_mesh.MeshSpec(**old),
                                       j_mesh.MeshSpec(**new)), (old, new)


def test_mesh_from_env_on_one_rank():
    """A world of one (no process group) builds its mesh and groups of
    nobody; a contract one rank cannot hold raises as ``derive`` does."""
    mesh = t_mesh.mesh_from_env({"TPU_CHIPS_PER_HOST": "1"})
    assert mesh.spec == t_mesh.MeshSpec() and mesh.rank == 0
    assert mesh.groups == {} and mesh.group(t_mesh.BATCH_AXES) is None
    with pytest.raises(ValueError, match="needs 4 ranks"):
        t_mesh.make_mesh(t_mesh.MeshSpec(dp=2, tp=2))
    with pytest.raises(t_mesh.SpecError, match="does not divide"):
        t_mesh.mesh_from_env(ENVS["host-4-topo-2x2"])


SPECS = [dict(dp=2), dict(tp=2), dict(dp=2, tp=2), dict(dcn=2, dp=2, tp=2),
         dict(dp=1, fsdp=2, tp=2), dict(ep=2, dp=2), dict(ep=2, tp=2, fsdp=2)]


@pytest.mark.parametrize("fields", SPECS, ids=lambda f: "x".join(
    f"{k}{v}" for k, v in f.items()))
def test_ranks_follow_the_reference_device_order(fields):
    """Rank r's coordinate is device r's place in the reference's mesh,
    and each process group holds the devices that mesh lines up on its
    axes (for a tuple of axes, first axis major)."""
    spec = t_mesh.MeshSpec(**fields)
    n = spec.total
    ids = np.vectorize(lambda d: d.id)(
        j_mesh.make_mesh(j_mesh.MeshSpec(**fields), jax.devices()[:n]).devices)
    for rank in range(n):
        where = [int(i[0]) for i in np.nonzero(ids == rank)]
        assert [t_mesh.Mesh(spec, rank).coords[a]
                for a in t_mesh.AXES] == where
    for axes in t_mesh.GROUP_AXES:
        moved = [t_mesh.AXES.index(a) for a in axes]
        rest = [i for i in range(len(t_mesh.AXES)) if i not in moved]
        want = ids.transpose(rest + moved).reshape(
            -1, int(np.prod([ids.shape[i] for i in moved]))).tolist()
        assert t_mesh.group_ranks(spec, axes) == want, axes


def _rules_of(specs):
    return {path: sharding.P(*tuple(spec)) for path, spec in specs.items()}


@pytest.mark.parametrize("n_experts", [0, 4], ids=["dense", "moe"])
def test_sharding_rules_match_the_reference(n_experts):
    kw = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_ff=64,
              n_experts=n_experts)
    want = _rules_of(j_tf.sharding_rules(j_tf.TransformerConfig(**kw)))
    t_config = t_tf.TransformerConfig(**kw)
    assert t_tf.sharding_rules(t_config) == want
    # the tree of rules lays out like the param tree, leaf for leaf
    params = t_tf.init_params(t_config, device="cpu")
    rules = t_tf.leaf_rules(t_config)
    assert len(rules) == len(tree_leaves(params))
    for p, dims in zip(tree_leaves(params), rules):
        assert len(dims) == p.dim()
    j_shard = j_tf.param_shardings(
        j_tf.TransformerConfig(**kw),
        j_mesh.make_mesh(j_mesh.MeshSpec(), jax.devices()[:1]))
    assert [sharding.P(*tuple(s.spec)) for s in jax.tree.leaves(j_shard)] \
        == rules
    tree = t_tf.param_shardings(t_config)
    assert set(tree) == set(j_shard) and set(tree["layers"]) == set(
        j_shard["layers"])
    for name in ("embed", "final_norm"):
        assert tree[name] == sharding.P(*tuple(j_shard[name].spec))
    for name, spec in j_shard["layers"].items():
        assert tree["layers"][name] == sharding.P(*tuple(spec.spec))


def test_moe_rules_match_the_reference():
    assert _rules_of(j_moe.expert_shard_spec()) == t_moe.expert_shard_spec()
    for prefix, stacked in (("", False), ("layers/", True)):
        assert _rules_of(j_moe.moe_sharding_rules(prefix, stacked)) == \
            t_moe.moe_sharding_rules(prefix, stacked)


@pytest.mark.parametrize("fields", SPECS, ids=lambda f: "x".join(
    f"{k}{v}" for k, v in f.items()))
def test_blocks_tile_the_tensor(fields):
    """Every rank's block of each param, put back where its rule says,
    rebuilds the full tensor exactly once."""
    spec = t_mesh.MeshSpec(**fields)
    config = t_tf.TransformerConfig(vocab=64, d_model=32, n_layers=2,
                                    n_heads=4, d_ff=64, n_experts=4,
                                    dtype=torch.float32)
    params = t_tf.init_params(config, device="cpu")
    for full, dims in zip(tree_leaves(params), t_tf.leaf_rules(config)):
        seen = torch.zeros_like(full)
        for rank in range(spec.total):
            mesh = t_mesh.Mesh(spec, rank)
            where = sharding.block_slices(full.shape, dims, mesh)
            assert torch.equal(sharding.shard(full, dims, mesh), full[where])
            seen[where] += 1
        copies = spec.total // int(np.prod(
            [t_mesh.Mesh(spec).size(a) for a in dims]))
        assert bool((seen == copies).all())


# -- the gang worker ------------------------------------------------------------

WORKER_ENV = {
    "TORCH_DEVICE": "cpu", "VOCAB": "64", "D_MODEL": "32", "N_LAYERS": "2",
    "N_HEADS": "4", "N_KV_HEADS": "2", "D_FF": "64", "SEQ_LEN": "16",
    "KEEPALIVE_S": "0", "TRAIN_INFLIGHT_STEPS": "0",
}
LR, STEPS = 3e-4, 4
GANG_DEADLINE_S = 240


@pytest.mark.parametrize("elastic", ["0", "1"])
def test_one_device_refuses_a_four_chip_host(tmp_path, elastic):
    """A 2x2 topology of 4-chip hosts on one device: the reference's
    ``mesh_from_env`` raises in ``derive`` before its elastic guard, and
    so does the port, with or without ``TRAIN_ELASTIC_DP``."""
    env = dict(WORKER_ENV, **ENVS["host-4-topo-2x2"], TRAIN_STEPS="1",
               TRAIN_ELASTIC_DP=elastic, CHECKPOINT_DIR=str(tmp_path))
    with pytest.raises(JSpecError) as want:
        j_mesh.derive(env, 1)
    with pytest.raises(t_mesh.SpecError) as got:
        train(env, log=lambda m: None)
    assert str(got.value) == str(want.value)


def test_topology_guard_refuses_a_mesh_mismatch(tmp_path):
    env = dict(WORKER_ENV, **ENVS["topo-2x2"], TRAIN_STEPS="1",
               CHECKPOINT_DIR=str(tmp_path))
    with pytest.raises(RuntimeError, match="mesh mismatch"):
        train(env, log=lambda m: None)


def test_elastic_dp_trains_at_batch_2(tmp_path):
    logs = []
    result = train(dict(WORKER_ENV, **ENVS["topo-2x2"], TRAIN_STEPS="1",
                        TRAIN_ELASTIC_DP="1", SANDBOX=str(tmp_path),
                        CHECKPOINT_DIR=str(tmp_path / "ckpt")),
                   log=logs.append)
    assert result.batch == 2
    assert any(m.startswith("elastic-dp resume: 4 -> 1 chips (dp 4->1")
               for m in logs), logs


def _load(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _checkpoint(directory, step):
    names = [n for n in os.listdir(directory)
             if n.startswith(f"step_{step:010d}")]
    assert len(names) == 1, os.listdir(directory)
    return os.path.join(directory, names[0])


@pytest.fixture(scope="module")
def gang_runs(tmp_path_factory):
    """A 2-rank gang: 4 steps in one go (``whole``), and 2 steps then a
    resume to 4 (``resumed``); each with its own checkpoint directory."""
    root = tmp_path_factory.mktemp("gang")
    env = dict(WORKER_ENV, SANDBOX=str(root))
    runs = {}
    for name, stops in (("whole", (STEPS,)), ("resumed", (2, STEPS))):
        ckpt = str(root / name)
        runs[name] = [train_gang(
            dict(env, TRAIN_STEPS=str(stop), CHECKPOINT_DIR=ckpt),
            local_devices=2, log=lambda m: None, timeout_s=60,
            deadline_s=GANG_DEADLINE_S) for stop in stops]
    return root, runs


def test_gang_resume_equals_the_uninterrupted_run(gang_runs):
    root, runs = gang_runs
    (whole,), (first, resumed) = runs["whole"], runs["resumed"]
    assert whole.batch == 4 and (whole.start, first.start) == (0, 0)
    assert resumed.start == 2 and resumed.losses[3] == whole.losses[3]
    a = _load(_checkpoint(root / "whole", STEPS))
    b = _load(_checkpoint(root / "resumed", STEPS))
    leaves = [k for k in a if k.startswith("leaf_")]
    assert leaves and all(np.array_equal(a[k], b[k]) for k in leaves)
    # the barrier probe timed every step of both ranks
    with open(root / "steplog.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert len(records) == 2 * (STEPS + 2 + 2)
    assert all("blocked_s" in r for r in records)


def _one_device_run(rows=slice(0, 4), update=True):
    """One device's make_train_step at the gang's global batch (4) and
    tokens (the fixed batch from seed 1): (losses by step, the train
    state's params, mu and nu leaves, and the init's leaves).  ``rows``
    and ``update`` plant a gang's faults: the steps a gang whose ranks
    all read rows 0-1 takes (a gang that skips the gradient mean steps
    its params the same way: AdamW ignores the gradient's scale), and a
    gang that never applies its update."""
    config = t_tf.config_from_env(WORKER_ENV, dtype=torch.bfloat16)
    params = t_tf.init_params(config, seed=0, device="cpu")
    init = [p.detach().clone() for p in tree_leaves(params)]
    optimizer = t_tf.adamw(params, LR)
    step = t_tf.make_train_step(config, optimizer)
    tokens, targets = synthetic_tokens(
        4, config.max_seq, config.vocab,
        torch.Generator(device="cpu").manual_seed(1))
    losses = {}
    for s in range(STEPS):
        if update:
            losses[s] = float(step(params, tokens[rows], targets[rows]))
        else:
            losses[s] = float(t_tf.loss_fn(config, params, tokens,
                                           targets).detach())
    return losses, _state_leaves(t_tf.train_state(params, optimizer)), init


def _state_leaves(state):
    (count, mu, nu), _, _ = state["opt_state"]
    return {"count": int(count), "params": tree_leaves(state["params"]),
            "mu": tree_leaves(mu), "nu": tree_leaves(nu)}


def _gang_misfits(losses, state, one):
    """Where a gang's losses (by step) and train state stand apart from
    one device's run ``one`` by more than bf16 rounding allows.

    A gang rank's gradient is the bf16 mean over its own rows, and the
    all-reduce adds the ranks' bf16 means, where one device rounds the
    whole batch's once: a few bf16 ulps (2^-8 relative) an element.  So
    AdamW's moments stay within 3e-2 relative Frobenius a leaf (1e-2 at
    most on the CPU), each param's movement from the init, about lr a
    step, within a fifth of its size (5e-2 at most), and the loss
    within 1e-3 relative at each step (2e-5).  A gang whose ranks read
    the same rows, skip the gradient mean or never update lands a
    relative 0.29 or more apart on the moments and 0.66 or more on the
    movement."""
    want_losses, want, init = one
    misfits = [f"loss at step {s}: {v} vs {want_losses[s]}"
               for s, v in losses.items()
               if abs(v - want_losses[s]) > 1e-3 * abs(want_losses[s])]
    if state["count"] != want["count"]:
        misfits.append(f"count {state['count']} vs {want['count']}")
    for name in ("mu", "nu"):
        for i, (a, b) in enumerate(zip(state[name], want[name])):
            a, b = a.detach().float(), b.detach().float()
            if (a - b).norm() > 3e-2 * b.norm():
                misfits.append(f"{name} leaf {i}: relative "
                               f"{float((a - b).norm() / b.norm()):.3e}")
    for i, (a, b, p0) in enumerate(zip(state["params"], want["params"],
                                       init)):
        a, b, p0 = a.detach().float(), b.detach().float(), p0.float()
        moved = (b - p0).norm()
        if (a - b).norm() > 0.2 * moved:
            misfits.append(f"param leaf {i}: apart "
                           f"{float((a - b).norm()):.3e}, moved "
                           f"{float(moved):.3e}")
    return misfits


def test_gang_matches_one_device_at_the_same_batch(gang_runs):
    root, runs = gang_runs
    (whole,), (first, _) = runs["whole"], runs["resumed"]
    losses = {**whole.losses, **first.losses}
    assert sorted(losses) == [0, 1, STEPS - 1]
    config = t_tf.config_from_env(WORKER_ENV, dtype=torch.bfloat16)
    params = t_tf.init_params(config, seed=0, device="cpu")
    state, step = t_ckpt.restore_checkpoint(
        str(root / "whole"), t_tf.train_state(params, t_tf.adamw(params)))
    assert step == STEPS
    assert _gang_misfits(losses, _state_leaves(state),
                         _one_device_run()) == []


@pytest.mark.parametrize("fault", ["same rows", "no update"])
def test_gang_check_catches_a_planted_fault(fault):
    """The comparison above refuses what a faulty gang would save: the
    run of a gang whose ranks all train on rows 0-1 (or skip the
    gradient mean), or that never updates, against the right run."""
    one = _one_device_run()
    losses, state, _ = (_one_device_run(rows=slice(0, 2))
                        if fault == "same rows"
                        else _one_device_run(update=False))
    misfits = _gang_misfits(losses, state, one)
    kinds = {m.split(" ")[0] for m in misfits}
    assert {"mu", "nu", "param"} <= kinds, misfits


def test_gang_checkpoint_restores_bit_for_bit_in_both_packages(gang_runs):
    root, _ = gang_runs
    path = _checkpoint(root / "whole", STEPS)
    raw = _load(path)
    config = t_tf.config_from_env(WORKER_ENV, dtype=torch.bfloat16)
    params = t_tf.init_params(config, seed=0, device="cpu")
    t_state, _ = t_ckpt.restore_checkpoint(
        str(root / "whole"), t_tf.train_state(params, t_tf.adamw(params)))
    j_config = j_tf.config_from_env(WORKER_ENV, dtype=jnp.bfloat16)
    j_params = j_tf.init_params(j_config, jax.random.key(0))
    j_state, _ = j_ckpt.restore_checkpoint(
        str(root / "whole"),
        {"params": j_params, "opt_state": optax.adamw(LR).init(j_params)})
    t_leaves, j_leaves = tree_leaves(t_state), jax.tree.leaves(j_state)
    assert len(t_leaves) == len(j_leaves) == len(
        [k for k in raw if k.startswith("leaf_")])
    for i, (t, j) in enumerate(zip(t_leaves, j_leaves)):
        t = t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
        j = np.asarray(j).astype(np.float32) if j.dtype == jnp.bfloat16 \
            else np.asarray(j)
        assert np.array_equal(t, raw[f"leaf_{i}"])
        assert np.array_equal(j, raw[f"leaf_{i}"])


def test_gang_refuses_a_diverging_start_step(tmp_path):
    """Two workers, each with its own CHECKPOINT_DIR, one of which holds
    a step-2 checkpoint: both refuse before the first step."""
    stale = str(tmp_path / "w1")
    train(dict(WORKER_ENV, TRAIN_STEPS="2", TRAIN_ASYNC_CKPT="0",
               SANDBOX=str(tmp_path), CHECKPOINT_DIR=stale),
          log=lambda m: None)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=train_worker._rank_entry, args=(
        dict(WORKER_ENV, TRAIN_STEPS="3", TPU_WORKER_COUNT="2",
             TPU_WORKER_ID=str(w), SANDBOX=str(tmp_path),
             CHECKPOINT_DIR=stale if w else str(tmp_path / "w0")),
        0, 1, "file://" + str(tmp_path / "store"), 60, results))
        for w in (0, 1)]
    for p in procs:
        p.start()
    try:
        errors = [results.get(timeout=GANG_DEADLINE_S)[2] for _ in procs]
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    assert all(e and "checkpoint step diverges across the gang: [0, 2]"
               in e for e in errors), errors

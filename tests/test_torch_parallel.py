"""The port's sharded train step (``make_train_step(mesh=...)``,
dcos_commons_tpu_torch/parallel/sharding.py) and the explicit expert
parallel ``moe_ffn(axis_name="ep")`` on gloo process groups of 2 and 4
CPU processes, against the JAX package's mesh step and its
``shard_map`` case on the virtual CPU devices of this pytest process.

The same numpy-made params (the JAX init) and tokens go to both sides;
each rank shards the full params itself (``shard_params``) and takes
its rows of the global batch.  f32, remat on, ``loss_chunk`` on (two
chunks of 8 over seq 16), MoE routing groups of 8 (two a row).
Tolerances: the loss within 1e-5 relative at each of 2 AdamW steps,
and the params after them within 1e-5 (absolute and relative) where
the gradient (one process's, of the whole batch) is at least 1e-6 at
both steps, as the single-device step was held.  Where it is not, AdamW's first steps move a param
by about lr * g / (|g| + 1e-8), whose slope turns f32 rounding of g
into a step difference of up to 2 lr a step: those params are held to
2 lr * steps.  ``moe_ffn`` outputs, loss and gradients within 1e-5.

Layouts (each a case; the layouts of one world run in one spawn of its
processes): dp2, tp2, fsdp2, dp2 with ``grad_accum=2``, GQA (2 KV
heads) under tp2, MoE under ep2 and under tp2 (2 processes);
dp2 x tp2, dp x fsdp x tp = 1 x 2 x 2, dcn2 from ``mesh_from_env``
with ``TPU_NUM_SLICES=2``, ``TPU_CHIPS_PER_HOST=2``, and MoE under
ep2 x tp2 (4 processes).

Every spawn has a join deadline, the process group a timeout, and the
rendezvous is a file store under the test's ``tmp_path``: no TCP port.
"""

import os
import pickle
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dcos_commons_tpu.models import moe as j_moe
from dcos_commons_tpu.models import transformer as j_tf
from dcos_commons_tpu.parallel import mesh as j_mesh
from dcos_commons_tpu.parallel.compat import shard_map
from dcos_commons_tpu_torch.models import moe as t_moe
from dcos_commons_tpu_torch.models import transformer as t_tf
from dcos_commons_tpu_torch.parallel import mesh as t_mesh
from dcos_commons_tpu_torch.parallel import sharding
from dcos_commons_tpu_torch.utils.tree import tree_leaves, tree_map

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))
DEADLINE_S = 300
TOL = 1e-5
STEPS = 2
BATCH = 4

BASE = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=4,
            d_ff=64, max_seq=16, remat=True, loss_chunk=8)
MOE = dict(n_experts=4, moe_top_k=2, moe_group_size=8, d_ff=32)
# name -> (world, config fields, mesh: MeshSpec fields or an env
# for mesh_from_env, grad_accum)
LAYOUTS = {
    "dp2": (2, {}, {"dp": 2}, 1),
    "tp2": (2, {}, {"tp": 2}, 1),
    "fsdp2": (2, {}, {"fsdp": 2}, 1),
    "dp2-grad-accum-2": (2, {}, {"dp": 2}, 2),
    "gqa-tp2": (2, {"n_kv_heads": 2}, {"tp": 2}, 1),
    "moe-ep2": (2, MOE, {"ep": 2}, 1),
    "moe-tp2": (2, MOE, {"tp": 2}, 1),
    "dp2xtp2": (4, {}, {"dp": 2, "tp": 2}, 1),
    "dp1xfsdp2xtp2": (4, {}, {"dp": 1, "fsdp": 2, "tp": 2}, 1),
    "dcn2-from-env": (4, {}, {"env": {"TPU_NUM_SLICES": "2",
                                      "TPU_CHIPS_PER_HOST": "2"}}, 1),
    "moe-ep2xtp2": (4, MOE, {"ep": 2, "tp": 2}, 1),
}
EP_WORLDS = (2, 4)

_RUNNER = r"""
import datetime, importlib, os, pickle, sys
repo, tests, module, fn, rank, world, work = sys.argv[1:8]
sys.path[:0] = [repo, tests]
import torch
import torch.distributed as dist
torch.set_num_threads(1)
dist.init_process_group(
    "gloo", init_method="file://" + os.path.join(work, "store"),
    world_size=int(world), rank=int(rank),
    timeout=datetime.timedelta(seconds=120))
with open(os.path.join(work, "in.pkl"), "rb") as f:
    payload = pickle.load(f)
out = getattr(importlib.import_module(module), fn)(payload)
if int(rank) == 0:
    with open(os.path.join(work, "out.pkl.tmp"), "wb") as f:
        pickle.dump(out, f)
    os.replace(os.path.join(work, "out.pkl.tmp"),
               os.path.join(work, "out.pkl"))
dist.destroy_process_group()
"""


def run_gang(work, world, fn, payload, deadline_s=DEADLINE_S,
             module=__name__):
    """Run ``module.fn(payload)`` in ``world`` fresh processes joined by
    gloo over a file store in ``work``; return rank 0's result.  Every
    process is killed at the deadline."""
    os.makedirs(work, exist_ok=True)
    with open(os.path.join(work, "in.pkl"), "wb") as f:
        pickle.dump(payload, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    procs, logs = [], []
    for rank in range(world):
        log = open(os.path.join(work, f"rank{rank}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _RUNNER, REPO, TESTS, module, fn,
             str(rank), str(world), str(work)],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=REPO))
    end = time.monotonic() + deadline_s
    try:
        for p in procs:
            p.wait(timeout=max(1.0, end - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    if any(p.returncode != 0 for p in procs):
        tails = []
        for rank in range(world):
            with open(os.path.join(work, f"rank{rank}.log")) as f:
                tails.append(f"rank {rank} (exit {procs[rank].returncode}):"
                             f"\n{f.read()[-3000:]}")
        raise AssertionError("gang failed or passed its deadline:\n"
                             + "\n".join(tails))
    with open(os.path.join(work, "out.pkl"), "rb") as f:
        return pickle.load(f)


# -- what each rank runs -------------------------------------------------------


def _port_mesh(mesh_fields):
    if "env" in mesh_fields:
        return t_mesh.mesh_from_env(mesh_fields["env"])
    return t_mesh.make_mesh(t_mesh.MeshSpec(**mesh_fields))


def _rank_train(cases):
    """Each case: 2 sharded steps from the full params, on this rank's
    rows; returns {name: (losses, full params after the steps, the
    least |g| of each param over the steps)}, where g is one process's
    gradient of the whole batch at the gang's params before each step."""
    import torch.distributed as dist

    out = {}
    for name, fields, mesh_fields, grad_accum, params, batches in cases:
        config = t_tf.TransformerConfig(**fields, dtype=torch.float32)
        mesh = _port_mesh(mesh_fields)
        full = tree_map(torch.from_numpy, params)
        local = t_tf.shard_params(full, config, mesh)
        step = t_tf.make_train_step(config, t_tf.adamw(local), mesh=mesh,
                                    grad_accum=grad_accum)
        n = mesh.size(t_mesh.BATCH_AXES)
        i = mesh.index(t_mesh.BATCH_AXES)
        losses, small = [], None
        for toks in batches:
            rows = torch.from_numpy(toks.astype(np.int64))
            now = t_tf.unshard_params(local, config, mesh)
            if dist.get_rank() == 0:
                leaves = [t.requires_grad_(True) for t in tree_leaves(now)]
                grads = [g.abs().numpy() for g in torch.autograd.grad(
                    t_tf.loss_fn(config, now, rows[:, :-1], rows[:, 1:]),
                    leaves)]
                small = grads if small is None else [
                    np.minimum(a, b) for a, b in zip(small, grads)]
            rows = rows[i * len(rows) // n:(i + 1) * len(rows) // n]
            losses.append(float(step(local, rows[:, :-1], rows[:, 1:])))
        gathered = t_tf.unshard_params(local, config, mesh)
        out[name] = (losses, tree_map(lambda t: t.numpy(), gathered), small)
    return out


def _rank_moe_ep(case):
    """The reference's shard_map case (``__graft_entry__.py``
    ``dryrun_multichip``, its ep section) over an ep axis of the whole
    world: returns (loss, output rows of every rank, full gradients) for
    both dispatches."""
    import torch.distributed as dist

    fields, params, x = case
    config = t_moe.MoEConfig(**fields, dtype=torch.float32)
    mesh = t_mesh.make_mesh(t_mesh.MeshSpec(ep=dist.get_world_size()))
    rules = t_moe.expert_shard_spec()
    rows = len(x) // mesh.size(("ep",))
    i = mesh.index(("ep",))
    xl = torch.from_numpy(x[i * rows:(i + 1) * rows])
    out = {}
    for impl in ("onehot", "sorted"):
        local = {k: sharding.shard(torch.from_numpy(v), rules[k], mesh)
                 .requires_grad_(True) for k, v in params.items()}
        with mesh:
            y, aux = t_moe.moe_ffn(config, local, xl, axis_name="ep",
                                   impl=impl)
        n = mesh.size(("ep",))
        # each rank's share of the mean loss; the pmean and all_to_all
        # carry every rank's cotangents, as shard_map's transposes do
        share = ((y ** 2).mean() + 0.01 * aux) / n
        grads = dict(zip(local, torch.autograd.grad(share,
                                                    list(local.values()))))
        loss = sharding.all_reduce(share.detach().clone(),
                                   mesh.group(("ep",)))
        grads["router"] = sharding.all_reduce(grads["router"],
                                              mesh.group(("ep",)))
        full = {k: sharding.unshard(g, rules[k], mesh).numpy()
                for k, g in grads.items()}
        ys = sharding.unshard(y.detach(), sharding.P("ep", None), mesh)
        out[impl] = (float(loss), ys.numpy(), full)
    return out


def _rank_main(payload):
    kind, body = payload
    if kind == "train":
        return _rank_train(body)
    return _rank_moe_ep(body)


# -- the JAX side --------------------------------------------------------------


def _jax_mesh(world, mesh_fields):
    if "env" in mesh_fields:
        return j_mesh.mesh_from_env(mesh_fields["env"], n_devices=world)
    return j_mesh.make_mesh(j_mesh.MeshSpec(**mesh_fields),
                            jax.devices()[:world])


def _batches(seed, vocab):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (STEPS, BATCH, BASE["max_seq"] + 1)
                        ).astype(np.int32)


def _jax_run(world, fields, mesh_fields, grad_accum, batches):
    config = j_tf.TransformerConfig(**dict(BASE, **fields),
                                    dtype=jnp.float32)
    params = j_tf.init_params(config, jax.random.key(0))
    full = jax.tree.map(lambda a: np.asarray(a).copy(), params)
    mesh = _jax_mesh(world, mesh_fields)
    optimizer = optax.adamw(3e-4)
    with mesh:
        state = optimizer.init(params)
        step = j_tf.make_train_step(config, optimizer, mesh=mesh,
                                    donate=False, grad_accum=grad_accum)
        losses = []
        for toks in batches:
            params, state, loss = step(params, state, toks[:, :-1],
                                       toks[:, 1:])
            losses.append(float(loss))
    return full, losses, [np.asarray(a) for a in jax.tree.leaves(params)]


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    """Every layout run once on each side: {name: (jax losses, jax
    params, port losses, port params)}."""
    jax_side, cases = {}, {2: [], 4: []}
    for seed, (name, (world, fields, mesh_fields, ga)) in enumerate(
            LAYOUTS.items()):
        batches = _batches(seed, BASE["vocab"])
        full, losses, leaves = _jax_run(world, fields, mesh_fields, ga,
                                        batches)
        jax_side[name] = (losses, leaves)
        cases[world].append((name, dict(BASE, **fields), mesh_fields, ga,
                             full, batches))
    port = {}
    for world, body in cases.items():
        port.update(run_gang(tmp_path_factory.mktemp(f"gang{world}"),
                             world, "_rank_main", ("train", body)))
    return {name: (*jax_side[name], *port[name]) for name in LAYOUTS}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_sharded_step_matches_the_jax_mesh_step(gangs, layout):
    j_losses, j_leaves, t_losses, t_params, small = gangs[layout]
    np.testing.assert_allclose(t_losses, j_losses, rtol=TOL, atol=0)
    t_leaves = tree_leaves(t_params)
    assert len(t_leaves) == len(j_leaves)
    for want, got, g in zip(j_leaves, t_leaves, small):
        tight = g >= 1e-6
        np.testing.assert_allclose(got[tight], want[tight], atol=TOL,
                                   rtol=TOL)
        assert np.abs(got - want).max() <= 2 * 3e-4 * STEPS * (1 + 1e-4)


def _jax_moe_ep(world, impl):
    """The reference's shard_map ep case at ep = world."""
    fields = dict(d_model=64, d_ff=128, n_experts=world * 2, top_k=2,
                  capacity_factor=4.0)
    config = j_moe.MoEConfig(**fields, dtype=jnp.float32)
    mesh = j_mesh.make_mesh(j_mesh.MeshSpec(ep=world), jax.devices()[:world])
    params = j_moe.init_moe_params(config, jax.random.key(4))
    x = np.random.default_rng(5).standard_normal((world * 8, 64)).astype(
        np.float32)
    from jax.sharding import PartitionSpec as JP

    def body(p, x):
        y, aux = j_moe.moe_ffn(config, p, x, axis_name="ep", impl=impl)
        local = (y ** 2).mean() + 0.01 * aux
        return jax.lax.pmean(jax.lax.pmean(local, "ep"), "dp"), y

    with mesh:
        fn = shard_map(body, mesh=mesh,
                       in_specs=(j_moe.expert_shard_spec(), JP(("dp", "ep"))),
                       out_specs=(JP(), JP(("dp", "ep"))), check_vma=False)
        (loss, y), grads = jax.jit(jax.value_and_grad(
            lambda p: fn(p, x), has_aux=True))(params)
    full = {k: np.asarray(v).copy() for k, v in params.items()}
    return (fields, full, x), (float(loss), np.asarray(y),
                               {k: np.asarray(v) for k, v in grads.items()})


@pytest.fixture(scope="module")
def moe_ep_runs(tmp_path_factory):
    out = {}
    for world in EP_WORLDS:
        ref = {}
        for impl in ("onehot", "sorted"):
            case, ref[impl] = _jax_moe_ep(world, impl)
        port = run_gang(tmp_path_factory.mktemp(f"ep{world}"), world,
                        "_rank_main", ("moe_ep", case))
        out[world] = (ref, port)
    return out


@pytest.mark.parametrize("impl", ["onehot", "sorted"])
@pytest.mark.parametrize("ep", EP_WORLDS)
def test_moe_ffn_ep_all_to_all_matches_shard_map(moe_ep_runs, ep, impl):
    (j_loss, j_y, j_grads) = moe_ep_runs[ep][0][impl]
    (t_loss, t_y, t_grads) = moe_ep_runs[ep][1][impl]
    np.testing.assert_allclose(t_loss, j_loss, rtol=TOL, atol=0)
    np.testing.assert_allclose(t_y, j_y, atol=TOL, rtol=TOL)
    assert set(t_grads) == set(j_grads)
    for name, want in j_grads.items():
        np.testing.assert_allclose(t_grads[name], want, atol=TOL, rtol=1e-4)

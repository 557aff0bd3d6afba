"""Collective overlap in the port (dcos_commons_tpu_torch/parallel/overlap.py,
``make_train_step(..., overlap=...)``, the start/wait collectives of
parallel/sharding.py, ``ring_attention(..., overlap=True)``) on gloo
process groups of 2 and 4 CPU processes.

- The knob: for a table of env contracts, ``enable_collective_overlap``
  turns overlap on exactly where the reference's adds XLA flags, with
  ``TORCH_DEVICE`` read where the reference reads ``JAX_PLATFORMS``;
  it writes nothing to the env.  Overlap on a mesh whose data axes
  hold one rank (tp2, the MoE's ep2, no mesh) raises ``OverlapError``
  before any collective.
- Two ranks: overlap on against off for dp2 and fsdp2, with
  ``grad_accum`` 1 and 2 and remat ``full`` and ``save-attn``, and the
  ring recipe over sp2: the losses and the params after 2 AdamW steps
  are equal (every sum over two ranks has one order).  Four ranks:
  dp2 x tp2 and fsdp2 x tp2 within 1e-6 relative (gloo's chunking of
  a bucket may add in another order), and against the JAX package's
  one-device step at the same batch within ``tests/test_torch_mesh.py``
  ``_gang_misfits``' tolerance.
- The ring: overlapped sp2 and sp4 values and q/k/v gradients equal
  the synchronous ring's, and match the JAX ring under ``shard_map``
  within ``tests/test_torch_long_context.py``'s 2e-5.
- Engagement: gradient buckets were launched before the backward's last
  gradient, fsdp gathers a layer ahead; the overlapped step makes no
  device synchronisation under ``timed_collectives``.  A reducer that
  drops one bucket is caught by the comparison.
- ``init_gang`` binds an NCCL group to ``cuda:<local_rank>`` and leaves
  gloo's call as it was.

f32, 2 layers, d_model 32, seq 16, batch 4; the same numpy-made params
(the JAX init) and tokens on every side.  Every spawn has a deadline
(``run_gang``: a file store under ``tmp_path``, a process-group
timeout).
"""

import itertools

import numpy as np
import pytest
import torch

from dcos_commons_tpu_torch.models import transformer as t_tf
from dcos_commons_tpu_torch.parallel import distributed, overlap, sharding
from dcos_commons_tpu_torch.parallel import mesh as t_mesh
from dcos_commons_tpu_torch.parallel.ring import ring_attention
from dcos_commons_tpu_torch.utils.tree import tree_leaves, tree_map

STEPS = 2
BATCH = 4
LR = 3e-4
FOUR_RTOL = 1e-6
ATTN_TOL = 2e-5
BASE = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=4,
            d_ff=64, max_seq=16, remat=True, loss_chunk=8)
# name -> (world, config fields, MeshSpec fields, grad_accum)
TWO = {f"{'x'.join(f'{k}{v}' for k, v in m.items())}-ga{ga}-{policy}":
       (2, {"remat_policy": policy}, m, ga)
       for m, ga, policy in itertools.product(
           ({"dp": 2}, {"fsdp": 2}), (1, 2), ("full", "save-attn"))}
TWO["ring-sp2"] = (2, {"use_ring_attention": True}, {"sp": 2}, 1)
TWO["ring-sp2-no-remat"] = (2, {"use_ring_attention": True, "remat": False},
                            {"sp": 2}, 1)
FOUR = {"dp2xtp2": (4, {}, {"dp": 2, "tp": 2}, 1),
        "fsdp2xtp2": (4, {}, {"fsdp": 2, "tp": 2}, 1)}
LAYOUTS = {**TWO, **FOUR}
FAULT = "dp2-ga1-full"
# ring attention: (sp, causal), q/k/v [2, 4, 32, 8]
RING_SHAPE = (2, 4, 32, 8)
RING_CASES = [(sp, causal) for sp in (2, 4) for causal in (True, False)]


# -- the knob ------------------------------------------------------------------

ENVS = [
    {},
    {"TPU_GENERATION": "v5e"},
    {"TPU_GENERATION": ""},
    {"TPU_GENERATION": "h100", "TRAIN_XLA_OVERLAP": "0"},
    {"TPU_GENERATION": "h100", "TRAIN_XLA_OVERLAP": "false"},
    {"TPU_GENERATION": "h100", "TRAIN_XLA_OVERLAP": "1"},
    {"TPU_GENERATION": "h100", "TRAIN_XLA_OVERLAP": "no"},
    {"TRAIN_XLA_OVERLAP": "1"},
    {"TPU_GENERATION": "v4", "TORCH_DEVICE": "cpu"},
    {"TPU_GENERATION": "v4", "TORCH_DEVICE": "CPU"},
    {"TPU_GENERATION": "v4", "TORCH_DEVICE": "cuda"},
    {"TPU_GENERATION": "v4", "TORCH_DEVICE": "cuda:1"},
    {"TPU_GENERATION": "v4", "TORCH_DEVICE": ""},
    {"TPU_GENERATION": "v5p", "XLA_FLAGS": "--xla_dump_to=/dev/null"},
    {"TPU_GENERATION": "v5p", "TRAIN_XLA_OVERLAP": "false",
     "TORCH_DEVICE": "cuda"},
]


def _reference_env(env):
    """The reference's env for a port env: ``TORCH_DEVICE`` is read
    where the reference reads ``JAX_PLATFORMS``."""
    out = {k: v for k, v in env.items() if k != "TORCH_DEVICE"}
    if "TORCH_DEVICE" in env:
        out["JAX_PLATFORMS"] = env["TORCH_DEVICE"]
    return out


@pytest.mark.parametrize("env", ENVS, ids=lambda e: ",".join(
    f"{k}={v}" for k, v in e.items()) or "empty")
def test_knob_matches_the_reference(env):
    from dcos_commons_tpu.parallel.overlap import (
        enable_collective_overlap as reference,
    )

    mine = dict(env)
    got = overlap.enable_collective_overlap(mine)
    assert mine == env  # nothing written to the env
    assert bool(got) == bool(reference(_reference_env(env)))
    assert got in ([], list(overlap.MECHANISMS))


@pytest.mark.parametrize("env", ENVS, ids=lambda e: ",".join(
    f"{k}={v}" for k, v in e.items()) or "empty")
def test_the_worker_overlaps_only_when_asked(env):
    """The port's train worker: off by default (the reference's is on),
    and with ``TRAIN_XLA_OVERLAP`` 1 or true, the contract's decision."""
    from dcos_commons_tpu_torch.frameworks.train_worker import (
        overlap_from_env,
    )

    asked = env.get("TRAIN_XLA_OVERLAP") in ("1", "true")
    want = overlap.enable_collective_overlap(env) if asked else []
    assert overlap_from_env(env) == want
    assert overlap_from_env(dict(env, TRAIN_XLA_OVERLAP="true")) == (
        overlap.enable_collective_overlap(dict(env, TRAIN_XLA_OVERLAP="1")))


def test_knob_reads_os_environ_by_default(monkeypatch):
    monkeypatch.setenv("TPU_GENERATION", "h100")
    monkeypatch.setenv("TORCH_DEVICE", "cuda")
    monkeypatch.delenv("TRAIN_XLA_OVERLAP", raising=False)
    assert overlap.enable_collective_overlap() == list(overlap.MECHANISMS)
    monkeypatch.setenv("TRAIN_XLA_OVERLAP", "0")
    assert overlap.enable_collective_overlap() == []


@pytest.mark.parametrize("case", ["no mesh", "one rank", "tp2",
                                  "moe ep2", "ring on tp2"])
def test_overlap_that_cannot_engage_raises(case):
    """``OverlapError`` before anything runs where the data axes hold one
    rank: no gradient is reduced there, so nothing would overlap.  Never
    the synchronous step in silence."""
    fields = {"ring on tp2": {"use_ring_attention": True},
              "moe ep2": {"n_experts": 4}}.get(case, {})
    config = t_tf.TransformerConfig(**BASE, **fields, dtype=torch.float32)
    mesh = None if case == "no mesh" else t_mesh.Mesh(t_mesh.MeshSpec(**{
        "one rank": {}, "tp2": {"tp": 2}, "moe ep2": {"ep": 2},
        "ring on tp2": {"tp": 2}}[case]), 0)
    assert t_tf.overlap_mechanisms(config, mesh) == ()
    with pytest.raises(overlap.OverlapError):
        t_tf.make_train_step(config, None, mesh=mesh, overlap=True)
    assert t_tf.make_train_step(config, None, mesh=mesh).overlap == ()


def test_what_engages_on_each_mesh():
    def engaged(fields, recipe=None):
        config = t_tf.TransformerConfig(**BASE, **({recipe: True} if recipe
                                                   else {}),
                                        dtype=torch.float32)
        return t_tf.overlap_mechanisms(
            config, t_mesh.Mesh(t_mesh.MeshSpec(**fields), 0))

    assert engaged({"dp": 2}) == ("grad_reduce",)
    assert engaged({"dp": 2, "tp": 2}) == ("grad_reduce",)
    assert engaged({"fsdp": 2, "tp": 2}) == ("grad_reduce", "fsdp_prefetch")
    assert engaged({"sp": 2}, "use_ring_attention") == ("grad_reduce",
                                                        "ring_hop")
    assert engaged({"sp": 2}, "use_ulysses_attention") == ("grad_reduce",)
    assert engaged({"tp": 2}) == ()


def test_init_gang_binds_nccl_to_the_local_card(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **kw: calls.append((a, kw)))
    distributed.init_gang("file:///nowhere", 2, 1, "gloo", timeout_s=5)
    distributed.init_gang("file:///nowhere", 4, 3, "nccl", timeout_s=5,
                          local_rank=1)
    (gloo_args, gloo_kw), (nccl_args, nccl_kw) = calls
    assert gloo_args == ("gloo",) and "device_id" not in gloo_kw
    assert gloo_kw["world_size"] == 2 and gloo_kw["rank"] == 1
    assert nccl_args == ("nccl",)
    assert nccl_kw["device_id"] == torch.device("cuda", 1)
    assert {k: v for k, v in nccl_kw.items() if k != "device_id"} == dict(
        gloo_kw, world_size=4, rank=3)


# -- what each rank runs -------------------------------------------------------


def _run(fields, mesh_fields, grad_accum, params, batches, lap,
         timed=False):
    """2 steps of ``make_train_step(overlap=lap)`` from the full
    params on this rank's rows (and sequence chunk): (losses, full
    params, full AdamW moments and count, the step's stats; with
    ``timed``, a third step under ``timed_collectives`` with the device
    synchronisations it made)."""
    config = t_tf.TransformerConfig(**dict(BASE, **fields),
                                    dtype=torch.float32)
    mesh = t_mesh.make_mesh(t_mesh.MeshSpec(**mesh_fields))
    local = t_tf.shard_params(tree_map(torch.from_numpy, params), config,
                              mesh)
    optimizer = t_tf.adamw(local, LR)
    step = t_tf.make_train_step(config, optimizer, mesh=mesh,
                                grad_accum=grad_accum, overlap=lap)
    n, i = mesh.size(t_mesh.BATCH_AXES), mesh.index(t_mesh.BATCH_AXES)
    m, j = mesh.size(("sp",)), mesh.index(("sp",))
    chunk = BASE["max_seq"] // m

    def rows(toks):
        toks = torch.from_numpy(toks.astype(np.int64))[
            i * BATCH // n:(i + 1) * BATCH // n]
        x, y = toks[:, :-1], toks[:, 1:]
        return x[:, j * chunk:(j + 1) * chunk], y[:, j * chunk:(j + 1) * chunk]

    losses = [float(step(local, *rows(toks))) for toks in batches]
    stats = dict(step.stats)
    rules = t_tf.leaf_rules(config)
    (count, mu, nu), _, _ = t_tf.adamw_state(optimizer, local)
    state = {name: [sharding.unshard(t, d, mesh).numpy()
                    for t, d in zip(tree_leaves(tree), rules)]
             for name, tree in (("params", local), ("mu", mu), ("nu", nu))}
    state["count"] = int(count)
    synced = None
    if timed:
        real, synced = sharding._sync, []
        sharding._sync = lambda t: synced.append(1)
        try:
            with sharding.timed_collectives() as coll:
                step(local, *rows(batches[-1]))
        finally:
            sharding._sync = real
        synced = (len(synced), dict(coll))
    return losses, state, stats, step.overlap, synced


def _drop_one_bucket():
    """A reducer that leaves its second bucket unreduced on every rank
    (each keeps its own gradient there): the planted fault."""
    real, calls = overlap.all_reduce_start, []

    def dropped(t, group):
        calls.append(1)
        if len(calls) == 2:
            return sharding.Pending(None, t)
        return real(t, group)

    overlap.all_reduce_start = dropped
    return lambda: setattr(overlap, "all_reduce_start", real)


def _rank_train(cases, params, batches):
    """{name: (off, on)} of ``_run``; the fault case also returns the
    run with one bucket dropped."""
    out = {}
    for name, fields, mesh_fields, grad_accum in cases:
        timed = name == FAULT
        off = _run(fields, mesh_fields, grad_accum, params, batches, False,
                   timed)
        on = _run(fields, mesh_fields, grad_accum, params, batches, True,
                  timed)
        out[name] = (off, on)
        if name == FAULT:
            restore = _drop_one_bucket()
            try:
                out["fault"] = (off, _run(fields, mesh_fields, grad_accum,
                                          params, batches, True))
            finally:
                restore()
    return out


def _rank_ring(cases, q, k, v, w):
    """{(sp, causal): (synchronous, overlapped)}, each (the full output,
    the full q/k/v gradients of sum(out * w)), gathered over sp."""
    world = torch.distributed.get_world_size()
    mesh = t_mesh.make_mesh(t_mesh.MeshSpec(sp=world))
    spec = sharding.P(None, None, "sp", None)
    out = {}
    for sp, causal in cases:
        pair = []
        for lap in (False, True):
            parts = [torch.from_numpy(sharding.shard(a, spec, mesh))
                     .requires_grad_(True) for a in (q, k, v)]
            got = ring_attention(*parts, mesh, "sp", causal, overlap=lap)
            grads = torch.autograd.grad(
                (got * torch.from_numpy(sharding.shard(w, spec, mesh))).sum(),
                parts)
            pair.append((sharding.unshard(got.detach(), spec, mesh).numpy(),
                         [sharding.unshard(g, spec, mesh).numpy()
                          for g in grads]))
        out[(sp, causal)] = tuple(pair)
    return out


def _rank_hops_left(q, k, v):
    """Hop handles still alive after an overlapped ring's forward and
    backward, with the cycle collector off: a handle that kept a tensor
    of its own hop would hold that tensor's autograd node in a cycle,
    and with it every tensor the node saved (a recompute's never runs
    its backward)."""
    import gc

    world = torch.distributed.get_world_size()
    mesh = t_mesh.make_mesh(t_mesh.MeshSpec(sp=world))
    spec = sharding.P(None, None, "sp", None)
    gc.collect()
    gc.disable()
    try:
        parts = [torch.from_numpy(sharding.shard(a, spec, mesh))
                 .requires_grad_(True) for a in (q, k, v)]
        out = ring_attention(*parts, mesh, "sp", True, overlap=True)
        torch.autograd.grad(out.sum(), parts)
        with torch.no_grad():
            ring_attention(*parts, mesh, "sp", True, overlap=True)
        del out, parts
        return sum(isinstance(o, sharding.Hop) for o in gc.get_objects())
    finally:
        gc.enable()


def _rank_main(payload):
    train, ring = payload
    return {"train": _rank_train(*train), "ring": _rank_ring(*ring),
            "hops left": _rank_hops_left(*ring[1:4])}


# -- the comparisons -----------------------------------------------------------


def _apart(a, b, rtol):
    """Where run ``a`` stands apart from run ``b`` (``_run``'s losses
    and state): beyond ``rtol`` relative (0: not equal)."""
    out = [f"loss {s}: {x} vs {y}" for s, (x, y) in enumerate(zip(a[0], b[0]))
           if abs(x - y) > rtol * abs(y)]
    for name in ("params", "mu", "nu"):
        for j, (x, y) in enumerate(zip(a[1][name], b[1][name])):
            diff = float(np.abs(x - y).max())
            if (diff > rtol * float(np.abs(y).max())) if rtol else not (
                    np.array_equal(x, y)):
                out.append(f"{name} leaf {j}: apart {diff:.3e}")
    if a[1]["count"] != b[1]["count"]:
        out.append(f"count {a[1]['count']} vs {b[1]['count']}")
    return out


def _jax_side(batches):
    """The JAX init (numpy), and its one-device step at the gang's global
    batch: (losses by step, state, init leaves) as ``_gang_misfits``
    reads them."""
    import jax
    import jax.numpy as jnp
    import optax

    from dcos_commons_tpu.models import transformer as j_tf

    config = j_tf.TransformerConfig(**BASE, dtype=jnp.float32)
    params = j_tf.init_params(config, jax.random.key(0))
    full = jax.tree.map(lambda a: np.asarray(a).copy(), params)
    optimizer = optax.adamw(LR)
    state = optimizer.init(params)
    step = j_tf.make_train_step(config, optimizer, donate=False)
    losses = {}
    for s, toks in enumerate(batches):
        params, state, loss = step(params, state, toks[:, :-1], toks[:, 1:])
        losses[s] = float(loss)
    adam = state[0]
    leaves = {name: [torch.from_numpy(np.asarray(a).copy())
                     for a in jax.tree.leaves(tree)]
              for name, tree in (("params", params), ("mu", adam.mu),
                                 ("nu", adam.nu))}
    leaves["count"] = int(adam.count)
    init = [torch.from_numpy(a) for a in jax.tree.leaves(full)]
    return full, (losses, leaves, init)


def _jax_ring(sp, causal, q, k, v, w):
    import functools

    import jax
    from jax.sharding import PartitionSpec as JP

    from dcos_commons_tpu.parallel import mesh as j_mesh
    from dcos_commons_tpu.parallel.compat import shard_map
    from dcos_commons_tpu.parallel.ring import ring_attention as j_ring

    mesh = j_mesh.make_mesh(j_mesh.MeshSpec(sp=sp), jax.devices()[:sp])
    fn = functools.partial(j_ring, axis_name="sp", causal=causal,
                           axis_size=sp)
    spec = JP(None, None, "sp", None)
    with mesh:
        ring = shard_map(fn, mesh=mesh, in_specs=(spec,) * 3,
                         out_specs=spec, check_vma=False)
        out = ring(q, k, v)
        grads = jax.grad(lambda q, k, v: (ring(q, k, v) * w).sum(),
                         argnums=(0, 1, 2))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every layout and ring case, both ways, the port's in one spawn a
    world size; the JAX step and rings."""
    from test_torch_parallel import run_gang

    rng = np.random.default_rng(0)
    batches = rng.integers(0, BASE["vocab"], (STEPS, BATCH,
                                              BASE["max_seq"] + 1)
                           ).astype(np.int32)
    full, jax_step = _jax_side(batches)
    q, k, v, w = (rng.standard_normal(RING_SHAPE).astype(np.float32)
                  for _ in range(4))
    port = {}
    for world in (2, 4):
        cases = [(name, *case[1:]) for name, case in LAYOUTS.items()
                 if case[0] == world]
        rings = [c for c in RING_CASES if c[0] == world]
        got = run_gang(tmp_path_factory.mktemp(f"overlap{world}"), world,
                       "_rank_main", ((cases, full, batches),
                                      (rings, q, k, v, w)),
                       deadline_s=240, module=__name__)
        port["ring"] = {**port.get("ring", {}), **got["ring"]}
        port[f"hops left {world}"] = got["hops left"]
        port.update(got["train"])
    jax_rings = {case: _jax_ring(*case, q, k, v, w) for case in RING_CASES}
    return port, jax_step, jax_rings


@pytest.mark.parametrize("layout", list(TWO))
def test_two_ranks_overlap_equals_off_bit_for_bit(runs, layout):
    off, on = runs[0][layout]
    assert _apart(on, off, 0) == []
    _, fields, mesh_fields, _ = LAYOUTS[layout]
    assert on[3] == t_tf.overlap_mechanisms(
        t_tf.TransformerConfig(**dict(BASE, **fields)),
        t_mesh.Mesh(t_mesh.MeshSpec(**mesh_fields), 0))
    assert on[3] and off[3] == ()


@pytest.mark.parametrize("layout", list(FOUR))
def test_four_ranks_overlap_within_1e_6(runs, layout):
    off, on = runs[0][layout]
    assert _apart(on, off, FOUR_RTOL) == []


@pytest.mark.parametrize("layout", ["dp2-ga1-full", *FOUR])
def test_overlapped_gang_matches_the_jax_step(runs, layout):
    """The overlapped gang against the JAX package's one-device step at
    the same global batch and tokens, by ``_gang_misfits``' rules."""
    from test_torch_mesh import _gang_misfits

    _, on = runs[0][layout]
    state = {"count": on[1]["count"],
             **{name: [torch.from_numpy(a) for a in on[1][name]]
                for name in ("params", "mu", "nu")}}
    assert _gang_misfits(dict(enumerate(on[0])), state, runs[1]) == []


def test_a_dropped_bucket_is_caught(runs):
    off, faulty = runs[0]["fault"]
    assert _apart(faulty, off, 0) != []
    assert _apart(faulty, off, FOUR_RTOL) != []


@pytest.mark.parametrize("layout", ["dp2-ga1-full", "dp2-ga2-save-attn",
                                    "fsdp2-ga1-full", "fsdp2-ga2-save-attn",
                                    "ring-sp2", "ring-sp2-no-remat", *FOUR])
def test_reductions_launch_inside_the_backward(runs, layout):
    """Buckets were launched while gradients were still to come (before
    the backward's last node); under fsdp, gathers a layer ahead."""
    _, on = runs[0][layout]
    stats = on[2]
    assert stats["buckets"] >= 1 and stats["launched_early"] >= 1, stats
    if "fsdp" in layout:
        assert stats["prefetched"] >= BASE["n_layers"], stats
    assert "fsdp_prefetch" in on[3] or stats["prefetched"] == 0


def test_the_overlapped_step_makes_no_device_synchronisation(runs):
    """Under ``timed_collectives`` the synchronous step brackets each
    collective with device synchronisations; the overlapped one makes
    none and reports its waits under ``wait_seconds``."""
    off, on = runs[0][FAULT]
    (off_syncs, off_coll), (on_syncs, on_coll) = off[4], on[4]
    assert off_syncs == 2 * off_coll["calls"] > 0
    assert off_coll["starts"] == 0 and off_coll["waits"] == 0
    assert on_syncs == 0 and on_coll["calls"] == 0
    assert on_coll["starts"] >= 1 and on_coll["waits"] >= on_coll["starts"]
    assert on_coll["wait_seconds"] >= 0.0


@pytest.mark.parametrize("case", RING_CASES, ids=lambda c: f"sp{c[0]}-"
                         f"{'causal' if c[1] else 'full'}")
def test_overlapped_ring_equals_the_synchronous_ring(runs, case):
    (sync_out, sync_grads), (out, grads) = runs[0]["ring"][case]
    assert np.array_equal(out, sync_out)
    for got, want in zip(grads, sync_grads):
        assert np.array_equal(got, want)
    j_out, j_grads = runs[2][case]
    np.testing.assert_allclose(out, j_out, atol=ATTN_TOL, rtol=ATTN_TOL)
    for got, want in zip(grads, j_grads):
        np.testing.assert_allclose(got, want, atol=ATTN_TOL, rtol=ATTN_TOL)


@pytest.mark.parametrize("world", [2, 4])
def test_the_ring_leaves_no_hop_alive(runs, world):
    assert runs[0][f"hops left {world}"] == 0


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_a_step_dies_with_its_last_reference(grad_accum):
    """Dropping a step frees its optimizer and the optimizer's moments at
    once, with the cycle collector off: a step that named itself would
    keep them (on the card, a whole model's AdamW state a step) until
    the collector ran."""
    import gc
    import weakref

    config = t_tf.TransformerConfig(**BASE, dtype=torch.float32)
    params = t_tf.init_params(config, seed=0, device="cpu")
    optimizer = t_tf.adamw(params, LR)
    step = t_tf.make_train_step(config, optimizer, grad_accum=grad_accum)
    toks = torch.zeros(2, BASE["max_seq"] + 1, dtype=torch.int64)
    step(params, toks[:, :-1], toks[:, 1:])
    gone = weakref.ref(optimizer)
    gc.collect()
    gc.disable()
    try:
        del step, optimizer
        assert gone() is None
    finally:
        gc.enable()

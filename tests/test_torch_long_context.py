"""Long context in the port: ring and Ulysses attention over ``sp``
(``parallel/ring.py``, ``parallel/ulysses.py``), the transformer and
its train step on a sequence split over ``sp``, and the GPipe pipeline
over ``pp`` (``parallel/pipeline.py``, ``models/transformer.py``
``pipeline_loss_fn``), on gloo process groups of 2 and 4 CPU processes,
against the JAX package's functions under ``shard_map`` on the virtual
CPU devices of this pytest process (its flash attention runs its plain
version on the CPU).

The same numpy-made inputs and weights (the JAX init) go to both sides.
Tolerances: ring and Ulysses outputs 2e-5 (absolute and relative); the
sp transformer losses 1e-4 against JAX's ``shard_map`` loss, as the
JAX package's own tests hold them against the dense loss; the sp train
step over 2 AdamW steps by the rules of ``tests/test_torch_parallel.py``
(1e-5) against the JAX single-device step; ``pipeline_apply`` 1e-5
against sequential application; the pipelined loss and every gradient
5e-4 against JAX's pipelined loss and the dense ``jax.grad``, as
``tests/test_parallel_pp_ep.py`` holds the reference's.

Each world size spawns its processes once (``run_gang``: a file store
under ``tmp_path``, a join deadline, a process-group timeout).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as JP
from test_torch_parallel import run_gang

from dcos_commons_tpu.models import transformer as j_tf
from dcos_commons_tpu.parallel import mesh as j_mesh
from dcos_commons_tpu.parallel.compat import shard_map
from dcos_commons_tpu.parallel.ring import ring_attention as j_ring
from dcos_commons_tpu.parallel.ulysses import ulysses_attention as j_ulysses
from dcos_commons_tpu_torch.models import decode as t_decode
from dcos_commons_tpu_torch.models import transformer as t_tf
from dcos_commons_tpu_torch.parallel import mesh as t_mesh
from dcos_commons_tpu_torch.parallel import pipeline as t_pipe
from dcos_commons_tpu_torch.parallel import sharding
from dcos_commons_tpu_torch.parallel.ring import ring_attention
from dcos_commons_tpu_torch.parallel.ulysses import ulysses_attention
from dcos_commons_tpu_torch.utils.tree import tree_leaves, tree_map

ATTN_TOL = 2e-5
LOSS_TOL = 1e-4
STEP_TOL = 1e-5
PIPE_TOL = 5e-4
STEPS = 2
LR = 3e-4

# the attention cases: (recipe, sp, causal); q/k/v [2, 8, 64, 16]
ATTN_CASES = [(recipe, sp, causal) for recipe in ("ring", "ulysses")
              for sp in (2, 4) for causal in (True, False)]
ATTN_SHAPE = (2, 8, 64, 16)
# the transformer-loss cases: (recipe, MeshSpec fields), 4 processes
LM = dict(vocab=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=4,
          d_ff=128, max_seq=64, remat=False)
LOSS_CASES = [(recipe, mesh) for recipe in ("ring", "ulysses")
              for mesh in ({"sp": 4}, {"sp": 2, "tp": 2})]
# the sp train-step cases: name -> (world, recipe, MeshSpec fields)
STEP_BASE = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=4,
                 d_ff=64, max_seq=16, remat=True, loss_chunk=8)
STEP_BATCH = 4
STEP_CASES = {
    "ring-sp2": (2, "ring", {"sp": 2}),
    "ulysses-sp2": (2, "ulysses", {"sp": 2}),
    "ring-sp2xdp2": (4, "ring", {"dp": 2, "sp": 2}),
    "ulysses-sp2xtp2": (4, "ulysses", {"sp": 2, "tp": 2}),
}
# the pipeline: tests/test_parallel_pp_ep.py's config and batch
PIPE = dict(vocab=128, d_model=64, n_layers=4, n_heads=4, n_kv_heads=4,
            d_ff=128, max_seq=32, remat=False)
PIPE_BATCH = 8
PIPE_CASES = {"pp4": ({"pp": 4}, 4), "pp2xdp2": ({"pp": 2, "dp": 2}, 2)}
APPLY_STAGES = 4


def _recipe(name):
    return {"use_ring_attention": name == "ring",
            "use_ulysses_attention": name == "ulysses"}


def _chunk(a, index, n, axis):
    """Chunk ``index`` of ``n`` of ``a`` (an array or a tensor) along
    ``axis``."""
    size = a.shape[axis] // n
    where = [slice(None)] * a.ndim
    where[axis] = slice(index * size, (index + 1) * size)
    return a[tuple(where)]


# -- what each rank runs -------------------------------------------------------


def _rank_attention(cases, q, k, v):
    """{(recipe, sp, causal): the full output, gathered over sp}."""
    world = torch.distributed.get_world_size()
    mesh = t_mesh.make_mesh(t_mesh.MeshSpec(sp=world))
    i = mesh.index(("sp",))
    out = {}
    for recipe, sp, causal in cases:
        fn = ring_attention if recipe == "ring" else ulysses_attention
        parts = [torch.from_numpy(_chunk(t, i, sp, 2)) for t in (q, k, v)]
        got = fn(*parts, mesh, "sp", causal)
        out[(recipe, sp, causal)] = sharding.unshard(
            got, sharding.P(None, None, "sp", None), mesh).numpy()
    return out


def _rank_loss(cases, params, tokens, targets):
    """{(recipe, mesh): the global mean loss} of ``loss_fn`` on each
    rank's blocks and chunk of the sequence."""
    out = {}
    for recipe, fields in cases:
        config = t_tf.TransformerConfig(**LM, **_recipe(recipe),
                                        dtype=torch.float32)
        mesh = t_mesh.make_mesh(t_mesh.MeshSpec(**fields))
        local = t_tf.shard_params(tree_map(torch.from_numpy, params), config,
                                  mesh)
        i, n = mesh.index(("sp",)), mesh.size(("sp",))
        loss = t_tf.loss_fn(config, local,
                            torch.from_numpy(_chunk(tokens, i, n, 1)).long(),
                            torch.from_numpy(_chunk(targets, i, n, 1)).long(),
                            mesh)
        out[(recipe, tuple(sorted(fields.items())))] = float(
            sharding.batch_mean(loss, mesh))
    return out


def _rank_steps(cases, params, batches):
    """{name: (losses, full params after the steps, the least |g| of
    each param over the steps)}: g is one process's gradient of the
    whole batch at the gang's params before each step."""
    import torch.distributed as dist

    out = {}
    for name, recipe, fields in cases:
        config = t_tf.TransformerConfig(**STEP_BASE, **_recipe(recipe),
                                        dtype=torch.float32)
        plain = t_tf.TransformerConfig(**STEP_BASE, dtype=torch.float32)
        mesh = t_mesh.make_mesh(t_mesh.MeshSpec(**fields))
        local = t_tf.shard_params(tree_map(torch.from_numpy, params), config,
                                  mesh)
        step = t_tf.make_train_step(config, t_tf.adamw(local, LR), mesh=mesh)
        nb, ib = mesh.size(t_mesh.BATCH_AXES), mesh.index(t_mesh.BATCH_AXES)
        ns, js = mesh.size(("sp",)), mesh.index(("sp",))
        losses, small = [], None
        for toks in batches:
            toks = torch.from_numpy(toks.astype(np.int64))
            now = t_tf.unshard_params(local, config, mesh)
            if dist.get_rank() == 0:
                leaves = [t.requires_grad_(True) for t in tree_leaves(now)]
                grads = [g.abs().numpy() for g in torch.autograd.grad(
                    t_tf.loss_fn(plain, now, toks[:, :-1], toks[:, 1:]),
                    leaves)]
                small = grads if small is None else [
                    np.minimum(a, b) for a, b in zip(small, grads)]
            rows = toks[ib * len(toks) // nb:(ib + 1) * len(toks) // nb]
            tokens = _chunk(rows[:, :-1], js, ns, 1)
            targets = _chunk(rows[:, 1:], js, ns, 1)
            losses.append(float(step(local, tokens, targets)))
        out[name] = (losses, tree_map(
            lambda t: t.numpy(), t_tf.unshard_params(local, config, mesh)),
            small)
    return out


def _stage(w, x):
    for i in range(w.shape[0]):
        x = torch.tanh(x @ w[i])
    return x


def _rank_apply(w, x):
    """``pipeline_apply`` of a tanh stack over pp = world, 4 microbatches:
    the merged output of the last stage."""
    world = torch.distributed.get_world_size()
    mesh = t_mesh.make_mesh(t_mesh.MeshSpec(pp=world))
    per = len(w) // world
    i = mesh.index(("pp",))
    local = torch.from_numpy(w[i * per:(i + 1) * per])
    out = t_pipe.pipeline_apply(
        _stage, local, t_pipe.split_microbatches(torch.from_numpy(x), 4),
        mesh)
    return t_pipe.merge_microbatches(
        t_pipe.last_stage_value(out, mesh)).numpy()


def _rank_pipeline(cases, params, tokens, targets):
    """{name: (loss, full gradients)} of ``pipeline_value_and_grad``."""
    config = t_tf.TransformerConfig(**PIPE, dtype=torch.float32)
    specs = t_tf.pipeline_param_specs(config)
    out = {}
    for name, (fields, n_micro) in cases.items():
        mesh = t_mesh.make_mesh(t_mesh.MeshSpec(**fields))
        local = t_tf.shard_params(tree_map(torch.from_numpy, params), config,
                                  mesh, rules=specs)
        for leaf in tree_leaves(local):
            leaf.requires_grad_(True)
        n, i = mesh.size(t_mesh.BATCH_AXES), mesh.index(t_mesh.BATCH_AXES)
        rows = slice(i * PIPE_BATCH // n, (i + 1) * PIPE_BATCH // n)
        loss, grads = t_tf.pipeline_value_and_grad(
            config, local, torch.from_numpy(tokens[rows]).long(),
            torch.from_numpy(targets[rows]).long(), n_micro, mesh)
        full = t_tf.unshard_params(grads, config, mesh, rules=specs)
        out[name] = (float(loss), [g.numpy() for g in tree_leaves(full)])
    return out


def _rank_main(payload):
    out = {}
    for kind, args in payload:
        fn = {"attention": _rank_attention, "loss": _rank_loss,
              "steps": _rank_steps, "apply": _rank_apply,
              "pipeline": _rank_pipeline}[kind]
        out[kind] = fn(*args)
    return out


# -- the JAX side --------------------------------------------------------------


def _jax_attention(recipe, sp, causal, q, k, v):
    mesh = j_mesh.make_mesh(j_mesh.MeshSpec(sp=sp), jax.devices()[:sp])
    if recipe == "ring":
        fn = functools.partial(j_ring, axis_name="sp", causal=causal,
                               axis_size=sp)
    else:
        fn = functools.partial(j_ulysses, axis_name="sp", causal=causal,
                               block_q=32, block_k=32, axis_size=sp)
    spec = JP(None, None, "sp", None)
    with mesh:
        out = shard_map(fn, mesh=mesh, in_specs=(spec,) * 3, out_specs=spec,
                        check_vma=False)(q, k, v)
    return np.asarray(out)


def _jax_loss(recipe, fields, params, tokens, targets):
    config = j_tf.TransformerConfig(**LM, **_recipe(recipe),
                                    dtype=jnp.float32)
    mesh = j_mesh.make_mesh(j_mesh.MeshSpec(**fields), jax.devices()[:4])

    def body(params, tokens, targets):
        return jax.lax.pmean(j_tf.loss_fn(config, params, tokens, targets),
                             "sp")

    with mesh:
        loss = jax.jit(shard_map(
            body, mesh=mesh, in_specs=(JP(), JP(None, "sp"), JP(None, "sp")),
            out_specs=JP(), check_vma=False))(params, tokens, targets)
    return float(loss)


def _jax_steps(batches):
    """The JAX single-device step, 2 AdamW steps from the seed-0 init:
    (full params before, losses, leaves after)."""
    config = j_tf.TransformerConfig(**STEP_BASE, dtype=jnp.float32)
    params = j_tf.init_params(config, jax.random.key(0))
    full = jax.tree.map(lambda a: np.asarray(a).copy(), params)
    optimizer = optax.adamw(LR)
    state = optimizer.init(params)
    step = j_tf.make_train_step(config, optimizer, donate=False)
    losses = []
    for toks in batches:
        params, state, loss = step(params, state, toks[:, :-1], toks[:, 1:])
        losses.append(float(loss))
    return full, losses, [np.asarray(a) for a in jax.tree.leaves(params)]


def _jax_pipeline(fields, n_micro, params, tokens, targets):
    """JAX's pipelined loss (``pmean`` over dp) and its gradients."""
    config = j_tf.TransformerConfig(**PIPE, dtype=jnp.float32)
    mesh = j_mesh.make_mesh(j_mesh.MeshSpec(**fields), jax.devices()[:4])
    batch = JP("dp") if fields.get("dp", 1) > 1 else JP()

    def body(p, t, g):
        local = j_tf.pipeline_loss_fn(config, p, t, g, n_micro=n_micro,
                                      axis_name="pp")
        return jax.lax.pmean(local, "dp")

    with mesh:
        piped = shard_map(
            body, mesh=mesh,
            in_specs=(j_tf.pipeline_param_specs(params), batch, batch),
            out_specs=JP(), check_vma=False)
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: piped(p, tokens, targets)))(params)
    return float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides of every case; the port's in one spawn a world size."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(ATTN_SHAPE).astype(np.float32)
               for _ in range(3))
    jax_side = {"attention": {
        case: _jax_attention(*case, q, k, v) for case in ATTN_CASES}}

    lm_config = j_tf.TransformerConfig(**LM, dtype=jnp.float32)
    lm_params = jax.tree.map(lambda a: np.asarray(a).copy(), j_tf.init_params(
        lm_config, jax.random.key(0)))
    toks = rng.integers(0, LM["vocab"], (2, LM["max_seq"] + 1)).astype(
        np.int32)
    lm_tokens, lm_targets = toks[:, :-1], toks[:, 1:]
    jax_side["loss"] = {
        (recipe, tuple(sorted(fields.items()))): _jax_loss(
            recipe, fields, lm_params, lm_tokens, lm_targets)
        for recipe, fields in LOSS_CASES}
    jax_side["dense loss"] = float(j_tf.loss_fn(lm_config, lm_params,
                                                lm_tokens, lm_targets))

    batches = rng.integers(0, STEP_BASE["vocab"], (
        STEPS, STEP_BATCH, STEP_BASE["max_seq"] + 1)).astype(np.int32)
    step_params, j_losses, j_leaves = _jax_steps(batches)
    jax_side["steps"] = (j_losses, j_leaves)

    w = (rng.standard_normal((APPLY_STAGES * 2, 16, 16)) * 0.3).astype(
        np.float32)
    x = rng.standard_normal((8, 16)).astype(np.float32)
    jax_side["apply"] = _stage(torch.from_numpy(w),
                               torch.from_numpy(x)).numpy()

    pipe_config = j_tf.TransformerConfig(**PIPE, dtype=jnp.float32)
    pipe_params = jax.tree.map(lambda a: np.asarray(a).copy(),
                               j_tf.init_params(pipe_config,
                                                jax.random.key(0)))
    toks = rng.integers(0, PIPE["vocab"], (PIPE_BATCH, PIPE["max_seq"] + 1)
                        ).astype(np.int32)
    p_tokens, p_targets = toks[:, :-1], toks[:, 1:]
    jax_side["pipeline"] = {
        name: _jax_pipeline(fields, n_micro, pipe_params, p_tokens,
                            p_targets)
        for name, (fields, n_micro) in PIPE_CASES.items()}
    dense_loss, dense = jax.value_and_grad(
        lambda p: j_tf.loss_fn(pipe_config, p, p_tokens, p_targets))(
            pipe_params)
    jax_side["dense pipeline"] = (float(dense_loss),
                                  [np.asarray(g) for g in
                                   jax.tree.leaves(dense)])

    payloads = {}
    for world in (2, 4):
        steps = [(n, r, f) for n, (w_, r, f) in STEP_CASES.items()
                 if w_ == world]
        payloads[world] = [
            ("attention", ([c for c in ATTN_CASES if c[1] == world],
                           q, k, v)),
            ("steps", (steps, step_params, batches)),
        ]
    payloads[4] += [
        ("loss", (LOSS_CASES, lm_params, lm_tokens, lm_targets)),
        ("apply", (w, x)),
        ("pipeline", (PIPE_CASES, pipe_params, p_tokens, p_targets)),
    ]
    port = {world: run_gang(tmp_path_factory.mktemp(f"long{world}"), world,
                            "_rank_main", body, module=__name__)
            for world, body in payloads.items()}
    return jax_side, port


@pytest.mark.parametrize("case", ATTN_CASES,
                         ids=lambda c: f"{c[0]}-sp{c[1]}-"
                         f"{'causal' if c[2] else 'full'}")
def test_attention_matches_jax(runs, case):
    jax_side, port = runs
    np.testing.assert_allclose(port[case[1]]["attention"][case],
                               jax_side["attention"][case], atol=ATTN_TOL,
                               rtol=ATTN_TOL)


@pytest.mark.parametrize("case", LOSS_CASES, ids=lambda c: c[0] + "-" + "x".join(
    f"{k}{v}" for k, v in c[1].items()))
def test_sequence_parallel_loss_matches_shard_map(runs, case):
    jax_side, port = runs
    key = (case[0], tuple(sorted(case[1].items())))
    got = port[4]["loss"][key]
    np.testing.assert_allclose(got, jax_side["loss"][key], atol=LOSS_TOL,
                               rtol=LOSS_TOL)
    np.testing.assert_allclose(got, jax_side["dense loss"], atol=LOSS_TOL,
                               rtol=LOSS_TOL)


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_sequence_parallel_step_matches_one_device(runs, name):
    """The rules of tests/test_torch_parallel.py: the loss 1e-5 relative
    at each step, the params 1e-5 where one process's |g| >= 1e-6 at
    both steps, 2 lr a step elsewhere."""
    jax_side, port = runs
    j_losses, j_leaves = jax_side["steps"]
    t_losses, t_params, small = port[STEP_CASES[name][0]]["steps"][name]
    np.testing.assert_allclose(t_losses, j_losses, rtol=STEP_TOL, atol=0)
    t_leaves = tree_leaves(t_params)
    assert len(t_leaves) == len(j_leaves)
    for want, got, g in zip(j_leaves, t_leaves, small):
        tight = g >= 1e-6
        np.testing.assert_allclose(got[tight], want[tight], atol=STEP_TOL,
                                   rtol=STEP_TOL)
        assert np.abs(got - want).max() <= 2 * LR * STEPS * (1 + 1e-4)


def test_pipeline_apply_matches_sequential(runs):
    jax_side, port = runs
    np.testing.assert_allclose(port[4]["apply"], jax_side["apply"],
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", list(PIPE_CASES))
def test_pipeline_loss_and_gradients_match_dense(runs, name):
    jax_side, port = runs
    loss, grads = port[4]["pipeline"][name]
    j_loss, _ = jax_side["pipeline"][name]
    dense_loss, dense = jax_side["dense pipeline"]
    np.testing.assert_allclose(loss, j_loss, atol=PIPE_TOL, rtol=PIPE_TOL)
    np.testing.assert_allclose(loss, dense_loss, atol=PIPE_TOL,
                               rtol=PIPE_TOL)
    assert len(grads) == len(dense)
    for got, want in zip(grads, dense):
        np.testing.assert_allclose(got, want, atol=PIPE_TOL, rtol=PIPE_TOL)


# -- on one process ----------------------------------------------------------------


def test_split_merge_microbatches_roundtrip():
    x = torch.arange(24.0).reshape(8, 3)
    micro = t_pipe.split_microbatches(x, 4)
    assert micro.shape == (4, 2, 3)
    assert torch.equal(t_pipe.merge_microbatches(micro), x)
    with pytest.raises(ValueError, match="not divisible"):
        t_pipe.split_microbatches(x, 3)


def test_refusals():
    """Both recipes at once; the MoE in the pipeline; Ulysses with heads
    sp does not divide, in the function and in ``check_mesh``."""
    with pytest.raises(ValueError, match="ONE sequence-parallel"):
        t_tf.TransformerConfig(use_ring_attention=True,
                               use_ulysses_attention=True)
    moe = t_tf.TransformerConfig(vocab=16, d_model=16, n_layers=2, n_heads=2,
                                 d_ff=16, n_experts=4, dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="not pipelined"):
        t_tf.pipeline_loss_fn(moe, {}, torch.zeros(2, 4, dtype=torch.long),
                              torch.zeros(2, 4, dtype=torch.long), 2, None)
    mesh = t_mesh.Mesh(t_mesh.MeshSpec(sp=4))
    q = torch.zeros(1, 6, 8, 8)
    with pytest.raises(ValueError, match="divisible"):
        ulysses_attention(q, q, q, mesh)
    uly = t_tf.TransformerConfig(vocab=16, d_model=48, n_layers=1, n_heads=6,
                                 d_ff=16, use_ulysses_attention=True,
                                 dtype=torch.float32)
    with pytest.raises(ValueError, match="divisible"):
        t_tf.check_mesh(uly, mesh)


def test_recipe_config_serves_as_without():
    """The cached paths ignore the recipes, as the reference's decode
    does: greedy generation, and a paged prefill chunk and decode steps,
    give the same logits for a config with either recipe as without."""
    base = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=4,
                d_ff=64, max_seq=32, dtype=torch.float32)
    plain = t_tf.TransformerConfig(**base)
    params = t_tf.init_params(plain, seed=0, device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(3).integers(
        0, 64, (2, 7))).long()

    def serve(config):
        tokens = t_decode.generate(config, params, prompt, 5)
        cache = t_decode.init_paged_kv_cache(config, 6, 4, device="cpu")
        table = torch.tensor([1, 2, 3, 0])
        logits, cache = t_decode.paged_prefill_chunk(
            config, params, cache, prompt[:1], table, 0, 7)
        out = [logits]
        tok, pos = logits.argmax(-1), torch.tensor([7])
        for _ in range(2):
            logits, cache = t_decode.paged_decode_step(
                config, params, cache, tok, pos, table[None])
            out.append(logits)
            tok, pos = logits.argmax(-1), pos + 1
        return tokens, out

    want_tokens, want = serve(plain)
    for recipe in ("ring", "ulysses"):
        got_tokens, got = serve(t_tf.TransformerConfig(**base,
                                                       **_recipe(recipe)))
        assert torch.equal(got_tokens, want_tokens)
        assert all(torch.equal(a, b) for a, b in zip(got, want))

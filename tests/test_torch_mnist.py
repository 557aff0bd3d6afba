"""The port's MNIST path (dcos_commons_tpu_torch/models/mlp.py,
utils/data.py ``synthetic_mnist``, frameworks/train_mnist.py) against
the JAX package's, on the CPU.  The same numpy weights (the JAX
``mlp_init``'s, through ``np.asarray``) and the same numpy batch go
through both sides.

Tolerances: f32 logits and loss within 1e-6 (sums of up to 784
products in another order); bf16 logits within 2e-2 (each product's
output is rounded to bf16 on both sides, an ulp is 2^-8 relative, and
XLA fuses the bias add and ReLU where torch rounds after each); three
Adam steps against ``optax.adam(1e-3)``: f32 losses within 1e-6 and
params within 1e-5 wherever the first step's gradient is exactly zero
or at least 1e-7 (ten times Adam's eps).  Below that, the first update
``g / (|g| + eps)`` amplifies the f32 rounding of a gradient that is
nearly zero (-1.52e-9 here against -1.74e-9 in JAX: a sum that
cancels, taken in another order) into up to 2e-5 of a param; there the
params are held within 3 lr, and such elements are fewer than 1 in
1000 (122 of 669,706 here).  bf16 losses
within 2e-2 (torch's Adam and optax round the bf16 moments and the
update in another order: both keep the moments in bf16, as the
reference does)."""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dcos_commons_tpu.models import mlp as j_mlp
from dcos_commons_tpu.utils.data import synthetic_mnist as j_synthetic_mnist
from dcos_commons_tpu_torch.frameworks import train_mnist
from dcos_commons_tpu_torch.models import mlp as t_mlp
from dcos_commons_tpu_torch.models.bridge import (
    mlp_params_from_jax,
    params_to_jax,
)
from dcos_commons_tpu_torch.utils import synthetic_mnist

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
LOGITS_TOL = {"f32": 1e-6, "bf16": 2e-2}
BATCH = 32


def _setup(name, seed=0):
    jdt, tdt = DTYPES[name]
    jparams = j_mlp.mlp_init(j_mlp.MlpConfig(dtype=jdt),
                             jax.random.key(seed))
    tparams = mlp_params_from_jax(jparams, device="cpu", dtype=tdt)
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (BATCH, 784)).astype(np.float32)
    y = rng.integers(0, 10, (BATCH,)).astype(np.int32)
    return jparams, tparams, x, y


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_forward_and_loss_match_jax(name):
    jparams, tparams, x, y = _setup(name)
    want = np.asarray(j_mlp.mlp_forward(jparams, jnp.asarray(x)))
    got = t_mlp.mlp_forward(tparams, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (BATCH, 10)
    tol = LOGITS_TOL[name]
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=tol)
    want_loss = float(j_mlp.mlp_loss(jparams, jnp.asarray(x),
                                     jnp.asarray(y)))
    got_loss = float(t_mlp.mlp_loss(tparams, torch.from_numpy(x),
                                    torch.from_numpy(y)))
    assert abs(got_loss - want_loss) <= tol * (1 + abs(want_loss))


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_three_adam_steps_match_optax(name):
    jparams, tparams, x, y = _setup(name, seed=1)
    optimizer = optax.adam(1e-3)
    opt_state = optimizer.init(jparams)
    j_step = j_mlp.mlp_train_step(optimizer)
    adam = t_mlp.mlp_adam(tparams, 1e-3)
    t_step = t_mlp.mlp_train_step(adam)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    g0 = jax.grad(j_mlp.mlp_loss)(jparams, jnp.asarray(x), jnp.asarray(y))
    for _ in range(3):
        jparams, opt_state, j_loss = j_step(jparams, opt_state,
                                            jnp.asarray(x), jnp.asarray(y))
        t_loss = t_step(tparams, xt, yt)
        if name == "f32":
            assert abs(float(t_loss) - float(j_loss)) <= 1e-6
        else:
            assert abs(float(t_loss) - float(j_loss)) <= 2e-2
    # the moments stay in the params' dtype on both sides
    mu = opt_state[0].mu
    for key, p in tparams.items():
        state = adam.state[p]
        assert state["exp_avg"].dtype == p.dtype
        assert mu[key].dtype == jparams[key].dtype
    if name == "f32":
        tiny = 0
        for key, p in tparams.items():
            got, want = p.detach().numpy(), np.asarray(jparams[key])
            g = np.abs(np.asarray(g0[key]))
            steady = (g >= 1e-7) | (g == 0)
            tiny += int((~steady).sum())
            np.testing.assert_allclose(got[steady], want[steady],
                                       atol=1e-5, rtol=1e-5, err_msg=key)
            assert np.abs(got - want).max() <= 3e-3, key
        assert tiny < sum(p.numel() for p in tparams.values()) / 1000


def test_mlp_tree_crosses_the_bridge_both_ways():
    """``params_to_jax`` carries the flat ``w1..b3`` tree back as it
    carries the transformer's; ``mlp_params_from_jax`` takes it in."""
    jparams, tparams, _, _ = _setup("bf16")
    back = params_to_jax(tparams)
    assert sorted(back) == sorted(jparams)
    for key in jparams:
        assert back[key].dtype == np.asarray(jparams[key]).dtype
        np.testing.assert_array_equal(
            np.asarray(back[key], np.float32),
            np.asarray(jparams[key], np.float32))
    with pytest.raises(ValueError, match="unexpected MLP leaves"):
        mlp_params_from_jax({"w1": jparams["w1"]}, device="cpu")


def test_meta_init_matches_the_jax_shapes():
    for name, (jdt, tdt) in DTYPES.items():
        want = jax.eval_shape(
            lambda k: j_mlp.mlp_init(j_mlp.MlpConfig(dtype=jdt), k),
            jax.random.key(0))
        got = t_mlp.mlp_init(t_mlp.MlpConfig(dtype=tdt), 0, "meta")
        assert sorted(got) == sorted(want)
        for key, leaf in got.items():
            assert leaf.device.type == "meta"
            assert tuple(leaf.shape) == tuple(want[key].shape)
            assert leaf.dtype.itemsize == want[key].dtype.itemsize


def test_synthetic_mnist_shapes_dtypes_and_ranges():
    x, y = synthetic_mnist(256, seed=1, device="cpu")
    jx, jy = j_synthetic_mnist(jax.random.key(1), 256)
    assert x.shape == jx.shape == (256, 784)
    assert y.shape == jy.shape == (256,)
    assert x.dtype == torch.float32 and not y.dtype.is_floating_point
    assert float(x.min()) >= 0.0 and float(x.max()) < 1.0
    assert int(y.min()) >= 0 and int(y.max()) <= 9
    # a seed gives the same batch again, another seed another one
    x2, y2 = synthetic_mnist(256, seed=1, device="cpu")
    assert torch.equal(x, x2) and torch.equal(y, y2)
    assert not torch.equal(x, synthetic_mnist(256, seed=2,
                                              device="cpu")[0])


def test_train_mnist_trains_on_the_cpu_when_asked():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = train_mnist.main({"TORCH_DEVICE": "cpu", "TRAIN_STEPS": "8"})
    lines = out.getvalue().splitlines()
    assert rc == 0, lines
    assert lines[0].startswith("step 0 loss=")
    last = lines[-1]
    assert last.startswith("trained 8 steps on cpu"), last
    first, final = (float(v) for v in last.split("loss ")[1].split(" -> "))
    assert final < first


def test_train_mnist_without_a_card_raises():
    """No ``TORCH_DEVICE``: the card or nothing."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the job would train on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_mnist.main({"TRAIN_STEPS": "1"})

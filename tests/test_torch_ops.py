"""The port's ops (dcos_commons_tpu_torch/ops) against the JAX
package's: the plain PyTorch versions of kernels K1 (RMSNorm) and K2
(flash-attention forward) held against the Pallas kernels run in
interpret mode on the CPU.  The same numpy inputs, made from a seed,
go to both; tolerances are the JAX package's own kernel tests'
(tests/test_workload.py)."""

import numpy as np
import pytest
import torch

from dcos_commons_tpu.ops.attention import _pallas_attention, flash_attention
from dcos_commons_tpu.ops.rmsnorm import rms_norm
from dcos_commons_tpu_torch.ops import attention as t_attention
from dcos_commons_tpu_torch.ops import rmsnorm as t_rmsnorm


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32
    )


@pytest.mark.parametrize("rows", [512, 100])
def test_rms_norm_plain_matches_pallas(rows):
    """512 rows run the Pallas kernel (interpreted); 100 rows do not
    tile 256 and take the JAX package's own plain path."""
    x, w = _normal(0, rows, 128), _normal(1, 128)
    want = np.asarray(rms_norm(x, w, interpret=True, block_rows=256))
    got = t_rmsnorm.rms_norm(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_rms_norm_gradient_is_the_plain_versions():
    """The backward is autograd through the plain version (the JAX
    package's custom VJP recomputes the same reference)."""
    import jax

    x, w = _normal(2, 4, 3, 16), _normal(3, 16)
    g = _normal(4, 4, 3, 16)
    _, vjp = jax.vjp(lambda a, b: rms_norm(a, b), x, w)
    want_x, want_w = vjp(g)
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    t_rmsnorm.rms_norm(xt, wt).backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), want_x, atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), want_w, atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_matches_pallas(causal):
    q, k, v = (_normal(i, 2, 4, 256, 64) for i in (10, 11, 12))
    want = np.asarray(flash_attention(q, k, v, causal=causal,
                                      interpret=True))
    got = t_attention.flash_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal
    )
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_lse_matches_pallas_residual(causal):
    q, k, v = (_normal(i, 1, 2, 256, 64) for i in (20, 21, 22))
    _, lse = _pallas_attention(q, k, v, causal, 128, 128, True,
                               save_residuals=True)
    want = np.asarray(lse)[..., 0]                       # [bh, seq_q]
    o, got = t_attention.flash_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
        return_lse=True,
    )
    assert tuple(got.shape) == (2, 256) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_flash_attention_top_left_causal_when_seq_q_differs():
    """seq_q != seq_k: query i sees keys j <= i (top-left), as the TPU
    kernel masks — not FlashAttention-2's bottom-right alignment."""
    q = _normal(30, 1, 2, 128, 64)
    k, v = _normal(31, 1, 2, 256, 64), _normal(32, 1, 2, 256, 64)
    want = np.asarray(flash_attention(q, k, v, causal=True,
                                      interpret=True))
    got = t_attention.flash_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=True
    )
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    # query 0 sees key 0 only: its output is v[0]
    np.testing.assert_allclose(got.numpy()[0, :, 0], v[0, :, 0],
                               atol=1e-6)


def test_flash_attention_cuda_gradient_is_not_ported():
    """The K3/K4 backward comes with the training slice: a tensor off
    the CPU (here the meta device, which needs no card) that needs a
    gradient raises before any launch."""
    q = torch.zeros(1, 1, 4, 64, device="meta", requires_grad=True)
    with pytest.raises(NotImplementedError, match="K3/K4"):
        t_attention.flash_attention(q, q, q)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The wrappers launch their kernel or raise: a CPU tensor never
    reaches them through the public ops, and called directly they
    refuse it instead of computing anything."""
    x = torch.zeros(4, 64)
    with pytest.raises(ValueError, match="CUDA"):
        t_rmsnorm.rms_norm_kernel(x, x[0])
    with pytest.raises(ValueError, match="CUDA"):
        t_attention.flash_fwd_kernel(x[None], x[None], x[None], True)
    assert t_rmsnorm.rms_norm_kernel.launches == 0
    assert t_attention.flash_fwd_kernel.launches == 0

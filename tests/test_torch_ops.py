"""The port's ops (dcos_commons_tpu_torch/ops) against the JAX
package's: the plain PyTorch versions of kernels K1 (RMSNorm), K2
(flash-attention forward) and K3/K4 (its backward) held against the
Pallas kernels run in interpret mode on the CPU.  The same numpy
inputs, made from a seed, go to both; tolerances are the JAX package's
own kernel tests' (tests/test_workload.py)."""

import numpy as np
import pytest
import torch

from dcos_commons_tpu.ops.attention import (
    _pallas_attention,
    _pallas_attention_bwd,
    flash_attention,
)
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


def _pallas_residuals(q, k, v, causal):
    o, lse = _pallas_attention(q, k, v, causal, 128, 128, True,
                               save_residuals=True)
    return o, lse


@pytest.mark.parametrize("causal", [True, False])
def test_reference_attention_bwd_matches_pallas_bwd(causal):
    """The plain backward K3/K4 are held against, fed the TPU kernels'
    own forward residuals, against ``_pallas_attention_bwd`` (the dq and
    dk/dv kernels, interpreted)."""
    q, k, v, do = (_normal(i, 2, 3, 256, 64) for i in (40, 41, 42, 43))
    o, lse = _pallas_residuals(q, k, v, causal)
    want = _pallas_attention_bwd(q, k, v, o, lse, do, causal, 128, 128,
                                 True)
    got = t_attention.reference_attention_bwd(
        *(torch.from_numpy(np.array(a)) for a in (q, k, v, o)),
        torch.from_numpy(np.array(lse)[..., 0]), torch.from_numpy(do),
        causal,
    )
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-5,
                                   rtol=5e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_gradient_matches_pallas_grad(causal):
    """The CPU autograd path (through the plain version) against
    ``jax.vjp`` of the Pallas custom VJP, interpreted."""
    import jax

    q, k, v, do = (_normal(i, 2, 3, 256, 64) for i in (50, 51, 52, 53))
    _, vjp = jax.vjp(
        lambda a, b, c: flash_attention(a, b, c, causal=causal,
                                        interpret=True, force_pallas=True),
        q, k, v,
    )
    want = vjp(do)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = t_attention.flash_attention(*leaves, causal=causal)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-5,
                                   rtol=5e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_backward_at_a_ragged_length_matches_the_reference_vjp(causal):
    """seq 100 does not tile the TPU kernels' 128 blocks, so the JAX
    package differentiates its dense reference; the port's plain
    backward and its autograd path agree with that VJP."""
    import jax

    from dcos_commons_tpu.parallel.ring import reference_attention

    q, k, v, do = (_normal(i, 1, 2, 100, 64) for i in (60, 61, 62, 63))
    _, vjp = jax.vjp(
        lambda a, b, c: reference_attention(a, b, c, causal), q, k, v
    )
    want = vjp(do)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = t_attention.flash_attention(tq, tk, tv, causal,
                                         return_lse=True)
    plain = t_attention.reference_attention_bwd(tq, tk, tv, o, lse, tdo,
                                                causal)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    auto = torch.autograd.grad(
        t_attention.flash_attention(*leaves, causal=causal), leaves, tdo
    )
    for g_plain, g_auto, w in zip(plain, auto, want):
        np.testing.assert_allclose(g_plain.numpy(), np.asarray(w),
                                   atol=5e-5, rtol=5e-5)
        np.testing.assert_allclose(g_auto.numpy(), np.asarray(w),
                                   atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("bh,seq,hd,causal", [
    (2, 200, 128, True), (2, 200, 128, False), (8, 100, 64, True),
    (8, 100, 64, False), (16, 257, 128, True),
])
def test_bf16_backward_limit_catches_a_backward_without_operand_rounding(
        bh, seq, hd, causal):
    """chip_smoke.py holds K3/K4 in bf16 to a relative Frobenius error
    (``TOL``).  A backward that drops the TPU kernels' rounding of ds
    and p to the operand dtype (here: the plain backward run on the f32
    values of the same bf16 inputs, its outputs rounded to bf16) lands
    more than twice beyond that limit at the phase 2b shapes."""
    import chip_smoke

    limit = chip_smoke.TOL[("K3/K4", torch.bfloat16)]
    q, k, v, do = (torch.from_numpy(_normal(70 + i, 1, bh, seq, hd))
                   .to(torch.bfloat16) for i in range(4))
    o, lse = t_attention.flash_attention(q, k, v, causal, return_lse=True)
    want = t_attention.reference_attention_bwd(q, k, v, o, lse, do, causal)
    unrounded = t_attention.reference_attention_bwd(
        *(t.float() for t in (q, k, v, o)), lse, do.float(), causal
    )
    for name, u, w in zip(("dq", "dk", "dv"), unrounded, want):
        err = ((u.to(torch.bfloat16).float() - w.float()).norm()
               / w.float().norm()).item()
        assert err > 2 * limit, (name, err, limit)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The wrappers launch their kernel or raise: a CPU tensor never
    reaches them through the public ops, and called directly they
    refuse it instead of computing anything."""
    x = torch.zeros(4, 64)
    with pytest.raises(ValueError, match="CUDA"):
        t_rmsnorm.rms_norm_kernel(x, x[0])
    with pytest.raises(ValueError, match="CUDA"):
        t_attention.flash_fwd_kernel(x[None], x[None], x[None], True)
    rows = torch.zeros(1, 4)
    with pytest.raises(ValueError, match="CUDA"):
        t_attention.flash_dq_kernel(*(x[None],) * 4, rows, rows, True)
    with pytest.raises(ValueError, match="CUDA"):
        t_attention.flash_dkv_kernel(*(x[None],) * 4, rows, rows, True)
    assert t_rmsnorm.rms_norm_kernel.launches == 0
    assert t_attention.flash_fwd_kernel.launches == 0
    assert t_attention.flash_dq_kernel.launches == 0
    assert t_attention.flash_dkv_kernel.launches == 0

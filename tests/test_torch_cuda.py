"""The port's hand-written kernels on the card: K1 (Triton RMSNorm) and
K2 (CUDA flash-attention forward) against their plain PyTorch versions,
their launch counters, and the checks their wrappers make.  Marked
``cuda``: they skip on a host without a CUDA card.  On the card, where
JAX (which tests/conftest.py imports) need not be installed:
``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_cuda.py -q``."""

import pytest
import torch

from dcos_commons_tpu_torch.ops import attention, rmsnorm

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


# (atol, rtol) as chip_smoke.py states them
_K1_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1.6e-2, 1.6e-2)}
_TOL = {torch.float32: (2e-5, 2e-4), torch.bfloat16: (1.6e-2, 1.6e-2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(1, 2048), (37, 2048), (300, 96)])
def test_rms_norm_kernel_matches_plain(gen, dtype, rows, d):
    x = torch.randn(rows, d, device="cuda", generator=gen).to(dtype)
    w = torch.randn(d, device="cuda", generator=gen).to(dtype)
    before = rmsnorm.rms_norm_kernel.launches
    got = rmsnorm.rms_norm(x, w)
    assert rmsnorm.rms_norm_kernel.launches == before + 1
    torch.testing.assert_close(got, rmsnorm._reference(x, w),
                               atol=_K1_TOL[dtype][0],
                               rtol=_K1_TOL[dtype][1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("sq,sk,causal", [(1, 1, True), (77, 77, True),
                                          (130, 70, False),
                                          (50, 200, True)])
def test_flash_kernel_matches_plain(gen, dtype, hd, sq, sk, causal):
    q = torch.randn(2, 3, sq, hd, device="cuda", generator=gen).to(dtype)
    k = torch.randn(2, 3, sk, hd, device="cuda", generator=gen).to(dtype)
    v = torch.randn(2, 3, sk, hd, device="cuda", generator=gen).to(dtype)
    before = attention.flash_fwd_kernel.launches
    o, lse = attention.flash_attention(q, k, v, causal, return_lse=True)
    assert attention.flash_fwd_kernel.launches == before + 1
    atol, rtol = _TOL[dtype]
    torch.testing.assert_close(
        o, attention.reference_attention(q, k, v, causal), atol=atol,
        rtol=rtol,
    )
    torch.testing.assert_close(lse, attention.reference_lse(q, k, causal),
                               atol=1e-4, rtol=1e-5)


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    x = torch.randn(4, 8, 96, device="cuda", generator=gen)
    with pytest.raises(ValueError, match="head_dim"):
        attention.flash_fwd_kernel(x, x, x, True)
    with pytest.raises(ValueError, match="contiguous"):
        attention.flash_fwd_kernel(*(x[:, :, :64],) * 3, True)
    xt = torch.randn(96, 8, device="cuda", generator=gen).t()
    with pytest.raises(ValueError, match="contiguous"):
        rmsnorm.rms_norm_kernel(xt, xt[0].contiguous())
    q = torch.randn(1, 1, 8, 64, device="cuda", requires_grad=True)
    with pytest.raises(NotImplementedError, match="K3/K4"):
        attention.flash_attention(q, q, q)

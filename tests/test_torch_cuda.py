"""The port's hand-written kernels on the card: K1 (Triton RMSNorm), K2
(CUDA flash-attention forward), K3 and K4 (CUDA flash-attention dq and
dk/dv) against their plain PyTorch versions, the autograd Function's
gradients against the plain ones, their launch counters, and the checks
their wrappers make.  Marked
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


def _bwd_error(got, want, dtype):
    """f32: max abs error; bf16: relative Frobenius error."""
    diff = (got.float() - want.float())
    if dtype == torch.float32:
        return diff.abs().max().item()
    return (diff.norm() / want.float().norm()).item()


# K3/K4 against the plain backward, as chip_smoke.py states them: f32
# max abs error (sums of up to 2048 products in another order, twice
# nested); bf16 relative Frobenius error (ds and p are rounded to bf16
# on both sides: the sound kernels read up to 4.9e-5, a backward
# without that rounding 2.4e-3 to 2.7e-3)
_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-4}
# the autograd Function against autograd through reference_attention,
# which keeps ds and p in f32: bf16 holds the 2.4e-3 to 2.7e-3 of the
# operand rounding and the forward's own rounding of o
_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# chip_smoke.py phase 2b's shapes, and two with seq_q != seq_k
_BWD_SHAPES = [
    (192, 2048, 2048, 128, True, torch.bfloat16),
    *[(bh, s, s, hd, causal, dtype)
      for bh, s, hd in ((2, 200, 128), (8, 100, 64))
      for causal in (True, False)
      for dtype in (torch.float32, torch.bfloat16)],
    (16, 257, 257, 128, True, torch.bfloat16),
    (4, 70, 130, 64, True, torch.float32),
    (4, 130, 70, 128, True, torch.float32),
]


@pytest.mark.parametrize("bh,sq,sk,hd,causal,dtype", _BWD_SHAPES)
def test_backward_kernels_match_plain(gen, bh, sq, sk, hd, causal, dtype):
    q = torch.randn(bh, sq, hd, device="cuda", generator=gen).to(dtype)
    k = torch.randn(bh, sk, hd, device="cuda", generator=gen).to(dtype)
    v = torch.randn(bh, sk, hd, device="cuda", generator=gen).to(dtype)
    do = torch.randn(bh, sq, hd, device="cuda", generator=gen).to(dtype)
    o, lse = attention.flash_fwd_kernel(q, k, v, causal, True)
    before = (attention.flash_dq_kernel.launches,
              attention.flash_dkv_kernel.launches)
    got = attention.flash_bwd(q, k, v, o, lse, do, causal)
    assert (attention.flash_dq_kernel.launches,
            attention.flash_dkv_kernel.launches) == (before[0] + 1,
                                                     before[1] + 1)
    want = attention.reference_attention_bwd(
        *(t[None] for t in (q, k, v, o)), lse, do[None], causal
    )
    torch.cuda.synchronize()
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w[0].shape
        err = _bwd_error(g, w[0], dtype)
        assert err <= _BWD_TOL[dtype], (name, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_autograd_gradients_match_plain(gen, dtype, causal):
    shape = (2, 3, 150, 64)
    q, k, v, do = (
        torch.randn(shape, device="cuda", generator=gen).to(dtype)
        for _ in range(4)
    )
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = attention.flash_attention(*leaves, causal=causal)
    got = torch.autograd.grad(out, leaves, do)
    ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(
        attention.reference_attention(*ref, causal), ref, do
    )
    for g, w in zip(got, want):
        assert _bwd_error(g, w, dtype) <= _GRAD_TOL[dtype]


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    x = torch.randn(4, 8, 96, device="cuda", generator=gen)
    with pytest.raises(ValueError, match="head_dim"):
        attention.flash_fwd_kernel(x, x, x, True)
    with pytest.raises(ValueError, match="contiguous"):
        attention.flash_fwd_kernel(*(x[:, :, :64],) * 3, True)
    xt = torch.randn(96, 8, device="cuda", generator=gen).t()
    with pytest.raises(ValueError, match="contiguous"):
        rmsnorm.rms_norm_kernel(xt, xt[0].contiguous())
    y = torch.randn(4, 8, 64, device="cuda", generator=gen)
    rows = torch.zeros(4, 8, device="cuda")
    with pytest.raises(ValueError, match="lse/di"):
        attention.flash_dq_kernel(y, y, y, y, rows.double(), rows, True)
    with pytest.raises(ValueError, match="do not match"):
        attention.flash_dkv_kernel(y, y, y, y[:, :4], rows, rows, True)


def test_prefetcher_stages_batches_on_the_card(gen, tmp_path):
    """Pinned host buffers, a side stream and an event: the batches
    that reach the consumer's stream equal the host stream's."""
    import numpy as np

    from dcos_commons_tpu_torch.data import DevicePrefetcher, TokenDataset
    from dcos_commons_tpu_torch.data.loader import write_token_shard

    rng = np.random.default_rng(1)
    write_token_shard(str(tmp_path / "a.tokens"), rng.integers(0, 99, 4000))
    want = TokenDataset(str(tmp_path), 64).batches(8, start_step=3)
    got = DevicePrefetcher(
        TokenDataset(str(tmp_path), 64).batches(8, start_step=3), "cuda"
    )
    try:
        for _ in range(5):
            (wt, wy), (gt, gy) = next(want), next(got)
            assert gt.is_cuda and gt.dtype == torch.int64
            assert torch.equal(gt.cpu(), torch.from_numpy(wt).long())
            assert torch.equal(gy.cpu(), torch.from_numpy(wy).long())
    finally:
        got.close()


def test_inflight_window_waits_on_the_drained_step_only(gen):
    """A CUDA loss is copied to pinned host memory when pushed; the
    drained value is that copy, equal to the loss."""
    from dcos_commons_tpu_torch.trace.steplog import InflightWindow

    class Recorder:
        def __init__(self):
            self.steps = []

        def record(self, step, **fields):
            self.steps.append(step)

    rec = Recorder()
    window = InflightWindow(rec, 2)
    losses = [torch.randn((), device="cuda", generator=gen) for _ in range(4)]
    drained = []
    for i, loss in enumerate(losses):
        drained += window.push(i, loss * 2, 0.0)
    drained += window.drain()
    assert [s for s, _ in drained] == [0, 1, 2, 3] == rec.steps
    for (_, host), loss in zip(drained, losses):
        assert host.device.type == "cpu"
        assert float(host) == float(loss * 2)

"""The port's hand-written kernels on the card: K1 (CUDA RMSNorm), K2
(CUDA flash-attention forward), K3 and K4 (CUDA flash-attention dq and
dk/dv) against their plain PyTorch versions -- K1 also at widths and
alignments that take its scalar loop and in f16, the bf16 K2-K4
(wgmma + TMA) also at the edges of their tiles, with seq_q != seq_k,
across heads and run to run -- the autograd Function's
gradients against the plain ones, their launch counters, and the checks
their wrappers make.  The MoE path in f32, card against CPU: moe_ffn
(both dispatches) and one MoE train step, routing first (each test
prints the CPU run's smallest top-k probability margin).  The MNIST MLP
card against CPU, f32 and bf16: its forward and three Adam steps.  Long
context on two ranks of the card over gloo: the ring hop
(``ppermute``) on CUDA tensors, and Ulysses attention against the CPU.
Marked ``cuda``: they skip on a host without a CUDA card.  On the card, where
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


# (atol, rtol) as chip_smoke.py states them; f16, which only these tests
# run: the output is rounded once to f16 on both sides, so a tie may
# land one ulp (2^-11 relative) apart, as bf16's may land 2^-8 apart
_K1_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1.6e-2, 1.6e-2),
           torch.float16: (2e-3, 2e-3)}
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


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("rows", [1, 4096])
@pytest.mark.parametrize("d", [2048, 96, 2047, 8192])
def test_k1_at_widths_rows_and_alignments(gen, d, rows, dtype, offset):
    """K1's vector path (d a multiple of the 16-byte vector, every
    pointer aligned: 2048 and 96) and its scalar loop (2047; 8192, wider
    than the vectors a lane holds in f32, bf16 and f16; and x starting
    one element off 16-byte alignment)."""
    flat = torch.randn(rows * d + offset, device="cuda", generator=gen)
    x = flat.to(dtype)[offset:].view(rows, d)
    assert (x.data_ptr() % 16 != 0) == bool(offset)
    w = (1 + 0.1 * torch.randn(d, device="cuda", generator=gen)).to(dtype)
    before = rmsnorm.rms_norm_kernel.launches
    got = rmsnorm.rms_norm_kernel(x, w)
    assert rmsnorm.rms_norm_kernel.launches == before + 1
    torch.testing.assert_close(got, rmsnorm._reference(x, w),
                               atol=_K1_TOL[dtype][0],
                               rtol=_K1_TOL[dtype][1])


def test_k1_refuses_mixed_dtypes(gen):
    x = torch.randn(4, 64, device="cuda", generator=gen)
    with pytest.raises(ValueError, match="one dtype"):
        rmsnorm.rms_norm_kernel(x.to(torch.bfloat16), x[0])


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
# on both sides: the sound kernels read up to 1.9e-4, a backward
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


# The bf16 K2-K4 (wgmma + TMA) at the edges of their tiles: 128-row Q
# tiles and K/V ring stages in K2, 128-row K tiles and 64-row Q ring
# stages in K4, 128-row Q tiles and 64-row K/V ring stages in K3, 16-wide
# wgmma steps; lengths around each, where a ragged tile or a permuted
# register fragment would show
_TILE_LENGTHS = [1, 15, 63, 64, 65, 127, 128, 129, 200]


def _bwd_case(gen, bh, sq, sk, hd, causal):
    """Operands of K3 and K4 with lse, di and o from the plain forward,
    and the plain backward's (dq, dk, dv)."""
    q, do = (torch.randn(bh, sq, hd, device="cuda", generator=gen)
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(bh, sk, hd, device="cuda", generator=gen)
            .to(torch.bfloat16) for _ in range(2))
    o = attention.reference_attention(q[None], k[None], v[None], causal)[0]
    lse = attention.reference_lse(q[None], k[None], causal)
    di = (do.float() * o.float()).sum(-1)
    want = attention.reference_attention_bwd(
        q[None], k[None], v[None], o[None], lse, do[None], causal)
    return (q, k, v, do, lse, di), tuple(w[0] for w in want)


def _floored_error(got, want, floor):
    """bf16 relative Frobenius error with the denominator floored."""
    want = want.float()
    return ((got.float() - want).norm()
            / torch.maximum(want.norm(), floor)).item()


def _k4_errors(got, want):
    """bf16 relative Frobenius errors of (dk, dv) against the plain
    (dq, dk, dv).  dk's denominator has a floor of 1% of ||dv||: where
    every query sees a single key (length 1), ds = p (dp - di) cancels
    to rounding noise on both sides and dk is that noise, not a
    quantity to hold to a relative limit."""
    dk, dv = got
    _, dk_w, dv_w = want
    floor = 1e-2 * dv_w.float().norm()
    return (_floored_error(dk, dk_w, floor),
            _floored_error(dv, dv_w, torch.zeros_like(floor)))


def _k3_error(dq, want):
    """bf16 relative Frobenius error of dq against the plain (dq, dk,
    dv), its denominator floored at 1% of ||dv|| as dk's is: dq = scale
    ds k cancels to the same noise where a query sees a single key."""
    dq_w, _, dv_w = want
    return _floored_error(dq, dq_w, 1e-2 * dv_w.float().norm())


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", _TILE_LENGTHS)
def test_k2_bf16_matches_plain_at_tile_edges(gen, s, causal, hd):
    q, k, v = (torch.randn(3, s, hd, device="cuda", generator=gen)
               .to(torch.bfloat16) for _ in range(3))
    o, lse = attention.flash_fwd_kernel(q, k, v, causal, True)
    q4, k4, v4 = q[None], k[None], v[None]
    torch.testing.assert_close(
        o[None], attention.reference_attention(q4, k4, v4, causal),
        atol=_TOL[torch.bfloat16][0], rtol=_TOL[torch.bfloat16][1])
    torch.testing.assert_close(lse, attention.reference_lse(q4, k4, causal),
                               atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", _TILE_LENGTHS)
def test_k4_bf16_matches_plain_at_tile_edges(gen, s, causal, hd):
    args, want = _bwd_case(gen, 3, s, s, hd, causal)
    got = attention.flash_dkv_kernel(*args, causal)
    torch.cuda.synchronize()
    for name, err in zip(("dk", "dv"), _k4_errors(got, want)):
        assert err <= _BWD_TOL[torch.bfloat16], (name, err)


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", _TILE_LENGTHS)
def test_k3_bf16_matches_plain_at_tile_edges(gen, s, causal, hd):
    args, want = _bwd_case(gen, 3, s, s, hd, causal)
    before = attention.flash_dq_kernel.launches
    dq = attention.flash_dq_kernel(*args, causal)
    assert attention.flash_dq_kernel.launches == before + 1
    torch.cuda.synchronize()
    assert dq.dtype == torch.bfloat16 and dq.shape == want[0].shape
    err = _k3_error(dq, want)
    assert err <= _BWD_TOL[torch.bfloat16], err


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", [(100, 260), (260, 100)])
def test_bf16_kernels_match_plain_when_seq_q_differs(gen, sq, sk, causal,
                                                     hd):
    """Top-left causal: with seq_q < seq_k the last K tiles see no query
    (K4 writes zeros there); with seq_q > seq_k the last queries see
    every key."""
    q = torch.randn(2, sq, hd, device="cuda", generator=gen).to(
        torch.bfloat16)
    k, v = (torch.randn(2, sk, hd, device="cuda", generator=gen)
            .to(torch.bfloat16) for _ in range(2))
    o, lse = attention.flash_fwd_kernel(q, k, v, causal, True)
    torch.testing.assert_close(
        o[None], attention.reference_attention(q[None], k[None], v[None],
                                               causal),
        atol=_TOL[torch.bfloat16][0], rtol=_TOL[torch.bfloat16][1])
    torch.testing.assert_close(
        lse, attention.reference_lse(q[None], k[None], causal), atol=1e-4,
        rtol=1e-5)
    args, want = _bwd_case(gen, 2, sq, sk, hd, causal)
    got = attention.flash_dkv_kernel(*args, causal)
    for name, err in zip(("dk", "dv"), _k4_errors(got, want)):
        assert err <= _BWD_TOL[torch.bfloat16], (name, err)
    err = _k3_error(attention.flash_dq_kernel(*args, causal), want)
    assert err <= _BWD_TOL[torch.bfloat16], ("dq", err)


def _bf16_heads(gen, bh, s, hd, big):
    """[bh, s, hd] bf16 with every head but the middle one scaled to
    large values."""
    x = torch.randn(bh, s, hd, device="cuda", generator=gen)
    x[torch.arange(bh, device="cuda") != bh // 2] *= big
    return x.to(torch.bfloat16)


@pytest.mark.parametrize("hd", [64, 128])
def test_bf16_kernels_keep_heads_apart(gen, hd):
    """A ragged last tile must read zeros past its own head, not the
    next head's rows: each head of a bh = 3 launch equals, bit for bit,
    the launch on that head alone, with the neighbours of the middle
    head filled with large values."""
    s = 129
    q, k, v, do = (_bf16_heads(gen, 3, s, hd, 300.0) for _ in range(4))
    o, lse = attention.flash_fwd_kernel(q, k, v, True, True)
    di = (do.float() * o.float()).sum(-1)
    dk, dv = attention.flash_dkv_kernel(q, k, v, do, lse, di, True)
    dq = attention.flash_dq_kernel(q, k, v, do, lse, di, True)
    for h in range(3):
        one = [t[h:h + 1].contiguous() for t in (q, k, v, do)]
        rows = (lse[h:h + 1].contiguous(), di[h:h + 1].contiguous())
        o1, lse1 = attention.flash_fwd_kernel(*one[:3], True, True)
        dk1, dv1 = attention.flash_dkv_kernel(*one, *rows, True)
        dq1 = attention.flash_dq_kernel(*one, *rows, True)
        assert torch.equal(o1, o[h:h + 1]) and torch.equal(lse1, lse[h:h + 1])
        assert torch.equal(dk1, dk[h:h + 1]) and torch.equal(dv1, dv[h:h + 1])
        assert torch.equal(dq1, dq[h:h + 1])


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_kernels_are_deterministic(gen, causal):
    """No atomics: two launches give the same bits."""
    q, k, v, do = (torch.randn(4, 300, 128, device="cuda", generator=gen)
                   .to(torch.bfloat16) for _ in range(4))
    o, lse = attention.flash_fwd_kernel(q, k, v, causal, True)
    o2, lse2 = attention.flash_fwd_kernel(q, k, v, causal, True)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    di = (do.float() * o.float()).sum(-1)
    first = attention.flash_dkv_kernel(q, k, v, do, lse, di, causal)
    second = attention.flash_dkv_kernel(q, k, v, do, lse, di, causal)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert torch.equal(attention.flash_dq_kernel(q, k, v, do, lse, di, causal),
                       attention.flash_dq_kernel(q, k, v, do, lse, di, causal))


def test_bf16_wrappers_refuse_unaligned_pointers(gen):
    """TMA needs 16-byte aligned base pointers: a contiguous view that
    starts one element into its storage is refused, not launched."""
    flat = torch.randn(2 * 64 * 64 + 1, device="cuda", generator=gen).to(
        torch.bfloat16)
    x = flat[1:].view(2, 64, 64)
    assert x.is_contiguous() and x.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        attention.flash_fwd_kernel(x, x, x, True)
    rows = torch.zeros(2, 64, device="cuda")
    with pytest.raises(ValueError, match="16-byte"):
        attention.flash_dkv_kernel(x, x, x, x, rows, rows, True)
    with pytest.raises(ValueError, match="16-byte"):
        attention.flash_dq_kernel(x, x, x, x, rows, rows, True)


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


# -- the MoE path, card against CPU in f32 ----------------------------------


@pytest.fixture
def no_tf32(gen):
    """f32 products in f32 on the card, as on the CPU."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield gen
    torch.backends.cuda.matmul.allow_tf32 = saved


def _routing_margin(probs, k):
    """The smallest gap between neighbouring router probabilities among
    a token's first k + 1: how near its routing is to a tie."""
    top = probs.topk(k + 1, dim=-1).values
    return (top[..., :-1] - top[..., 1:]).min().item()


@pytest.mark.parametrize("impl", ["onehot", "sorted"])
def test_moe_ffn_card_matches_cpu(no_tf32, impl):
    """moe_ffn at the MoE flagship's expert shape (d 2048, 4 experts of
    d_ff 2048, top-2, capacity 1.25) over two groups of 256 tokens:
    routing equal, outputs within 1e-5 + 1e-5 relative, aux within
    1e-6 (f32 sums in another order)."""
    from dcos_commons_tpu_torch.models import moe

    config = moe.MoEConfig(d_model=2048, d_ff=2048, n_experts=4, top_k=2,
                           capacity_factor=1.25, dtype=torch.float32)
    params = moe.init_moe_params(config, torch.Generator().manual_seed(0),
                                 torch.device("cpu"))
    x = torch.randn(2, 256, 2048, generator=torch.Generator().manual_seed(1))
    card = {n: t.cuda() for n, t in params.items()}
    _, idx_c, probs_c, _ = moe._route(config, params, x)
    _, idx_g, _, _ = moe._route(config, card, x.cuda())
    print(f"moe_ffn {impl}: smallest CPU top-2 margin "
          f"{_routing_margin(probs_c, 2):.3e}")
    assert torch.equal(idx_g.cpu(), idx_c)
    want_y, want_aux = moe.moe_ffn(config, params, x, impl=impl)
    got_y, got_aux = moe.moe_ffn(config, card, x.cuda(), impl=impl)
    torch.testing.assert_close(got_y.cpu(), want_y, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got_aux.cpu(), want_aux, atol=1e-6, rtol=0)


def test_moe_train_step_card_matches_cpu(no_tf32):
    """One f32 MoE train step (2 layers, d 256, 4 heads of 64: the FMA
    kernels K2-K4 on the card; two routing groups a row, full remat) on
    the card against the CPU: routing equal at every call, forward and
    remat recompute, then the loss within 1e-5 relative and every
    gradient leaf, the router's included, within 1e-4 relative
    Frobenius error."""
    from dcos_commons_tpu_torch.models import moe
    from dcos_commons_tpu_torch.models import transformer as tf
    from dcos_commons_tpu_torch.utils.tree import tree_leaves, tree_map

    config = tf.TransformerConfig(
        vocab=512, d_model=256, n_layers=2, n_heads=4, n_kv_heads=4,
        d_ff=256, max_seq=128, n_experts=4, moe_capacity_factor=1.25,
        moe_group_size=64, dtype=torch.float32, remat=True)
    cpu_params = tf.init_params(config, seed=2, device="cpu")
    toks = torch.randint(0, 512, (2, 129),
                         generator=torch.Generator().manual_seed(2))
    inner, out = moe._route, {}
    for dev in ("cuda", "cpu"):
        calls = []

        def route(*args):
            r = inner(*args)
            calls.append((r[1].cpu(), r[2].cpu()))
            return r

        params = tree_map(lambda t: t.to(dev), cpu_params)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        moe._route = route
        try:
            loss = tf.loss_fn(config, params, toks[:, :-1].to(dev),
                              toks[:, 1:].to(dev))
            grads = torch.autograd.grad(loss, leaves)
        finally:
            moe._route = inner
        out[dev] = (loss.item(), [g.cpu() for g in grads], calls)
    (loss_g, grads_g, calls_g), (loss_c, grads_c, calls_c) = (
        out["cuda"], out["cpu"])
    assert len(calls_g) == len(calls_c) == 4     # 2 forwards, 2 recomputes
    margin = min(_routing_margin(probs, 2) for _, probs in calls_c)
    print(f"MoE train step: smallest CPU top-2 margin {margin:.3e}")
    for (idx_g, _), (idx_c, _) in zip(calls_g, calls_c):
        assert torch.equal(idx_g, idx_c)
    assert abs(loss_g - loss_c) <= 1e-5 * abs(loss_c)
    for g, c in zip(grads_g, grads_c):
        assert ((g - c).norm() / c.norm()).item() <= 1e-4


# -- long context: two ranks on the card, joined by gloo ---------------------


def _mlp_pair(dtype, seed=0):
    """The same MLP weights and batch on the card and on the CPU."""
    from dcos_commons_tpu_torch.models import mlp

    cpu = mlp.mlp_init(mlp.MlpConfig(dtype=dtype), seed, "cpu")
    card = {k: v.to("cuda") for k, v in cpu.items()}
    x, y = synthetic_mnist_cpu(seed)
    return cpu, card, x, y


def synthetic_mnist_cpu(seed):
    from dcos_commons_tpu_torch.utils import synthetic_mnist

    return synthetic_mnist(256, seed=seed + 1, device="cpu")


# card against CPU: f32 (TF32 off) sums of up to 784 products in
# another order, bf16 one bf16 ulp (2^-8 relative) of a logit and the
# loss through it
_MLP_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
_MLP_LATER_LOSS = 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlp_forward_card_matches_cpu(no_tf32, dtype):
    from dcos_commons_tpu_torch.models import mlp

    cpu, card, x, y = _mlp_pair(dtype)
    tol = _MLP_TOL[dtype]
    got = mlp.mlp_forward(card, x.cuda())
    assert got.is_cuda and got.dtype == torch.float32
    torch.testing.assert_close(got.cpu(), mlp.mlp_forward(cpu, x),
                               atol=tol, rtol=tol)
    assert abs(float(mlp.mlp_loss(card, x.cuda(), y.cuda()))
               - float(mlp.mlp_loss(cpu, x, y))) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlp_adam_steps_card_match_cpu(no_tf32, dtype):
    """Three Adam steps.  f32 params after the first step within 1e-5 +
    1e-5 |p| wherever its gradient is zero or at least 1e-7 (below,
    Adam's first update amplifies a nearly-zero gradient's rounding, as
    tests/test_torch_mnist.py states), within 2 lr elsewhere; the losses
    within the forward's tolerance, and those of steps 2 and 3 in f32
    within ``_MLP_LATER_LOSS``: after a sign-like Adam step a hidden
    unit's input can sit near zero, and the two sides' roundings then
    take its ReLU to either side (on the CPU, f32 against f64 from
    ``mlp_init`` seed 0 moved 1.7e-3 of a param and 8.6e-6 of the
    third loss that way)."""
    from dcos_commons_tpu_torch.models import mlp

    cpu, card, x, y = _mlp_pair(dtype)
    keys = sorted(cpu)
    for key in keys:
        cpu[key].requires_grad_(True)
    grads = torch.autograd.grad(mlp.mlp_loss(cpu, x, y),
                                [cpu[k] for k in keys])
    g0 = {k: g.abs() for k, g in zip(keys, grads)}
    steps = [mlp.mlp_train_step(mlp.mlp_adam(p, 1e-3)) for p in (cpu, card)]
    for i in range(3):
        want = float(steps[0](cpu, x, y))
        got = float(steps[1](card, x.cuda(), y.cuda()))
        tol = (_MLP_TOL[dtype] if i == 0 or dtype != torch.float32
               else _MLP_LATER_LOSS)
        assert abs(got - want) <= tol, (i, got, want)
        if i or dtype != torch.float32:
            continue
        for key, p in card.items():
            diff = (p.detach().cpu() - cpu[key].detach()).abs()
            steady = (g0[key] >= 1e-7) | (g0[key] == 0)
            limit = 1e-5 + 1e-5 * cpu[key].detach().abs()
            assert bool((diff <= limit)[steady].all()), key
            assert float(diff.max()) <= 2e-3, key


def _pair_rank(rank, store, case, results):
    """One of two ranks on card 0 over gloo: ``case`` "ppermute" or
    "ulysses"; puts (rank, result, error)."""
    import traceback

    try:
        import datetime

        import torch.distributed as dist

        from dcos_commons_tpu_torch.parallel import sharding
        from dcos_commons_tpu_torch.parallel.mesh import MeshSpec, make_mesh
        from dcos_commons_tpu_torch.parallel.ulysses import ulysses_attention

        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group("gloo", init_method="file://" + store,
                                world_size=2, rank=rank,
                                timeout=datetime.timedelta(seconds=120))
        mesh = make_mesh(MeshSpec(sp=2))
        if case == "ppermute":
            out = {}
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.full((3, 5), rank + 1.0, device="cuda",
                               dtype=dtype, requires_grad=True)
                y = sharding.ppermute(x, mesh, ("sp",))
                (g,) = torch.autograd.grad((y * (rank + 1)).sum(), x)
                out[str(dtype)] = (y.device.type, y.dtype == dtype,
                                   y[0, 0].item(), g[0, 0].item())
        else:
            gen = torch.Generator().manual_seed(0)
            q, k, v = (torch.randn(2, 4, 256, 64, generator=gen)
                       for _ in range(3))
            w = torch.randn(2, 4, 128, 64, generator=gen)
            sl = slice(rank * 128, (rank + 1) * 128)
            runs = {}
            for dev in ("cuda", "cpu"):
                parts = [t[:, :, sl].to(dev).requires_grad_(True)
                         for t in (q, k, v)]
                before = attention.flash_fwd_kernel.launches
                o = ulysses_attention(*parts, mesh, "sp", True)
                grads = torch.autograd.grad((o * w.to(dev)).sum(), parts)
                # numpy: a tensor in the queue would be shared through a
                # file descriptor that dies with this process
                runs[dev] = ([o.detach().cpu().numpy()]
                             + [g.cpu().numpy() for g in grads],
                             attention.flash_fwd_kernel.launches - before)
            out = runs
        dist.destroy_process_group()
        results.put((rank, out, None))
    except BaseException:  # noqa: BLE001 — reported to the parent
        results.put((rank, None, traceback.format_exc()))


def _on_two_ranks(tmp_path, case):
    """Both ranks' results of ``_pair_rank``; every process ends within
    its deadline."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    store = str(tmp_path / "store")
    procs = [ctx.Process(target=_pair_rank, args=(r, store, case, results))
             for r in range(2)]
    for p in procs:
        p.start()
    out = {}
    try:
        for _ in procs:
            rank, result, error = results.get(timeout=240)
            assert error is None, f"rank {rank}:\n{error}"
            out[rank] = result
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    return out


def test_ppermute_on_the_card_over_gloo(gen, tmp_path):
    """The ring hop on CUDA tensors (f32 and bf16) over gloo: each rank
    gets the other's tensor on the card, and the gradient takes the
    trip back (rank r's output is scaled by r + 1, so its input's
    gradient is the other rank's scale)."""
    out = _on_two_ranks(tmp_path, "ppermute")
    for rank in (0, 1):
        other = 1 - rank
        for dtype in ("torch.float32", "torch.bfloat16"):
            assert out[rank][dtype] == ("cuda", True, other + 1.0,
                                        other + 1.0)


def test_ulysses_on_the_card_matches_cpu(no_tf32, tmp_path):
    """Ulysses over sp2 in f32 on the card (the all-to-alls over gloo,
    K2 forward and K3/K4 backward on each rank's 2 heads of the whole
    sequence) against the same on the CPU (the plain version): output
    within K2's f32 tolerance, the gradients within 1e-4 (K3/K4's f32
    limit in chip_smoke.py), K2 launched once a rank."""
    out = _on_two_ranks(tmp_path, "ulysses")
    for rank in (0, 1):
        (card, launches), (cpu, cpu_launches) = (out[rank]["cuda"],
                                                 out[rank]["cpu"])
        assert launches == 1 and cpu_launches == 0
        card, cpu = ([torch.from_numpy(a) for a in run]
                     for run in (card, cpu))
        atol, rtol = _TOL[torch.float32]
        torch.testing.assert_close(card[0], cpu[0], atol=atol, rtol=rtol)
        for got, want in zip(card[1:], cpu[1:]):
            torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)

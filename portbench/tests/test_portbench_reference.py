"""The plain reference against itself at a tiny size: causal logits, the
MoE capacity rule, the layer-by-layer training step against autograd
through the whole model, and its AdamW against torch's."""

import math

import pytest
import torch
import torch.nn.functional as F

from portbench.lib.counts import Geometry
from portbench.reference import model as ref

DENSE = Geometry(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
                 head_dim=8, d_ff=48, rope_theta=1e4, eps=1e-6,
                 dtype="float32")
MOE = Geometry(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
               head_dim=8, d_ff=48, n_experts=4, top_k=2,
               capacity_factor=1.0, group_size=16, aux_coef=0.02,
               rope_theta=1e4, eps=1e-6, dtype="float32")


@pytest.mark.parametrize("g", [DENSE, MOE], ids=["dense", "moe"])
def test_logits_of_a_prefix_equal_the_full_forward(g):
    """What prefill then decode through a cache computes: each
    position's logits from the tokens before it alone."""
    params = ref.make_reference_params(g, 7, "cpu")
    seq = torch.randint(0, g.vocab, (24,), generator=torch.Generator()
                        .manual_seed(1)).tolist()
    full = ref.logits(g, params, seq, 0)
    for k in (1, 5, 13, 24):
        part = ref.logits(g, params, seq[:k], 0)
        # drop-free routing routes each token alone, so a prefix routes
        # as it does inside the whole sequence
        torch.testing.assert_close(part, full[:k], atol=2e-5, rtol=2e-5)


def test_moe_capacity_keeps_first_choices_first():
    g = Geometry(vocab=8, d_model=4, n_layers=1, n_heads=1, n_kv_heads=1,
                 head_dim=4, d_ff=2, n_experts=2, top_k=2,
                 capacity_factor=0.5, group_size=4, dtype="float32")
    # router: expert 0 is every token's first choice, expert 1 second
    w = {"router": torch.tensor([[4.0, 0.0]] * 4),
         "w_gate": torch.ones(2, 4, 2), "w_up": torch.ones(2, 4, 2),
         "w_down": torch.ones(2, 2, 4)}
    x = torch.ones(1, 4, 4)
    y, _ = ref.moe(g, w, x, None, None)
    # capacity 0.5 * 2 * 4 / 2 = 2: tokens 0 and 1 reach expert 0 and,
    # with expert 1's two slots, their second choices too; tokens 2
    # and 3 are dropped from both
    assert (y[0, :2].abs() > 0).all()
    torch.testing.assert_close(y[0, 2:], torch.zeros(2, 4))
    # drop-free: every token gets both choices
    y_all, _ = ref.moe(g, w, x, 4, None)
    torch.testing.assert_close(y_all[0, 2:], y_all[0, :2])


def _whole_model_loss(g, params, tokens, targets):
    x = params["embed"][tokens]
    aux_total = 0.0
    for i in range(g.n_layers):
        w = {k[len("layers/"):]: v[i] for k, v in params.items()
             if k.startswith("layers/")}
        rows = [ref.layer(g, w, x[r:r + 1]) for r in range(x.shape[0])]
        x = torch.cat([y for y, _ in rows])
        aux_total = aux_total + sum(a for _, a in rows) / x.shape[0]
    lg = ref.rms_norm(x, params["final_norm"], g.eps) @ params["embed"].T
    loss = F.cross_entropy(lg.reshape(-1, g.vocab), targets.reshape(-1))
    if g.n_experts:
        loss = loss + g.aux_coef * aux_total / g.n_layers
    return loss


@pytest.mark.parametrize("g", [DENSE, MOE], ids=["dense", "moe"])
def test_layer_by_layer_step_equals_autograd(g):
    params = ref.make_reference_params(g, 11, "cpu")
    gen = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, g.vocab, (2, 32), generator=gen)
    targets = torch.randint(0, g.vocab, (2, 32), generator=gen)
    leaves = {p: t.clone().requires_grad_(True) for p, t in params.items()}
    loss = _whole_model_loss(g, leaves, tokens, targets)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    out = ref.train_steps(g, params, [(tokens, targets)])
    assert out["losses"][0] == pytest.approx(loss.item(), rel=1e-5)
    for p, gr in grads.items():
        assert out["first_grad"][p] == pytest.approx(float(gr.norm()),
                                                     rel=1e-4, abs=1e-9), p


def test_adamw_matches_torch():
    p0 = torch.randn(5, 7, generator=torch.Generator().manual_seed(0))
    grads = [torch.randn(5, 7, generator=torch.Generator().manual_seed(s))
             for s in (1, 2, 3)]
    mine = {"w": p0.clone()}
    opt = ref.AdamW(mine)
    theirs = p0.clone().requires_grad_(True)
    torch_opt = torch.optim.AdamW([theirs], lr=3e-4, betas=(0.9, 0.999),
                                  eps=1e-8, weight_decay=1e-4)
    for gr in grads:
        opt.t += 1
        opt.update(mine["w"], opt.m["w"], opt.v["w"], gr)
        theirs.grad = gr.clone()
        torch_opt.step()
    torch.testing.assert_close(mine["w"], theirs.detach(), atol=1e-7,
                               rtol=1e-6)


def test_fp8_control_rounds_products_and_their_gradients():
    x = torch.randn(16, 32, generator=torch.Generator().manual_seed(5))
    w = torch.randn(32, 8, generator=torch.Generator().manual_seed(6))
    q = ref.fp8_e4m3(x, -1)
    rel = ((q - x).norm() / x.norm()).item()
    assert 1e-3 < rel < 0.1          # e4m3 keeps 3 mantissa bits
    leaf = x.clone().requires_grad_(True)
    ref.fp8_e4m3(leaf, -1).sum().backward()
    torch.testing.assert_close(leaf.grad, torch.ones_like(x))
    xs, ws = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    out = ref._mm(xs, ws, ref.FP8)
    torch.testing.assert_close(out, ref.fp8_e4m3(x, -1) @ ref.fp8_e4m3(w, -2))
    grad = torch.randn(16, 8, generator=torch.Generator().manual_seed(7))
    out.backward(grad)
    g5 = ref.fp8_e5m2(grad, -1)
    torch.testing.assert_close(xs.grad, g5 @ ref.fp8_e4m3(w, -2).T)
    torch.testing.assert_close(ws.grad, ref.fp8_e4m3(x, -1).T @ g5)
    assert not torch.equal(g5, grad) and math.isfinite(rel)

"""The plain reference of the benchmark's decoders, in float32 PyTorch.

Written from the published descriptions of Mistral-7B and Mixtral-8x7B
(the Hugging Face ``MistralForCausalLM`` / ``MixtralForCausalLM``
layers) and the ``assumed`` list of each configuration file, with no
kernel, cache or batching and nothing of the port:

- RMSNorm with statistics in f32, ``x * rsqrt(mean(x^2) + eps) * w``;
- half-split rotary embeddings (``rotate_half``) at positions 0..s-1;
- grouped-query causal attention, each KV head read by ``n_heads /
  n_kv_heads`` consecutive query heads, softmax scaled by
  ``head_dim^-0.5``;
- SwiGLU, ``(silu(x Wg) * (x Wu)) Wd``;
- Mixtral's FFN: an f32 router, softmax over the experts, the top-k
  renormalised (equal to Mixtral's softmax over the top-k logits); as
  assumed for the port, tokens route in groups (``moe_group_size``),
  each expert takes at most ``capacity`` of a group's choices, first
  choices before second ones and in token order, and a dropped choice
  adds nothing; the switch load-balancing term ``E * mean(top-1 share
  x mean probability)`` averaged over groups and layers;
- the head tied to the embedding (as assumed for the port), in f32.

Every product runs in f32 with TF32 off.  ``quant`` set (the control,
one precision below the configuration's bf16) runs the products as an
fp8 recipe would: each operand of every projection, expert and head
product rounded to e4m3 (a scale per row of the activations and per
column of the weights) and the gradients entering their backward
products to e5m2 (the MoE router's product too); attention's q, k, v
and probabilities rounded to e4m3, their gradients passed straight
through.

Training follows the port's step: mean next-token NLL (plus the MoE
term), gradients of every leaf, then AdamW (decoupled weight decay,
bias-corrected moments) with the state held as the configuration
states it: parameters and both moments in the parameters' dtype, the
update worked out in f32.  To fit at the timed sizes the step runs
layer by layer: a forward that keeps each layer's input, the head and
loss a row at a time, then each layer recomputed under autograd a row
at a time, its gradients applied to its own slice of every stacked
leaf as soon as they exist.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from portbench.lib.counts import Geometry
from portbench.lib.sketch import sketch
from portbench.lib.weights import leaf_specs, make_leaf

Quant = bool
FP8 = True  # the control
Q_BLOCK = 1024  # query rows of attention scored at once


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _rounded(x: torch.Tensor, dim: int, dtype, top: float) -> torch.Tensor:
    """``x`` scaled slice by slice along ``dim`` to ``dtype``'s range by
    its largest magnitude, rounded to ``dtype`` and back to f32."""
    with torch.no_grad():
        s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / top
        return (x / s).to(dtype).to(torch.float32) * s


def fp8_e4m3(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Rounded to e4m3; the gradient passes the rounding unchanged."""
    q = _rounded(x, dim, torch.float8_e4m3fn, 448.0)
    return x + (q - x).detach() if x.requires_grad else q


def fp8_e5m2(x: torch.Tensor, dim: int) -> torch.Tensor:
    return _rounded(x, dim, torch.float8_e5m2, 57344.0)


class _Fp8Product(torch.autograd.Function):
    """``x [..., k] @ w [k, n]`` from e4m3 operands; the backward's
    products take the incoming gradient in e5m2."""

    @staticmethod
    def forward(ctx, x, w):
        xq, wq = fp8_e4m3(x.detach(), -1), fp8_e4m3(w.detach(), -2)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, grad):
        xq, wq = ctx.saved_tensors
        gq = fp8_e5m2(grad, -1)
        gw = xq.reshape(-1, xq.shape[-1]).T @ gq.reshape(-1, gq.shape[-1])
        return gq @ wq.T, gw


def _mm(x: torch.Tensor, w: torch.Tensor, quant: Quant) -> torch.Tensor:
    return _Fp8Product.apply(x, w) if quant else x @ w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [b, s, heads, hd] at positions 0..s-1, halves rotated."""
    s, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    inv = 1.0 / (theta ** (torch.arange(0, half, device=x.device,
                                        dtype=torch.float32) * 2 / hd))
    ang = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] * inv
    cos = torch.cat([ang.cos(), ang.cos()], -1)[None, :, None, :]
    sin = torch.cat([ang.sin(), ang.sin()], -1)[None, :, None, :]
    rot = torch.cat([-x[..., half:], x[..., :half]], -1)
    return x * cos + rot * sin


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              quant: Quant = False) -> torch.Tensor:
    """Causal GQA: q [b, s, h, hd], k/v [b, s, kv, hd] -> [b, s, h*hd].
    Query rows in blocks; a block scores only the keys it can see."""
    if quant:
        q, k, v = (fp8_e4m3(t, -1) for t in (q, k, v))
    b, s, h, hd = q.shape
    kv = k.shape[2]
    rep = h // kv
    qg = q.reshape(b, s, kv, rep, hd) * hd ** -0.5
    out = []
    for q0 in range(0, s, Q_BLOCK):
        q1 = min(q0 + Q_BLOCK, s)
        scores = torch.einsum("bqkrd,blkd->bkrql", qg[:, q0:q1], k[:, :q1])
        mask = (torch.arange(q0, q1, device=q.device)[:, None]
                >= torch.arange(q1, device=q.device)[None, :])
        scores = scores.masked_fill(~mask, float("-inf"))
        p = torch.softmax(scores, dim=-1)
        if quant:
            p = fp8_e4m3(p, -1)
        out.append(torch.einsum("bkrql,blkd->bqkrd", p, v[:, :q1]))
    return torch.cat(out, 1).reshape(b, s, h * hd)


def swiglu(x, wg, wu, wd, quant: Quant):
    return _mm(F.silu(_mm(x, wg, quant)) * _mm(x, wu, quant), wd, quant)


def routing_groups(g: Geometry, s: int) -> int:
    """Tokens of one routing group: the row when it is no longer than
    ``moe_group_size``, else that size where it divides the row."""
    gs = g.group_size
    return s if s <= gs else (gs if s % gs == 0 else s)


def moe(g: Geometry, w: Dict[str, torch.Tensor], x: torch.Tensor,
        capacity: Optional[int], quant: Quant):
    """x [b, s, d] -> (y [b, s, d], the load-balancing term averaged
    over groups).  ``capacity`` None: the configuration's; a group's
    size: drop-free."""
    b, s, d = x.shape
    e, k = g.n_experts, g.top_k
    t = routing_groups(g, s)
    h = x.reshape(-1, t, d)
    probs = torch.softmax(_mm(h, w["router"], quant), dim=-1)   # [G, t, E]
    top, idx = torch.topk(probs, k, dim=-1)                  # [G, t, k]
    gates = top / top.sum(-1, keepdim=True)
    share = F.one_hot(idx[..., 0], e).float().mean(1)        # [G, E]
    aux = (e * (share * probs.mean(1)).mean(-1)).mean()
    cap = capacity if capacity is not None else max(
        int(g.capacity_factor * k * t / e), 1)
    # a choice's place in its expert's queue: all first choices, in
    # token order, then all second choices
    flat = idx.transpose(1, 2).reshape(idx.shape[0], k * t)  # [G, k*t]
    hot = F.one_hot(flat, e)
    place = (hot.cumsum(1) - 1).gather(-1, flat[..., None])[..., 0]
    keep = (place < cap).reshape(-1, k, t).transpose(1, 2)   # [G, t, k]
    y = torch.zeros_like(h)
    for j in range(e):
        picked = (idx == j) & keep
        rows = picked.any(-1)
        if not bool(rows.any()):
            continue
        gate = (gates * picked).sum(-1)[rows]
        out = swiglu(h[rows], w["w_gate"][j], w["w_up"][j], w["w_down"][j],
                     quant)
        y = y.index_put((rows,), y[rows] + gate[:, None] * out)
    return y.reshape(b, s, d), aux


def layer(g: Geometry, w: Dict[str, torch.Tensor], x: torch.Tensor,
          capacity: Optional[int] = None, quant: Quant = False):
    """One decoder layer on f32 x [b, s, d]: (x, the MoE term or 0)."""
    b, s, _ = x.shape
    hd = g.head_dim
    h = rms_norm(x, w["attn_norm"], g.eps)
    q = _mm(h, w["wq"], quant).reshape(b, s, g.n_heads, hd)
    k = _mm(h, w["wk"], quant).reshape(b, s, g.n_kv_heads, hd)
    v = _mm(h, w["wv"], quant).reshape(b, s, g.n_kv_heads, hd)
    q, k = rope(q, g.rope_theta), rope(k, g.rope_theta)
    x = x + _mm(attention(q, k, v, quant), w["wo"], quant)
    h = rms_norm(x, w["mlp_norm"], g.eps)
    if g.n_experts:
        y, aux = moe(g, w, h, capacity, quant)
        return x + y, aux
    return x + swiglu(h, w["w_gate"], w["w_up"], w["w_down"], quant), \
        x.new_zeros(())


LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm",
              "router", "w_gate", "w_up", "w_down")


def layer_weights(params: Dict[str, torch.Tensor], i: int,
                  grad: bool = False) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s f32 copy of every stacked leaf."""
    out = {}
    for key in LAYER_KEYS:
        leaf = params.get("layers/" + key)
        if leaf is not None:
            out[key] = leaf[i].to(torch.float32, copy=True).requires_grad_(
                grad)
    return out


def make_reference_params(g: Geometry, seed: int, device
                          ) -> Dict[str, torch.Tensor]:
    """The benchmark's weights from the seed, path -> leaf, in the
    dtype they are stored in."""
    return {path: make_leaf(g, seed, i, device)
            for i, (path, *_r) in enumerate(leaf_specs(g))}


# -- serving: logits of a sequence ----------------------------------------

@torch.no_grad()
def logits(g: Geometry, params: Dict[str, torch.Tensor],
           tokens: Sequence[int], first: int, quant: Quant = False
           ) -> torch.Tensor:
    """f32 logits ``[len(tokens) - first, vocab]`` of positions
    ``first ..`` of one sequence (drop-free routing, as served)."""
    dev = params["embed"].device
    ids = torch.as_tensor(list(tokens), device=dev, dtype=torch.long)[None]
    x = params["embed"][ids].float()
    cap = ids.shape[1] if g.n_experts else None
    for i in range(g.n_layers):
        x, _ = layer(g, layer_weights(params, i), x, cap, quant)
    h = rms_norm(x[0, first:], params["final_norm"].float(), g.eps)
    return _mm(h, params["embed"].float().T, quant)


# -- training: the step, AdamW, the readings --------------------------------

class AdamW:
    """AdamW as the port configures it (``models/transformer.py``
    ``adamw``): lr 3e-4, betas (0.9, 0.999), eps 1e-8, weight decay
    1e-4 applied as ``p *= 1 - lr * wd`` before the moment update."""

    def __init__(self, params: Dict[str, torch.Tensor], lr=3e-4,
                 betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4):
        self.lr, self.betas, self.eps, self.wd = lr, betas, eps, weight_decay
        self.m = {p: torch.zeros_like(t) for p, t in params.items()}
        self.v = {p: torch.zeros_like(t) for p, t in params.items()}
        self.t = 0

    def update(self, param: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
               grad: torch.Tensor) -> None:
        """One leaf (or one layer's slice of one), in place, with the
        step count of the step being taken."""
        b1, b2 = self.betas
        t = self.t
        p32, g = param.float(), grad.float()
        p32 = p32 * (1.0 - self.lr * self.wd)
        m32 = b1 * m.float() + (1.0 - b1) * g
        v32 = b2 * v.float() + (1.0 - b2) * g * g
        denom = (v32.sqrt() / math.sqrt(1.0 - b2 ** t)) + self.eps
        p32 = p32 - (self.lr / (1.0 - b1 ** t)) * m32 / denom
        param.copy_(p32)
        m.copy_(m32)
        v.copy_(v32)


def train_steps(g: Geometry, params: Dict[str, torch.Tensor],
                batches: Sequence[tuple], quant: Quant = False,
                opt: Optional[AdamW] = None, sketch_seed: int = 0) -> dict:
    """Follow the port's training steps over ``batches`` ((tokens,
    targets) [b, s] long, on the params' device), updating ``params``
    in place.  Returns the losses of each step, and each leaf's gradient
    norm and sketch (``lib/sketch.py``, directions from
    ``sketch_seed``) at the first step."""
    opt = opt or AdamW(params)
    losses: List[float] = []
    first_grad: Dict[str, float] = {}
    first_sketch: Dict[str, torch.Tensor] = {}
    for step, (tokens, targets) in enumerate(batches):
        opt.t += 1
        sk = {} if step == 0 else None
        sq = _one_step(g, params, opt, tokens, targets, quant, losses,
                       sk, sketch_seed)
        if step == 0:
            first_grad = {p: math.sqrt(v) for p, v in sq.items()}
            first_sketch = sk
    return {"losses": losses, "first_grad": first_grad,
            "first_sketch": first_sketch}


def _one_step(g, params, opt, tokens, targets, quant, losses, sk=None,
              sketch_seed=0) -> Dict[str, float]:
    b, s = tokens.shape
    n_layers = g.n_layers
    sq: Dict[str, float] = {p: 0.0 for p in params}
    acts: List[Optional[torch.Tensor]] = []
    aux_total = 0.0
    with torch.no_grad():
        x = params["embed"][tokens].float()
        for i in range(n_layers):
            acts.append(x)
            w = layer_weights(params, i)
            rows = [layer(g, w, x[r:r + 1], None, quant) for r in range(b)]
            x = torch.cat([y for y, _ in rows])
            aux_total += float(sum(a for _, a in rows)) / b
            del w, rows
    # the head and the loss, a row at a time
    embed = params["embed"].to(torch.float32, copy=True).requires_grad_(True)
    final = params["final_norm"].to(torch.float32, copy=True).requires_grad_(
        True)
    gx = torch.zeros_like(x)
    nll = torch.zeros((), device=x.device)
    for r in range(b):
        xr = x[r].detach().requires_grad_(True)
        lg = _mm(rms_norm(xr, final, g.eps), embed.T, quant)
        row = -torch.log_softmax(lg, -1).gather(
            -1, targets[r][:, None])[:, 0].sum()
        (row / (b * s)).backward()
        gx[r] = xr.grad
        nll += row.detach()
        del lg, row, xr
    loss = float(nll) / (b * s)
    if g.n_experts:
        loss += g.aux_coef * aux_total / n_layers
    losses.append(loss)
    _apply(opt, params, "final_norm", final.grad, sq, None, sk, sketch_seed)
    del x
    # each layer recomputed under autograd, its gradients applied
    for i in reversed(range(n_layers)):
        w = layer_weights(params, i, grad=True)
        gin = torch.empty_like(gx)
        for r in range(b):
            xr = acts[i][r:r + 1].detach().requires_grad_(True)
            y, aux = layer(g, w, xr, None, quant)
            obj = (y * gx[r:r + 1]).sum()
            if g.n_experts:
                obj = obj + (g.aux_coef / n_layers) * aux / b
            obj.backward()
            gin[r] = xr.grad[0]
            del y, aux, obj, xr
        acts[i] = None
        gx = gin
        for key, t in w.items():
            _apply(opt, params, "layers/" + key, t.grad, sq, i, sk,
                   sketch_seed)
        del w
    embed.grad.index_add_(0, tokens.reshape(-1), gx.reshape(-1, g.d_model))
    _apply(opt, params, "embed", embed.grad, sq, None, sk, sketch_seed)
    return sq


def _apply(opt: AdamW, params, path: str, grad: torch.Tensor,
           sq: Dict[str, float], i: Optional[int] = None,
           sk: Optional[dict] = None, sketch_seed: int = 0) -> None:
    sq[path] += float(grad.float().pow(2).sum())
    if sk is not None:
        part = sketch(grad, sketch_seed, path, i)
        sk[path] = part if path not in sk else sk[path] + part
    p, m, v = params[path], opt.m[path], opt.v[path]
    if i is not None:
        p, m, v = p[i], m[i], v[i]
    opt.update(p, m, v, grad)


def change_norms(g: Geometry, params: Dict[str, torch.Tensor], seed: int
                 ) -> Dict[str, float]:
    """Each leaf's norm of its change from the seed's weights."""
    out = {}
    for i, (path, *_r) in enumerate(leaf_specs(g)):
        p0 = make_leaf(g, seed, i, params[path].device)
        out[path] = float((params[path].float() - p0.float()).norm())
        del p0
    return out

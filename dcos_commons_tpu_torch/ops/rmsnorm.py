"""RMSNorm: kernel K1 (Triton) and its plain PyTorch version.

K1 replaces the TPU kernel ``dcos_commons_tpu/ops/rmsnorm.py::_kernel``
(launched by ``_pallas_rms_norm``): ``y = x * rsqrt(mean(x^2) + eps) * w``
over the last axis, statistics in f32, output in x's dtype.

What bounds it on the H100: memory.  Each element is read once and
written once (2 bytes each way in bf16) for about four flops, two
orders of magnitude under the card's flop/byte ridge, so the least time
is the bytes over 3.35 TB/s.  The design moves each byte once: one
program per row loads the whole row (``BLOCK_D = next_pow2(d)``) with
one masked, coalesced load into registers, reduces the sum of squares
in f32 there, and stores the scaled row once.  Any row count works (the
TPU launcher needed rows % 256 == 0 and fell back otherwise); the mask
covers any width.

The backward pass recomputes through autograd on the plain version, as
the JAX package's custom VJP does (no backward kernel exists there).
The module does not import triton; the kernel is built at its first
launch, so the module imports on a host without it.
"""

import torch

EPS = 1e-6

# triton.language, bound at the kernel's first build: the jitted body
# below resolves ``tl`` in this module's globals when it compiles
tl = None
_kernel_fn = None


def _reference(x: torch.Tensor, w: torch.Tensor, eps: float = EPS
               ) -> torch.Tensor:
    """The plain version: f32 statistics, output in x's dtype."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def _build_kernel():
    global tl, _kernel_fn
    if _kernel_fn is not None:
        return _kernel_fn
    from dcos_commons_tpu_torch.device import import_triton

    triton = import_triton()
    import triton.language as language

    tl = language

    @triton.jit
    def _rms_norm_fwd(x_ptr, w_ptr, y_ptr, stride_x, stride_y, d, eps,
                      BLOCK_D: tl.constexpr):
        row = tl.program_id(0)
        cols = tl.arange(0, BLOCK_D)
        mask = cols < d
        x = tl.load(x_ptr + row * stride_x + cols, mask=mask,
                    other=0.0).to(tl.float32)
        var = tl.sum(x * x, axis=0) / d
        w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        y = x / tl.sqrt(var + eps) * w
        tl.store(y_ptr + row * stride_y + cols,
                 y.to(y_ptr.dtype.element_ty), mask=mask)

    _kernel_fn = _rms_norm_fwd
    return _kernel_fn


def rms_norm_kernel(x: torch.Tensor, w: torch.Tensor, eps: float = EPS
                    ) -> torch.Tensor:
    """Launch K1 on ``x [rows, d]`` (CUDA, contiguous, f32/bf16/f16)
    and ``w [d]``; returns y in x's dtype.  Counts its launches in
    ``rms_norm_kernel.launches``."""
    if not (x.is_cuda and w.is_cuda and x.device == w.device):
        raise ValueError("rms_norm_kernel needs x and w on one CUDA device")
    if x.dim() != 2 or w.dim() != 1 or w.shape[0] != x.shape[1]:
        raise ValueError(
            f"rms_norm_kernel takes x [rows, d] and w [d], got "
            f"{tuple(x.shape)} and {tuple(w.shape)}"
        )
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise ValueError(f"rms_norm_kernel: unsupported dtype {x.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rms_norm_kernel needs contiguous x and w")
    rows, d = x.shape
    y = torch.empty_like(x)
    if rows == 0:
        return y
    block_d = max(16, 1 << (d - 1).bit_length())
    kernel = _build_kernel()
    # triton raises on a refused launch (its launcher checks the
    # CUDA driver's return code), so no launch goes unnoticed
    kernel[(rows,)](
        x, w, y, x.stride(0), y.stride(0), d, eps,
        BLOCK_D=block_d, num_warps=min(16, max(1, block_d // 256)),
    )
    rms_norm_kernel.launches += 1
    return y


rms_norm_kernel.launches = 0


class _RMSNormFn(torch.autograd.Function):
    """K1 forward; backward through autograd on the plain version."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return rms_norm_kernel(x, w, eps)

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        with torch.enable_grad():
            x_ = x.detach().requires_grad_(True)
            w_ = w.detach().requires_grad_(True)
            gx, gw = torch.autograd.grad(
                _reference(x_, w_, ctx.eps), (x_, w_), grad
            )
        return gx, gw, None


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = EPS
             ) -> torch.Tensor:
    """RMSNorm over the last axis; any leading shape.  Differentiable.

    A CPU tensor takes the plain version; a CUDA tensor takes K1."""
    shape = x.shape
    flat = x.reshape(-1, shape[-1])
    if flat.device.type == "cpu":
        return _reference(flat, w, eps).reshape(shape)
    flat = flat.contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        out = _RMSNormFn.apply(flat, w.contiguous(), eps)
    else:
        out = rms_norm_kernel(flat, w.contiguous(), eps)
    return out.reshape(shape)

"""RMSNorm: kernel K1 (CUDA C++, ``csrc/rmsnorm.cu``) and its plain
PyTorch version.

K1 replaces the TPU kernel ``dcos_commons_tpu/ops/rmsnorm.py::_kernel``
(launched by ``_pallas_rms_norm``): ``y = x * rsqrt(mean(x^2) + eps) * w``
over the last axis, statistics in f32, output in x's dtype.  The source
note in ``csrc/rmsnorm.cu`` says what bounds it on the H100 and what its
design does about that.

At the decode and train-worker shapes the device work is a few
microseconds, so the wrapper is kept lean: the C entry point's
signature is declared once, the checks read plain attributes (the
device as an index), the launch is one ctypes call on the raw handle of
PyTorch's current stream, and no device context is entered when x's
device is already the current one.

The backward pass recomputes through autograd on the plain version, as
the JAX package's custom VJP does (no backward kernel exists there).
"""

import ctypes

import torch

EPS = 1e-6
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_lib = None


def _reference(x: torch.Tensor, w: torch.Tensor, eps: float = EPS
               ) -> torch.Tensor:
    """The plain version: f32 statistics, output in x's dtype."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def _library():
    """The built ``csrc/rmsnorm.cu`` with its C signatures declared."""
    global _lib
    if _lib is None:
        from dcos_commons_tpu_torch.device import cuda_library

        lib = cuda_library("rmsnorm")
        vp, i = ctypes.c_void_p, ctypes.c_int
        # x, w, y, rows, d, dtype, eps, stream
        lib.rmsnorm_fwd.argtypes = [vp, vp, vp, i, i, i, ctypes.c_float, vp]
        lib.rmsnorm_fwd.restype = i
        lib.rmsnorm_error_string.argtypes = [i]
        lib.rmsnorm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def rms_norm_kernel(x: torch.Tensor, w: torch.Tensor, eps: float = EPS
                    ) -> torch.Tensor:
    """Launch K1 on ``x [rows, d]`` (CUDA, contiguous, f32/bf16/f16)
    and ``w [d]`` of x's dtype; returns y in x's dtype.  Counts its
    launches in ``rms_norm_kernel.launches``."""
    dev = x.get_device()                   # -1 for a CPU tensor
    if dev < 0 or w.get_device() != dev:
        raise ValueError("rms_norm_kernel needs x and w on one CUDA device")
    if x.dim() != 2 or w.dim() != 1 or w.shape[0] != x.shape[1]:
        raise ValueError(
            f"rms_norm_kernel takes x [rows, d] and w [d], got "
            f"{tuple(x.shape)} and {tuple(w.shape)}"
        )
    code = _DTYPE_CODE.get(x.dtype)
    if code is None or w.dtype != x.dtype:
        raise ValueError(
            f"rms_norm_kernel takes f32, bf16 or f16 x and w of one dtype, "
            f"got {x.dtype} and {w.dtype}"
        )
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rms_norm_kernel needs contiguous x and w")
    rows, d = x.shape
    y = torch.empty_like(x)
    if rows == 0 or d == 0:
        return y
    lib = _library()
    args = (x.data_ptr(), w.data_ptr(), y.data_ptr(), rows, d, code, eps)
    if dev == torch.cuda.current_device():
        # the raw handle of PyTorch's current stream on x's device, read
        # without building a torch.cuda.Stream object for each call
        err = lib.rmsnorm_fwd(*args, torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            err = lib.rmsnorm_fwd(*args,
                                  torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        message = lib.rmsnorm_error_string(err).decode()
        raise RuntimeError(f"rmsnorm_fwd launch failed: {message}")
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
    if not flat.is_cuda:
        return _reference(flat, w, eps).reshape(shape)
    flat, w = flat.contiguous(), w.contiguous()
    if (x.requires_grad or w.requires_grad) and torch.is_grad_enabled():
        out = _RMSNormFn.apply(flat, w, eps)
    else:
        out = rms_norm_kernel(flat, w, eps)
    return out.view(shape)

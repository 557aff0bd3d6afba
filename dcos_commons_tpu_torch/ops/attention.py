"""Flash-attention forward: kernel K2 (CUDA C++, ``csrc/flash_fwd.cu``)
and its plain PyTorch version.

K2 replaces the TPU kernel ``dcos_commons_tpu/ops/attention.py::_fwd_kernel``
(launched by ``_pallas_attention``); the source note in
``csrc/flash_fwd.cu`` says what bounds it on the H100 and what its
design does about that.  Layout at the public function is the JAX
package's: ``[batch, heads, seq, head_dim]``; the kernel takes the
contiguous ``[batch*heads, seq, head_dim]`` view.  The causal mask is
top-left aligned (query i sees keys j <= i), as the TPU kernel's, also
when seq_q != seq_k.  The optional lse (logsumexp of each query row's
scaled scores) is ``[batch*heads, seq_q]`` f32 — the TPU kernel's
residual without its 128-lane replication.

The plain version is the port's own copy of
``dcos_commons_tpu/parallel/ring.py::reference_attention``.  The
backward kernels (K3/K4) come with the training slice: a CUDA tensor
that needs a gradient raises ``NotImplementedError`` here.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

_NEG = -1e30
HEAD_DIMS = (64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _masked_scores(q, k, causal):
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, k.float())
    if causal:
        qn, kn = s.shape[-2], s.shape[-1]
        mask = (torch.arange(qn, device=s.device)[:, None]
                >= torch.arange(kn, device=s.device)[None, :])
        s = torch.where(mask, s, torch.full_like(s, _NEG))
    return s


def reference_attention(q, k, v, causal: bool = True) -> torch.Tensor:
    """Dense attention — the plain version K2 is held against."""
    p = torch.softmax(_masked_scores(q, k, causal), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def reference_lse(q, k, causal: bool = True) -> torch.Tensor:
    """Plain lse: [batch*heads, seq_q] f32 logsumexp of the masked,
    scaled scores (what K2 writes when asked)."""
    b, h, sq, _ = q.shape
    return torch.logsumexp(_masked_scores(q, k, causal), dim=-1).reshape(
        b * h, sq
    )


_lib = None


def _library():
    """The built ``csrc/flash_fwd.cu`` with its C signatures declared."""
    global _lib
    if _lib is None:
        from dcos_commons_tpu_torch.device import cuda_library

        lib = cuda_library("flash_fwd")
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_fwd.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i, i, vp]
        lib.flash_fwd.restype = i
        lib.flash_fwd_error_string.argtypes = [i]
        lib.flash_fwd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def flash_fwd_kernel(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
    return_lse: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch K2 on contiguous ``q [bh, seq_q, hd]``, ``k``/``v
    [bh, seq_k, hd]`` (one CUDA device, f32 or bf16, hd 64 or 128).
    Returns (o like q, lse [bh, seq_q] f32 or None).  Counts its
    launches in ``flash_fwd_kernel.launches``."""
    tensors = (q, k, v)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("flash_fwd_kernel needs q, k, v on one CUDA device")
    if q.dtype not in _DTYPE_CODE or any(t.dtype != q.dtype for t in tensors):
        raise ValueError(
            f"flash_fwd_kernel takes f32 or bf16 q/k/v of one dtype, got "
            f"{[t.dtype for t in tensors]}"
        )
    if any(t.dim() != 3 for t in tensors):
        raise ValueError("flash_fwd_kernel takes [bh, seq, head_dim] tensors")
    bh, seq_q, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_fwd_kernel: head_dim {hd} not in {HEAD_DIMS}")
    if k.shape != v.shape or k.shape[0] != bh or k.shape[2] != hd:
        raise ValueError(
            f"flash_fwd_kernel: k {tuple(k.shape)} / v {tuple(v.shape)} do "
            f"not match q {tuple(q.shape)}"
        )
    seq_k = k.shape[1]
    if seq_q < 1 or seq_k < 1 or bh < 1 or bh > 65535:
        raise ValueError(
            f"flash_fwd_kernel: needs seq >= 1 and 1 <= bh <= 65535, got "
            f"bh {bh}, seq_q {seq_q}, seq_k {seq_k}"
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_fwd_kernel needs contiguous q, k, v")
    lib = _library()
    o = torch.empty_like(q)
    lse = (
        torch.empty((bh, seq_q), device=q.device, dtype=torch.float32)
        if return_lse else None
    )
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            bh, seq_q, seq_k, hd, _DTYPE_CODE[q.dtype], int(causal), stream,
        )
    if err != 0:
        raise RuntimeError(
            "flash_fwd launch failed: "
            + lib.flash_fwd_error_string(err).decode()
        )
    flash_fwd_kernel.launches += 1
    return o, lse


flash_fwd_kernel.launches = 0


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    causal: bool = True, return_lse: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """``[batch, heads, seq, head_dim]`` attention.

    CPU tensors take the plain version (differentiable through
    autograd); CUDA tensors take K2, any seq length.  With
    ``return_lse`` also returns the lse ``[batch*heads, seq_q]`` f32."""
    b, h, sq, hd = q.shape
    if q.device.type == "cpu":
        o = reference_attention(q, k, v, causal)
        return (o, reference_lse(q, k, causal)) if return_lse else o
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v)
    ):
        raise NotImplementedError(
            "flash_attention backward on CUDA needs kernels K3/K4, which "
            "come with the training slice (ROADMAP queue 2)"
        )
    sk = k.shape[2]
    o, lse = flash_fwd_kernel(
        q.reshape(b * h, sq, hd).contiguous(),
        k.reshape(b * h, sk, hd).contiguous(),
        v.reshape(b * h, sk, hd).contiguous(),
        causal, return_lse,
    )
    o = o.reshape(b, h, sq, hd)
    return (o, lse) if return_lse else o

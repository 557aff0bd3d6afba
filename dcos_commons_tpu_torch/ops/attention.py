"""Flash attention, forward and backward: kernels K2 (``csrc/flash_fwd.cu``),
K3 and K4 (``csrc/flash_bwd.cu``), all CUDA C++, and their plain
PyTorch versions.  In bf16 all three run on the tensor cores (wgmma,
with tiles loaded by TMA; ``csrc/hopper.cuh``); in f32 they run f32 FMA
on the CUDA cores, exact for the f32 parity checks.  A launch that
fails raises: nothing falls back.

K2 replaces the TPU kernel ``dcos_commons_tpu/ops/attention.py::_fwd_kernel``
(launched by ``_pallas_attention``); K3 and K4 replace ``_dq_kernel``
and ``_dkv_kernel`` (launched by ``_pallas_attention_bwd``).  The
source notes in ``csrc/`` say what bounds each on the H100 and what its
design does about that.  Layout at the public function is the JAX
package's: ``[batch, heads, seq, head_dim]``; the kernels take the
contiguous ``[batch*heads, seq, head_dim]`` view.  The causal mask is
top-left aligned (query i sees keys j <= i), as the TPU kernels', also
when seq_q != seq_k.  The lse (logsumexp of each query row's scaled
scores) is ``[batch*heads, seq_q]`` f32 — the TPU kernel's residual
without its 128-lane replication.

``flash_attention`` on CUDA tensors that need a gradient goes through
``_FlashAttentionFn``, the counterpart of the JAX package's
``custom_vjp``: the forward launches K2 and saves (q, k, v, o, lse); the
backward computes ``di = rowsum(do * o)`` in f32 from the saved output
in its own dtype (a torch expression, outside the kernels, as the JAX
package computes it) and launches K3 and K4.  CPU tensors keep autograd
through the plain ``reference_attention``, as the JAX package's untiled
fallback does.

The plain forward is the port's own copy of
``dcos_commons_tpu/parallel/ring.py::reference_attention``;
``reference_attention_bwd`` is the plain FA2 backward from the saved lse
that K3 and K4 are held against.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

_NEG = -1e30
_LOG2E = 1.4426950408889634
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


def reference_attention_bwd(q, k, v, o, lse, do, causal: bool = True):
    """The plain FA2 backward from the saved lse — what K3 and K4 are
    held against.  q, o, do ``[b, h, seq_q, hd]``; k, v ``[b, h, seq_k,
    hd]``; lse ``[b*h, seq_q]`` f32.  Returns (dq, dk, dv) in the
    operands' dtypes.

    ``di = rowsum(do * o)`` in f32 from o in its own dtype; ``p =
    exp(s - lse)`` with masked entries exactly 0; ``dp = do v^T``; ``ds
    = p (dp - di)``; ``dq = scale ds k``, ``dk = scale ds^T q``, ``dv =
    p^T do``.  ds and p are rounded to the operand dtype before those
    products, as the TPU kernels round them (``ds.astype(k.dtype)``,
    ``p.astype(do.dtype)``, ``ds.astype(q.dtype)``); sums are f32."""
    b, h, sq, hd = q.shape
    scale = hd ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    p = torch.exp(s - lse.reshape(b, h, sq, 1))
    if causal:
        sk = k.shape[2]
        mask = (torch.arange(sq, device=s.device)[:, None]
                >= torch.arange(sk, device=s.device)[None, :])
        p = torch.where(mask, p, torch.zeros_like(p))
    di = (do.float() * o.float()).sum(-1, keepdim=True)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    ds = p * (dp - di)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds.to(k.dtype).float(),
                      k.float()) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds.to(q.dtype).float(),
                      q.float()) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(do.dtype).float(),
                      do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


_libs = {}


def _library(name: str, entry_points):
    """The built ``csrc/<name>.cu`` with the C signatures of its
    ``(function, number of pointer arguments)`` entry points declared."""
    lib = _libs.get(name)
    if lib is None:
        from dcos_commons_tpu_torch.device import cuda_library

        lib = cuda_library(name)
        vp, i = ctypes.c_void_p, ctypes.c_int
        for fn, n_pointers in entry_points:
            # pointers, then bh, seq_q, seq_k, head_dim, dtype, causal,
            # then the stream
            getattr(lib, fn).argtypes = [vp] * n_pointers + [i] * 6 + [vp]
            getattr(lib, fn).restype = i
        err_fn = getattr(lib, name + "_error_string")
        err_fn.argtypes = [i]
        err_fn.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def _check_operands(name, q, k, v, *extra):
    """The checks every attention kernel's wrapper makes on its
    ``[bh, seq, head_dim]`` operands (``extra``: more tensors shaped
    like q).  Returns (bh, seq_q, seq_k, head_dim)."""
    tensors = (q, k, v) + extra
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError(f"{name} needs its operands on one CUDA device")
    if q.dtype not in _DTYPE_CODE or any(t.dtype != q.dtype for t in tensors):
        raise ValueError(
            f"{name} takes f32 or bf16 operands of one dtype, got "
            f"{[t.dtype for t in tensors]}"
        )
    if any(t.dim() != 3 for t in tensors):
        raise ValueError(f"{name} takes [bh, seq, head_dim] tensors")
    bh, seq_q, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {hd} not in {HEAD_DIMS}")
    if k.shape != v.shape or k.shape[0] != bh or k.shape[2] != hd:
        raise ValueError(
            f"{name}: k {tuple(k.shape)} / v {tuple(v.shape)} do not "
            f"match q {tuple(q.shape)}"
        )
    if any(t.shape != q.shape for t in extra):
        raise ValueError(
            f"{name}: {[tuple(t.shape) for t in extra]} do not match q "
            f"{tuple(q.shape)}"
        )
    seq_k = k.shape[1]
    if seq_q < 1 or seq_k < 1 or bh < 1 or bh > 65535:
        raise ValueError(
            f"{name}: needs seq >= 1 and 1 <= bh <= 65535, got bh {bh}, "
            f"seq_q {seq_q}, seq_k {seq_k}"
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous operands")
    return bh, seq_q, seq_k, hd


def _check_tma_alignment(name, *tensors):
    """The bf16 kernels (K2-K4) read their operands through TMA tensor
    maps, which need a 16-byte aligned base pointer."""
    if tensors[0].dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 for t in tensors):
        raise ValueError(
            f"{name}: bf16 operands need 16-byte aligned data pointers "
            f"(TMA), got {[hex(t.data_ptr()) for t in tensors]}"
        )


def _check_rows(name, q, *rows):
    """lse and di: contiguous ``[bh, seq_q]`` f32 beside q."""
    for t in rows:
        if (t.device != q.device or t.dtype != torch.float32
                or tuple(t.shape) != tuple(q.shape[:2])
                or not t.is_contiguous()):
            raise ValueError(
                f"{name}: lse/di must be contiguous f32 {tuple(q.shape[:2])}"
                f" on {q.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}"
            )


def _raise_on(lib, source, fn, err):
    """Raise with the CUDA error string when launch ``fn`` of the
    ``csrc/<source>.cu`` library returned anything but 0."""
    if err != 0:
        message = getattr(lib, source + "_error_string")(err).decode()
        raise RuntimeError(f"{fn} launch failed: {message}")


def flash_fwd_kernel(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
    return_lse: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch K2 on contiguous ``q [bh, seq_q, hd]``, ``k``/``v
    [bh, seq_k, hd]`` (one CUDA device, f32 or bf16, hd 64 or 128).
    Returns (o like q, lse [bh, seq_q] f32 or None).  Counts its
    launches in ``flash_fwd_kernel.launches``."""
    bh, seq_q, seq_k, hd = _check_operands("flash_fwd_kernel", q, k, v)
    _check_tma_alignment("flash_fwd_kernel", q, k, v)
    lib = _library("flash_fwd", [("flash_fwd", 5)])
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
    _raise_on(lib, "flash_fwd", "flash_fwd", err)
    flash_fwd_kernel.launches += 1
    return o, lse


flash_fwd_kernel.launches = 0

_BWD_ENTRY_POINTS = [("flash_bwd_dq", 7), ("flash_bwd_dkv", 8)]


def flash_dq_kernel(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, di: torch.Tensor, causal: bool,
) -> torch.Tensor:
    """Launch K3: dq like q from contiguous ``q``/``do [bh, seq_q,
    hd]``, ``k``/``v [bh, seq_k, hd]`` (f32 or bf16, bf16 16-byte
    aligned) and f32 ``lse``/``di [bh, seq_q]``.  The bf16 kernel reads
    each thread's lse and di rows once, so they go as they are (K4's
    bf16 kernel needs them padded; see ``flash_dkv_kernel``).  Counts
    its launches in ``flash_dq_kernel.launches``."""
    bh, seq_q, seq_k, hd = _check_operands("flash_dq_kernel", q, k, v, do)
    _check_rows("flash_dq_kernel", q, lse, di)
    _check_tma_alignment("flash_dq_kernel", q, k, v, do)
    lib = _library("flash_bwd", _BWD_ENTRY_POINTS)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
            bh, seq_q, seq_k, hd, _DTYPE_CODE[q.dtype], int(causal), stream,
        )
    _raise_on(lib, "flash_bwd", "flash_bwd_dq", err)
    flash_dq_kernel.launches += 1
    return dq


flash_dq_kernel.launches = 0


def flash_dkv_kernel(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, di: torch.Tensor, causal: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K4: (dk, dv) like k, from the operands of
    ``flash_dq_kernel``.  Counts its launches in
    ``flash_dkv_kernel.launches``."""
    bh, seq_q, seq_k, hd = _check_operands("flash_dkv_kernel", q, k, v, do)
    _check_rows("flash_dkv_kernel", q, lse, di)
    _check_tma_alignment("flash_dkv_kernel", q, k, v, do)
    lib = _library("flash_bwd", _BWD_ENTRY_POINTS)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.dtype == torch.bfloat16:
        # the wgmma kernel copies each Q tile's 64 lse and di values into
        # shared memory in one aligned bulk copy: rows padded to whole
        # tiles, lse in base 2 for its exp2
        rows = torch.zeros((2, bh, -(-seq_q // 64) * 64), device=q.device,
                           dtype=torch.float32)
        rows[0, :, :seq_q] = lse * _LOG2E
        rows[1, :, :seq_q] = di
        lse, di = rows[0], rows[1]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            bh, seq_q, seq_k, hd, _DTYPE_CODE[q.dtype], int(causal), stream,
        )
    _raise_on(lib, "flash_bwd", "flash_bwd_dkv", err)
    flash_dkv_kernel.launches += 1
    return dk, dv


flash_dkv_kernel.launches = 0


def flash_bwd(q, k, v, o, lse, do, causal):
    """The backward on ``[bh, seq, hd]`` operands: di from the saved
    output in its own dtype, then K3 and K4.  Returns (dq, dk, dv)."""
    di = (do.float() * o.float()).sum(-1)
    dq = flash_dq_kernel(q, k, v, do, lse, di, causal)
    dk, dv = flash_dkv_kernel(q, k, v, do, lse, di, causal)
    return dq, dk, dv


class _FlashAttentionFn(torch.autograd.Function):
    """K2 forward, K3/K4 backward on ``[bh, seq, hd]`` operands; the
    lse output carries no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_fwd_kernel(q, k, v, causal, True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        return (*flash_bwd(q, k, v, o, lse, do.contiguous(), ctx.causal),
                None)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    causal: bool = True, return_lse: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """``[batch, heads, seq, head_dim]`` attention, differentiable.

    CPU tensors take the plain version (differentiable through
    autograd); CUDA tensors take K2 forward and K3/K4 backward, any seq
    length.  With ``return_lse`` also returns the lse ``[batch*heads,
    seq_q]`` f32."""
    b, h, sq, hd = q.shape
    if q.device.type == "cpu":
        o = reference_attention(q, k, v, causal)
        return (o, reference_lse(q, k, causal)) if return_lse else o
    sk = k.shape[2]
    flat = (
        q.reshape(b * h, sq, hd).contiguous(),
        k.reshape(b * h, sk, hd).contiguous(),
        v.reshape(b * h, sk, hd).contiguous(),
    )
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        o, lse = _FlashAttentionFn.apply(*flat, causal)
    else:
        o, lse = flash_fwd_kernel(*flat, causal, return_lse)
    o = o.reshape(b, h, sq, hd)
    return (o, lse) if return_lse else o

"""Weight-only int8 quantization for the serving path (port of
``dcos_commons_tpu/models/quantize.py``).

Each big matmul leaf ``W`` in ``params["layers"]`` becomes
``{"q": int8, "scale": f32}`` with the scale the max-abs over W's
contraction axis (-2: ``x @ W`` contracts it), so dequantization
commutes with the matmul.  Embeddings and norms stay native.  Every
projection reads its weight through :func:`dequantize_weight`.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

Params = Dict[str, Any]

# layer leaves eligible for weight-only quantization; everything else
# (norms) stays native
_QUANT_LEAVES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def quantize_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Symmetric per-output-channel int8, scale over axis -2."""
    w32 = w.float()
    scale = (w32.abs().amax(dim=-2, keepdim=True) / 127.0).clamp_min(1e-12)
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def dequantize_weight(w: Any, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`quantize_weight`; identity on plain tensors."""
    if isinstance(w, dict) and "q" in w:
        return (w["q"].float() * w["scale"]).to(dtype)
    return w


def quantize_params_int8(params: Params) -> Params:
    """Copy of the param tree with the layer matmul weights stored int8
    (``{"q", "scale"}`` leaves, leading n_layers axis kept)."""
    layers = dict(params["layers"])
    for name in _QUANT_LEAVES:
        if name in layers:
            layers[name] = quantize_weight(layers[name])
    out = dict(params)
    out["layers"] = layers
    return out

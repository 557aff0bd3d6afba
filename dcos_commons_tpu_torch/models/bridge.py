"""Weights carried across from the JAX package.

``params_from_jax`` takes the JAX package's flagship param tree as
numpy arrays (or anything ``np.asarray`` reads, such as JAX arrays):
``embed``, ``layers`` with every leaf stacked on a leading
``n_layers`` axis, ``final_norm``; int8 ``{"q", "scale"}`` leaves
included.  It returns the port's tree of the same shape, so both
packages compute the same function of the same weights.  The reverse
direction comes with the training slice (checkpoints).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from dcos_commons_tpu_torch.device import resolve_device

Params = Dict[str, Any]
_DENSE_LAYER_LEAVES = {
    "attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate", "w_up",
    "w_down",
}


def _tensor(arr, device, dtype) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype == np.int8:
        return torch.from_numpy(a.copy()).to(device)
    # bf16 arrives as an ml_dtypes extension type torch cannot read;
    # f32 holds every bf16 value exactly
    return torch.from_numpy(a.astype(np.float32)).to(device=device,
                                                     dtype=dtype)


def _leaf(arr, device, dtype):
    if isinstance(arr, dict):
        if set(arr) != {"q", "scale"}:
            raise ValueError(f"unexpected leaf keys {sorted(arr)}")
        return {"q": _tensor(arr["q"], device, torch.int8),
                "scale": _tensor(arr["scale"], device, torch.float32)}
    return _tensor(arr, device, dtype)


def params_from_jax(tree: Params, device=None,
                    dtype: torch.dtype = torch.float32) -> Params:
    """The JAX package's param tree -> the port's, on ``device``
    (default ``cuda``) with float leaves in ``dtype``."""
    dev = resolve_device(device)
    extra = set(tree["layers"]) - _DENSE_LAYER_LEAVES
    if extra:
        raise NotImplementedError(
            f"layer leaves {sorted(extra)} (MoE) are not ported yet: "
            "ROADMAP queue 1, 'MoE and long-context'"
        )
    return {
        "embed": _leaf(tree["embed"], dev, dtype),
        "layers": {name: _leaf(leaf, dev, dtype)
                   for name, leaf in tree["layers"].items()},
        "final_norm": _leaf(tree["final_norm"], dev, dtype),
    }

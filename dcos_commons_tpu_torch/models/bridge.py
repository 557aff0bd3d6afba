"""Weights and train state carried between the JAX package and the port.

``params_from_jax`` takes the JAX package's flagship param tree as
numpy arrays (or anything ``np.asarray`` reads, such as JAX arrays):
``embed``, ``layers`` with every leaf stacked on a leading
``n_layers`` axis, ``final_norm``; int8 ``{"q", "scale"}`` leaves and
the MoE leaves (``router [n, d, E]``, expert stacks ``w_gate``/``w_up``
``[n, E, d, f]`` and ``w_down [n, E, f, d]``) included.  It returns the
port's tree of the same shape, so both packages compute the same
function of the same weights.  The router stays f32 whatever ``dtype``
the other float leaves take, as the JAX package keeps it.

``mlp_params_from_jax`` takes the MNIST MLP's flat ``w1..b3`` tree the
same way; ``params_to_jax`` carries it back, as it carries any tree.

``params_to_jax`` and ``train_state_to_jax`` go the other way, to trees
of numpy arrays: the params, and ``{"params", "opt_state"}`` with the
optimizer state in ``optax.adamw``'s layout ``((count, mu, nu), (),
())``, whose leaves are those of the JAX package's optax state in its
flatten order (``jax.tree.unflatten`` onto the optax state's structure
rebuilds it).  bf16 leaves come back as ml_dtypes ``bfloat16`` arrays
when ml_dtypes is installed (it comes with jax), else as their exact
float32 widening.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from dcos_commons_tpu_torch.device import resolve_device
from dcos_commons_tpu_torch.utils.tree import tree_map

Params = Dict[str, Any]
_LAYER_LEAVES = {
    "attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate", "w_up",
    "w_down", "router",
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
    extra = set(tree["layers"]) - _LAYER_LEAVES
    if extra:
        raise ValueError(f"unexpected layer leaves {sorted(extra)}")
    return {
        "embed": _leaf(tree["embed"], dev, dtype),
        "layers": {
            name: _leaf(leaf, dev,
                        torch.float32 if name == "router" else dtype)
            for name, leaf in tree["layers"].items()
        },
        "final_norm": _leaf(tree["final_norm"], dev, dtype),
    }


def mlp_params_from_jax(tree: Params, device=None,
                        dtype: torch.dtype = torch.float32) -> Params:
    """The JAX package's MLP params (``w1``, ``b1``, ..., ``b3``) -> the
    port's, on ``device`` (default ``cuda``) in ``dtype``."""
    dev = resolve_device(device)
    expected = {f"{k}{i}" for k in "wb" for i in (1, 2, 3)}
    if set(tree) != expected:
        raise ValueError(f"unexpected MLP leaves {sorted(tree)}")
    return {name: _tensor(arr, dev, dtype) for name, arr in tree.items()}


def _to_numpy(t) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    wide = t.float().numpy()
    try:
        from ml_dtypes import bfloat16
    except ImportError:
        return wide
    # f32 holds every bf16 value exactly, so this cast is exact
    return wide.astype(bfloat16)


def params_to_jax(params: Params) -> Params:
    """The port's param tree -> the same tree of numpy arrays."""
    return tree_map(_to_numpy, params)


def train_state_to_jax(params: Params, optimizer) -> Params:
    """Params and AdamW state -> ``{"params", "opt_state"}`` of numpy
    arrays in the JAX train worker's layout."""
    from dcos_commons_tpu_torch.models.transformer import adamw_state

    return {
        "params": params_to_jax(params),
        "opt_state": tree_map(_to_numpy, adamw_state(optimizer, params)),
    }

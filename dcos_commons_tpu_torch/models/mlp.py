"""MNIST-scale MLP: the BASELINE.json config-3 workload (port of
``dcos_commons_tpu/models/mlp.py``).

``frameworks/train_mnist.py`` trains this on one card; it exists to
prove the control plane launches real work, not to be clever.  Native
(bf16 by default) matmuls, f32 loss.  No kernel of the port's own: the
three products go to ``torch.matmul``, as the reference computes them
outside any Pallas kernel.

``mlp_adam`` is the counterpart of ``optax.adam(1e-3)``: b1 0.9, b2
0.999, eps 1e-8, and the moments in the params' dtype, as optax keeps
them (``torch.optim.Adam`` does the same; its order of operations and
its rounding in bf16 differ from optax's, which the tests state as a
tolerance).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import torch
import torch.nn.functional as F

from dcos_commons_tpu_torch.device import generator, resolve_device

MlpParams = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class MlpConfig:
    d_in: int = 784
    d_hidden: int = 512
    d_out: int = 10
    dtype: torch.dtype = torch.bfloat16


def mlp_init(config: MlpConfig, seed: int = 0, device=None) -> MlpParams:
    """``w1..b3``, random from ``seed`` on ``device`` (default ``cuda``;
    ``meta``: shapes and dtypes only).  The draws differ from the JAX
    package's; carry its weights across with
    ``models.bridge.mlp_params_from_jax``."""
    dev = resolve_device(device)
    gen = generator(dev, seed)

    def normal(shape, scale):
        w = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.float32)
        return (w * scale).to(config.dtype)

    def zeros(n):
        return torch.zeros((n,), dtype=config.dtype, device=dev)

    return {
        "w1": normal((config.d_in, config.d_hidden), config.d_in ** -0.5),
        "b1": zeros(config.d_hidden),
        "w2": normal((config.d_hidden, config.d_hidden),
                     config.d_hidden ** -0.5),
        "b2": zeros(config.d_hidden),
        "w3": normal((config.d_hidden, config.d_out),
                     config.d_hidden ** -0.5),
        "b3": zeros(config.d_out),
    }


def mlp_forward(params: MlpParams, x: torch.Tensor) -> torch.Tensor:
    x = x.to(params["w1"].dtype)
    x = torch.relu(x @ params["w1"] + params["b1"])
    x = torch.relu(x @ params["w2"] + params["b2"])
    return (x @ params["w3"] + params["b3"]).float()


def mlp_loss(params: MlpParams, x: torch.Tensor, y: torch.Tensor
             ) -> torch.Tensor:
    logp = F.log_softmax(mlp_forward(params, x), dim=-1)
    return -logp.gather(-1, y.long()[:, None]).mean()


def mlp_adam(params: MlpParams, lr: float = 1e-3) -> torch.optim.Adam:
    """The counterpart of ``optax.adam(lr)`` over ``params`` (every
    leaf becomes trainable, in ``w1..b3`` order)."""
    leaves = [params[k] for k in sorted(params)]
    for p in leaves:
        p.requires_grad_(True)
    return torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def mlp_train_step(optimizer: torch.optim.Optimizer
                   ) -> Callable[[MlpParams, torch.Tensor, torch.Tensor],
                                 torch.Tensor]:
    """``step(params, x, y)``: one optimizer step on ``params`` in
    place; returns the loss before the step."""

    def step(params: MlpParams, x: torch.Tensor, y: torch.Tensor
             ) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = mlp_loss(params, x, y)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step

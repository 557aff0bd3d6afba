"""Single-host MNIST training task (BASELINE.json config 3): the port of
``frameworks/jax/train_mnist.py``.

Launched by the scheduler inside a sandbox; trains the MLP on synthetic
MNIST for ``TRAIN_STEPS`` steps (default 60) on one fixed batch of 256,
on the card unless ``TORCH_DEVICE=cpu`` asks for the CPU (with no card
and no such request it raises: it never carries on on the CPU), then
exits 0 if the loss fell, so the FINISH goal completes the deploy step.

The reference's ``warm_cache.py`` has no counterpart: this step is
eager, its products go to cuBLAS, and nothing of it is compiled per
host.

Run: ``python dcos_commons_tpu_torch/frameworks/train_mnist.py`` (or
``-m dcos_commons_tpu_torch.frameworks.train_mnist``) from the repo root.
"""

import os
import sys
import time
from typing import Mapping, Optional

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
)


def main(env: Optional[Mapping[str, str]] = None) -> int:
    import torch

    from dcos_commons_tpu_torch.device import resolve_device
    from dcos_commons_tpu_torch.models import (
        MlpConfig,
        mlp_adam,
        mlp_init,
        mlp_train_step,
    )
    from dcos_commons_tpu_torch.utils import synthetic_mnist

    env = os.environ if env is None else env
    device = resolve_device(env.get("TORCH_DEVICE") or "cuda")
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "host")
    # demo-scale run: 60 steps converges MNIST; the options default
    # 100 sizes the full trainer
    steps = int(env.get("TRAIN_STEPS", "60"))
    params = mlp_init(MlpConfig(), seed=0, device=device)
    step_fn = mlp_train_step(mlp_adam(params, 1e-3))
    x, y = synthetic_mnist(256, seed=1, device=device)

    t0 = time.time()
    first = last = None
    for i in range(steps):
        loss = step_fn(params, x, y)
        if i == 0:
            first = float(loss)
            print(f"step 0 loss={first:.4f} (first step "
                  f"{time.time() - t0:.1f}s)", flush=True)
    last = float(loss)
    print(
        f"trained {steps} steps on {device.type} ({name}): "
        f"loss {first:.4f} -> {last:.4f}",
        flush=True,
    )
    return 0 if last < first else 1


if __name__ == "__main__":
    sys.exit(main())

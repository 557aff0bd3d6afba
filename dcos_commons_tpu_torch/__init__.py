"""PyTorch/CUDA port of the JAX workload plane (``dcos_commons_tpu``).

The port runs the flagship decoder on an NVIDIA Hopper card with
kernels written by hand for it (``ops/``, ``csrc/``); the JAX package
beside it is the reference each ported module is held against.  The
port imports ``torch`` and numpy and nothing of the JAX package: what
it needs of the pure-Python modules there (the serving engines,
paging, migration, the micro-batcher, the metrics registry, the
service specification and its validators, the options renderer) it
keeps as its own copies.

Entry points that create tensors take ``device=``; left out, it is
``cuda``, and a host without CUDA raises instead of running on the CPU
(``device.resolve_device``).

The control plane (the scheduler process, its API and CLI) imports no
``torch``: ``resolve_device`` is loaded on first use, so ``python -m
dcos_commons_tpu_torch serve`` and ``cli`` start without it.
"""

__all__ = ["resolve_device"]


def __getattr__(name):
    if name == "resolve_device":
        from dcos_commons_tpu_torch.device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

"""PyTorch/CUDA port of the JAX workload plane (``dcos_commons_tpu``).

The port runs the flagship decoder on an NVIDIA Hopper card with
kernels written by hand for it (``ops/``, ``csrc/``); the JAX package
beside it is the reference each ported module is held against.  The
port imports ``torch`` and numpy and nothing of the JAX package: what
it needs of the pure-Python modules there (the serving engines,
paging, migration, the micro-batcher, the metrics registry) it keeps
as its own copies.

Entry points that create tensors take ``device=``; left out, it is
``cuda``, and a host without CUDA raises instead of running on the CPU
(``device.resolve_device``).
"""

from dcos_commons_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]

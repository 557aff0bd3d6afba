"""The hot ops, each a hand-written Hopper kernel beside its plain
PyTorch version: the plain version runs for CPU tensors (and is what
the tests and ``chip_smoke.py`` hold the kernel against); a CUDA
tensor always goes through the kernel."""

from dcos_commons_tpu_torch.ops.attention import (
    flash_attention,
    reference_attention,
)
from dcos_commons_tpu_torch.ops.rmsnorm import rms_norm

__all__ = ["flash_attention", "reference_attention", "rms_norm"]

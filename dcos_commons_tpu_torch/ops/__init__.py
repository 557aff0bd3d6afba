"""The hot ops, each a hand-written Hopper kernel beside its plain
PyTorch version: the plain version runs for CPU tensors (and is what
the tests and ``chip_smoke.py`` hold the kernel against); a CUDA
tensor always goes through the kernel."""

from dcos_commons_tpu_torch.ops.attention import (
    flash_attention,
    reference_attention,
    reference_attention_bwd,
)
from dcos_commons_tpu_torch.ops.rmsnorm import rms_norm

__all__ = [
    "flash_attention",
    "kernel_launches",
    "reference_attention",
    "reference_attention_bwd",
    "rms_norm",
]


def kernel_launches():
    """{"K1": n, ..., "K4": n}: each kernel's launches so far in this
    process (its wrapper's counter)."""
    from dcos_commons_tpu_torch.ops import attention, rmsnorm

    return {
        "K1": rmsnorm.rms_norm_kernel.launches,
        "K2": attention.flash_fwd_kernel.launches,
        "K3": attention.flash_dq_kernel.launches,
        "K4": attention.flash_dkv_kernel.launches,
    }

"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit) and the least
time a piece of work can take on it.

Frozen copy of ``chip_smoke.py``'s ``PEAK_BYTES``, ``PEAK_FLOPS`` and
``bound()``, keyed by dtype name so that nothing here needs torch.
"""

from __future__ import annotations

from typing import Tuple

PEAK_BYTES = 3.35e12           # HBM3, bytes/s
PEAK_FLOPS = {                 # FLOP/s
    "bfloat16": 989e12,
    "float16": 989e12,
    "float32": 67e12,          # outside the tensor cores
}


def bound(n_bytes: float, flops: float, dtype: str = "bfloat16"
          ) -> Tuple[float, str]:
    """(least seconds, "bytes" or "operations"): the larger of the bytes
    over the HBM bandwidth and the operations over the peak rate."""
    t_bytes = n_bytes / PEAK_BYTES
    t_ops = flops / PEAK_FLOPS[dtype]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

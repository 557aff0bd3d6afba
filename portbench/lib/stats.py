"""Order statistics and counts of the benchmark's samples."""

from __future__ import annotations

from typing import Sequence


def percentile(ordered: Sequence[float], q: int) -> float:
    """Nearest-rank percentile over an ascending-sorted sequence.

    Frozen copy of ``dcos_commons_tpu_torch/metrics/registry.py``
    ``percentile``, the convention the serving engine's TTFT gauges
    use.  ``math.inf`` entries (requests that never finished) sort last
    and count as missing every limit."""
    n = len(ordered)
    if n == 0:
        raise ValueError("percentile of no samples")
    return ordered[min(n - 1, max(0, -(-q * n // 100) - 1))]


def median(values: Sequence[float]) -> float:
    ordered = sorted(values)
    n = len(ordered)
    mid = n // 2
    return ordered[mid] if n % 2 else 0.5 * (ordered[mid - 1] + ordered[mid])


def served_tokens(spans, t0: float, t1: float) -> int:
    """Tokens the pool produced in [t0, t1), from the benchmark's spans
    that ended there: one for each row a decode call was handed a page
    table for, and a prompt's first from its last prefill chunk."""
    n = 0
    for name, _a, b, x in spans.items:
        if t0 <= b < t1:
            if name == "decode":
                n += len(x["positions"])
            elif name == "prefill_chunk":
                n += x["first_tokens"]
    return n

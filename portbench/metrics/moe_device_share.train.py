"""moe_device_share.train: the share of the traced steps' device time
spent in the MoE FFN (``models/moe.py``: routing, the one-hot dispatch
and combine, the expert FFN; forward, recompute and backward), in
percent."""

from portbench.lib.trace import time_by_part


def read(ctx, rec):
    if rec.trace is None or not ctx.geometry.n_experts:
        return None
    split = time_by_part(rec.trace.raw)
    total = sum(split.values())
    moe = sum(v for k, v in split.items() if k.startswith("moe."))
    if total <= 0 or moe <= 0:
        return None
    return 100.0 * moe / total

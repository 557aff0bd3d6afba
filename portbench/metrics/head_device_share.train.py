"""head_device_share.train: the share of the traced steps' device time
spent in the f32 head and its loss (``models/transformer.py``
``_logits`` and ``_nll``, forward and backward), in percent."""

from portbench.lib.trace import time_by_part


def read(ctx, rec):
    if rec.trace is None:
        return None
    split = time_by_part(rec.trace.raw)
    total = sum(split.values())
    if total <= 0 or "head" not in split:
        return None
    return 100.0 * split["head"] / total

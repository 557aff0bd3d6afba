"""step_mfu.train: model FLOPs of the window's training steps over the
window's seconds and the card's bf16 peak, in percent.  Model FLOPs are
``Geometry.train_flops`` (6 x the matmul parameters a token uses plus
causal attention, no recompute); the window is the untraced one."""

from portbench.lib.peaks import PEAK_FLOPS


def read(ctx, rec):
    steps = rec.counters.get("steps", 0)
    t0, t1 = rec.window
    if not steps or t1 <= t0:
        return None
    flops = steps * ctx.geometry.train_flops(ctx.mix["batch"], ctx.mix["seq"])
    return 100.0 * flops / (t1 - t0) / PEAK_FLOPS["bfloat16"]

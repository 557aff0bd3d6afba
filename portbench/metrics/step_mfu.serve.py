"""step_mfu.serve: model FLOPs of every prompt and output token the
pool computed in the window over the window's seconds and the card's
bf16 peak, in percent.  A prefill chunk counts its tokens' trunk and
causal attention and the head at its last position; a decode step its
active rows' (``Geometry.prefill_chunk_flops``, ``decode_flops``)."""

from portbench.lib.peaks import PEAK_FLOPS


def read(ctx, rec):
    g = ctx.geometry
    t0, t1 = rec.window
    flops = sum(g.prefill_chunk_flops(x["start"], x["length"])
                for _n, _a, _b, x in ctx.spans.of("prefill_chunk", t0, t1))
    flops += sum(g.decode_flops(x["positions"])
                 for _n, _a, _b, x in ctx.spans.of("decode", t0, t1))
    if flops <= 0 or t1 <= t0:
        return None
    return 100.0 * flops / (t1 - t0) / PEAK_FLOPS["bfloat16"]

"""output_tokens_per_s.serve: tokens the pool produced in the window
(the traced tail left out) over its seconds, counted from the
benchmark's own spans around the pool's calls (``lib/stats.py``
``served_tokens``).  Below the knee it follows the offered load; it
shows whether the engine keeps up with it."""

from portbench.lib.stats import served_tokens


def read(ctx, rec):
    t0, t1 = rec.window
    n = served_tokens(ctx.spans, t0, t1)
    if n <= 0 or t1 <= t0:
        return None
    return n / (t1 - t0)

"""decode_step_ms.serve: the host clock around each call of the pool's
decode step (``PagedPoolModel.decode``, which returns the tokens to the
host, so it waits for the card), the window's total over its calls."""


def read(ctx, rec):
    t0, t1 = rec.window
    calls = ctx.spans.of("decode", t0, t1)
    if not calls:
        return None
    return 1e3 * sum(b - a for _n, a, b, _x in calls) / len(calls)

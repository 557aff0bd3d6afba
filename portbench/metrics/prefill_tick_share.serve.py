"""prefill_tick_share.serve: the wall time of the engine's prefill phase
(``engine.prefill`` ranges: every chunk and its bookkeeping) over the
wall time of its ticks (``engine.tick`` ranges), counting only ticks
wholly inside the traced window, in percent."""

from portbench.lib.ranges import spans, within


def read(ctx, rec):
    t = rec.trace
    if t is None:
        return None
    ticks = [e for e in spans(t, ["engine.tick"])
             if t.t0 <= e["ts"] and e["ts"] + e["dur"] <= t.t1]
    total = sum(e["dur"] for e in ticks)
    if total <= 0:
        return None
    prefill = sum(e["dur"] for e in spans(t, ["engine.prefill"])
                  if within(e, ticks))
    return 100.0 * prefill / total

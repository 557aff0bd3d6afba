"""The knee of a serving cell: its open loop at several fixed rates, one
process, one set-up.

    python3 portbench/tools/sweep.py --workload <name> --rates 1.5,2.5,3.5 \
        [--seconds 40] [--seed 1]

For each rate (requests a second) one JSON line: requests sent and
failed, latency p50 and p95 from the due time, tokens/s produced in the
window, the decode step's mean ms and rows (mean and most), and the
latency of the window's first and last quarter of requests (a backlog
that grows through the window shows as a last quarter far slower than
the first).
The knee is the highest rate whose last quarter is not.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from portbench.lib import harness  # noqa: E402
from portbench.lib.stats import percentile, served_tokens  # noqa: E402
from portbench.lib.traffic import serve_schedule  # noqa: E402


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=40.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args()
    ctx = harness.build_context(args.workload, args.seed, args.seconds, False)
    drv = harness.driver_of(ctx)
    cell = drv.ServeCell(ctx)
    for rate in [float(r) for r in args.rates.split(",")]:
        mix = dict(ctx.mix, rate=rate)
        schedule = serve_schedule(mix, args.seed, args.seconds,
                                  ctx.geometry.vocab)
        mark = len(ctx.spans.items)
        outcomes, t0, _ = cell.window(schedule, args.seconds)
        summary = drv.summarize(ctx, outcomes, t0)
        lat = [o.done - (t0 + o.request.due) for o in outcomes
               if o.tokens is not None]
        q = max(1, len(outcomes) // 4)
        first = [o.done - (t0 + o.request.due) for o in outcomes[:q]
                 if o.tokens is not None]
        last = [o.done - (t0 + o.request.due) for o in outcomes[-q:]
                if o.tokens is not None]
        decodes = [s for s in ctx.spans.items[mark:] if s[0] == "decode"
                   and s[1] < t0 + args.seconds]
        print(json.dumps({
            "rate": rate, "requests": len(outcomes),
            "failed": summary["failed"],
            "latency_p50_s": percentile(sorted(lat), 50) if lat else None,
            "latency_p95_s": summary["serve_latency_p95_s"],
            "first_quarter_mean_s": sum(first) / max(len(first), 1),
            "last_quarter_mean_s": sum(last) / max(len(last), 1),
            "tokens_per_s": served_tokens(ctx.spans, t0, t0 + args.seconds)
            / args.seconds,
            "decode_ms": 1e3 * sum(b - a for _, a, b, _x in decodes)
            / max(len(decodes), 1),
            "decode_rows": sum(len(x["positions"]) for *_r, x in decodes)
            / max(len(decodes), 1),
            "decode_rows_max": max((len(x["positions"])
                                    for *_r, x in decodes), default=0),
            "ttft_p95_s": cell.engine.stats().get("ttft_p95_s"),
            "queue_at_close": cell.window_end["queue_depth"],
            "active_at_close": cell.window_end["active_slots"],
        }), flush=True)
    cell.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

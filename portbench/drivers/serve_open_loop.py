"""Driver ``serve_open_loop``: the port's paged engine under an open
loop of requests.

Set-up makes the weights, builds ``PagedPoolModel`` and ``PagedEngine``
in process as ``frameworks/serve_worker.py`` builds them, and warms
the pool's two entry points at the cell's shapes (``pool.warm``).  Each
request of the schedule (``lib/traffic.py``) is sent from a thread of
its own at its due time, whatever came before: first a pre-roll of
``preroll_s`` seconds, which fills the engine to the occupancy the rate
holds it at, then the window.  Only requests due in the window are
judged; each is timed from its due time to the return of ``submit``.
They are drained after it; one unfinished ``drain_s`` seconds after
the window closes has failed.  Then the state is freed and the plain
reference is run over a sample of the window's finished requests,
drawn from the seed with the longest among them: the widest gap by
which a served token's logit lies below the reference's best decides.

The tokens served are counted from the benchmark's own spans around the
pool's calls: a decode call gives one token to each row it is handed a
page table for, and a prompt's last prefill chunk its first token
(``lib/stats.py`` ``served_tokens``).

Mix keys: ``rate`` (requests a second), ``prompt_tokens`` and
``output_tokens`` (lognormal: ``median``, ``sigma``, ``min``, ``max``),
``shape_seed``, ``preroll_s``, ``slots``, ``max_len``, ``page_tokens``,
``chunk_tokens``, ``warm_chunk_lengths`` (shorter chunks run in the
warm-up), ``prefix_cache``, ``drain_s``, ``trace_s`` (the
window's last seconds traced in a ``--trace 1`` run), ``check_requests``
and ``check_tokens`` (the sample's size).
"""

from __future__ import annotations

import math
import os
import threading
import time
from typing import List, Optional

import numpy as np

from portbench.lib import program
from portbench.lib.compare import judged
from portbench.lib.harness import Context, Record, process_age
from portbench.lib.stats import percentile, served_tokens
from portbench.lib.trace import WINDOW, Trace, load
from portbench.lib.traffic import Request, serve_schedule
from portbench.lib.weights import make_params


class Outcome:
    __slots__ = ("request", "sent", "done", "tokens", "error")

    def __init__(self, request: Request):
        self.request = request
        self.sent: Optional[float] = None
        self.done: Optional[float] = None
        self.tokens: Optional[List[int]] = None
        self.error: Optional[str] = None


class ServeCell:
    """The program's side of a serving cell."""

    def __init__(self, ctx: Context):
        import torch

        from dcos_commons_tpu_torch.serve.engine import PagedEngine
        from dcos_commons_tpu_torch.serve.pool import PagedPoolModel

        self.ctx, self.g, self.mix = ctx, ctx.geometry, ctx.mix
        mix = self.mix
        if ctx.device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        self.config = program.transformer_config(self.g, mix["max_len"],
                                                 remat=False)
        self.params = make_params(self.g, ctx.seed, ctx.device)
        per_row = -(-mix["max_len"] // mix["page_tokens"])
        pages = mix["slots"] * per_row
        self.pool = PagedPoolModel(
            self.config, self.params, mix["slots"], mix["max_len"],
            mix["page_tokens"], pages, mix["chunk_tokens"])
        self.pool.warm()
        for n in mix["warm_chunk_lengths"]:
            # the last chunk of a prompt is shorter: its products' shapes
            self.pool.prefill_chunk(
                np.zeros((1, mix["chunk_tokens"]), np.int32), slot=0,
                table=np.zeros(per_row, np.int32), start=0,
                true_len=min(int(n), mix["chunk_tokens"]), temp=0.0, seed=0)
        if ctx.trace and ctx.device == "cuda":
            # the profiler's first start initializes CUPTI: here, not
            # while the engine serves
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]):
                torch.ones(1, device="cuda").add_(1.0)
        program.sync(ctx.device)
        spans = ctx.spans

        self.profiler = _LoopProfiler(ctx)
        # a prompt's length by its first tokens, and by the slot it is
        # being prefilled into: which chunk is a prompt's last
        self.prompt_len: dict = {}
        slot_len: dict = {}

        def prefill_chunk(tokens, **kw):
            self.profiler.poll()
            start, length, slot = (int(kw["start"]), int(kw["true_len"]),
                                   int(kw["slot"]))
            if start == 0:
                slot_len[slot] = self.prompt_len.get(
                    _head(tokens[0][:length]))
            last = slot_len.get(slot) == start + length
            if last:
                del slot_len[slot]
            with spans.span("prefill_chunk", start=start, length=length,
                            first_tokens=int(last)):
                return self.pool.prefill_chunk(tokens, **kw)

        def decode(tok, pos, temps, seeds, tables, n_active=None):
            self.profiler.poll()
            live = [int(p) for p, t in zip(pos, tables) if t.any()]
            with spans.span("decode", positions=live):
                return self.pool.decode(tok, pos, temps, seeds, tables,
                                        n_active)

        self.engine = PagedEngine(
            prefill_chunk, decode, mix["slots"], mix["max_len"],
            mix["max_len"] - mix["output_tokens"]["max"],
            page_tokens=mix["page_tokens"], pages=pages,
            chunk_tokens=mix["chunk_tokens"],
            prefix_cache=bool(mix["prefix_cache"]),
            queue_timeout_s=float(mix["drain_s"]) + 600.0,
            # a traced run's profiler stops on the loop thread, also
            # where the engine has nothing left to do
            on_idle=self.profiler.poll if ctx.trace else None,
        )

    def window(self, schedule: List[Request], seconds: float,
               trace_s: float = 0.0):
        """Send the schedule, its pre-roll first; returns (the timed
        requests' outcomes, t0, the trace or None).  Returns once every
        timed request finished or ``drain_s`` passed after the window
        closed."""
        for r in schedule:
            self.prompt_len[_head(r.prompt)] = len(r.prompt)
        every = [Outcome(r) for r in schedule]
        outcomes = [o for o in every if o.request.timed]
        threads: List[threading.Thread] = []
        spans = self.ctx.spans
        engine = self.engine

        def client(o: Outcome):
            o.sent = time.perf_counter()
            try:
                with spans.span("submit", index=o.request.index):
                    out = engine.submit([o.request.prompt],
                                        o.request.new_tokens,
                                        temperature=0.0)
                o.tokens = [int(t) for t in out[0]]
            except Exception as e:  # noqa: BLE001 — a failed request
                o.error = repr(e)
            o.done = time.perf_counter()

        def dispatch(t0: float):
            for o in every:
                delay = t0 + o.request.due - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                th = threading.Thread(target=client, args=(o,), daemon=True)
                th.start()
                if o.request.timed:
                    threads.append(th)

        t0 = time.perf_counter() - min(0.0, min(
            (r.due for r in schedule), default=0.0))
        sender = threading.Thread(target=dispatch, args=(t0,), daemon=True)
        sender.start()
        trace = None
        if trace_s > 0:
            _sleep_until(t0 + seconds - trace_s)
            self.profiler.want = "start"
        _sleep_until(t0 + seconds)
        self.window_end = engine.stats()
        if trace_s > 0:
            trace = self.profiler.finish()
        deadline = t0 + seconds + float(self.mix["drain_s"])
        sender.join(max(0.0, deadline - time.perf_counter()))
        for th in list(threads):
            th.join(max(0.0, deadline - time.perf_counter()))
        return outcomes, t0, trace

    def close(self) -> dict:
        stats = self.engine.stats()
        self.engine.stop()
        del self.engine, self.pool, self.params
        program.release()
        return stats


class _LoopProfiler:
    """``torch.profiler`` started and stopped on the engine's loop
    thread, which launches all the serving work (a profiler records the
    host ops of the thread that starts it), at that thread's first call
    into the pool after it is asked to."""

    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.want: Optional[str] = None
        self.prof = None
        self.range = None
        self.stopped = threading.Event()

    def poll(self) -> None:
        if self.want == "start" and self.prof is None:
            import torch
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if self.ctx.device == "cuda" else [])
            self.prof = profile(activities=activities)
            self.prof.start()
            self.range = torch.profiler.record_function(WINDOW)
            self.range.__enter__()
            self.ctx.spans.traced = True
        elif self.want == "stop" and self.prof is not None \
                and not self.stopped.is_set():
            program.sync(self.ctx.device)
            self.range.__exit__(None, None, None)
            self.ctx.spans.traced = False
            self.prof.stop()
            self.stopped.set()

    def finish(self, timeout: float = 60.0) -> Optional[Trace]:
        """Ask the loop to stop the profiler; the trace of the window."""
        self.want = "stop"
        if not self.stopped.wait(timeout):
            return None
        path = os.path.join(self.ctx.scratch, "serve_trace.json")
        self.prof.export_chrome_trace(path)
        trace = Trace(load(path))
        os.remove(path)
        self.prof = None
        return trace


def _head(tokens) -> tuple:
    """A prompt's key: its first eight ids (uniform, unshared)."""
    return tuple(int(t) for t in tokens[:8])


def _sleep_until(t: float) -> None:
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        time.sleep(min(left, 0.5))


def sample(outcomes: List[Outcome], seed: int, max_requests: int,
           max_tokens: int) -> List[Outcome]:
    """Finished requests drawn from the seed, the longest first in."""
    done = [o for o in outcomes if o.tokens is not None]
    if not done:
        return []
    longest = max(done, key=lambda o: len(o.request.prompt)
                  + o.request.new_tokens)
    rng = np.random.default_rng(seed)
    rest = [done[i] for i in rng.permutation(len(done))
            if done[i] is not longest]
    picked, tokens = [longest], longest.request.new_tokens
    for o in rest:
        if len(picked) >= max_requests or tokens >= max_tokens:
            break
        picked.append(o)
        tokens += o.request.new_tokens
    return picked


def served_gaps(ctx: Context, picked: List[Outcome], quant=False) -> dict:
    """For each sampled request, the reference's logits at the positions
    that chose its served tokens: the widest gap below the reference's
    best of a served token, and with ``quant`` also of the token the
    lower precision puts first (the control)."""
    import torch

    from portbench.reference import model as ref

    ref.no_tf32()
    g = ctx.geometry
    params = ref.make_reference_params(g, ctx.seed, ctx.device)
    served, control, n = 0.0, 0.0, 0
    for o in picked:
        prompt, out = o.request.prompt, o.tokens
        seq = prompt + out[:-1]
        lg = ref.logits(g, params, seq, len(prompt) - 1)
        best = lg.max(-1).values
        got = lg.gather(-1, torch.as_tensor(out, device=lg.device)[:, None])
        served = max(served, float((best - got[:, 0]).max()))
        n += len(out)
        if quant:
            low = ref.logits(g, params, seq, len(prompt) - 1, quant)
            pick = low.argmax(-1)
            control = max(control, float(
                (best - lg.gather(-1, pick[:, None])[:, 0]).max()))
        del lg
    del params
    program.release()
    out = {"served_logit_gap": served, "tokens": n}
    if quant:
        out["control_logit_gap"] = control
    return out


def summarize(ctx: Context, outcomes: List[Outcome], t0: float) -> dict:
    """The end-to-end numbers of a window's requests."""
    seconds = ctx.seconds
    lat, out_tokens, failed = [], 0, 0
    for o in outcomes:
        ok = (o.tokens is not None and o.done is not None
              and len(o.tokens) == o.request.new_tokens)
        if not ok:
            failed += 1
            lat.append(math.inf)
            continue
        lat.append(o.done - (t0 + o.request.due))
        if o.done <= t0 + seconds:
            out_tokens += len(o.tokens)
    lat.sort()
    lag = max((o.sent - (t0 + o.request.due) for o in outcomes
               if o.sent is not None), default=0.0)
    decodes = [x["positions"] for n, _a, b, x in ctx.spans.items
               if n == "decode" and t0 <= b < t0 + seconds]
    rows = [len(p) for p in decodes]
    return {"serve_latency_p95_s": percentile(lat, 95) if lat else math.inf,
            "completed_tokens_per_s": out_tokens / seconds,
            "served_tokens_per_s": served_tokens(ctx.spans, t0, t0 + seconds)
            / seconds,
            "rows_mean": sum(rows) / max(len(rows), 1),
            "rows_max": max(rows, default=0),
            # positions the decoding rows hold in the arena, at most
            "kv_positions_max": max((sum(p) + len(p) for p in decodes),
                                    default=0),
            "failed": failed, "latency_p50_s": percentile(lat, 50)
            if lat else math.inf, "generator_lag_s": lag}


def run(ctx: Context) -> Record:
    cell = ServeCell(ctx)
    schedule = serve_schedule(ctx.mix, ctx.seed, ctx.seconds, ctx.geometry.vocab)
    program.sync(ctx.device)
    setup_s = process_age()
    trace_s = float(ctx.mix["trace_s"]) if ctx.trace else 0.0
    outcomes, t0, trace = cell.window(schedule, ctx.seconds, trace_s)
    peak = program.read_peak(ctx.device)
    stats = cell.close()
    summary = summarize(ctx, outcomes, t0)
    picked = sample(outcomes, ctx.seed, ctx.mix["check_requests"],
                    ctx.mix["check_tokens"])
    t_ref = time.perf_counter()
    gaps = served_gaps(ctx, picked) if picked else {
        "served_logit_gap": math.inf, "tokens": 0}
    checks, ok = judged({"served_logit_gap": (gaps["served_logit_gap"],
                                              "sample")}, ctx.limits)
    rec = Record(
        e2e={"serve_latency_p95_s": summary["serve_latency_p95_s"],
             "setup_s": setup_s},
        attempted=len(outcomes), failed=summary["failed"], checks=checks,
        correct=ok and summary["failed"] == 0, memory_peak=peak,
        # the host-clock readers leave out the traced tail
        window=(t0, t0 + ctx.seconds - trace_s), trace=trace,
        counters={"engine": stats, "summary": summary},
    )
    errors = [o.error for o in outcomes if o.error]
    if errors:
        rec.notes.append(f"{len(errors)} requests raised, the first: "
                         f"{errors[0][:300]}")
    rec.notes.append(
        f"{len(outcomes)} requests, {summary['failed']} failed; latency "
        f"p50 {summary['latency_p50_s']:.4f} s; tokens/s served in the "
        f"window {summary['served_tokens_per_s']:.4f}, of requests "
        f"completed in it {summary['completed_tokens_per_s']:.1f}; rows "
        f"a decode step {summary['rows_mean']:.2f} mean, "
        f"{summary['rows_max']} most, holding "
        f"{summary['kv_positions_max']} positions at most; generator lag "
        f"{summary['generator_lag_s']:.4f} s; engine ttft p95 "
        f"{stats.get('ttft_p95_s')}; sample {len(picked)} requests, "
        f"{gaps['tokens']} tokens; reference "
        f"{time.perf_counter() - t_ref:.1f} s")
    return rec

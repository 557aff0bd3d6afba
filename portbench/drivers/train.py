"""Driver ``train``: the port's training step, fed by its data loader.

Set-up builds one training step with its model and optimizer state
(``make_train_step(config, adamw(params))``, no mesh, as
``frameworks/train_worker.py`` builds it), fed by ``TokenDataset`` and
``DevicePrefetcher`` over token shards written from the seed, and
drives it through the mix's ``setup_steps`` (the warm-up), reading the
loss of each, each leaf's first gradient from AdamW's first moment
after step 1 (its norm and a random sketch, ``lib/sketch.py``), and
each leaf's change after ``reference_steps``.  The
window then runs whole steps of that same object for ``--seconds``.
After the window the state is freed and the plain reference follows
the first ``reference_steps`` steps on the same rows.

Mix keys: ``batch``, ``seq``, ``rows`` (rows of token shards written),
``shards``, ``doc_tokens`` and ``zipf_exponent`` (the documents),
``shape_seed``, ``setup_steps``, ``reference_steps``, ``inflight``
(steps the host runs ahead), ``trace_steps``.
"""

from __future__ import annotations

import math
import os
import time
from collections import deque

from portbench.lib import compare, program, sketch
from portbench.lib.harness import Context, Record, process_age
from portbench.lib.trace import WINDOW, Scopes, Trace, load, part_scopes
from portbench.lib.traffic import write_train_shards
from portbench.lib.weights import leaf_specs, make_leaf, make_params, \
    tree_paths, get

BETA1 = 0.9  # the port's adamw


class TrainCell:
    """The program's side of a training cell."""

    def __init__(self, ctx: Context):
        import torch

        from dcos_commons_tpu_torch.data import loader
        from dcos_commons_tpu_torch.models import transformer

        self.ctx, self.g, self.mix = ctx, ctx.geometry, ctx.mix
        self.torch = torch
        dev = ctx.device
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
        self.config = program.transformer_config(self.g, self.mix["seq"],
                                                 remat=True)
        self.params = make_params(self.g, ctx.seed, dev)
        self.optimizer = transformer.adamw(self.params, 3e-4)
        self.step = transformer.make_train_step(self.config, self.optimizer)
        data_dir = os.path.join(ctx.scratch, "shards")
        write_train_shards(self.mix, ctx.seed, self.g.vocab, data_dir)
        dataset = loader.TokenDataset(data_dir, self.mix["seq"],
                                      seed=ctx.seed)
        self.batches = loader.DevicePrefetcher(
            dataset.batches(self.mix["batch"]), dev, depth=2)
        self.paths = tree_paths(self.params)

    def one(self):
        spans = self.ctx.spans
        with spans.span("data"):
            tokens, targets = next(self.batches)
        with spans.span("train_step"):
            loss = self.step(self.params, tokens, targets)
        return loss, tokens, targets

    def setup_steps(self) -> dict:
        """The set-up's steps, with the readings the reference follows."""
        k_ref = self.mix["reference_steps"]
        losses, kept, first_grad, first_sketch, change = [], [], {}, {}, {}
        for k in range(max(self.mix["setup_steps"], k_ref)):
            loss, tokens, targets = self.one()
            losses.append(float(loss))
            if k < k_ref:
                kept.append((tokens.cpu(), targets.cpu()))
            if k == 0:
                first_grad = {p: self.first_moment_norm(p) / (1.0 - BETA1)
                              for p in self.paths}
                first_sketch = {p: self.first_moment_sketch(p)
                                / (1.0 - BETA1) for p in self.paths}
            if k == k_ref - 1:
                change = self.change_norms()
        return {"losses": losses[:k_ref], "first_grad": first_grad,
                "first_sketch": first_sketch, "change": change,
                "batches": kept, "setup_losses": losses}

    def first_moment_norm(self, path: str) -> float:
        """AdamW's first moment of a leaf; zero where the optimizer has
        made none (optax's init)."""
        state = self.optimizer.state.get(get(self.params, path), {})
        moment = state.get("exp_avg")
        return 0.0 if moment is None else program.leaf_norm(moment)

    def first_moment_sketch(self, path: str):
        import torch

        state = self.optimizer.state.get(get(self.params, path), {})
        moment = state.get("exp_avg")
        if moment is None:
            return torch.zeros(sketch.K, dtype=torch.float64)
        return sketch.leaf_sketch(moment, self.ctx.seed, path,
                                  path.startswith("layers/"))

    def change_norms(self) -> dict:
        out = {}
        specs = leaf_specs(self.g)
        for i, (path, *_r) in enumerate(specs):
            p0 = make_leaf(self.g, self.ctx.seed, i, self.ctx.device)
            out[path] = program.diff_norm(get(self.params, path), p0)
            del p0
        return out

    def window(self, seconds: float):
        """Whole steps for ``seconds``: (steps, failed, t0, t1)."""
        pending, n, failed = deque(), 0, 0
        inflight = self.mix["inflight"]
        t0 = time.perf_counter()
        while True:
            loss, _, _ = self.one()
            pending.append(loss)
            n += 1
            while len(pending) > inflight:
                failed += not math.isfinite(float(pending.popleft()))
            if time.perf_counter() - t0 >= seconds:
                break
        while pending:
            failed += not math.isfinite(float(pending.popleft()))
        program.sync(self.ctx.device)
        return n, failed, t0, time.perf_counter()

    def traced(self) -> Trace:
        """``trace_steps`` steps under the profiler after one it
        discards (a session's first kernels can reach the trace late)."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile, schedule

        dev = self.ctx.device
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev == "cuda" else [])
        path = os.path.join(self.ctx.scratch, "train_trace.json")
        with profile(activities=activities,
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)
                     ) as prof, Scopes(part_scopes(self.g.n_experts)):
            self.one()
            program.sync(dev)
            prof.step()
            self.ctx.spans.traced = True
            with torch.profiler.record_function(WINDOW):
                for _ in range(self.mix["trace_steps"]):
                    self.one()
                program.sync(dev)
            self.ctx.spans.traced = False
            prof.step()
        prof.export_chrome_trace(path)
        trace = Trace(load(path))
        os.remove(path)
        return trace

    def close(self) -> None:
        self.batches.close()
        del self.step, self.optimizer, self.params, self.batches
        program.release()


def reference_readings(ctx: Context, batches, quant=False, rows=None,
                       lr: float = 3e-4) -> dict:
    """The plain reference over the kept rows (``rows``: a slice of each
    batch, ``lr`` 0: a state left unchanged; faults planted in the
    reference)."""
    import torch

    from portbench.reference import model as ref

    ref.no_tf32()
    g = ctx.geometry
    params = ref.make_reference_params(g, ctx.seed, ctx.device)
    dev = ctx.device
    feed = [(t.to(dev), y.to(dev)) if rows is None
            else (t[rows].to(dev), y[rows].to(dev)) for t, y in batches]
    out = ref.train_steps(g, params, feed, quant=quant,
                          opt=ref.AdamW(params, lr=lr), sketch_seed=ctx.seed)
    out["change"] = ref.change_norms(g, params, ctx.seed)
    del params
    program.release()
    return out


def run(ctx: Context) -> Record:
    cell = TrainCell(ctx)
    readings = cell.setup_steps()
    program.sync(ctx.device)
    setup_s = process_age()
    steps, failed, t0, t1 = cell.window(ctx.seconds)
    tokens = steps * ctx.mix["batch"] * ctx.mix["seq"]
    trace = cell.traced() if ctx.trace else None
    peak = program.read_peak(ctx.device)
    cell.close()
    t_ref = time.perf_counter()
    ref = reference_readings(ctx, readings["batches"])
    numbers = compare.train_numbers(readings, ref)
    checks, ok = compare.judged(numbers, ctx.limits)
    rec = Record(
        e2e={"train_tokens_per_s": tokens / (t1 - t0), "setup_s": setup_s},
        attempted=steps, failed=failed, checks=checks,
        correct=ok and failed == 0, memory_peak=peak, window=(t0, t1),
        counters={"steps": steps, "step_tokens": ctx.mix["batch"]
                  * ctx.mix["seq"]},
        trace=trace,
    )
    rec.notes.append(
        f"losses program {readings['setup_losses']} reference "
        f"{ref['losses']}; leaves: grad worst {numbers['grad_gap'][1]} "
        f"sketch median {numbers['grad_sketch_gap'][1]}, "
        f"change {numbers['change_gap'][1]}; reference "
        f"{time.perf_counter() - t_ref:.1f} s; window {steps} steps "
        f"in {t1 - t0:.3f} s")
    return rec

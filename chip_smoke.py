"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Run from the repo root: ``python3 chip_smoke.py`` (no arguments, one
CUDA card).  Phases, each fatal on failure:

1. Device and build: the card's name and power limit (nvidia-smi), every
   kernel built from the CUDA C++ sources in the checkout (one nvcc per
   source, all started together), build seconds.
2. Each kernel against its plain PyTorch version on the card, at the
   shapes of the serving path (and K1 at the train worker's [4096,
   2048]), within the tolerances in ``TOL``; kernel, plain and library
   times (CUDA events) beside the least time the card could take
   (``bound_ms``).  K1's lines also split its back-to-back time into
   the device time of a launch (a CUDA graph of launches replayed under
   events) and the host microseconds of a wrapper call.
2b. The backward kernels K3 (dq) and K4 (dk/dv) against the plain
   backward (``reference_attention_bwd``) at the flagship training shape
   [192, 2048, 128] bf16 causal, at ragged shapes causal and not, f32
   and bf16, and at K2's serving shape; with times as in phase 2.
3. The slot-pool server (``KV_PAGE_TOKENS=0``) of the port's worker at
   the flagship width (bench.py ``flagship_config``: vocab 32768,
   d_model 2048, 16/16 heads, d_ff 8192, bf16; depth 12) answers
   /generate requests; kernels K1 and K2 must have launched.
4. The paged server (the default) answers the same requests, with a
   shared prefix so the prefix cache is hit; K1 must have launched and
   K2 not (paged attention is plain PyTorch, as in the JAX package).
5. Greedy outputs of the paged and slot paths are token-identical on a
   2-layer f32 model at the same width.
6. Train-step parity: one ``make_train_step`` (AdamW) of a 2-layer f32
   model at the flagship width on the card (kernels) against the same
   step on the CPU (plain versions), same weights and batch.
7. The port's train worker at the flagship width (bench.py
   ``flagship_config``: 12 layers, seq 2048, remat full with one stored
   layer, bf16) takes 6 steps from scratch, writes a checkpoint, and a
   second run resumes from it to step 8; K1-K4 launch exactly the
   counts the remat policy implies.  Then ``make_train_step`` at
   bench.py's training batch (12) is timed: tokens/s, step ms, peak
   device memory; two more steps run under ``torch.profiler``, the
   first its warm-up, and the second's trace gives the ten device
   operations that took the most time in it, the port's kernels (each
   kernel's launches in the trace must equal its counter's), the device
   time by kind of work and the device's busy share of the step.
9. The MoE flagship (bench.py ``moe_flagship_config``: the flagship's
   width with 4 experts of d_ff 2048, top-2) served on both pool paths
   as in phases 3 and 4, with the same kernel rules.
10. MoE parity in f32: phase 6's train step on a 2-layer MoE model
   (capacity factor 1.25), its routing (every top-k choice) compared
   card against CPU first, with the smallest top-k probability margin
   of the CPU run; then phase 5's cross-path check on the MoE model.
11. The MoE train worker (full remat, no stored layer) from scratch and
   resumed from its checkpoint, then ``make_train_step`` at bench.py
   bench_moe's batch 8 timed and profiled as in phase 7, the profile's
   device time split first into the MoE parts (routing, the dispatch
   and combine einsums, the expert FFN: ``time_by_part``).
12. The gang step (``make_train_step(mesh=...)``).  (a) A world of one
   over NCCL, through the port's rendezvous (``tcp://127.0.0.1``): the
   flagship (12 layers, bf16, batch 12) against the no-mesh step, 2
   steps bit for bit (or within 1e-6 relative), then both timed.  (b)
   Two processes on the one card joined by gloo, at the flagship's
   width cut to 4 layers, global batch 4: the dense model under dp2,
   tp2 and fsdp2, the MoE under tp2 and ep2, each against the
   one-process step on the card (bf16: the loss within 1e-2; f32 at 2
   layers and seq 256, TF32 off: the loss within 1e-5, the first
   step's gradients and the params as ``compare_f32`` says); K2-K4 launch on each rank's rows and h/tp
   heads; each step's time split into collectives and compute.
13. The serving gang (``frameworks/serve_gang_worker.py`` ``build_rank``:
   the whole gang one tp axis, rank 0 driving the others with one tick
   broadcast each, over gloo).  (a) Two processes on the one card over
   gloo, f32 (TF32 off), the flagship's width at 2 layers, on both
   pools: the greedy replies to 8 requests (16 new tokens each, one at
   a time) equal one process's, and the prefill logits of a 900-token
   prompt are within ``GANG_F32_LOGITS_RTOL`` of one process's.  (b)
   The bf16 flagship at full width served by the tp2 gang on both pools
   over phase 3's mix: every reply has its length; tokens/s, TTFT, the
   decode step and its collectives' share (``timed_collectives``); K1
   and K2 launch on each rank at its 8 heads (K2 on the slot pool only)
   and are held against their plain versions at every shape a rank
   gave them.
14. Between 13(b)'s slot gang and its paged one: the port's
   ``RouterServer`` in front of the gang's rank 0 and a single-card
   serve worker (a process of its own), discovered through a stub of
   the scheduler's ``/v1/endpoints/<vip>``.  Routed greedy replies
   equal the pods' direct ones; the single pod is then killed while it
   decodes, and every request completes (failed over to the gang).
15. Long context: two processes on the one card joined by gloo, each
   layout against one process on the card on the whole sequence and
   the full params.  (a) f32 (TF32 off), the flagship's width at 2
   layers, 512 positions a rank, batch 2: Ulysses and ring over sp2
   (``make_train_step(mesh=...)`` on each rank's chunk; the loss within
   1e-5, the first step's gradients and the params after 2 AdamW steps
   as ``compare_f32`` says) and the pipeline over pp2 in 2
   microbatches (``pipeline_value_and_grad`` and AdamW on each stage's
   leaves, held the same way).  (b) The bf16 flagship at full width and
   depth, 2048 positions a rank: Ulysses and ring over sp2 (a context
   of 4096, batch 1, 3 steps) and the pipeline over pp2 (batch 4, 4
   microbatches, 2 steps), the loss within 1e-2 of one process; step
   ms, tokens/s and the split into collectives and compute.  Ulysses
   ranks launch K2-K4 at [8, 4096, 4096, 128], the ring none of them.
16. The MNIST job (BASELINE.json config 3): (a)
   ``dcos_commons_tpu_torch/frameworks/train_mnist.py`` as a subprocess
   with no ``TORCH_DEVICE``, as the scheduler launches it: exit 0, a
   cuda device, the loss down over its 60 steps; (b) the same numpy MLP
   weights and batch on the card and the CPU, the forward and 3 Adam
   steps, f32 (TF32 off) and bf16, within ``MLP_TOL``, and one step
   timed under CUDA events (ms, samples/s).  The path runs none of
   K1-K4: their counters, set to 0 before it, read 0 after.
17. shardcheck on the card: (a) the port's footprint of phase 7's timed
   step (the flagship, batch 12), section by section, against its
   measured peak: params + gradients + optimizer state must fit under
   it; the whole prediction and its ratio to the peak are printed, not
   gated; (b) ``GENERATION_HBM_MB["h100"]`` holds no more than the
   card's ``total_memory``.
8. Run last: every kernel against its plain version at each shape the
   train runs of phases 7, 11, 12 and 15 launched it at (K1 [24576,
   16384 or 4096, 2048] bf16, K2-K4 [192, 128 or 32, 2048, 2048, 128]
   bf16 causal, the gang's, and Ulysses' [8, 4096, 4096, 128]), within
   ``TOL``.

``python3 chip_smoke.py --nccl-gang`` (a host with 2 or 4 cards) runs
phase 12 over NCCL instead, rank r on card r (four cards: dp2 x tp2,
fsdp2 x tp2, dcn2 x tp2, dp4 and the MoE under ep2 x tp2), then the
gang train worker on every card, from scratch and resumed, then phase
13(b)'s serving gang at tp2 or tp4 over NCCL, one rank a card, then
long context over NCCL: ``collective_bandwidth`` (psum, all_gather,
reduce_scatter, the ring hop; 64 MB a rank) over every card and
``single_chip_rooflines`` on card 0, then phase 15(b)'s layouts (two
cards: Ulysses and ring sp2, pp2; four: Ulysses and ring sp4 at a
context of 8192, Ulysses sp2 x tp2, pp2 x dp2); nothing else but 17(c):
the gang train worker's steplog beside shardcheck's NVLink wire model
of its dp layout (``stepcompare``, reported, not gated).

Each kernel's log line gives its error, its time, the plain version's,
the library call's and the bound, the rate it reached (TFLOP/s) and its
time over the library call's.  Each phase has its own time limit: one
that outlives it (a kernel that hangs the card) is named and ends the
run with exit code 3.

The line before the last is a JSON object ``{"kernels": [...]}``; each
entry's ``launches`` sums the main-path runs, dense and MoE (phases 3,
4, 7, 9, 11 and 12, both ranks of 12(b), of 13(b) and 14 and of 15),
and its ``design`` says how it computes (K1: a warp a
row with 16-byte vector loads, launched through ctypes; K2-K4: wgmma
with TMA-fed tiles in bf16, f32 FMA in f32).  The last line is ``{"ok":
true, "device": {...}}``.  Without CUDA, or without the port beside it,
the script fails before printing either.
"""

import contextlib
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s and
# the flop rate of the type the operations run in
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# kernel vs plain version on the card, as (atol, rtol):
# K1 f32: the same arithmetic in another order; bf16: the output is
# rounded once to bf16 on both sides, so a tie may land one ulp
# (2^-8 relative) apart.  K2 f32: sums of up to 960 products in
# another order; bf16: the kernel rounds p to bf16 before P V, as the
# TPU kernel does, and the plain version keeps it f32, so an output may
# land one bf16 ulp away (2^-8 relative).  lse: f32 on both sides.
# K3/K4 against the plain backward: f32 as the largest absolute error
# (sums of up to 2048 products in another order, twice nested: s and
# dp, then ds times k or q); bf16 as the relative Frobenius error
# ||got - want|| / ||want||.  Both sides round ds and p to bf16 before
# the products, so the sound kernels read 0 to 1.9e-4 on the card
# (PERF.md: the FMA kernels up to 6.0e-5, K4 on the tensor cores up to
# 1.9e-4); a backward that keeps ds and p in f32 reads 2.4e-3 to 2.7e-3
# against the plain one at the phase 2b shapes (tests/test_torch_ops.py
# measures it on the CPU), so the limit sits between the two.
TOL = {
    ("K1", torch.float32): (1e-5, 1e-5),
    ("K1", torch.bfloat16): (1.6e-2, 1.6e-2),
    ("K2", torch.float32): (2e-5, 2e-4),
    ("K2", torch.bfloat16): (1.6e-2, 1.6e-2),
    ("lse", torch.float32): (1e-4, 1e-5),
    ("K3/K4", torch.float32): 1e-4,
    ("K3/K4", torch.bfloat16): 5e-4,
}

FLAGSHIP_ENV = {
    "VOCAB": "32768", "D_MODEL": "2048", "N_LAYERS": "12",
    "N_HEADS": "16", "N_KV_HEADS": "16", "D_FF": "8192",
    "MAX_LEN": "1024", "MAX_NEW_TOKENS": "64", "SERVE_BATCH": "8",
    "TORCH_DEVICE": "cuda", "PORT_HTTP": "0",
}


def log(msg):
    print(msg, flush=True)


def time_ms(fn, iters=20, warmup=3):
    """Mean time of ``fn()`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, n=50, reps=5):
    """Device time of one ``fn()``: n calls captured in a CUDA graph,
    the graph replayed under CUDA events, so no host work lies between
    the launches."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * n)


def host_us(fn, n=200):
    """Host microseconds of one ``fn()`` call: the host clock around n
    back-to-back calls, before the card is waited for."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def bound(n_bytes, flops, dtype):
    """(least ms, "bytes" or "operations") on the H100."""
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(name, got, want, tol):
    atol, rtol = tol
    err = (got.float() - want.float()).abs()
    limit = atol + rtol * want.float().abs()
    if not torch.isfinite(got.float()).all() or bool((err > limit).any()):
        raise AssertionError(
            f"{name}: max_abs_err {err.max().item():.3e} beyond "
            f"atol {atol} rtol {rtol}"
        )
    return err.max().item()


class Watchdog:
    """A time limit for each phase.  A kernel that hangs the card (a
    barrier phase out of step) would hold the run until its outer limit;
    instead the phase that outlives its own limit is named and the
    process ends with exit code 3, printing no result."""

    def __init__(self):
        self.timer = None

    def phase(self, name, seconds):
        self.stop()

        def expire():
            log(f"phase {name} exceeded its {seconds} s limit")
            os._exit(3)

        self.timer = threading.Timer(seconds, expire)
        self.timer.daemon = True
        self.timer.start()

    def stop(self):
        if self.timer is not None:
            self.timer.cancel()
            self.timer = None


class ShapeLog:
    """Records the shapes a kernel wrapper is called with on the main
    path (the wrapper itself counts the launches)."""

    def __init__(self, module, name, key):
        self.key = key
        self.inner = getattr(module, name)
        self.shapes = {}
        setattr(module, name, self)

    def __call__(self, *args, **kw):
        k = self.key(*args, **kw)
        self.shapes[k] = self.shapes.get(k, 0) + 1
        return self.inner(*args, **kw)

    @property
    def launches(self):
        # the wrapper counts through its module-level name, which is
        # this object while the log is installed
        return self.inner.launches

    @launches.setter
    def launches(self, value):
        self.inner.launches = value

    def reset(self):
        self.shapes = {}
        self.inner.launches = 0

    def busiest(self):
        """The shape with the most launches (ties: the largest)."""
        return max(self.shapes, key=lambda s: (self.shapes[s], s[:-1]))


def install_shape_logs():
    """A ShapeLog on each kernel's wrapper: {"K1": ..., "K4": ...}."""
    from dcos_commons_tpu_torch.ops import attention, rmsnorm

    logs = {
        "K1": ShapeLog(rmsnorm, "rms_norm_kernel",
                       lambda x, w, eps=None: (x.shape[0], x.shape[1],
                                               x.dtype)),
        "K2": ShapeLog(attention, "flash_fwd_kernel",
                       lambda q, k, v, causal, lse=False: (
                           q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                           bool(causal), q.dtype)),
    }
    for name, fn in (("K3", "flash_dq_kernel"), ("K4", "flash_dkv_kernel")):
        logs[name] = ShapeLog(
            attention, fn,
            lambda q, k, v, do, lse, di, causal: (
                q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                bool(causal), q.dtype))
    return logs


# -- phase 2: kernels against their plain versions -----------------------


def k1_case(rows, d, dtype, gen):
    from dcos_commons_tpu_torch.ops import rmsnorm

    x = torch.randn(rows, d, device="cuda", generator=gen).to(dtype)
    w = (1 + 0.1 * torch.randn(d, device="cuda", generator=gen)).to(dtype)
    kern = getattr(rmsnorm.rms_norm_kernel, "inner", rmsnorm.rms_norm_kernel)
    y = kern(x, w)
    torch.cuda.synchronize()
    err = check(f"K1 rows={rows} d={d} {dtype}", y,
                rmsnorm._reference(x, w), TOL[("K1", dtype)])
    ms = time_ms(lambda: kern(x, w))
    plain_ms = time_ms(lambda: rmsnorm._reference(x, w))

    def library():
        return torch.nn.functional.rms_norm(x, (d,), w, eps=rmsnorm.EPS)

    lib_ms = time_ms(library)
    # each captured call keeps its own output in the graph's memory pool
    n_graph = 20 if rows * d > 2**22 else 50
    item = x.element_size()
    b_ms, b_by = bound(2 * rows * d * item + d * item, 4 * rows * d,
                       torch.float32)
    return dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by, flops=4 * rows * d,
                device_ms=device_ms(lambda: kern(x, w), n_graph),
                host_us=host_us(lambda: kern(x, w)),
                library_device_ms=device_ms(library, n_graph),
                library_host_us=host_us(library))


def k2_pairs(sq, sk, causal):
    if not causal:
        return sq * sk
    i = np.arange(sq)
    return int(np.minimum(i + 1, sk).sum())


def k2_case(bh, sq, sk, hd, dtype, causal, gen, iters=20):
    from dcos_commons_tpu_torch.ops import attention

    kern = getattr(attention.flash_fwd_kernel, "inner",
                   attention.flash_fwd_kernel)
    q = torch.randn(bh, sq, hd, device="cuda", generator=gen).to(dtype)
    k = torch.randn(bh, sk, hd, device="cuda", generator=gen).to(dtype)
    v = torch.randn(bh, sk, hd, device="cuda", generator=gen).to(dtype)
    o, lse = kern(q, k, v, causal, True)
    torch.cuda.synchronize()
    q4, k4, v4 = (t[None] for t in (q, k, v))
    tag = f"K2 bh={bh} sq={sq} sk={sk} hd={hd} causal={causal} {dtype}"
    err = check(tag, o[None], attention.reference_attention(q4, k4, v4,
                                                            causal),
                TOL[("K2", dtype)])
    check(tag + " lse", lse, attention.reference_lse(q4, k4, causal),
          TOL[("lse", torch.float32)])
    ms = time_ms(lambda: kern(q, k, v, causal, False), iters)
    plain_ms = time_ms(
        lambda: attention.reference_attention(q4, k4, v4, causal), iters
    )
    lib_ms = None
    if sq == sk or not causal:
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_ms = time_ms(lambda: sdpa(q4, k4, v4, is_causal=causal), iters)
    item = q.element_size()
    n_bytes = (2 * bh * sq * hd + 2 * bh * sk * hd) * item
    flops = 4 * hd * bh * k2_pairs(sq, sk, causal)
    b_ms, b_by = bound(n_bytes, flops, dtype)
    return dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by, flops=flops)


def k34_case(bh, sq, sk, hd, dtype, causal, gen, iters=20):
    """K3 and K4 against the plain backward, on K2's forward outputs.
    Returns (K3 result, K4 result); plain and library times cover the
    whole backward (dq, dk and dv) and stand on both."""
    from dcos_commons_tpu_torch.ops import attention

    fwd = getattr(attention.flash_fwd_kernel, "inner",
                  attention.flash_fwd_kernel)
    k3 = getattr(attention.flash_dq_kernel, "inner",
                 attention.flash_dq_kernel)
    k4 = getattr(attention.flash_dkv_kernel, "inner",
                 attention.flash_dkv_kernel)
    q, do = (torch.randn(bh, sq, hd, device="cuda", generator=gen).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(bh, sk, hd, device="cuda", generator=gen).to(dtype)
            for _ in range(2))
    o, lse = fwd(q, k, v, causal, True)
    di = (do.float() * o.float()).sum(-1)
    dq = k3(q, k, v, do, lse, di, causal)
    dk, dv = k4(q, k, v, do, lse, di, causal)
    torch.cuda.synchronize()
    q4, k4_, v4, o4, do4 = (t[None] for t in (q, k, v, o, do))
    want = attention.reference_attention_bwd(q4, k4_, v4, o4, lse, do4,
                                             causal)
    tag = f"bh={bh} sq={sq} sk={sk} hd={hd} causal={causal} {dtype}"
    errs = {}
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        diff = got.float() - w[0].float()
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"K3/K4 {tag} {name}: not finite")
        max_abs = diff.abs().max().item()
        metric = (max_abs if dtype == torch.float32
                  else (diff.norm() / w[0].float().norm()).item())
        if metric > TOL[("K3/K4", dtype)]:
            raise AssertionError(
                f"K3/K4 {tag} {name}: error {metric:.3e} beyond "
                f"{TOL[('K3/K4', dtype)]}"
            )
        errs[name] = (max_abs, metric)
    lib_err = None
    if sq == sk or not causal:
        # the library's backward against the same plain version, as a
        # yardstick for the tensor cores' own rounding (reported only)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (q4, k4_, v4)]
        lib_grads = torch.autograd.grad(sdpa(*leaves, is_causal=causal),
                                        leaves, do4)
        lib_err = max(((g[0].float() - w[0].float()).norm()
                       / w[0].float().norm()).item()
                      for g, w in zip(lib_grads, want))
        del leaves, lib_grads
    del want
    plain_ms = time_ms(
        lambda: attention.reference_attention_bwd(q4, k4_, v4, o4, lse, do4,
                                                  causal),
        iters=max(2, iters // 4),
    )
    lib_ms = None
    if sq == sk or not causal:
        sdpa = torch.nn.functional.scaled_dot_product_attention
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (q4, k4_, v4)]

        def fwd_bwd():
            torch.autograd.grad(sdpa(*leaves, is_causal=causal), leaves, do4)

        with torch.no_grad():
            fwd_ms = time_ms(lambda: sdpa(*leaves, is_causal=causal), iters)
        lib_ms = time_ms(fwd_bwd, iters) - fwd_ms
    item = q.element_size()
    pairs = bh * k2_pairs(sq, sk, causal)
    rows = 2 * bh * sq * 4                      # lse and di, f32
    out = []
    for name, fn, flops, n_bytes, err_names in (
        ("K3", lambda: k3(q, k, v, do, lse, di, causal), 6 * hd * pairs,
         (3 * bh * sq * hd + 2 * bh * sk * hd) * item + rows, ("dq",)),
        ("K4", lambda: k4(q, k, v, do, lse, di, causal), 8 * hd * pairs,
         (2 * bh * sq * hd + 4 * bh * sk * hd) * item + rows, ("dk", "dv")),
    ):
        b_ms, b_by = bound(n_bytes, flops, dtype)
        out.append(dict(
            err=max(errs[e][0] for e in err_names),
            metric=max(errs[e][1] for e in err_names),
            ms=time_ms(fn, iters), plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=b_ms, bound_by=b_by, flops=flops, library_err=lib_err,
        ))
    return out


def phase_backward(gen):
    """Phase 2b: K3 and K4 at the training shape, ragged shapes and
    K2's serving shape.  Returns the largest max-abs error of each and
    the results at the training shape."""
    errs = {"K3": 0.0, "K4": 0.0}
    shapes = [(192, 2048, 2048, 128, True, torch.bfloat16)]
    for bh, s, hd in ((2, 200, 128), (8, 100, 64)):
        for causal in (True, False):
            for dtype in (torch.float32, torch.bfloat16):
                shapes.append((bh, s, s, hd, causal, dtype))
    shapes.append((16, 257, 257, 128, True, torch.bfloat16))
    train_shape = None
    for bh, sq, sk, hd, causal, dtype in shapes:
        r3, r4 = k34_case(bh, sq, sk, hd, dtype, causal, gen,
                          iters=5 if sq > 1000 else 20)
        design = "wgmma+tma" if dtype == torch.bfloat16 else "fma"
        for name, r in (("K3 flash_dq", r3), ("K4 flash_dkv", r4)):
            errs[name[:2]] = max(errs[name[:2]], r["err"])
            log(f"{name} ({design}) [{bh}, {sq}, {sk}, {hd}] causal={causal} "
                f"{dtype}: checked error {r['metric']:.3e}  {fmt(r)}")
        if train_shape is None:
            train_shape = (r3, r4)
    return errs, train_shape


def fmt_k1(r):
    """A K1 case's log: ``fmt`` and the split of its back-to-back time
    into device time and host time, beside ``F.rms_norm``'s."""
    return (f"{fmt(r)}  | device {r['device_ms']:.4f} ms/launch, host "
            f"{r['host_us']:.1f} us/call; F.rms_norm device "
            f"{r['library_device_ms']:.4f} ms, host "
            f"{r['library_host_us']:.1f} us")


def fmt(r):
    """A case's log: error, times, the rate the kernel reached (its
    operations over its time) and its time over the library call's
    (for K3 and K4, over the whole backward's: SDPA computes dq, dk and
    dv in one call; there also the library's own relative Frobenius
    error against the plain backward, the largest of dq, dk, dv)."""
    lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
    ratio = ("n/a" if r["library_ms"] is None
             else f"{r['ms'] / r['library_ms']:.2f}x")
    lib_err = ("" if r.get("library_err") is None
               else f"  library's own error {r['library_err']:.3e}")
    return (f"max_abs_err {r['err']:.3e}  kernel {r['ms']:.4f} ms  plain "
            f"{r['plain_ms']:.4f} ms  library {lib} ms  bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})  "
            f"{r['flops'] / r['ms'] / 1e9:.1f} TFLOP/s  kernel/library "
            f"{ratio}{lib_err}")


def phase_kernels(gen):
    errs = {"K1": 0.0, "K2": 0.0}
    k1_shapes = [(rows, dtype) for dtype in (torch.bfloat16, torch.float32)
                 for rows in (1, 8, 64, 960)]
    # ... and the train worker's shape, where K1 is launch-bound too
    for rows, dtype in k1_shapes + [(4096, torch.bfloat16)]:
        r = k1_case(rows, 2048, dtype, gen)
        errs["K1"] = max(errs["K1"], r["err"])
        log(f"K1 rms_norm [{rows}, 2048] {dtype}: {fmt_k1(r)}")
    for dtype in (torch.bfloat16, torch.float32):
        for s in (64, 200, 960):
            for causal in (True, False):
                r = k2_case(16, s, s, 128, dtype, causal, gen)
                errs["K2"] = max(errs["K2"], r["err"])
                log(f"K2 flash_fwd [1, 16, {s}, 128] causal={causal} "
                    f"{dtype}: {fmt(r)}")
    r = k2_case(8, 300, 300, 64, torch.bfloat16, True, gen)
    errs["K2"] = max(errs["K2"], r["err"])
    log(f"K2 flash_fwd [1, 8, 300, 64] causal=True bf16: {fmt(r)}")
    r = k2_case(16, 100, 260, 128, torch.float32, True, gen)
    errs["K2"] = max(errs["K2"], r["err"])
    log(f"K2 flash_fwd [1, 16, 100/260, 128] causal=True f32 (top-left): "
        f"{fmt(r)}")
    return errs


# -- phases 3-5: the serving path ----------------------------------------


def requests_for(vocab, seed=0):
    """Eight prompts of 100..900 tokens; three share a 256-token prefix
    (one in each half, see ``serve``: prefix caching on the paged
    path); one samples (temperature 0.8)."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, 256).tolist()
    out = []
    for i, n in enumerate((120, 900, 333, 512, 100, 700, 257, 640)):
        body = rng.integers(0, vocab, n).tolist()
        if i in (2, 4, 6):
            body = prefix + body[: max(1, n - 256)]
        out.append({"tokens": [body], "max_new_tokens": 64,
                    "temperature": 0.8 if i == 5 else 0.0})
    return out


def post(port, path, body=None, timeout=600):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data,
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        if resp.status != 200:
            raise AssertionError(f"{path}: HTTP {resp.status}")
        return json.loads(resp.read())


def post_waves(port, requests):
    """POST ``requests`` to /generate in two concurrent waves (the second
    finds the first's shared prefix pages fully prefilled, so the paged
    path's prefix cache can hit).  Returns (replies, wall seconds)."""
    replies = [None] * len(requests)
    errors = []

    def client(i):
        try:
            replies[i] = post(port, "/generate", requests[i])
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    t0 = time.monotonic()
    half = len(requests) // 2
    for wave in (range(half), range(half, len(requests))):
        clients = [threading.Thread(target=client, args=(i,))
                   for i in wave]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=900)
    wall = time.monotonic() - t0
    if errors:
        raise errors[0]
    return replies, wall


def check_replies(requests, replies, vocab):
    """Every reply one row of the requested length, in the vocabulary."""
    for req, rep in zip(requests, replies):
        toks = rep["tokens"]
        if len(toks) != 1 or len(toks[0]) != req["max_new_tokens"]:
            raise AssertionError(f"reply of the wrong length: {rep}")
        if not all(0 <= t < vocab for t in toks[0]):
            raise AssertionError(f"token out of range: {toks[0]}")


def serve(env, requests, logs):
    """Start the port's worker in a thread, reset the counters, drive
    ``requests`` in two concurrent waves, read the counters.  Returns (replies,
    launches by kernel, stats, wall seconds)."""
    from dcos_commons_tpu_torch.frameworks.serve_worker import build_server

    from dcos_commons_tpu_torch.utils import param_bytes, param_count

    served = build_server(env, log=log, ready_file="")
    log(f"params: {param_count(served.pool.params)} "
        f"({param_bytes(served.pool.params) / 1e9:.3f} GB)")
    thread = threading.Thread(target=served.server.serve_forever,
                              daemon=True)
    thread.start()
    try:
        torch.cuda.synchronize()
        for shape_log in logs.values():
            shape_log.reset()
        replies, wall = post_waves(served.port, requests)
        torch.cuda.synchronize()
        launches = {n: s.inner.launches for n, s in logs.items()}
        stats = post(served.port, "/stats")
    finally:
        served.server.shutdown()
        served.server.server_close()
        served.engine.stop()
    check_replies(requests, replies, int(env["VOCAB"]))
    del served
    torch.cuda.empty_cache()
    return replies, launches, stats, wall


def report_serving(name, replies, launches, stats, wall):
    n_tok = sum(len(r["tokens"][0]) for r in replies)
    log(f"{name}: {len(replies)} requests, {n_tok} tokens in {wall:.3f} s "
        f"= {n_tok / wall:.1f} tok/s; ttft p50 "
        f"{stats.get('ttft_p50_s')} s p95 {stats.get('ttft_p95_s')} s; "
        f"launches {launches}")
    log(f"{name} /stats: {json.dumps(stats, sort_keys=True)}")


def cross_path_check(env=FLAGSHIP_ENV, label="f32"):
    """Greedy tokens of the paged and slot paths on a 2-layer f32 model
    at the width of ``env`` must be identical."""
    from dcos_commons_tpu_torch.models import config_from_env, init_params
    from dcos_commons_tpu_torch.serve.engine import PagedEngine, SlotEngine
    from dcos_commons_tpu_torch.serve.pool import PagedPoolModel, PoolModel

    config = config_from_env(dict(env, N_LAYERS="2"), dtype=torch.float32,
                             remat=False)
    params = init_params(config, seed=1, device="cuda")
    prompts = [r["tokens"][0][:300] for r in requests_for(config.vocab, 1)]
    max_len, prompt_len, n_new = 384, 320, 32
    outs = []
    for paged in (False, True):
        if paged:
            pool = PagedPoolModel(config, params, 4, max_len, 16, 96, 64)
            engine = PagedEngine(pool.prefill_chunk, pool.decode, 4, max_len,
                                 prompt_len, page_tokens=16, pages=96,
                                 chunk_tokens=64, prefix_cache=True)
        else:
            pool = PoolModel(config, params, 4, max_len)
            engine = SlotEngine(pool.prefill, pool.decode, 4, max_len,
                                prompt_len)
        try:
            outs.append(engine.submit(prompts, n_new))
        finally:
            engine.stop()
        del pool
    if outs[0] != outs[1]:
        raise AssertionError(f"paged and slot greedy outputs differ ({label})")
    log(f"cross-path {label}: {len(prompts)} prompts x {n_new} tokens "
        f"identical")


# -- phases 6-7: the train path ------------------------------------------

TRAIN_ENV = {
    "VOCAB": "32768", "D_MODEL": "2048", "N_LAYERS": "12",
    "N_HEADS": "16", "N_KV_HEADS": "16", "D_FF": "8192", "SEQ_LEN": "2048",
    "TORCH_DEVICE": "cuda", "KEEPALIVE_S": "0",
}
# bench.py flagship_config: full remat (the config's default) with the
# last layer stored
NO_REMAT_LAYERS = 1
TRAIN_BATCH = 12          # bench.py bench_transformer's batch
LR = 3e-4
# bench.py moe_flagship_config: the flagship's width with 4 experts of
# d_ff 2048 (top-2), capacity factor 1.25, full remat with no stored
# layer; bench_moe trains it at batch 8.  The workers take N_EXPERTS and
# D_FF from the env and keep config_from_env's capacity factor (1.5), as
# the JAX workers do
MOE_ENV = {"N_EXPERTS": "4", "D_FF": "2048"}
MOE_CAPACITY = 1.25
MOE_BATCH = 8


def launches_per_step(n_layers, no_remat_layers):
    """Kernel launches of one train step under full remat with the last
    ``no_remat_layers`` stored: the forward runs every layer (K1 twice
    a layer plus the final norm, K2 once); the backward recomputes the
    forward of each checkpointed layer (K1 twice, K2 once; the norm
    backward is autograd on the plain version, as in the JAX package)
    and runs K3 and K4 once a layer."""
    recomputed = n_layers - no_remat_layers
    return {"K1": 2 * n_layers + 1 + 2 * recomputed,
            "K2": n_layers + recomputed, "K3": n_layers, "K4": n_layers}


class RoutingLog:
    """While installed, records each MoE routing call's top-k choices and
    router probabilities (``models/moe.py`` ``_route``) on the host."""

    def __init__(self):
        from dcos_commons_tpu_torch.models import moe

        self.moe, self.inner, self.calls = moe, moe._route, []

    def __enter__(self):
        self.moe._route = self
        return self

    def __exit__(self, *exc):
        self.moe._route = self.inner

    def __call__(self, config, params, x):
        out = self.inner(config, params, x)
        self.calls.append((out[1].detach().cpu(), out[2].detach().cpu()))
        return out


def top_k_margins(probs, k):
    """Per token, the smallest gap between neighbouring probabilities
    among the first k + 1: how near the token's routing is to a tie."""
    top = probs.topk(min(k + 1, probs.shape[-1]), dim=-1).values
    return (top[..., :-1] - top[..., 1:]).min(-1).values


def compare_routing(card, cpu, top_k):
    """The card's routing calls against the CPU's, call by call.  A token
    routed differently is a fault unless its CPU margin is under 1e-6 (a
    tie: f32 sums in another order may break it either way); such ties
    are counted in the log line, beside the smallest CPU margin."""
    if len(card) != len(cpu):
        raise AssertionError(f"{len(card)} routing calls on the card, "
                             f"{len(cpu)} on the CPU")
    smallest, ties = float("inf"), 0
    for (idx_g, _), (idx_c, probs_c) in zip(card, cpu):
        margins = top_k_margins(probs_c, top_k)
        smallest = min(smallest, margins.min().item())
        differ = (idx_g != idx_c).any(-1)
        if differ.any():
            if (margins[differ] >= 1e-6).any():
                raise AssertionError(
                    f"routing differs at {int(differ.sum())} tokens, CPU "
                    f"margins {margins[differ].tolist()[:8]}")
            ties += int(differ.sum())
    log(f"  routing: {len(card)} calls, top-{top_k} choices equal card vs "
        f"CPU but {ties} tokens at ties; smallest CPU top-k margin "
        f"{smallest:.3e}")


def train_step_parity(env, label, **config_fields):
    """Phases 6 and 10: one make_train_step of a 2-layer f32 model, batch
    2, seq 256, on the card and on the CPU from the same weights and
    batch.  TF32 stays off
    (``torch.backends.cuda.matmul.allow_tf32`` is False), so both sides
    compute in f32.  Tolerances: the loss within 1e-5 relative and each
    gradient leaf within 1e-4 relative Frobenius error (f32 sums in
    another order).  After the AdamW step every param whose gradient is
    at least 100 eps (1e-6) agrees within 1e-6 + 1e-5 |p|.  Adam's first
    step moves a param by lr * g / (|g| + eps), whose slope lr * eps /
    (|g| + eps)^2 turns the gradients' rounding differences (about 1e-8
    absolute here) into step differences of up to 2 lr where |g| is
    near eps = 1e-8; those params are held to that 2 lr bound only.  A
    MoE model's routing (top-k choices of every routing call, the
    remat's recomputes included) is compared first."""
    from dcos_commons_tpu_torch.models.transformer import (
        adamw, config_from_env, init_params, loss_fn, make_train_step,
    )
    from dcos_commons_tpu_torch.utils.tree import tree_leaves, tree_map

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("train-step parity needs TF32 off")
    config = config_from_env(dict(env, N_LAYERS="2", SEQ_LEN="256"),
                             dtype=torch.float32, **config_fields)
    cpu_params = init_params(config, seed=3, device="cpu")
    toks = np.random.default_rng(3).integers(0, config.vocab, (2, 257))
    out, routes = {}, {}
    for dev in ("cuda", "cpu"):
        params = (cpu_params if dev == "cpu"
                  else tree_map(lambda t: t.to(dev), cpu_params))
        tokens = torch.from_numpy(toks[:, :-1]).to(dev)
        targets = torch.from_numpy(toks[:, 1:]).to(dev)
        optimizer = adamw(params, LR)
        leaves = tree_leaves(params)
        with RoutingLog() as routing:
            loss = loss_fn(config, params, tokens, targets)
            grads = [g.cpu() for g in torch.autograd.grad(loss, leaves)]
            step_loss = make_train_step(config, optimizer)(params, tokens,
                                                           targets)
        routes[dev] = routing.calls
        out[dev] = (loss.item(), grads, step_loss.item(),
                    [p.detach().cpu() for p in leaves])
    if config.n_experts > 0:
        compare_routing(routes["cuda"], routes["cpu"], config.moe_top_k)
    (loss_g, grads_g, step_g, params_g) = out["cuda"]
    (loss_c, grads_c, step_c, params_c) = out["cpu"]
    if not (np.isfinite(loss_g) and abs(loss_g - loss_c) <= 1e-5 * abs(loss_c)
            and abs(step_g - step_c) <= 1e-5 * abs(step_c)):
        raise AssertionError(f"train loss card {loss_g} / {step_g} vs cpu "
                             f"{loss_c} / {step_c}")
    grad_err = max(((g - c).norm() / c.norm()).item()
                   for g, c in zip(grads_g, grads_c))
    if grad_err > 1e-4:
        raise AssertionError(f"gradients differ: rel err {grad_err:.3e}")
    far, near_eps, total, max_diff, max_tight = 0, 0, 0, 0.0, 0.0
    for g, c, grad in zip(params_g, params_c, grads_c):
        diff = (g - c).abs()
        tight = grad.abs() >= 1e-6
        far += int((diff > 1e-6 + 1e-5 * c.abs())[tight].sum())
        near_eps += int((~tight).sum())
        total += c.numel()
        max_diff = max(max_diff, diff.max().item())
        if tight.any():
            max_tight = max(max_tight, diff[tight].max().item())
    if far or max_diff > 2 * LR * (1 + 1e-4) + 1e-6:
        raise AssertionError(f"params after the step: {far} with |g| >= "
                             f"1e-6 apart, max {max_diff:.3e}")
    log(f"train-step parity ({label}, 2 layers, f32, TF32 off): loss card "
        f"{loss_g:.6f} cpu {loss_c:.6f}; grad rel err {grad_err:.3e}; "
        f"params after AdamW: max |diff| {max_tight:.3e} where |g| >= 1e-6, "
        f"{max_diff:.3e} over all; {near_eps}/{total} params with |g| < "
        f"1e-6")


def run_train_worker(env, logs, start, steps, no_remat_layers):
    """One in-process run of the port's train worker; returns the
    launches by kernel, after checking the resume point, the losses
    and the launch counts against ``launches_per_step``."""
    from dcos_commons_tpu_torch.frameworks.train_worker import train

    torch.cuda.synchronize()
    for shape_log in logs.values():
        shape_log.reset()
    t0 = time.monotonic()
    result = train(dict(env, TRAIN_STEPS=str(steps)), log=log,
                   no_remat_layers=no_remat_layers)
    torch.cuda.synchronize()
    launches = {n: s.inner.launches for n, s in logs.items()}
    wall = time.monotonic() - t0
    if result.start != start or result.checkpoint_errors:
        raise AssertionError(f"train worker started at {result.start} "
                             f"(want {start}); {result.checkpoint_errors}")
    if not result.losses or not all(np.isfinite(list(result.losses.values()))):
        raise AssertionError(f"train losses {result.losses}")
    per_step = launches_per_step(int(env["N_LAYERS"]), no_remat_layers)
    want = {n: per_step[n] * (steps - start) for n in logs}
    if launches != want:
        raise AssertionError(f"train launches {launches}, want {want}")
    log(f"train worker steps {start}..{steps - 1}: losses {result.losses}; "
        f"{wall:.1f} s with checkpoint IO; launches {launches} "
        f"(per step {per_step})")
    return launches


# kernel names in a profile: the port's own, and kinds of library work
PORT_KERNELS = ("flash_fwd_", "flash_dq_", "flash_dkv_", "rms_norm_rows")
WORK_KINDS = (
    ("port kernels (K1-K4)", PORT_KERNELS),
    ("matmuls", ("gemm", "nvjet", "xmma", "cutlass")),
    ("elementwise and reductions (aten)", ("at::native",)),
)


# the MoE FFN's parts, by the function of models/moe.py that computes
# them; a profiled MoE step splits its device time over these first
MOE_PARTS = {
    "_routing": "MoE routing (router, top-k, slots: element-wise)",
    "_dispatch": "MoE dispatch/combine einsums",
    "_combine": "MoE dispatch/combine einsums",
    "_expert_ffn": "MoE expert FFN (matmuls, SwiGLU)",
}


class MoEScopes:
    """While installed, each MoE part runs inside a profiler range named
    ``moe.<function>``; the port's own code carries no ranges."""

    def __enter__(self):
        from dcos_commons_tpu_torch.models import moe

        self.moe = moe
        self.saved = {name: getattr(moe, name) for name in MOE_PARTS}
        for name, fn in self.saved.items():
            setattr(moe, name, self.scoped("moe." + name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.moe, name, fn)

    @staticmethod
    def scoped(label, fn):
        def run(*args, **kw):
            with torch.profiler.record_function(label):
                return fn(*args, **kw)
        return run


# device work in a Kineto trace, and the host spans that nest host ops
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_SPANS = ("cpu_op", "user_annotation")


def time_by_part(trace):
    """Device ms of a profile's Kineto trace (the dict
    ``export_chrome_trace`` writes) by MoE part, forward and backward,
    and the rest by kind of kernel (``WORK_KINDS``).  A device operation
    belongs to the host op of its ``External id``; that op belongs to a
    part when it ran inside the part's range (the forward, and remat's
    recompute of it), or inside the ``evaluate_function`` of an autograd
    node that a forward op in the range made: both carry the node's
    ``Sequence number``.  Host ops nest by time on their thread."""
    host = sorted((e for e in trace["traceEvents"] if e.get("ph") == "X"
                   and e.get("cat") in HOST_SPANS),
                  key=lambda e: (e["tid"], e["ts"], -e["dur"]))
    where, part_of_seq, stack = {}, {}, []
    for e in host:
        while stack and (stack[-1][0]["tid"] != e["tid"] or e["ts"]
                         >= stack[-1][0]["ts"] + stack[-1][0]["dur"]):
            stack.pop()
        ctx, in_bwd = stack[-1][1:] if stack else (None, False)
        args = e.get("args", {})
        if e["name"].startswith("moe."):
            ctx = ("part", MOE_PARTS[e["name"][4:]])
        elif e["name"].startswith("autograd::engine::evaluate_function"):
            ctx, in_bwd = ("node", args.get("Sequence number")), True
        if ctx and ctx[0] == "part" and not in_bwd \
                and args.get("Sequence number", -1) >= 0:
            part_of_seq[args["Sequence number"]] = ctx[1]
        where[args.get("External id")] = ctx
        stack.append((e, ctx, in_bwd))
    split = {}
    for e in trace["traceEvents"]:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_WORK:
            continue
        ctx = where.get(e.get("args", {}).get("External id"))
        kind = None
        if ctx:
            kind = ctx[1] if ctx[0] == "part" else part_of_seq.get(ctx[1])
        kind = kind or next((kind for kind, marks in WORK_KINDS
                             if any(m in e["name"] for m in marks)), "other")
        split[kind] = split.get(kind, 0.0) + e["dur"] / 1e3
    return split


def profile_step(run, top=10, moe=False):
    """Two ``run()``s under ``torch.profiler``, the first a warm-up it
    discards, the second recorded: logs the ``top`` device operations by
    device time, the port's kernels, the device time by kind of work
    (``time_by_part``, from the exported trace; with ``moe``, the MoE
    parts run in ranges and are split out first), and the device's busy
    time against the step's host-clock time (with the profiler on).
    Fails when the profiler records no device time, or when the trace
    holds another number of a kernel's launches than its wrapper
    counted in the recorded step.

    The warm-up: a profiling session's first kernels may reach the
    trace late or not at all.  Without it the MoE step, profiled after
    the dense one in the same process, lost its first layer's two K1
    and one K2 launches (counters K1 49, K2 24 a step; trace 47 and
    23), while the dense step, the process's first session, kept
    them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from dcos_commons_tpu_torch.ops import attention, rmsnorm

    counters = {"K1": rmsnorm.rms_norm_kernel,
                "K2": attention.flash_fwd_kernel,
                "K3": attention.flash_dq_kernel,
                "K4": attention.flash_dkv_kernel}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        with MoEScopes() if moe else contextlib.nullcontext():
            run()
            torch.cuda.synchronize()
            prof.step()
            before = {n: c.launches for n, c in counters.items()}
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            counted = {n: c.launches - before[n] for n, c in counters.items()}
            prof.step()
    # the ranges' own device spans (the MoE parts, the profiler's step)
    # would count their kernels twice
    ops = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and e.self_device_time_total > 0
           and not e.key.startswith(("moe.", "ProfilerStep"))]
    if not ops:
        raise AssertionError("torch.profiler recorded no device time")
    busy_ms = sum(e.self_device_time_total for e in ops) / 1e3
    log(f"profiled step: {wall_ms:.1f} ms on the host clock (profiler on), "
        f"device busy {busy_ms:.1f} ms ({busy_ms / wall_ms:.1%}) in "
        f"{sum(e.count for e in ops)} device operations of "
        f"{len(ops)} kinds; the top {top} by device time:")
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:top]:
        ms = e.self_device_time_total / 1e3
        log(f"  {ms:9.3f} ms {ms / busy_ms:6.1%} x{e.count:<5d} "
            f"{e.key[:110]}")
    # the port's kernels, and the step's device time by kind of work
    for e in ops:
        if any(k in e.key for k in PORT_KERNELS):
            ms = e.self_device_time_total / 1e3
            log(f"  port kernel {ms:9.3f} ms {ms / busy_ms:6.1%} "
                f"x{e.count:<5d} {e.key[:90]}")
    path = os.path.join(ROOT, "build", "smoke", "profiled_step.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    os.remove(path)
    split = time_by_part(trace)
    # each kernel's launches in the trace, by the kernel's full name (K1
    # has a template a vector width), against the wrappers' counters
    traced, names = {n: 0 for n in counters}, {}
    for e in trace["traceEvents"]:
        if e.get("ph") != "X" or e.get("cat") != "kernel":
            continue
        for n, mark in (("K1", "rms_norm_rows"), ("K2", "flash_fwd_"),
                        ("K3", "flash_dq_"), ("K4", "flash_dkv_")):
            if mark in e["name"]:
                traced[n] += 1
                names[e["name"][:80]] = names.get(e["name"][:80], 0) + 1
    log(f"  launches in the profiled step: counters {counted}, trace "
        f"{traced}; by name {names}")
    if traced != counted:
        raise AssertionError(f"the trace holds launches {traced}, the "
                             f"counters {counted}")
    log(f"  by kind ({sum(split.values()):.1f} ms attributed): " + ", ".join(
        f"{kind} {ms:.1f} ms ({ms / busy_ms:.1%})"
        for kind, ms in sorted(split.items(), key=lambda kv: -kv[1])))


def time_train_step(logs, config, batch, label, peaks, warmup=2, steps=5):
    """make_train_step of ``config`` at ``batch``: tokens/s, step ms and
    peak device memory (host clock around synchronised steps; the peak
    also into ``peaks[label]``), then one more step under the profiler
    (after its warm-up step)."""
    from dcos_commons_tpu_torch.models.transformer import (
        adamw, init_params, make_train_step,
    )
    from dcos_commons_tpu_torch.utils import synthetic_tokens

    params = init_params(config, seed=0, device="cuda")
    step = make_train_step(config, adamw(params, LR))
    tokens, targets = synthetic_tokens(
        batch, config.max_seq, config.vocab,
        torch.Generator(device="cuda").manual_seed(1),
    )
    for _ in range(warmup):
        step(params, tokens, targets)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for shape_log in logs.values():
        shape_log.reset()
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = step(params, tokens, targets)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    peaks[label] = peak
    if not np.isfinite(float(loss)):
        raise AssertionError(f"train loss {float(loss)}")
    log(f"train step {label} [batch {batch}, seq {config.max_seq}] bf16, "
        f"remat full + {config.no_remat_layers} stored layers: "
        f"{dt / steps * 1e3:.1f} ms/step, "
        f"{batch * config.max_seq * steps / dt:,.0f} tokens/s, peak "
        f"device memory {peak / 2**30:.2f} GiB, loss {float(loss):.4f}")
    profile_step(lambda: step(params, tokens, targets),
                 moe=config.n_experts > 0)
    launches = {n: s.inner.launches for n, s in logs.items()}
    per_step = launches_per_step(config.n_layers, config.no_remat_layers)
    # the timed steps, the profiler's warm-up step and the profiled one
    if launches != {n: per_step[n] * (steps + 2) for n in logs}:
        raise AssertionError(f"timed and profiled steps launched {launches}")
    del params, step
    torch.cuda.empty_cache()
    return launches


def phase_train(logs, env, no_remat_layers, steps, timed):
    """Phases 7 and 11: the train worker of ``env`` from scratch to
    ``steps[0]``, its resume to ``steps[1]``, then ``timed()`` (the timed
    step).  Returns the launches by kernel over the three runs and the
    shapes each kernel was launched at in them."""
    ckpt = os.path.join(ROOT, "build", "smoke", "train_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    # a flagship train-state checkpoint is params + two moments widened
    # to f32: 872,466,432 x 3 x 4 bytes = 10.5 GB (the MoE flagship's
    # 872,564,736 as many); with CHECKPOINT_KEEP 1 the next save lands
    # before the last is pruned
    free = shutil.disk_usage(os.path.join(ROOT, "build")).free
    log(f"disk free under build/: {free / 2**30:.1f} GiB")
    if free < 22e9:
        raise AssertionError("the train worker needs 22 GB of disk for "
                             "two flagship checkpoints")
    env = dict(env, CHECKPOINT_DIR=ckpt, CHECKPOINT_KEEP="1",
               SANDBOX=os.path.join(ROOT, "build", "smoke"))
    shapes = {n: set() for n in logs}

    def note_shapes():
        for n, shape_log in logs.items():
            shapes[n].update(shape_log.shapes)

    first, last = steps
    total = run_train_worker(env, logs, 0, first, no_remat_layers)
    note_shapes()
    names = sorted(n for n in os.listdir(ckpt) if n.startswith("step_"))
    if not names or not names[-1].startswith(f"step_{first:010d}"):
        raise AssertionError(f"no step-{first} checkpoint: {names}")
    for run in (lambda: run_train_worker(env, logs, first, last,
                                         no_remat_layers),
                timed):
        launches = run()
        note_shapes()
        total = {n: total[n] + launches[n] for n in total}
    shutil.rmtree(ckpt, ignore_errors=True)
    return total, shapes


def check_train_shapes(shapes, gen, checked):
    """Each kernel against its plain version at every shape the train
    path launched it at, but those in ``checked``.  Returns the largest
    max-abs error of each kernel."""
    errs = {n: 0.0 for n in shapes}
    for rows, d, dtype in sorted(shapes["K1"] - checked["K1"], key=str):
        r = k1_case(rows, d, dtype, gen)
        errs["K1"] = max(errs["K1"], r["err"])
        log(f"K1 rms_norm at train shape [{rows}, {d}] {dtype}: {fmt_k1(r)}")
    for bh, sq, sk, hd, causal, dtype in sorted(shapes["K2"] - checked["K2"],
                                                key=str):
        r = k2_case(bh, sq, sk, hd, dtype, causal, gen, iters=5)
        errs["K2"] = max(errs["K2"], r["err"])
        log(f"K2 flash_fwd at train shape [{bh}, {sq}, {sk}, {hd}] "
            f"causal={causal} {dtype}: {fmt(r)}")
    if shapes["K3"] != shapes["K4"]:
        raise AssertionError(f"K3 at {shapes['K3']}, K4 at {shapes['K4']}")
    for bh, sq, sk, hd, causal, dtype in sorted(shapes["K3"] - checked["K3"],
                                                key=str):
        for name, r in zip(("K3", "K4"), k34_case(bh, sq, sk, hd, dtype,
                                                   causal, gen, iters=5)):
            errs[name] = max(errs[name], r["err"])
            log(f"{name} at train shape [{bh}, {sq}, {sk}, {hd}] "
                f"causal={causal} {dtype}: checked error "
                f"{r['metric']:.3e}  {fmt(r)}")
    return errs


# -- phase 12: the gang step ------------------------------------------------

# phase 12(b)'s layouts: (label, extra env, MeshSpec fields)
GANG_LAYOUTS = (
    ("dense dp2", {}, {"dp": 2}),
    ("dense tp2", {}, {"tp": 2}),
    ("dense fsdp2", {}, {"fsdp": 2}),
    ("MoE tp2", MOE_ENV, {"tp": 2}),
    ("MoE ep2", MOE_ENV, {"ep": 2}),
)
# --nccl-gang on four cards: dp x tp, fsdp x tp, dcn x tp (the mesh
# mesh_from_env derives for TPU_NUM_SLICES=2, TPU_CHIPS_PER_HOST=2),
# pure dp, and the MoE under ep x tp
NCCL4_LAYOUTS = (
    ("dense dp2xtp2", {}, {"dp": 2, "tp": 2}),
    ("dense fsdp2xtp2", {}, {"fsdp": 2, "tp": 2}),
    ("dense dcn2xtp2", {}, {"dcn": 2, "tp": 2}),
    ("dense dp4", {}, {"dp": 4}),
    ("MoE ep2xtp2", MOE_ENV, {"ep": 2, "tp": 2}),
)
GANG_BATCH = 4            # the global batch of the gang phases
GANG_LAYERS = 4           # the flagship's width, depth cut to 4
GANG_STEPS = 2
# bf16 gang against one process: the loss within 1e-2 relative at each
# step (the gang's products run at other shapes and its partial sums
# round to bf16 before they are added: a few bf16 ulps, 2^-8 each, in
# the loss).  The params are held in f32 only (1e-5 where |g| >= 1e-6):
# in bf16 a MoE token whose top-k choice sits within rounding of a tie
# may route apart, which moves whole expert rows.  Their largest bf16
# difference is logged.
GANG_BF16_LOSS_RTOL = 1e-2


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def gang_config(extra, dtype, layers, seq):
    from dcos_commons_tpu_torch.models import config_from_env

    moe = {"moe_capacity_factor": MOE_CAPACITY} if extra else {}
    return config_from_env(dict(TRAIN_ENV, **extra, N_LAYERS=str(layers),
                                SEQ_LEN=str(seq)), dtype=dtype, **moe)


def gang_batch(config, batch):
    from dcos_commons_tpu_torch.utils import synthetic_tokens

    return synthetic_tokens(batch, config.max_seq, config.vocab,
                            torch.Generator(device="cuda").manual_seed(1))


def one_process_steps(config, steps, batch, mesh=None, trace=False):
    """``steps`` of make_train_step (on ``mesh``, or none) from the seed-0
    init at the fixed batch: (losses, params, and with ``trace`` the
    params' leaves after each step and the gradients each step applied)."""
    from dcos_commons_tpu_torch.models.transformer import (
        adamw, init_params, make_train_step,
    )
    from dcos_commons_tpu_torch.utils.tree import tree_leaves

    params = init_params(config, seed=0, device="cuda")
    optimizer = adamw(params, LR)
    step = make_train_step(config, optimizer, mesh=mesh)
    tokens, targets = gang_batch(config, batch)
    losses, after, grads = [], [], []
    if trace:
        optimizer.register_step_pre_hook(lambda *_: grads.append(
            [p.grad.detach().clone() for p in tree_leaves(params)]))
    for _ in range(steps):
        losses.append(float(step(params, tokens, targets)))
        if trace:
            after.append([p.detach().clone() for p in tree_leaves(params)])
    return losses, params, (after, grads)


def phase_gang_one(logs, flagship):
    """Phase 12(a): a world of one over NCCL, through the port's
    rendezvous: make_train_step(mesh=...) of the flagship (12 layers,
    bf16, batch 12) against the no-mesh step, 2 steps each from the same
    init, then 3 timed steps of each.  Returns the mesh runs' launches."""
    import torch.distributed as dist

    from dcos_commons_tpu_torch.parallel.distributed import init_gang
    from dcos_commons_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from dcos_commons_tpu_torch.utils.tree import tree_leaves

    init_gang(f"tcp://127.0.0.1:{free_port()}", 1, 0, "nccl", timeout_s=120)
    try:
        mesh = make_mesh(MeshSpec())
        ref_losses, ref, _ = one_process_steps(flagship, GANG_STEPS,
                                               TRAIN_BATCH)
        for shape_log in logs.values():
            shape_log.reset()
        losses, params, _ = one_process_steps(flagship, GANG_STEPS,
                                              TRAIN_BATCH, mesh)
        torch.cuda.synchronize()
        launches = {n: s.inner.launches for n, s in logs.items()}
        exact = losses == ref_losses and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                              tree_leaves(ref)))
        worst = max(((a.float() - b.float()).abs().max()
                     / b.float().abs().max().clamp_min(1e-30)).item()
                    for a, b in zip(tree_leaves(params), tree_leaves(ref)))
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                           ref_losses))
        if not exact and (worst > 1e-6 or loss_rel > 1e-6):
            raise AssertionError(
                f"mesh of one vs no mesh: losses {losses} / {ref_losses}, "
                f"params max rel diff {worst:.3e}")
        del params, ref
        torch.cuda.empty_cache()
        per_step = launches_per_step(flagship.n_layers,
                                     flagship.no_remat_layers)
        want = {n: per_step[n] * GANG_STEPS for n in logs}
        if launches != want:
            raise AssertionError(f"12(a) launches {launches}, want {want}")
        times = {}
        for label, m in (("no mesh", None), ("mesh of one", mesh)):
            from dcos_commons_tpu_torch.models.transformer import (
                adamw, init_params, make_train_step,
            )

            params = init_params(flagship, seed=0, device="cuda")
            step = make_train_step(flagship, adamw(params, LR), mesh=m)
            tokens, targets = gang_batch(flagship, TRAIN_BATCH)
            step(params, tokens, targets)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                step(params, tokens, targets)
            torch.cuda.synchronize()
            times[label] = (time.perf_counter() - t0) / 3 * 1e3
            del params, step
            torch.cuda.empty_cache()
        log(f"12(a) NCCL world of one, flagship [batch {TRAIN_BATCH}, seq "
            f"{flagship.max_seq}] bf16, {flagship.n_layers} layers: "
            f"{'bit for bit' if exact else f'max rel diff {worst:.3e}'} "
            f"against the no-mesh step (losses {losses}); step "
            f"{times['mesh of one']:.1f} ms on the mesh, "
            f"{times['no mesh']:.1f} ms without; launches {launches}")
    finally:
        dist.destroy_process_group()
    return launches


def compare_f32(gang, ref, gang_grads, grads):
    """The f32 gang against one process, by step, from leaf lists of the
    params after each step and of the gradients the step applied (the
    gang's after its reduction, gathered to full size).  For each step:
    ``grad_rel``, the largest relative Frobenius difference of a leaf's
    gradient (a leaf both sides give a zero gradient counts 0), and
    ``all``, the largest param difference.  After the first step also
    ``apart``, the params more than 1e-5 + 1e-5 |p| apart among those
    whose one-process gradient is at least 1e-6, and ``worst``, their
    largest difference (with its leaf, value and gradient): AdamW's
    first step moves a param by lr g / (|g| + 1e-8), steep in g near
    1e-8, so a smaller gradient may land up to 2 lr apart.  Later steps'
    params are held only to 2 lr a step: their gradients are taken at
    params the first step moved apart, and ``grad_rel`` shows how far."""
    out = []
    for k in range(len(gang)):
        grad_rel = 0.0
        for a, b in zip(gang_grads[k], grads[k]):
            apart_norm = (a - b).norm().item()
            grad_rel = max(grad_rel, 0.0 if apart_norm == 0 else
                           apart_norm / max(b.norm().item(), 1e-30))
        entry = dict(grad_rel=grad_rel, all=max(
            (a - b).abs().max().item() for a, b in zip(gang[k], ref[k])))
        if k == 0:
            apart, worst, where = 0, 0.0, None
            for j, (a, b) in enumerate(zip(gang[0], ref[0])):
                tight = grads[0][j].abs() >= 1e-6
                diff = torch.where(tight, (a - b).abs(),
                                   torch.zeros_like(b))
                apart += int((diff > 1e-5 + 1e-5 * b.abs()).sum())
                if diff.max().item() > worst:
                    i = int(diff.argmax())
                    worst, where = diff.max().item(), dict(
                        leaf=j, p=b.flatten()[i].item(),
                        g=grads[0][j].flatten()[i].item())
            entry.update(apart=apart, worst=worst, where=where)
        out.append(entry)
    return out


def time_gang_step(step, params, tokens, targets):
    """One step of every rank timed on the host clock, then one more
    with each collective bracketed by device synchronisations
    (``timed_collectives``): (step ms, timed ms, the collectives'
    stats: ``seconds``, ``calls``)."""
    import torch.distributed as dist

    from dcos_commons_tpu_torch.parallel.sharding import timed_collectives

    dist.barrier()
    t0 = time.perf_counter()
    step(params, tokens, targets)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    dist.barrier()
    with timed_collectives() as coll:
        t0 = time.perf_counter()
        step(params, tokens, targets)
        torch.cuda.synchronize()
        timed_ms = (time.perf_counter() - t0) * 1e3
    return step_ms, timed_ms, coll


def judge_f32(r0):
    """(within tolerance, its log text) of an f32 gang run's rank 0
    report against one process (``compare_f32``'s entries)."""
    first = r0["steps"][0]
    ok = (r0["loss_rel"] <= 1e-5 and first["grad_rel"] <= 1e-5
          and first["apart"] == 0
          and all(st["all"] <= 2 * LR * (k + 1) * (1 + 1e-4)
                  for k, st in enumerate(r0["steps"])))
    return ok, ("f32: loss 1e-5 rel at each step, the first step's "
                "gradient 1e-5 rel Frobenius a leaf, its params 1e-5 + "
                "1e-5 |p| where |g| >= 1e-6, 2 lr a step everywhere "
                f"(compare_f32); by step: {r0['steps']}")


def gang_rank_main(rank, world, backend, init_method, cases, results):
    """A rank of a gang phase: under gloo every rank on card 0 (phase
    12(b)), under NCCL rank r on card r (``--nccl-gang``).  For each
    case, GANG_STEPS sharded steps from the full seeded init on this
    rank's rows, then one step with the collectives timed and one
    without; rank 0 also runs the one-process step at the same global
    batch and compares.  Puts (rank, report or None, error)."""
    import traceback

    try:
        import torch.distributed as dist

        from dcos_commons_tpu_torch.models.transformer import (
            adamw, init_params, leaf_rules, make_train_step, shard_params,
            unshard_params,
        )
        from dcos_commons_tpu_torch.parallel.distributed import init_gang
        from dcos_commons_tpu_torch.parallel.mesh import (
            BATCH_AXES, MeshSpec, make_mesh,
        )
        from dcos_commons_tpu_torch.parallel.sharding import unshard
        from dcos_commons_tpu_torch.utils.tree import tree_leaves

        torch.cuda.set_device(rank if backend == "nccl" else 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        init_gang(init_method, world, rank, backend, timeout_s=300)
        logs = install_shape_logs()
        report = []
        for label, extra, fields, dtype, layers, seq in cases:
            config = gang_config(extra, dtype, layers, seq)
            mesh = make_mesh(MeshSpec(**fields))
            params = shard_params(init_params(config, seed=0, device="cuda"),
                                  config, mesh)
            optimizer = adamw(params, LR)
            step = make_train_step(config, optimizer, mesh=mesh)
            f32 = dtype == torch.float32
            applied = []
            if f32:
                # the gradients each f32 step applies, gathered to full
                # size (every rank gathers: the hook runs in every step)
                rules = leaf_rules(config)
                hook = optimizer.register_step_pre_hook(
                    lambda *_: applied.append([
                        unshard(p.grad, d, mesh) for p, d in zip(
                            tree_leaves(params), rules)]))
            tokens, targets = gang_batch(config, GANG_BATCH)
            n, i = mesh.size(BATCH_AXES), mesh.index(BATCH_AXES)
            rows = slice(i * GANG_BATCH // n, (i + 1) * GANG_BATCH // n)
            tokens, targets = tokens[rows], targets[rows]
            torch.cuda.synchronize()
            for shape_log in logs.values():
                shape_log.reset()
            losses, fulls = [], []
            for k in range(GANG_STEPS):
                losses.append(float(step(params, tokens, targets)))
                if f32 or k == GANG_STEPS - 1:
                    fulls.append(tree_leaves(unshard_params(params, config,
                                                            mesh)))
            if f32:
                hook.remove()
            torch.cuda.synchronize()
            launches = {k: s.inner.launches for k, s in logs.items()}
            shapes = {k: sorted(s.shapes, key=str) for k, s in logs.items()}
            step_ms, timed_ms, coll = time_gang_step(step, params, tokens,
                                                     targets)
            del params, step
            entry = dict(label=label, dtype=str(dtype), layers=layers,
                         seq=seq, rank=rank, losses=losses,
                         launches=launches, shapes=shapes, step_ms=step_ms,
                         timed_ms=timed_ms,
                         collective_ms=coll["seconds"] * 1e3,
                         collectives=coll["calls"])
            if rank == 0:
                ref_losses, ref, (after, grads) = one_process_steps(
                    config, GANG_STEPS, GANG_BATCH, trace=f32)
                entry["ref_losses"] = ref_losses
                entry["loss_rel"] = max(abs(a - b) / abs(b)
                                        for a, b in zip(losses, ref_losses))
                if f32:
                    entry["steps"] = compare_f32(fulls, after, applied,
                                                 grads)
                else:
                    entry["param_max_diff"] = max(
                        (a.float() - b.detach().float()).abs().max().item()
                        for a, b in zip(fulls[-1], tree_leaves(ref)))
                del ref, after, grads
            del fulls, applied
            torch.cuda.empty_cache()
            report.append(entry)
            dist.barrier()
        dist.destroy_process_group()
        results.put((rank, report, None))
    except BaseException:  # noqa: BLE001 — reported to the parent
        results.put((rank, None, traceback.format_exc()))


def phase_gang(tag, world, backend, layouts, deadline_s):
    """A gang of ``world`` spawned processes at the flagship's width:
    each of ``layouts`` in bf16 at GANG_LAYERS layers and seq 2048, then
    in f32 (TF32 off) at 2 layers and seq 256.  Checks each against the
    one-process step and the kernels' launches on each rank's rows and
    h/tp heads; returns (launches by kernel summed over the ranks,
    shapes).  Phase 12(b) is two processes on the one card over gloo."""
    seq = int(TRAIN_ENV["SEQ_LEN"])
    cases = [(label, extra, fields, dtype, layers, s)
             for dtype, layers, s in ((torch.bfloat16, GANG_LAYERS, seq),
                                      (torch.float32, 2, 256))
             for label, extra, fields in layouts]
    reports = spawn_ranks(gang_rank_main, world, backend, (cases,),
                          deadline_s, tag)
    launches = {n: 0 for n in ("K1", "K2", "K3", "K4")}
    shapes = {n: set() for n in launches}
    for runs in zip(*(reports[r] for r in range(world))):
        r0 = runs[0]
        label, f32 = r0["label"], r0["dtype"] == "torch.float32"
        config = gang_config(MOE_ENV if "MoE" in label else {},
                             torch.float32 if f32 else torch.bfloat16,
                             r0["layers"], r0["seq"])
        per_step = launches_per_step(config.n_layers,
                                     config.no_remat_layers)
        fields = next(f for lab, _, f in layouts if lab == label)
        tp = fields.get("tp", 1)
        rows = GANG_BATCH // (fields.get("dcn", 1) * fields.get("dp", 1)
                              * fields.get("fsdp", 1))
        heads = config.n_heads // tp
        for r in runs:
            want = {n: per_step[n] * GANG_STEPS for n in launches}
            if r["launches"] != want:
                raise AssertionError(f"{tag} {label} rank {r['rank']}: "
                                     f"launches {r['launches']}, want {want}")
            for n in ("K2", "K3", "K4"):
                if {tuple(x)[0] for x in r["shapes"][n]} != {rows * heads}:
                    raise AssertionError(
                        f"{tag} {label}: {n} at {r['shapes'][n]}, want "
                        f"{rows} rows x {heads} heads")
            for n in launches:
                launches[n] += r["launches"][n]
                shapes[n].update(tuple(x) for x in r["shapes"][n])
            if r["losses"] != r0["losses"]:
                raise AssertionError(f"{tag} {label}: the ranks' losses "
                                     "differ")
        if f32:
            ok, tol = judge_f32(r0)
        else:
            ok = r0["loss_rel"] <= GANG_BF16_LOSS_RTOL
            tol = (f"bf16: loss {GANG_BF16_LOSS_RTOL} rel, params max diff "
                   f"{r0['param_max_diff']:.3e} logged")
        step_ms = max(r["step_ms"] for r in runs)
        coll_ms = max(r["collective_ms"] for r in runs)
        timed_ms = max(r["timed_ms"] for r in runs)
        log(f"{tag} {label} {'f32' if f32 else 'bf16'} [{r0['layers']} "
            f"layers, batch {GANG_BATCH}, seq {r0['seq']}]: losses "
            f"{r0['losses']} vs one process {r0['ref_losses']} (rel "
            f"{r0['loss_rel']:.3e}); {tol}; step {step_ms:.1f} ms; "
            f"timed step {timed_ms:.1f} ms = collectives {coll_ms:.1f} ms "
            f"({r0['collectives']} calls) + compute "
            f"{timed_ms - coll_ms:.1f} ms; K2-K4 on {rows} x {heads} "
            f"heads; launches a rank {r0['launches']}")
        if not ok:
            raise AssertionError(f"{tag} {label}: gang and one process "
                                 "differ beyond the tolerance")
    return launches, shapes


# -- phases 13-14: the serving gang and the router --------------------------

GANG_SERVE_LAYERS_F32 = 2       # phase 13a: the flagship's width, 2 layers
GANG_DECODE_STEPS = 10          # the decode-step bench after a served mix
# phase 13a: the gang's prefill logits against one process's, f32 with
# TF32 off: the largest difference over the largest |logit| (PERF.md §6
# states the bound and its prediction)
GANG_F32_LOGITS_RTOL = 1e-4


def gang_serve_rank_main(rank, world, backend, init_method, env, dtype,
                         probe, control, results):
    """A rank of a serving gang (``serve_gang_worker.build_rank``): under
    gloo every rank on card 0, under NCCL rank r on card r.  Counts the
    kernels' launches from the end of the gang's warm-up until the served
    phases end (rank 0: the parent's word on ``control``; the others:
    rank 0's STOP tick), then every rank times ``GANG_DECODE_STEPS``
    decode steps of its pool, plain and with the collectives timed, and,
    given a ``probe`` prompt, runs its prefill (rank 0 keeps the
    logits).  Puts ("port", port, None) from rank 0, then (rank, report
    or None, error)."""
    import traceback

    try:
        import torch.distributed as dist

        from dcos_commons_tpu_torch.frameworks.serve_gang_worker import (
            build_rank,
        )
        from dcos_commons_tpu_torch.models import decode

        device = f"cuda:{rank}" if backend == "nccl" else "cuda:0"
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        logs = install_shape_logs()
        gang = build_rank(env, local_rank=rank, local_devices=world,
                          init_method=init_method, backend=backend,
                          device=device, dtype=dtype, ready_file="",
                          log=log if rank == 0 else (lambda msg: None))
        torch.cuda.synchronize()
        for shape_log in logs.values():
            shape_log.reset()
        if rank == 0:
            threading.Thread(target=gang.server.serve_forever,
                             daemon=True).start()
            results.put(("port", gang.port, None))
            control.get()
            torch.cuda.synchronize()
            report = dict(launches={k: s.inner.launches
                                    for k, s in logs.items()},
                          shapes={k: sorted(s.shapes, key=str)
                                  for k, s in logs.items()})
            gang.stop()
        else:
            gang.follow()
            torch.cuda.synchronize()
            report = dict(launches={k: s.inner.launches
                                    for k, s in logs.items()},
                          shapes={k: sorted(s.shapes, key=str)
                                  for k, s in logs.items()})
        report.update(rank=rank, **bench_gang_decode(gang, dist))
        if probe is not None:
            with torch.inference_mode():
                logits, _ = decode.prefill(
                    gang.config, gang.pool.params,
                    torch.as_tensor(probe, device=device)[None], len(probe),
                    mesh=gang.mesh)
            if rank == 0:
                report["logits"] = logits.float().cpu().numpy()
        dist.barrier()
        dist.destroy_process_group()
        results.put((rank, report, None))
    except BaseException:  # noqa: BLE001 — reported to the parent
        results.put((rank, None, traceback.format_exc()))


def bench_gang_decode(gang, dist):
    """Every rank in step: ``GANG_DECODE_STEPS`` decode steps of the
    whole pool (every row at position 512) on the host clock around
    synchronised steps, then as many with each collective bracketed by
    device synchronisations (``timed_collectives``)."""
    from dcos_commons_tpu_torch.parallel.sharding import timed_collectives

    pool = gang.pool
    n = pool.slots
    args = [np.zeros(n, np.int32), np.full(n, 512, np.int32),
            np.zeros(n, np.float32), np.zeros(n, np.int32)]
    if hasattr(pool, "pages_per_row"):
        ppr = pool.pages_per_row
        args.append((1 + np.arange(n)[:, None] * ppr
                     + np.arange(ppr)[None]).astype(np.int32))
    for _ in range(3):
        pool.decode(*args)
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(GANG_DECODE_STEPS):
        pool.decode(*args)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / GANG_DECODE_STEPS
    dist.barrier()
    with timed_collectives() as coll:
        t0 = time.perf_counter()
        for _ in range(GANG_DECODE_STEPS):
            pool.decode(*args)
        torch.cuda.synchronize()
        timed_ms = (time.perf_counter() - t0) * 1e3 / GANG_DECODE_STEPS
    return dict(decode_ms=step_ms, timed_ms=timed_ms,
                collective_ms=coll["seconds"] * 1e3 / GANG_DECODE_STEPS,
                collectives=coll["calls"] // GANG_DECODE_STEPS)


def run_serve_gang(tag, world, backend, env, drive, deadline_s,
                   dtype=None, probe=None):
    """Spawn a serving gang of ``world`` ranks, call ``drive(port)`` with
    rank 0's port once it serves, then stop the gang.  Returns (what
    ``drive`` returned, every rank's report in rank order)."""
    import multiprocessing
    import queue

    if backend == "nccl":
        init_method = f"tcp://127.0.0.1:{free_port()}"
    else:
        store = os.path.join(ROOT, "build", "smoke", "serve_gang_store")
        if os.path.exists(store):
            os.remove(store)
        init_method = f"file://{store}"
    ctx = multiprocessing.get_context("spawn")
    results, control = ctx.Queue(), ctx.Queue()
    procs = [ctx.Process(target=gang_serve_rank_main,
                         args=(r, world, backend, init_method, env, dtype,
                               probe, control, results))
             for r in range(world)]
    for p in procs:
        p.start()
    reports = {}
    end = time.monotonic() + deadline_s

    def take():
        while True:
            try:
                item = results.get(timeout=5)
            except queue.Empty:
                if time.monotonic() > end:
                    raise AssertionError(f"{tag}: past its {deadline_s} s")
                if any(p.exitcode not in (None, 0) for p in procs):
                    raise AssertionError(
                        f"{tag}: a rank died, exit codes "
                        f"{[p.exitcode for p in procs]}")
                continue
            if item[2] is not None:
                raise AssertionError(f"{tag} rank {item[0]} failed:\n"
                                     f"{item[2]}")
            return item

    try:
        _, port, _ = take()
        try:
            out = drive(port)
        finally:
            control.put("stop")
        while len(reports) < world:
            rank, report, _ = take()
            reports[rank] = report
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    return out, [reports[r] for r in range(world)]


def check_gang_kernels(tag, reports, slot_path, heads):
    """K1 on every rank, K2 on every rank of the slot path (none on the
    paged one) at ``heads`` heads, K3/K4 nowhere.  Returns (launches
    summed over the ranks, shapes)."""
    launches = {n: 0 for n in ("K1", "K2", "K3", "K4")}
    shapes = {n: set() for n in launches}
    for r in reports:
        got = r["launches"]
        if (got["K1"] == 0 or bool(got["K2"]) != slot_path or got["K3"]
                or got["K4"]):
            raise AssertionError(f"{tag} rank {r['rank']} kernels: {got}")
        bhs = {tuple(x)[0] for x in r["shapes"]["K2"]}
        if slot_path and bhs != {heads}:
            raise AssertionError(f"{tag} rank {r['rank']}: K2 at "
                                 f"{r['shapes']['K2']}, want {heads} heads")
        for n in launches:
            launches[n] += got[n]
            shapes[n].update(tuple(x) for x in r["shapes"][n])
    return launches, shapes


def report_gang(tag, reports):
    step = max(r["decode_ms"] for r in reports)
    timed = max(r["timed_ms"] for r in reports)
    coll = max(r["collective_ms"] for r in reports)
    log(f"{tag}: decode step ({reports[0]['collectives']} collectives) "
        f"{step:.2f} ms; timed step {timed:.2f} ms = collectives "
        f"{coll:.2f} ms ({coll / timed:.1%}) + compute {timed - coll:.2f} "
        f"ms; launches a rank {[r['launches'] for r in reports]}")
    return dict(decode_ms=step, timed_ms=timed, collective_ms=coll)


def one_process_replies(env, params, config, requests):
    """The same requests, one at a time, through one process's pool of
    the gang's geometry, on the card."""
    from dcos_commons_tpu_torch.serve import paged_config_from_env
    from dcos_commons_tpu_torch.serve.engine import PagedEngine, SlotEngine
    from dcos_commons_tpu_torch.serve.pool import PagedPoolModel, PoolModel

    max_len = int(env["MAX_LEN"])
    slots = int(env["SERVE_BATCH"])
    prompt_len = max_len - int(env["MAX_NEW_TOKENS"])
    paged = paged_config_from_env(env)
    if paged is not None:
        pool = PagedPoolModel(config, params, slots, max_len,
                              paged.page_tokens, paged.pages,
                              paged.chunk_tokens)
        engine = PagedEngine(pool.prefill_chunk, pool.decode, slots, max_len,
                             prompt_len, page_tokens=paged.page_tokens,
                             pages=paged.pages,
                             chunk_tokens=paged.chunk_tokens,
                             prefix_cache=paged.prefix_cache)
    else:
        pool = PoolModel(config, params, slots, max_len)
        engine = SlotEngine(pool.prefill, pool.decode, slots, max_len,
                            prompt_len)
    try:
        # the tokens as the workers' handler cleans them
        return [{"tokens": engine.submit(
            [[int(t) % config.vocab for t in row] for row in r["tokens"]],
            r["max_new_tokens"])} for r in requests]
    finally:
        engine.stop()


def phase_gang_f32(sandbox):
    """13a: a gang of 2 over gloo on the one card, f32 (TF32 off), the
    flagship's width at 2 layers, on both pools: its greedy replies (one
    request at a time) equal one process's, and its prefill logits of
    one prompt are within GANG_F32_LOGITS_RTOL of one process's."""
    from dcos_commons_tpu_torch.models import config_from_env, init_params
    from dcos_commons_tpu_torch.models.decode import prefill

    requests = [dict(r, max_new_tokens=16, temperature=0.0)
                for r in requests_for(32768, seed=1)]
    probe = (np.asarray(requests[1]["tokens"][0], np.int64)
             % int(FLAGSHIP_ENV["VOCAB"]))
    for path, extra in (("slot", {"KV_PAGE_TOKENS": "0"}),
                        ("paged", {"KV_PAGE_TOKENS": "16",
                                   "PREFILL_CHUNK_TOKENS": "64"})):
        env = dict(FLAGSHIP_ENV, **extra, SANDBOX=sandbox,
                   N_LAYERS=str(GANG_SERVE_LAYERS_F32))
        replies, reports = run_serve_gang(
            f"13a {path}", 2, "gloo", env,
            lambda port: [post(port, "/generate", r) for r in requests],
            240, dtype=torch.float32, probe=probe)
        check_replies(requests, replies, 32768)
        config = config_from_env(env, dtype=torch.float32, remat=False)
        params = init_params(config, seed=0, device="cuda")
        want = one_process_replies(env, params, config, requests)
        with torch.inference_mode():
            ref, _ = prefill(config, params,
                             torch.as_tensor(probe, device="cuda")[None],
                             len(probe))
        ref = ref.float().cpu().numpy()
        rel = (np.abs(reports[0]["logits"] - ref).max()
               / np.abs(ref).max())
        same = sum(a == b for a, b in zip(replies, want))
        lead = [next((j for j, (x, y) in enumerate(
            zip(a["tokens"][0], b["tokens"][0])) if x != y), None)
            for a, b in zip(replies, want)]
        check_gang_kernels(f"13a {path}", reports, path == "slot", 8)
        report_gang(f"13a f32 tp2 gloo {path}", reports)
        log(f"13a f32 tp2 gloo {path} [{GANG_SERVE_LAYERS_F32} layers]: "
            f"{same}/{len(requests)} greedy replies equal one process's "
            f"(first differing token {lead}); prefill logits of a "
            f"{len(probe)}-token prompt {rel:.3e} apart relative to the "
            f"largest (limit {GANG_F32_LOGITS_RTOL})")
        if same != len(requests) or not rel <= GANG_F32_LOGITS_RTOL:
            raise AssertionError(f"13a {path}: the gang and one process "
                                 "differ")
        del params
        torch.cuda.empty_cache()


def endpoint_stub(backends):
    """A stand-in for the scheduler's ``GET /v1/endpoints/<vip>``, in the
    shape ``router.frontdoor.fetch_endpoint`` reads; ``backends`` is the
    live list (name -> address), read at every poll."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def do_GET(self):
            if self.path != "/v1/endpoints/vip:inference":
                self.send_error(404)
                return
            body = json.dumps({
                "name": "vip:inference", "generation": "g1",
                "address": sorted(backends.values()),
                "backends": [{"address": a, "task": n,
                              "state": "TASK_RUNNING", "ready": True,
                              "draining": False}
                             for n, a in sorted(backends.items())],
            }).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def start_pod(env, workdir):
    """The port's serve worker as a process of its own on the card (so
    it can be killed mid-stream); returns (process, port)."""
    os.makedirs(workdir, exist_ok=True)
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "dcos_commons_tpu_torch",
                                      "frameworks", "serve_worker.py")],
        cwd=workdir, env=dict(os.environ, **dict(env, SANDBOX=workdir)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []
    for line in proc.stdout:
        lines.append(line)
        if line.startswith("warm:"):
            port = int(line.rsplit("port", 1)[1])
            threading.Thread(target=lambda: [None for _ in proc.stdout],
                             daemon=True).start()
            return proc, port
    proc.wait()
    raise AssertionError("the serve worker did not start:\n"
                         + "".join(lines[-40:]))


def phase_router(gang_port, pod_env, sandbox):
    """14: the port's RouterServer in front of the gang's rank 0 and a
    single-card serve worker, discovered through an endpoint stub.
    Routed greedy replies equal the pods' direct ones; then the single
    pod is killed while it decodes, and every request completes (on the
    gang)."""
    from dcos_commons_tpu_torch.router.frontdoor import RouterServer

    prompts = [r["tokens"][0][:300] for r in requests_for(32768, seed=2)]
    requests = [{"tokens": [p], "max_new_tokens": 16} for p in prompts]
    pod, pod_port = start_pod(pod_env, os.path.join(sandbox, "pod"))
    backends = {"gang": f"127.0.0.1:{gang_port}",
                "pod": f"127.0.0.1:{pod_port}"}
    stub = endpoint_stub(backends)
    router = RouterServer(f"http://127.0.0.1:{stub.server_address[1]}",
                          endpoint="vip:inference", port=0,
                          host="127.0.0.1", poll_interval_s=0.5,
                          page_tokens=16, log=log)
    router.start()
    try:
        direct = {name: [post(int(addr.rsplit(":", 1)[1]), "/generate", r)
                         for r in requests]
                  for name, addr in backends.items()}
        t0 = time.monotonic()
        routed, _ = post_waves(router.port, requests)
        routed_s = time.monotonic() - t0
        served_by = []
        for i, rep in enumerate(routed):
            names = [n for n in backends if direct[n][i] == rep]
            if not names:
                raise AssertionError(f"14: routed reply {i} equals no "
                                     f"pod's direct reply: {rep}")
            served_by.append(names)
        pods = post(router.port, "/pods")["pods"]
        log(f"14 routed {len(routed)} greedy requests in {routed_s:.3f} s, "
            f"each equal to a pod's direct reply (the pods that give it: "
            f"{served_by}); admitted by pod "
            f"{ {n: row.get('admitted') for n, row in pods.items()} }")
        # kill the single pod while it decodes: the rest complete
        killed = []

        def killer():
            end = time.monotonic() + 120
            while time.monotonic() < end:
                try:
                    if post(pod_port, "/stats")["active_slots"] >= 1:
                        break
                except Exception:  # noqa: BLE001 — still starting
                    pass
                time.sleep(0.005)
            pod.kill()
            killed.append(time.monotonic())

        before = post(router.port, "/stats")
        thread = threading.Thread(target=killer)
        thread.start()
        t0 = time.monotonic()
        replies = [None] * len(requests)
        errors = []

        def client(i):
            try:
                replies[i] = post(router.port, "/generate", requests[i])
            except Exception as e:  # noqa: BLE001 — raised below
                errors.append(e)

        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(len(requests))]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=600)
        thread.join(timeout=130)
        if errors:
            raise errors[0]
        after = post(router.port, "/stats")
        kinds = []
        for i, rep in enumerate(replies):
            names = [n for n in backends if direct[n][i] == rep]
            if not names:
                raise AssertionError(f"14: reply {i} after the kill equals "
                                     f"no pod's direct reply: {rep}")
            kinds.append(names)
        failovers = after["router_failovers"] - before["router_failovers"]
        log(f"14 single pod killed mid-stream "
            f"{killed[0] - t0:.3f} s into the wave: {len(replies)} requests "
            f"completed in {time.monotonic() - t0:.3f} s (equal to the "
            f"direct replies of {kinds}); router failovers {failovers}")
        if not killed or failovers < 1:
            raise AssertionError("14: the kill did not fail a request over")
    finally:
        router.stop()
        stub.shutdown()
        stub.server_close()
        if pod.poll() is None:
            pod.kill()
        pod.wait(timeout=30)


def phase_gang_serving(tag, world, backend, sandbox, router_phase,
                       watchdog=None):
    """13b (and ``--nccl-gang``'s tp4): the bf16 flagship at full width
    served by a tp gang on both pools over the mix; on the slot pool,
    then, with ``router_phase``, phase 14 in front of it.  Returns
    (launches summed over the ranks, K1 shapes, K2 shapes)."""
    requests = requests_for(32768)
    heads = 16 // world
    launches = {n: 0 for n in ("K1", "K2", "K3", "K4")}
    shapes = {"K1": set(), "K2": set()}
    for path, extra in (("slot", {"KV_PAGE_TOKENS": "0"}),
                        ("paged", {"KV_PAGE_TOKENS": "16",
                                   "PREFILL_CHUNK_TOKENS": "64"})):
        env = dict(FLAGSHIP_ENV, **extra, SANDBOX=sandbox)

        def drive(port):
            replies, wall = post_waves(port, requests)
            stats = post(port, "/stats")
            if router_phase and path == "slot":
                watchdog.phase("14 router", 420)
                phase_router(port, env, sandbox)
                watchdog.phase(f"{tag} serving gang, paged", 600)
            return replies, wall, stats

        (replies, wall, stats), reports = run_serve_gang(
            f"{tag} {path}", world, backend, env, drive, 900)
        check_replies(requests, replies, 32768)
        found, seen = check_gang_kernels(f"{tag} {path}", reports,
                                         path == "slot", heads)
        report_serving(f"{tag} tp{world} {backend} {path}", replies,
                       found, stats, wall)
        report_gang(f"{tag} tp{world} {backend} {path}", reports)
        for n in launches:
            launches[n] += found[n]
        shapes["K1"] |= seen["K1"]
        shapes["K2"] |= seen["K2"]
    return launches, shapes


# -- phase 15: long context -------------------------------------------------

# phase 15's layouts: (label, "ring", "ulysses" or "pp", MeshSpec fields,
# the bf16 global batch, the pipeline's microbatches)
LONG_LAYOUTS = (
    ("ulysses sp2", "ulysses", {"sp": 2}, 1, 0),
    ("ring sp2", "ring", {"sp": 2}, 1, 0),
    ("pp2", "pp", {"pp": 2}, 4, 4),
)
# --nccl-gang on four cards: a context of 8192 over sp4, Ulysses under
# tp, and the dryrun's pp x dp
NCCL4_LONG_LAYOUTS = (
    ("ulysses sp4", "ulysses", {"sp": 4}, 1, 0),
    ("ring sp4", "ring", {"sp": 4}, 1, 0),
    ("ulysses sp2xtp2", "ulysses", {"sp": 2, "tp": 2}, 1, 0),
    ("pp2xdp2", "pp", {"pp": 2, "dp": 2}, 4, 2),
)
LONG_SEQ = 2048           # each rank's positions in bf16 (sp2: 4096 in all)
LONG_STEPS = 3            # bf16 sp steps; the pipeline and f32 take 2
# 15(a): f32 (TF32 off) at the flagship's width, 2 layers, 512 positions
# a rank, batch 2 (the pipeline in 2 microbatches)
LONG_F32 = dict(layers=2, seq=512, batch=2, micro=2)


def long_cases(layouts, dtype):
    """The rank-side cases of ``layouts`` in ``dtype``: (label, kind,
    MeshSpec fields, dtype, layers, positions a rank, global batch,
    microbatches, steps); bf16 is 15(b)'s flagship, f32 15(a)'s."""
    if dtype == torch.float32:
        f = LONG_F32
        return [(label, kind, fields, dtype, f["layers"], f["seq"],
                 f["batch"], f["micro"], GANG_STEPS)
                for label, kind, fields, _, _ in layouts]
    return [(label, kind, fields, dtype, int(TRAIN_ENV["N_LAYERS"]),
             LONG_SEQ, batch, micro,
             GANG_STEPS if kind == "pp" else LONG_STEPS)
            for label, kind, fields, batch, micro in layouts]


def long_config(kind, dtype, layers, seq):
    """The flagship (bench.py ``flagship_config``: full remat, the last
    layer stored) at ``layers`` and a global sequence of ``seq``, with
    the recipe ``kind`` names (none for the pipeline or ``None``)."""
    from dcos_commons_tpu_torch.models import config_from_env

    return config_from_env(
        dict(TRAIN_ENV, N_LAYERS=str(layers), SEQ_LEN=str(seq)),
        dtype=dtype, no_remat_layers=NO_REMAT_LAYERS,
        use_ring_attention=kind == "ring",
        use_ulysses_attention=kind == "ulysses")


def long_launches(kind, config, fields, rank_index, n_micro):
    """K1-K4 launches of one step on a rank: a sp rank's are one
    process's (the ring's without K2-K4); a pipeline rank runs its stage
    of L layers on each of the M + S - 1 ticks, forward (K1 twice a
    layer, K2 once) and backward (the recompute of its L - k
    checkpointed layers, K3 and K4 once a layer), and the last rank the
    final norm."""
    if kind != "pp":
        per = launches_per_step(config.n_layers, config.no_remat_layers)
        return dict(per, K2=0, K3=0, K4=0) if kind == "ring" else per
    stages = fields["pp"]
    ticks = n_micro + stages - 1
    layers = config.n_layers // stages
    recomputed = layers - min(config.no_remat_layers, layers)
    return {"K1": ticks * 2 * (layers + recomputed)
            + (rank_index == stages - 1),
            "K2": ticks * (layers + recomputed),
            "K3": ticks * layers, "K4": ticks * layers}


def long_rank_main(rank, world, backend, init_method, cases, probe,
                   results):
    """A rank of phase 15 (gloo, every rank on card 0) or of
    ``--nccl-gang``'s long-context layouts (NCCL, rank r on card r).
    With ``probe``, first ``collective_bandwidth`` over the world and,
    on rank 0, ``single_chip_rooflines``.  Then each case from the full
    seeded init: a sp layout through ``make_train_step(mesh=...)`` on
    the rank's rows and sequence chunk, the pipeline through
    ``pipeline_value_and_grad`` and AdamW on the stage's leaves; its
    steps, one timed step and one with the collectives timed.  Rank 0
    also runs one process on the whole sequence and compares.  Puts
    (rank, report or None, error)."""
    import traceback

    try:
        import torch.distributed as dist

        from dcos_commons_tpu_torch.models.transformer import (
            adamw, init_params, leaf_rules, make_train_step,
            pipeline_param_specs, pipeline_value_and_grad, shard_params,
            unshard_params,
        )
        from dcos_commons_tpu_torch.parallel.collectives import (
            collective_bandwidth, single_chip_rooflines,
        )
        from dcos_commons_tpu_torch.parallel.distributed import init_gang
        from dcos_commons_tpu_torch.parallel.mesh import (
            BATCH_AXES, MeshSpec, make_mesh,
        )
        from dcos_commons_tpu_torch.parallel.sharding import unshard
        from dcos_commons_tpu_torch.utils.tree import tree_leaves

        torch.cuda.set_device(rank if backend == "nccl" else 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        init_gang(init_method, world, rank, backend, timeout_s=300)
        logs = install_shape_logs()
        report = {"cases": []}
        if probe:
            report["bandwidth"] = collective_bandwidth(
                make_mesh(MeshSpec(dp=world)), "dp", payload_mb=64.0,
                iters=20)
            if rank == 0:
                report["rooflines"] = single_chip_rooflines()
            dist.barrier()
        refs = {}
        for (label, kind, fields, dtype, layers, seq, batch, n_micro,
             steps) in cases:
            mesh = make_mesh(MeshSpec(**fields))
            sp = mesh.size(("sp",))
            config = long_config(kind, dtype, layers, seq * sp)
            f32 = dtype == torch.float32
            specs = pipeline_param_specs(config) if kind == "pp" else None
            params = shard_params(init_params(config, seed=0, device="cuda"),
                                  config, mesh, rules=specs)
            optimizer = adamw(params, LR)
            if kind == "pp":
                def step(params, tokens, targets):
                    loss, grads = pipeline_value_and_grad(
                        config, params, tokens, targets, n_micro, mesh)
                    leaves = tree_leaves(params)
                    for p, g in zip(leaves, tree_leaves(grads)):
                        p.grad = g
                    optimizer.step()
                    for p in leaves:
                        p.grad = None
                    return loss
            else:
                step = make_train_step(config, optimizer, mesh=mesh)
            applied = []
            if f32:
                # the gradients each step applies, gathered to full size
                rules = leaf_rules(config, rules=specs)
                hook = optimizer.register_step_pre_hook(
                    lambda *_: applied.append([
                        unshard(p.grad, d, mesh) for p, d in zip(
                            tree_leaves(params), rules)]))
            tokens, targets = gang_batch(config, batch)
            n, i = mesh.size(BATCH_AXES), mesh.index(BATCH_AXES)
            j, chunk = mesh.index(("sp",)), seq
            rows = slice(i * batch // n, (i + 1) * batch // n)
            cols = slice(j * chunk, (j + 1) * chunk)
            tokens = tokens[rows, cols].contiguous()
            targets = targets[rows, cols].contiguous()
            torch.cuda.synchronize()
            for shape_log in logs.values():
                shape_log.reset()
            losses, fulls = [], []
            for _ in range(steps):
                losses.append(float(step(params, tokens, targets)))
                if f32:
                    fulls.append(tree_leaves(unshard_params(
                        params, config, mesh, rules=specs)))
            if f32:
                hook.remove()
            torch.cuda.synchronize()
            launches = {k: s.inner.launches for k, s in logs.items()}
            shapes = {k: sorted(s.shapes, key=str) for k, s in logs.items()}
            step_ms, timed_ms, coll = time_gang_step(step, params, tokens,
                                                     targets)
            del params, step, optimizer
            torch.cuda.empty_cache()
            entry = dict(label=label, kind=kind, dtype=str(dtype),
                         layers=layers, seq=seq, context=seq * sp,
                         batch=batch, micro=n_micro, rank=rank,
                         pp_index=mesh.index(("pp",)), losses=losses,
                         launches=launches, shapes=shapes, step_ms=step_ms,
                         timed_ms=timed_ms,
                         collective_ms=coll["seconds"] * 1e3,
                         collectives=coll["calls"])
            if rank == 0:
                key = (str(dtype), layers, seq * sp, batch, steps)
                if key not in refs:
                    ref_losses, _, trace = one_process_steps(
                        long_config(None, dtype, layers, seq * sp), steps,
                        batch, trace=f32)
                    refs[key] = (ref_losses, trace)
                ref_losses, (after, grads) = refs[key]
                entry["ref_losses"] = ref_losses
                entry["loss_rel"] = max(abs(a - b) / abs(b)
                                        for a, b in zip(losses, ref_losses))
                if f32:
                    entry["steps"] = compare_f32(fulls, after, applied,
                                                 grads)
            del fulls, applied
            torch.cuda.empty_cache()
            report["cases"].append(entry)
            dist.barrier()
        dist.destroy_process_group()
        results.put((rank, report, None))
    except BaseException:  # noqa: BLE001 — reported to the parent
        results.put((rank, None, traceback.format_exc()))


def spawn_ranks(target, world, backend, args, deadline_s, tag):
    """``target(rank, world, backend, init_method, *args, results)`` in
    ``world`` spawned processes (NCCL at a free local port, gloo over a
    file store under build/smoke); returns {rank: report}.  Every
    process is joined, or killed, before it returns."""
    import multiprocessing

    if backend == "nccl":
        init_method = f"tcp://127.0.0.1:{free_port()}"
    else:
        store = os.path.join(ROOT, "build", "smoke", "gang_store")
        if os.path.exists(store):
            os.remove(store)
        init_method = f"file://{store}"
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=target,
                         args=(r, world, backend, init_method, *args,
                               results))
             for r in range(world)]
    for p in procs:
        p.start()
    reports = {}
    try:
        end = time.monotonic() + deadline_s
        while len(reports) < world:
            rank, report, error = results.get(
                timeout=max(1.0, end - time.monotonic()))
            if error is not None:
                raise AssertionError(f"{tag} rank {rank} failed:\n{error}")
            reports[rank] = report
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    return reports


def phase_long(tag, world, backend, cases, deadline_s, probe=False):
    """Long-context training in ``world`` spawned processes: each case
    against one process on the whole sequence (bf16: the loss within
    ``GANG_BF16_LOSS_RTOL``; f32: as ``compare_f32`` says), the kernels'
    launches on each rank (Ulysses: K2-K4 on the rank's heads over the
    whole context; the ring: none of them), the step and its split into
    collectives and compute logged.  With ``probe``, the collectives'
    bus GB/s and card 0's rooflines are logged first.  Returns
    (launches by kernel summed over the ranks, shapes)."""
    reports = spawn_ranks(long_rank_main, world, backend, (cases, probe),
                          deadline_s, tag)
    if probe:
        bw = reports[0]["bandwidth"]
        log(f"{tag} collective_bandwidth over {world} ranks ({backend}, "
            f"{bw['payload_mb_per_chip']} MB a rank, {bw['iters']:.0f} "
            "chained calls, bus GB/s a rank): " + ", ".join(
                f"{k[:-len('_gbps_per_chip')]} {v:.1f}" for k, v in
                bw.items() if k.endswith("_gbps_per_chip")))
        rl = reports[0]["rooflines"]
        log(f"{tag} single_chip_rooflines on card 0: HBM copy "
            f"{rl['hbm_copy_gbps']:.1f} GB/s, bf16 matmul "
            f"{rl['matmul_bf16_tflops']:.1f} TFLOP/s")
    launches = {n: 0 for n in ("K1", "K2", "K3", "K4")}
    shapes = {n: set() for n in launches}
    for runs in zip(*(reports[r]["cases"] for r in range(world))):
        r0 = runs[0]
        label, kind, f32 = (r0["label"], r0["kind"],
                            r0["dtype"] == "torch.float32")
        fields = next(c[2] for c in cases if c[0] == label)
        config = long_config(kind, torch.float32 if f32 else torch.bfloat16,
                             r0["layers"], r0["context"])
        tp = fields.get("tp", 1)
        rows = r0["batch"] // (fields.get("dp", 1) * fields.get("dcn", 1)
                               * fields.get("fsdp", 1))
        heads = config.n_heads // tp
        if kind == "ulysses":
            want_attn = {(rows * heads // fields["sp"], r0["context"],
                          r0["context"], config.head_dim, True,
                          str(config.dtype))}
        elif kind == "pp":
            want_attn = {(rows // r0["micro"] * heads, r0["seq"], r0["seq"],
                          config.head_dim, True, str(config.dtype))}
        else:
            want_attn = set()
        steps = len(r0["losses"])
        for r in runs:
            per = long_launches(kind, config, fields, r["pp_index"],
                                r0["micro"])
            want = {n: per[n] * steps for n in launches}
            if r["launches"] != want:
                raise AssertionError(f"{tag} {label} rank {r['rank']}: "
                                     f"launches {r['launches']}, want {want}")
            for n in ("K2", "K3", "K4"):
                got = {tuple(x[:5]) + (str(x[5]),) for x in r["shapes"][n]}
                if got != want_attn:
                    raise AssertionError(f"{tag} {label} rank {r['rank']}: "
                                         f"{n} at {got}, want {want_attn}")
            for n in launches:
                launches[n] += r["launches"][n]
                shapes[n].update(tuple(x) for x in r["shapes"][n])
            if r["losses"] != r0["losses"]:
                raise AssertionError(f"{tag} {label}: the ranks' losses "
                                     "differ")
        if f32:
            ok, tol = judge_f32(r0)
        else:
            ok = r0["loss_rel"] <= GANG_BF16_LOSS_RTOL
            tol = f"bf16: loss {GANG_BF16_LOSS_RTOL} rel"
        step_ms = max(r["step_ms"] for r in runs)
        coll_ms = max(r["collective_ms"] for r in runs)
        timed_ms = max(r["timed_ms"] for r in runs)
        tokens = r0["batch"] * r0["context"]
        log(f"{tag} {label} {'f32' if f32 else 'bf16'} [{r0['layers']} "
            f"layers, batch {r0['batch']}, context {r0['context']}, "
            f"{r0['seq']} positions a rank"
            + (f", {r0['micro']} microbatches" if kind == "pp" else "")
            + f"]: losses {r0['losses']} vs one process "
            f"{r0['ref_losses']} (rel {r0['loss_rel']:.3e}); {tol}; step "
            f"{step_ms:.1f} ms ({tokens / step_ms * 1e3:,.0f} tokens/s); "
            f"timed step {timed_ms:.1f} ms = collectives {coll_ms:.1f} ms "
            f"({100 * coll_ms / timed_ms:.1f}%, {r0['collectives']} calls) "
            f"+ compute {timed_ms - coll_ms:.1f} ms; K2-K4 at "
            f"{sorted(want_attn) or 'none'}; launches a rank "
            f"{r0['launches']}")
        if not ok:
            raise AssertionError(f"{tag} {label}: the gang and one process "
                                 "differ beyond the tolerance")
    return launches, shapes


# -- phase 16: the MNIST job --------------------------------------------------

MNIST_STEPS = 60          # train_mnist.py's default, as the reference's
MNIST_BATCH = 256         # its one fixed batch
# the MLP card against CPU: f32 (TF32 off) sums of up to 784 products
# in another order; bf16 one bf16 ulp (2^-8 relative) of a logit and
# the loss through it.  f32 params after the first Adam step within
# 1e-5 + 1e-5 |p| where its gradient is zero or at least 1e-7 (below
# that the update g / (|g| + eps) amplifies the rounding of a
# nearly-zero gradient, as tests/test_torch_mnist.py states), 2 lr
# elsewhere; the f32 losses of steps 2 and 3 within MLP_LATER_LOSS
# (after a sign-like Adam step a hidden unit's input can sit near zero
# and the two roundings take its ReLU to either side, as
# tests/test_torch_cuda.py states)
MLP_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
MLP_LATER_LOSS = 1e-4


def phase_mnist_job(sandbox):
    """16(a): train_mnist.py as the scheduler launches it (no
    TORCH_DEVICE): exit 0 on a cuda device, the loss down over its 60
    steps."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("TORCH_DEVICE", "TRAIN_STEPS")}
    script = os.path.join(ROOT, "dcos_commons_tpu_torch", "frameworks",
                          "train_mnist.py")
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, script], env=env, cwd=sandbox,
                         capture_output=True, text=True, timeout=240)
    wall = time.monotonic() - t0
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or not lines:
        raise AssertionError(f"train_mnist.py exit {out.returncode}: "
                             f"{out.stdout[-2000:]}{out.stderr[-2000:]}")
    last = lines[-1]
    if not last.startswith(f"trained {MNIST_STEPS} steps on cuda ("):
        raise AssertionError(f"train_mnist.py did not train on cuda: {last}")
    first, final = (float(v) for v in last.split("loss ")[1].split(" -> "))
    if not final < first:
        raise AssertionError(f"train_mnist.py loss did not fall: {last}")
    log(f"16(a) train_mnist.py: exit 0 in {wall:.1f} s: {lines[0]}; {last}")


def phase_mnist_parity(smi):
    """16(b): the same numpy MLP weights and batch on the card and the
    CPU, forward and 3 Adam steps, f32 and bf16, within ``MLP_TOL``
    (``MLP_LATER_LOSS`` for the later f32 losses); then one step timed
    under CUDA events."""
    from dcos_commons_tpu_torch.models import mlp

    for dtype in (torch.float32, torch.bfloat16):
        tol = MLP_TOL[dtype]
        rng = np.random.default_rng(0)
        config = mlp.MlpConfig(dtype=dtype)
        shapes = mlp.mlp_init(config, 0, "meta")
        weights = {k: rng.standard_normal(tuple(v.shape)).astype(np.float32)
                   * (0.05 if k.startswith("w") else 0.01)
                   for k, v in shapes.items()}
        cpu = {k: torch.from_numpy(w).to(dtype) for k, w in weights.items()}
        card = {k: v.to("cuda") for k, v in cpu.items()}
        x = torch.from_numpy(rng.uniform(0, 1, (MNIST_BATCH, 784))
                             .astype(np.float32))
        y = torch.from_numpy(rng.integers(0, 10, (MNIST_BATCH,)))
        xc, yc = x.cuda(), y.cuda()
        logits_err = check(f"MLP logits {dtype}",
                           mlp.mlp_forward(card, xc).cpu(),
                           mlp.mlp_forward(cpu, x), (tol, tol))
        keys = sorted(cpu)
        for key in keys:
            cpu[key].requires_grad_(True)
        g0 = torch.autograd.grad(mlp.mlp_loss(cpu, x, y),
                                 [cpu[k] for k in keys])
        g0 = {k: g.abs() for k, g in zip(keys, g0)}
        steps = [mlp.mlp_train_step(mlp.mlp_adam(p, 1e-3))
                 for p in (cpu, card)]
        losses = []
        param_err = 0.0
        for i in range(3):
            losses.append((float(steps[0](cpu, x, y)),
                           float(steps[1](card, xc, yc))))
            limit = (tol if i == 0 or dtype != torch.float32
                     else MLP_LATER_LOSS)
            if not abs(losses[-1][0] - losses[-1][1]) <= limit:
                raise AssertionError(f"MLP {dtype} losses {losses}")
            if i or dtype != torch.float32:
                continue
            for key in keys:
                diff = (card[key].detach().cpu() - cpu[key].detach()).abs()
                steady = (g0[key] >= 1e-7) | (g0[key] == 0)
                bound = 1e-5 + 1e-5 * cpu[key].detach().abs()
                if not bool((diff <= bound)[steady].all()) or float(
                        diff.max()) > 2e-3:
                    raise AssertionError(f"MLP f32 param {key} differs by "
                                         f"{float(diff.max()):.3e}")
                param_err = max(param_err, float(diff[steady].max()))
        loss_err = max(abs(a - b) for a, b in losses)
        ms = time_ms(lambda: steps[1](card, xc, yc), iters=50, warmup=5)
        log(f"16(b) MLP {dtype} card vs CPU: logits {logits_err:.3e}, "
            f"losses over 3 Adam steps {losses} (max diff {loss_err:.3e}), "
            f"f32 params after one step {param_err:.3e}; one step "
            f"[batch {MNIST_BATCH}] {ms:.4f} ms, "
            f"{MNIST_BATCH / ms * 1e3:,.0f} samples/s ({smi})")


# -- phase 17: shardcheck on the card ---------------------------------------


def shard_sections(workload):
    """{section: bytes on one card} of a shardcheck workload."""
    from dcos_commons_tpu_torch.analysis import shardcheck

    reports, problems = shardcheck._check_workload(
        workload, shardcheck.axis_vocabulary())
    if problems:
        raise AssertionError(f"shardcheck problems: {problems}")
    sections = {}
    for r in reports:
        sections[r.leaf.section] = (sections.get(r.leaf.section, 0)
                                    + r.per_chip_bytes)
    return sections, reports


def phase_shardcheck(peak, smi):
    """17(a): shardcheck's footprint of phase 7's timed step (the
    flagship, remat full + NO_REMAT_LAYERS stored, batch TRAIN_BATCH)
    against its measured peak: params + gradients + optimizer state
    must fit under the peak; the whole prediction and its ratio to the
    peak are printed, not gated.  17(b): the HBM table's h100 entry
    holds no more than the card has."""
    from dcos_commons_tpu_torch.analysis import shardcheck
    from dcos_commons_tpu_torch.specification import GpuSpec

    gpu = GpuSpec(chips_per_host=1)
    workload = shardcheck.PROFILES["train_worker.py"](
        dict(TRAIN_ENV, **gpu.mesh_env()), gpu, None, None,
        batch=TRAIN_BATCH)
    sections, _ = shard_sections(workload)
    gib = 2 ** 30
    floor = sections["params"] + sections["grads"] + sections["opt"]
    total = sum(sections.values())
    log("17(a) shardcheck, flagship train step [batch "
        f"{TRAIN_BATCH}, seq {TRAIN_ENV['SEQ_LEN']}], by section: "
        + ", ".join(f"{k} {v / gib:.3f} GiB"
                    for k, v in sorted(sections.items()))
        + f"; params+grads+opt {floor / gib:.3f} GiB, all {total / gib:.3f}"
        f" GiB; measured peak {peak / gib:.3f} GiB (phase 7); prediction "
        f"over peak {total / peak:.3f} ({smi})")
    if floor > peak:
        raise AssertionError(
            f"params + grads + optimizer state {floor} B exceed the "
            f"measured peak {peak} B: the footprint model overcounts")
    card = torch.cuda.get_device_properties(0).total_memory
    table = shardcheck.GENERATION_HBM_MB["h100"] * 2 ** 20
    log(f"17(b) GENERATION_HBM_MB['h100'] {table:,} B against the card's "
        f"total_memory {card:,} B ({smi})")
    if table > card:
        raise AssertionError("the HBM table holds more than the card has: "
                             "it would approve an OOM")


def gang_stepcompare(steplog_path, world, smi):
    """17(c), ``--nccl-gang``: the gang train worker's steplog against
    shardcheck's NVLink wire model of its dp layout; reported, not
    gated."""
    from dcos_commons_tpu_torch.analysis import shardcheck
    from dcos_commons_tpu_torch.specification import GpuSpec
    from dcos_commons_tpu_torch.trace.steplog import read_steplog

    gpu = GpuSpec(chips_per_host=world)
    env = dict(TRAIN_ENV, N_LAYERS="2", **gpu.mesh_env())
    workload = shardcheck.PROFILES["train_worker.py"](env, gpu, None, None)
    _, reports = shard_sections(workload)
    cost = shardcheck._cost_model(workload, reports, "h100")
    records = read_steplog(steplog_path)
    compared = shardcheck.stepcompare(cost, records)
    log(f"17(c) stepcompare, gang train worker on {world} cards "
        f"{ {k: v for k, v in workload.mesh.axes().items() if v > 1} } at "
        f"{shardcheck.NVLINK_GBPS['h100']} GB/s: {len(records)} steplog "
        f"records, cost {cost['per_step']}, {compared} ({smi})")


def check_gang_shapes(shapes, gen):
    """K1 and K2 against their plain versions at every shape a gang rank
    launched them at.  Returns the largest max-abs error of each."""
    errs = {"K1": 0.0, "K2": 0.0}
    for rows, d, dtype in sorted(shapes["K1"], key=str):
        r = k1_case(rows, d, dtype, gen)
        errs["K1"] = max(errs["K1"], r["err"])
        log(f"K1 at a gang rank's shape [{rows}, {d}] {dtype}: {fmt_k1(r)}")
    for bh, sq, sk, hd, causal, dtype in sorted(shapes["K2"], key=str):
        r = k2_case(bh, sq, sk, hd, dtype, causal, gen, iters=5)
        errs["K2"] = max(errs["K2"], r["err"])
        log(f"K2 at a gang rank's shape [{bh}, {sq}, {sk}, {hd}] "
            f"causal={causal} {dtype}: {fmt(r)}")
    return errs


def nccl_gang_main(kind, smi):
    """``--nccl-gang``: the gang step over NCCL, one rank a card, on
    every card of the host (2 or 4), against one process; then the gang
    train worker on them, from scratch and resumed."""
    from dcos_commons_tpu_torch.device import build_cuda
    from dcos_commons_tpu_torch.frameworks.train_worker import train_gang

    n = torch.cuda.device_count()
    layouts = {2: GANG_LAYOUTS, 4: NCCL4_LAYOUTS}.get(n)
    if layouts is None:
        log(f"--nccl-gang runs on 2 or 4 cards, this host has {n}")
        return 2
    watchdog = Watchdog()
    watchdog.phase("1 build", 400)
    build_cuda()
    os.makedirs(os.path.join(ROOT, "build", "smoke"), exist_ok=True)
    watchdog.phase(f"12(c) NCCL gang of {n}", 900)
    launches, _ = phase_gang(f"12(c) NCCL x{n}", n, "nccl", layouts, 840)
    log(f"12(c) launches over the ranks {launches}")
    watchdog.phase("12(c) gang train worker", 600)
    ckpt = os.path.join(ROOT, "build", "smoke", "gang_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    env = dict(TRAIN_ENV, N_LAYERS="2", CHECKPOINT_DIR=ckpt,
               SANDBOX=os.path.join(ROOT, "build", "smoke"))
    steplog = os.path.join(env["SANDBOX"], "steplog.jsonl")
    if os.path.exists(steplog):
        os.remove(steplog)
    for steps, start in ((2, 0), (3, 2)):
        result = train_gang(dict(env, TRAIN_STEPS=str(steps)), n, log=log,
                            deadline_s=540)
        if result.start != start or result.checkpoint_errors or not all(
                np.isfinite(list(result.losses.values()))):
            raise AssertionError(f"gang train worker: {result}")
        log(f"12(c) train worker, {n} ranks over NCCL, steps {start}.."
            f"{steps - 1}: batch {result.batch}, losses {result.losses}")
    shutil.rmtree(ckpt, ignore_errors=True)
    gang_stepcompare(steplog, n, smi)
    # the serving gang at full width, one rank a card over NCCL
    watchdog.phase(f"12(c) tp{n} serving gang", 600)
    launches, _ = phase_gang_serving(
        "12(c)", n, "nccl", os.path.join(ROOT, "build", "smoke"), False,
        watchdog)
    log(f"12(c) tp{n} serving launches over the ranks {launches}")
    # long context over NCCL, after the collective probe and the rooflines
    watchdog.phase(f"15 long context on {n} cards", 600)
    launches, _ = phase_long(
        f"15 NCCL x{n}", n, "nccl",
        long_cases({2: LONG_LAYOUTS, 4: NCCL4_LONG_LAYOUTS}[n],
                   torch.bfloat16), 560,
        probe=True)
    log(f"15 NCCL x{n} launches over the ranks {launches}")
    watchdog.stop()
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": n}}), flush=True)
    return 0


def main():
    if not torch.cuda.is_available():
        log("CUDA is not available: chip_smoke needs one NVIDIA card")
        return 2
    from dcos_commons_tpu_torch.device import build_cuda

    t_start = time.monotonic()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:] == ["--nccl-gang"]:
        return nccl_gang_main(kind, smi)

    # phase 1: build every kernel from the checkout
    watchdog = Watchdog()
    watchdog.phase("1 build", 400)
    t0 = time.monotonic()
    build_cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    log(f"build: {time.monotonic() - t0:.1f} s (nvcc, every csrc/*.cu)")

    # the main path's shapes, recorded as it runs
    logs = install_shape_logs()

    # phase 2
    watchdog.phase("2 kernels", 180)
    errs = phase_kernels(gen)
    # phase 2b
    watchdog.phase("2b backward kernels", 240)
    bwd_errs, (r3, r4) = phase_backward(gen)
    errs.update(bwd_errs)

    # phase 3: slot pool at the flagship width
    watchdog.phase("3 slot-pool serving", 300)
    sandbox = os.path.join(ROOT, "build", "smoke")
    os.makedirs(sandbox, exist_ok=True)
    requests = requests_for(32768)
    env = dict(FLAGSHIP_ENV, KV_PAGE_TOKENS="0", SANDBOX=sandbox)
    slot_replies, slot_launches, stats, wall = serve(env, requests, logs)
    report_serving("slot pool", slot_replies, slot_launches, stats, wall)
    if (slot_launches["K1"] == 0 or slot_launches["K2"] == 0
            or slot_launches["K3"] or slot_launches["K4"]):
        raise AssertionError(f"slot path kernels: {slot_launches}")
    k2_shape = logs["K2"].busiest()
    k1_slot_shapes = dict(logs["K1"].shapes)

    # phase 4: paged arena (the default), prefix cache on
    watchdog.phase("4 paged serving", 300)
    env = dict(FLAGSHIP_ENV, KV_PAGE_TOKENS="16",
               PREFILL_CHUNK_TOKENS="64", SANDBOX=sandbox)
    paged_replies, paged_launches, stats, wall = serve(env, requests, logs)
    report_serving("paged", paged_replies, paged_launches, stats, wall)
    if (paged_launches["K1"] == 0 or paged_launches["K2"]
            or paged_launches["K3"] or paged_launches["K4"]):
        raise AssertionError(f"paged path kernels: {paged_launches}")
    if not stats.get("prefix_cache_hit_rate"):
        raise AssertionError("the shared prefix never hit the prefix cache")
    greedy = [i for i, r in enumerate(requests) if r["temperature"] == 0.0]
    pairs = [(slot_replies[i]["tokens"][0], paged_replies[i]["tokens"][0])
             for i in greedy]
    lead = [next((j for j, (a, b) in enumerate(zip(x, y)) if a != b), len(x))
            for x, y in pairs]
    log(f"bf16 greedy agreement slot vs paged (not asserted: bf16 "
        f"near-ties may flip): {sum(x == y for x, y in pairs)}/{len(pairs)} "
        f"replies identical, {sum(x[0] == y[0] for x, y in pairs)}/"
        f"{len(pairs)} first tokens equal, leading tokens equal {lead}")
    for shape, n in logs["K1"].shapes.items():
        k1_slot_shapes[shape] = k1_slot_shapes.get(shape, 0) + n
    logs["K1"].shapes = k1_slot_shapes
    k1_shape = logs["K1"].busiest()

    # phase 5: exact cross-path check in f32
    watchdog.phase("5 cross-path check", 180)
    cross_path_check()

    # phase 6: the train step on the card against the CPU
    watchdog.phase("6 train-step parity", 180)
    train_step_parity(TRAIN_ENV, "flagship",
                      no_remat_layers=NO_REMAT_LAYERS)

    # phase 7: the train worker at the flagship width, then the timed step
    watchdog.phase("7 train worker and timed step", 600)
    from dcos_commons_tpu_torch.models import config_from_env

    flagship = config_from_env(TRAIN_ENV, dtype=torch.bfloat16,
                               no_remat_layers=NO_REMAT_LAYERS)
    peaks = {}
    train_launches, train_shapes = phase_train(
        logs, TRAIN_ENV, NO_REMAT_LAYERS, (6, 8),
        lambda: time_train_step(logs, flagship, TRAIN_BATCH, "flagship",
                                peaks))

    # phase 9: the MoE flagship served on both pool paths
    watchdog.phase("9 MoE serving", 300)
    moe_launches = {}
    for label, extra, slot_path in (
        ("MoE slot pool", {"KV_PAGE_TOKENS": "0"}, True),
        ("MoE paged", {"KV_PAGE_TOKENS": "16", "PREFILL_CHUNK_TOKENS": "64"},
         False),
    ):
        env = dict(FLAGSHIP_ENV, **MOE_ENV, **extra, SANDBOX=sandbox)
        replies, launches, stats, wall = serve(env, requests, logs)
        report_serving(label, replies, launches, stats, wall)
        if (launches["K1"] == 0 or bool(launches["K2"]) != slot_path
                or launches["K3"] or launches["K4"]):
            raise AssertionError(f"{label} kernels: {launches}")
        moe_launches = {n: moe_launches.get(n, 0) + launches[n]
                        for n in logs}

    # phase 10: the MoE train step card against CPU, and the MoE paths'
    # greedy tokens, in f32
    watchdog.phase("10 MoE parity", 300)
    train_step_parity(dict(TRAIN_ENV, **MOE_ENV), "MoE",
                      moe_capacity_factor=MOE_CAPACITY)
    cross_path_check(dict(FLAGSHIP_ENV, **MOE_ENV), "MoE f32")

    # phase 11: the MoE train worker, its resume, the timed and profiled
    # step at bench.py bench_moe's batch
    watchdog.phase("11 MoE train worker and timed step", 600)
    moe_config = config_from_env(dict(TRAIN_ENV, **MOE_ENV),
                                 dtype=torch.bfloat16,
                                 moe_capacity_factor=MOE_CAPACITY)
    moe_train_launches, moe_train_shapes = phase_train(
        logs, dict(TRAIN_ENV, **MOE_ENV), 0, (4, 6),
        lambda: time_train_step(logs, moe_config, MOE_BATCH, "MoE", peaks))
    # phase 12: the gang step.  (a) a world of one over NCCL at the
    # flagship's full size; (b) two processes on the one card over gloo
    watchdog.phase("12a NCCL world of one", 300)
    gang_one_launches = phase_gang_one(logs, flagship)
    for n, shapes in train_shapes.items():
        shapes.update(logs[n].shapes)
    watchdog.phase("12b two processes over gloo", 600)
    gang_two_launches, gang_two_shapes = phase_gang(
        "12(b)", 2, "gloo", GANG_LAYOUTS, 540)
    # phase 13: the serving gang.  (a) f32 at 2 layers against one
    # process; (b) the bf16 flagship at full width over the mix, on both
    # pools, with phase 14 (the router in front of the gang and a single
    # pod) between the slot and the paged gang
    watchdog.phase("13a f32 serving gang", 420)
    phase_gang_f32(sandbox)
    watchdog.phase("13b serving gang, slot", 600)
    serve_gang_launches, serve_gang_shapes = phase_gang_serving(
        "13(b)", 2, "gloo", sandbox, True, watchdog)
    watchdog.phase("13b K1 and K2 at the gang's shapes", 300)
    for name, err in check_gang_shapes(serve_gang_shapes, gen).items():
        errs[name] = max(errs[name], err)
    # phase 15: long context, two processes on the one card over gloo:
    # (a) f32 at 2 layers, (b) the bf16 flagship, Ulysses and ring over
    # sp2 and the pipeline over pp2
    watchdog.phase("15 long context", 300)
    long_counts, long_shapes = phase_long(
        "15", 2, "gloo", long_cases(LONG_LAYOUTS, torch.float32)
        + long_cases(LONG_LAYOUTS, torch.bfloat16), 280)
    # phase 16: the MNIST job, (a) as the scheduler launches it, (b) the
    # MLP card against CPU and its step timed; it runs none of K1-K4
    watchdog.phase("16 MNIST job", 300)
    for shape_log in logs.values():
        shape_log.reset()
    phase_mnist_job(sandbox)
    phase_mnist_parity(smi)
    mnist_launches = {n: logs[n].launches for n in logs}
    log(f"16 MNIST path launches {mnist_launches}")
    if any(mnist_launches.values()):
        raise AssertionError(f"the MNIST path launched {mnist_launches}")
    # phase 17: shardcheck against phase 7's measured peak and the card
    watchdog.phase("17 shardcheck", 120)
    phase_shardcheck(peaks["flagship"], smi)
    launches = {n: slot_launches[n] + paged_launches[n] + train_launches[n]
                + moe_launches[n] + moe_train_launches[n]
                + gang_one_launches[n] + gang_two_launches[n]
                + serve_gang_launches[n] + long_counts[n] for n in logs}
    for n in logs:
        train_shapes[n] |= (moe_train_shapes[n] | gang_two_shapes[n]
                            | long_shapes[n])

    # phase 8, last: every kernel at every shape the train paths gave it
    # (phase 15's Ulysses and pipeline shapes among them).
    # The kernels line times each at the flagship training shape
    # (bench.py batch 12: K1 [24576, 2048], K2-K4 [192, 2048, 2048, 128]),
    # which the timed step launched; K3/K4 were checked there in 2b
    watchdog.phase("8 kernels at the main path's shapes", 300)
    seq = int(TRAIN_ENV["SEQ_LEN"])
    k1_train = (TRAIN_BATCH * seq, 2048, torch.bfloat16)
    attn_train = (TRAIN_BATCH * 16, seq, seq, 128, True, torch.bfloat16)
    k1_moe = (MOE_BATCH * seq, 2048, torch.bfloat16)
    attn_moe = (MOE_BATCH * 16, seq, seq, 128, True, torch.bfloat16)
    if (k1_train not in train_shapes["K1"]
            or attn_train not in train_shapes["K2"]
            or attn_train not in train_shapes["K3"]
            or k1_moe not in moe_train_shapes["K1"]
            or attn_moe not in moe_train_shapes["K3"]):
        raise AssertionError(f"train path shapes {train_shapes}")
    r1 = k1_case(*k1_train, gen)
    log(f"K1 at the training shape {list(k1_train)}: {fmt_k1(r1)}")
    r2 = k2_case(*attn_train[:4], torch.bfloat16, True, gen)
    log(f"K2 at the training shape {list(attn_train[:4])}: {fmt(r2)}")
    # ... and at every other shape the train paths gave it
    checked = {
        "K1": {k1_train, (4096, 2048, torch.bfloat16)}
        | {(rows, 2048, dt) for rows in (1, 8, 64, 960)
           for dt in (torch.bfloat16, torch.float32)},
        "K2": {attn_train}, "K3": {attn_train}, "K4": {attn_train},
    }
    for name, err in check_train_shapes(train_shapes, gen, checked).items():
        errs[name] = max(errs[name], err)
    rows, d, dt = k1_shape
    log(f"K1 at its busiest serving shape {k1_shape}: "
        f"{fmt_k1(k1_case(rows, d, dt, gen))}")
    bh, sq, sk, hd, causal, dt2 = k2_shape
    log(f"K2 at its busiest serving shape {k2_shape}: "
        f"{fmt(k2_case(bh, sq, sk, hd, dt2, causal, gen))}")
    pkg = "dcos_commons_tpu_torch"
    kernels = [
        dict(name="K1 rms_norm", route="cuda",
             design="warp a row, 16-byte vector loads, ctypes launch",
             source=f"{pkg}/csrc/rmsnorm.cu",
             replaces="dcos_commons_tpu/ops/rmsnorm.py:16",
             launches=launches["K1"],
             max_abs_err=max(errs["K1"], r1["err"]), ms=r1["ms"],
             plain_ms=r1["plain_ms"], bound_ms=r1["bound_ms"],
             bound_by=r1["bound_by"], library_ms=r1["library_ms"]),
        dict(name="K2 flash_fwd", route="cuda",
             design="wgmma+tma (bf16), fma (f32)",
             source=f"{pkg}/csrc/flash_fwd.cu",
             replaces="dcos_commons_tpu/ops/attention.py:33",
             launches=launches["K2"],
             max_abs_err=max(errs["K2"], r2["err"]), ms=r2["ms"],
             plain_ms=r2["plain_ms"], bound_ms=r2["bound_ms"],
             bound_by=r2["bound_by"], library_ms=r2["library_ms"]),
    ]
    for name, label, line, design, r in (
        ("K3", "K3 flash_dq", 108, "wgmma+tma (bf16), fma (f32)", r3),
        ("K4", "K4 flash_dkv", 172, "wgmma+tma (bf16), fma (f32)", r4),
    ):
        # plain_ms and library_ms time the whole backward (dq, dk, dv):
        # the plain version and SDPA's backward compute both kernels'
        # outputs in one call
        kernels.append(dict(
            name=label, route="cuda", design=design,
            source=f"{pkg}/csrc/flash_bwd.cu",
            replaces=f"dcos_commons_tpu/ops/attention.py:{line}",
            launches=launches[name], max_abs_err=errs[name], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    watchdog.stop()
    log(f"total {time.monotonic() - t_start:.1f} s")
    log(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

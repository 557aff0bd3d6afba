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
   device memory; one more step runs under ``torch.profiler``, which
   prints the ten device operations that took the most time in it, the
   port's kernels, the device time by kind of work and the device's
   busy share of the step.  Every kernel is then held
   against its plain version
   at each shape these train runs launched it at (K1 [24576, 2048] and
   [4096, 2048] bf16, K2-K4 [192 or 32, 2048, 2048, 128] bf16 causal),
   within ``TOL``.

Each kernel's log line gives its error, its time, the plain version's,
the library call's and the bound, the rate it reached (TFLOP/s) and its
time over the library call's.  Each phase has its own time limit: one
that outlives it (a kernel that hangs the card) is named and ends the
run with exit code 3.

The line before the last is a JSON object ``{"kernels": [...]}``; each
entry's ``design`` says how it computes (K1: a warp a row with 16-byte
vector loads, launched through ctypes; K2-K4: wgmma with TMA-fed tiles
in bf16, f32 FMA in f32).  The last line is ``{"ok": true, "device":
{...}}``.  Without CUDA, or without the port beside it, the script
fails before printing either.
"""

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
        replies = [None] * len(requests)
        errors = []

        def client(i):
            try:
                replies[i] = post(served.port, "/generate", requests[i])
            except Exception as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        t0 = time.monotonic()
        # two waves: the second finds the first's shared prefix pages
        # fully prefilled, so the paged path's prefix cache can hit
        half = len(requests) // 2
        for wave in (range(half), range(half, len(requests))):
            clients = [threading.Thread(target=client, args=(i,))
                       for i in wave]
            for c in clients:
                c.start()
            for c in clients:
                c.join(timeout=900)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = {n: s.inner.launches for n, s in logs.items()}
        if errors:
            raise errors[0]
        stats = post(served.port, "/stats")
    finally:
        served.server.shutdown()
        served.server.server_close()
        served.engine.stop()
    for req, rep in zip(requests, replies):
        toks = rep["tokens"]
        if len(toks) != 1 or len(toks[0]) != req["max_new_tokens"]:
            raise AssertionError(f"reply of the wrong length: {rep}")
        vocab = int(env["VOCAB"])
        if not all(0 <= t < vocab for t in toks[0]):
            raise AssertionError(f"token out of range: {toks[0]}")
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


def cross_path_check():
    """Greedy tokens of the paged and slot paths on a 2-layer f32 model
    at the flagship width must be identical."""
    from dcos_commons_tpu_torch.models import config_from_env, init_params
    from dcos_commons_tpu_torch.serve.engine import PagedEngine, SlotEngine
    from dcos_commons_tpu_torch.serve.pool import PagedPoolModel, PoolModel

    env = dict(FLAGSHIP_ENV, N_LAYERS="2")
    config = config_from_env(env, dtype=torch.float32, remat=False)
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
        raise AssertionError("paged and slot greedy outputs differ in f32")
    log(f"cross-path f32: {len(prompts)} prompts x {n_new} tokens identical")


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


def train_step_parity():
    """Phase 6: one make_train_step of a 2-layer f32 model at the
    flagship width, batch 2, seq 256, on the card and on the CPU from
    the same weights and batch.  TF32 stays off
    (``torch.backends.cuda.matmul.allow_tf32`` is False), so both sides
    compute in f32.  Tolerances: the loss within 1e-5 relative and each
    gradient leaf within 1e-4 relative Frobenius error (f32 sums in
    another order).  After the AdamW step every param whose gradient is
    at least 100 eps (1e-6) agrees within 1e-6 + 1e-5 |p|.  Adam's first
    step moves a param by lr * g / (|g| + eps), whose slope lr * eps /
    (|g| + eps)^2 turns the gradients' rounding differences (about 1e-8
    absolute here) into step differences of up to 2 lr where |g| is
    near eps = 1e-8; those params are held to that 2 lr bound only."""
    from dcos_commons_tpu_torch.models.transformer import (
        adamw, config_from_env, init_params, loss_fn, make_train_step,
    )
    from dcos_commons_tpu_torch.utils.tree import tree_leaves, tree_map

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("phase 6 needs TF32 off")
    env = dict(TRAIN_ENV, N_LAYERS="2", SEQ_LEN="256")
    config = config_from_env(env, dtype=torch.float32,
                             no_remat_layers=NO_REMAT_LAYERS)
    cpu_params = init_params(config, seed=3, device="cpu")
    toks = np.random.default_rng(3).integers(0, config.vocab, (2, 257))
    out = {}
    for dev in ("cuda", "cpu"):
        params = (cpu_params if dev == "cpu"
                  else tree_map(lambda t: t.to(dev), cpu_params))
        tokens = torch.from_numpy(toks[:, :-1]).to(dev)
        targets = torch.from_numpy(toks[:, 1:]).to(dev)
        optimizer = adamw(params, LR)
        leaves = tree_leaves(params)
        loss = loss_fn(config, params, tokens, targets)
        grads = [g.cpu() for g in torch.autograd.grad(loss, leaves)]
        step_loss = make_train_step(config, optimizer)(params, tokens,
                                                       targets)
        out[dev] = (loss.item(), grads, step_loss.item(),
                    [p.detach().cpu() for p in leaves])
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
    log(f"train-step parity (2 layers, f32, TF32 off): loss card {loss_g:.6f}"
        f" cpu {loss_c:.6f}; grad rel err {grad_err:.3e}; params after "
        f"AdamW: max |diff| {max_tight:.3e} where |g| >= 1e-6, "
        f"{max_diff:.3e} over all; {near_eps}/{total} params with |g| < "
        f"1e-6")


def run_train_worker(env, logs, start, steps):
    """One in-process run of the port's train worker; returns the
    launches by kernel, after checking the resume point, the losses
    and the launch counts against ``launches_per_step``."""
    from dcos_commons_tpu_torch.frameworks.train_worker import train

    torch.cuda.synchronize()
    for shape_log in logs.values():
        shape_log.reset()
    t0 = time.monotonic()
    result = train(dict(env, TRAIN_STEPS=str(steps)), log=log,
                   no_remat_layers=NO_REMAT_LAYERS)
    torch.cuda.synchronize()
    launches = {n: s.inner.launches for n, s in logs.items()}
    wall = time.monotonic() - t0
    if result.start != start or result.checkpoint_errors:
        raise AssertionError(f"train worker started at {result.start} "
                             f"(want {start}); {result.checkpoint_errors}")
    if not result.losses or not all(np.isfinite(list(result.losses.values()))):
        raise AssertionError(f"train losses {result.losses}")
    per_step = launches_per_step(int(env["N_LAYERS"]), NO_REMAT_LAYERS)
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


def profile_step(run, top=10):
    """One ``run()`` under ``torch.profiler``: logs the ``top`` device
    operations by device time, the port's kernels, the device time by
    kind of work, and the device's busy time against the step's
    host-clock time (with the profiler on).  Fails when the profiler
    records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ops = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and e.self_device_time_total > 0]
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
    split = {}
    for e in ops:
        kind = next((kind for kind, marks in WORK_KINDS
                     if any(m in e.key for m in marks)), "other")
        split[kind] = split.get(kind, 0.0) + e.self_device_time_total / 1e3
    log("  by kind: " + ", ".join(
        f"{kind} {ms:.1f} ms ({ms / busy_ms:.1%})"
        for kind, ms in sorted(split.items(), key=lambda kv: -kv[1])))


def time_train_step(logs, warmup=2, steps=5):
    """make_train_step at bench.py's training shape: tokens/s, step ms
    and peak device memory (host clock around synchronised steps), then
    one more step under the profiler."""
    from dcos_commons_tpu_torch.models.transformer import (
        adamw, config_from_env, init_params, make_train_step,
    )
    from dcos_commons_tpu_torch.utils import synthetic_tokens

    config = config_from_env(TRAIN_ENV, dtype=torch.bfloat16,
                             no_remat_layers=NO_REMAT_LAYERS)
    params = init_params(config, seed=0, device="cuda")
    step = make_train_step(config, adamw(params, LR))
    tokens, targets = synthetic_tokens(
        TRAIN_BATCH, config.max_seq, config.vocab,
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
    if not np.isfinite(float(loss)):
        raise AssertionError(f"train loss {float(loss)}")
    log(f"train step [batch {TRAIN_BATCH}, seq {config.max_seq}] bf16, "
        f"remat full + 1 stored layer: {dt / steps * 1e3:.1f} ms/step, "
        f"{TRAIN_BATCH * config.max_seq * steps / dt:,.0f} tokens/s, peak "
        f"device memory {peak / 2**30:.2f} GiB, loss {float(loss):.4f}")
    profile_step(lambda: step(params, tokens, targets))
    launches = {n: s.inner.launches for n, s in logs.items()}
    per_step = launches_per_step(config.n_layers, config.no_remat_layers)
    if launches != {n: per_step[n] * (steps + 1) for n in logs}:
        raise AssertionError(f"timed and profiled steps launched {launches}")
    del params, step
    torch.cuda.empty_cache()
    return launches


def phase_train(logs):
    """Phase 7: the train worker from scratch, its resume, and the timed
    step.  Returns the launches by kernel over the three runs and the
    shapes each kernel was launched at in them."""
    ckpt = os.path.join(ROOT, "build", "smoke", "train_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    # a flagship train-state checkpoint is params + two moments widened
    # to f32: 872,466,432 x 3 x 4 bytes = 10.5 GB; with CHECKPOINT_KEEP
    # 1 the next save lands before the last is pruned
    free = shutil.disk_usage(os.path.join(ROOT, "build")).free
    log(f"disk free under build/: {free / 2**30:.1f} GiB")
    if free < 22e9:
        raise AssertionError("phase 7 needs 22 GB of disk for two "
                             "flagship checkpoints")
    env = dict(TRAIN_ENV, CHECKPOINT_DIR=ckpt, CHECKPOINT_KEEP="1",
               SANDBOX=os.path.join(ROOT, "build", "smoke"))
    shapes = {n: set() for n in logs}

    def note_shapes():
        for n, shape_log in logs.items():
            shapes[n].update(shape_log.shapes)

    total = run_train_worker(env, logs, 0, 6)
    note_shapes()
    names = sorted(n for n in os.listdir(ckpt) if n.startswith("step_"))
    if not names or not names[-1].startswith("step_0000000006"):
        raise AssertionError(f"no step-6 checkpoint: {names}")
    for run in (lambda: run_train_worker(env, logs, 6, 8),
                lambda: time_train_step(logs)):
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


def main():
    if not torch.cuda.is_available():
        log("CUDA is not available: chip_smoke needs one NVIDIA card")
        return 2
    from dcos_commons_tpu_torch.device import build_cuda
    from dcos_commons_tpu_torch.ops import attention, rmsnorm

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

    # phase 1: build every kernel from the checkout
    watchdog = Watchdog()
    watchdog.phase("1 build", 400)
    t0 = time.monotonic()
    build_cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    log(f"build: {time.monotonic() - t0:.1f} s (nvcc, every csrc/*.cu)")

    # the main path's shapes, recorded as it runs
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
    train_step_parity()

    # phase 7: the train worker at the flagship width, then the timed step
    watchdog.phase("7 train worker and timed step", 600)
    train_launches, train_shapes = phase_train(logs)
    launches = {n: slot_launches[n] + paged_launches[n] + train_launches[n]
                for n in logs}

    # the kernels line: every kernel at the flagship training shape
    # (bench.py batch 12: K1 [24576, 2048], K2-K4 [192, 2048, 2048, 128]),
    # which the timed step launched; K3/K4 were checked there in 2b
    watchdog.phase("8 kernels at the main path's shapes", 300)
    seq = int(TRAIN_ENV["SEQ_LEN"])
    k1_train = (TRAIN_BATCH * seq, 2048, torch.bfloat16)
    attn_train = (TRAIN_BATCH * 16, seq, seq, 128, True, torch.bfloat16)
    if (k1_train not in train_shapes["K1"]
            or attn_train not in train_shapes["K2"]
            or attn_train not in train_shapes["K3"]):
        raise AssertionError(f"train path shapes {train_shapes}")
    r1 = k1_case(*k1_train, gen)
    log(f"K1 at the training shape {list(k1_train)}: {fmt_k1(r1)}")
    r2 = k2_case(*attn_train[:4], torch.bfloat16, True, gen)
    log(f"K2 at the training shape {list(attn_train[:4])}: {fmt(r2)}")
    # ... and at every other shape the train path gave it
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

"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Run from the repo root: ``python3 chip_smoke.py`` (no arguments, one
CUDA card).  Phases, each fatal on failure:

1. Device and build: the card's name and power limit (nvidia-smi), the
   kernels built from the sources in the checkout (CUDA C++ with nvcc,
   Triton at first launch), build seconds.
2. Each kernel against its plain PyTorch version on the card, at the
   shapes of the serving path, within the tolerances in ``TOL``; kernel,
   plain and library times (CUDA events) beside the least time the card
   could take (``bound_ms``).
3. The slot-pool server (``KV_PAGE_TOKENS=0``) of the port's worker at
   the flagship width (bench.py ``flagship_config``: vocab 32768,
   d_model 2048, 16/16 heads, d_ff 8192, bf16; depth 12) answers
   /generate requests; kernels K1 and K2 must have launched.
4. The paged server (the default) answers the same requests, with a
   shared prefix so the prefix cache is hit; K1 must have launched and
   K2 not (paged attention is plain PyTorch, as in the JAX package).
5. Greedy outputs of the paged and slot paths are token-identical on a
   2-layer f32 model at the same width.

The line before the last is a JSON object ``{"kernels": [...]}``; the
last line is ``{"ok": true, "device": {...}}``.  Without CUDA, or
without the port beside it, the script fails before printing either.
"""

import json
import os
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
# another order; bf16: inputs are exact in both, the f32 result is
# rounded once.  lse: f32 on both sides.
TOL = {
    ("K1", torch.float32): (1e-5, 1e-5),
    ("K1", torch.bfloat16): (1.6e-2, 1.6e-2),
    ("K2", torch.float32): (2e-5, 2e-4),
    ("K2", torch.bfloat16): (1.6e-2, 1.6e-2),
    ("lse", torch.float32): (1e-4, 1e-5),
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
    lib_ms = time_ms(
        lambda: torch.nn.functional.rms_norm(x, (d,), w, eps=rmsnorm.EPS)
    )
    item = x.element_size()
    b_ms, b_by = bound(2 * rows * d * item + d * item, 4 * rows * d,
                       torch.float32)
    return dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by)


def k2_pairs(sq, sk, causal):
    if not causal:
        return sq * sk
    i = np.arange(sq)
    return int(np.minimum(i + 1, sk).sum())


def k2_case(bh, sq, sk, hd, dtype, causal, gen):
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
    ms = time_ms(lambda: kern(q, k, v, causal, False))
    plain_ms = time_ms(
        lambda: attention.reference_attention(q4, k4, v4, causal)
    )
    lib_ms = None
    if sq == sk or not causal:
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_ms = time_ms(lambda: sdpa(q4, k4, v4, is_causal=causal))
    item = q.element_size()
    n_bytes = (2 * bh * sq * hd + 2 * bh * sk * hd) * item
    b_ms, b_by = bound(n_bytes, 4 * hd * bh * k2_pairs(sq, sk, causal),
                       dtype)
    return dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by)


def fmt(r):
    lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
    return (f"max_abs_err {r['err']:.3e}  kernel {r['ms']:.4f} ms  plain "
            f"{r['plain_ms']:.4f} ms  library {lib} ms  bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")


def phase_kernels(gen):
    errs = {"K1": 0.0, "K2": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        for rows in (1, 8, 64, 960):
            r = k1_case(rows, 2048, dtype, gen)
            errs["K1"] = max(errs["K1"], r["err"])
            log(f"K1 rms_norm [{rows}, 2048] {dtype}: {fmt(r)}")
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
    t0 = time.monotonic()
    build_cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.ones(2, 64, device="cuda")
    rmsnorm.rms_norm_kernel(x, x[0])       # triton compiles here
    attention.flash_fwd_kernel(*(torch.ones(1, 8, 64, device="cuda"),) * 3,
                               True)
    torch.cuda.synchronize()
    log(f"build: {time.monotonic() - t0:.1f} s (nvcc + triton)")

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

    # phase 2
    errs = phase_kernels(gen)

    # phase 3: slot pool at the flagship width
    sandbox = os.path.join(ROOT, "build", "smoke")
    os.makedirs(sandbox, exist_ok=True)
    requests = requests_for(32768)
    env = dict(FLAGSHIP_ENV, KV_PAGE_TOKENS="0", SANDBOX=sandbox)
    slot_replies, slot_launches, stats, wall = serve(env, requests, logs)
    report_serving("slot pool", slot_replies, slot_launches, stats, wall)
    if slot_launches["K1"] == 0 or slot_launches["K2"] == 0:
        raise AssertionError(f"slot path skipped a kernel: {slot_launches}")
    k2_shape = logs["K2"].busiest()
    k1_slot_shapes = dict(logs["K1"].shapes)

    # phase 4: paged arena (the default), prefix cache on
    env = dict(FLAGSHIP_ENV, KV_PAGE_TOKENS="16",
               PREFILL_CHUNK_TOKENS="64", SANDBOX=sandbox)
    paged_replies, paged_launches, stats, wall = serve(env, requests, logs)
    report_serving("paged", paged_replies, paged_launches, stats, wall)
    if paged_launches["K1"] == 0 or paged_launches["K2"] != 0:
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
    cross_path_check()

    # the kernels line: timings at each kernel's busiest main-path shape
    rows, d, dt = k1_shape
    r1 = k1_case(rows, d, dt, gen)
    bh, sq, sk, hd, causal, dt2 = k2_shape
    r2 = k2_case(bh, sq, sk, hd, dt2, causal, gen)
    log(f"K1 at main-path shape {k1_shape}: {fmt(r1)}")
    log(f"K2 at main-path shape {k2_shape}: {fmt(r2)}")
    pkg = "dcos_commons_tpu_torch"
    kernels = [
        dict(name="K1 rms_norm", route="triton",
             source=f"{pkg}/ops/rmsnorm.py",
             replaces="dcos_commons_tpu/ops/rmsnorm.py:16",
             launches=slot_launches["K1"] + paged_launches["K1"],
             max_abs_err=max(errs["K1"], r1["err"]), ms=r1["ms"],
             plain_ms=r1["plain_ms"], bound_ms=r1["bound_ms"],
             bound_by=r1["bound_by"], library_ms=r1["library_ms"]),
        dict(name="K2 flash_fwd", route="cuda",
             source=f"{pkg}/csrc/flash_fwd.cu",
             replaces="dcos_commons_tpu/ops/attention.py:33",
             launches=slot_launches["K2"] + paged_launches["K2"],
             max_abs_err=max(errs["K2"], r2["err"]), ms=r2["ms"],
             plain_ms=r2["plain_ms"], bound_ms=r2["bound_ms"],
             bound_by=r2["bound_by"], library_ms=r2["library_ms"]),
    ]
    log(f"total {time.monotonic() - t_start:.1f} s")
    log(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

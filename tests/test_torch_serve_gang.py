"""The port's serving gang (dcos_commons_tpu_torch/models/decode.py and
serve/pool.py with ``mesh=``, frameworks/serve_gang_worker.py) against
the JAX package's single-device serving.

* Parity: the tp-sharded cached paths and pools run on gloo groups of 2
  and 4 CPU processes (spawned as in tests/test_torch_parallel.py, with
  a join deadline and a process-group timeout) and are held against the
  JAX package's single-device ``prefill_into_slot``/``decode_step``,
  ``paged_prefill_chunk``/``paged_decode_step`` and its ``PoolModel``/
  ``PagedPoolModel``, with the same weights (the reference's
  ``init_params``, carried across by ``models/bridge.py``; each rank
  quantizes the full weights itself where the case is int8, then takes
  its block).  f32: every prefill and decode logit within 1e-4 and the
  greedy tokens equal, both at each call (the JAX side's argmax) and
  through the pools' own admission sequence.  Cases: MHA and GQA at tp2
  (tp divides the KV heads) and at tp4 (GQA: it does not, so every rank
  holds every KV head), int8 weights and int8 KV at tp2 and tp4, the
  MoE at tp2; each on the slot and the paged path.
* Planted faults: the same check fails on the slot path with no
  all-reduce after ``wo``, and with the logits left ungathered.
* The gang worker: two processes of serve_gang_worker.py with
  TORCH_DEVICE=cpu, on both pool paths, answer POST /generate through
  rank 0 with the single-process serve worker's greedy tokens, admit a
  request while another decodes, idle past their process-group
  timeout and still serve, and print the reference's ``tp=`` line.
"""

import contextlib
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcos_commons_tpu.models import decode as j_decode
from dcos_commons_tpu.models import transformer as j_tf
from dcos_commons_tpu.models.quantize import (
    quantize_params_int8 as j_quantize,
)
from dcos_commons_tpu.serve import pool as j_pool
from dcos_commons_tpu_torch.models.bridge import params_from_jax
from test_torch_parallel import run_gang

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4
BASE = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=64, max_seq=64, remat=False)
MOE = dict(n_experts=4, moe_top_k=2, moe_group_size=8, d_ff=32)
# the JAX references: config fields, int8 weights, int8 KV
REFS = {
    "mha": ({"n_kv_heads": 4}, False, False),
    "gqa": ({}, False, False),
    "int8-weights": ({}, True, False),
    "int8-kv": ({}, False, True),
    "moe": (MOE, False, False),
}
# case -> (world, reference); at tp4 the 2 KV heads do not split
CASES = {
    "mha-tp2": (2, "mha"),
    "gqa-tp2": (2, "gqa"),
    "int8-weights-tp2": (2, "int8-weights"),
    "int8-kv-tp2": (2, "int8-kv"),
    "moe-tp2": (2, "moe"),
    "mha-tp4": (4, "mha"),
    "gqa-tp4-kv-whole": (4, "gqa"),
    "int8-weights-tp4": (4, "int8-weights"),
    "int8-kv-tp4-kv-whole": (4, "int8-kv"),
}
FAULTS = ("no-reduce-after-wo", "logits-ungathered")
PATHS = ("slot", "paged")

# the slot script: (slot, prompt seed, prompt length) admissions into a
# 3-row pool of 24 positions, each followed by 3 decode steps
SLOTS, MAX_LEN = 3, 24
ADMITS = ((1, 1, 9), (0, 2, 12), (1, 3, 4))
DECODES = 3
# the paged script: 2 rows, pages of 4, 12 pages, chunks of 5; row 1
# shares row 0's first two pages (a prefix hit: it starts at 8)
PAGED = (2, MAX_LEN, 4, 12, 5)
TABLES = np.array([[1, 2, 3, 4, 0, 0], [1, 2, 5, 6, 0, 0]], np.int32)


def _prompt(seed, n, width=None):
    out = np.zeros((1, width or n), np.int32)
    out[0, :n] = np.random.default_rng(seed).integers(0, 64, n)
    return out


def _paged_prompts():
    a = _prompt(4, 11)[0]
    return a, np.concatenate([a[:8], _prompt(5, 3)[0]])


def _chunks(prompt, start):
    """(padded [1, 5] chunk, start, true length) from ``start`` on."""
    out = []
    while start < len(prompt):
        n = min(5, len(prompt) - start)
        chunk = np.zeros((1, 5), np.int32)
        chunk[0, :n] = prompt[start:start + n]
        out.append((chunk, start, n))
        start += n
    return out


# -- what each rank runs -----------------------------------------------------


@contextlib.contextmanager
def _planted(fault):
    """A fault in the port's cached paths, for the check to catch."""
    from dcos_commons_tpu_torch.models import decode

    saved = {k: getattr(decode, k) for k in ("_attn_residual", "reduce_from",
                                             "gather")}
    if fault == "no-reduce-after-wo":
        def residual(config, layer, x, attn, mesh=None):
            b, s, _ = x.shape
            flat = attn.transpose(1, 2).reshape(b, s, -1)
            return x + flat @ layer["wo"]

        decode._attn_residual = residual
        decode.reduce_from = lambda x, mesh, axes: x
    elif fault == "logits-ungathered":
        decode.gather = lambda x, dim, mesh, axes: x
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(decode, k, v)


def _rank_case(mesh, fields, weights_int8, kv_int8, params, script, path):
    """One case on this rank: the logits of every call of the script
    (fed the JAX side's tokens), then the pool's own greedy run."""
    from dcos_commons_tpu_torch.models import decode
    from dcos_commons_tpu_torch.models import transformer as t_tf
    from dcos_commons_tpu_torch.models.quantize import quantize_params_int8
    from dcos_commons_tpu_torch.serve import pool as t_pool
    from dcos_commons_tpu_torch.utils.tree import tree_map

    config = t_tf.TransformerConfig(**fields, dtype=torch.float32)
    full = tree_map(torch.from_numpy, params)
    if weights_int8:
        full = quantize_params_int8(full)
    local = t_tf.shard_params(full, config, mesh)
    kv = "int8" if kv_int8 else "native"
    logits, tokens = [], []

    def t(a):
        return torch.from_numpy(np.asarray(a).astype(np.int64))

    with torch.inference_mode():
        if path == "slot":
            cache = decode.init_kv_cache(config, SLOTS, MAX_LEN, kv, "cpu",
                                         mesh)
            for (slot, seed, n), steps in zip(ADMITS, script):
                got, cache = decode.prefill_into_slot(
                    config, local, cache, t(_prompt(seed, n)), slot, n, mesh)
                logits.append(got.numpy())
                for tok, pos in steps:
                    got, cache = decode.decode_step(config, local, cache,
                                                    t(tok), t(pos), mesh)
                    logits.append(got.numpy())
        else:
            cache = decode.init_paged_kv_cache(config, 13, 4, kv, "cpu", mesh)
            for row, (prompt, start) in enumerate(zip(_paged_prompts(),
                                                      (0, 8))):
                for chunk, at, n in _chunks(prompt, start):
                    got, cache = decode.paged_prefill_chunk(
                        config, local, cache, t(chunk), t(TABLES[row]), at,
                        n, mesh)
                    logits.append(got.numpy())
            for tok, pos in script:
                got, cache = decode.paged_decode_step(
                    config, local, cache, t(tok), t(pos), t(TABLES), mesh)
                logits.append(got.numpy())
    if path == "slot":
        pool = t_pool.PoolModel(config, local, SLOTS, MAX_LEN, kv, mesh=mesh)
        tokens = _slot_pool_run(pool)
    else:
        pool = t_pool.PagedPoolModel(config, local, *PAGED, kv_dtype=kv,
                                     mesh=mesh)
        tokens = _paged_pool_run(pool)
    return logits, tokens


def _rank_main(cases):
    from dcos_commons_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    import torch.distributed as dist

    mesh = make_mesh(MeshSpec(tp=dist.get_world_size()))
    out = {}
    for key, fault, args in cases:
        with _planted(fault):
            out[key] = _rank_case(mesh, *args)
    return out


# -- the pools' own runs (both packages) ------------------------------------


def _slot_pool_run(pool):
    """test_torch_serve's admission sequence on a 3-row pool: every
    first token and decode output."""
    width = 12
    tok = np.zeros(SLOTS, np.int32)
    pos = np.zeros(SLOTS, np.int32)
    zeros_f, zeros_i = np.zeros(SLOTS, np.float32), np.zeros(SLOTS, np.int32)
    out = []
    for slot, seed, n in ADMITS:
        first = pool.prefill(_prompt(seed, n, width), slot, n, 0.0, 0)
        out.append([int(first)])
        tok[slot], pos[slot] = first, n
        for _ in range(DECODES):
            tok = np.array(pool.decode(tok, pos, zeros_f, zeros_i),
                             np.int32)
            out.append(tok.tolist())
            pos = pos + 1
    return out


def _paged_pool_run(pool):
    out, tok = [], np.zeros(2, np.int32)
    for row, (prompt, start) in enumerate(zip(_paged_prompts(), (0, 8))):
        for chunk, at, n in _chunks(prompt, start):
            first = pool.prefill_chunk(chunk, row, TABLES[row], at, n, 0.0,
                                       0)
            out.append([int(first)])
        tok[row] = first
    pos = np.array([11, 11], np.int32)
    zeros_f, zeros_i = np.zeros(2, np.float32), np.zeros(2, np.int32)
    for _ in range(4):
        tok = np.array(pool.decode(tok, pos, zeros_f, zeros_i, TABLES),
                         np.int32)
        out.append(tok.tolist())
        pos = pos + 1
    return out


# -- the JAX side ------------------------------------------------------------

_j_init = jax.jit(j_tf.init_params, static_argnums=0)
_j_slot_prefill = jax.jit(j_decode.prefill_into_slot, static_argnums=0)
_j_decode = jax.jit(j_decode.decode_step, static_argnums=0)
_j_chunk = jax.jit(j_decode.paged_prefill_chunk, static_argnums=0)
_j_paged_decode = jax.jit(j_decode.paged_decode_step, static_argnums=0)


def _jax_reference(fields, weights_int8, kv_int8):
    """(full native params as numpy, {path: (logits, the script's
    tokens, the pool's tokens)})."""
    config = j_tf.TransformerConfig(**fields, dtype=jnp.float32)
    params = _j_init(config, jax.random.key(0))
    full = jax.tree.map(lambda t: t.numpy(), params_from_jax(params, "cpu"))
    if weights_int8:
        params = j_quantize(params)
    kv = "int8" if kv_int8 else "native"
    out = {}

    # slot: every call's logits, the next call fed their argmax
    cache = j_decode.init_kv_cache(config, SLOTS, MAX_LEN, kv)
    logits, script = [], []
    tok = np.zeros(SLOTS, np.int32)
    pos = np.zeros(SLOTS, np.int32)
    for slot, seed, n in ADMITS:
        got, cache = _j_slot_prefill(config, params, cache,
                                     jnp.asarray(_prompt(seed, n)), slot, n)
        logits.append(np.asarray(got))
        tok[slot], pos[slot] = int(np.asarray(got).argmax()), n
        steps = []
        for _ in range(DECODES):
            steps.append((tok.copy(), pos.copy()))
            got, cache = _j_decode(config, params, cache, jnp.asarray(tok),
                                   jnp.asarray(pos))
            logits.append(np.asarray(got))
            tok = np.asarray(got).argmax(-1).astype(np.int32)
            pos = pos + 1
        script.append(steps)
    pool = j_pool.PoolModel(config, params, SLOTS, MAX_LEN, kv_dtype=kv)
    out["slot"] = (logits, script, _slot_pool_run(pool))

    # paged: the chunks of both rows, then 4 decode steps
    cache = j_decode.init_paged_kv_cache(config, 13, 4, kv)
    logits, script, tok = [], [], np.zeros(2, np.int32)
    for row, (prompt, start) in enumerate(zip(_paged_prompts(), (0, 8))):
        for chunk, at, n in _chunks(prompt, start):
            got, cache = _j_chunk(config, params, cache, jnp.asarray(chunk),
                                  jnp.asarray(TABLES[row]), at, n)
            logits.append(np.asarray(got))
        tok[row] = int(np.asarray(got).argmax())
    pos = np.array([11, 11], np.int32)
    for _ in range(4):
        script.append((tok.copy(), pos.copy()))
        got, cache = _j_paged_decode(config, params, cache, jnp.asarray(tok),
                                     jnp.asarray(pos), jnp.asarray(TABLES))
        logits.append(np.asarray(got))
        tok = np.asarray(got).argmax(-1).astype(np.int32)
        pos = pos + 1
    pool = j_pool.PagedPoolModel(config, params, *PAGED, kv_dtype=kv)
    out["paged"] = (logits, script, _paged_pool_run(pool))
    return full, out


def _misfits(got, want):
    """What a rank's (logits, pool tokens) gets wrong against the JAX
    side's (logits, script, pool tokens); empty when it fits."""
    g_logits, g_tokens = got
    w_logits, _, w_tokens = want
    out = []
    for i, (g, w) in enumerate(zip(g_logits, w_logits)):
        if g.shape != w.shape:
            out.append(f"call {i}: logits {g.shape}, want {w.shape}")
            continue
        err = np.abs(g - w).max()
        if not err <= ATOL + ATOL * np.abs(w).max():
            out.append(f"call {i}: logits {err:.3e} apart")
        if not np.array_equal(g.argmax(-1), w.argmax(-1)):
            out.append(f"call {i}: greedy tokens differ")
    if len(g_logits) != len(w_logits):
        out.append(f"{len(g_logits)} calls, want {len(w_logits)}")
    if g_tokens != w_tokens:
        out.append(f"pool tokens {g_tokens}, want {w_tokens}")
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{(case or fault, path): (port result, JAX reference)}."""
    refs = {name: _jax_reference(dict(BASE, **fields), w8, kv8)
            for name, (fields, w8, kv8) in REFS.items()}
    payloads, want = {2: [], 4: []}, {}

    def add(world, key, fault, ref, path):
        fields, w8, kv8 = REFS[ref]
        full, paths = refs[ref]
        payloads[world].append((key, fault, (
            dict(BASE, **fields), w8, kv8, full, paths[path][1], path)))
        want[key] = paths[path]

    for case, (world, ref) in CASES.items():
        for path in PATHS:
            add(world, (case, path), None, ref, path)
    for fault in FAULTS:
        add(2, (fault, "slot"), fault, "gqa", "slot")
    got = {}
    for world, cases in payloads.items():
        got.update(run_gang(tmp_path_factory.mktemp(f"serve{world}"), world,
                            "_rank_main", cases, module=__name__))
    return {key: (got[key], want[key]) for key in want}


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("case", list(CASES))
def test_tp_pools_match_the_jax_single_device_pools(runs, case, path):
    got, want = runs[(case, path)]
    assert not _misfits(got, want)


@pytest.mark.parametrize("fault", FAULTS)
def test_parity_check_catches_a_planted_fault(runs, fault):
    got, want = runs[(fault, "slot")]
    assert _misfits(got, want)


@pytest.mark.parametrize("fields", [{"dp": 2}, {"tp": 2, "ep": 2},
                                    {"tp": 3}])
def test_cached_paths_refuse_a_mesh_they_do_not_run(fields):
    """Only tp shards the cached paths, and it must split the query
    heads (4 here); the KV heads may stay whole."""
    from dcos_commons_tpu_torch.models import decode
    from dcos_commons_tpu_torch.models import transformer as t_tf
    from dcos_commons_tpu_torch.parallel.mesh import Mesh, MeshSpec

    config = t_tf.TransformerConfig(**BASE, dtype=torch.float32)
    with pytest.raises(ValueError):
        decode.check_serving_mesh(config, Mesh(MeshSpec(**fields)))
    decode.check_serving_mesh(config, Mesh(MeshSpec(tp=4)))


# -- the gang worker end to end ---------------------------------------------

_STOP_RANK = r"""
import json, sys, threading, urllib.request
sys.path.insert(0, sys.argv[1])
import torch.distributed as dist
from dcos_commons_tpu_torch.frameworks.serve_gang_worker import build_rank

rank, store, env = int(sys.argv[2]), sys.argv[3], json.loads(sys.argv[4])
gang = build_rank(env, local_rank=rank, local_devices=2,
                  init_method="file://" + store, log=lambda msg: None,
                  ready_file="")
if rank == 0:
    threading.Thread(target=gang.server.serve_forever, daemon=True).start()
    req = urllib.request.Request(
        f"http://127.0.0.1:{gang.port}/generate",
        json.dumps({"tokens": [[1, 2, 3]], "max_new_tokens": 4}).encode(),
        {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        print("reply", json.loads(resp.read())["tokens"], flush=True)
    gang.stop()
else:
    gang.follow()
# after STOP the ranks meet in a collective of their own: a rank still
# waiting for a tick would not reach it
dist.barrier()
print("stopped", flush=True)
"""


@pytest.mark.parametrize("path", ["slot", "paged"])
def test_gang_ranks_stop_together(tmp_path, path):
    """``GangRank.stop`` on rank 0 ends every rank's loop at the same
    tick, after a served request (what chip_smoke.py does before it
    reads each rank's counters)."""
    env = dict(WORKER_ENV, PORT_HTTP="0", SANDBOX=str(tmp_path),
               GANG_TIMEOUT_S="20",
               KV_PAGE_TOKENS="0" if path == "slot" else "8")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _STOP_RANK, REPO, str(rank),
         str(tmp_path / "store"), json.dumps(env)],
        cwd=tmp_path, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=dict(os.environ, OMP_NUM_THREADS="1"))
        for rank in (0, 1)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], outs
    assert all(out.rstrip().endswith("stopped") for out in outs), outs
    assert "reply [[" in outs[0]


WORKER_ENV = dict(
    TORCH_DEVICE="cpu", VOCAB="64", D_MODEL="32", N_LAYERS="2", D_FF="64",
    SEQ_LEN="64", MAX_LEN="64", MAX_NEW_TOKENS="40", SERVE_BATCH="2",
    # the idle ticks must keep the process groups inside this timeout
    GANG_TIMEOUT_S="3",
)
PROMPTS = [[1, 2, 3, 4], [9, 8], [5, 6, 7, 2, 1], list(range(3, 23))]


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _post(port, body, timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", json.dumps(body).encode(),
        {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())["tokens"]


def _stats(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats",
                                timeout=30) as resp:
        return json.loads(resp.read())


def _wait_for(predicate, seconds, what):
    end = time.monotonic() + seconds
    while time.monotonic() < end:
        if predicate():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


@pytest.fixture(scope="module", params=["slot", "paged"])
def gang(request, tmp_path_factory):
    """Two worker processes of one tp2 gang, and one process's greedy
    replies to PROMPTS (the port's serve worker, in this process)."""
    from dcos_commons_tpu_torch.frameworks.serve_worker import build_server

    work = tmp_path_factory.mktemp(f"gang-{request.param}")
    env = dict(WORKER_ENV, KV_PAGE_TOKENS="0" if request.param == "slot"
               else "8")
    served = build_server(dict(env, PORT_HTTP="0", SANDBOX=str(work)),
                          log=lambda msg: None, ready_file="")
    thread = threading.Thread(target=served.server.serve_forever,
                              daemon=True)
    thread.start()
    try:
        direct = {n: [_post(served.port, {"tokens": [p],
                                          "max_new_tokens": n})[0]
                      for p in PROMPTS] for n in (2, 8, 40)}
    finally:
        served.server.shutdown()
        served.server.server_close()
        served.engine.stop()
    port = _free_port()
    coordinator = f"127.0.0.1:{_free_port()}"
    procs, logs = [], []
    for worker in (0, 1):
        sandbox = work / f"worker{worker}"
        sandbox.mkdir()
        log = open(work / f"worker{worker}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(
                REPO, "dcos_commons_tpu_torch", "frameworks",
                "serve_gang_worker.py")],
            cwd=sandbox, stdout=log, stderr=subprocess.STDOUT,
            env=dict(os.environ, **env, PORT_HTTP=str(port),
                     SANDBOX=str(sandbox), TPU_WORKER_ID=str(worker),
                     TPU_WORKER_COUNT="2", COORDINATOR_ADDRESS=coordinator,
                     OMP_NUM_THREADS="1")))
    try:
        _wait_for(lambda: all((work / f"worker{w}" / "ready").exists()
                              for w in (0, 1))
                  or any(p.poll() is not None for p in procs), 120,
                  "both ranks ready")
        assert all(p.poll() is None for p in procs), _tail(work)
        yield port, direct, procs, work
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=30)
        for log in logs:
            log.close()


def _tail(work):
    return "\n".join((work / f"worker{w}.log").read_text()[-3000:]
                     for w in (0, 1))


def test_gang_worker_serves_one_process_greedy_tokens(gang):
    port, direct, procs, work = gang
    for n in (2, 8):
        assert [_post(port, {"tokens": [p], "max_new_tokens": n})[0]
                for p in PROMPTS] == direct[n], _tail(work)
    # one multi-row request with MIXED lengths, per-row true_len
    assert _post(port, {"tokens": PROMPTS[:2], "max_new_tokens": 8}) == \
        direct[8][:2]
    assert "serving sharded generate" in (work / "worker0.log").read_text()
    assert " tp=2 " in (work / "worker0.log").read_text()
    assert "rank 1: following gang broadcasts" in \
        (work / "worker1.log").read_text()
    # every rank samples its decode ticks into its sandbox's steplog
    for worker in (0, 1):
        lines = (work / f"worker{worker}" / "steplog.jsonl").read_text()
        first = json.loads(lines.splitlines()[0])
        assert first["worker"] == worker and first["rows"] >= 1
        assert {"wall_s", "blocked_s"} <= set(first)


def test_gang_worker_admits_mid_flight_and_idles_past_its_timeout(gang):
    port, direct, procs, work = gang
    before = _stats(port)["requests_completed"]
    long_reply = []
    thread = threading.Thread(target=lambda: long_reply.append(
        _post(port, {"tokens": [PROMPTS[3]], "max_new_tokens": 40})[0]))
    thread.start()
    _wait_for(lambda: _stats(port)["active_slots"] >= 1, 30,
              "the long request decoding")
    # admitted while the long one decodes, and done before it
    assert _post(port, {"tokens": [PROMPTS[0]], "max_new_tokens": 2})[0] \
        == direct[2][0]
    stats = _stats(port)
    assert stats["requests_completed"] == before + 1, stats
    assert stats["active_slots"] >= 1, stats
    thread.join(timeout=60)
    assert long_reply == [direct[40][3]]
    # idle past GANG_TIMEOUT_S: the idle ticks keep every rank meeting
    time.sleep(2 * float(WORKER_ENV["GANG_TIMEOUT_S"]))
    assert all(p.poll() is None for p in procs), _tail(work)
    assert _post(port, {"tokens": [PROMPTS[2]], "max_new_tokens": 8})[0] \
        == direct[8][2]

"""The port's serving plane (dcos_commons_tpu_torch/serve and its
worker) against the JAX package's.

* Pools: the port's ``PoolModel``/``PagedPoolModel`` and the JAX ones
  take the same admission sequence on a tiny f32 model with the same
  weights; greedy tokens are identical at every step.
* Sampling: a sampling row's tokens depend on its (seed, position)
  only — not on its slot or its neighbours (serve/pool.py).
* Engines: the port's copies of ``SlotEngine``/``PagedEngine``, driven
  by one recording fake model, make the same device calls in the same
  order as the JAX engines and return the same replies.
* Worker: one subprocess of the port's worker with TORCH_DEVICE=cpu
  answers /generate and /stats.
"""

import json
import os
import subprocess
import sys
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcos_commons_tpu.models import transformer as j_tf
from dcos_commons_tpu.serve import engine as j_engine
from dcos_commons_tpu.serve import pool as j_pool
from dcos_commons_tpu_torch.models import transformer as t_tf
from dcos_commons_tpu_torch.models.bridge import params_from_jax
from dcos_commons_tpu_torch.serve import engine as t_engine
from dcos_commons_tpu_torch.serve import pool as t_pool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_LEN = 24
DIMS = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=64, max_seq=64, remat=False)


@pytest.fixture(scope="module")
def models():
    j_config = j_tf.TransformerConfig(dtype=jnp.float32, **DIMS)
    t_config = t_tf.TransformerConfig(dtype=torch.float32, **DIMS)
    j_params = jax.jit(j_tf.init_params, static_argnums=0)(
        j_config, jax.random.key(0)
    )
    return (j_config, j_params, t_config,
            params_from_jax(j_params, "cpu", torch.float32))


def _prompt(seed, n, width):
    out = np.zeros((1, width), np.int32)
    out[0, :n] = np.random.default_rng(seed).integers(0, 64, n)
    return out


def test_slot_pools_greedy_tokens_identical(models):
    j_config, j_params, t_config, t_params = models
    pools = [j_pool.PoolModel(j_config, j_params, 3, MAX_LEN),
             t_pool.PoolModel(t_config, t_params, 3, MAX_LEN)]
    width = 12
    tok = [np.zeros(3, np.int32) for _ in pools]
    pos = np.zeros(3, np.int32)
    zeros_f, zeros_i = np.zeros(3, np.float32), np.zeros(3, np.int32)
    # admit into slot 1, step, admit into slot 0, step, re-admit slot 1
    for slot, seed, n in ((1, 1, 9), (0, 2, 12), (1, 3, 4)):
        prompt = _prompt(seed, n, width)
        firsts = [p.prefill(prompt, slot, n, 0.0, 0) for p in pools]
        assert firsts[0] == firsts[1]
        for t in tok:
            t[slot] = firsts[0]
        pos[slot] = n
        for _ in range(3):
            outs = [p.decode(t, pos, zeros_f, zeros_i)
                    for p, t in zip(pools, tok)]
            np.testing.assert_array_equal(outs[1], outs[0])
            tok = [o.astype(np.int32) for o in outs]
            pos = pos + 1


def test_paged_pools_greedy_tokens_identical(models):
    j_config, j_params, t_config, t_params = models
    args = (2, MAX_LEN, 4, 12, 5)   # slots, max_len, page, pages, chunk
    pools = [j_pool.PagedPoolModel(j_config, j_params, *args),
             t_pool.PagedPoolModel(t_config, t_params, *args)]
    tables = np.zeros((2, 6), np.int32)
    tables[0, :4] = [1, 2, 3, 4]
    tables[1, :4] = [1, 2, 5, 6]    # shares row 0's first two pages
    prompt = _prompt(4, 11, 11)[0]
    tok = [np.zeros(2, np.int32) for _ in pools]
    for row, start in ((0, 0), (1, 8)):
        p = prompt if row == 0 else np.concatenate(
            [prompt[:8], _prompt(5, 3, 3)[0]]
        )
        while start < 11:
            n = min(5, 11 - start)
            chunk = np.zeros((1, 5), np.int32)
            chunk[0, :n] = p[start:start + n]
            firsts = [pl.prefill_chunk(chunk, row, tables[row], start, n,
                                       0.0, 0) for pl in pools]
            assert firsts[0] == firsts[1]
            start += n
        for t in tok:
            t[row] = firsts[0]
    pos = np.array([11, 11], np.int32)
    zeros_f, zeros_i = np.zeros(2, np.float32), np.zeros(2, np.int32)
    for _ in range(4):
        outs = [pl.decode(t, pos, zeros_f, zeros_i, tables)
                for pl, t in zip(pools, tok)]
        np.testing.assert_array_equal(outs[1], outs[0])
        tok = [o.astype(np.int32) for o in outs]
        pos = pos + 1
    # a page exported from the port's arena imports back unchanged
    page = pools[1].export_page(3)
    pools[1].import_page(7, page)
    for key, arr in pools[1].cache.items():
        torch.testing.assert_close(arr[:, 7], arr[:, 3])


def test_sampling_depends_on_seed_and_position_not_slot(models):
    _, _, t_config, t_params = models
    pool = t_pool.PoolModel(t_config, t_params, 3, MAX_LEN)
    prompt = _prompt(6, 7, 10)
    # the same (seed, position) in two slots, a different seed beside
    firsts = [pool.prefill(prompt, slot, 7, 1.5, seed)
              for slot, seed in ((0, 11), (2, 11), (1, 12))]
    assert firsts[0] == firsts[1]
    tok = np.array(firsts, np.int32)
    pos = np.array([7, 7, 7], np.int32)
    temps = np.full(3, 1.5, np.float32)
    seeds = np.array([11, 12, 11], np.int32)
    tok = tok[[0, 2, 1]]                 # row 1 now holds the seed-12 row
    for _ in range(5):
        tok = pool.decode(tok, pos, temps, seeds).astype(np.int32)
        assert tok[0] == tok[2]
        pos = pos + 1
    # the stream is the row's alone: the same row alone in a fresh pool
    alone = t_pool.PoolModel(t_config, t_params, 1, MAX_LEN)
    first = alone.prefill(prompt, 0, 7, 1.5, 11)
    assert first == firsts[0]


class _Recorder:
    """One fake model for both engines: each next token is a pure
    function of its row's (token, position), and every device call is
    logged (without the random per-request seeds)."""

    def __init__(self):
        self.calls = []
        self.partial = {}

    def prefill(self, padded, slot, true_len, temp, seed):
        prompt = [int(t) for t in padded[0, :true_len]]
        self.calls.append(("prefill", slot, tuple(prompt), temp))
        return (sum(prompt) * 31 + len(prompt)) % 97

    def prefill_chunk(self, padded, slot, table, start, true_len, temp,
                      seed):
        self.calls.append(("chunk", slot, tuple(int(t) for t in table),
                           start, true_len, temp))
        buf = self.partial.setdefault(slot, [])
        del buf[start:]
        buf.extend([0] * (start - len(buf)))
        buf.extend(int(t) for t in padded[0, :true_len])
        return (sum(buf) * 31 + len(buf)) % 97

    def _next(self, tok, pos):
        return np.asarray([(int(t) * 7 + int(p) * 3 + 1) % 97
                           for t, p in zip(tok, pos)], np.int32)

    def decode(self, tok, pos, temps, seeds, n_active=None):
        self.calls.append(("decode", tuple(tok.tolist()),
                           tuple(pos.tolist()), n_active))
        return self._next(tok, pos)

    def paged_decode(self, tok, pos, temps, seeds, tables, n_active=None):
        self.calls.append(("decode", tuple(tok.tolist()),
                           tuple(pos.tolist()),
                           tuple(map(tuple, tables.tolist())), n_active))
        return self._next(tok, pos)


_JOBS = [
    ([[1, 2, 3, 4, 5, 6, 7, 8, 9]], 6, None),
    ([[4], [5, 6]], 5, None),
    ([[1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11]], 4, None),   # prefix hit
    ([[7, 8, 9, 10]], 8, 40),
]


@pytest.mark.parametrize("paged", [False, True])
def test_engines_match_the_jax_engines(paged):
    runs = []
    for module in (j_engine, t_engine):
        rec = _Recorder()
        if paged:
            engine = module.PagedEngine(
                rec.prefill_chunk, rec.paged_decode, 2, 20, 12,
                page_tokens=4, pages=10, chunk_tokens=4,
                prefix_cache=True,
            )
        else:
            engine = module.SlotEngine(rec.prefill, rec.decode, 2, 20, 12)
        try:
            replies = [engine.submit(rows, n, eos_id=eos)
                       for rows, n, eos in _JOBS]
            stats = engine.stats()
        finally:
            engine.stop()
        runs.append((replies, rec.calls, stats))
    (j_replies, j_calls, j_stats), (t_replies, t_calls, t_stats) = runs
    assert t_replies == j_replies
    assert t_calls == j_calls
    assert set(t_stats) == set(j_stats)
    for key in ("requests_completed", "tokens_out", "active_slots"):
        assert t_stats[key] == j_stats[key]


def test_worker_serves_on_cpu(tmp_path):
    env = dict(
        os.environ, TORCH_DEVICE="cpu", VOCAB="64", D_MODEL="32",
        N_LAYERS="2", N_HEADS="4", N_KV_HEADS="2", D_FF="64",
        MAX_LEN="32", MAX_NEW_TOKENS="8", SERVE_BATCH="2",
        PORT_HTTP="0", SANDBOX=str(tmp_path),
    )
    proc = subprocess.Popen(
        [sys.executable,
         os.path.join(REPO, "dcos_commons_tpu_torch", "frameworks",
                      "serve_worker.py")],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
    )
    try:
        port, lines = None, []
        deadline = time.monotonic() + 120
        while port is None and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if line.startswith("warm:"):
                port = int(line.rsplit("port", 1)[1])
        assert port is not None, "".join(lines)
        assert (tmp_path / "ready").exists()
        url = f"http://127.0.0.1:{port}"
        body = json.dumps({"tokens": [[1, 2, 3], [4, 5, 6, 7, 8]],
                           "max_new_tokens": 5}).encode()
        req = urllib.request.Request(url + "/generate", body,
                                     {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            reply = json.loads(resp.read())
        assert [len(r) for r in reply["tokens"]] == [5, 5]
        assert all(0 <= t < 64 for r in reply["tokens"] for t in r)
        bad = urllib.request.Request(
            url + "/generate", json.dumps({"tokens": [[1] * 30]}).encode()
        )
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(bad, timeout=60)
        assert err.value.code == 400
        with urllib.request.urlopen(url + "/stats", timeout=60) as resp:
            stats = json.loads(resp.read())
        assert stats["requests_completed"] == 1
        assert stats["tokens_out"] == 10
        assert "kv_pages_free" in stats      # the paged default
    finally:
        proc.kill()
        proc.wait(timeout=30)
        proc.stdout.close()

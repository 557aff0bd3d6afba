"""Live session migration of the port (``serve/migration.py`` and the
``PagedEngine``'s migration hooks) against the JAX package's, on real
paged pools of a tiny f32 model (2 layers, d_model 64, 4 heads over 2
KV heads, vocab 97), on the CPU.

Seeded numpy weights reach the JAX pools as arrays and the port's
through its weight bridge (``params_from_jax``), so both packages hold
the same params.  The JAX pools run as the JAX package's own tests run
them on the CPU.  Each scenario of ``tests/test_migration.py`` (which
runs on a fake arena) runs here on both packages over
``PagedPoolModel``s, whose pages are exported and imported for real:

* the snapshot's wire round trip, with real page payloads (native and
  int8, whose pages carry their scales);
* a session moved mid-generation finishes the unmigrated greedy
  continuation, and that continuation is equal across the packages;
* a kill at each stage before cutover resumes the source, a kill at
  release is exactly once;
* splice transactionality (the allocator's invariants, the arena
  restored), the refusal of an incompatible snapshot (a native page
  into an int8 arena);
* ``drain_sessions`` with and without a viable destination,
  ``PrefillHandoff``'s ranking by free pages and its fallback;
* the hooks' refusals, the same on both packages;
* two port serve-worker processes (``TORCH_DEVICE=cpu``) drained over
  ``POST /migrate`` and through the port's front door's
  ``/drain?pod=&to=``.

Decisions, stage names, statuses and tokens are compared exactly; page
payloads to 1e-5 in f32, int8 codes to one step (a tie may round either
way) and their scales to 1e-5.  A decode pool's step is paced with a
short sleep so a test can catch a session mid-decode, as the reference
test's fake arena does.
"""

import json
import os
import random
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcos_commons_tpu.models import transformer as j_tf
from dcos_commons_tpu.serve import engine as j_engine
from dcos_commons_tpu.serve import migration as j_mig
from dcos_commons_tpu.serve import paging as j_paging
from dcos_commons_tpu.serve import pool as j_pool
from dcos_commons_tpu_torch.models import transformer as t_tf
from dcos_commons_tpu_torch.models.bridge import params_from_jax
from dcos_commons_tpu_torch.serve import engine as t_engine
from dcos_commons_tpu_torch.serve import migration as t_mig
from dcos_commons_tpu_torch.serve import paging as t_paging
from dcos_commons_tpu_torch.serve import pool as t_pool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = dict(vocab=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq=64, remat=False)
P = 4              # page tokens
CHUNK = 8          # prefill chunk tokens
SLOTS = 3
MAX_LEN = 64
PROMPT_LEN = 48
BANK_PAGES = 40    # every pool's arena; an engine may use fewer
ATOL = 1e-5
PKGS = ("jax", "torch")
STAGES = ("snapshot", "stream", "splice", "cutover")


def _numpy_params(seed=0):
    """Seeded numpy weights in the JAX tree's shapes: matrices with
    1/sqrt(fan-in) scale (embeddings 1), norm gains near 1, so greedy
    margins are wide."""
    config = j_tf.TransformerConfig(dtype=jnp.float32, **DIMS)
    shapes = jax.eval_shape(
        lambda: j_tf.init_params(config, jax.random.key(0)))
    rng = np.random.default_rng(seed)

    def leaf(name, shape):
        if "norm" in name:
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(
                np.float32)
        scale = 1.0 if name == "embed" else shape[-2] ** -0.5
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    return {
        "embed": leaf("embed", shapes["embed"].shape),
        "final_norm": leaf("final_norm", shapes["final_norm"].shape),
        "layers": {name: leaf(name, s.shape)
                   for name, s in sorted(shapes["layers"].items())},
    }


_WEIGHTS = _numpy_params()
_NS = {
    "jax": types.SimpleNamespace(
        engine=j_engine, mig=j_mig, pool=j_pool, paging=j_paging,
        config=j_tf.TransformerConfig(dtype=jnp.float32, **DIMS),
        params=jax.tree_util.tree_map(jnp.asarray, _WEIGHTS)),
    "torch": types.SimpleNamespace(
        engine=t_engine, mig=t_mig, pool=t_pool, paging=t_paging,
        config=t_tf.TransformerConfig(dtype=torch.float32, **DIMS),
        params=params_from_jax(_WEIGHTS, "cpu", torch.float32)),
}
_POOLS = {}
_ORACLES = {}


def _pool(pkg, kv, index):
    """One pool of the bank: a pool is built (and the JAX one compiled)
    once and serves one engine at a time; an engine only reads pages it
    wrote or imported, so an earlier test's pages change nothing."""
    key = (pkg, kv, index)
    if key not in _POOLS:
        ns = _NS[pkg]
        _POOLS[key] = ns.pool.PagedPoolModel(
            ns.config, ns.params, SLOTS, MAX_LEN, P, BANK_PAGES, CHUNK,
            kv_dtype=kv)
    return _POOLS[key]


def _make_pod(pkg, index, kv="native", role="unified", handoff=None,
              pages=BANK_PAGES, step_s=0.004):
    pool = _pool(pkg, kv, index)

    def decode(*args, **kw):
        time.sleep(step_s)
        return pool.decode(*args, **kw)

    return _NS[pkg].engine.PagedEngine(
        pool.prefill_chunk, decode, SLOTS, MAX_LEN, PROMPT_LEN,
        page_tokens=P, pages=pages, chunk_tokens=CHUNK, prefix_cache=True,
        role=role, read_page=pool.export_page, write_page=pool.import_page,
        handoff=handoff, queue_timeout_s=30,
    )


def _oracle(pkg, prompt, n, kv="native"):
    """The unmigrated greedy reply of ``pkg``'s pool."""
    key = (pkg, kv, tuple(prompt), n)
    if key not in _ORACLES:
        eng = _make_pod(pkg, "oracle", kv, step_s=0.0)
        try:
            _ORACLES[key] = eng.submit([list(prompt)], n)[0]
        finally:
            eng.stop()
    return _ORACLES[key]


def _prompt(seed, n):
    return [int(t) for t in np.random.default_rng(seed).integers(0, 97, n)]


def _submit_async(eng, prompt, n, result, key="r"):
    def client():
        try:
            result[key] = eng.submit([prompt], n)
        except BaseException as e:  # noqa: BLE001 — the assertion target
            result[key] = e

    t = threading.Thread(target=client, daemon=True)
    t.start()
    return t


def _wait_mid_decode(eng, min_out=4, timeout=20.0):
    """Block until the single live session decodes with at least
    ``min_out`` tokens out; returns its rid."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        sess = eng.sessions()
        if sess and sess[0]["state"] == "decode" \
                and eng.stats()["tokens_out"] >= min_out:
            return sess[0]["rid"]
        time.sleep(0.002)
    raise AssertionError("session never reached mid-decode")


def _private_pages(eng):
    """Every page privately owned by a live row of ``eng`` (the
    allocator's conservation check takes them)."""
    with eng._cv:
        rows = {r for r in eng._rows if r is not None}
        rows |= set(eng._prefilling)
        rows |= set(eng._spliced.values())
        rows |= set(eng._migrated.values())
        return [p for r in rows for p in r.private_pages]


def _same_pages(a, b, kv_end):
    """Two snapshots' page payloads: the same virtual pages and keys;
    at the positions written ([0, kv_end); the rest of a page is what
    the arena held before), f32 within ATOL, int8 codes within one
    step."""
    assert [v for v, _ in a] == [v for v, _ in b]
    for (v, pa), (_w, pb) in zip(a, b):
        assert sorted(pa) == sorted(pb)
        live = min(P, kv_end - v * P)
        for key in pa:
            x, y = np.asarray(pa[key]), np.asarray(pb[key])
            assert x.dtype == y.dtype and x.shape == y.shape, key
            x, y = x[:, :live], y[:, :live]       # [layers, P, heads, ...]
            if x.dtype == np.int8:
                assert np.abs(x.astype(int) - y.astype(int)).max() <= 1
            else:
                np.testing.assert_allclose(x, y, atol=ATOL, rtol=ATOL)


# -- the greedy reference ----------------------------------------------


@pytest.mark.parametrize("kv", ["native", "int8"])
def test_unmigrated_greedy_replies_equal_across_packages(kv):
    for seed, n in ((1, 13), (2, 6), (3, 21)):
        prompt = _prompt(seed, n)
        assert _oracle("jax", prompt, 30, kv) == \
            _oracle("torch", prompt, 30, kv)


# -- the snapshot and its wire -----------------------------------------


def _handoff_snapshot(pkg, kv, prompt, n):
    """The snapshot a prefill pod exports the moment its prompt is
    prefilled (kv_end = prompt length, one token out: the same state on
    both packages), captured by a handoff that then declines, so the
    pod decodes locally.  Returns (snapshot, the reply)."""
    box = {}

    def capture(engine, rid):
        box["snap"] = engine.export_frozen(rid)
        return None

    eng = _make_pod(pkg, 0, kv, role="prefill", handoff=capture)
    try:
        reply = eng.submit([prompt], n)[0]
    finally:
        eng.stop()
    return box["snap"], reply


@pytest.mark.parametrize("kv", ["native", "int8"])
def test_exported_snapshots_are_twins_and_survive_the_wire(kv):
    prompt, n = _prompt(4, 19), 20
    snaps = {}
    for pkg in PKGS:
        snap, reply = _handoff_snapshot(pkg, kv, prompt, n)
        assert reply == _oracle(pkg, prompt, n, kv)
        wire = json.loads(json.dumps(snap.to_wire()))
        back = _NS[pkg].mig.SessionSnapshot.from_wire(wire)
        assert back.to_wire() == snap.to_wire()
        assert back.nbytes() == snap.nbytes()
        keys = {"k", "v"} | ({"k_scale", "v_scale"} if kv == "int8"
                             else set())
        for _v, payload in back.pages:
            assert set(payload) == keys
            assert payload["k"].dtype == (np.int8 if kv == "int8"
                                          else np.float32)
        snaps[pkg] = snap
    j, t = snaps["jax"], snaps["torch"]
    assert (t.tokens, t.out, t.fill_pos, t.kv_end, t.page_tokens,
            t.max_new, t.source) == (j.tokens, j.out, j.fill_pos, j.kv_end,
                                     j.page_tokens, j.max_new, j.source)
    assert t.kv_end == len(prompt) and len(t.out) == 1
    _same_pages(j.pages, t.pages, t.kv_end)
    # each package reads the other's wire
    for src, dst in (("jax", "torch"), ("torch", "jax")):
        crossed = _NS[dst].mig.SessionSnapshot.from_wire(
            json.loads(json.dumps(snaps[src].to_wire())))
        assert crossed.to_wire() == snaps[src].to_wire()


# -- the protocol ------------------------------------------------------


_MOVED = {}


@pytest.mark.parametrize("pkg", PKGS)
def test_mid_generation_migration_greedy_equal(pkg):
    """Freeze mid-decode, move, and the destination finishes the
    unmigrated greedy continuation; both arenas stay clean and the
    source's pages all come home."""
    src = _make_pod(pkg, 0)
    dst = _make_pod(pkg, 1)
    try:
        free0 = src.stats()["kv_pages_free"]
        prompt, n = _prompt(5, 13), 30
        result = {}
        t = _submit_async(src, prompt, n, result)
        rid = _wait_mid_decode(src, min_out=5)
        transport = _NS[pkg].mig.InProcessTransport()
        record = _NS[pkg].mig.migrate_session(
            src, dst, rid, dest_name="dst", transport=transport)
        assert record.ok and record.stage == "release"
        assert record.pages > 0 and record.bytes > 0
        t.join(timeout=30)
        err = result["r"]
        assert isinstance(err, _NS[pkg].mig.SessionMigratedError), err
        assert err.moved_to == "dst" and err.dest_rid == record.dest_rid
        out = dst.collect(err.dest_rid, timeout=30)
        assert out == _oracle(pkg, prompt, n)
        _MOVED[pkg] = out
        src._allocator.check_invariants()
        dst._allocator.check_invariants()
        assert src.stats()["migrations_out"] == 1
        assert dst.stats()["migrations_in"] == 1
        assert transport.sessions == 1 and transport.bytes_sent > 0
        stats = src.stats()
        assert stats["kv_pages_free"] + stats["kv_pages_reclaimable"] \
            == free0
        assert src.sessions() == []
    finally:
        src.stop()
        dst.stop()


def test_migrated_continuations_equal_across_packages():
    prompt, n = _prompt(5, 13), 30
    for pkg in PKGS:
        if pkg not in _MOVED:
            test_mid_generation_migration_greedy_equal(pkg)
    assert _MOVED["jax"] == _MOVED["torch"] == _oracle("jax", prompt, n)


class ChaosKill(RuntimeError):
    pass


def _kill_before_cutover(pkg, stage):
    """(the record of what a kill at ``stage`` left, for the twin
    comparison)."""
    src = _make_pod(pkg, 0)
    dst = _make_pod(pkg, 1)
    try:
        dst_free0 = dst.stats()["kv_pages_free"]
        prompt, n = _prompt(6, 8), 24
        result = {}
        t = _submit_async(src, prompt, n, result)
        rid = _wait_mid_decode(src)
        seen = []

        def chaos(at):
            seen.append(at)
            if at == stage:
                raise ChaosKill(at)

        with pytest.raises(ChaosKill):
            _NS[pkg].mig.migrate_session(src, dst, rid, dest_name="dst",
                                         chaos=chaos)
        assert dst.sessions() == []
        assert dst.stats()["migrations_in"] == 0
        assert dst.stats()["kv_pages_free"] == dst_free0
        t.join(timeout=30)
        assert result["r"] == [_oracle(pkg, prompt, n)]
        assert src.stats()["migrations_out"] == 0
        src._allocator.check_invariants()
        dst._allocator.check_invariants()
        return seen, result["r"]
    finally:
        src.stop()
        dst.stop()


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("pkg", PKGS)
def test_chaos_kill_before_cutover_resumes_source(pkg, stage):
    """A death at any pre-cutover boundary aborts cleanly: the
    destination keeps nothing, the source finishes the untouched
    greedy reply."""
    assert stage in _NS[pkg].mig.STAGES
    seen, reply = _kill_before_cutover(pkg, stage)
    assert seen == list(STAGES[:STAGES.index(stage) + 1])
    assert reply == [_oracle("jax" if pkg == "torch" else "torch",
                             _prompt(6, 8), 24)]


@pytest.mark.parametrize("pkg", PKGS)
def test_chaos_kill_at_release_is_exactly_once(pkg):
    """Cutover landed, release died: the source must not resume; a
    retried release redirects the client, and the destination's reply
    is the one greedy copy."""
    mig = _NS[pkg].mig
    src = _make_pod(pkg, 0)
    dst = _make_pod(pkg, 1)
    try:
        prompt, n = _prompt(7, 6), 26
        result = {}
        t = _submit_async(src, prompt, n, result)
        rid = _wait_mid_decode(src)

        def chaos(at):
            if at == "release":
                raise RuntimeError("killed post-cutover pre-ack")

        with pytest.raises(mig.ReleasePendingError) as exc:
            mig.migrate_session(src, dst, rid, dest_name="dst", chaos=chaos)
        pending = exc.value
        assert pending.rid == rid and pending.moved_to == "dst"
        dst.abort_splice(pending.dest_rid)      # cutover is final
        assert dst.stats()["migrations_in"] == 1
        assert src.sessions() == []
        assert not t.join(timeout=0.2) and t.is_alive()
        src.release_migrated(rid, moved_to="dst", dest_rid=pending.dest_rid)
        t.join(timeout=30)
        assert isinstance(result["r"], mig.SessionMigratedError)
        assert dst.collect(pending.dest_rid, timeout=30) == \
            _oracle(pkg, prompt, n)
        assert src.stats()["migrations_out"] == 1
        src._allocator.check_invariants()
        dst._allocator.check_invariants()
    finally:
        src.stop()
        dst.stop()


# -- splice transactionality -------------------------------------------


def _fabricated_snapshot(pkg, kv, tokens, out, max_new, fill):
    """A wire-faithful snapshot whose pages are real payloads of the
    arena's layout (zeros)."""
    template = _pool(pkg, kv, "template").export_page(0)
    plen = len(tokens)
    fill_pos = min(fill, plen)
    kv_end = plen + len(out) - 1 if fill_pos >= plen and out else fill_pos
    n_pages = _NS[pkg].paging.pages_for(kv_end, P) if kv_end > 0 else 0
    pages = [(v, {k: np.zeros_like(a) for k, a in template.items()})
             for v in range(n_pages)]
    return _NS[pkg].mig.SessionSnapshot(
        rid=0, tokens=list(tokens), max_new=max_new, temperature=0.0,
        eos=None, seed=1, out=list(out), fill_pos=fill_pos, kv_end=kv_end,
        page_tokens=P, pages=pages)


_SWEEPS = {}


@pytest.mark.parametrize("pkg", PKGS)
def test_splice_abort_sweep_restores_arena(pkg):
    """A seeded sweep of splices and aborts over varied geometry and
    arena pressure: the invariants hold after every op, every refusal
    is the same on both packages, and the arena's free count returns."""
    decisions = []
    for arena_pages in (6, 12, 30):
        rng = random.Random(7)
        pod = _make_pod(pkg, 2, pages=arena_pages)
        try:
            free0 = pod.stats()["kv_pages_free"]
            spliced = []
            for _ in range(10):
                plen = rng.randint(1, 24)
                n_out = rng.randint(1, 12)
                snap = _fabricated_snapshot(
                    pkg, "native",
                    [rng.randrange(97) for _ in range(plen)],
                    [rng.randrange(97) for _ in range(n_out)],
                    max_new=n_out + rng.randint(1, 20),
                    fill=rng.randint(0, plen))
                if plen + snap.max_new > MAX_LEN:
                    continue
                try:
                    spliced.append(pod.splice(snap))
                    decisions.append("spliced")
                except _NS[pkg].mig.MigrationError as e:
                    decisions.append(str(e))
                pod._allocator.check_invariants(_private_pages(pod))
            for rid in spliced:
                pod.abort_splice(rid)
                pod._allocator.check_invariants(_private_pages(pod))
            assert pod.stats()["kv_pages_free"] == free0
        finally:
            pod.stop()
    _SWEEPS[pkg] = decisions
    assert "spliced" in decisions and len(set(decisions)) > 1


def test_splice_sweeps_decide_alike():
    for pkg in PKGS:
        if pkg not in _SWEEPS:
            test_splice_abort_sweep_restores_arena(pkg)
    assert _SWEEPS["jax"] == _SWEEPS["torch"]


@pytest.mark.parametrize("pkg", PKGS)
def test_splice_rejects_incompatible_snapshots_cleanly(pkg):
    mig = _NS[pkg].mig
    pod = _make_pod(pkg, 2, pages=10)
    try:
        free0 = pod.stats()["kv_pages_free"]
        bad = _fabricated_snapshot(pkg, "native", [1, 2, 3], [4],
                                   max_new=4, fill=3)
        bad.page_tokens = 8
        with pytest.raises(mig.MigrationError, match="geometry"):
            pod.splice(bad)
        holey = _fabricated_snapshot(pkg, "native", list(range(9)), [4, 5],
                                     max_new=6, fill=9)
        holey.pages = holey.pages[:1]
        with pytest.raises(mig.MigrationError, match="missing pages"):
            pod.splice(holey)
        huge = _fabricated_snapshot(pkg, "native", list(range(40)), [1],
                                    max_new=20, fill=40)
        with pytest.raises(mig.MigrationError):
            pod.splice(huge)
        assert pod.stats()["kv_pages_free"] == free0
        pod._allocator.check_invariants()
    finally:
        pod.stop()


@pytest.mark.parametrize("pkg", PKGS)
def test_native_session_refused_by_an_int8_pod(pkg):
    """A native arena's pages do not fit an int8 arena (no scales): the
    destination's import refuses them, the splice is undone, the source
    resumes and finishes the untouched reply."""
    src = _make_pod(pkg, 0)
    dst = _make_pod(pkg, 1, kv="int8")
    try:
        dst_free0 = dst.stats()["kv_pages_free"]
        prompt, n = _prompt(8, 10), 24
        result = {}
        t = _submit_async(src, prompt, n, result)
        rid = _wait_mid_decode(src)
        with pytest.raises(ValueError, match="kv_dtype mismatch"):
            _NS[pkg].mig.migrate_session(src, dst, rid, dest_name="int8")
        assert dst.sessions() == [] and dst.stats()["migrations_in"] == 0
        assert dst.stats()["kv_pages_free"] == dst_free0
        dst._allocator.check_invariants(_private_pages(dst))
        t.join(timeout=30)
        assert result["r"] == [_oracle(pkg, prompt, n)]
        src._allocator.check_invariants()
    finally:
        src.stop()
        dst.stop()


@pytest.mark.parametrize("pkg", PKGS)
def test_int8_session_moves_with_its_scales(pkg):
    """An int8 arena's session moves mid-decode with its scales and
    finishes the unmigrated int8 greedy reply."""
    mig = _NS[pkg].mig
    src = _make_pod(pkg, 0, kv="int8")
    dst = _make_pod(pkg, 1, kv="int8")
    try:
        prompt, n = _prompt(9, 17), 30
        result = {}
        t = _submit_async(src, prompt, n, result)
        rid = _wait_mid_decode(src, min_out=3)
        sent = []

        class Recording(mig.InProcessTransport):
            def send(self, snap):
                sent.append(snap)
                return super().send(snap)

        mig.migrate_session(src, dst, rid, dest_name="dst",
                            transport=Recording())
        t.join(timeout=30)
        err = result["r"]
        assert isinstance(err, mig.SessionMigratedError)
        assert dst.collect(err.dest_rid, timeout=30) == \
            _oracle(pkg, prompt, n, "int8")
        (snap,) = sent
        for _v, payload in snap.pages:
            assert payload["k"].dtype == np.int8
            assert payload["k_scale"].dtype == np.float32
            assert (payload["k_scale"] > 0).all()
        src._allocator.check_invariants()
        dst._allocator.check_invariants()
    finally:
        src.stop()
        dst.stop()


# -- drain-with-migration ----------------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_drain_sessions_moves_every_live_session(pkg):
    mig = _NS[pkg].mig
    src = _make_pod(pkg, 0, step_s=0.03)
    big = _make_pod(pkg, 1, pages=40)
    small = _make_pod(pkg, 2, pages=20)
    try:
        prompts = [_prompt(10, 5), _prompt(11, 3), _prompt(12, 4)]
        n = 40
        results = [{} for _ in prompts]
        threads = [_submit_async(src, p, n, r)
                   for p, r in zip(prompts, results)]
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and (
            len(src.sessions()) < len(prompts)
            or any(s["state"] != "decode" for s in src.sessions())
        ):
            time.sleep(0.002)
        report = mig.drain_sessions(src, {"big": big, "small": small})
        assert len(report) == len(prompts)
        assert all(row["ok"] for row in report), report
        assert sorted(tuple(r["tokens"]) for r in report) == \
            sorted(tuple(p) for p in prompts)
        # re-picked a session: the first move goes to the roomier pod
        assert report[0]["dest"] == "big"
        for t in threads:
            t.join(timeout=30)
        dests = {"big": big, "small": small}
        by_prompt = {tuple(r["tokens"]): r for r in report}
        for prompt, result in zip(prompts, results):
            err = result["r"]
            assert isinstance(err, mig.SessionMigratedError), err
            out = dests[err.moved_to].collect(err.dest_rid, timeout=30)
            assert out == _oracle(pkg, prompt, n)
            assert by_prompt[tuple(prompt)]["dest"] == err.moved_to
        assert src.sessions() == []
        assert src.stats()["migrations_out"] == len(prompts)
        for pod in (src, big, small):
            pod._allocator.check_invariants()
    finally:
        for pod in (src, big, small):
            pod.stop()


@pytest.mark.parametrize("pkg", PKGS)
def test_drain_with_no_viable_destination_resumes_sessions(pkg):
    src = _make_pod(pkg, 0)
    tiny = _make_pod(pkg, 1, pages=3)    # cannot admit anything real
    try:
        prompt, n = _prompt(13, 12), 20
        result = {}
        t = _submit_async(src, prompt, n, result)
        _wait_mid_decode(src)
        report = _NS[pkg].mig.drain_sessions(src, {"tiny": tiny})
        assert len(report) == 1 and not report[0]["ok"]
        assert report[0]["dest"] is None and report[0]["dest_rid"] == -1
        assert "page budget" in report[0]["error"]
        t.join(timeout=30)
        assert result["r"] == [_oracle(pkg, prompt, n)]
        src._allocator.check_invariants()
        tiny._allocator.check_invariants()
    finally:
        src.stop()
        tiny.stop()


# -- prefill/decode disaggregation -------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_prefill_handoff_ranks_decode_pods_by_free_pages(pkg):
    mig = _NS[pkg].mig
    pods = {}
    handoff = mig.PrefillHandoff(lambda: pods)
    prefill = _make_pod(pkg, 0, role="prefill", handoff=handoff)
    decode_a = _make_pod(pkg, 1, role="decode", pages=40)
    decode_b = _make_pod(pkg, 2, role="decode", pages=20)
    pods["decode-a"] = decode_a
    pods["decode-b"] = decode_b
    try:
        prompt, n = _prompt(14, 13), 30
        with pytest.raises(mig.SessionMigratedError) as exc:
            prefill.submit([prompt], n)
        err = exc.value
        assert err.moved_to == "decode-a"       # the most free pages
        assert pods[err.moved_to].collect(err.dest_rid, timeout=30) == \
            _oracle(pkg, prompt, n)
        assert handoff.handoffs == 1 and handoff.fallbacks == 0
        assert prefill.stats()["serving_role"] == "prefill"
        assert decode_a.stats()["serving_role"] == "decode"
        assert prefill.sessions() == []
        for pod in (prefill, decode_a, decode_b):
            pod._allocator.check_invariants()
    finally:
        for pod in (prefill, decode_a, decode_b):
            pod.stop()


@pytest.mark.parametrize("pkg", PKGS)
def test_prefill_pod_degrades_to_local_decode(pkg):
    """No decode pod takes the session (none offered, then one too
    small): the handoff falls back and the prefill pod decodes
    locally."""
    mig = _NS[pkg].mig
    pods = {}
    handoff = mig.PrefillHandoff(lambda: pods)
    prefill = _make_pod(pkg, 0, role="prefill", handoff=handoff)
    tiny = _make_pod(pkg, 1, role="decode", pages=3)
    try:
        prompt, n = _prompt(15, 5), 16
        assert prefill.submit([prompt], n) == [_oracle(pkg, prompt, n)]
        pods["tiny"] = tiny
        assert prefill.submit([prompt], n) == [_oracle(pkg, prompt, n)]
        assert handoff.fallbacks == 2 and handoff.handoffs == 0
        prefill._allocator.check_invariants()
        tiny._allocator.check_invariants()
    finally:
        prefill.stop()
        tiny.stop()


# -- the hooks' refusals -----------------------------------------------


def _hook_decisions(pkg):
    """Each migration verb against states it must refuse, and one
    freeze/export/abort/unfreeze round: (verb, outcome) in order."""
    mig = _NS[pkg].mig
    pod = _make_pod(pkg, 0)
    out = []

    def attempt(verb, fn):
        try:
            got = fn()
        except mig.MigrationError as e:
            out.append((verb, "refused", str(e)))
        else:
            out.append((verb, "ok", got))

    try:
        attempt("freeze unknown", lambda: pod.freeze(99))
        attempt("export unknown", lambda: pod.export_frozen(99))
        attempt("activate unknown", lambda: pod.activate(99))
        attempt("abort unknown", lambda: pod.abort_splice(99))
        attempt("release unknown", lambda: pod.release_migrated(
            99, moved_to="x", dest_rid=1))
        attempt("unfreeze unknown", lambda: pod.unfreeze(99))
        prompt, n = _prompt(16, 9), 30
        result = {}
        t = _submit_async(pod, prompt, n, result)
        rid = _wait_mid_decode(pod)
        attempt("export unfrozen", lambda: pod.export_frozen(rid))
        attempt("release unfrozen", lambda: pod.release_migrated(
            rid, moved_to="x", dest_rid=1))
        attempt("freeze", lambda: pod.freeze(rid))
        attempt("sessions frozen", lambda: pod.sessions())
        snap = pod.export_frozen(rid)
        out.append(("export", len(snap.tokens), snap.fill_pos,
                    snap.page_tokens,
                    [v for v, _ in snap.pages] == list(range(
                        _NS[pkg].paging.pages_for(snap.kv_end, P))),
                    snap.kv_end == len(snap.tokens) + len(snap.out) - 1))
        spliced = pod.splice(snap)          # into its own pod
        attempt("activate twice", lambda: (pod.abort_splice(spliced),
                                           pod.activate(spliced)))
        attempt("unfreeze", lambda: pod.unfreeze(rid))
        t.join(timeout=30)
        out.append(("reply", result["r"] == [_oracle(pkg, prompt, n)]))
        stats = pod.stats()
        out.append(("stats", stats["migrations_in"],
                    stats["migrations_out"], stats["serving_role"]))
        pod._allocator.check_invariants()
    finally:
        pod.stop()
    return out


def test_hooks_refuse_and_resume_alike():
    decisions = {pkg: _hook_decisions(pkg) for pkg in PKGS}
    assert decisions["torch"] == decisions["jax"]
    assert ("reply", True) in decisions["torch"]
    assert sum(1 for d in decisions["torch"] if d[1] == "refused") == 7


def test_http_engine_client_refusals_are_migration_errors():
    """The HTTP duck maps an unreachable peer to ``MigrationError`` and
    ranks it last (empty stats), as the reference's does."""
    for mig in (j_mig, t_mig):
        client = mig.HttpEngineClient("gone", "127.0.0.1:9", timeout_s=2)
        with pytest.raises(mig.MigrationError, match="unreachable"):
            client.activate(1)
        assert client.stats() == {}


# -- the worker processes ----------------------------------------------


WORKER_ENV = {
    "TORCH_DEVICE": "cpu", "VOCAB": "97", "D_MODEL": "128",
    "N_LAYERS": "4", "N_HEADS": "4", "N_KV_HEADS": "2", "D_FF": "256",
    "MAX_LEN": "320", "MAX_NEW_TOKENS": "256", "SERVE_BATCH": "3",
    "KV_PAGE_TOKENS": "4", "PREFILL_CHUNK_TOKENS": "8", "PORT_HTTP": "0",
    "OMP_NUM_THREADS": "1",
}
N_WORKER = 200     # new tokens a request: sessions live long enough to move


def _post(port, path, body=None, timeout=120):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data,
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _start_worker(workdir):
    os.makedirs(workdir, exist_ok=True)
    proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "dcos_commons_tpu_torch",
                                      "frameworks", "serve_worker.py")],
        cwd=workdir, env=dict(os.environ, **WORKER_ENV, SANDBOX=workdir),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []
    deadline = time.monotonic() + 120
    for line in proc.stdout:
        lines.append(line)
        if line.startswith("warm:"):
            threading.Thread(target=lambda: lines.extend(proc.stdout),
                             daemon=True).start()
            return proc, int(line.rsplit("port", 1)[1]), lines
        if time.monotonic() > deadline:
            break
    proc.kill()
    proc.wait()
    raise AssertionError("worker did not start:\n" + "".join(lines[-30:]))


@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    root = tmp_path_factory.mktemp("workers")
    started = {}
    try:
        for name in ("A", "B"):
            started[name] = _start_worker(str(root / name))
        yield started
    finally:
        for proc, _port, _lines in started.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=30)


def _wave(port, prompts, moved_to=None):
    """Send ``prompts`` at once to ``port``; returns (replies, errors)."""
    replies, errors = [None] * len(prompts), []

    def client(i):
        try:
            replies[i] = _post(port, "/generate", {
                "tokens": [prompts[i]], "max_new_tokens": N_WORKER,
            })["tokens"][0]
        except urllib.error.HTTPError as e:
            body = json.loads(e.read())
            if e.code != 409 or moved_to is None:
                errors.append(body)
                return
            replies[i] = ("moved", body["migrated_to"], body["dest_rid"])
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    return threads, replies, errors


def _wait_active(port, want=1, timeout=60):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if _post(port, "/stats")["active_slots"] >= want:
            return
        time.sleep(0.002)
    raise AssertionError("the worker never decoded")


def test_workers_drain_over_the_migrate_verb(workers):
    """POST /migrate {"verb": "drain"} on A moves its live sessions to B
    through B's /migrate splice and activate; A's blocked clients get
    409 naming B, and B's collect gives A's own greedy reply."""
    (_pa, a, a_lines), (_pb, b, _b_lines) = workers["A"], workers["B"]
    prompts = [_prompt(20 + i, 30 + 7 * i) for i in range(3)]
    direct = [_post(a, "/generate", {"tokens": [p],
                                     "max_new_tokens": N_WORKER})
              ["tokens"][0] for p in prompts]
    before_a, before_b = _post(a, "/stats"), _post(b, "/stats")
    threads, replies, errors = _wave(a, prompts, moved_to="B")
    _wait_active(a, 2)
    report = _post(a, "/migrate", {"verb": "drain",
                                   "dests": {"B": f"127.0.0.1:{b}"}})
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    rows = report["report"]
    moved = [r for r in rows if r["ok"]]
    assert moved and all(r["dest"] == "B" for r in moved), rows
    assert all("no live session" in r["error"] for r in rows
               if not r["ok"])
    for i, rep in enumerate(replies):
        if isinstance(rep, tuple):
            _tag, dest, dest_rid = rep
            assert dest == "B"
            rep = _post(b, "/generate", {"collect": dest_rid})["tokens"][0]
        assert rep == direct[i]
    after_a, after_b = _post(a, "/stats"), _post(b, "/stats")
    assert after_a["migrations_out"] - before_a["migrations_out"] == \
        len(moved) == after_b["migrations_in"] - before_b["migrations_in"]
    assert any(line.startswith("migrated session ") for line in a_lines)
    assert after_a["kv_pages_free"] + after_a["kv_pages_reclaimable"] == \
        after_a["kv_pages_total"]


def test_workers_drain_through_the_front_door(workers):
    """The port's front door: ``POST /drain?pod=A&to=B`` drains A in the
    router and moves A's sessions to B; the router follows each 409
    with a collect on B, and every client sees A's direct reply."""
    from dcos_commons_tpu_torch.router.frontdoor import RouterServer

    (_pa, a, _la), (_pb, b, _lb) = workers["A"], workers["B"]
    prompts = [_prompt(30 + i, 25 + 5 * i) for i in range(3)]
    direct = [_post(a, "/generate", {"tokens": [p],
                                     "max_new_tokens": N_WORKER})
              ["tokens"][0] for p in prompts]
    pods = {"A": {"address": f"127.0.0.1:{a}"}}

    def discover():
        return {"generation": str(len(pods)),
                "backends": [dict(row, task=name)
                             for name, row in pods.items()]}

    router = RouterServer("http://unused", port=0, host="127.0.0.1",
                          poll_interval_s=0.2, page_tokens=4,
                          discover=discover, log=None)
    router.start()
    try:
        before = _post(router.port, "/stats")
        threads, replies, errors = _wave(router.port, prompts)
        _wait_active(a, 2)
        pods["B"] = {"address": f"127.0.0.1:{b}"}
        router.refresh_once()
        drained = _post(router.port, "/drain?pod=A&to=B", {})
        for t in threads:
            t.join(timeout=120)
        after = _post(router.port, "/stats")
    finally:
        router.stop()
    assert not errors, errors
    assert drained["draining"] and "error" not in drained["report"]
    rows = drained["report"]["report"]
    moved = [r for r in rows if r["ok"]]
    assert moved, rows
    assert replies == direct
    assert after["router_failovers"] == before["router_failovers"]
    assert after["router_migration_follows"] - \
        before["router_migration_follows"] == len(moved)

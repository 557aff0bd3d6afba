"""Sharded serving gang on the cards: the port of
``frameworks/jax/serve_gang_worker.py``.

The model's params are split over every rank of the gang by tensor
parallelism (the WHOLE gang is one tp axis: ``MeshSpec(tp=world)``), and
so is the pool's KV cache (``serve/pool.py`` with ``mesh=``).  Every
rank must take part in every collective, but requests arrive at rank 0
only, so rank 0 drives the gang with one broadcast a tick and every
rank, rank 0 included, executes the same payload:

    NOOP    keep the gang meeting while idle (every ``IDLE_TICK_S``)
    ADMIT   prefill ONE request (paged: ONE CHUNK of one request's
            prompt, through its page table) into the pool
    DECODE  advance EVERY pool row one step (per-row token, position,
            temperature, seed; paged: through per-row page tables)
    STOP    leave the loop: rank 0 is shutting the gang down (the
            port's addition, so a gang ends without a killed rank)

Requests join and leave mid-flight, as in the reference.  The payloads
are the reference's, of fixed shapes whatever the op: slot ``head [6]``
int64, ``rows [slots, 4]`` int64, ``prompt [1, prompt_len]`` int32;
paged the head, the rows, the page tables ``[slots, pages_per_row]`` and
the chunk ``[1, chunk_tokens]``.  They travel as one flat int64 host
tensor over gloo (``parallel.distributed.broadcast_arrays``): beside an
NCCL world on the cards, in a gloo group of their own (``tick_group``),
so a tick costs no host-to-device copy and the idle ticks never touch
NCCL; tp's collectives run on the world.  Page allocation and the
prefix cache are rank 0's host bookkeeping (``PagedEngine``); the other
ranks see only page ids.

The same env contract as the reference (``MAX_LEN``, ``SERVE_BATCH``,
``SERVE_SLOTS``, ``MAX_NEW_TOKENS``, ``KV_PAGE_TOKENS``, ``KV_PAGES``,
``PREFILL_CHUNK_TOKENS``, ``PREFIX_CACHE``, ``KV_DTYPE``,
``WEIGHT_DTYPE``, ``CHECKPOINT_DIR``, ``SERVE_QUEUE_TIMEOUT_S``,
``PORT_HTTP``, ``SANDBOX``, the model's env and the gang's
``COORDINATOR_ADDRESS``/``TPU_WORKER_ID``/``TPU_WORKER_COUNT``), the same
HTTP API on rank 0 (POST ``/generate``, GET ``/stats``), the ready
file and the sampled steplog (``_STEPLOG_EVERY``).  ``TORCH_DEVICE``
(default ``cuda``) as in the serve worker; ``GANG_TIMEOUT_S`` (default
300) bounds every wait of the process groups.

Ranks are placed as in the port's train worker: a worker starts one
rank a local card, rank ``worker_id * k + local_rank`` of
``worker_count * k``, on card ``local_rank``, NCCL on the cards and gloo
on the CPU.  ``WEIGHT_DTYPE=int8`` quantizes the FULL weights before
each rank takes its block, as the reference quantizes the placed
global arrays (a row split over tp keeps its column's scale).  A
checkpoint is restored through the whole train-state layout, as the
port's serve worker does.

Run: ``python -m dcos_commons_tpu_torch.frameworks.serve_gang_worker``
from the repo root (or the file path).  ``build_rank`` sets one rank up
without serving, so a caller can drive the gang from its own processes.
"""

import json
import math
import os
import queue
import sys
import threading
import time
import traceback
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Mapping, Optional

import numpy as np

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
)

from dcos_commons_tpu_torch.serve import (  # noqa: E402
    SERVESTATS_NAME,
    PagedEngine,
    SlotEngine,
    paged_config_from_env,
)
from dcos_commons_tpu_torch.trace.steplog import (  # noqa: E402
    STEPLOG_NAME,
    StepLog,
)
from dcos_commons_tpu_torch.utils.microbatch import (  # noqa: E402
    QueueTimeoutError,
)

# how often idle ranks meet in a noop broadcast: the gang must stay in
# lockstep even with no traffic
IDLE_TICK_S = 0.05

OP_NOOP = 0
OP_ADMIT = 1
OP_DECODE = 2
OP_STOP = 3

# steplog sampling: the first few decode ticks, then every Nth
_STEPLOG_EVERY = 64


def _zero_payload(slots, prompt_len):
    return (
        np.zeros(6, np.int64),                # head [op, a, b, c, d, e]
        np.zeros((slots, 4), np.int64),       # rows [tok, pos, temp_u, seed]
        np.zeros((1, prompt_len), np.int32),  # ADMIT prompt
    )


def _broadcast_tick(group, payload, slots, prompt_len):
    """One gang-wide broadcast: rank 0 passes (head, rows, prompt), the
    others None and receive rank 0's.

    head by op: ADMIT = [op, slot, true_len, seed, temp_micro, 0];
    DECODE = [op, n_active, 0, 0, 0, 0]; NOOP and STOP = [op, 0, ...].
    ``rows`` carries the DECODE pool state (token, position, temperature
    in micro-units, per-row seed)."""
    from dcos_commons_tpu_torch.parallel.distributed import broadcast_arrays

    return broadcast_arrays(payload, _zero_payload(slots, prompt_len),
                            group)


def _execute_tick(pool, head, rows, prompt):
    """Run the broadcast op: EVERY rank (rank 0 included) executes the
    same payload, so the collectives of every rank come in the same
    order.  Returns the op's result (the first token for ADMIT, the next
    tokens for DECODE, None otherwise)."""
    op = int(head[0])
    if op == OP_ADMIT:
        return pool.prefill(
            prompt, slot=int(head[1]), true_len=int(head[2]),
            temp=int(head[4]) / 1e6, seed=int(head[3]),
        )
    if op == OP_DECODE:
        return pool.decode(
            rows[:, 0].astype(np.int32),
            rows[:, 1].astype(np.int32),
            (rows[:, 2] / 1e6).astype(np.float32),
            rows[:, 3].astype(np.int32),
        )
    return None


# -- paged protocol: ADMIT is one prompt CHUNK through the request's page
# table, DECODE carries every row's table; the same fixed shapes every
# tick


def _zero_paged_payload(slots, pages_per_row, chunk_tokens):
    return (
        # head by op: ADMIT = [op, slot, start, true_len, seed,
        # temp_micro]; DECODE = [op, n_active, 0, 0, 0, 0]
        np.zeros(6, np.int64),
        np.zeros((slots, 4), np.int64),   # rows [tok, pos, temp_u, seed]
        np.zeros((slots, pages_per_row), np.int64),  # page tables
        np.zeros((1, chunk_tokens), np.int32),       # ADMIT chunk
    )


def _broadcast_paged_tick(group, payload, slots, pages_per_row,
                          chunk_tokens):
    """One gang-wide broadcast of the paged payload (as
    ``_broadcast_tick``)."""
    from dcos_commons_tpu_torch.parallel.distributed import broadcast_arrays

    return broadcast_arrays(
        payload, _zero_paged_payload(slots, pages_per_row, chunk_tokens),
        group)


def _execute_paged_tick(pool, head, rows, tables, chunk):
    """Execute the broadcast paged op on EVERY rank (rank 0 included):
    page ids arrive as data."""
    op = int(head[0])
    if op == OP_ADMIT:
        slot = int(head[1])
        return pool.prefill_chunk(
            chunk, slot=slot, table=tables[slot].astype(np.int32),
            start=int(head[2]), true_len=int(head[3]),
            temp=int(head[5]) / 1e6, seed=int(head[4]),
        )
    if op == OP_DECODE:
        return pool.decode(
            rows[:, 0].astype(np.int32),
            rows[:, 1].astype(np.int32),
            (rows[:, 2] / 1e6).astype(np.float32),
            rows[:, 3].astype(np.int32),
            tables.astype(np.int32),
        )
    return None


def _rows(tok, pos, temps, seeds):
    return np.stack([
        tok.astype(np.int64),
        pos.astype(np.int64),
        np.round(temps.astype(np.float64) * 1e6).astype(np.int64),
        seeds.astype(np.int64),
    ], axis=1)


@dataclass
class GangRank:
    """One rank of a warm gang, not yet serving.  Rank 0 holds the HTTP
    server and the engine (``server.serve_forever()`` serves, ``stop()``
    ends the gang); every other rank runs ``follow()``, which returns
    when rank 0 stops."""

    rank: int
    mesh: Any
    config: Any
    pool: Any
    tick: Callable[[Optional[tuple]], tuple]
    execute: Callable[..., Any]
    log_tick: Callable[[float, float, int], None]
    server: Optional[ThreadingHTTPServer] = None
    engine: Any = None
    port: int = 0
    stopped: Optional[threading.Event] = None
    stopping: Optional[threading.Event] = None

    def follow(self) -> None:
        """Meet rank 0 in every tick and execute what it scheduled,
        until it broadcasts STOP."""
        while True:
            b0 = time.time()
            payload = self.tick(None)
            blocked_s = time.time() - b0
            head = payload[0]
            if int(head[0]) == OP_STOP:
                return
            t0 = time.time()
            self.execute(*payload)
            if int(head[0]) == OP_DECODE:
                self.log_tick(time.time() - t0, blocked_s, int(head[1]))

    def stop(self, timeout_s: float = 120) -> None:
        """Rank 0: stop taking requests, let the engine finish what it
        holds, broadcast STOP from the engine's own idle tick (so no
        other tick can interleave with it) and stop the engine."""
        self.server.shutdown()
        self.stopping.set()
        if not self.stopped.wait(timeout_s):
            raise TimeoutError(f"the gang did not stop in {timeout_s} s")
        self.engine.stop()
        self.server.server_close()


def build_rank(env: Mapping[str, str],
               local_rank: int = 0,
               local_devices: int = 1,
               init_method: Optional[str] = None,
               backend: Optional[str] = None,
               device: Any = None,
               log: Callable[[str], None] = print,
               ready_file: str = "ready",
               dtype: Any = None) -> GangRank:
    """Join the gang, build the config, the full params (restored and
    quantized as the env says), the rank's block of them, the tp mesh
    and the pool; warm the pool as a gang; on rank 0 bind the HTTP port
    and build the engine; write ``ready_file`` (skipped when empty).

    ``backend`` and ``device`` default to NCCL and card ``local_rank``
    (gloo and the CPU with ``TORCH_DEVICE=cpu``); a caller may put gloo
    ranks on one card instead.  ``init_method`` overrides the
    rendezvous at ``COORDINATOR_ADDRESS``; ``dtype`` the model's (bf16
    on the cards, f32 on the CPU)."""
    import torch

    from dcos_commons_tpu_torch.device import resolve_device
    from dcos_commons_tpu_torch.frameworks.serve_worker import serving_params
    from dcos_commons_tpu_torch.metrics.registry import Metrics
    from dcos_commons_tpu_torch.models import config_from_env
    from dcos_commons_tpu_torch.models.transformer import shard_params
    from dcos_commons_tpu_torch.parallel.distributed import (
        gang_rank,
        initialize_from_env,
        tick_group,
    )
    from dcos_commons_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from dcos_commons_tpu_torch.serve.pool import PagedPoolModel, PoolModel

    kind = env.get("TORCH_DEVICE") or "cuda"
    if device is None:
        device = f"cuda:{local_rank}" if kind == "cuda" else kind
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    timeout_s = float(env.get("GANG_TIMEOUT_S") or 300)
    contract = initialize_from_env(env, backend, local_rank, local_devices,
                                   timeout_s, init_method)
    rank, world = gang_rank(contract, local_rank, local_devices)
    say = log if rank == 0 else (lambda msg: None)
    if ready_file and local_rank == 0:
        # a relaunch reuses the sandbox: a stale ready file from the
        # previous incarnation must not pass readiness while cold
        try:
            os.remove(ready_file)
        except OSError:
            pass
    if dtype is None:
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    config = config_from_env(env, dtype=dtype, remat=False)
    max_len = int(env.get("MAX_LEN", "256"))
    # unset SERVE_BATCH means a bare/dev launch: one request
    batch = int(env.get("SERVE_BATCH", "1"))
    slots = int(env.get("SERVE_SLOTS") or 0) or batch
    new_tokens = int(env.get("MAX_NEW_TOKENS", "32"))
    prompt_len = max_len - new_tokens

    # the WHOLE gang is one tp axis; the tick's group is built right
    # after the mesh's, at the same point on every rank
    mesh = make_mesh(MeshSpec(tp=world))
    group = tick_group(timeout_s) if world > 1 else None
    with torch.inference_mode():
        params = shard_params(serving_params(env, config, device, say),
                              config, mesh)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    kv_dtype = env.get("KV_DTYPE", "native")
    paged = paged_config_from_env(env)
    pages_per_row = chunk_tokens = 0
    if paged is not None:
        pool = PagedPoolModel(
            config, params, slots, max_len, paged.page_tokens, paged.pages,
            paged.chunk_tokens, kv_dtype=kv_dtype, mesh=mesh,
        )
        pages_per_row, chunk_tokens = paged.pages_per_row, paged.chunk_tokens

        def tick(payload):
            return _broadcast_paged_tick(group, payload, slots,
                                         pages_per_row, chunk_tokens)

        execute = lambda *p: _execute_paged_tick(pool, *p)  # noqa: E731
        # warm the pool as a GANG before readiness: every rank reaches
        # this call at the same point
        pool.warm()
    else:
        pool = PoolModel(config, params, slots, max_len, kv_dtype=kv_dtype,
                         mesh=mesh)

        def tick(payload):
            return _broadcast_tick(group, payload, slots, prompt_len)

        execute = lambda *p: _execute_tick(pool, *p)  # noqa: E731
        pool.warm(prompt_len)

    # per-tick step telemetry ($SANDBOX/steplog.jsonl): sampled decode
    # ticks on every rank — wall seconds, active rows, and for the
    # followers the time parked in the broadcast waiting for rank 0
    steplog = StepLog(os.path.join(env.get("SANDBOX", "."), STEPLOG_NAME))
    tick_count = [0]

    def log_tick(wall_s, blocked_s, active):
        n = tick_count[0]
        tick_count[0] += 1
        if n >= 4 and n % _STEPLOG_EVERY:
            return
        steplog.record(n, wall_s=round(wall_s, 6),
                       blocked_s=round(blocked_s, 6), rows=active,
                       tokens=active, worker=rank)

    gang = GangRank(rank, mesh, config, pool, tick, execute, log_tick)
    if rank != 0:
        if ready_file and local_rank == 0:
            with open(ready_file, "w") as f:
                f.write("warm\n")
        log(f"rank {rank}: following gang broadcasts")
        return gang

    # ---- rank 0: the HTTP front end and the engine --------------------
    # the engine's callbacks broadcast the op, then execute it exactly
    # as a follower does; its idle hook keeps the followers meeting
    stopping, stopped = threading.Event(), threading.Event()

    def prefill_fn(padded, slot, true_len, temp, seed):
        # round(), as decode_fn does: truncation would give a request's
        # first token another temperature than its later ones
        head = np.asarray(
            [OP_ADMIT, slot, true_len, seed, round(temp * 1e6), 0], np.int64)
        _, zero_rows, _ = _zero_payload(slots, prompt_len)
        return execute(*tick((head, zero_rows, padded.astype(np.int32))))

    def decode_fn(tok, pos, temps, seeds, n_active):
        head = np.asarray([OP_DECODE, n_active, 0, 0, 0, 0], np.int64)
        payload = tick((head, _rows(tok, pos, temps, seeds),
                        np.zeros((1, prompt_len), np.int32)))
        t0 = time.time()
        out = execute(*payload)
        # rank 0 paces the gang; it never waits in the broadcast
        log_tick(time.time() - t0, 0.0, n_active)
        return out

    def paged_prefill_fn(padded, slot, table, start, true_len, temp, seed):
        head = np.asarray(
            [OP_ADMIT, slot, start, true_len, seed, round(temp * 1e6)],
            np.int64)
        _, zero_rows, zero_tables, _ = _zero_paged_payload(
            slots, pages_per_row, chunk_tokens)
        zero_tables[slot] = table
        return execute(*tick((head, zero_rows, zero_tables,
                              padded.astype(np.int32))))

    def paged_decode_fn(tok, pos, temps, seeds, tables, n_active):
        head = np.asarray([OP_DECODE, n_active, 0, 0, 0, 0], np.int64)
        payload = tick((head, _rows(tok, pos, temps, seeds),
                        tables.astype(np.int64),
                        np.zeros((1, chunk_tokens), np.int32)))
        t0 = time.time()
        out = execute(*payload)
        log_tick(time.time() - t0, 0.0, n_active)
        return out

    def idle_tick():
        if stopped.is_set():
            return  # the followers have left: nobody to meet
        payload = (_zero_paged_payload(slots, pages_per_row, chunk_tokens)
                   if paged is not None else _zero_payload(slots,
                                                           prompt_len))
        # read the flag once: a stop set during this tick's broadcast
        # must not count this NOOP as the STOP
        stop = stopping.is_set()
        if stop:
            payload[0][0] = OP_STOP
        tick(payload)
        if stop:
            stopped.set()

    queue_timeout_s = float(env.get("SERVE_QUEUE_TIMEOUT_S", "600"))
    metrics = Metrics()
    stats_path = os.path.join(env.get("SANDBOX", "."), SERVESTATS_NAME)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def do_GET(self):
            if self.path.split("?")[0] != "/stats":
                self.send_error(404)
                return
            payload = json.dumps(engine.stats()).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def do_POST(self):
            if self.path != "/generate":
                self.send_error(404)
                return
            length = int(self.headers.get("Content-Length", 0))
            try:
                body = json.loads(self.rfile.read(length))
                rows = body["tokens"]
                if len(rows) > batch:
                    raise ValueError(
                        f"{len(rows)} prompts > server batch {batch}"
                    )
                # rows may have MIXED lengths: each rides its own pool
                # slot with its own true_len
                for row in rows:
                    if not 1 <= len(row) <= prompt_len:
                        raise ValueError(
                            f"prompt length must be in [1, {prompt_len}]"
                        )
                if not rows:
                    raise ValueError("tokens must be non-empty")
                temp = float(body.get("temperature", 0.0))
                if not math.isfinite(temp) or not 0.0 <= temp <= 1e4:
                    # bounded: the broadcast head carries the value as
                    # micro-units in an int64
                    raise ValueError(
                        f"temperature must be in [0, 10000], got {temp}"
                    )
                n = min(int(body.get("max_new_tokens", new_tokens)),
                        new_tokens)
                if n < 1:
                    raise ValueError("max_new_tokens must be >= 1")
                eos = body.get("eos")
                if eos is not None:
                    eos = int(eos)
                    if not 0 <= eos < config.vocab:
                        raise ValueError(
                            f"eos must be in [0, {config.vocab})"
                        )
                result = engine.submit(
                    [[int(t) % config.vocab for t in row] for row in rows],
                    n, temperature=temp, eos_id=eos,
                )
                payload = json.dumps({"tokens": result}).encode()
                self.send_response(200)
            except QueueTimeoutError as e:
                # saturation, NOT caller error: clients back off
                payload = json.dumps({"error": str(e)}).encode()
                self.send_response(503)
            except Exception as e:  # noqa: BLE001 — surface to client
                payload = json.dumps({"error": str(e)}).encode()
                self.send_response(400)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

    # bind BEFORE building the engine: the bound port rides the engine's
    # first stats flush (a taken port falls back to an ephemeral bind)
    port = int(env.get("PORT_HTTP", "0"))
    try:
        server = ThreadingHTTPServer(("0.0.0.0", port), Handler)
    except OSError:
        server = ThreadingHTTPServer(("0.0.0.0", 0), Handler)
        log(f"rank 0: port {port} in use; bound "
            f"{server.server_address[1]} instead (advertised via "
            "servestats)")
    bound_port = int(server.server_address[1])
    if paged is not None:
        engine = PagedEngine(
            paged_prefill_fn, paged_decode_fn, slots, max_len, prompt_len,
            page_tokens=paged.page_tokens, pages=paged.pages,
            chunk_tokens=paged.chunk_tokens,
            prefix_cache=paged.prefix_cache,
            queue_timeout_s=queue_timeout_s,
            on_idle=idle_tick, idle_every_s=IDLE_TICK_S,
            stats_path=stats_path, log=log,
            extra_stats={"http_port": bound_port},
        )
        shape = (f"{paged.pages}-page arena (pages of {paged.page_tokens}, "
                 f"{slots} rows, chunk {paged.chunk_tokens})")
    else:
        engine = SlotEngine(
            prefill_fn, decode_fn, slots, max_len, prompt_len,
            queue_timeout_s=queue_timeout_s,
            on_idle=idle_tick, idle_every_s=IDLE_TICK_S,
            stats_path=stats_path, log=log,
            extra_stats={"http_port": bound_port},
        )
        shape = f"{slots}-slot pool"
    engine.register_metrics(metrics)
    if ready_file:
        with open(ready_file, "w") as f:
            f.write("warm\n")
    log(f"rank 0: serving sharded generate over a {shape} "
        f"(prompts<={prompt_len}->{new_tokens}) tp={world} on {bound_port}")
    gang.server, gang.engine, gang.port = server, engine, bound_port
    gang.stopping, gang.stopped = stopping, stopped
    return gang


def serve_rank(env: Mapping[str, str], local_rank: int = 0,
               local_devices: int = 1, init_method: Optional[str] = None,
               log: Callable[[str], None] = print) -> None:
    """Build one rank and serve: rank 0 answers HTTP until it is
    killed, the others follow its ticks until it stops them."""
    gang = build_rank(env, local_rank, local_devices, init_method, log=log)
    if gang.rank != 0:
        gang.follow()
        return
    try:
        gang.server.serve_forever()
    finally:
        gang.engine.stop()
        gang.server.server_close()


def _rank_entry(env, local_rank, local_devices, init_method, errors):
    try:
        serve_rank(env, local_rank, local_devices, init_method,
                   log=lambda msg: print(msg, flush=True))
    except BaseException:  # noqa: BLE001 — reported to the launcher
        errors.put((local_rank, traceback.format_exc()))
        raise


def serve_gang(env: Mapping[str, str], local_devices: int,
               log: Callable[[str], None] = print) -> None:
    """Run this worker's ``local_devices`` ranks: in this process for
    one, else one spawned process each (a lone worker's ranks meet at a
    file store of their own, a gang's at ``COORDINATOR_ADDRESS``).
    Returns when every rank has ended; raises, after stopping the
    others, when one fails."""
    if local_devices == 1:
        serve_rank(env, log=log)
        return
    import multiprocessing
    import tempfile

    ctx = multiprocessing.get_context("spawn")
    errors = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="rendezvous-") as meet:
        init_method = None
        if int(env.get("TPU_WORKER_COUNT", "1") or 1) == 1:
            init_method = "file://" + os.path.join(meet, "store")
        procs = [ctx.Process(target=_rank_entry,
                             args=(dict(env), r, local_devices, init_method,
                                   errors))
                 for r in range(local_devices)]
        for p in procs:
            p.start()
        try:
            while any(p.is_alive() for p in procs):
                try:
                    r, error = errors.get(timeout=1)
                except queue.Empty:
                    if any(p.exitcode not in (None, 0) for p in procs):
                        raise RuntimeError(
                            "a rank exited: exit codes "
                            f"{[p.exitcode for p in procs]}")
                    continue
                raise RuntimeError(f"local rank {r} failed:\n{error}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()


def main() -> int:
    import torch

    kind = os.environ.get("TORCH_DEVICE") or "cuda"
    # one rank a card the host really has
    local_devices = (torch.cuda.device_count()
                     if kind == "cuda" and torch.cuda.is_available() else 1)
    serve_gang(os.environ, max(1, local_devices),
               log=lambda msg: print(msg, flush=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

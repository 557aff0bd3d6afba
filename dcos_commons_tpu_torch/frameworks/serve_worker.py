"""Inference serving task on the card: the port of
``frameworks/jax/serve_worker.py``.

The same env contract (model: ``VOCAB``/``D_MODEL``/``N_LAYERS``/
``N_HEADS``/``N_KV_HEADS``/``D_FF``/``SEQ_LEN``/``N_EXPERTS``; serving:
``MAX_LEN``, ``MAX_NEW_TOKENS``, ``SERVE_BATCH``, ``SERVE_SLOTS``,
``KV_PAGE_TOKENS``, ``KV_PAGES``, ``PREFILL_CHUNK_TOKENS``,
``PREFIX_CACHE``, ``KV_DTYPE``, ``WEIGHT_DTYPE``, ``SERVE_ROLE``,
``SERVE_DECODE_PODS``, ``SERVE_QUEUE_TIMEOUT_S``, ``PORT_HTTP``,
``SANDBOX``), the same HTTP API (POST ``/generate``, GET ``/stats``,
POST ``/migrate``), status codes (400 caller error, 409 migration
redirect or refusal, 503 saturation) and servestats file.  Both pool
paths: the paged arena by default, the slot pool with
``KV_PAGE_TOKENS=0``.  Greedy outputs are token-identical on both.

``TORCH_DEVICE`` (default ``cuda``) picks the device, the counterpart
of the JAX worker's ``JAX_PLATFORMS=cpu`` switch: bf16 on the card,
f32 on the CPU (``TORCH_DTYPE=float32`` or ``bfloat16`` sets it); a
MoE router stays f32 on both, and under ``WEIGHT_DTYPE=int8``.  Without
CUDA and without ``TORCH_DEVICE=cpu`` the worker fails to start.
``/stats`` also carries ``kernel_launches`` (K1-K4 in this process) and,
on a prefill pod that hands off, ``prefill_handoffs`` and
``prefill_fallbacks``.  Weights are random from seed 0, or, with
``CHECKPOINT_DIR``, the params of the train worker's latest checkpoint
(either package's: the file format is shared).

Run: ``python -m dcos_commons_tpu_torch.frameworks.serve_worker`` from
the repo root (or the file path).  ``build_server(env)`` does all the
set-up without serving, so a caller can run the server in a thread.
"""

import json
import math
import os
import sys
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Mapping

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
from dcos_commons_tpu_torch.serve.migration import (  # noqa: E402
    HttpEngineClient,
    MigrationError,
    PrefillHandoff,
    SessionMigratedError,
    SessionSnapshot,
    drain_sessions,
)
from dcos_commons_tpu_torch.utils.microbatch import (  # noqa: E402
    QueueTimeoutError,
)


@dataclass
class Served:
    """A warm server, not yet serving: ``server.serve_forever()``
    starts it; ``engine.stop()`` and ``server.server_close()`` end it."""

    server: ThreadingHTTPServer
    engine: Any
    pool: Any
    config: Any
    port: int
    shape: str


def serving_params(env: Mapping[str, str], config, device,
                   log: Callable[[str], None] = print):
    """The full params a server starts from: random from seed 0, or,
    with ``CHECKPOINT_DIR``, the params of the train worker's latest
    checkpoint; with ``WEIGHT_DTYPE=int8`` quantized whole."""
    from dcos_commons_tpu_torch.models import init_params
    from dcos_commons_tpu_torch.models.transformer import adamw_layout
    from dcos_commons_tpu_torch.utils.checkpoint import (
        SKIP,
        restore_checkpoint,
    )

    params = init_params(config, seed=0, device=device)
    ckpt_dir = env.get("CHECKPOINT_DIR", "")
    if ckpt_dir:
        # serve the TRAINED weights when the train worker's checkpoint
        # exists.  Its tree is {"params", "opt_state"}, flattened with
        # sorted keys, so the optimizer state's 1 + 2n leaves come
        # FIRST: the params are read at their true offsets through the
        # whole train-state layout, the optimizer's leaves skipped.
        like = {"params": params, "opt_state": adamw_layout(params, SKIP)}
        state, step = restore_checkpoint(ckpt_dir, like)
        if step is not None:
            params = state["params"]
            log(f"restored checkpoint step {step}")
    if env.get("WEIGHT_DTYPE", "native") == "int8":
        from dcos_commons_tpu_torch.models import quantize_params_int8

        params = quantize_params_int8(params)
        log("weights quantized to int8 (per-channel)")
    return params


def serving_dtype(env: Mapping[str, str], device):
    """The compute dtype: ``TORCH_DTYPE`` (``bfloat16`` or ``float32``)
    where it is set, else bf16 on the card and f32 on the CPU."""
    import torch

    name = (env.get("TORCH_DTYPE") or "").strip()
    if not name:
        return torch.bfloat16 if device.type == "cuda" else torch.float32
    if name not in ("bfloat16", "float32"):
        raise ValueError(
            f"TORCH_DTYPE must be bfloat16 or float32, got {name!r}"
        )
    return getattr(torch, name)


def build_server(env: Mapping[str, str],
                 log: Callable[[str], None] = print,
                 ready_file: str = "ready") -> Served:
    """Build the model, pool and engine from ``env``, bind the HTTP
    port, warm both entry points and write ``ready_file`` (skipped
    when empty)."""
    import torch

    from dcos_commons_tpu_torch.device import resolve_device
    from dcos_commons_tpu_torch.metrics.registry import Metrics
    from dcos_commons_tpu_torch.models import config_from_env
    from dcos_commons_tpu_torch.ops import kernel_launches
    from dcos_commons_tpu_torch.serve.pool import PagedPoolModel, PoolModel

    device = resolve_device(env.get("TORCH_DEVICE") or "cuda")
    config = config_from_env(
        env, dtype=serving_dtype(env, device), remat=False,
    )
    max_len = int(env.get("MAX_LEN", "256"))
    # unset SERVE_BATCH means a bare/dev launch: one request
    # sdklint: disable=config-default-drift — dev fallback
    batch = int(env.get("SERVE_BATCH", "1"))
    slots = int(env.get("SERVE_SLOTS") or 0) or batch
    new_tokens = int(env.get("MAX_NEW_TOKENS", "32"))

    params = serving_params(env, config, device, log)

    prompt_len = max_len - new_tokens
    kv_dtype = env.get("KV_DTYPE", "native")
    queue_timeout_s = float(env.get("SERVE_QUEUE_TIMEOUT_S", "600"))
    metrics = Metrics()
    stats_path = os.path.join(env.get("SANDBOX", "."), SERVESTATS_NAME)
    paged = paged_config_from_env(env)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def do_GET(self):
            if self.path.split("?")[0] != "/stats":
                self.send_error(404)
                return
            stats = dict(engine.stats(), kernel_launches=kernel_launches())
            if handoff is not None:
                stats["prefill_handoffs"] = handoff.handoffs
                stats["prefill_fallbacks"] = handoff.fallbacks
            payload = json.dumps(stats).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def do_POST(self):
            if self.path == "/migrate":
                self._do_migrate()
                return
            if self.path != "/generate":
                self.send_error(404)
                return
            length = int(self.headers.get("Content-Length", 0))
            try:
                body = json.loads(self.rfile.read(length))
                if "collect" in body:
                    # the migration follow-up (router/core.py): the
                    # session moved HERE mid-generation and the
                    # router collects the finished reply by dest rid
                    result = [engine.collect(int(body["collect"]))]
                    payload = json.dumps({"tokens": result}).encode()
                    self.send_response(200)
                    self._finish(payload)
                    return
                rows = body["tokens"]
                if len(rows) > batch:
                    raise ValueError(
                        f"{len(rows)} prompts > server batch {batch}; "
                        "split the request"
                    )
                # rows may have MIXED lengths (per-row true_len); an
                # over-length prompt is refused, never silently
                # continued as a DIFFERENT (truncated) prompt
                if not rows:
                    raise ValueError("tokens must be non-empty")
                for row in rows:
                    if len(row) < 1:
                        raise ValueError("prompts must be non-empty")
                    if len(row) > prompt_len:
                        raise ValueError(
                            f"prompt length {len(row)} exceeds the "
                            f"server's context {prompt_len}"
                        )
                temp = float(body.get("temperature", 0.0))
                if not math.isfinite(temp) or temp < 0.0:
                    # json.loads accepts NaN/Infinity: a NaN must not
                    # reach the chip, where it poisons sampling
                    raise ValueError(
                        f"temperature must be finite and >= 0, got {temp}"
                    )
                n = int(body.get("max_new_tokens", new_tokens))
                if n < 1:
                    raise ValueError(
                        f"max_new_tokens must be >= 1, got {n}"
                    )
                n = min(n, new_tokens)
                eos = body.get("eos")
                if eos is not None:
                    eos = int(eos)
                    if not 0 <= eos < config.vocab:
                        raise ValueError(
                            f"eos must be in [0, {config.vocab}), got {eos}"
                        )
                clean_rows = [
                    [int(t) % config.vocab for t in row] for row in rows
                ]
                result = engine.submit(
                    clean_rows, n, temperature=temp, eos_id=eos
                )
                payload = json.dumps({"tokens": result}).encode()
                self.send_response(200)
            except SessionMigratedError as e:
                # a redirect, not a failure: the session finished on
                # another pod — 409 names it and the router follows
                # with a collect request (router/frontdoor.py)
                payload = json.dumps({
                    "error": str(e),
                    "rid": e.rid,
                    "migrated_to": e.moved_to,
                    "dest_rid": e.dest_rid,
                }).encode()
                self.send_response(409)
            except QueueTimeoutError as e:
                # saturation, NOT caller error: the request never got
                # a KV slot in time — clients/load generators back off
                payload = json.dumps({"error": str(e)}).encode()
                self.send_response(503)
            except Exception as e:  # noqa: BLE001 — surface to client
                payload = json.dumps({"error": str(e)}).encode()
                self.send_response(400)
            self._finish(payload)

        def _finish(self, payload: bytes) -> None:
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def _do_migrate(self) -> None:
            """The DCN lane's HTTP leg: this pod as a migration
            DESTINATION (serve/migration.py HttpEngineClient drives
            it verb by verb).  409 = the engine refused (budget,
            geometry, unknown rid) — the source aborts cleanly and
            resumes; 400 = malformed request."""
            length = int(self.headers.get("Content-Length", 0))
            try:
                body = json.loads(self.rfile.read(length))
                verb = body.get("verb")
                if paged is None:
                    raise MigrationError(
                        "slot-pool pods cannot host migrations "
                        "(KV_PAGE_TOKENS=0)"
                    )
                if verb == "splice":
                    snap = SessionSnapshot.from_wire(body["snapshot"])
                    dest_rid = engine.splice(snap)
                    payload = json.dumps(
                        {"dest_rid": dest_rid}
                    ).encode()
                elif verb == "activate":
                    engine.activate(int(body["rid"]))
                    payload = json.dumps({"ok": True}).encode()
                elif verb == "abort":
                    engine.abort_splice(int(body["rid"]))
                    payload = json.dumps({"ok": True}).encode()
                elif verb == "drain":
                    # source-side one-shot: move every live session
                    # to the named peers (drain-with-migration — the
                    # front door's /drain?to= and the scale-in plan
                    # both drive this instead of waiting generations
                    # out).  Sessions that cannot move are reported
                    # ok=false and finish here under the legacy drain.
                    dests = {
                        str(peer): HttpEngineClient(str(peer),
                                                    str(addr))
                        for peer, addr in dict(
                            body.get("dests") or {}
                        ).items()
                    }
                    report = drain_sessions(
                        engine, dests,
                        log=log,
                    )
                    payload = json.dumps({"report": report}).encode()
                else:
                    raise ValueError(f"unknown migrate verb {verb!r}")
                self.send_response(200)
            except MigrationError as e:
                payload = json.dumps({"error": str(e)}).encode()
                self.send_response(409)
            except Exception as e:  # noqa: BLE001 — surface to client
                payload = json.dumps({"error": str(e)}).encode()
                self.send_response(400)
            self._finish(payload)

    if ready_file:
        # a relaunch reuses the sandbox: a stale ready file from the
        # previous incarnation must not pass readiness while cold
        try:
            os.remove(ready_file)
        except OSError:
            pass
    # bind before building the engine: the bound port goes into the
    # engine's first stats snapshot
    port = int(env.get("PORT_HTTP", "0"))
    try:
        server = ThreadingHTTPServer(("0.0.0.0", port), Handler)
    except OSError:
        server = ThreadingHTTPServer(("0.0.0.0", 0), Handler)
        log(f"port {port} in use; bound {server.server_address[1]} "
            "instead (advertised via servestats)")
    bound_port = int(server.server_address[1])

    handoff = None
    if paged is not None:
        role = (env.get("SERVE_ROLE") or "").strip() or "unified"
        if role == "prefill":
            decode_pods = {}
            for item in env.get("SERVE_DECODE_PODS", "").split(","):
                if "=" not in item:
                    continue
                peer, addr = item.split("=", 1)
                peer, addr = peer.strip(), addr.strip()
                if peer and addr:
                    decode_pods[peer] = HttpEngineClient(peer, addr)
            if decode_pods:
                handoff = PrefillHandoff(lambda: decode_pods, log=log)
        pool = PagedPoolModel(
            config, params, slots, max_len, paged.page_tokens,
            paged.pages, paged.chunk_tokens, kv_dtype=kv_dtype,
        )
        engine = PagedEngine(
            pool.prefill_chunk, pool.decode, slots, max_len,
            prompt_len,
            page_tokens=paged.page_tokens, pages=paged.pages,
            chunk_tokens=paged.chunk_tokens,
            prefix_cache=paged.prefix_cache,
            queue_timeout_s=queue_timeout_s, stats_path=stats_path,
            role=role, read_page=pool.export_page,
            write_page=pool.import_page, handoff=handoff, log=log,
            extra_stats={"http_port": bound_port},
        )
    else:
        pool = PoolModel(config, params, slots, max_len, kv_dtype=kv_dtype)
        engine = SlotEngine(
            pool.prefill, pool.decode, slots, max_len, prompt_len,
            queue_timeout_s=queue_timeout_s, stats_path=stats_path,
            log=log, extra_stats={"http_port": bound_port},
        )
    engine.register_metrics(metrics)
    try:
        if paged is not None:
            pool.warm()
            shape = (
                f"paged KV: {paged.pages} pages x {paged.page_tokens} "
                f"tokens, {slots} rows, chunk {paged.chunk_tokens}, "
                f"prefix cache {'on' if paged.prefix_cache else 'off'}"
            )
        else:
            pool.warm(prompt_len)
            shape = f"slot pool: {slots} slots x {max_len}"
    except BaseException:
        engine.stop()
        server.server_close()
        raise
    if ready_file:
        with open(ready_file, "w") as f:
            f.write("warm\n")
    log(
        f"warm: continuous batching ({shape}) (prompts<={prompt_len}, "
        f"<={new_tokens} new) on {device} port {bound_port}"
    )
    return Served(server, engine, pool, config, bound_port, shape)


def main() -> int:
    served = build_server(os.environ, log=lambda m: print(m, flush=True))
    try:
        served.server.serve_forever()
    finally:
        served.engine.stop()
        served.server.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

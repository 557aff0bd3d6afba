"""Training task on the card: the port of
``frameworks/jax/train_worker.py``, on ONE card.

The same env contract: ``TRAIN_STEPS``, ``CHECKPOINT_DIR``,
``CHECKPOINT_KEEP``, ``TRAIN_ASYNC_CKPT``, ``TRAIN_GRAD_ACCUM``,
``TRAIN_INFLIGHT_STEPS``, ``DATA_DIR``, ``KEEPALIVE_S``, ``SANDBOX``
(the steplog's directory), the model's ``VOCAB``/``D_MODEL``/
``N_LAYERS``/``N_HEADS``/``N_KV_HEADS``/``D_FF``/``SEQ_LEN``/
``N_EXPERTS`` (> 0: the MoE variant, ``D_FF`` per expert), and the
scheduler's gang contract (``TPU_WORKER_ID``/``TPU_WORKER_COUNT``/
``TPU_NUM_SLICES``/...), plus ``TORCH_DEVICE`` (default ``cuda``) as in
the serve worker.  The same config (``config_from_env`` with bf16, on
the CPU too), batch rule (``max(2, 2 * devices)`` rounded up to a
multiple of ``TRAIN_GRAD_ACCUM``), optimizer (``adamw``, the
counterpart of ``optax.adamw(3e-4)``), synthetic data (one fixed batch
from seed 1) or ``DATA_DIR`` shards, checkpoint cadence (every 20th
step and the last, stamped with the next step to run, so a resumed run
never applies a step twice; the file is the JAX worker's, leaf for
leaf), incarnation fencing, in-flight window and log lines (``step N
loss=...``, ``worker i/n: k steps, t tokens/s``).

One card only: a gang contract (``TPU_WORKER_COUNT`` > 1 or
``TPU_NUM_SLICES`` > 1) raises ``NotImplementedError`` (ROADMAP queue
1, item 8, the multi-GPU train step), and so the gang-only parts of the
JAX worker — the barrier probe (``STEPLOG_BARRIER_PROBE``), the
cross-host agreement on the resume step, the elastic re-layout guard
on ``TPU_TOPOLOGY`` — have nothing to do here.  ``TRAIN_DONATE`` and
the persistent compilation cache have no torch counterpart: the step
always updates in place, and nothing is compiled per process but the
kernels, which ``build/`` keeps.

Run: ``python -m dcos_commons_tpu_torch.frameworks.train_worker`` from
the repo root (or the file path).  ``train(env)`` runs the loop without
the keep-alive, so a caller can drive it in-process.
"""

import math
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
)


@dataclass
class TrainResult:
    """What one ``train`` run did: the first step it ran (the resume
    stamp), the step count it ran to, the drained losses it printed,
    its tokens/s on the host clock, and the final params."""

    start: int
    steps: int
    batch: int
    seconds: float
    tokens_per_s: float
    params: Any
    losses: Dict[int, float] = field(default_factory=dict)
    checkpoint_errors: List[str] = field(default_factory=list)


def train(env: Mapping[str, str],
          log: Callable[[str], None] = print,
          no_remat_layers: int = 0) -> TrainResult:
    """Train ``TRAIN_STEPS`` steps from the latest checkpoint in
    ``CHECKPOINT_DIR`` (or from scratch), as the JAX worker does.
    ``no_remat_layers`` stores the last k layers' activations, as
    bench.py's flagship config does with 1; the worker's ``main`` keeps
    the JAX worker's 0 (every layer rematerialised)."""
    import torch

    from dcos_commons_tpu_torch.data import DevicePrefetcher, TokenDataset
    from dcos_commons_tpu_torch.device import resolve_device
    from dcos_commons_tpu_torch.models.transformer import (
        adamw,
        config_from_env,
        init_params,
        load_train_state,
        make_train_step,
        train_state,
    )
    from dcos_commons_tpu_torch.parallel.distributed import (
        contract_from_env,
        require_single_worker,
    )
    from dcos_commons_tpu_torch.trace.steplog import (
        STEPLOG_NAME,
        InflightWindow,
        StepLog,
    )
    from dcos_commons_tpu_torch.utils import (
        AsyncCheckpointer,
        claim_incarnation,
        restore_checkpoint,
        save_checkpoint,
        synthetic_tokens,
    )

    contract = contract_from_env(env)
    require_single_worker(contract)
    device = resolve_device(env.get("TORCH_DEVICE") or "cuda")
    steps = int(env.get("TRAIN_STEPS", "100"))
    ckpt_dir = env.get("CHECKPOINT_DIR", "checkpoints")
    # per-step telemetry into $SANDBOX/steplog.jsonl, read by the
    # scheduler's /v1/debug/trace
    steplog = StepLog(os.path.join(env.get("SANDBOX", "."), STEPLOG_NAME))
    config = config_from_env(env, dtype=torch.bfloat16,
                             no_remat_layers=no_remat_layers)
    params = init_params(config, seed=0, device=device)
    optimizer = adamw(params, 3e-4)
    # the checkpoint carries params AND optimizer moments; its stamp is
    # the next step to run, so resume never double-applies a step
    state, start = restore_checkpoint(ckpt_dir,
                                      train_state(params, optimizer))
    if start is not None:
        load_train_state(params, optimizer, state)
        log(f"restored checkpoint step {start}")
    start = start or 0
    del state
    grad_accum = max(1, int(env.get("TRAIN_GRAD_ACCUM", "1")))
    # in-flight window: dispatch step N, wait on step N-k's loss.
    # 0 = synchronous (wait every step)
    inflight = max(0, int(env.get("TRAIN_INFLIGHT_STEPS", "2")))
    step_fn = make_train_step(config, optimizer, grad_accum=grad_accum)
    # one device; microbatches must split evenly
    batch = max(2, 2 * 1)
    multiple = math.lcm(grad_accum, 1)
    if batch % multiple:
        batch += multiple - batch % multiple
    data_dir = env.get("DATA_DIR", "")
    batches = None
    if data_dir:
        # real corpus: memory-mapped token shards, prefetched onto the
        # card; the stream is a pure function of (seed, step) so
        # checkpoint resume continues EXACTLY where the last run left
        dataset = TokenDataset(
            data_dir, config.max_seq,
            worker_id=contract["worker_id"],
            worker_count=contract["worker_count"],
        )
        batches = DevicePrefetcher(
            dataset.batches(batch, start_step=start), device, depth=2
        )
        log(f"data: {dataset.n_sequences} sequences for worker "
            f"{contract['worker_id']}")
    else:
        tokens, targets = synthetic_tokens(
            batch, config.max_seq, config.vocab,
            torch.Generator(device=device).manual_seed(1),
        )
    # non-blocking checkpointing: save() costs the loop one device-side
    # clone; the host copy + npz write + fenced prune run on a
    # background thread.  The writer incarnation fences a zombie
    # trainer out of a relaunched worker's CHECKPOINT_DIR.
    keep = int(env.get("CHECKPOINT_KEEP", "3"))
    async_ckpt = env.get("TRAIN_ASYNC_CKPT", "1") not in ("0", "false")
    incarnation = claim_incarnation(ckpt_dir)
    checkpointer = (
        AsyncCheckpointer(ckpt_dir, keep=keep, incarnation=incarnation)
        if async_ckpt else None
    )
    # the bounded in-flight window bills wall_s to the step that
    # incurred it although the host runs k steps ahead of the card
    window = InflightWindow(steplog, inflight)
    losses: Dict[int, float] = {}

    def note_drained(drained):
        for s, ready_loss in drained:
            if s % 20 == 0 or s == steps - 1:
                # the loss is already on the host: float() here cannot
                # stall the card the way the just-dispatched step's
                # loss would
                losses[s] = float(ready_loss)
                log(f"step {s} loss={losses[s]:.4f}")

    t0 = time.time()
    for i in range(start, steps):
        step_t0 = time.time()
        if batches is not None:
            tokens, targets = next(batches)
        loss = step_fn(params, tokens, targets)
        if i % 20 == 0 or i == steps - 1:
            state = train_state(params, optimizer)
            if checkpointer is not None:
                # snapshot NOW: the clone is enqueued before the next
                # step updates these tensors in place
                checkpointer.save(i + 1, state)
            else:
                save_checkpoint(ckpt_dir, i + 1, state, keep=keep,
                                incarnation=incarnation)
        note_drained(window.push(
            i, loss, step_t0, tokens=tokens.shape[0] * tokens.shape[1],
            worker=contract["worker_id"],
        ))
    note_drained(window.drain())
    errors: List[str] = []
    if checkpointer is not None:
        errors = checkpointer.close()
        if errors:
            print(f"checkpoint writer errors: {errors[:3]}",
                  file=sys.stderr, flush=True)
    steplog.close()
    if batches is not None:
        batches.close()
    dt = time.time() - t0
    tps = batch * config.max_seq * (steps - start) / max(dt, 1e-9)
    log(f"worker {contract['worker_id']}/{contract['worker_count']}: "
        f"{steps - start} steps, {tps:,.0f} tokens/s")
    return TrainResult(start=start, steps=steps, batch=batch, seconds=dt,
                       tokens_per_s=tps, params=params, losses=losses,
                       checkpoint_errors=errors)


def main() -> int:
    train(os.environ, log=lambda msg: print(msg, flush=True))
    # goal RUNNING: stay alive until the scheduler kills or
    # reconfigures the pod
    keepalive = os.environ.get("KEEPALIVE_S")
    if keepalive:
        time.sleep(float(keepalive))
    else:
        while True:
            time.sleep(60)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Training task on the card: the port of
``frameworks/jax/train_worker.py``, one process a GPU.

The same env contract: ``TRAIN_STEPS``, ``CHECKPOINT_DIR``,
``CHECKPOINT_KEEP``, ``TRAIN_ASYNC_CKPT``, ``TRAIN_GRAD_ACCUM``,
``TRAIN_INFLIGHT_STEPS``, ``DATA_DIR``, ``KEEPALIVE_S``, ``SANDBOX``
(the steplog's directory), ``STEPLOG_BARRIER_PROBE``,
``TRAIN_ELASTIC_DP``, the model's ``VOCAB``/``D_MODEL``/``N_LAYERS``/
``N_HEADS``/``N_KV_HEADS``/``D_FF``/``SEQ_LEN``/``N_EXPERTS`` (> 0: the
MoE variant, ``D_FF`` per expert), and the scheduler's gang contract
(``COORDINATOR_ADDRESS``, ``TPU_WORKER_ID``/``TPU_WORKER_COUNT``,
``TPU_CHIPS_PER_HOST``, ``TPU_TOPOLOGY``, ``TPU_NUM_SLICES``, ...),
plus ``TORCH_DEVICE`` (default ``cuda``) as in the serve worker.

The gang: a worker starts one rank per local device (``main`` counts
the cards; ``train_gang`` takes the count), rank ``worker_id * k +
local_rank`` of ``worker_count * k``, joined at
``tcp://COORDINATOR_ADDRESS`` (NCCL on the card, gloo on the CPU; the
ranks of a lone worker meet at a file store of their own).  Each rank
then follows the JAX worker:

- the mesh ``mesh_from_env`` derives for the world, and the
  ``TPU_TOPOLOGY`` guard: when the ranks present derive another mesh
  than the declared topology, only a dp/dcn change may proceed, and
  only with ``TRAIN_ELASTIC_DP=1`` (an elastic resume, logged);
- the same config (``config_from_env`` with bf16, on the CPU too), the
  full seeded init, of which the rank keeps its block, and ``adamw``
  (the counterpart of ``optax.adamw(3e-4)``) on the blocks;
- the resume: the checkpoint read whole and cut to the rank's blocks,
  the resume step agreed by the gang (a divergence raises);
- the batch rule ``max(2, 2 * devices)``, rounded up to a multiple of
  the batch shards times ``TRAIN_GRAD_ACCUM`` (each rank splits its own
  rows into the microbatches), the rows of the rank's batch coordinate
  from one fixed batch (seed 1), or from ``DATA_DIR`` (each host's
  ``batch / worker_count`` rows of its shards, split over its ranks);
- the checkpoint cadence (every 20th step and the last, stamped with
  the next step to run; gathered whole, written by rank 0 in the JAX
  worker's file format), rank 0's incarnation claim broadcast to the
  gang, the barrier probe that fills the steplog's ``blocked_s``, the
  in-flight window and the log lines (``step N loss=...``, ``worker
  i/n: k steps, t tokens/s``, from each worker's first rank).

``TRAIN_DONATE`` and the persistent compilation cache have no torch
counterpart: the step always updates in place, and nothing is compiled
per process but the kernels, which ``build/`` keeps.

Run: ``python -m dcos_commons_tpu_torch.frameworks.train_worker`` from
the repo root (or the file path).  ``train(env)`` runs one rank's loop
without the keep-alive, so a caller can drive it in-process;
``train_gang(env, k)`` starts and waits for a worker's k ranks.
"""

import json
import os
import queue
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Mapping, Optional

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
)


@dataclass
class TrainResult:
    """What one ``train`` run did: the first step it ran (the resume
    stamp), the step count it ran to, the global batch, the drained
    losses it printed, its tokens/s on the host clock, the final
    params (this rank's blocks), and the kernel launches (K1-K4, as
    ``ops.kernel_launches`` counts them) of the run, one dict for each
    local rank of the worker."""

    start: int
    steps: int
    batch: int
    seconds: float
    tokens_per_s: float
    params: Any
    losses: Dict[int, float] = field(default_factory=dict)
    checkpoint_errors: List[str] = field(default_factory=list)
    launches: List[Dict[str, int]] = field(default_factory=list)


def host_rows(mesh, worker_id: int, local_devices: int):
    """(index, count): this rank's place among the distinct batch
    coordinates of its host's ranks, which split the host's rows."""
    from dcos_commons_tpu_torch.parallel.mesh import BATCH_AXES, Mesh

    first = worker_id * local_devices
    coords = sorted({Mesh(mesh.spec, r).index(BATCH_AXES)
                     for r in range(first, first + local_devices)})
    return coords.index(mesh.index(BATCH_AXES)), len(coords)


def train(env: Mapping[str, str],
          log: Callable[[str], None] = print,
          no_remat_layers: int = 0,
          local_rank: int = 0,
          local_devices: int = 1,
          init_method: Optional[str] = None,
          timeout_s: float = 300) -> TrainResult:
    """Train ``TRAIN_STEPS`` steps from the latest checkpoint in
    ``CHECKPOINT_DIR`` (or from scratch), as the JAX worker does, as
    rank ``local_rank`` of the worker's ``local_devices``.
    ``no_remat_layers`` stores the last k layers' activations, as
    bench.py's flagship config does with 1; the worker's ``main`` keeps
    the JAX worker's 0 (every layer rematerialised).  ``init_method``
    overrides the rendezvous at the coordinator address, ``timeout_s``
    bounds the process group's waits."""
    import torch

    from dcos_commons_tpu_torch.data import (
        DevicePrefetcher,
        TokenDataset,
        rank_rows,
    )
    from dcos_commons_tpu_torch.device import resolve_device
    from dcos_commons_tpu_torch.ops import kernel_launches
    from dcos_commons_tpu_torch.models.transformer import (
        adamw,
        config_from_env,
        init_params,
        leaf_rules,
        load_train_state,
        make_train_step,
        shard_params,
        train_state,
    )
    from dcos_commons_tpu_torch.parallel.distributed import (
        barrier,
        broadcast_int,
        contract_from_env,
        gang_rank,
        gather_ints,
        initialize_from_env,
    )
    from dcos_commons_tpu_torch.parallel.mesh import (
        BATCH_AXES,
        derive,
        elastic_reshard_ok,
        mesh_from_env,
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

    launched = kernel_launches()
    kind = env.get("TORCH_DEVICE") or "cuda"
    device = resolve_device(f"cuda:{local_rank}" if kind == "cuda" else kind)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    contract = contract_from_env(env)
    rank = gang_rank(contract, local_rank, local_devices)[0]
    # the gang's size comes from the contract alone, the same on every
    # rank: the branches on it below are gang-uniform
    world = contract["worker_count"] * local_devices
    if local_rank != 0:
        log = lambda msg: None  # noqa: E731 — a worker logs once
    initialize_from_env(env, "nccl" if device.type == "cuda" else "gloo",
                        local_rank, local_devices, timeout_s, init_method)
    if contract["num_slices"] > 1:
        # the slice identity an operator needs when reading one
        # sandbox's log against a whole-gang timeline
        log(f"multi-slice gang: slice {contract['slice_index']}/"
            f"{contract['num_slices']} ({contract['hosts_per_slice']} "
            f"host(s)/slice), slice anchor "
            f"{contract['slice_coordinator'] or 'n/a'}")
    steps = int(env.get("TRAIN_STEPS", "100"))
    ckpt_dir = env.get("CHECKPOINT_DIR", "checkpoints")
    # per-step telemetry into $SANDBOX/steplog.jsonl, read by the
    # scheduler's /v1/debug/trace; the barrier probe meets the gang
    # before each step's first collective, and its wait on the fast
    # ranks IS the skew the slow one imposed (STEPLOG_BARRIER_PROBE=0
    # drops it)
    steplog = StepLog(os.path.join(env.get("SANDBOX", "."), STEPLOG_NAME))
    probe_gang = env.get("STEPLOG_BARRIER_PROBE", "1") not in ("0", "false")
    mesh = mesh_from_env(env, n_devices=world)
    if env.get("TPU_TOPOLOGY"):
        # elastic-DP resume guard: when the devices actually present
        # disagree with the DECLARED topology (a resized relaunch),
        # proceeding is only safe if the change is a pure batch-axis
        # (dp/dcn) re-layout — params and optimizer state replicate over
        # those axes, so the checkpoint restores bit-identically onto
        # the new mesh.  A model-axis change (tp/fsdp/...) would silently
        # train a different parallelism: refuse loudly.
        declared = derive(env)
        actual = derive(env, n_devices=world)
        if actual != declared:
            elastic = env.get("TRAIN_ELASTIC_DP", "0") not in ("0", "false")
            if not elastic or not elastic_reshard_ok(declared, actual):
                raise RuntimeError(
                    f"mesh mismatch: declared topology derives {declared} "
                    f"but {world} device(s) derive {actual}; only a dp/dcn "
                    "change is elastically resumable (set "
                    "TRAIN_ELASTIC_DP=1 to allow it)"
                )
            log(f"elastic-dp resume: {declared.total} -> {actual.total} "
                f"chips (dp {declared.dp}->{actual.dp}, dcn "
                f"{declared.dcn}->{actual.dcn}); checkpoint reshards as a "
                "pure re-layout")
    config = config_from_env(env, dtype=torch.bfloat16,
                             no_remat_layers=no_remat_layers)
    params = shard_params(init_params(config, seed=0, device=device),
                          config, mesh)
    optimizer = adamw(params, 3e-4)
    rules = leaf_rules(config, train_state=True)
    # the checkpoint carries params AND optimizer moments; its stamp is
    # the next step to run, so resume never double-applies a step
    state, start = restore_checkpoint(
        ckpt_dir, train_state(params, optimizer), mesh=mesh, rules=rules)
    if start is not None:
        load_train_state(params, optimizer, state)
        log(f"restored checkpoint step {start}")
    start = start or 0
    del state
    if world > 1:
        # the stamp came off each rank's own view of the directory: a
        # gang that disagreed on the trip count would deadlock in the
        # shorter rank's last collective.  Agree up front and fail
        # loudly on divergence: recovery relaunches the gang.
        starts = gather_ints(start, mesh)
        if min(starts) != max(starts):
            raise RuntimeError(
                "checkpoint step diverges across the gang: "
                f"{sorted(starts)}; wipe the stale sandboxes or restore a "
                "shared CHECKPOINT_DIR"
            )
        start = starts[0]
    grad_accum = max(1, int(env.get("TRAIN_GRAD_ACCUM", "1")))
    # in-flight window: dispatch step N, wait on step N-k's loss.
    # 0 = synchronous (wait every step)
    inflight = max(0, int(env.get("TRAIN_INFLIGHT_STEPS", "2")))
    step_fn = make_train_step(config, optimizer, mesh=mesh,
                              grad_accum=grad_accum)
    batch = max(2, 2 * world)
    # each rank splits its own rows into the microbatches, so the
    # batch must split evenly over the batch shards AND then into
    # grad_accum (the JAX worker's lcm(grad_accum, shards) admits a
    # batch GSPMD splits unevenly, which a rank's rows cannot)
    shards = mesh.size(BATCH_AXES)
    multiple = grad_accum * shards
    if batch % multiple:
        batch += multiple - batch % multiple
    index, rows = mesh.index(BATCH_AXES), batch // shards
    data_dir = env.get("DATA_DIR", "")
    batches = None
    if data_dir:
        # real corpus: memory-mapped token shards round-robin over the
        # workers (disjoint per worker), each host's share of the global
        # batch split over its ranks, prefetched onto the card; the
        # stream is a pure function of (seed, step), so checkpoint
        # resume continues EXACTLY where the last run left
        dataset = TokenDataset(
            data_dir, config.max_seq,
            worker_id=contract["worker_id"],
            worker_count=contract["worker_count"],
        )
        local_rows = max(1, batch // contract["worker_count"])
        batches = DevicePrefetcher(
            rank_rows(dataset.batches(local_rows, start_step=start),
                      *host_rows(mesh, contract["worker_id"],
                                 local_devices)),
            device, depth=2,
        )
        log(f"data: {dataset.n_sequences} sequences for worker "
            f"{contract['worker_id']}")
    else:
        tokens, targets = synthetic_tokens(
            batch, config.max_seq, config.vocab,
            torch.Generator(device=device).manual_seed(1),
        )
        tokens = tokens[index * rows:(index + 1) * rows]
        targets = targets[index * rows:(index + 1) * rows]
    gang = world > 1
    # non-blocking checkpointing: save() costs the loop a gather (in a
    # gang) and a device-side clone; the host copy + npz write + fenced
    # prune run on rank 0's background thread.  The writer incarnation
    # fences a zombie trainer out of a relaunched gang's
    # CHECKPOINT_DIR: rank 0 claims it (the only writer) and the gang
    # agrees on it, so nothing downstream can branch on a local value.
    keep = int(env.get("CHECKPOINT_KEEP", "3"))
    async_ckpt = env.get("TRAIN_ASYNC_CKPT", "1") not in ("0", "false")
    if gang:
        incarnation = broadcast_int(
            claim_incarnation(ckpt_dir) if rank == 0 else 0, mesh)
    else:
        incarnation = claim_incarnation(ckpt_dir)
    checkpointer = (
        AsyncCheckpointer(ckpt_dir, keep=keep, incarnation=incarnation,
                          mesh=mesh, rules=rules)
        if async_ckpt else None
    )
    # the bounded in-flight window bills wall_s/blocked_s to the step
    # that incurred them although the host runs k steps ahead of the
    # card
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
        blocked_s = 0.0
        if gang and probe_gang:
            b0 = time.time()
            barrier(mesh)
            blocked_s = time.time() - b0
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
                                incarnation=incarnation, mesh=mesh,
                                rules=rules)
        note_drained(window.push(
            i, loss, step_t0, blocked_s=blocked_s,
            tokens=batch * config.max_seq, worker=contract["worker_id"],
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
    if world > 1:
        torch.distributed.destroy_process_group()
    launched = {k: n - launched[k] for k, n in kernel_launches().items()}
    return TrainResult(start=start, steps=steps, batch=batch, seconds=dt,
                       tokens_per_s=tps, params=params, losses=losses,
                       checkpoint_errors=errors, launches=[launched])


def _rank_entry(env, local_rank, local_devices, init_method, timeout_s,
                results):
    """One spawned rank: ``train``, its result (without the params) or
    its error on ``results``."""
    try:
        if (env.get("TORCH_DEVICE") or "cuda") == "cpu":
            import torch

            torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                      // local_devices))
        result = train(env, log=lambda msg: print(msg, flush=True),
                       local_rank=local_rank, local_devices=local_devices,
                       init_method=init_method, timeout_s=timeout_s)
        results.put((local_rank, replace(result, params=None), None))
    except BaseException:  # noqa: BLE001 — reported to the launcher
        results.put((local_rank, None, traceback.format_exc()))
        raise


def train_gang(env: Mapping[str, str], local_devices: int,
               log: Callable[[str], None] = print,
               timeout_s: float = 300,
               deadline_s: Optional[float] = None) -> TrainResult:
    """Run this worker's ``local_devices`` ranks of ``train``: in this
    process for one, else one spawned process each, and wait for them.
    A lone worker's ranks meet at a file store in a directory of their
    own; a gang's at ``COORDINATOR_ADDRESS``.  Returns local rank 0's
    result (``params`` None when spawned) with every local rank's
    ``launches``; raises with the first
    failing rank's traceback, or when ``deadline_s`` passes (every rank
    is stopped first).  Its last log line is ``kernel launches {...}``:
    the worker id, each local rank's K1-K4 launches and, on the card,
    the UUIDs of the cards the ranks ran on (one a rank, in order), for
    whoever reads the worker's log (an agent's sandbox)."""
    if local_devices == 1:
        result = train(env, log=log, timeout_s=timeout_s)
        _log_launches(env, result, log)
        return result
    import multiprocessing

    env = dict(env)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="rendezvous-") as meet:
        init_method = None
        if int(env.get("TPU_WORKER_COUNT", "1") or 1) == 1:
            init_method = "file://" + os.path.join(meet, "store")
        procs = [ctx.Process(
            target=_rank_entry,
            args=(env, r, local_devices, init_method, timeout_s, results))
            for r in range(local_devices)]
        for p in procs:
            p.start()
        end = None if deadline_s is None else time.monotonic() + deadline_s
        got: Dict[int, Any] = {}
        try:
            while len(got) < local_devices:
                if end is not None and time.monotonic() > end:
                    raise TimeoutError(
                        f"{local_devices - len(got)} rank(s) still running "
                        f"after {deadline_s} s")
                try:
                    r, result, error = results.get(timeout=1)
                except queue.Empty:
                    codes = [p.exitcode for p in procs]
                    if any(c not in (None, 0) for c in codes):
                        raise RuntimeError(f"a rank exited with no result: "
                                           f"exit codes {codes}")
                    continue
                if error is not None:
                    raise RuntimeError(f"local rank {r} failed:\n{error}")
                got[r] = result
        finally:
            done = len(got) == local_devices
            for p in procs:
                p.join(timeout=30 if done else 0)
                if p.is_alive():
                    p.kill()
                    p.join()
    log(f"worker {env.get('TPU_WORKER_ID', '0')}: {local_devices} ranks "
        "done")
    result = replace(got[0], launches=[got[r].launches[0]
                                       for r in range(local_devices)])
    _log_launches(env, result, log)
    return result


def _log_launches(env: Mapping[str, str], result: TrainResult,
                  log: Callable[[str], None]) -> None:
    import torch

    cards = []
    if (env.get("TORCH_DEVICE") or "cuda") == "cuda":
        cards = [str(torch.cuda.get_device_properties(i).uuid)
                 for i in range(len(result.launches))]
    log("kernel launches " + json.dumps({
        "worker": int(env.get("TPU_WORKER_ID", "0") or 0),
        "launches": result.launches, "cards": cards}))


def main() -> int:
    import torch

    kind = os.environ.get("TORCH_DEVICE") or "cuda"
    # one rank a card the host really has
    local_devices = (torch.cuda.device_count()
                     if kind == "cuda" and torch.cuda.is_available() else 1)
    train_gang(os.environ, max(1, local_devices),
               log=lambda msg: print(msg, flush=True))
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

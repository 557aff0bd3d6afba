"""Training data pipeline: sharded token files -> the card (port of
``dcos_commons_tpu/data/loader.py``).

A training framework needs tokens flowing onto the card without the
train step ever waiting on the host.  Design:

* **Shard files** are raw little-endian int32 token streams
  (``<name>.tokens``), memory-mapped (np.memmap) — no parse step, the
  OS page cache is the read buffer, and a 100GB corpus costs no RSS.
* **Deterministic host sharding**: shard FILES distribute round-robin
  over (worker_id, worker_count) — the scheduler's gang env contract —
  so multi-host pods read disjoint data with no coordination, and a
  PERMANENT replacement re-reads exactly its predecessor's shards.
* **Stateless addressing**: batch ``i`` of epoch ``e`` is a pure
  function of (seed, e, i) — resume from a checkpoint step means
  seeking, not replaying; no loader state needs checkpointing beyond
  the step counter the trainer already saves.
* **Device prefetch**: a background thread stages the NEXT batches to
  the named device while the current step computes — the standard
  double-buffer recipe; depth 2 hides the host copy and the PCIe
  transfer under the step.  On the card each batch goes through pinned
  host memory with a non-blocking copy on a side stream; the consumer's
  stream waits on that copy's event before it uses the batch.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

TOKEN_DTYPE = np.int32
SUFFIX = ".tokens"


def write_token_shard(path: str, tokens) -> None:
    """Write one shard file (tooling/test helper)."""
    arr = np.asarray(tokens, TOKEN_DTYPE)
    with open(path, "wb") as f:
        f.write(arr.tobytes())


def list_shards(data_dir: str) -> List[str]:
    return sorted(
        os.path.join(data_dir, name)
        for name in os.listdir(data_dir)
        if name.endswith(SUFFIX)
    )


class TokenDataset:
    """Memory-mapped view over this worker's shard files.

    ``worker_id``/``worker_count`` follow the scheduler's gang env
    contract; shard files round-robin over workers.  Sequences of
    ``seq_len + 1`` tokens are cut from each shard (input/target
    overlap by one), addressed deterministically by (seed, epoch, i).
    """

    def __init__(
        self,
        data_dir: str,
        seq_len: int,
        worker_id: int = 0,
        worker_count: int = 1,
        seed: int = 0,
    ):
        if worker_count < 1 or not (0 <= worker_id < worker_count):
            raise ValueError(f"bad worker {worker_id}/{worker_count}")
        shards = list_shards(data_dir)
        if not shards:
            raise FileNotFoundError(f"no *{SUFFIX} shards in {data_dir}")
        mine = shards[worker_id::worker_count]
        if not mine:
            raise ValueError(
                f"{len(shards)} shard(s) cannot feed worker "
                f"{worker_id}/{worker_count}; add shards or shrink the gang"
            )
        self.seq_len = seq_len
        self.seed = seed
        self._maps = [
            np.memmap(path, TOKEN_DTYPE, mode="r") for path in mine
        ]
        window = seq_len + 1
        self._per_shard = [len(m) // window for m in self._maps]
        self.n_sequences = sum(self._per_shard)
        if self.n_sequences == 0:
            raise ValueError(
                f"shards shorter than seq_len+1={window}: {mine}"
            )
        # flat index -> (shard, within-shard offset), built once
        self._shard_of = np.repeat(
            np.arange(len(self._maps)), self._per_shard
        )
        self._base = np.concatenate([
            np.arange(n) for n in self._per_shard
        ])

    def sequence(self, index: int) -> np.ndarray:
        """The index-th (seq_len + 1)-token window."""
        index = int(index) % self.n_sequences
        shard = int(self._shard_of[index])
        offset = int(self._base[index]) * (self.seq_len + 1)
        return np.asarray(
            self._maps[shard][offset: offset + self.seq_len + 1]
        )

    def _order(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, epoch))
        return rng.permutation(self.n_sequences)

    def batches(
        self, batch_size: int, start_step: int = 0
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Infinite (tokens, targets) [batch, seq_len] stream.

        Deterministic in (seed, start_step): resuming from a trainer
        checkpoint at step N means ``batches(b, start_step=N)`` — the
        stream continues exactly where the dead incarnation left off,
        reshuffling per epoch.
        """
        per_epoch = max(self.n_sequences // batch_size, 1)
        step = start_step
        # the O(n) epoch permutation is computed once PER EPOCH, not
        # per batch — at corpus scale a per-step reshuffle would
        # dominate the memmap reads and defeat the prefetch buffer
        order_epoch, order = -1, None
        while True:
            epoch, within = divmod(step, per_epoch)
            if epoch != order_epoch:
                order_epoch, order = epoch, self._order(epoch)
            rows = [
                self.sequence(order[(within * batch_size + j)
                                    % self.n_sequences])
                for j in range(batch_size)
            ]
            block = np.stack(rows)
            yield block[:, :-1].copy(), block[:, 1:].copy()
            step += 1


def rank_rows(it, index: int, count: int):
    """A rank's share of each host batch of ``it``: rows ``[index * n /
    count, (index + 1) * n / count)`` of its n.  In a gang each host
    reads ``batch / worker_count`` rows (``TokenDataset``'s shards are
    the host's), and its ranks split them by their place among the
    host's batch coordinates: what the JAX module's sharded placement
    puts on each device of the host."""
    for host_batch in it:
        n = len(host_batch[0])
        if n % count:
            raise ValueError(f"{n} rows do not split over {count} ranks")
        lo, hi = index * n // count, (index + 1) * n // count
        yield tuple(a[lo:hi] for a in host_batch)


class DevicePrefetcher:
    """Double-buffer host batches onto ``device``.

    Wraps any (tokens, targets) numpy iterator; a daemon thread stays
    ``depth`` batches ahead so the train step never waits on host IO.
    Batches arrive as int64 tensors on ``device`` (the port's indexing
    dtype).  In a gang, wrap the host stream in ``rank_rows`` first:
    each rank places only its own rows.
    """

    def __init__(self, it, device, depth: int = 2):
        self._device = torch.device(device)
        self._stream = (
            torch.cuda.Stream(self._device)
            if self._device.type == "cuda" else None
        )
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()

        def put_or_stop(item) -> None:
            # every enqueue respects close(): an unbounded put would
            # leave the pump thread (and its staged device batches)
            # blocked forever when the consumer stops early
            while not self._stop.is_set():
                try:
                    self._queue.put(item, timeout=0.2)
                    return
                except queue.Full:
                    continue

        def pump():
            try:
                for host_batch in it:
                    put_or_stop(self._place(host_batch))
                    if self._stop.is_set():
                        return
                # normal exhaustion (finite eval sets): the sentinel
                # with no error becomes StopIteration, not a deadlock
                put_or_stop(None)
            except BaseException as e:  # surfaced on next __next__
                self._error = e
                put_or_stop(None)

        self._thread = threading.Thread(
            target=pump, name="data-prefetch", daemon=True
        )
        self._thread.start()

    def _place(self, host_batch):
        """(tensors on the device, the event behind their copies or
        None off the card)."""
        hosts = [torch.from_numpy(np.asarray(a, np.int64))
                 for a in host_batch]
        if self._stream is None:
            return tuple(t.to(self._device) for t in hosts), None
        with torch.cuda.stream(self._stream):
            placed = tuple(
                t.pin_memory().to(self._device, non_blocking=True)
                for t in hosts
            )
            event = torch.cuda.Event()
            event.record(self._stream)
        return placed, event

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            # after exhaustion/error/close: keep raising (iterator
            # protocol) instead of blocking on an empty queue forever
            raise (self._error or StopIteration)
        item = self._queue.get()
        if item is None:
            self.close()
            raise (self._error or StopIteration)
        placed, event = item
        if event is not None:
            current = torch.cuda.current_stream(self._device)
            current.wait_event(event)
            for t in placed:
                # the side stream's allocation is used on this stream
                t.record_stream(current)
        return placed

    def close(self) -> None:
        self._stop.set()

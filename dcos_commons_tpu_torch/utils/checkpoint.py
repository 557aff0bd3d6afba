"""Workload checkpointing: npz with dtype-safe leaves (port of
``dcos_commons_tpu/utils/checkpoint.py``).

The control plane WALs its own state (SURVEY.md section 5.4); workload
checkpointing is the service's job, and this is the pattern library:
PERMANENT gang recovery = re-place the sub-slice, restore the latest
step here, resume.

Leaves that numpy cannot round-trip (bfloat16) are stored as float32
with the original dtype recorded.  The step stamp is "next step to
run", so resume never double-applies an update.

The file format is the JAX package's, leaf for leaf: leaves are keyed
``leaf_<i>`` by their index in ``utils.tree.tree_flatten``, which orders
them as ``jax.tree.flatten`` does (sorted dict keys).  So a checkpoint
written by the JAX train worker restores into the port bit for bit,
and the reverse holds too (the train state's layout is
``models.transformer.adamw_state``'s).

A gang (``mesh=`` and each leaf's rule, ``rules=``) saves as the JAX
module's multi-host save does: every rank calls, each leaf is gathered
to its full size (a collective, in program order with the step's), and
only rank 0 writes, in the same file format, so a gang's checkpoint
restores in the single-device port and in the JAX package bit for bit.
A gang restore reads the full leaves and keeps each rank's block.

Writer-incarnation fencing (ADVICE round 5): recovery can relaunch a
trainer while its superseded predecessor still has one save in
flight, and two misconfigured jobs can share a CHECKPOINT_DIR.  The
old "the caller that just saved step N owns the frontier" rule let
exactly those zombies destroy the genuine latest checkpoints.  A
fenced writer claims a monotonically increasing incarnation token
(:func:`claim_incarnation`, an O_EXCL marker file so concurrent
claimers can never share one) and records it IN the checkpoint name;
save and prune then refuse to cross a NEWER incarnation's frontier —
a stale writer can only prune its own past (and its predecessors'),
never the live writer's future.

:class:`AsyncCheckpointer` is the non-blocking path: ``save()``
snapshots the tree with a device-side clone enqueued on the current
stream (safe against the train step's in-place update, which the same
stream runs after it) and hands it to one background writer thread,
so the step loop never waits on the device-to-host copy or file IO.
"""

from __future__ import annotations

import json
import os
import queue
import re
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from dcos_commons_tpu_torch.parallel.distributed import broadcast_int
from dcos_commons_tpu_torch.parallel.mesh import Mesh
from dcos_commons_tpu_torch.parallel.sharding import Dims, shard, unshard
from dcos_commons_tpu_torch.utils.tree import tree_flatten, tree_unflatten

# legacy names (step_<digits>.npz) parse as incarnation 0: every
# fenced writer's past, prunable by any of them
_STEP_RE = re.compile(r"^step_(\d+)(?:\.inc_(\d+))?\.npz$")
_INC_RE = re.compile(r"^writer_(\d+)\.inc$")


class StaleWriterError(RuntimeError):
    """A writer tried to save or prune across a NEWER incarnation's
    frontier: it has been superseded (recovery relaunched the trainer,
    or another job owns the directory) and must stop writing."""


def _step_files(directory: str) -> List[Tuple[int, int, str]]:
    """[(step, incarnation, filename)] sorted by (step, incarnation).
    Only exact step_<digits>[.inc_<digits>].npz names count — a stray
    operator file (step_best.npz, a .tmp) must never crash
    saves/restores or be pruned."""
    out = []
    for name in os.listdir(directory):
        m = _STEP_RE.match(name)
        if m:
            out.append((int(m.group(1)), int(m.group(2) or 0), name))
    return sorted(out)


def _max_incarnation(directory: str) -> int:
    """Highest incarnation visible in ``directory``: claimed marker
    files AND checkpoint names (a marker could be lost to a partial
    directory copy; the checkpoints themselves still fence)."""
    top = 0
    if os.path.isdir(directory):
        for name in os.listdir(directory):
            m = _INC_RE.match(name)
            if m:
                top = max(top, int(m.group(1)))
        for _step, inc, _name in _step_files(directory):
            top = max(top, inc)
    return top


def claim_incarnation(directory: str) -> int:
    """Durably claim the next writer incarnation for ``directory``.

    The claim is an O_EXCL-created ``writer_<n>.inc`` marker, so two
    trainers racing a recovery relaunch can never share a token; the
    loser retries above the winner.
    """
    os.makedirs(directory, exist_ok=True)
    n = _max_incarnation(directory) + 1
    while True:
        try:
            fd = os.open(
                os.path.join(directory, f"writer_{n:010d}.inc"),
                os.O_CREAT | os.O_EXCL | os.O_WRONLY,
            )
            os.close(fd)
            return n
        except FileExistsError:
            n += 1


def _host_array(leaf: Any) -> Tuple[np.ndarray, Optional[str]]:
    """A leaf as a numpy array numpy can store, and the dtype name to
    record when it had to be widened (bfloat16 -> float32)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.float().numpy(), "bfloat16"
        return t.numpy(), None
    arr = np.asarray(leaf)
    if arr.dtype.kind not in "fiub":
        return arr.astype(np.float32), arr.dtype.name
    return arr, None


def _gathered(leaves: List[Any], mesh: Optional[Mesh],
              rules: Optional[List[Dims]]) -> List[Any]:
    """Each tensor leaf at its full size, a copy of its own (collective
    under a mesh: every rank calls, in leaf order)."""
    out = []
    for i, leaf in enumerate(leaves):
        if not isinstance(leaf, torch.Tensor):
            out.append(np.copy(np.asarray(leaf)))
            continue
        if mesh is not None and rules is not None:
            out.append(unshard(leaf, rules[i], mesh))
        else:
            out.append(leaf.detach().clone())
    return out


def save_checkpoint(
    directory: str, step: int, tree: Any, keep: int = 0,
    incarnation: Optional[int] = None, mesh: Optional[Mesh] = None,
    rules: Optional[List[Dims]] = None,
) -> str:
    """Atomic save of a pytree; ``step`` = next step to run on resume.

    In a gang (``mesh``, with ``rules`` giving each leaf's layout in
    ``tree_flatten`` order) every rank calls: each leaf is gathered to
    its full size, and only rank 0 writes (the others return "").

    ``keep`` > 0 prunes AFTER the new file is durably in place (write
    + fsync + rename first, delete after — a crash mid-save can
    orphan an extra file but never leaves fewer than ``keep``
    restorable steps).  Two kinds of files go: steps older than the
    newest ``keep`` at-or-below the one just saved (a long run would
    otherwise grow the directory by ~3 bytes/param per save until the
    disk fills), and steps newer than the one just saved — an
    abandoned future (operator rolled back and retrained) that would
    otherwise poison the default latest-step resume.  ``keep=0``
    prunes nothing.

    ``incarnation`` (from :func:`claim_incarnation`) fences both
    decisions: the token is recorded in the checkpoint name, saving
    raises :class:`StaleWriterError` when the directory already holds
    a NEWER incarnation's checkpoint, and pruning only ever touches
    files at-or-below this writer's incarnation — "the caller is
    authoritative about the frontier" was exactly wrong for a zombie
    writer flushing one last save after recovery relaunched a newer
    trainer (ADVICE round 5).  ``incarnation=None`` keeps the legacy
    unfenced behavior for single-writer tools.
    """
    leaves, _ = tree_flatten(tree)
    if mesh is not None:
        leaves = _gathered(leaves, mesh, rules)
        if mesh.rank != 0:
            return ""
    arrays = {}
    dtypes = {}
    for i, leaf in enumerate(leaves):
        # numpy's npz cannot hold bfloat16: widen to f32 and remember
        arr, widened_from = _host_array(leaf)
        if widened_from is not None:
            dtypes[str(i)] = widened_from
        arrays[f"leaf_{i}"] = arr

    os.makedirs(directory, exist_ok=True)
    if incarnation is not None and _max_incarnation(directory) > incarnation:
        # a newer writer owns this directory: the zombie must neither
        # overwrite the live frontier nor (below) prune it
        raise StaleWriterError(
            f"writer incarnation {incarnation} superseded by "
            f"{_max_incarnation(directory)} in {directory}; refusing "
            "to save — recovery relaunched a newer trainer"
        )
    suffix = (
        "" if incarnation is None else f".inc_{incarnation:010d}"
    )
    path = os.path.join(directory, f"step_{step:010d}{suffix}.npz")
    tmp = path + ".tmp"
    meta = json.dumps({
        "dtypes": dtypes, "step": step,
        "incarnation": incarnation or 0,
    }).encode()
    with open(tmp, "wb") as f:
        np.savez(f, __meta__=np.frombuffer(meta, dtype=np.uint8), **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    if keep > 0:
        # prune by the LISTED names (not reconstructed ones): a
        # hand-named step_5.npz must actually be removed, and a
        # non-matching stray file must never crash the save.  The
        # just-saved step anchors the frontier: retention counts the
        # newest `keep` AT OR BELOW it (so this call's own file is
        # never deleted — review r5), and anything ABOVE it is an
        # abandoned future from a rollback, pruned so the default
        # latest-step resume cannot restore the state the rollback
        # was meant to undo (review r5, follow-up).  Fencing: only
        # files from THIS incarnation or older are candidates — a
        # newer writer's files are the live frontier, not our
        # abandoned future (unreachable when the save-fence above
        # raised, load-bearing when the newer file landed between
        # that check and this scan).
        mine = incarnation if incarnation is not None else float("inf")
        files = [
            (s, i, n) for s, i, n in _step_files(directory) if i <= mine
        ]
        older = [(s, n) for s, i, n in files if s <= step]
        stale_future = [(s, n) for s, i, n in files if s > step]
        for _s, name in older[:-keep] + stale_future:
            try:
                os.remove(os.path.join(directory, name))
            except OSError:
                pass  # already gone (concurrent pruner) — harmless
    return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    files = _step_files(directory)
    return files[-1][0] if files else None


class Skip:
    """A leaf of a restore template that is not read: ``restore_checkpoint``
    returns it as it is.  It still takes its flatten index, so the
    leaves after it keep their true offsets in the file."""

    def __repr__(self) -> str:
        return "Skip()"


SKIP = Skip()


def restore_checkpoint(
    directory: str, like: Any, step: Optional[int] = None,
    mesh: Optional[Mesh] = None, rules: Optional[List[Dims]] = None,
) -> Tuple[Any, Optional[int]]:
    """Restore into the structure of ``like``; returns (tree, step) or
    (like, None) when no checkpoint exists.  Each tensor leaf comes
    back with ``like``'s dtype and device (a recorded bfloat16 is read
    from its exact f32 widening) and must have ``like``'s shape; a
    ``SKIP`` leaf is not read.  In a gang (``mesh`` and ``rules`` as
    in ``save_checkpoint``) ``like`` holds this rank's blocks, and each
    full leaf of the file is cut to this rank's block."""
    files = _step_files(directory) if os.path.isdir(directory) else []
    target = step if step is not None else (
        files[-1][0] if files else None
    )
    if target is None:
        return like, None
    # open the LISTED filename for the step: a hand-named step_5.npz
    # (unpadded) must restore, not 404 on a reconstructed name.  With
    # same-step files from several incarnations, the NEWEST
    # incarnation's wins (the sort is (step, incarnation)).
    names = [name for s, _inc, name in files if s == target]
    if not names:
        # an EXPLICITLY requested step that is absent is an error,
        # not a silent fresh-start (step is not None here: the
        # latest-step path only yields steps that exist)
        raise FileNotFoundError(
            f"no checkpoint for step {step} in {directory}"
        )
    path = os.path.join(directory, names[-1])
    leaves, structure = tree_flatten(like)
    restored = []
    with np.load(path) as data:
        n_file = sum(1 for key in data.files if key.startswith("leaf_"))
        if n_file != len(leaves):
            raise ValueError(
                f"{path} holds {n_file} leaves, the template {len(leaves)}"
            )
        for i, leaf in enumerate(leaves):
            if isinstance(leaf, Skip):
                restored.append(leaf)
                continue
            arr = data[f"leaf_{i}"]
            if mesh is not None and rules is not None:
                arr = shard(arr, rules[i], mesh)
            if isinstance(leaf, torch.Tensor):
                if tuple(arr.shape) != tuple(leaf.shape):
                    raise ValueError(
                        f"{path} leaf_{i} has shape {arr.shape}, the "
                        f"template {tuple(leaf.shape)}"
                    )
                restored.append(torch.from_numpy(arr).to(
                    device=leaf.device, dtype=leaf.dtype
                ))
            else:
                restored.append(arr)
    return tree_unflatten(structure, restored), target


def _snapshot_tree(tree: Any, mesh: Optional[Mesh] = None,
                   rules: Optional[List[Dims]] = None
                   ) -> Tuple[Any, Optional[torch.cuda.Event]]:
    """Device-side copy of a tree of tensors, enqueued on the current
    stream, and an event recorded behind the copies (None off the
    card).  Under a mesh each leaf is gathered to its full size first.

    The train step updates params and optimizer state IN PLACE on the
    same stream, after this copy: the clones hold the values of the
    save.  The writer thread waits on the event before it reads the
    clones, whatever stream it runs on."""
    leaves, structure = tree_flatten(tree)
    clones = _gathered(leaves, mesh, rules)
    event = None
    if any(isinstance(c, torch.Tensor) and c.is_cuda for c in clones):
        event = torch.cuda.Event()
        event.record()
    return tree_unflatten(structure, clones), event


class AsyncCheckpointer:
    """Non-blocking, incarnation-fenced checkpoint writer.

    ``save(step, tree)`` costs the step loop only a device-side clone
    per leaf, enqueued on the current stream; one background thread
    then copies to host and runs :func:`save_checkpoint` (write + fsync
    + rename + fenced prune) off the hot path.  The queue is BOUNDED:
    saving faster than the disk drains backpressures ``save()`` instead
    of hoarding device-memory snapshots.

    Fencing: the writer claims an incarnation up front (or is handed
    one).  The first save that hits a newer incarnation's frontier
    marks the checkpointer ``fenced`` and every later save drops
    immediately — a zombie trainer must stop fighting the live writer,
    not retry.  Write failures land in ``errors`` (telemetry-grade:
    training continues; the operator reads the list via ``wait()``).

    A gang (``mesh``, ``rules``) follows ``save_checkpoint``: every rank
    calls ``save()`` in the same order, the gather runs there, on the
    caller's thread (a collective from the writer thread would race the
    step's collectives), and only rank 0 enqueues a write.  Only rank 0
    sees the directory, so it alone can latch the fence: its latch is
    broadcast at each save and every rank skips the same saves (a skip
    on rank 0 alone would leave the others in the gather).  Rank 0
    claims the incarnation when none is handed in.
    """

    def __init__(
        self, directory: str, keep: int = 0,
        incarnation: Optional[int] = None, max_pending: int = 2,
        mesh: Optional[Mesh] = None, rules: Optional[List[Dims]] = None,
    ):
        self.directory = directory
        self.keep = keep
        self.mesh, self.rules = mesh, rules
        if incarnation is None and (mesh is None or mesh.rank == 0):
            incarnation = claim_incarnation(directory)
        self.incarnation = incarnation
        self.errors: List[str] = []
        self.saved: List[str] = []
        # latched False -> True by the writer thread (a stale save) or
        # by the caller (the gang's broadcast fence); both writes hold
        # the lock, the caller reads it without one
        self.fenced = False
        self._fence_lock = threading.Lock()
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(1, max_pending))
        self._thread = threading.Thread(
            target=self._drain, name="async-ckpt", daemon=True
        )
        self._thread.start()

    def save(self, step: int, tree: Any) -> None:
        """Snapshot ``tree`` (device-side clone) and enqueue the write;
        returns as soon as the copies are ENQUEUED."""
        if self.mesh is not None and self.mesh.spec.total > 1:
            if broadcast_int(int(self.fenced), self.mesh):
                with self._fence_lock:
                    self.fenced = True
                return
        elif self.fenced:
            return
        snapshot = _snapshot_tree(tree, self.mesh, self.rules)
        if self.mesh is not None and self.mesh.rank != 0:
            return
        self._queue.put((step, *snapshot))

    def _drain(self) -> None:
        while True:
            item = self._queue.get()
            try:
                if item is None:
                    return
                step, snapshot, event = item
                try:
                    if event is not None:
                        event.synchronize()
                    self.saved.append(save_checkpoint(
                        self.directory, step, snapshot, keep=self.keep,
                        incarnation=self.incarnation,
                    ))
                except StaleWriterError as e:
                    with self._fence_lock:
                        self.fenced = True
                    self.errors.append(str(e))
                except Exception as e:  # noqa: BLE001 — a failed save
                    # (full disk, NFS hiccup) must not kill the writer
                    # thread: later saves may land, and the step loop
                    # reads the failure from .errors
                    self.errors.append(repr(e))
            finally:
                self._queue.task_done()

    def wait(self) -> List[str]:
        """Block until every enqueued save is durable (or failed);
        returns accumulated error strings."""
        self._queue.join()
        return list(self.errors)

    def close(self) -> List[str]:
        """Drain pending saves, stop the writer thread, return errors."""
        self._queue.put(None)
        self._thread.join()
        return list(self.errors)

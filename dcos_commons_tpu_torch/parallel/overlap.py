"""Collective/compute overlap of the sharded train step (port of
``dcos_commons_tpu/parallel/overlap.py``).

The reference prepends XLA's latency-hiding flags to ``XLA_FLAGS``, so
the compiler floats the grad reduce-scatters, the fsdp all-gathers and
the ring's ``ppermute`` alongside compute.  Eager PyTorch has no
scheduler to ask: ``make_train_step(..., overlap=True)`` overlaps each
of those collectives by hand, with every mechanism a mesh whose data
axes hold more than one rank makes a collective for (``applicable``):

- ``grad_reduce``: each gradient is reduced as soon as the backward has
  made it.  Every leaf of the step is split into per-layer leaves (rows
  of the stacked ``[n_layers, ...]`` leaves), whose hooks put each
  gradient into a bucket (``GradReducer``); a bucket is launched
  (``async_op=True``) when its layer's gradients are all in or it holds
  ``BUCKET_BYTES``, over ``reduce_gradients``' groups, and divided by
  the same n once it lands.  Every handle is waited on before the
  optimizer steps;
- ``fsdp_prefetch``: at the first read of layer i, layer i's and layer
  i+1's fsdp all-gathers are launched (in the backward's recompute,
  i-1's), and each is waited on at its own first read
  (``FsdpPrefetch``); the reduce-scatters of the backward are launched
  and waited on when their bucket is packed;
- ``ring_hop``: ring attention posts the K/V hop for block i+1 before
  block i's products (``parallel/ring.py``, ``sharding.ppermute_start``).

None of them changes a value: the same products run on the same inputs,
and each gradient is reduced over the same ranks.  Over two ranks a sum
has one order, so the step equals the synchronous step bit for bit;
over more, gloo's and NCCL's chunking may add in another order.

``enable_collective_overlap`` is the env contract of the reference's
function: it says which mechanisms the env allows, and writes nothing
to the environment.  The port's train worker engages them only where
``TRAIN_XLA_OVERLAP`` asks for them (``frameworks/train_worker.py``).
"""

from __future__ import annotations

import functools
import os
from collections import Counter
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from dcos_commons_tpu_torch.parallel.mesh import DATA_AXES, Mesh
from dcos_commons_tpu_torch.parallel.sharding import (
    FSDP,
    Dims,
    Pending,
    all_reduce_start,
    gather_fsdp,
    gather_start,
    gathered,
    overlapped_collectives,
    wait_scatters,
)

MECHANISMS = ("grad_reduce", "fsdp_prefetch", "ring_hop")
# a gradient bucket is launched once it holds this many bytes, or when
# the gradients of its layer are all in (whichever comes first)
BUCKET_BYTES = 25 << 20


class OverlapError(ValueError):
    """Overlap was asked for where it cannot engage."""


def enable_collective_overlap(
    env: Optional[Mapping[str, str]] = None,
) -> List[str]:
    """The mechanisms the env allows (all of ``MECHANISMS``), or none
    where the reference adds no flag: ``TRAIN_XLA_OVERLAP`` is
    ``0`` or ``false``, the task has no ``TPU_GENERATION`` (the
    scheduler's env contract of an accelerator task), or the caller
    asked for the CPU (``TORCH_DEVICE=cpu``, the counterpart of
    ``JAX_PLATFORMS=cpu``).  ``env`` defaults to ``os.environ``; nothing
    is written to it."""
    env = os.environ if env is None else env
    if env.get("TRAIN_XLA_OVERLAP", "1") in ("0", "false"):
        return []
    if not env.get("TPU_GENERATION"):
        return []
    if "cpu" in env.get("TORCH_DEVICE", "").lower():
        return []
    return list(MECHANISMS)


def applicable(mesh: Optional[Mesh], ring_axis: Optional[str] = None
               ) -> Tuple[str, ...]:
    """The mechanisms a step on ``mesh`` engages: none without a mesh
    or where the data axes hold one rank (no gradient is reduced, so
    nothing is launched from the backward); else the gradient
    reduction, the fsdp gathers where fsdp splits the params, and the
    ring's hops where ``ring_axis`` (the ring recipe's sp axis, None
    without the recipe) has more than one rank."""
    if mesh is None or mesh.size(DATA_AXES) == 1:
        return ()
    out = ["grad_reduce"]
    if mesh.size(FSDP) > 1:
        out.append("fsdp_prefetch")
    if ring_axis is not None and mesh.size((ring_axis,)) > 1:
        out.append("ring_hop")
    return tuple(out)


def resolve(overlap: bool, mesh: Optional[Mesh],
            ring_axis: Optional[str] = None) -> Tuple[str, ...]:
    """The mechanisms a step engages: none if ``overlap`` is False, else
    ``applicable``'s, or ``OverlapError`` where it has none."""
    if not overlap:
        return ()
    can = applicable(mesh, ring_axis)
    if not can:
        raise OverlapError(
            f"overlap cannot engage on {mesh.spec if mesh else 'no mesh'}: "
            "it overlaps the reduction of gradients over the data axes "
            f"{DATA_AXES}, and there they hold one rank")
    return can


def accumulated_mean(acc: torch.Tensor, g: torch.Tensor, k: int
                     ) -> torch.Tensor:
    """The last of ``k`` microbatches' gradient ``g`` added to the f32
    sum ``acc`` of the earlier ones, and their mean in ``g``'s dtype:
    what a step with ``grad_accum`` k reduces."""
    acc.add_(g.float())
    return (acc / k).to(g.dtype)


def _fsdp_dim(dims: Dims) -> Optional[int]:
    split = [d for d, axes in enumerate(dims) if "fsdp" in axes]
    return split[0] if len(split) == 1 else None


class FsdpPrefetch:
    """The fsdp gathers of a layer, launched a layer ahead.

    ``read(layers, rules, i, name)`` stands in for ``gather_fsdp`` of
    ``layers[name][i]``: it launches layer i's gathers not yet in flight
    and the next layer's (i+1 in the forward, i-1 in the backward's
    recompute, which runs the layers in reverse), then waits on this
    leaf's.  Launches follow sorted names, so every rank makes them in
    one order."""

    def __init__(self, mesh: Mesh):
        self.mesh, self.group, self.n = mesh, mesh.group(FSDP), mesh.size(FSDP)
        self.backward = False
        self.launched: set = set()
        self.pending: Dict[Tuple[int, str], Pending] = {}
        self.prefetched = 0

    def phase(self, backward: bool) -> None:
        self.drain()
        self.backward, self.launched = backward, set()

    def drain(self) -> None:
        """Wait on gathers nothing read (a recompute that stopped once
        it had what the backward needs)."""
        for pending in self.pending.values():
            pending.wait()
        self.pending = {}

    def _launch(self, layers, rules, i: int, ahead: bool) -> None:
        for name in sorted(layers):
            dim = _fsdp_dim(rules["layers/" + name][1:])
            if dim is None or (i, name) in self.launched:
                continue
            self.launched.add((i, name))
            self.pending[(i, name)] = gather_start(
                layers[name][i], dim, self.group, self.n)
            self.prefetched += ahead

    def read(self, layers, rules, i: int, name: str) -> torch.Tensor:
        dims = rules["layers/" + name][1:]
        dim = _fsdp_dim(dims)
        if dim is None:
            return gather_fsdp(layers[name][i], dims, self.mesh)
        self._launch(layers, rules, i, ahead=False)
        nxt = i - 1 if self.backward else i + 1
        if 0 <= nxt < len(layers[name]):
            self._launch(layers, rules, nxt, ahead=True)
        pending = self.pending.pop((i, name), None)
        if pending is None:  # read twice in one phase: gather again
            pending = gather_start(layers[name][i], dim, self.group, self.n)
        return gathered(layers[name][i], pending, dim, self.mesh, FSDP)


class GradReducer:
    """The gradient reduction of one backward, launched from it.

    ``slots[k]`` is (leaf j, row i or None) of the k-th tensor autograd
    differentiates; ``add(k, g)`` is its hook.  Gradients go into one
    bucket a (reduction axes, dtype, layer); a full bucket
    is packed into one flat tensor and all-reduced with
    ``async_op=True``: ``reduce_gradients``' groups (a param split over
    fsdp: ``dcn``, ``dp``, ``sp``; any other: ``DATA_AXES``) and dtype.
    With ``acc`` (the f32 sums of the earlier microbatches) each
    gradient is first made ``accumulated_mean``'s, as the synchronous
    step makes it.  ``finish()`` launches what is left, waits on every
    bucket and returns the leaves' gradients divided by the data axes'
    size.  It makes them once the caller has dropped what the backward
    returned, and frees each bucket as it is copied out: the step holds
    no more at a time than the synchronous one, a set of gradients and
    one of their sums."""

    def __init__(self, mesh: Mesh, leaves: Sequence[torch.Tensor],
                 dims: Sequence[Dims], slots: Sequence[Tuple[int, Optional[int]]],
                 acc: Optional[List[torch.Tensor]] = None, k: int = 1):
        self.mesh, self.leaves, self.slots = mesh, leaves, list(slots)
        self.acc, self.k = acc, k
        self.n = mesh.size(DATA_AXES)
        # without fsdp both groups hold the same ranks: one bucket
        split = mesh.size(FSDP) > 1
        self.keys = [(("dcn", "dp", "sp") if split and any(
            "fsdp" in a for a in dims[j]) else DATA_AXES,
            str(leaves[j].dtype), i) for j, i in self.slots]
        self.expect = Counter(self.keys)
        self.open: Dict[tuple, list] = {}
        self.nbytes: Dict[tuple, int] = {}
        self.flights: List[Tuple[Pending, List[int]]] = []
        self.left = len(self.slots)
        self.buckets = self.early = 0

    def hooks(self, inputs: Sequence[torch.Tensor]) -> None:
        for k, t in enumerate(inputs):
            t.register_hook(functools.partial(self.add, k))

    def add(self, k: int, g: torch.Tensor) -> None:
        self.left -= 1
        key = self.keys[k]
        self.open.setdefault(key, []).append((k, g))
        self.nbytes[key] = (self.nbytes.get(key, 0)
                            + g.numel() * g.element_size())
        self.expect[key] -= 1
        if self.expect[key] == 0 or self.nbytes[key] >= BUCKET_BYTES:
            self._launch(key)

    def _row(self, tensors, k: int) -> torch.Tensor:
        j, i = self.slots[k]
        return tensors[j] if i is None else tensors[j][i]

    def _launch(self, key) -> None:
        entries = self.open.pop(key)
        self.nbytes.pop(key)
        wait_scatters()
        parts = [(g if self.acc is None else accumulated_mean(
            self._row(self.acc, k), g, self.k)).reshape(-1)
            for k, g in entries]
        group = self.mesh.group(key[0])
        pending = all_reduce_start(torch.cat(parts), group)
        if group is not None:
            self.buckets += 1
            self.early += self.left > 0
        self.flights.append((pending, [k for k, _ in entries]))

    def finish(self) -> List[torch.Tensor]:
        if self.left:
            raise RuntimeError(f"{self.left} of the backward's "
                               f"{len(self.slots)} gradients never came")
        for key in sorted(self.open, key=str):
            self._launch(key)
        grads = [torch.empty_like(p) for p in self.leaves]
        flights, self.flights = self.flights, []
        while flights:
            pending, ks = flights.pop(0)
            flat, offset = pending.wait(), 0
            for k in ks:
                out = self._row(grads, k)
                part = flat[offset:offset + out.numel()].view(out.shape)
                offset += out.numel()
                out.copy_(part / self.n if self.n > 1 else part)
            del pending, flat
        return grads


_current: Optional["OverlapRun"] = None


def current_run() -> Optional["OverlapRun"]:
    """The overlapped step running now (None outside one).  The model
    reads it where a layer gathers its fsdp leaves and where attention
    runs the ring; the backward's recompute runs on autograd's thread,
    so this is the process's, not a thread's."""
    return _current


class OverlapRun:
    """One overlapped step: while it is entered, ``current_run()`` is it,
    collectives are not synchronised by ``timed_collectives``, and
    (with ``fsdp_prefetch``) the backward's fsdp reduce-scatters are
    launched asynchronously.  ``stats`` counts what engaged: gradient
    buckets launched (``buckets``), of them before the backward's last
    gradient (``launched_early``), and gathers launched a layer ahead
    (``prefetched``)."""

    def __init__(self, mechanisms: Sequence[str], mesh: Mesh):
        self.mechanisms = tuple(mechanisms)
        self.prefetch = (FsdpPrefetch(mesh) if "fsdp_prefetch"
                         in self.mechanisms else None)
        self.ring = "ring_hop" in self.mechanisms
        self.stats = dict(buckets=0, launched_early=0, prefetched=0)
        self._span = overlapped_collectives(self.prefetch is not None)

    def __enter__(self) -> "OverlapRun":
        global _current
        if _current is not None:
            raise RuntimeError("an overlapped step is already running")
        self._span.__enter__()
        _current = self
        return self

    def __exit__(self, *exc) -> None:
        global _current
        try:
            if self.prefetch is not None:
                self.prefetch.drain()
                self.stats["prefetched"] = self.prefetch.prefetched
        finally:
            _current = None
            self._span.__exit__(*exc)

    def phase(self, backward: bool) -> None:
        """Mark the start of a forward or of a backward (a microbatch's
        each)."""
        if self.prefetch is not None:
            self.prefetch.phase(backward)

    def count(self, reducer: GradReducer) -> None:
        self.stats["buckets"] += reducer.buckets
        self.stats["launched_early"] += reducer.early

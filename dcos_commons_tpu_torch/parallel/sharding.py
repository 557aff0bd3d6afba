"""The port's layout of a sharded step: per-dimension rules, a rank's
block of a full tensor, and the collectives of the forward and the
backward as ``torch.autograd.Function``s.

The JAX package has no one-file counterpart: there a param's
``PartitionSpec`` is all the model says, and GSPMD inserts the gathers,
reductions and reduce-scatters.  Here each is explicit, placed where
Megatron-LM places it, and small enough that ``torch.autograd.grad`` in
``make_train_step`` stays as it is:

- a rule is a tuple with one entry a dimension, each entry the tuple of
  mesh axes that split that dimension (``P("tp", "fsdp")`` is
  ``(("tp",), ("fsdp",))``), which is a ``PartitionSpec``'s meaning;
- ``copy_to`` (identity forward, all-reduce backward) enters a region
  where each rank of an axis computes on its own shard: the input of
  every column-parallel product over tp, the expert input over ep;
- ``reduce_from`` (all-reduce forward, identity backward) leaves it:
  the row-parallel product's partial sums, the vocab-parallel lookup,
  the expert outputs of the other ep ranks;
- ``gather`` (all-gather forward, reduce-scatter backward) is fsdp's
  per-layer gather of a stored shard;
- ``all_to_all`` and ``pmean`` (forward and backward alike) are the
  explicit ep path of ``moe_ffn(axis_name=...)``, where each
  rank's loss counts on its own, as in ``shard_map``; ``all_to_all``
  also regroups heads and sequence chunks in Ulysses attention;
- ``ppermute`` (send to the next rank of an axis, receive from the
  previous one; the gradient takes the reverse trip) is
  ``lax.ppermute`` over the ring ``j -> j+1``: the K/V hops of ring
  attention and the activation hops of the pipeline;
- ``vocab_parallel_nll`` is the cross entropy of logits split over tp.

So a param that every rank of an axis holds whole gets the same, whole
gradient on each of them, and only the batch axes (``dcn``, ``dp``,
``fsdp``) and, under a sequence-parallel recipe, ``sp`` (each rank's
loss reads its own chunk) are left to reduce after the backward
(``reduce_gradients``).  Every collective of a group of one rank is
skipped, on every rank alike.

``timed_collectives()`` adds up the host time spent in the collectives
(each bracketed by device synchronisations while it is on).

The overlapped step (``parallel/overlap.py``) uses the start/wait forms
below: ``all_reduce_start``, ``gather_start`` and ``ppermute_start``
launch with ``async_op=True`` and return a handle (``Pending``, ``Hop``)
that is waited on where its result is read, and ``_Gather``'s
reduce-scatter is launched the same way while an overlapped step asks
for it (``_Async.scatters``).  Nothing of the overlapped step is
bracketed by a synchronisation: ``timed_collectives`` reports its host
time blocked in waits (and in the blocking collectives it still makes)
as ``wait_seconds``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from dcos_commons_tpu_torch.parallel.mesh import DATA_AXES, Mesh

Dims = Tuple[Tuple[str, ...], ...]
TP = ("tp",)
EP = ("ep",)
FSDP = ("fsdp",)


def P(*entries) -> Dims:
    """A rule in ``PartitionSpec`` notation: each entry None, an axis
    name or a tuple of axis names."""
    out = []
    for e in entries:
        if e is None:
            out.append(())
        elif isinstance(e, str):
            out.append((e,))
        else:
            out.append(tuple(e))
    return tuple(out)


# -- collective timing ------------------------------------------------------


class _Clock:
    enabled = False
    seconds = 0.0
    calls = 0
    # set while an overlapped step runs: nothing is synchronised
    overlapped = False
    wait_seconds = 0.0
    waits = 0
    starts = 0


@contextlib.contextmanager
def timed_collectives():
    """While on, every collective of this module waits for the device
    before and after it and adds its host time to the yielded stats
    (``seconds``, ``calls``).  Inside an overlapped step nothing is
    synchronised: the host time blocked in a handle's wait or in a
    blocking collective goes to ``wait_seconds`` (``waits`` of them),
    and ``starts`` counts the asynchronous launches."""
    _Clock.enabled, _Clock.seconds, _Clock.calls = True, 0.0, 0
    _Clock.wait_seconds, _Clock.waits, _Clock.starts = 0.0, 0, 0
    stats: Dict[str, float] = {}
    try:
        yield stats
    finally:
        _Clock.enabled = False
        stats.update(seconds=_Clock.seconds, calls=_Clock.calls,
                     wait_seconds=_Clock.wait_seconds, waits=_Clock.waits,
                     starts=_Clock.starts)


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _collective(fn, t: torch.Tensor, *args, **kw) -> None:
    if not _Clock.enabled:
        fn(*args, **kw)
        return
    if _Clock.overlapped:
        t0 = time.perf_counter()
        fn(*args, **kw)
        _Clock.wait_seconds += time.perf_counter() - t0
        _Clock.waits += 1
        return
    _sync(t)
    t0 = time.perf_counter()
    fn(*args, **kw)
    _sync(t)
    _Clock.seconds += time.perf_counter() - t0
    _Clock.calls += 1


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In place over ``group`` (nothing for None); returns ``t``."""
    if group is not None:
        _collective(dist.all_reduce, t, t, op=op, group=group)
    return t


def _dim_buffers(t: torch.Tensor, dim: int, times: int, over: int = 1):
    """``t`` with ``dim`` moved first (contiguous) and an empty output of
    ``times / over`` its first dimension: an all-gather's operands
    (``times`` n) or a reduce-scatter's (``over`` n)."""
    moved = t.movedim(dim, 0).contiguous()
    return moved, moved.new_empty((moved.shape[0] * times // over,)
                                  + tuple(moved.shape[1:]))


def _gather_dim(t: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    moved, out = _dim_buffers(t, dim, n)
    _collective(dist.all_gather_into_tensor, out, out, moved, group=group)
    return out.movedim(0, dim)


def _scatter_dim(t: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    moved, out = _dim_buffers(t, dim, 1, n)
    _collective(dist.reduce_scatter_tensor, out, out, moved,
                op=dist.ReduceOp.SUM, group=group)
    return out.movedim(0, dim)


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    t = t.contiguous()
    out = torch.empty_like(t)
    _collective(dist.all_to_all_single, out, out, t, group=group)
    return out


def _shift_args(t: torch.Tensor, index: int, n: int, shift: int):
    """``all_to_all_single``'s output, input and split keywords for
    ``_shift``."""
    t = t.contiguous()
    out = torch.empty_like(t)
    send, recv = [0] * n, [0] * n
    send[(index + shift) % n] = t.numel()
    recv[(index - shift) % n] = t.numel()
    return out, t, dict(output_split_sizes=recv, input_split_sizes=send)


def _shift(t: torch.Tensor, group, index: int, n: int, shift: int
           ) -> torch.Tensor:
    """``t`` of the rank ``shift`` places before this one on the axis
    (this rank's ``t`` goes ``shift`` places on).  One
    ``all_to_all_single`` with every split empty but the two peers', so
    the send and the receive are posted together (a ring cannot
    deadlock) and gloo stages CUDA tensors through the host itself."""
    out, t, splits = _shift_args(t, index, n, shift)
    _collective(dist.all_to_all_single, out, out.view(-1), t.view(-1),
                group=group, **splits)
    return out


# -- asynchronous collectives -------------------------------------------------


class Pending:
    """An asynchronous collective in flight: ``value`` is its output,
    which nothing may read before ``wait()`` (NCCL: the current stream
    waits for the collective; gloo: the host does).  A collective of a
    group of one rank launches nothing and is ready at once."""

    def __init__(self, work, value: torch.Tensor):
        self.work, self.value = work, value

    def wait(self) -> torch.Tensor:
        if self.work is not None:
            t0 = time.perf_counter()
            self.work.wait()
            self.work = None
            if _Clock.enabled:
                _Clock.wait_seconds += time.perf_counter() - t0
                _Clock.waits += 1
        return self.value


def _start(fn, *args, **kw):
    if _Clock.enabled:
        _Clock.starts += 1
    return fn(*args, async_op=True, **kw)


def all_reduce_start(t: torch.Tensor, group) -> Pending:
    """``all_reduce`` (sum) of ``t`` in place over ``group``, launched."""
    if group is None:
        return Pending(None, t)
    return Pending(_start(dist.all_reduce, t, group=group), t)


def gather_start(x: torch.Tensor, dim: int, group, n: int) -> Pending:
    """``_gather_dim`` launched: the all-gather of ``dim`` over
    ``group`` (rank order), no autograd (``gathered`` attaches it)."""
    moved, out = _dim_buffers(x.detach(), dim, n)
    work = _start(dist.all_gather_into_tensor, out, moved, group=group)
    return Pending(work, out.movedim(0, dim))


def _scatter_start(t: torch.Tensor, dim: int, group, n: int) -> Pending:
    moved, out = _dim_buffers(t, dim, 1, n)
    work = _start(dist.reduce_scatter_tensor, out, moved,
                  op=dist.ReduceOp.SUM, group=group)
    return Pending(work, out.movedim(0, dim))


def _shift_start(t: torch.Tensor, group, index: int, n: int, shift: int
                 ) -> Pending:
    """``_shift`` launched."""
    out, t, splits = _shift_args(t, index, n, shift)
    work = _start(dist.all_to_all_single, out.view(-1), t.view(-1),
                  group=group, **splits)
    return Pending(work, out)


class _Async:
    """While ``scatters`` is a list (``overlapped_collectives``), each
    fsdp reduce-scatter of the backward is launched and appended there,
    and its gradient is read only after ``wait_scatters()``."""

    scatters: Optional[List[Pending]] = None


@contextlib.contextmanager
def overlapped_collectives(async_scatters: bool):
    """The span of an overlapped step: ``timed_collectives``
    synchronises nothing, and with ``async_scatters`` the backward's
    fsdp reduce-scatters are launched and left in flight (every one is
    waited on before this returns)."""
    _Clock.overlapped = True
    _Async.scatters = [] if async_scatters else None
    try:
        yield
        wait_scatters()
    finally:
        _Clock.overlapped = False
        _Async.scatters = None


def wait_scatters() -> None:
    """Wait on every fsdp reduce-scatter launched so far."""
    if _Async.scatters:
        for pending in _Async.scatters:
            pending.wait()
        _Async.scatters.clear()


def _scatter_grad(g: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    if _Async.scatters is None:
        return _scatter_dim(g, dim, group, n)
    pending = _scatter_start(g, dim, group, n)
    _Async.scatters.append(pending)
    return pending.value


# -- autograd collectives ---------------------------------------------------


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        return _gather_dim(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return _scatter_grad(g, ctx.dim, ctx.group, ctx.n), None, None, None


class _Gathered(torch.autograd.Function):
    """A gather launched ahead (``gather_start``), waited on here, at
    its first read; the backward is ``_Gather``'s."""

    @staticmethod
    def forward(ctx, x, pending, dim, group, n):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        return pending.wait()

    @staticmethod
    def backward(ctx, g):
        return (_scatter_grad(g, ctx.dim, ctx.group, ctx.n), None, None,
                None, None)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index, n, shift):
        ctx.args = (group, index, n, -shift)
        return _shift(x, group, index, n, shift)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, *ctx.args), None, None, None, None


class _HopStart(torch.autograd.Function):
    """The launch of a ring hop.  Its output is the receive buffer,
    which only ``_HopWait`` reads; in the backward it waits for the
    reverse hop that ``_HopWait``'s backward launched, so autograd runs
    the backward of whatever the forward did between the two (the
    ring's block) while the gradient travels.  The hop drops each
    tensor once it has been waited on: a tensor kept there would hold
    its own autograd node, whose context holds the hop, in a cycle."""

    @staticmethod
    def forward(ctx, x, hop):
        ctx.hop = hop
        hop.pending = _shift_start(x, *hop.args)
        return hop.pending.value

    @staticmethod
    def backward(ctx, g):
        back, ctx.hop.back = ctx.hop.back, None
        return back.wait(), None


class _HopWait(torch.autograd.Function):
    @staticmethod
    def forward(ctx, buffer, hop):
        ctx.hop = hop
        hop.pending.wait()
        hop.pending = None
        return buffer.view_as(buffer)

    @staticmethod
    def backward(ctx, g):
        group, index, n, shift = ctx.hop.args
        ctx.hop.back = _shift_start(g, group, index, n, -shift)
        return ctx.hop.back.value, None


class Hop:
    """``ppermute_start``'s handle: ``wait()`` (once) returns what the
    forward ``ppermute`` returns, with the same gradient."""

    def __init__(self, x: torch.Tensor, group, index: int, n: int,
                 shift: int):
        self.args = (group, index, n, shift)
        self.pending = self.back = None
        self.buffer = None if group is None else _HopStart.apply(x, self)
        self.x = x if group is None else None

    def wait(self) -> torch.Tensor:
        if self.buffer is None:
            x, self.x = self.x, None
            return x
        buffer, self.buffer = self.buffer, None
        return _HopWait.apply(buffer, self)


def copy_to(x: torch.Tensor, mesh: Optional[Mesh], axes: Sequence[str]
            ) -> torch.Tensor:
    """Identity forward, all-reduce of the gradient over ``axes``."""
    group = None if mesh is None else mesh.group(axes)
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, mesh: Optional[Mesh],
                axes: Sequence[str]) -> torch.Tensor:
    """All-reduce (sum) forward over ``axes``, identity backward."""
    group = None if mesh is None else mesh.group(axes)
    return x if group is None else _ReduceFrom.apply(x, group)


def pmean(x: torch.Tensor, mesh: Optional[Mesh], axes: Sequence[str]
          ) -> torch.Tensor:
    """``lax.pmean``: the mean over ``axes``, forward and backward alike,
    for values each rank's own loss reads (the explicit ep path)."""
    group = None if mesh is None else mesh.group(axes)
    return x if group is None else _Psum.apply(x, group) / mesh.size(axes)


def gather(x: torch.Tensor, dim: int, mesh: Optional[Mesh],
           axes: Sequence[str]) -> torch.Tensor:
    """All-gather of ``dim`` over ``axes`` (rank order), reduce-scatter
    (sum) of the gradient."""
    group = None if mesh is None else mesh.group(axes)
    if group is None:
        return x
    return _Gather.apply(x, dim, group, mesh.size(axes))


def all_to_all(x: torch.Tensor, mesh: Mesh, axes: Sequence[str]
               ) -> torch.Tensor:
    """``all_to_all_single`` over ``axes``: dimension 0 in equal chunks,
    chunk j to rank j, the received chunks concatenated in rank order.
    Its gradient takes the same trip back."""
    group = mesh.group(axes)
    return x if group is None else _AllToAll.apply(x, group)


def ppermute(x: torch.Tensor, mesh: Optional[Mesh], axes: Sequence[str],
             shift: int = 1) -> torch.Tensor:
    """``lax.ppermute`` over the ring ``j -> j + shift`` of ``axes``: the
    ``x`` of the rank ``shift`` places before this one.  The gradient
    goes the reverse way, so every rank of the axis must call the
    backward too (each rank's graph holds the same hops)."""
    group = None if mesh is None else mesh.group(axes)
    if group is None:
        return x
    return _PPermute.apply(x, group, mesh.index(axes), mesh.size(axes),
                           shift)


def ppermute_start(x: torch.Tensor, mesh: Optional[Mesh],
                   axes: Sequence[str], shift: int = 1) -> Hop:
    """``ppermute`` in two halves: the hop is posted now and
    ``.wait()`` returns its result.  The gradient takes the reverse trip
    the same way: posted when the backward reaches ``.wait()``'s node,
    waited on at the launch's."""
    group = None if mesh is None else mesh.group(axes)
    if group is None:
        return Hop(x, None, 0, 1, shift)
    return Hop(x, group, mesh.index(axes), mesh.size(axes), shift)


def gathered(x: torch.Tensor, pending: Pending, dim: int,
             mesh: Mesh, axes: Sequence[str]) -> torch.Tensor:
    """``gather(x, dim, mesh, axes)`` from ``gather_start``'s handle of
    ``x``'s gather: waits on it and attaches the reduce-scatter of the
    gradient."""
    return _Gathered.apply(x, pending, dim, mesh.group(axes),
                           mesh.size(axes))


def gather_fsdp(t: torch.Tensor, dims: Dims, mesh: Optional[Mesh]
                ) -> torch.Tensor:
    """A stored fsdp shard gathered to the size a rank computes with
    (its other axes stay split)."""
    for d, axes in enumerate(dims):
        if "fsdp" in axes:
            t = gather(t, d, mesh, FSDP)
    return t


def vocab_parallel_nll(logits: torch.Tensor, targets: torch.Tensor,
                       mesh: Mesh) -> torch.Tensor:
    """Negative log-likelihood of ``targets`` from f32 logits whose last
    dimension is this rank's block of the vocabulary (tp): the max and
    the sum of exponentials all-reduced over tp, the target's logit
    taken from the rank that holds it."""
    group = mesh.group(TP)
    v_local = logits.shape[-1]
    with torch.no_grad():
        top = all_reduce(logits.max(-1, keepdim=True).values.contiguous(),
                         group, dist.ReduceOp.MAX)
    shifted = logits - top
    sumexp = reduce_from(shifted.exp().sum(-1), mesh, TP)
    local = targets.long() - mesh.index(TP) * v_local
    inside = (local >= 0) & (local < v_local)
    picked = shifted.gather(-1, local.clamp(0, v_local - 1)[..., None])[..., 0]
    target = reduce_from(picked * inside, mesh, TP)
    return torch.log(sumexp) - target


def vocab_parallel_embed(embed: torch.Tensor, tokens: torch.Tensor,
                         mesh: Mesh) -> torch.Tensor:
    """``embed[tokens]`` where ``embed`` holds this rank's block of the
    vocabulary rows (tp): the rows it holds, zeros elsewhere, summed
    over tp."""
    v_local = embed.shape[0]
    local = tokens - mesh.index(TP) * v_local
    inside = (local >= 0) & (local < v_local)
    rows = embed[local.clamp(0, v_local - 1)] * inside[..., None].to(
        embed.dtype)
    return reduce_from(rows, mesh, TP)


# -- a rank's block of a full tensor -------------------------------------------


def block_slices(shape: Sequence[int], dims: Dims, mesh: Mesh
                 ) -> Tuple[slice, ...]:
    """This rank's block of a tensor of ``shape`` laid out by ``dims``."""
    if len(dims) != len(shape):
        raise ValueError(f"rule {dims} for a tensor of shape {tuple(shape)}")
    out = []
    for size, axes in zip(shape, dims):
        n = mesh.size(axes)
        if size % n:
            raise ValueError(
                f"dimension {size} does not split over {axes} ({n} ranks)"
            )
        i = mesh.index(axes)
        out.append(slice(i * size // n, (i + 1) * size // n))
    return tuple(out)


def shard(full: Any, dims: Dims, mesh: Mesh) -> Any:
    """This rank's block of ``full`` (a tensor or a numpy array), as a
    contiguous copy of its own."""
    part = full[block_slices(full.shape, dims, mesh)]
    if isinstance(part, torch.Tensor):
        return part.contiguous().clone()
    return np.array(part)


def unshard(t: torch.Tensor, dims: Dims, mesh: Mesh) -> torch.Tensor:
    """The full tensor from every rank's block (no autograd), in memory
    of its own: each split dimension all-gathered over its axes, and a
    copy where none is split, which the step's in-place update of ``t``
    does not reach."""
    full = t.detach()
    for d, axes in enumerate(dims):
        group = mesh.group(axes)
        if group is not None:
            full = _gather_dim(full, d, group, mesh.size(axes))
    return (full.contiguous() if full.data_ptr() != t.data_ptr()
            else full.clone())


# -- after the backward ---------------------------------------------------------


def reduce_gradients(grads: List[torch.Tensor], dims: List[Dims],
                     mesh: Mesh) -> List[torch.Tensor]:
    """The mean over the data axes (the batch axes, and ``sp`` under a
    sequence-parallel recipe) of each rank's local gradients.  A
    param's fsdp reduce-scatter has already summed over fsdp, so its
    gradient is summed over ``dcn``, ``dp`` and ``sp`` only; every other
    param's over all four.  Over tp and ep nothing is left to do (see
    the module doc)."""
    n = mesh.size(DATA_AXES)
    out = []
    for g, d in zip(grads, dims):
        axes = (("dcn", "dp", "sp") if any("fsdp" in a for a in d)
                else DATA_AXES)
        g = all_reduce(g.contiguous(), mesh.group(axes))
        out.append(g / n if n > 1 else g)
    return out


def batch_mean(value: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A per-rank mean over local rows and sequence positions (a 0-d
    tensor) as the mean over the global batch: the shards are equal."""
    group = mesh.group(DATA_AXES)
    if group is None:
        return value
    return all_reduce(value.detach().clone(), group) / mesh.size(DATA_AXES)

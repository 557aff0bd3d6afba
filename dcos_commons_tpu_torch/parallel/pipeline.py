"""Pipeline parallelism: layer stages over the ``pp`` mesh axis (port of
``dcos_commons_tpu/parallel/pipeline.py``), and the microbatch split,
which the train step's gradient accumulation also uses.

The GPipe schedule of the reference: every rank holds one contiguous
stage of layers; M microbatches run through S stages in M + S - 1
ticks, rank 0 feeding microbatch ``min(t, M-1)`` and the last rank
writing the output of microbatch ``t - (S-1)``, with one ``ppermute``
(stage s to s+1) a tick but the last, whose result nothing reads.
The wrap edge (last rank to rank 0) carries values rank 0 never reads.

Autograd differentiates the schedule end to end: each tick's permute
sends its gradient back one stage.  That is a collective, so every rank
must run the same backward hops in the same order.  The graph of each
rank is therefore the same: rank 0 reads the permuted state through
``torch.where`` (its gradient is zero there, as the reference's
``jnp.where``), and every rank's output is the stacked tick outputs
masked by ``where`` to zeros on all but the last rank, which the
caller's loss must read on every rank (``pipeline_loss_fn`` does).
The hops then form one chain, each waiting for the next tick's, in the
same order on every rank.  Every rank runs its stage on every tick, as
the reference does, also in the bubble (ticks on which it holds no
microbatch; what it computes there reaches no output): so every hop's
input depends on the stage's params on every rank, and a backward that
asks for their gradients (``torch.autograd.grad`` prunes what it need
not run) runs every hop's on every rank.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from dcos_commons_tpu_torch.parallel.mesh import Mesh
from dcos_commons_tpu_torch.parallel.sharding import ppermute, reduce_from


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,
    microbatches: torch.Tensor,
    mesh: Optional[Mesh],
    axis: str = "pp",
) -> torch.Tensor:
    """Run ``microbatches`` ``[M, microbatch, ...]`` (the same on every
    rank of ``axis``; only rank 0 feeds them in) through the pipeline,
    ``stage_fn(stage_params, x)`` being this rank's stage.  Returns
    ``[M, microbatch, ...]``: the outputs on the last rank, zeros on the
    others (see the module doc for why they are still read)."""
    axes = (axis,)
    n_stages = 1 if mesh is None else mesh.size(axes)
    idx = 0 if mesh is None else mesh.index(axes)
    n_micro = microbatches.shape[0]
    ticks = n_micro + n_stages - 1
    first = torch.tensor(idx == 0, device=microbatches.device)
    state = torch.zeros_like(microbatches[0])
    outs = []
    for t in range(ticks):
        x = torch.where(first, microbatches[min(t, n_micro - 1)], state)
        y = stage_fn(stage_params, x)
        if t >= n_stages - 1:  # microbatch t - (S-1) leaves the last stage
            outs.append(y)
        if t < ticks - 1:  # the last tick's permute would carry nothing read
            state = ppermute(y, mesh, axes)
    return _on_last_rank(torch.stack(outs), mesh, axis)


def _on_last_rank(x: torch.Tensor, mesh: Optional[Mesh], axis: str
                  ) -> torch.Tensor:
    """``x`` on the last rank of ``axis``, zeros elsewhere, ``x`` kept in
    the graph of every rank (its gradient zero there)."""
    n = 1 if mesh is None else mesh.size((axis,))
    if n == 1:
        return x
    last = torch.tensor(mesh.index((axis,)) == n - 1, device=x.device)
    return torch.where(last, x, torch.zeros_like(x))


def last_stage_value(x: torch.Tensor, mesh: Optional[Mesh],
                     axis: str = "pp") -> torch.Tensor:
    """The last rank's ``x`` on every rank of ``axis`` (a sum of ``x``
    masked to the last rank: one all-reduce).  Its backward is the
    identity: the value is one result, not a share of each rank's."""
    return reduce_from(_on_last_rank(x, mesh, axis), mesh, (axis,))


def split_microbatches(batch: torch.Tensor, n_micro: int) -> torch.Tensor:
    """[B, ...] -> [M, B/M, ...]; B must divide evenly."""
    b = batch.shape[0]
    if b % n_micro:
        raise ValueError(
            f"batch {b} not divisible into {n_micro} microbatches"
        )
    return batch.reshape((n_micro, b // n_micro) + tuple(batch.shape[1:]))


def merge_microbatches(micro: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`split_microbatches`."""
    return micro.reshape((micro.shape[0] * micro.shape[1],)
                         + tuple(micro.shape[2:]))

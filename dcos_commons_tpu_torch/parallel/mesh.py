"""The logical device mesh over a ``torch.distributed`` world (port of
``dcos_commons_tpu/parallel/mesh.py``).

Axes vocabulary (scaling-book conventions):
    dcn   cross-slice data parallel — batch split ACROSS slices,
          gradient allreduce rides the data-center network (the only
          collective that should: params replicate over dcn)
    dp    data parallel — batch split, gradient allreduce
    fsdp  fully-sharded data parallel — params/optimizer sharded,
          all-gathered per layer
    ep    expert parallel — MoE experts split
    pp    pipeline parallel — layer stages split
    tp    tensor parallel — heads/ffn split, activation collectives
    sp    sequence/context parallel — ring or Ulysses attention over
          sequence chunks

``MeshSpec``, ``derive``, ``elastic_reshard_ok`` and ``BATCH_AXES`` are
the JAX module's, line for line: pure shape math on the scheduler's env
contract.  Where the JAX module lays jax devices out in a ``Mesh``, the
port lays out the ranks of the process group, one process a GPU, in
the same C order over ``(dcn, dp, fsdp, ep, pp, sp, tp)``: ``tp`` is
innermost, so a tp group is consecutive ranks of one host, and ``dcn``
is outermost.  ``make_mesh`` returns a :class:`Mesh`: the spec, this
rank's coordinate on every axis, and one process group for each axis
and each tuple of axes that the sharding rules reduce over.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np


class SpecError(Exception):
    """An env contract no mesh can satisfy (the JAX package's
    ``specification.specs.SpecError``, of which the port keeps its own
    copy)."""


@dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape; axes with size 1 are kept (harmless)."""

    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    pp: int = 1
    ep: int = 1
    dcn: int = 1

    @property
    def total(self) -> int:
        return (self.dcn * self.dp * self.fsdp * self.tp * self.sp
                * self.pp * self.ep)

    def axes(self) -> Dict[str, int]:
        return {
            "dcn": self.dcn,
            "dp": self.dp,
            "fsdp": self.fsdp,
            "ep": self.ep,
            "pp": self.pp,
            "sp": self.sp,
            "tp": self.tp,
        }


AXES = ("dcn", "dp", "fsdp", "ep", "pp", "sp", "tp")
BATCH_AXES = ("dcn", "dp", "fsdp")  # batch shards over all data axes
# the axes each rank's loss is an equal share of: its rows, and under a
# sequence-parallel recipe its chunk of the sequence
DATA_AXES = BATCH_AXES + ("sp",)
# the tuples of axes a process group is built for: each axis alone, the
# data axes (the loss mean and the gradient mean of a replicated param)
# and the data axes but fsdp (the gradient mean of a param whose fsdp
# dimension the reduce-scatter already summed)
GROUP_AXES = tuple((a,) for a in AXES) + (DATA_AXES, ("dcn", "dp", "sp"))


class Mesh:
    """A rank's view of the mesh: ``spec``, ``rank``, ``coords`` (this
    rank's index on every axis) and the process groups.

    ``size(axes)`` and ``index(axes)`` treat a tuple of axes as one
    axis, the first of them major, as a ``PartitionSpec`` entry does.
    ``group(axes)`` is the process group of the ranks that share this
    rank's coordinate on every other axis, or None where the axes span
    one rank (a size-1 axis issues no collective).  ``control_device``
    is where the gang's small control tensors live (the resume step,
    the incarnation, the barrier): ``cpu`` under gloo, the rank's card
    under NCCL.  ``with mesh:`` makes it the mesh that
    ``models.moe.moe_ffn(axis_name=...)`` reduces over, as the JAX
    package's ``with mesh:`` binds axis names."""

    def __init__(self, spec: MeshSpec, rank: int = 0,
                 groups: Optional[Dict[Tuple[str, ...], object]] = None,
                 control_device: str = "cpu"):
        self.spec = spec
        self.rank = rank
        shape = tuple(spec.axes()[a] for a in AXES)
        self.coords = dict(zip(AXES, (int(i) for i in
                                      np.unravel_index(rank, shape))))
        self.groups = groups or {}
        self.control_device = control_device

    @property
    def shape(self) -> Dict[str, int]:
        return self.spec.axes()

    def size(self, axes: Sequence[str]) -> int:
        n = 1
        for axis in axes:
            n *= self.shape[axis]
        return n

    def index(self, axes: Sequence[str]) -> int:
        i = 0
        for axis in axes:
            i = i * self.shape[axis] + self.coords[axis]
        return i

    def group(self, axes: Sequence[str]):
        axes = tuple(axes)
        if self.size(axes) == 1:
            return None
        if axes not in self.groups:
            raise KeyError(f"no process group was built for axes {axes}")
        return self.groups[axes]

    def __enter__(self) -> "Mesh":
        global _CURRENT
        self._outer = _CURRENT
        _CURRENT = self
        return self

    def __exit__(self, *exc) -> None:
        global _CURRENT
        _CURRENT = self._outer

    def __repr__(self) -> str:
        return f"Mesh({self.spec}, rank={self.rank}, coords={self.coords})"


_CURRENT: Optional[Mesh] = None


def current_mesh() -> Optional[Mesh]:
    """The mesh of the innermost ``with mesh:`` block, or None."""
    return _CURRENT


def group_ranks(spec: MeshSpec, axes: Sequence[str]):
    """Every process group over ``axes``: lists of global ranks that
    differ only in their coordinates on ``axes``, each list ordered by
    the combined index over ``axes`` (first axis major), the lists in
    order of their first rank."""
    shape = tuple(spec.axes()[a] for a in AXES)
    ranks = np.arange(spec.total).reshape(shape)
    moved = [AXES.index(a) for a in axes]
    rest = [i for i in range(len(AXES)) if i not in moved]
    blocks = ranks.transpose(rest + moved).reshape(
        -1, int(np.prod([shape[i] for i in moved])))
    return [[int(r) for r in block] for block in blocks]


def make_mesh(spec: MeshSpec) -> Mesh:
    """The :class:`Mesh` of this rank over the initialised process group
    (a world of one when none is initialised).

    Every rank builds every group, in the same order, with
    ``dist.new_group``: the call is collective over the whole world,
    so a rank that skipped one would hang the others.  Groups of one
    rank are not built.  The world must hold exactly ``spec.total``
    ranks."""
    import torch.distributed as dist

    initialised = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialised else 1
    rank = dist.get_rank() if initialised else 0
    if world != spec.total:
        raise ValueError(
            f"mesh {spec} needs {spec.total} ranks, the world has {world}"
        )
    control_device = (
        "cuda" if initialised and dist.get_backend() == "nccl" else "cpu"
    )
    groups = {}
    for axes in GROUP_AXES:
        members = group_ranks(spec, axes)
        if len(members[0]) == 1:
            continue
        for ranks in members:
            group = dist.new_group(ranks)
            if rank in ranks:
                groups[axes] = group
    return Mesh(spec, rank, groups, control_device)


def derive(env: Dict[str, str], n_devices: Optional[int] = None) -> MeshSpec:
    """Derive the MeshSpec from the scheduler's env contract — PURE
    shape math, no device queries, so analyzers evaluate it abstractly
    and :func:`mesh_from_env` builds the real mesh from the same
    derivation.

    TPU_TOPOLOGY "XxY" at TPU_CHIPS_PER_HOST chips/host: default to
    dp over hosts x tp within host — the layout the placement
    guarantees is contiguous within a host.  Multi-slice gangs
    (TPU_NUM_SLICES) lay a dcn axis over the slice boundary.

    Without ``n_devices`` the chip count comes from the declared
    topology (times slices), i.e. what the spec promises at deploy.
    A declared TPU_TOPOLOGY whose per-slice chip count
    TPU_CHIPS_PER_HOST does not divide raises SpecError: that spec can
    never lay the promised host-aligned mesh, and silently falling
    back to a pure-dp layout would train with a layout the operator
    never asked for.  With no topology declared (ad-hoc envs, local
    dryruns) the fallback stays graceful.
    """
    # 0 is the "probe the local runtime" sentinel, not a chip count
    chips_per_host = int(env.get("TPU_CHIPS_PER_HOST", "0") or 0)
    n_slices = int(env.get("TPU_NUM_SLICES", "1") or 1)
    topology = env.get("TPU_TOPOLOGY", "")
    if n_devices is None:
        if topology:
            try:
                dims = [int(d) for d in topology.lower().split("x")]
            except ValueError:
                raise SpecError(f"bad topology {topology!r}")
            if not dims or any(d <= 0 for d in dims):
                raise SpecError(f"bad topology {topology!r}")
            per_slice = 1
            for d in dims:
                per_slice *= d
        else:
            per_slice = max(chips_per_host, 1)
        n = per_slice * max(n_slices, 1)
    else:
        n = n_devices
    if n_slices > 1 and n % n_slices == 0:
        # multi-slice gang: dcn (pure data parallel) over the slice
        # boundary, dp x tp within each slice
        per_slice = n // n_slices
        if chips_per_host and per_slice % chips_per_host == 0 \
                and per_slice >= chips_per_host:
            return MeshSpec(
                dcn=n_slices,
                dp=per_slice // chips_per_host,
                tp=chips_per_host,
            )
        if chips_per_host and per_slice % chips_per_host and topology:
            raise SpecError(
                f"TPU_CHIPS_PER_HOST={chips_per_host} does not divide "
                f"the {per_slice}-chip slice of topology {topology!r}: "
                "no host-aligned mesh exists for this spec"
            )
        return MeshSpec(dcn=n_slices, dp=per_slice)
    if chips_per_host and n % chips_per_host == 0 and n > chips_per_host:
        return MeshSpec(dp=n // chips_per_host, tp=chips_per_host)
    if chips_per_host and n % chips_per_host and topology:
        raise SpecError(
            f"TPU_CHIPS_PER_HOST={chips_per_host} does not divide the "
            f"{n} chips of topology {topology!r}: no host-aligned mesh "
            "exists for this spec"
        )
    return MeshSpec(dp=n)


def mesh_from_env(env: Dict[str, str], n_devices: Optional[int] = None
                  ) -> Mesh:
    """Build the Mesh :func:`derive` prescribes for this env contract,
    over the world's ranks (``n_devices`` defaults to the world size)."""
    import torch.distributed as dist

    if n_devices is None:
        n_devices = (dist.get_world_size()
                     if dist.is_available() and dist.is_initialized() else 1)
    return make_mesh(derive(env, n_devices))


def elastic_reshard_ok(old: MeshSpec, new: MeshSpec) -> bool:
    """True when a checkpoint written under ``old`` restores onto
    ``new`` as a pure re-layout — an elastic-DP resize.

    The contract: only the batch axes (``dp``/``dcn``) may change.
    Params and optimizer state are REPLICATED over dp/dcn, so a
    changed width re-lays the same leaves; any model-sharding axis
    changing (tp/sp/pp/ep/fsdp) would change leaf SHARDS, and the
    gathered npz checkpoint would silently restore a different
    parallelism than the step function expects.  The worker refuses
    that resume loudly instead.

    A whole-slice drop or regrow is exactly a dcn change — the
    per-slice topology, and with it every model axis, is untouched —
    so it rides this rule with no special case."""
    return (
        old.tp == new.tp
        and old.sp == new.sp
        and old.pp == new.pp
        and old.ep == new.ep
        and old.fsdp == new.fsdp
    )

"""Worker-side distributed bootstrap: the rendezvous (port of
``dcos_commons_tpu/parallel/distributed.py``).

Workers read the scheduler-issued env contract and join one
``torch.distributed`` process group at the coordinator address the
scheduler allocated on worker 0's host (``COORDINATOR_ADDRESS``), where
the JAX package calls ``jax.distributed.initialize``.  The scheduler
persisted that address, so restarts rendezvous at the same point.

The JAX package runs one process a host; torch's convention, and the
port's, is one process a GPU.  A worker whose host has ``k`` devices
starts ``k`` local ranks: the global rank is ``worker_id * k +
local_rank`` and the world ``worker_count * k``, so a host's ranks are
consecutive and ``parallel/mesh.py``'s C-order layout keeps ``tp``
within a host and ``dcn`` outermost.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import List, Mapping, Optional, Tuple

LOG = logging.getLogger(__name__)


def contract_from_env(env: Optional[Mapping[str, str]] = None) -> dict:
    """The parsed contract, with the JAX package's names and defaults."""
    env = env if env is not None else os.environ
    # per-slice coordinator addressing (multi-slice gangs):
    # TPU_SLICE_COORDS lists each slice's rendezvous anchor
    # slice-major; a worker's own slice anchor is slice_coords[
    # slice_index].  The global rendezvous stays the single
    # COORDINATOR_ADDRESS — one process group spanning every slice —
    # while the slice anchors give slice-local tooling a stable
    # address without re-deriving placement.
    slice_coords = [
        a for a in env.get("TPU_SLICE_COORDS", "").split(",") if a
    ]
    num_slices = int(env.get("TPU_NUM_SLICES", "1") or 1)
    slice_index = int(env.get("TPU_SLICE_INDEX", "0") or 0)
    return {
        "coordinator": env.get("COORDINATOR_ADDRESS", ""),
        "worker_id": int(env.get("TPU_WORKER_ID", "0") or 0),
        "worker_count": int(env.get("TPU_WORKER_COUNT", "1") or 1),
        # 0 is the "probe the local runtime" sentinel, not a chip
        # count; options.json's 4 only applies to rendered deploys
        # sdklint: disable=config-default-drift — autodetect sentinel
        "chips_per_host": int(env.get("TPU_CHIPS_PER_HOST", "0") or 0),
        "topology": env.get("TPU_TOPOLOGY", ""),
        "generation": env.get("TPU_GENERATION", ""),
        "num_slices": num_slices,
        "slice_index": slice_index,
        "hosts_per_slice": int(env.get("TPU_HOSTS_PER_SLICE", "0") or 0),
        "slice_coords": slice_coords,
        "slice_coordinator": (
            slice_coords[slice_index]
            if 0 <= slice_index < len(slice_coords) else ""
        ),
    }


def gang_rank(contract: dict, local_rank: int = 0,
              local_devices: int = 1) -> Tuple[int, int]:
    """(global rank, world size) of a worker's ``local_rank``-th
    process when each worker runs ``local_devices`` of them."""
    if not 0 <= local_rank < local_devices:
        raise ValueError(f"local rank {local_rank} of {local_devices}")
    return (contract["worker_id"] * local_devices + local_rank,
            contract["worker_count"] * local_devices)


def init_gang(init_method: str, world_size: int, rank: int,
              backend: str, timeout_s: float = 300,
              local_rank: int = 0) -> None:
    """``torch.distributed.init_process_group`` with a timeout: NCCL for
    ranks that compute on CUDA tensors, gloo for CPU ones (the caller
    says which).  Under NCCL the group is bound to this rank's card,
    ``cuda:<local_rank>``, so its communicators are made for that card
    up front."""
    import torch
    import torch.distributed as dist

    LOG.info("init_process_group(%s, %s, %d/%d)", backend, init_method,
             rank, world_size)
    bound = ({"device_id": torch.device("cuda", local_rank)}
             if backend == "nccl" else {})
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s), **bound,
    )


def initialize_from_env(
    env: Optional[Mapping[str, str]],
    backend: str,
    local_rank: int = 0,
    local_devices: int = 1,
    timeout_s: float = 300,
    init_method: Optional[str] = None,
) -> dict:
    """Join the gang's process group from the scheduler env contract.

    ``backend`` is the caller's: "nccl" for ranks that compute on CUDA
    tensors, "gloo" for CPU ones.  Returns the parsed contract (``env``
    None reads ``os.environ``).  A world of one initialises nothing,
    as the JAX package initialises nothing for one worker.  Otherwise
    the group meets at ``tcp://<COORDINATOR_ADDRESS>`` (or at
    ``init_method``, when the caller has a rendezvous of its own, such
    as a file store for the ranks of one host), and a gang contract
    with neither raises: a gang that cannot meet must not train alone.
    """
    contract = contract_from_env(env)
    rank, world = gang_rank(contract, local_rank, local_devices)
    if world == 1:
        return contract
    if init_method is None:
        if not contract["coordinator"]:
            raise ValueError(
                f"a gang of {contract['worker_count']} worker(s) x "
                f"{local_devices} device(s) and no COORDINATOR_ADDRESS "
                "to meet at"
            )
        init_method = f"tcp://{contract['coordinator']}"
    if contract["num_slices"] > 1:
        LOG.info(
            "multi-slice gang: slice %d/%d, slice coords %s",
            contract["slice_index"], contract["num_slices"],
            ",".join(contract["slice_coords"]) or "n/a",
        )
    init_gang(init_method, world, rank, backend, timeout_s, local_rank)
    return contract


# -- the gang's control values ---------------------------------------------------
# Small integers every rank must agree on, carried by the world group on
# the mesh's control device (the host under gloo, the card under NCCL).


def broadcast_int(value: int, mesh) -> int:
    """Rank 0's ``value`` on every rank."""
    import torch
    import torch.distributed as dist

    if mesh.spec.total == 1:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64,
                     device=mesh.control_device)
    dist.broadcast(t, 0)
    return int(t.item())


def gather_ints(value: int, mesh) -> List[int]:
    """Every rank's ``value``, in rank order."""
    import torch
    import torch.distributed as dist

    if mesh.spec.total == 1:
        return [int(value)]
    t = torch.tensor([int(value)], dtype=torch.int64,
                     device=mesh.control_device)
    out = torch.empty(mesh.spec.total, dtype=torch.int64,
                      device=mesh.control_device)
    dist.all_gather_into_tensor(out, t)
    return [int(v) for v in out.tolist()]


def barrier(mesh) -> None:
    """Wait until every rank of the world has reached this call."""
    gather_ints(0, mesh)


# -- the serving gang's tick -------------------------------------------------
# Rank 0 of a serving gang drives every rank with one broadcast a tick
# (frameworks/serve_gang_worker.py).  Its payloads are small host arrays
# of fixed shapes, so they ride gloo on the host: over NCCL, which
# carries CUDA tensors only, every tick would pay a host-to-device copy
# before the broadcast and a device-to-host copy and a sync after it,
# and the idle ticks would sit in NCCL's watchdog.  Beside an NCCL world
# the tick gets a gloo group of its own; under gloo it rides the world.


def tick_group(timeout_s: float = 300):
    """The process group of the tick broadcast (None: the world, when
    it is gloo's).  Collective: every rank calls it once, at the same
    point, after the world is initialised."""
    import torch.distributed as dist

    if dist.get_backend() == "gloo":
        return None
    return dist.new_group(backend="gloo",
                          timeout=datetime.timedelta(seconds=timeout_s))


def broadcast_arrays(arrays, like, group=None):
    """Rank 0's integer numpy ``arrays`` on every rank, the counterpart
    of ``multihost_utils.broadcast_one_to_all``: rank 0 passes its
    arrays, the others None, and every rank gets arrays of ``like``'s
    shapes and dtypes.  One broadcast of one flat int64 host tensor, of
    the same size every tick.  A world of one returns ``arrays``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() == 1:
        return tuple(np.asarray(a) for a in arrays)
    src = like if arrays is None else arrays
    flat = torch.from_numpy(np.concatenate(
        [np.asarray(a).astype(np.int64).ravel() for a in src]))
    dist.broadcast(flat, 0, group=group)
    out, at = [], 0
    for a in like:
        out.append(flat[at:at + a.size].numpy().astype(a.dtype)
                   .reshape(a.shape))
        at += a.size
    return tuple(out)

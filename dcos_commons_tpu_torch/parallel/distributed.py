"""The worker side of the scheduler's env contract: the env half of
``dcos_commons_tpu/parallel/distributed.py::initialize_from_env``.

The port trains on one card.  The rendezvous half (``torch.distributed``
over the coordinator address the scheduler allocated) comes with the
multi-GPU train step, ROADMAP queue 1, item 8; until then a worker that
reads a gang contract refuses it (``require_single_worker``) instead of
training alone in silence.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional


def contract_from_env(env: Optional[Mapping[str, str]] = None) -> dict:
    """The parsed contract, with the JAX package's names and defaults."""
    env = env if env is not None else os.environ
    # per-slice coordinator addressing (multi-slice gangs):
    # TPU_SLICE_COORDS lists each slice's rendezvous anchor
    # slice-major; a worker's own slice anchor is slice_coords[
    # slice_index]
    slice_coords = [
        a for a in env.get("TPU_SLICE_COORDS", "").split(",") if a
    ]
    num_slices = int(env.get("TPU_NUM_SLICES", "1") or 1)
    slice_index = int(env.get("TPU_SLICE_INDEX", "0") or 0)
    return {
        "coordinator": env.get("COORDINATOR_ADDRESS", ""),
        "worker_id": int(env.get("TPU_WORKER_ID", "0") or 0),
        "worker_count": int(env.get("TPU_WORKER_COUNT", "1") or 1),
        # 0 is the "probe the local runtime" sentinel, not a chip count
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


def require_single_worker(contract: dict) -> None:
    """Raise for a gang contract: the multi-GPU step is not ported."""
    if contract["worker_count"] > 1 or contract["num_slices"] > 1:
        raise NotImplementedError(
            f"a gang of {contract['worker_count']} worker(s) over "
            f"{contract['num_slices']} slice(s): the multi-GPU train step "
            "is not ported yet (ROADMAP queue 1, item 8); the port trains "
            "on one card"
        )

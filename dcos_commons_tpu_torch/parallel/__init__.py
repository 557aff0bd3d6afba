"""The parallel layer of the port: the mesh over a ``torch.distributed``
world (``mesh``), the rendezvous from the scheduler's env contract
(``distributed``), the sharding rules' blocks and the collectives of the
sharded step (``sharding``), and the microbatch split (``pipeline``).
Sequence and pipeline parallelism wait for ROADMAP queue 1, "MoE and
long-context"."""

from dcos_commons_tpu_torch.parallel.distributed import (
    contract_from_env,
    gang_rank,
    init_gang,
    initialize_from_env,
)
from dcos_commons_tpu_torch.parallel.mesh import (
    BATCH_AXES,
    Mesh,
    MeshSpec,
    SpecError,
    derive,
    elastic_reshard_ok,
    make_mesh,
    mesh_from_env,
)
from dcos_commons_tpu_torch.parallel.pipeline import split_microbatches

__all__ = [
    "BATCH_AXES",
    "Mesh",
    "MeshSpec",
    "SpecError",
    "contract_from_env",
    "derive",
    "elastic_reshard_ok",
    "gang_rank",
    "init_gang",
    "initialize_from_env",
    "make_mesh",
    "mesh_from_env",
    "split_microbatches",
]

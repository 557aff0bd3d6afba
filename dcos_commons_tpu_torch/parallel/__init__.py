"""The parallel layer of the port: the mesh over a ``torch.distributed``
world (``mesh``), the rendezvous from the scheduler's env contract
(``distributed``), the sharding rules' blocks and the collectives of the
sharded step (``sharding``), ring and Ulysses attention over the
sequence (``ring``, ``ulysses``), the GPipe schedule and the microbatch
split (``pipeline``), and the collective and roofline probes
(``collectives``), and the overlap of the train step's collectives
with its compute (``overlap``)."""

from dcos_commons_tpu_torch.parallel.distributed import (
    contract_from_env,
    gang_rank,
    init_gang,
    initialize_from_env,
)
from dcos_commons_tpu_torch.parallel.collectives import (
    collective_bandwidth,
    single_chip_rooflines,
)
from dcos_commons_tpu_torch.parallel.mesh import (
    BATCH_AXES,
    DATA_AXES,
    Mesh,
    MeshSpec,
    SpecError,
    derive,
    elastic_reshard_ok,
    make_mesh,
    mesh_from_env,
)
from dcos_commons_tpu_torch.parallel.overlap import (
    MECHANISMS,
    OverlapError,
    enable_collective_overlap,
)
from dcos_commons_tpu_torch.parallel.pipeline import (
    last_stage_value,
    merge_microbatches,
    pipeline_apply,
    split_microbatches,
)
from dcos_commons_tpu_torch.parallel.ring import ring_attention
from dcos_commons_tpu_torch.parallel.sharding import ppermute
from dcos_commons_tpu_torch.parallel.ulysses import ulysses_attention

__all__ = [
    "BATCH_AXES",
    "DATA_AXES",
    "MECHANISMS",
    "Mesh",
    "MeshSpec",
    "OverlapError",
    "SpecError",
    "collective_bandwidth",
    "contract_from_env",
    "derive",
    "elastic_reshard_ok",
    "enable_collective_overlap",
    "gang_rank",
    "init_gang",
    "initialize_from_env",
    "last_stage_value",
    "make_mesh",
    "merge_microbatches",
    "mesh_from_env",
    "pipeline_apply",
    "ppermute",
    "ring_attention",
    "single_chip_rooflines",
    "split_microbatches",
    "ulysses_attention",
]

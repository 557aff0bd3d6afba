"""The training data pipeline: memory-mapped token shards onto the
card."""

from dcos_commons_tpu_torch.data.loader import (
    DevicePrefetcher,
    TokenDataset,
    list_shards,
    rank_rows,
    write_token_shard,
)

__all__ = [
    "DevicePrefetcher",
    "TokenDataset",
    "list_shards",
    "rank_rows",
    "write_token_shard",
]

"""Static analysis of the port's frameworks: ``shardcheck`` (sharding,
the per-card memory footprint against the card, collective cost), run
as ``python -m dcos_commons_tpu_torch.analysis shard``."""

"""Static analysis of the port's frameworks: ``shardcheck`` (sharding,
the per-card memory footprint against the card, collective cost) and
``speccheck`` (deploy-time spec failures at lint time), run as
``python -m dcos_commons_tpu_torch.analysis shard|specs``."""

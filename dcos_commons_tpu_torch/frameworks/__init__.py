"""The port's workers, its service YAMLs and their ``options.json`` (the
JAX package's live under ``frameworks/jax/`` at the repo root, where
its analyzers walk; the port's stay here, where its own shardcheck
walks)."""

"""The port's workers (the JAX package's live under ``frameworks/jax/``
at the repo root, where the analyzers walk; the port's stay here)."""

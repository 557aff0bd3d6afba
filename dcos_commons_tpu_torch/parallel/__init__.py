"""What the single-card train step needs of the JAX package's
``parallel/``: the scheduler's env contract (``distributed``) and the
microbatch split (``pipeline``).  The multi-GPU step, the collectives
and the pipeline schedule wait for ROADMAP queue 1, item 8 onwards."""

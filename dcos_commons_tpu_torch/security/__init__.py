"""The port's copy of what its router needs of the JAX package's
security plane (``security/auth.py``): the cluster bearer token."""

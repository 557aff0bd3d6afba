"""The port's copy of the JAX package's security plane as far as its
router, agent and scheduler need it (``security/auth.py``): the
cluster bearer token and the TLS transport.  Secrets and the
certificate authority (``security/secrets.py``, ``security/tls.py``)
are not in the port yet."""

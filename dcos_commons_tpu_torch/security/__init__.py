"""Security plane: secret materialization + TLS certificate issuance.

Reference: the X2 subsystem (dcos/) — SecretsClient.java fetching from
the DC/OS secrets service, CertificateAuthorityClient.java signing
per-task certs consumed by TLSEvaluationStage.java (214 LoC), gated by
the TLSRequiresServiceAccount validator.  Here: secrets
resolve through a pluggable provider on the scheduler, certs come from
a CA the scheduler owns, and both land in task sandboxes as 0600 files
shipped over the launch channel (never via env logging or artifacts
URLs).

Trust model for the launch channel itself (security/auth.py): the
control plane authenticates every hop with a shared cluster bearer
token and can serve HTTPS from the same CA (``python -m
dcos_commons_tpu_torch certs`` provisions both).  Without a token the plane
is **loopback/trusted-network only**: secrets and TLS keys transit the
scheduler->agent launch request, so 0.0.0.0 fleets MUST set
--auth-token-file everywhere and SHOULD add --tls-* so that channel is
encrypted end to end.  All entrypoints warn on non-loopback binds
without a token.

Port of ``dcos_commons_tpu/security/__init__.py``, line for line but
the imports.
"""

from dcos_commons_tpu_torch.security.secrets import (
    FileSecretsProvider,
    InMemorySecretsProvider,
    SecretNotFound,
    SecretsProvider,
)
from dcos_commons_tpu_torch.security.tls import CertificateAuthority

__all__ = [
    "CertificateAuthority",
    "FileSecretsProvider",
    "InMemorySecretsProvider",
    "SecretNotFound",
    "SecretsProvider",
]

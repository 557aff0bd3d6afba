"""Control-plane authentication: the shared bearer token (the port's
copy of ``load_token``, ``check_bearer`` and ``auth_headers`` from the
JAX package's ``security/auth.py``, line for line).

One cluster auth token is shared by every control-plane process
(operator-managed file, like a service-account secret).  Servers
reject any request without ``Authorization: Bearer <token>`` (401);
comparison is constant-time.  The router's discovery polls send it to
the scheduler (``router/frontdoor.py`` ``fetch_endpoint``).  Without a
token the control plane is loopback/trusted-network only.  TLS and the
certificate tooling stay with the scheduler's package.
"""

from __future__ import annotations

import hmac
import os
from typing import Mapping, Optional

AUTH_HEADER = "Authorization"


def load_token(token: str = "", token_file: str = "",
               env: Optional[Mapping[str, str]] = None) -> str:
    """Resolve the cluster token: explicit > file > $AUTH_TOKEN(_FILE)."""
    if token:
        return token
    env = env if env is not None else os.environ
    token_file = token_file or env.get("AUTH_TOKEN_FILE", "")
    if token_file:
        with open(token_file) as f:
            return f.read().strip()
    return env.get("AUTH_TOKEN", "")


def check_bearer(headers, token: str) -> bool:
    """True when the request may proceed.  ``token == ''`` disables
    auth (single-machine dev mode; see the trust model above)."""
    if not token:
        return True
    presented = headers.get(AUTH_HEADER, "") or ""
    return hmac.compare_digest(
        presented.encode("utf-8"), f"Bearer {token}".encode("utf-8")
    )


def auth_headers(token: str) -> dict:
    return {AUTH_HEADER: f"Bearer {token}"} if token else {}

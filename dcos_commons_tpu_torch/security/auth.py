"""Control-plane authentication: shared bearer token + TLS transport.

Port of ``dcos_commons_tpu/security/auth.py``, line for line but the
imports: the bearer token, the TLS transport and ``certs_main``
(``python -m dcos_commons_tpu_torch certs``).

* a **cluster auth token** — one shared secret distributed to every
  control-plane process (operator-managed file, like a service-account
  secret).  Servers reject any request without
  ``Authorization: Bearer <token>`` (401); comparison is
  constant-time.  The router's discovery polls send it to the
  scheduler (``router/frontdoor.py`` ``fetch_endpoint``), the local
  agent's template fetches to ``/v1/artifacts``.
* optional **TLS** — each server can serve HTTPS with a certificate
  issued by the cluster CA; clients verify against the CA bundle.

Trust model: without a token the control plane is
**loopback/trusted-network only** — anyone who can reach an agent port
can run commands.  ``--bind 0.0.0.0`` fleets must set a token and
should add TLS so task secrets and TLS keys never transit plaintext.
"""

from __future__ import annotations

import hmac
import os
import secrets
import ssl
from typing import Mapping, Optional, Tuple

AUTH_HEADER = "Authorization"


def generate_token() -> str:
    """256-bit random bearer token (hex)."""
    return secrets.token_hex(32)


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


UNAUTHORIZED = (401, {"message": "missing or invalid bearer token"})


# ---------------------------------------------------------------------------
# TLS transport
# ---------------------------------------------------------------------------


def server_ssl_context(certfile: str, keyfile: str) -> ssl.SSLContext:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(certfile, keyfile)
    return ctx


def client_ssl_context(ca_file: str = "") -> ssl.SSLContext:
    """Verify servers against the cluster CA bundle; an empty ca_file
    falls back to system trust (public certs)."""
    if ca_file:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.load_verify_locations(ca_file)
        ctx.check_hostname = True
        ctx.verify_mode = ssl.CERT_REQUIRED
        return ctx
    return ssl.create_default_context()


def tls_pair(cert: str, key: str) -> Optional[Tuple[str, str]]:
    """Normalize a cert/key file pair; HALF a pair is a config error —
    silently serving plaintext when the operator asked for TLS is the
    one downgrade this module exists to prevent."""
    if bool(cert) != bool(key):
        raise ValueError(
            "TLS requires BOTH a certificate and a key file; got only "
            f"{'cert' if cert else 'key'} — refusing to serve plaintext"
        )
    return (cert, key) if cert else None


def wrap_http_server(httpd, tls: Optional[Tuple[str, str]]):
    """Wrap a stdlib HTTPServer's listening socket for HTTPS.

    ``tls`` is (certfile, keyfile) or None (plain HTTP).  The TLS
    handshake runs in the per-connection handler thread with a
    timeout, NOT in the accept loop: a client that opens TCP and never
    sends a ClientHello must not freeze the whole control-plane server
    (these servers gate launches, state, and lease renewals — an
    accept-loop stall would look like fleet-wide lease loss)."""
    if tls:
        ctx = server_ssl_context(tls[0], tls[1])
        httpd.socket = ctx.wrap_socket(
            httpd.socket, server_side=True, do_handshake_on_connect=False
        )
        inner_finish = httpd.finish_request

        def finish_request(request, client_address):
            request.settimeout(10.0)
            request.do_handshake()
            request.settimeout(None)
            inner_finish(request, client_address)

        httpd.finish_request = finish_request
    return httpd


def url_scheme(tls) -> str:
    return "https" if tls else "http"


# ---------------------------------------------------------------------------
# `python -m dcos_commons_tpu_torch certs` — provision CA + server certs
# ---------------------------------------------------------------------------


def certs_main(argv=None) -> int:
    """Provision control-plane TLS material into a directory:

        python -m dcos_commons_tpu_torch certs --dir ./cp-certs \\
            --hosts scheduler-host,agent-host-1,agent-host-2

    Writes ca.pem (hand to every client via --tls-ca / TLS_CA_FILE)
    and per-host <host>.cert.pem / <host>.key.pem (hand to the server
    bound on that host), plus a fresh auth token in token (0600).
    """
    import argparse

    from dcos_commons_tpu_torch.security.tls import CertificateAuthority

    parser = argparse.ArgumentParser(prog="dcos_commons_tpu_torch certs")
    parser.add_argument("--dir", required=True)
    parser.add_argument(
        "--hosts", default="localhost",
        help="comma-separated hostnames/IPs to issue server certs for",
    )
    args = parser.parse_args(argv)
    os.makedirs(args.dir, exist_ok=True)
    ca = CertificateAuthority.create("dcos-commons-tpu control plane CA")
    with open(os.path.join(args.dir, "ca.pem"), "wb") as f:
        f.write(ca.ca_cert_pem)
    for host in [h.strip() for h in args.hosts.split(",") if h.strip()]:
        cert, key = ca.issue(host, sans=[host, "localhost", "127.0.0.1"])
        cert_path = os.path.join(args.dir, f"{host}.cert.pem")
        key_path = os.path.join(args.dir, f"{host}.key.pem")
        with open(cert_path, "wb") as f:
            f.write(cert)
        fd = os.open(key_path, os.O_CREAT | os.O_WRONLY | os.O_TRUNC, 0o600)
        with os.fdopen(fd, "wb") as f:
            f.write(key)
    token_path = os.path.join(args.dir, "token")
    fd = os.open(token_path, os.O_CREAT | os.O_WRONLY | os.O_TRUNC, 0o600)
    with os.fdopen(fd, "w") as f:
        f.write(generate_token() + "\n")
    print(f"wrote CA, server certs, and auth token under {args.dir}")
    return 0

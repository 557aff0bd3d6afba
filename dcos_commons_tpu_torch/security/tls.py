"""Certificate authority: per-task TLS artifact issuance.

Reference: dcos/clients/CertificateAuthorityClient.java (CSR signing
against the DC/OS CA) consumed by offer/evaluate/TLSEvaluationStage
(cert + key + keystore artifacts placed in the task).  Here the
scheduler owns a CA (root key generated once and persisted via the
Persister, so scheduler restarts keep issuing from the same root) and
stamps each transport-encryption task with cert/key/ca PEMs delivered
as 0600 sandbox files.

Port of ``dcos_commons_tpu/security/tls.py``, line for line but the imports.
"""

from __future__ import annotations

import datetime
from typing import List, Optional, Tuple

CA_KEY_PATH = "/security/ca/key.pem"
CA_CERT_PATH = "/security/ca/cert.pem"


class CertificateAuthority:
    def __init__(self, ca_key_pem: bytes, ca_cert_pem: bytes):
        self._key_pem = ca_key_pem
        self._cert_pem = ca_cert_pem

    # -- construction -------------------------------------------------

    @staticmethod
    def create(common_name: str = "dcos-commons-tpu CA") -> "CertificateAuthority":
        from cryptography import x509
        from cryptography.hazmat.primitives import hashes, serialization
        from cryptography.hazmat.primitives.asymmetric import ec
        from cryptography.x509.oid import NameOID

        key = ec.generate_private_key(ec.SECP256R1())
        name = x509.Name(
            [x509.NameAttribute(NameOID.COMMON_NAME, common_name)]
        )
        now = datetime.datetime.now(datetime.timezone.utc)
        cert = (
            x509.CertificateBuilder()
            .subject_name(name)
            .issuer_name(name)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(minutes=5))
            .not_valid_after(now + datetime.timedelta(days=3650))
            .add_extension(
                x509.BasicConstraints(ca=True, path_length=0), critical=True
            )
            .sign(key, hashes.SHA256())
        )
        return CertificateAuthority(
            key.private_bytes(
                serialization.Encoding.PEM,
                serialization.PrivateFormat.PKCS8,
                serialization.NoEncryption(),
            ),
            cert.public_bytes(serialization.Encoding.PEM),
        )

    @staticmethod
    def load_or_create(persister) -> "CertificateAuthority":
        """Root key/cert persisted alongside scheduler state so
        restarts keep the same trust root."""
        key = persister.get_or_none(CA_KEY_PATH)
        cert = persister.get_or_none(CA_CERT_PATH)
        if key and cert:
            return CertificateAuthority(key, cert)
        ca = CertificateAuthority.create()
        persister.apply([
            _set(CA_KEY_PATH, ca._key_pem),
            _set(CA_CERT_PATH, ca._cert_pem),
        ])
        return ca

    @property
    def ca_cert_pem(self) -> bytes:
        return self._cert_pem

    # -- issuance -----------------------------------------------------

    def issue(
        self,
        common_name: str,
        sans: Optional[List[str]] = None,
        days: int = 825,
    ) -> Tuple[bytes, bytes]:
        """(cert_pem, key_pem) for one task endpoint, signed by the CA.

        Reference: TLSEvaluationStage builds CSR with the task's DNS
        names as SANs; here the scheduler passes the task name +
        hostname."""
        from cryptography import x509
        from cryptography.hazmat.primitives import hashes, serialization
        from cryptography.hazmat.primitives.asymmetric import ec
        from cryptography.x509.oid import NameOID

        ca_key = serialization.load_pem_private_key(self._key_pem, None)
        ca_cert = x509.load_pem_x509_certificate(self._cert_pem)
        key = ec.generate_private_key(ec.SECP256R1())
        now = datetime.datetime.now(datetime.timezone.utc)
        builder = (
            x509.CertificateBuilder()
            .subject_name(x509.Name(
                [x509.NameAttribute(NameOID.COMMON_NAME, common_name[:64])]
            ))
            .issuer_name(ca_cert.subject)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(minutes=5))
            .not_valid_after(now + datetime.timedelta(days=days))
            .add_extension(
                x509.BasicConstraints(ca=False, path_length=None),
                critical=True,
            )
        )
        import ipaddress

        alt_names: list = []
        for n in (sans or []):
            if not n:
                continue
            try:
                # IP literals must land in iPAddress SANs or client
                # hostname verification of e.g. https://127.0.0.1 fails
                alt_names.append(x509.IPAddress(ipaddress.ip_address(n)))
            except ValueError:
                alt_names.append(x509.DNSName(n))
        if alt_names:
            builder = builder.add_extension(
                x509.SubjectAlternativeName(alt_names), critical=False
            )
        cert = builder.sign(ca_key, hashes.SHA256())
        return (
            cert.public_bytes(serialization.Encoding.PEM),
            key.private_bytes(
                serialization.Encoding.PEM,
                serialization.PrivateFormat.PKCS8,
                serialization.NoEncryption(),
            ),
        )


def _set(path: str, value: bytes):
    from dcos_commons_tpu_torch.storage.persister import SetOp

    return SetOp(path, value)

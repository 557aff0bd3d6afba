"""The port's security plane (``dcos_commons_tpu_torch/security``:
secrets, the certificate authority, ``certs``) against the JAX
package's, on the CPU.

- tests/test_security.py's own cases run on the port, their imports
  pointed at it.
- ``FileSecretsProvider`` and ``InMemorySecretsProvider`` fetch and
  miss as the reference's do, on the same trees and refs.
- ``CertificateAuthority.create`` and ``issue`` make a chain that
  ``ssl`` verifies in a TLS handshake (a server holding the issued
  cert and key, a client trusting only the CA); ``load_or_create``
  gives the same CA after a restart and stores it where the reference
  does.
- ``python -m dcos_commons_tpu_torch certs`` writes the same files
  with the same modes as ``python -m dcos_commons_tpu certs``.
- A ``transport-encryption`` task launched by the builder-built
  scheduler carries cert, key and CA PEMs, as the reference's does.

Keys and certificates are random, so they compare by layout, mode and
verification, not by bytes."""

import base64
import os
import ssl
import stat
import subprocess
import sys

import pytest

from dcos_commons_tpu import security as j_security
from dcos_commons_tpu.security import tls as j_tls
from dcos_commons_tpu.storage import MemPersister as JMem
from dcos_commons_tpu import testing as j_testing
from dcos_commons_tpu_torch import security as t_security
from dcos_commons_tpu_torch.security import tls as t_tls
from dcos_commons_tpu_torch.storage import MemPersister as TMem
from dcos_commons_tpu_torch import testing as t_testing
from test_torch_sim import port_module

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = (
    ("jax", j_security, j_tls, JMem, j_testing, "dcos_commons_tpu"),
    ("port", t_security, t_tls, TMem, t_testing, "dcos_commons_tpu_torch"),
)

SECURITY_CASES = port_module("test_security.py")


def _case_names(module):
    return sorted(n for n in vars(module) if n.startswith("test_"))


def test_every_reference_case_is_run():
    assert len(_case_names(SECURITY_CASES)) == 10


@pytest.mark.parametrize("name", _case_names(SECURITY_CASES))
def test_security_case_on_the_port(name, tmp_path):
    case = getattr(SECURITY_CASES, name)
    if "tmp_path" in case.__code__.co_varnames[:case.__code__.co_argcount]:
        case(tmp_path)
    else:
        case()


def fetches(provider, refs):
    out = []
    for ref in refs:
        try:
            out.append(provider.fetch(ref))
        except Exception as e:  # noqa: BLE001 — compared across packages
            out.append((type(e).__name__, str(e), getattr(e, "source", None)))
    return out


def test_secrets_providers_fetch_and_miss_as_the_reference(tmp_path):
    (tmp_path / "root" / "app").mkdir(parents=True)
    (tmp_path / "root" / "app" / "password").write_bytes(b"hunter2")
    (tmp_path / "outside").write_bytes(b"leak")
    refs = ["app/password", "/app/password", "app/missing", "../outside",
            "app", ""]
    values = {"a/b": b"one", "c": b""}
    out = []
    for _, security, *_ in PACKAGES:
        out.append((
            fetches(security.FileSecretsProvider(str(tmp_path / "root")),
                    refs),
            fetches(security.InMemorySecretsProvider(values),
                    ["a/b", "c", "a", "missing"]),
        ))
    assert out[1] == out[0]
    assert out[0][0][0] == b"hunter2"
    assert out[0][1][:2] == [b"one", b""]


def handshake(ca_pem, cert_pem, key_pem, hostname, tmp_path):
    """A TLS handshake in memory: the server holds ``cert_pem`` and
    ``key_pem``, the client trusts ``ca_pem`` only and checks
    ``hostname``.  Returns the server certificate the client saw."""
    cert, key = tmp_path / "c.pem", tmp_path / "k.pem"
    cert.write_bytes(cert_pem)
    key.write_bytes(key_pem)
    server_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    server_ctx.load_cert_chain(str(cert), str(key))
    client_ctx = ssl.create_default_context(cadata=ca_pem.decode())
    bios = [ssl.MemoryBIO() for _ in range(4)]
    client = client_ctx.wrap_bio(bios[0], bios[1], server_hostname=hostname)
    server = server_ctx.wrap_bio(bios[2], bios[3], server_side=True)
    done = {"client": False, "server": False}
    for _ in range(20):
        for name, side, out_bio, in_bio in (
                ("client", client, bios[1], bios[2]),
                ("server", server, bios[3], bios[0])):
            if not done[name]:
                try:
                    side.do_handshake()
                    done[name] = True
                except ssl.SSLWantReadError:
                    pass
            in_bio.write(out_bio.read())
        if all(done.values()):
            return client.getpeercert()
    raise AssertionError("the handshake did not finish")


@pytest.mark.parametrize("pkg", ["jax", "port"])
@pytest.mark.parametrize("hostname", ["web-0-server", "127.0.0.1"])
def test_issued_chain_verifies_in_a_tls_handshake(pkg, hostname, tmp_path):
    tls = dict((p[0], p[2]) for p in PACKAGES)[pkg]
    ca = tls.CertificateAuthority.create()
    cert, key = ca.issue(hostname, sans=[hostname, "localhost"])
    peer = handshake(ca.ca_cert_pem, cert, key, hostname, tmp_path)
    assert dict(x[0] for x in peer["subject"])["commonName"] == hostname
    # a CA of its own does not verify it
    other = tls.CertificateAuthority.create()
    with pytest.raises(ssl.SSLCertVerificationError):
        handshake(other.ca_cert_pem, cert, key, hostname, tmp_path)


def test_load_or_create_keeps_the_ca_where_the_reference_does():
    layout = []
    for _, _, tls, mem, *_ in PACKAGES:
        persister = mem()
        first = tls.CertificateAuthority.load_or_create(persister)
        second = tls.CertificateAuthority.load_or_create(persister)
        assert second.ca_cert_pem == first.ca_cert_pem
        assert persister.get(tls.CA_CERT_PATH) == first.ca_cert_pem
        assert b"PRIVATE KEY" in persister.get(tls.CA_KEY_PATH)
        layout.append((tls.CA_KEY_PATH, tls.CA_CERT_PATH,
                       sorted(persister.dump())))
    assert layout[1] == layout[0]
    assert layout[0][:2] == ("/security/ca/key.pem", "/security/ca/cert.pem")


def certs_files(module, directory):
    proc = subprocess.run(
        [sys.executable, "-m", module, "certs", "--dir", str(directory),
         "--hosts", "sched-host, agent-1"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    files = {}
    for name in sorted(os.listdir(directory)):
        path = directory / name
        files[name] = stat.S_IMODE(os.stat(path).st_mode)
    return proc.stdout.replace(str(directory), "<dir>"), files


def test_certs_writes_the_same_files_as_the_jax_certs(tmp_path):
    out = [certs_files(module, tmp_path / name)
           for name, *_, module in PACKAGES]
    assert out[1] == out[0]
    files = out[0][1]
    assert files["token"] == files["agent-1.key.pem"] == 0o600
    assert sorted(files) == sorted([
        "ca.pem", "token", "sched-host.cert.pem", "sched-host.key.pem",
        "agent-1.cert.pem", "agent-1.key.pem"])
    # the port's certificates chain to the port's CA
    directory = tmp_path / "port"
    handshake((directory / "ca.pem").read_bytes(),
              (directory / "agent-1.cert.pem").read_bytes(),
              (directory / "agent-1.key.pem").read_bytes(), "agent-1",
              tmp_path)


def tls_payload(testing):
    with open(os.path.join(REPO, "frameworks", "helloworld",
                           "tls.yml")) as f:
        runner = testing.ServiceTestRunner(f.read())
    runner.run([testing.AdvanceCycles(1),
                testing.ExpectLaunchedTasks("secure-0-node")])
    agent = runner.world.agent
    return (agent.payloads[agent.task_id_of("secure-0-node")],
            runner.world.scheduler)


def test_transport_encryption_launch_carries_the_pems(tmp_path):
    """tls.yml through each builder-built scheduler: the launch payload's
    files (their destinations and modes) are the same, the cert verifies
    against the CA the scheduler persisted, and the key is its key."""
    shapes = []
    for _, _, tls, _, testing, _ in PACKAGES:
        payload, sched = tls_payload(testing)
        files = {f["dest"]: f for f in payload["files"]}
        shapes.append(sorted((d, f["mode"]) for d, f in files.items()))
        pem = {d.rsplit(".", 1)[1]: base64.b64decode(f["content"])
               for d, f in files.items()}
        assert pem["ca"] == sched.certificate_authority.ca_cert_pem
        handshake(pem["ca"], pem["crt"], pem["key"], "secure-0-node",
                  tmp_path)
    assert shapes[1] == shapes[0]
    assert shapes[0] == [("secure-tls-pod.ca", 0o644),
                         ("secure-tls-pod.crt", 0o644),
                         ("secure-tls-pod.key", 0o600)]

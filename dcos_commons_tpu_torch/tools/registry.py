"""Package registry: publish and install-from-registry.

Reference: tools/publish_http.py (serve built artifacts over HTTP so
clusters install without cloud credentials) and
tools/release_builder.py (immutable, digest-indexed releases).  A
registry is a directory holding artifacts plus an ``index.json``:

    {"packages": {name: {version: {"artifact": "<file>",
                                   "sha256": "<hex>",
                                   "description": "..."}}}}

used either directly by path (a shared filesystem / airgapped USB
drop) or served over HTTP:

    GET /v1/registry/index              -> the index
    GET /v1/registry/artifacts/<file>   -> artifact bytes
    PUT /v1/registry/artifacts/<file>   -> publish (bearer-gated)

Releases are IMMUTABLE: republishing a (name, version) with different
bytes is rejected — release_builder's stable-artifact rule; bump the
version instead.  Install verifies the artifact's digest against the
index before anything reaches the scheduler.

Port of ``dcos_commons_tpu/tools/registry.py``, line for line but the
imports.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import threading
from typing import Dict, Optional, Tuple

from dcos_commons_tpu_torch.tools.packaging import (
    PackageError,
    read_manifest,
)

INDEX_NAME = "index.json"
ARTIFACT_DIR = "artifacts"


def _is_http(registry: str) -> bool:
    return registry.startswith(("http://", "https://"))


def _artifact_name(name: str, version: str) -> str:
    for field, value in (("name", name), ("version", version)):
        if not re.fullmatch(r"[A-Za-z0-9._-]+", value or ""):
            raise PackageError(
                f"package {field} {value!r} is not registry-safe "
                "([A-Za-z0-9._-] only)"
            )
    return f"{name}-{version}.tar.gz"


def _version_key(version: str):
    """Order '0.10.2' above '0.9.9' (numeric segments compare as
    ints) and a RELEASE above its own prereleases ('1.0.0' outranks
    '1.0.0-rc1' — semver's prerelease rule; naive list comparison
    would resolve the rc as "latest")."""
    pieces = re.split(r"[.\-+]", version)
    core = []
    i = 0
    while i < len(pieces) and pieces[i].isdigit():
        core.append(int(pieces[i]))
        i += 1
    pre = pieces[i:]
    return (
        core,
        1 if not pre else 0,  # release > any prerelease of same core
        [(0, int(p)) if p.isdigit() else (1, p) for p in pre],
    )


def _load_index(path: str) -> Dict:
    if not os.path.exists(path):
        return {"packages": {}}
    with open(path, "r", encoding="utf-8") as f:
        try:
            index = json.load(f)
        except ValueError as e:
            raise PackageError(f"corrupt registry index {path}: {e}")
    index.setdefault("packages", {})
    return index


def _registry_lock(root: str):
    """Context manager: the registry's advisory index lock.  Every
    index read-modify-write (publish, prune) must hold it — in the
    documented shared-filesystem mode a concurrent writer's
    os.replace would otherwise erase this writer's entry.  (The HTTP
    path serializes in-process on top of this.)"""
    import contextlib

    @contextlib.contextmanager
    def _held():
        with contextlib.ExitStack() as stack:
            try:
                import fcntl

                lock = stack.enter_context(
                    open(os.path.join(root, ".index.lock"), "a+")
                )
                fcntl.flock(lock.fileno(), fcntl.LOCK_EX)
            except ImportError:  # pragma: no cover — non-POSIX
                pass
            yield

    return _held()


def _store_index(path: str, index: Dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(index, f, indent=2, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _http_call(
    url: str, *, data: Optional[bytes] = None, method: str = "GET",
    token: str = "", timeout: float = 60.0,
):
    import urllib.request

    headers = {}
    if token:
        headers["Authorization"] = f"Bearer {token}"
    if data is not None:
        headers["Content-Type"] = "application/octet-stream"
    req = urllib.request.Request(
        url, data=data, method=method, headers=headers
    )
    return urllib.request.urlopen(req, timeout=timeout)


# -- publish ----------------------------------------------------------


def publish_package(
    package_path: str, registry: str, token: str = ""
) -> Dict:
    """Publish a built package into a registry (dir path or HTTP URL).
    Returns {"name", "version", "sha256", "artifact"}."""
    with open(package_path, "rb") as f:
        payload = f.read()
    manifest = read_manifest(package_path)  # validates it IS a package
    name, version = manifest["name"], manifest.get("version", "0.0.0")
    artifact = _artifact_name(name, version)
    digest = hashlib.sha256(payload).hexdigest()
    if _is_http(registry):
        import urllib.error

        try:
            with _http_call(
                f"{registry.rstrip('/')}/v1/registry/artifacts/{artifact}",
                data=payload, method="PUT", token=token,
            ) as resp:
                return json.loads(resp.read().decode("utf-8"))
        except urllib.error.HTTPError as e:
            raise PackageError(
                f"registry rejected publish: {e.read().decode('utf-8')}"
            )
        except urllib.error.URLError as e:
            raise PackageError(f"registry unreachable at {registry}: {e}")
    return _publish_local(registry, artifact, payload, manifest, digest)


def _publish_local(
    root: str, artifact: str, payload: bytes, manifest: Dict, digest: str
) -> Dict:
    os.makedirs(os.path.join(root, ARTIFACT_DIR), exist_ok=True)
    index_path = os.path.join(root, INDEX_NAME)
    with _registry_lock(root):
        return _publish_local_locked(
            root, index_path, artifact, payload, manifest, digest
        )


def _publish_local_locked(
    root: str, index_path: str, artifact: str, payload: bytes,
    manifest: Dict, digest: str,
) -> Dict:
    name, version = manifest["name"], manifest.get("version", "0.0.0")
    index = _load_index(index_path)
    existing = index["packages"].get(name, {}).get(version)
    if existing is not None:
        if existing["sha256"] == digest:
            return {  # idempotent re-publish of identical bytes
                "name": name, "version": version,
                "sha256": digest, "artifact": artifact,
            }
        raise PackageError(
            f"{name} {version} is already published with different "
            "bytes — releases are immutable, bump the version"
        )
    tombstone = index.get("tombstones", {}).get(name, {}).get(version)
    if tombstone is not None and tombstone != digest:
        # a PRUNED version stays burned: clients that pinned it must
        # never see different bytes under the same (name, version);
        # republishing the original bytes restores it
        raise PackageError(
            f"{name} {version} was pruned from this registry and its "
            "digest is tombstoned — releases are immutable even after "
            "pruning; bump the version"
        )
    artifact_path = os.path.join(root, ARTIFACT_DIR, artifact)
    tmp = artifact_path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, artifact_path)
    index["packages"].setdefault(name, {})[version] = {
        "artifact": artifact,
        "sha256": digest,
        "description": manifest.get("description", ""),
    }
    _store_index(index_path, index)
    return {
        "name": name, "version": version,
        "sha256": digest, "artifact": artifact,
    }


def prune_registry(
    registry: str, keep: int, name: str = "", grace_s: float = 0.0,
) -> Dict:
    """Retire old releases (release_builder's lifecycle cleanup): for
    each package — or just ``name`` — keep the newest ``keep``
    versions by the semver ordering and drop the rest from the index,
    deleting artifact files no retained release references.  Runs on
    the registry HOST directory (the same place publishes land in
    shared-filesystem mode); an HTTP URL is refused — pruning is a
    registry-admin operation, not a client verb.  Returns
    {package: [pruned versions]}.  Immutability SURVIVES the prune:
    each pruned (name, version) leaves a digest TOMBSTONE in the
    index, so republishing different bytes under it is still
    rejected (republishing the original bytes restores it).

    CONCURRENT-READER CAVEAT: a ``RegistryServer`` (or a shared-
    filesystem client) may be mid-fetch of an artifact this prune
    just unreferenced.  On POSIX local disk the open stream survives
    the unlink, but in the documented NFS mode deleting the file a
    client is streaming yields TRUNCATED reads or stale-handle
    errors, not a clean 404.  Either quiesce fetches around the
    prune, or pass ``grace_s`` > 0: unreferenced artifacts are then
    RENAMED to ``<file>.trash-<epoch>-<grace>`` (dropping them from
    the index and from fetch immediately) and only unlinked by a
    LATER prune once the window RECORDED IN THE NAME has elapsed (a
    later prune with a smaller ``grace_s`` cannot shorten an earlier
    prune's promise) — any fetch that resolved the old index entry
    before the prune has ``grace_s`` seconds to finish streaming."""
    if _is_http(registry):
        raise PackageError(
            "prune runs on the registry host's directory, not over "
            "HTTP — ssh to the registry and pass its --dir path"
        )
    if keep < 1:
        raise PackageError(f"--keep must be >= 1, got {keep}")
    if not os.path.isdir(registry):
        raise PackageError(
            f"registry directory {registry!r} not found"
        )
    index_path = os.path.join(registry, INDEX_NAME)
    with _registry_lock(registry):
        index = _load_index(index_path)
        if name and name not in index["packages"]:
            raise PackageError(f"package {name!r} not in the registry")
        pruned: Dict = {}
        for pkg, versions in index["packages"].items():
            if name and pkg != name:
                continue
            ordered = sorted(versions, key=_version_key)
            for version in ordered[:-keep]:
                pruned.setdefault(pkg, []).append(version)
                # the tombstone carries the digest forward: pruning
                # must not reopen the (name, version) namespace to
                # different bytes
                index.setdefault("tombstones", {}).setdefault(
                    pkg, {}
                )[version] = versions[version]["sha256"]
                del versions[version]
        if pruned:
            _store_index(index_path, index)
        elif grace_s <= 0:
            return {}
        # delete artifacts nothing retained references (a file can be
        # shared only by index entries; recompute the live set).  With
        # a grace window, dead artifacts are parked as .trash-<epoch>
        # first (invisible to fetch, bytes intact for in-flight
        # readers) and reaped by whichever prune runs after the
        # window — so this block also runs when nothing was pruned,
        # to reap earlier prunes' leavings.
        import time

        now = time.time()
        live = {
            entry["artifact"]
            for versions in index["packages"].values()
            for entry in versions.values()
        }
        artifact_dir = os.path.join(registry, ARTIFACT_DIR)
        if os.path.isdir(artifact_dir):
            for fname in os.listdir(artifact_dir):
                path = os.path.join(artifact_dir, fname)
                if ".trash-" in fname:
                    # the window a parked file was PROMISED rides in
                    # its name (.trash-<epoch>-<grace>): a later prune
                    # run with a smaller --grace-s must not break the
                    # promise an earlier one made to in-flight readers
                    try:
                        parts = fname.rsplit(".trash-", 1)[1].split("-")
                        parked = float(parts[0])
                        promised = float(parts[1]) if len(parts) > 1 \
                            else 0.0
                    except (ValueError, IndexError):
                        parked = promised = 0.0
                    if now - parked >= promised:
                        try:
                            os.remove(path)
                        except OSError:
                            pass
                    continue
                if fname not in live and not fname.endswith(".tmp"):
                    try:
                        if grace_s > 0:
                            os.rename(
                                path,
                                f"{path}.trash-{int(now)}-{int(grace_s)}",
                            )
                        else:
                            os.remove(path)
                    except OSError:
                        pass
        return pruned


# -- resolve / fetch --------------------------------------------------


def registry_index(registry: str, token: str = "") -> Dict:
    if _is_http(registry):
        import urllib.error

        try:
            with _http_call(
                f"{registry.rstrip('/')}/v1/registry/index", token=token
            ) as resp:
                return json.loads(resp.read().decode("utf-8"))
        except urllib.error.HTTPError as e:
            # HTTPError IS-A URLError: without this arm a reachable
            # server's 404/500 would read as "unreachable"
            raise PackageError(
                f"registry error {e.code} at {registry}: "
                f"{e.read().decode('utf-8', 'replace')[:200]}"
            )
        except urllib.error.URLError as e:
            raise PackageError(f"registry unreachable at {registry}: {e}")
    return _load_index(os.path.join(registry, INDEX_NAME))


def fetch_package(
    registry: str, name: str, version: str = "", token: str = ""
) -> Tuple[str, bytes]:
    """Resolve ``name`` (latest version unless pinned) and return
    (version, payload) with the payload digest-verified against the
    index — a tampered artifact never reaches the scheduler."""
    index = registry_index(registry, token=token)
    versions = index.get("packages", {}).get(name)
    if not versions:
        known = sorted(index.get("packages", {}))
        raise PackageError(
            f"package {name!r} not in registry (has: {known})"
        )
    if not version:
        version = max(versions, key=_version_key)
    entry = versions.get(version)
    if entry is None:
        raise PackageError(
            f"{name} has no version {version!r} "
            f"(has: {sorted(versions, key=_version_key)})"
        )
    if _is_http(registry):
        import urllib.error

        try:
            with _http_call(
                f"{registry.rstrip('/')}/v1/registry/artifacts/"
                f"{entry['artifact']}",
                token=token,
            ) as resp:
                payload = resp.read()
        except urllib.error.HTTPError as e:
            raise PackageError(
                f"registry error {e.code} fetching {entry['artifact']} "
                f"from {registry}"
            )
        except urllib.error.URLError as e:
            raise PackageError(f"registry unreachable at {registry}: {e}")
    else:
        with open(
            os.path.join(registry, ARTIFACT_DIR, entry["artifact"]), "rb"
        ) as f:
            payload = f.read()
    digest = hashlib.sha256(payload).hexdigest()
    if digest != entry["sha256"]:
        raise PackageError(
            f"artifact digest mismatch for {name} {version}: the "
            "registry copy does not match its index"
        )
    return version, payload


# -- HTTP registry server ---------------------------------------------


class RegistryServer:
    """Serve a registry directory over HTTP (publish_http.py spirit).

    Reads are open; publish (PUT) requires the bearer token when one
    is set.  Publishing re-validates the payload as a package and goes
    through the same immutability gate as local publish."""

    def __init__(
        self, root: str, port: int = 0, bind: str = "127.0.0.1",
        auth_token: str = "",
    ):
        from http.server import (
            BaseHTTPRequestHandler,
            ThreadingHTTPServer,
        )

        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self._write_lock = threading.Lock()
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _reply(self, code: int, payload: bytes,
                       content_type: str = "application/json") -> None:
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def _reply_json(self, code: int, body: dict) -> None:
                self._reply(code, json.dumps(body).encode("utf-8"))

            def do_GET(self):
                if self.path == "/v1/registry/index":
                    index = _load_index(
                        os.path.join(server.root, INDEX_NAME)
                    )
                    self._reply_json(200, index)
                    return
                prefix = "/v1/registry/artifacts/"
                if self.path.startswith(prefix):
                    name = os.path.basename(self.path[len(prefix):])
                    path = os.path.join(server.root, ARTIFACT_DIR, name)
                    if not os.path.isfile(path):
                        self._reply_json(404, {"error": f"no {name}"})
                        return
                    with open(path, "rb") as f:
                        self._reply(
                            200, f.read(), "application/octet-stream"
                        )
                    return
                self._reply_json(404, {"error": "unknown route"})

            def do_PUT(self):
                if auth_token:
                    got = self.headers.get("Authorization", "")
                    if got != f"Bearer {auth_token}":
                        self._reply_json(
                            401, {"error": "publish requires the token"}
                        )
                        return
                prefix = "/v1/registry/artifacts/"
                if not self.path.startswith(prefix):
                    self._reply_json(404, {"error": "unknown route"})
                    return
                length = int(self.headers.get("Content-Length", 0))
                payload = self.rfile.read(length)
                try:
                    manifest = _manifest_of_bytes(payload)
                    digest = hashlib.sha256(payload).hexdigest()
                    artifact = _artifact_name(
                        manifest["name"],
                        manifest.get("version", "0.0.0"),
                    )
                    if os.path.basename(self.path[len(prefix):]) != \
                            artifact:
                        raise PackageError(
                            f"artifact name must be {artifact} for this "
                            "package's manifest"
                        )
                    with server._write_lock:
                        out = _publish_local(
                            server.root, artifact, payload, manifest,
                            digest,
                        )
                    self._reply_json(200, out)
                except PackageError as e:
                    self._reply_json(409, {"error": str(e)})

        self._server = ThreadingHTTPServer((bind, port), Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "RegistryServer":
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="registry",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)


def _manifest_of_bytes(payload: bytes) -> Dict:
    import io
    import tarfile

    from dcos_commons_tpu_torch.tools.packaging import MANIFEST_NAME

    try:
        with tarfile.open(
            fileobj=io.BytesIO(payload), mode="r:gz"
        ) as tar:
            member = tar.extractfile(MANIFEST_NAME)
            if member is None:
                raise PackageError("no manifest in upload")
            return json.loads(member.read().decode("utf-8"))
    except (tarfile.TarError, KeyError, ValueError, OSError) as e:
        raise PackageError(f"upload is not a package: {e}")

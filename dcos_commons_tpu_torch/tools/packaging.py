"""Framework packages: bundle, verify, extract, install.

Reference: tools/universe/package_builder.py (manifest + artifact
bundling) and the Cosmos install flow (frameworks/*/universe/
package.json + resource.json).  A package is a tar.gz of one framework
directory with a generated ``package.json`` manifest carrying name,
version, and per-file SHA-256 digests; extraction verifies every
digest and confines members to the target directory.

Port of ``dcos_commons_tpu/tools/packaging.py``, line for line but the
imports.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import tarfile
from typing import Dict, Optional

MANIFEST_NAME = "package.json"


class PackageError(Exception):
    pass


def build_package(
    framework_dir: str,
    out_path: str,
    name: str = "",
    version: str = "0.1.0",
    description: str = "",
) -> Dict:
    """Bundle ``framework_dir`` (must contain svc.yml) into a tar.gz
    with a digest manifest; returns the manifest."""
    framework_dir = os.path.abspath(framework_dir)
    svc = os.path.join(framework_dir, "svc.yml")
    if not os.path.isfile(svc):
        raise PackageError(f"{framework_dir} has no svc.yml")
    # a package with a self-inconsistent options schema must never
    # ship (reference: config.json is validated by universe tooling)
    from dcos_commons_tpu_torch.tools.options import options_findings

    schema_findings = options_findings(framework_dir)
    if schema_findings:
        raise PackageError(
            "options.json is inconsistent: " + "; ".join(schema_findings)
        )
    if not name:
        name = os.path.basename(framework_dir.rstrip(os.sep))
    # read each file ONCE: content and digest must come from the same
    # bytes, or a file rewritten mid-build ships with a manifest digest
    # that can never verify
    contents: Dict[str, bytes] = {}
    for root, _dirs, filenames in os.walk(framework_dir):
        for filename in sorted(filenames):
            path = os.path.join(root, filename)
            rel = os.path.relpath(path, framework_dir)
            if rel == MANIFEST_NAME or "__pycache__" in rel:
                continue
            # by CONTENT: a symlinked template becomes a regular file
            # in the package (extract rejects link members)
            with open(path, "rb") as f:
                contents[rel] = f.read()
    manifest = {
        "name": name,
        "version": version,
        "description": description,
        "files": {
            rel: hashlib.sha256(data).hexdigest()
            for rel, data in contents.items()
        },
    }
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with tarfile.open(out_path, "w:gz") as tar:
        def add_bytes(member_name: str, payload: bytes) -> None:
            member = tarfile.TarInfo(member_name)
            member.size = len(payload)
            tar.addfile(member, io.BytesIO(payload))

        add_bytes(
            MANIFEST_NAME, json.dumps(manifest, indent=2).encode("utf-8")
        )
        for rel in sorted(contents):
            add_bytes(rel, contents[rel])
    return manifest


def read_manifest(package_path: str) -> Dict:
    try:
        with tarfile.open(package_path, "r:gz") as tar:
            member = tar.extractfile(MANIFEST_NAME)
            if member is None:
                raise PackageError(f"{package_path}: no {MANIFEST_NAME}")
            return json.loads(member.read().decode("utf-8"))
    except (tarfile.TarError, KeyError, ValueError, OSError) as e:
        raise PackageError(f"{package_path}: not a package: {e}")


def extract_package(package_bytes: bytes, target_dir: str) -> Dict:
    """Extract a package into ``target_dir``, verifying the manifest
    digests and rejecting members that would escape the directory.

    Returns the manifest.  Reference: Cosmos unpacking a universe
    package before handing the scheduler its config."""
    os.makedirs(target_dir, exist_ok=True)
    # realpath on BOTH sides: a symlinked target dir must not make
    # every member look like an escape
    target_dir = os.path.realpath(target_dir)
    try:
        tar = tarfile.open(fileobj=io.BytesIO(package_bytes), mode="r:gz")
    except tarfile.TarError as e:
        raise PackageError(f"not a package tarball: {e}")
    with tar:
        try:
            manifest_member = tar.extractfile(MANIFEST_NAME)
            if manifest_member is None:
                raise KeyError(MANIFEST_NAME)
            manifest = json.loads(manifest_member.read().decode("utf-8"))
        except (KeyError, ValueError) as e:
            raise PackageError(f"bad package manifest: {e}")
        extracted = set()
        for member in tar.getmembers():
            if member.name == MANIFEST_NAME:
                continue
            if not member.isfile():
                raise PackageError(
                    f"package member {member.name!r} is not a regular file"
                )
            dest = os.path.realpath(os.path.join(target_dir, member.name))
            if not dest.startswith(target_dir + os.sep):
                raise PackageError(
                    f"package member escapes target: {member.name!r}"
                )
            expected = manifest.get("files", {}).get(member.name)
            if expected is None:
                raise PackageError(
                    f"package member not in manifest: {member.name!r}"
                )
            data = tar.extractfile(member).read()
            actual = hashlib.sha256(data).hexdigest()
            if actual != expected:
                raise PackageError(
                    f"digest mismatch for {member.name!r}"
                )
            os.makedirs(os.path.dirname(dest), exist_ok=True)
            with open(dest, "wb") as f:
                f.write(data)
            extracted.add(member.name)
    missing = set(manifest.get("files", {})) - extracted
    if missing:
        # a truncated archive must fail NOW, not at task launch when a
        # template turns out to be absent
        raise PackageError(f"package missing manifest files: {sorted(missing)}")
    if "svc.yml" not in manifest.get("files", {}):
        raise PackageError("package has no svc.yml")
    return manifest


def lint_airgap(framework_dir: str) -> list:
    """Air-gap lint (reference: tools/airgap_linter.py): a framework
    destined for a fleet with no egress must not bake external URLs or
    image pulls into its svc.yml / templates / scripts.  Returns a
    list of "path:line: finding" strings; empty = clean."""
    import re as _re

    if not os.path.isdir(framework_dir):
        # a typo'd path must not pass as "clean" (mirrors build_package
        # raising on a missing svc.yml)
        raise PackageError(f"no such framework dir: {framework_dir}")
    url_re = _re.compile(r"https?://[^\s\"']+", _re.IGNORECASE)
    image_re = _re.compile(r"^\s*image:\s*(\S+)")
    findings = []
    for dirpath, dirs, files in os.walk(framework_dir):
        # lint the file set build_package would SHIP (no VCS/cache
        # droppings — a .git/config URL is not a package finding)
        dirs[:] = [
            d for d in dirs if d != "__pycache__" and not d.startswith(".")
        ]
        for name in sorted(files):
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, framework_dir)
            try:
                with open(path, "r", encoding="utf-8") as f:
                    lines = f.readlines()
            except (UnicodeDecodeError, OSError):
                continue  # binaries are the tasks' problem, not ours
            for i, line in enumerate(lines, 1):
                stripped = line.strip()
                # NOTE: '*' is NOT a comment marker — a shell case arm
                # `*) curl https://...` must be flagged
                if stripped.startswith(("#", "//")):
                    continue
                if stripped.startswith("web-url:"):
                    # an ADVERTISED operator-browser URL, not a task
                    # fetch: air-gap egress rules don't apply to it
                    continue
                for url in url_re.findall(stripped):
                    host = url.split("//", 1)[1].split("/", 1)[0]
                    if host.startswith("["):  # bracketed IPv6
                        bare = host[1:].split("]", 1)[0]
                    else:
                        bare = host.split(":")[0]
                    if bare in (
                        "localhost", "127.0.0.1", "0.0.0.0", "::1",
                    ):
                        continue  # loopback is not egress
                    findings.append(
                        f"{rel}:{i}: external URL {url} — unreachable "
                        "in an air-gapped fleet"
                    )
                image = image_re.match(line)
                if image and "/" in image.group(1) and \
                        "." in image.group(1).split("/")[0]:
                    findings.append(
                        f"{rel}:{i}: image {image.group(1)} pulls from "
                        "an external registry"
                    )
    return findings


def main(argv: Optional[list] = None) -> int:
    """``python -m dcos_commons_tpu_torch package`` — build/inspect/install."""
    import argparse
    import sys
    import urllib.request

    parser = argparse.ArgumentParser(prog="dcos_commons_tpu_torch package")
    sub = parser.add_subparsers(dest="verb", required=True)
    p = sub.add_parser("build")
    p.add_argument("framework_dir")
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--name", default="")
    p.add_argument("--version", default="0.1.0")
    p.add_argument("--description", default="")
    p = sub.add_parser("inspect")
    p.add_argument("package")
    p = sub.add_parser("lint")
    p.add_argument("framework_dir")
    p = sub.add_parser(
        "publish",
        help="publish a built package into a registry "
             "(tools/publish_http.py + release_builder.py analogue)",
    )
    p.add_argument("package")
    p.add_argument(
        "--registry", required=True,
        help="registry directory path or HTTP URL",
    )
    p.add_argument("--token", default="", help="registry publish token")
    p = sub.add_parser(
        "registry-prune",
        help="retire old releases from a registry DIRECTORY: keep "
             "the newest K versions per package (release_builder "
             "lifecycle cleanup; runs on the registry host)",
    )
    p.add_argument("--dir", required=True, help="registry directory")
    p.add_argument(
        "--keep", type=int, required=True,
        help="newest versions to retain per package (>= 1)",
    )
    p.add_argument(
        "--name", default="",
        help="prune only this package (default: every package)",
    )
    p.add_argument(
        "--grace-s", type=float, default=0.0,
        help="seconds to keep a pruned artifact's bytes on disk "
             "(parked as .trash-<epoch>, out of the index) before a "
             "later prune unlinks it.  0 deletes immediately — on NFS "
             "a registry-serve client mid-fetch then gets truncated "
             "reads/stale handles, so either quiesce fetches or set a "
             "grace covering your slowest fetch",
    )
    p = sub.add_parser(
        "registry-serve",
        help="serve a registry directory over HTTP",
    )
    p.add_argument("--dir", required=True)
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--bind", default="127.0.0.1")
    p.add_argument("--token", default="",
                   help="bearer token required to publish")
    p.add_argument("--announce-file", default="")
    p = sub.add_parser("install")
    p.add_argument(
        "package",
        help="package tarball path, or a package NAME with --registry",
    )
    p.add_argument(
        "--url", required=True, help="multi scheduler API URL"
    )
    p.add_argument(
        "--registry", default="",
        help="resolve the package by name from this registry "
             "(dir path or HTTP URL) instead of a local tarball",
    )
    p.add_argument(
        "--package-version", default="",
        help="with --registry: install this version (default latest)",
    )
    p.add_argument("--token", default="", help="registry read token")
    p.add_argument(
        "--name", default="",
        help="service name (default: manifest name)",
    )
    p.add_argument(
        "--upgrade", action="store_true",
        help="push a new package version to a RUNNING service "
             "(Cosmos `update --package-version` analogue): validated "
             "config diff, rolling update over live state",
    )
    p.add_argument(
        "--options", default="",
        help="user options JSON file validated against the package's "
             "options.json (Cosmos `--options` analogue); on upgrade, "
             "prior options are kept and these overlay them",
    )
    args = parser.parse_args(argv)

    try:
        return _run_verb(args)
    except PackageError as e:
        print(f"package error: {e}", file=sys.stderr)
        return 1


def _run_verb(args) -> int:
    import json
    import sys
    import urllib.request

    if args.verb == "build":
        manifest = build_package(
            args.framework_dir, args.out,
            name=args.name, version=args.version,
            description=args.description,
        )
        print(json.dumps(
            {k: manifest[k] for k in ("name", "version")}
            | {"files": len(manifest["files"]), "out": args.out}
        ))
        return 0
    if args.verb == "inspect":
        print(json.dumps(read_manifest(args.package), indent=2))
        return 0
    if args.verb == "lint":
        findings = lint_airgap(args.framework_dir)
        # the options schema lints with the same verb: a package whose
        # defaults violate their own constraints must not ship
        from dcos_commons_tpu_torch.tools.options import options_findings

        findings += options_findings(args.framework_dir)
        for finding in findings:
            print(finding)
        if findings:
            print(f"{len(findings)} finding(s)", file=sys.stderr)
            return 1
        print("lint clean")
        return 0
    if args.verb == "publish":
        from dcos_commons_tpu_torch.tools.registry import publish_package

        out = publish_package(
            args.package, args.registry, token=args.token
        )
        print(json.dumps(out))
        return 0
    if args.verb == "registry-prune":
        from dcos_commons_tpu_torch.tools.registry import prune_registry

        pruned = prune_registry(
            args.dir, args.keep, name=args.name, grace_s=args.grace_s
        )
        print(json.dumps({"pruned": pruned}))
        return 0
    if args.verb == "registry-serve":
        from dcos_commons_tpu_torch.tools.registry import RegistryServer

        server = RegistryServer(
            args.dir, port=args.port, bind=args.bind,
            auth_token=args.token,
        ).start()
        print(f"registry serving {args.dir} at {server.url}", flush=True)
        if args.announce_file:
            tmp = args.announce_file + ".tmp"
            with open(tmp, "w") as f:
                f.write(server.url)
            os.replace(tmp, args.announce_file)
        import signal
        import threading as _threading

        stop = _threading.Event()
        signal.signal(signal.SIGTERM, lambda *_: stop.set())
        signal.signal(signal.SIGINT, lambda *_: stop.set())
        stop.wait()
        server.stop()
        return 0
    # install: the tarball travels to the scheduler (Cosmos analogue),
    # from a local build or resolved + digest-verified out of a registry
    if getattr(args, "registry", ""):
        from dcos_commons_tpu_torch.tools.registry import fetch_package

        version, payload = fetch_package(
            args.registry, args.package,
            version=getattr(args, "package_version", ""),
            token=args.token,
        )
        name = args.name or args.package
        print(f"resolved {args.package} {version} from registry",
              file=sys.stderr)
    else:
        with open(args.package, "rb") as f:
            payload = f.read()
        name = args.name or read_manifest(args.package)["name"]
    suffix = "?upgrade=true" if getattr(args, "upgrade", False) else ""
    headers = {"Content-Type": "application/gzip"}
    if getattr(args, "options", ""):
        import base64 as _b64

        with open(args.options, "r", encoding="utf-8") as f:
            try:
                options = json.load(f)
            except ValueError as e:
                print(f"bad options file {args.options}: {e}",
                      file=sys.stderr)
                return 1
        headers["X-Service-Options"] = _b64.b64encode(
            json.dumps(options).encode("utf-8")
        ).decode("ascii")
    req = urllib.request.Request(
        f"{args.url.rstrip('/')}/v1/multi/{name}{suffix}",
        data=payload,
        method="PUT",
        headers=headers,
    )
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            print(resp.read().decode("utf-8"))
    except urllib.error.HTTPError as e:
        print(e.read().decode("utf-8"), file=sys.stderr)
        return 1
    except urllib.error.URLError as e:
        print(f"scheduler unreachable at {args.url}: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Operator tooling: packaging and distribution, and the options schema
a framework's YAMLs render with.

Reference: tools/universe/ (package_builder.py / package_manager.py /
package_publisher.py) + the Cosmos install flow — a framework is
bundled (svc.yml + templates + scripts + manifest), published to a
catalog, and installed by name.  The package tarball travels TO the
scheduler (PUT /v1/multi/<name> with a gzip body), which extracts it
into its packages dir and serves the bundled config templates itself —
no external catalog service required.

Port of ``dcos_commons_tpu/tools/__init__.py``, line for line but the
imports.
"""

from dcos_commons_tpu_torch.tools.packaging import (
    PackageError,
    build_package,
    extract_package,
    read_manifest,
)
from dcos_commons_tpu_torch.tools.registry import (
    RegistryServer,
    fetch_package,
    prune_registry,
    publish_package,
    registry_index,
)

__all__ = [
    "PackageError",
    "RegistryServer",
    "build_package",
    "extract_package",
    "fetch_package",
    "prune_registry",
    "publish_package",
    "read_manifest",
    "registry_index",
]

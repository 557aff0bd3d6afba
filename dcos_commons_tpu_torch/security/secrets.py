"""Secret providers: where secret refs in a ServiceSpec resolve from.

Reference: dcos/clients/SecretsClient.java — the reference fetches
secret values from the DC/OS secrets service by path.  Here the
scheduler resolves each ref through a pluggable provider at launch
time and ships the VALUE to the agent as a 0600 sandbox file or an
env var; the value never touches the state store, logs, or the
artifacts endpoint.

Port of ``dcos_commons_tpu/security/secrets.py``, line for line but the imports.
"""

from __future__ import annotations

import os
from abc import ABC, abstractmethod
from typing import Dict


class SecretNotFound(Exception):
    def __init__(self, source: str):
        super().__init__(f"secret not found: {source!r}")
        self.source = source


class SecretsProvider(ABC):
    @abstractmethod
    def fetch(self, source: str) -> bytes:
        """Value for ``source``; raises SecretNotFound."""


class FileSecretsProvider(SecretsProvider):
    """Secrets from an operator-managed directory tree: the secret ref
    ``app/password`` reads ``<root>/app/password``.  Path traversal in
    refs is rejected."""

    def __init__(self, root: str):
        self._root = os.path.realpath(root)

    def fetch(self, source: str) -> bytes:
        path = os.path.realpath(os.path.join(self._root, source.lstrip("/")))
        if not path.startswith(self._root + os.sep):
            raise SecretNotFound(source)
        try:
            with open(path, "rb") as f:
                return f.read()
        except OSError:
            raise SecretNotFound(source)


class InMemorySecretsProvider(SecretsProvider):
    """Tests / sim harness."""

    def __init__(self, values: Dict[str, bytes]):
        self._values = dict(values)

    def fetch(self, source: str) -> bytes:
        try:
            return self._values[source]
        except KeyError:
            raise SecretNotFound(source)

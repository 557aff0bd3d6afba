"""Operator CLI (T2): the ``dcos <svc> ...`` subcommand equivalent.

Reference: cli/ (Go) — sections plan/pod/config/state/endpoints/debug
(cli/commands.go:39,56; plan verbs incl. pause/resume/force-restart/
force-complete, cli/commands/plan.go:51-90) speaking HTTP to the
scheduler API.  Invoke as ``python -m dcos_commons_tpu_torch.cli`` with the
scheduler URL from ``--url`` or ``$SCHEDULER_API_URL``.

Port of ``dcos_commons_tpu/cli/__init__.py``, line for line but the imports.
"""

from dcos_commons_tpu_torch.cli.client import ApiClient, CliError
from dcos_commons_tpu_torch.cli.commands import build_parser, main

__all__ = ["ApiClient", "CliError", "build_parser", "main"]

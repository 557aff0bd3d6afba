"""Process entrypoints for the framework.

    python -m dcos_commons_tpu_torch serve svc.yml --topology cluster.yml
    python -m dcos_commons_tpu_torch agent --host-id h0 --workdir ./sandbox
    python -m dcos_commons_tpu_torch cli  <verb> ...
    python -m dcos_commons_tpu_torch state-server --data-dir ./cluster-state
    python -m dcos_commons_tpu_torch analyze            # static analysis: lint | specs | plan | shard | dur | all

Reference: the pair of process mains the reference ships — the
scheduler process (SchedulerRunner.java:82 via each framework's
Main.java) and the task-side bootstrap (sdk/bootstrap/main.go:466) —
plus the operator CLI binary (sdk/cli/main.go:1-12).

Port of ``dcos_commons_tpu/__main__.py``, line for line but the imports
and the analyzers ``analyze`` runs.
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__.strip())
        return 0 if argv else 1
    command, rest = argv[0], argv[1:]
    if command == "serve":
        from dcos_commons_tpu_torch.runtime.runner import serve_main

        return serve_main(rest)
    if command == "agent":
        from dcos_commons_tpu_torch.agent.daemon import main as agent_main

        return agent_main(rest)
    if command == "cli":
        from dcos_commons_tpu_torch.cli.commands import main as cli_main

        return cli_main(rest)
    if command == "state-server":
        from dcos_commons_tpu_torch.storage.remote import main as state_main

        return state_main(rest)
    if command == "package":
        from dcos_commons_tpu_torch.tools.packaging import main as package_main

        return package_main(rest)
    if command == "certs":
        from dcos_commons_tpu_torch.security.auth import certs_main

        return certs_main(rest)
    if command in ("analyze", "lint"):
        # the port's analyzers: lint, specs, plan, shard, dur, all
        # (same entry point as `python -m dcos_commons_tpu_torch.analysis`;
        # `analyze` with no arguments runs all of them)
        from dcos_commons_tpu_torch.analysis.__main__ import main as analysis_main

        return analysis_main(rest)
    print(
        f"unknown command {command!r}; "
        "try serve | agent | cli | state-server | package | certs "
        "| analyze",
        file=sys.stderr,
    )
    return 1


if __name__ == "__main__":
    sys.exit(main())

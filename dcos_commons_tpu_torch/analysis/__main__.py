"""shardcheck CLI: ``python -m dcos_commons_tpu_torch.analysis shard``.

The ``shard`` subcommand of the JAX package's analysis CLI
(``python -m dcos_commons_tpu.analysis shard``) over the port's
framework directory, with its flags:

    --json              one machine-readable JSON document on stdout
                        (shard.findings, shard.footprint / shard.cost
                        per analyzed pod)
    --root DIR          repo root (default: the one holding this package)
    --hbm-mb N          per-card memory budget override (0 = the
                        generation table)
    --giant-mb N        replicated-param finding threshold (default 256)
    --steplog PATH      compare a worker steplog.jsonl against each
                        train workload's shard.cost wire-time model
    --step-floor-us N   calibrated compute floor added to the wire model
    --step-slack X      allowed measured-over-floor headroom (0.25)
    --catalog           print the rule catalog and exit
    --verbose, -v       also list suppressed findings

Exit code 1 when a finding (or a steplog regression) is reported.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional


def _default_root() -> str:
    """The repo root: the directory holding this package."""
    return os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv: Optional[List[str]] = None) -> int:
    from dcos_commons_tpu_torch.analysis import shardcheck

    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "shard":
        argv = argv[1:]
    parser = argparse.ArgumentParser(
        prog="python -m dcos_commons_tpu_torch.analysis shard",
        description=__doc__.splitlines()[0],
    )
    parser.add_argument("--json", action="store_true", dest="as_json")
    parser.add_argument("--catalog", action="store_true")
    parser.add_argument("--root", default=_default_root())
    parser.add_argument("--hbm-mb", type=int, default=0)
    parser.add_argument("--giant-mb", type=float, default=256.0)
    parser.add_argument(
        "--steplog", default="",
        help="worker steplog.jsonl: compare measured step time against "
             "each train workload's shard.cost wire-time model",
    )
    parser.add_argument(
        "--step-floor-us", type=float, default=0.0,
        help="calibrated compute floor (us) added to the wire model; "
             "0 leaves the comparison ungated on collective-free meshes",
    )
    parser.add_argument(
        "--step-slack", type=float, default=0.25,
        help="allowed measured-over-floor headroom before the steplog "
             "comparison counts as a regression (0.25 = +25%%)",
    )
    parser.add_argument(
        "--verbose", "-v", action="store_true",
        help="also list suppressed findings",
    )
    args = parser.parse_args(argv)

    if args.catalog:
        print(shardcheck.shard_rule_catalog())
        return 0

    def emit(line: str) -> None:
        if not args.as_json:
            print(line)

    result = shardcheck.analyze_all(
        os.path.abspath(args.root), hbm_mb=args.hbm_mb,
        giant_mb=args.giant_mb,
    )
    for finding in result.findings:
        emit(finding.render())
    if args.verbose:
        for finding in result.suppressed:
            emit(f"{finding.render()}  [suppressed]")
    emit(
        f"shard: {result.files_checked} files, "
        f"{len(result.findings)} finding(s), "
        f"{len(result.suppressed)} suppressed"
    )
    failed = bool(result.findings)
    doc = {"shard": {
        "files_checked": result.files_checked,
        "findings": [f.to_dict() for f in result.findings],
        "suppressed": len(result.suppressed),
        "footprint": {
            r.key: dict(r.footprint, mesh=r.mesh, script=r.script)
            for r in result.reports
        },
        "cost": {
            r.key: r.cost for r in result.reports if r.cost is not None
        },
    }}
    for r in result.reports:
        emit(f"{r.key}: {r.script} on {r.chips} card(s) {r.mesh}: "
             f"{r.footprint['per_chip_mb']} MB a card "
             f"{r.footprint['sections_mb']}")
    if args.steplog:
        # predicted-vs-measured step time: an explicit comparison that
        # regresses past the slack fails the run
        from dcos_commons_tpu_torch.trace.steplog import read_steplog

        records = read_steplog(args.steplog)
        doc["shard"]["stepcompare"] = {}
        for r in result.reports:
            if r.cost is None:
                continue
            comparison = shardcheck.stepcompare(
                r.cost, records, floor_us=args.step_floor_us,
                slack=args.step_slack,
            )
            doc["shard"]["stepcompare"][r.key] = comparison
            emit(
                f"stepcompare {r.key}: measured p50 "
                f"{comparison['measured_p50_us']}us vs floor "
                f"{comparison['predicted_floor_us']}us "
                f"(wire {comparison['predicted_wire_us']}us), "
                f"regression={comparison['regression']}"
            )
            failed |= comparison["regression"] is True
    rc = 1 if failed else 0
    if args.as_json:
        doc["exit_code"] = rc
        print(json.dumps(doc, indent=2, sort_keys=True))
    return rc


if __name__ == "__main__":
    sys.exit(main())

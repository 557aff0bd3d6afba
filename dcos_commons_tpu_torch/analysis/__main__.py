"""sdklint CLI: ``python -m dcos_commons_tpu_torch.analysis <command>``.

Port of ``dcos_commons_tpu/analysis/__main__.py`` over the port's
tree, every analyzer of the reference.  Commands (also reachable as
``python -m dcos_commons_tpu_torch analyze``):

    lint     framework lint (AST rules + baseline)
    specs    ahead-of-time spec analyzer (the port's frameworks/)
    spmd     SPMD collective-safety analyzer (cross-rank divergence)
    plan     plan state-machine model checker (exhaustive BFS)
    shard    static sharding / card-memory footprint / collective-cost
             analyzer
    race     thread-ownership / happens-before race analyzer (static
             half; the dynamic half is racecheck.install())
    config   env/config contract analyzer (options.json ⇄ YAML
             templates ⇄ task env ⇄ worker/SDK reads)
    dur      crash-consistency / durability-ordering analyzer
             (WAL-before-effect, replay parity, fence coverage,
             atomic pairs, file discipline + the persistence-point
             map the chaos harness auto-derives kill points from)
    all      every analyzer above — the CI gate; default when no
             command given

Flag spelling (``--lint``/.../``--dur``/``--all``) is accepted too,
composably: ``--lint --dur`` runs exactly those two.

Options:
    --json              one machine-readable JSON document on stdout
                        (findings per analyzer, plan.states_explored,
                        shard.footprint / shard.cost per analyzed pod,
                        dur.persistence_points / dur.per_kind,
                        race.shared_attrs / race.roles,
                        config.env_vars / config.flows / config.per_rule)
    --docs              render the config flow graph to
                        docs/config-reference-torch.md (implies config)
    --points            dump the durcheck persistence-point map as a
                        JSON document and exit (for the chaos harness)
    --update-baseline   rewrite the baseline from current
                        lint+spmd+shard+race+config+dur findings
    --catalog           print the rule catalogs and exit
    --root DIR          repo root (default: the one holding this package)
    --baseline PATH     baseline file (default: .sdklint-torch-baseline.json
                        at the root)
    --plan-max-states N cap per plancheck configuration (default 200000)
    --hbm-mb N          per-card memory budget override (0 = the
                        generation table)
    --giant-mb N        replicated-param finding threshold (default 256)
    --steplog PATH      compare a worker steplog.jsonl against each
                        train workload's shard.cost wire-time model
                        (predicted-vs-measured step time; a regression
                        past --step-slack fails the run)
    --step-floor-us N   calibrated compute floor added to the wire model
    --step-slack F      allowed measured-over-floor headroom (default 0.25)
    --host-cpus N       host shape the spec feasibility checks assume
    --host-mem MB       (defaults: a ``GpuHost``'s 8 cpus, 16384 MB,
    --host-disk MB      102400 MB)
    --verbose/-v        also list suppressed and baselined findings

Exit code 0 = no non-baselined findings and no plan violations;
1 = findings; 2 = bad usage.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

_COMMANDS = (
    "lint", "specs", "spmd", "plan", "shard", "race", "config", "dur",
    "all",
)


def _default_root() -> str:
    """The repo root: the directory holding this package."""
    return os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv: Optional[List[str]] = None) -> int:
    from dcos_commons_tpu_torch.analysis import baseline as baseline_mod
    from dcos_commons_tpu_torch.analysis import (
        configcheck,
        durcheck,
        plancheck,
        racecheck,
        shardcheck,
        speccheck,
        spmdcheck,
    )
    from dcos_commons_tpu_torch.analysis.configcheck import config_rule_catalog
    from dcos_commons_tpu_torch.analysis.durcheck import dur_rule_catalog
    from dcos_commons_tpu_torch.analysis.linter import lint_tree
    from dcos_commons_tpu_torch.analysis.racecheck import race_rule_catalog
    from dcos_commons_tpu_torch.analysis.rules import rule_catalog
    from dcos_commons_tpu_torch.analysis.shardcheck import shard_rule_catalog
    from dcos_commons_tpu_torch.analysis.spmdcheck import spmd_rule_catalog

    argv = list(sys.argv[1:] if argv is None else argv)
    # subcommand spelling -> the equivalent mode flag
    if argv and argv[0] in _COMMANDS:
        argv[0] = f"--{argv[0]}"

    parser = argparse.ArgumentParser(
        prog="python -m dcos_commons_tpu_torch.analysis",
        description=__doc__.splitlines()[0],
    )
    parser.add_argument("--lint", action="store_true")
    parser.add_argument("--specs", action="store_true")
    parser.add_argument("--spmd", action="store_true")
    parser.add_argument("--plan", action="store_true")
    parser.add_argument("--shard", action="store_true")
    parser.add_argument("--race", action="store_true")
    parser.add_argument("--config", action="store_true")
    parser.add_argument("--dur", action="store_true")
    parser.add_argument("--all", action="store_true")
    parser.add_argument(
        "--docs", action="store_true",
        help="render the config flow graph to "
             "docs/config-reference-torch.md (implies --config)",
    )
    parser.add_argument(
        "--points", action="store_true",
        help="dump the durcheck persistence-point map as JSON and exit",
    )
    parser.add_argument("--json", action="store_true", dest="as_json")
    parser.add_argument("--update-baseline", action="store_true")
    parser.add_argument("--catalog", action="store_true")
    parser.add_argument("--root", default=_default_root())
    parser.add_argument("--baseline", default="")
    parser.add_argument("--plan-max-states", type=int, default=200_000)
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
    parser.add_argument("--host-cpus", type=float, default=8.0)
    parser.add_argument("--host-mem", type=int, default=16384)
    parser.add_argument("--host-disk", type=int, default=102400)
    parser.add_argument(
        "--verbose", "-v", action="store_true",
        help="also list suppressed and baselined findings",
    )
    args = parser.parse_args(argv)

    if args.catalog:
        print(rule_catalog())
        print()
        print(spmd_rule_catalog())
        print()
        print(shard_rule_catalog())
        print()
        print(race_rule_catalog())
        print()
        print(config_rule_catalog())
        print()
        print(dur_rule_catalog())
        return 0

    if args.points:
        # the machine contract: testing/chaos.py auto-derives its
        # crash-injection points from exactly this document
        points = durcheck.persistence_point_map(os.path.abspath(args.root))
        per_kind: dict = {}
        for point in points:
            per_kind[point["kind"]] = per_kind.get(point["kind"], 0) + 1
        print(json.dumps(
            {"persistence_points": points, "per_kind": per_kind},
            indent=2, sort_keys=True,
        ))
        return 0

    any_mode = (args.lint or args.specs or args.spmd or args.plan
                or args.shard or args.race or args.config
                or args.dur or args.docs)
    run_lint = args.lint or args.all or not any_mode
    run_specs = args.specs or args.all or not any_mode
    run_spmd = args.spmd or args.all or not any_mode
    run_plan = args.plan or args.all or not any_mode
    run_shard = args.shard or args.all or not any_mode
    run_race = args.race or args.all or not any_mode
    run_config = args.config or args.docs or args.all or not any_mode
    run_dur = args.dur or args.all or not any_mode
    root = os.path.abspath(args.root)
    baseline_path = args.baseline or baseline_mod.baseline_path(root)
    known = baseline_mod.load_baseline(baseline_path)
    doc: dict = {}
    failed = False

    def emit(line: str) -> None:
        if not args.as_json:
            print(line)

    # lint, spmd, shard, race, config and dur share the baseline file;
    # --update-baseline rewrites it from every result set that ran so
    # none clobbers the others' entries
    baseline_feed = []

    def run_findings_pass(name: str, result) -> None:
        nonlocal failed
        if args.update_baseline:
            baseline_feed.extend(result.findings)
            fresh, absorbed = [], result.findings
        else:
            fresh, absorbed = baseline_mod.apply_baseline(
                result.findings, known
            )
        for finding in fresh:
            emit(finding.render())
        if args.verbose:
            for finding in absorbed:
                emit(f"{finding.render()}  [baselined]")
            for finding in result.suppressed:
                emit(f"{finding.render()}  [suppressed]")
        emit(
            f"{name}: {result.files_checked} files, "
            f"{len(fresh)} finding(s), {len(absorbed)} baselined, "
            f"{len(result.suppressed)} suppressed"
        )
        doc[name] = {
            "files_checked": result.files_checked,
            "findings": [f.to_dict() for f in fresh],
            "baselined": len(absorbed),
            "suppressed": len(result.suppressed),
        }
        failed |= bool(fresh)

    if run_lint:
        run_findings_pass("lint", lint_tree(root))

    if run_spmd:
        run_findings_pass("spmd", spmdcheck.analyze_tree(root))

    if run_race:
        race_result = racecheck.analyze_tree(root)
        run_findings_pass("race", race_result)
        # trend keys: how much shared state the thread model carries
        doc["race"]["shared_attrs"] = sum(
            len(attrs) for attrs in race_result.shared_attrs.values()
        )
        doc["race"]["roles"] = len({
            role
            for roles in race_result.roles.values()
            for role in roles
        })
        doc["race"]["classes"] = {
            cls: {
                "shared_attrs": race_result.shared_attrs.get(cls, []),
                "roles": race_result.roles.get(cls, []),
            }
            for cls in sorted(
                set(race_result.shared_attrs) | set(race_result.roles)
            )
        }

    if run_shard:
        shard_result = shardcheck.analyze_all(
            root, hbm_mb=args.hbm_mb, giant_mb=args.giant_mb
        )
        run_findings_pass("shard", shard_result)
        doc["shard"]["footprint"] = {
            r.key: dict(r.footprint, mesh=r.mesh, script=r.script)
            for r in shard_result.reports
        }
        doc["shard"]["cost"] = {
            r.key: r.cost
            for r in shard_result.reports if r.cost is not None
        }
        for r in shard_result.reports:
            emit(f"{r.key}: {r.script} on {r.chips} card(s) {r.mesh}: "
                 f"{r.footprint['per_chip_mb']} MB a card "
                 f"{r.footprint['sections_mb']}")
        if args.steplog:
            # predicted-vs-measured step time: hold each train
            # workload's wire-time model against the worker's steplog;
            # an explicit comparison that regresses past the slack
            # fails the run — the operator asked for the gate by
            # passing --steplog
            from dcos_commons_tpu_torch.trace.steplog import read_steplog

            records = read_steplog(args.steplog)
            doc["shard"]["stepcompare"] = {}
            for r in shard_result.reports:
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

    if run_config:
        config_result = configcheck.analyze_all(root)
        run_findings_pass("config", config_result)
        # trend keys: how much of the env surface the graph covers
        doc["config"]["env_vars"] = len(config_result.env_vars)
        doc["config"]["flows"] = len(config_result.flows)
        doc["config"]["per_rule"] = dict(config_result.per_rule)
        if args.docs:
            docs_path = configcheck.write_config_reference(
                root, config_result
            )
            emit(f"docs: wrote {docs_path}")
            doc["config"]["docs_path"] = docs_path

    if run_dur:
        dur_result = durcheck.analyze_tree(root)
        run_findings_pass("dur", dur_result)
        # trend keys: the durability surface the chaos matrix covers
        doc["dur"]["persistence_points"] = len(
            dur_result.persistence_points
        )
        per_kind = {}
        for point in dur_result.persistence_points:
            per_kind[point.kind] = per_kind.get(point.kind, 0) + 1
        doc["dur"]["per_kind"] = per_kind
        doc["dur"]["per_rule"] = dict(dur_result.per_rule)

    if args.update_baseline:
        if not (run_lint or run_spmd or run_shard or run_race
                or run_config or run_dur):
            emit(
                "baseline: nothing to update — only lint, spmd, shard, "
                "race, config, and dur feed the baseline; run one of "
                "them"
            )
        else:
            # entries of a baseline-feeding pass that did NOT run
            # survive verbatim: `--lint --update-baseline` must not
            # erase triaged spmd/shard debt it never recomputed (and
            # vice versa)
            retain = {}
            for fp, count in known.items():
                rule = fp.rsplit("::", 1)[-1]
                if rule.startswith("spmd-"):
                    owner_ran = run_spmd
                elif rule.startswith("shard-"):
                    owner_ran = run_shard
                elif rule.startswith("race-"):
                    owner_ran = run_race
                elif rule.startswith("config-"):
                    owner_ran = run_config
                elif rule.startswith("dur-"):
                    owner_ran = run_dur
                else:
                    owner_ran = run_lint
                if not owner_ran:
                    retain[fp] = count
            counts = baseline_mod.save_baseline(
                baseline_path, baseline_feed, retain=retain
            )
            emit(
                f"baseline: {sum(counts.values())} finding(s) across "
                f"{len(counts)} file/rule pair(s) -> {baseline_path}"
            )

    if run_specs:
        host_model = speccheck.HostModel(
            cpus=args.host_cpus,
            memory_mb=args.host_mem,
            disk_mb=args.host_disk,
        )
        findings = speccheck.analyze_all(root, host_model)
        for finding in findings:
            emit(finding.render())
        emit(f"specs: {len(findings)} finding(s)")
        doc["specs"] = {
            "findings": [f.to_dict() for f in findings],
        }
        failed |= bool(findings)

    if run_plan:
        summary = plancheck.check_all(max_states=args.plan_max_states)
        emit(f"plan: {summary.states_explored} states explored")
        emit(summary.render())
        doc["plan"] = {
            "states_explored": summary.states_explored,
            "transitions": summary.transitions,
            "configs": {
                r.config: {
                    "states": r.states,
                    "transitions": r.transitions,
                    "complete_states": r.complete_states,
                    "truncated": r.truncated,
                    "livelock_checked": r.livelock_checked,
                    "violations": len(r.violations),
                }
                for r in summary.results
            },
            "violations": [
                {
                    "invariant": v.invariant,
                    "detail": v.detail,
                    "trace": list(v.trace),
                }
                for v in summary.violations
            ],
        }
        failed |= not summary.ok

    rc = 1 if failed else 0
    if args.as_json:
        doc["exit_code"] = rc
        print(json.dumps(doc, indent=2, sort_keys=True))
    return rc


if __name__ == "__main__":
    sys.exit(main())

"""Ahead-of-time spec analyzer: deploy-time failures at lint time.

Reference: the 19 config validators run when a target config is
SUBMITTED (specification/validation.py) — but by then the package is
built and the operator is mid-install.  This pass runs the same
validators plus placement/port/plan/resource feasibility over every
``svc*.yml`` of the port's framework directory
(``dcos_commons_tpu_torch/frameworks``) rendered with its
``options.json`` defaults, so a spec that cannot possibly deploy fails
in CI.

Checks, each with its own rule id (suppressible like lint rules,
``# sdklint: disable-file=<rule>`` in the YAML):

- ``spec-options``     options.json schema findings (tools/options)
- ``spec-render``      template/YAML/spec mapping errors
- ``spec-validators``  default config validators against old=None
- ``spec-placement``   constraints unsatisfiable on the declared node set
- ``spec-ports``       fixed-port conflicts within a pod / across count
- ``spec-plan``        unknown pods/tasks, bad strategies, dependency
                       cycles in plan phases
- ``spec-resources``   one pod instance exceeding any single host
- ``no-gpus-resource`` a ``gpus:`` key in the YAML (BASELINE invariant)

Port of ``dcos_commons_tpu/analysis/speccheck.py``, line for line but
the imports, ``pod.gpu`` for ``pod.tpu``, the messages that name the
``gpu:`` block and the node set, and ``analyze_all``, which walks the
port's one framework directory (as ``shardcheck.analyze_all`` does)
where the reference walks ``frameworks/*``.  The ``no-gpus-resource``
pattern stays a ``gpus:`` key at the start of a line: it does not
match the port's ``gpu:`` block, and the port's specs carry no
``gpus`` scalar.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from dcos_commons_tpu_torch.analysis.linter import Finding, Suppressions


@dataclass
class HostModel:
    """The host shape feasibility checks assume.  Defaults mirror
    ``GpuHost``'s (offer/inventory.py); override via CLI flags when
    your fleet is beefier."""

    cpus: float = 8.0
    memory_mb: int = 16384
    disk_mb: int = 102400


def _yml_files(framework_dir: str) -> List[str]:
    return sorted(
        os.path.join(framework_dir, f)
        for f in os.listdir(framework_dir)
        if f.endswith(".yml")
    )


FRAMEWORK_DIR = os.path.join("dcos_commons_tpu_torch", "frameworks")


def analyze_all(
    root: str, host_model: Optional[HostModel] = None
) -> List[Finding]:
    """Every YAML of the port's framework directory under ``root``."""
    framework_dir = os.path.join(root, FRAMEWORK_DIR)
    if not os.path.isdir(framework_dir):
        return []
    return analyze_framework(framework_dir, root, host_model)


def analyze_framework(
    framework_dir: str,
    root: str,
    host_model: Optional[HostModel] = None,
) -> List[Finding]:
    from dcos_commons_tpu_torch.tools import options as options_mod

    host_model = host_model or HostModel()
    findings: List[Finding] = []
    rel_dir = os.path.relpath(framework_dir, root).replace(os.sep, "/")

    schema = None
    disabled: set = set()
    try:
        schema = options_mod.load_schema(framework_dir)
        if schema is not None:
            # JSON carries no comments, so options.json suppresses via
            # a top-level key instead:  "x-sdklint-disable": ["rule"]
            # (framework-wide, like disable-file)
            disabled = {str(r) for r in schema.get("x-sdklint-disable") or []}
        for text in options_mod.validate_schema(schema) if schema else []:
            findings.append(Finding(
                f"{rel_dir}/options.json", 1, "spec-options", text
            ))
        env = options_mod.render_options(schema, {})
    except options_mod.OptionsError as e:
        findings += [
            Finding(f"{rel_dir}/options.json", 1, "spec-options", text)
            for text in e.errors
        ]
        env = {}

    for path in _yml_files(framework_dir):
        findings += _analyze_yaml(path, root, env, host_model)
    if disabled:
        findings = [
            f for f in findings
            if f.rule not in disabled and "all" not in disabled
        ]
    return findings


def _analyze_yaml(
    path: str, root: str, env: Dict[str, str], host_model: HostModel
) -> List[Finding]:
    from dcos_commons_tpu_torch.specification.yaml_spec import from_yaml_file

    rel = os.path.relpath(path, root).replace(os.sep, "/")
    with open(path, "r", encoding="utf-8") as f:
        lines = f.read().splitlines()
    spec, render_error = render_spec(rel, lambda: from_yaml_file(path, env))
    return check_spec_lines(rel, lines, spec, render_error, host_model)


def render_spec(rel: str, render):
    """Run one spec-render callable, classifying failures into the
    ``spec-render`` Finding shape BOTH enforcement points share — the
    CI walker above and the admission gate (multi/admission.py).  One
    classifier, so a future special-cased exception type cannot give
    CI and a 422 body divergent wordings for the same failure."""
    from dcos_commons_tpu_torch.specification.specs import SpecError

    try:
        return render(), None
    except SpecError as e:
        return None, Finding(rel, 1, "spec-render", str(e))
    except Exception as e:
        return None, Finding(
            rel, 1, "spec-render", f"{type(e).__name__}: {e}"
        )


def check_spec_lines(
    rel: str,
    lines: Sequence[str],
    spec,
    render_error: Optional[Finding] = None,
    host_model=None,
    apply_suppressions: bool = True,
    feasibility_hint: str = " (--host-cpus/--host-mem/--host-disk to raise)",
) -> List[Finding]:
    """Every spec-level check over an ALREADY-RENDERED spec + its
    source lines.  Shared by the CI walker above and the dynamic
    add-service admission gate (multi/admission.py) — one rule set,
    two enforcement points.  ``host_model`` may be one HostModel (the
    CI walker's hypothetical fleet) or a LIST of them (admission's
    real per-host shapes): a pod is infeasible only when it fits NONE
    of them — per-dimension maxima across different hosts would admit
    specs no single host can run.  An EMPTY list means the fleet is
    unknown (admission with no up hosts): feasibility is skipped
    entirely rather than judged against the CI default shape.
    ``apply_suppressions=False`` is the admission gate's setting:
    suppression comments live in the operator-submitted payload
    there, so honoring them would let any payload waive its own
    rejection.  ``feasibility_hint`` tails the spec-resources message
    so each enforcement point names its own remediation."""
    if host_model is None:
        host_models = [HostModel()]
    elif isinstance(host_model, HostModel):
        host_models = [host_model]
    else:
        host_models = list(host_model)
    raw_findings: List[Finding] = []
    raw_findings += _check_gpus_keys(rel, lines)
    if render_error is not None:
        raw_findings.append(render_error)
    if spec is not None:
        anchor = _make_anchor(lines)
        raw_findings += _check_validators(rel, spec)
        raw_findings += _check_placement(rel, spec, anchor)
        raw_findings += _check_ports(rel, spec, anchor)
        raw_findings += _check_plans(rel, spec, anchor)
        if host_models:
            raw_findings += _check_resources(
                rel, spec, host_models, anchor, feasibility_hint
            )
    if not apply_suppressions:
        return raw_findings
    suppressions = Suppressions(lines)
    return [f for f in raw_findings if not suppressions.covers(f)]


def _make_anchor(lines: Sequence[str]):
    """Line of the first ``<name>:`` key in the YAML, so pod/plan
    findings land on (and are suppressible at) the declaring line;
    1 when not found."""
    def anchor(name: str) -> int:
        pattern = re.compile(rf"^\s*{re.escape(str(name))}\s*:")
        for i, text in enumerate(lines, start=1):
            if pattern.match(text):
                return i
        return 1
    return anchor


def _check_gpus_keys(rel: str, lines: Sequence[str]) -> List[Finding]:
    out = []
    for i, text in enumerate(lines, start=1):
        if re.match(r"^\s*gpus\s*:", text):
            out.append(Finding(
                rel, i, "no-gpus-resource",
                "`gpus:` key: accelerators are the pod-level gpu: "
                "block (BASELINE invariant)",
            ))
    return out


def _check_validators(rel: str, spec) -> List[Finding]:
    from dcos_commons_tpu_torch.specification.validation import (
        ConfigValidationError,
        validate_spec_change,
    )

    try:
        validate_spec_change(None, spec)
    except ConfigValidationError as e:
        return [
            Finding(rel, 1, "spec-validators", text) for text in e.errors
        ]
    return []


def _conjunctive_rules(rule) -> List:
    """The rules that must ALL pass: the root plus AndRule members,
    recursively.  Or/Not branches are skipped — no unsatisfiability
    conclusion is safe through them."""
    from dcos_commons_tpu_torch.offer.placement import AndRule

    if isinstance(rule, AndRule):
        out = []
        for child in rule.rules:
            out += _conjunctive_rules(child)
        return out
    return [rule]


def _implied_hosts(pod) -> Optional[int]:
    """Host count the pod's own gpu block declares, or None (CPU pods
    run on an unknown fleet)."""
    gpu = pod.gpu
    if gpu is None or not gpu.topology:
        return None
    per_host = gpu.chips_per_host
    if per_host <= 0 or gpu.total_chips % per_host:
        return None  # gang_pods_need_topology reports this shape
    return (gpu.total_chips // per_host) * max(gpu.slices, 1)


def _check_placement(rel: str, spec, anchor) -> List[Finding]:
    from dcos_commons_tpu_torch.offer.placement import (
        FieldMatchRule,
        MaxPerRule,
        parse_placement,
    )

    out = []
    for pod in spec.pods:
        try:
            rule = parse_placement(pod.placement)
        except ValueError:
            continue  # spec-validators already reports the parse error
        hosts = _implied_hosts(pod)
        for term in _conjunctive_rules(rule):
            if isinstance(term, MaxPerRule):
                if term.max_count <= 0:
                    out.append(Finding(
                        rel, anchor(pod.type), "spec-placement",
                        f"pod {pod.type!r}: max-per-{term.field_name}:"
                        f"{term.max_count} excludes every host",
                    ))
                elif (
                    term.field_name == "hostname"
                    and hosts is not None
                    and term.max_count * hosts < pod.count
                ):
                    out.append(Finding(
                        rel, anchor(pod.type), "spec-placement",
                        f"pod {pod.type!r}: count {pod.count} cannot fit "
                        f"max-per-hostname:{term.max_count} on the "
                        f"declared node set's {hosts} host(s)",
                    ))
            elif (
                isinstance(term, FieldMatchRule)
                and term.field_name == "generation"
                and not term.regex
                and not term.invert
                and pod.gpu is not None
                and pod.gpu.generation not in term.values
            ):
                out.append(Finding(
                    rel, anchor(pod.type), "spec-placement",
                    f"pod {pod.type!r}: placement requires generation "
                    f"{term.values} but the pod declares "
                    f"{pod.gpu.generation!r} — no host satisfies both",
                ))
    return out


def _check_ports(rel: str, spec, anchor) -> List[Finding]:
    out = []
    for pod in spec.pods:
        fixed: Dict[int, str] = {}
        for task in pod.tasks:
            for port in task.resources.ports:
                if not port.port:
                    continue
                where = f"{pod.type}/{task.name}:{port.name}"
                if port.port in fixed:
                    out.append(Finding(
                        rel, anchor(pod.type), "spec-ports",
                        f"fixed port {port.port} requested by both "
                        f"{fixed[port.port]} and {where}; one pod "
                        "instance's tasks share a host",
                    ))
                else:
                    fixed[port.port] = where
        if fixed and pod.count > 1 and \
                "max-per-host" not in (pod.placement or ""):
            ports = sorted(fixed)
            out.append(Finding(
                rel, anchor(pod.type), "spec-ports",
                f"pod {pod.type!r}: count {pod.count} with fixed "
                f"port(s) {ports} but no max-per-host placement — "
                "co-located instances would collide",
            ))
    return out


def _check_plans(rel: str, spec, anchor) -> List[Finding]:
    from dcos_commons_tpu_torch.plan.generator import dependency_cycle
    from dcos_commons_tpu_torch.plan.strategy import strategy_for_name

    out = []
    pod_types = {p.type: p for p in spec.pods}
    for plan_name, raw_plan in (spec.plans or {}).items():
        raw_plan = raw_plan or {}
        try:
            strategy_for_name(str(raw_plan.get("strategy", "serial")))
        except ValueError as e:
            out.append(Finding(
                rel, anchor(plan_name), "spec-plan", f"plan {plan_name!r}: {e}"
            ))
        phases = raw_plan.get("phases") or {}
        edges: Dict[str, List[str]] = {}
        for phase_name, raw_phase in phases.items():
            raw_phase = raw_phase or {}
            where = f"plan {plan_name!r} phase {phase_name!r}"
            deps = [str(d) for d in raw_phase.get("dependencies") or []]
            edges[str(phase_name)] = deps
            for dep in deps:
                if dep not in phases:
                    out.append(Finding(
                        rel, anchor(plan_name), "spec-plan",
                        f"{where}: dependency {dep!r} names no phase "
                        f"of this plan (have: {sorted(map(str, phases))})",
                    ))
            pod_name = raw_phase.get("pod")
            if not pod_name or str(pod_name) not in pod_types:
                out.append(Finding(
                    rel, anchor(plan_name), "spec-plan",
                    f"{where}: pod {pod_name!r} is not declared "
                    f"(have: {sorted(pod_types)})",
                ))
                continue
            pod = pod_types[str(pod_name)]
            task_names = {t.name for t in pod.tasks}
            for entry in raw_phase.get("steps") or []:
                if not isinstance(entry, dict) or len(entry) != 1:
                    out.append(Finding(
                        rel, anchor(plan_name), "spec-plan",
                        f"{where}: each step must be one "
                        "{index: [[tasks...]]} mapping",
                    ))
                    continue
                ((raw_index, task_groups),) = entry.items()
                if str(raw_index) != "default":
                    try:
                        index = int(raw_index)
                    except (TypeError, ValueError):
                        out.append(Finding(
                            rel, anchor(plan_name), "spec-plan",
                            f"{where}: step index {raw_index!r} is not "
                            "an integer or 'default'",
                        ))
                        continue
                    if not 0 <= index < pod.count:
                        out.append(Finding(
                            rel, anchor(plan_name), "spec-plan",
                            f"{where}: step index {index} out of range "
                            f"for pod {pod.type!r} (count {pod.count})",
                        ))
                for group in task_groups or []:
                    for task_name in group or []:
                        if str(task_name) not in task_names:
                            out.append(Finding(
                                rel, anchor(plan_name), "spec-plan",
                                f"{where}: step task {task_name!r} not "
                                f"in pod {pod.type!r} "
                                f"(have: {sorted(task_names)})",
                            ))
        edges = {k: v for k, v in edges.items() if v}
        if edges and "strategy" in raw_plan:
            out.append(Finding(
                rel, anchor(plan_name), "spec-plan",
                f"plan {plan_name!r}: explicit 'strategy' conflicts "
                "with phase 'dependencies' (the DAG defines the "
                "order; drop one)",
            ))
        cycle = dependency_cycle(edges)
        if cycle:
            out.append(Finding(
                rel, anchor(plan_name), "spec-plan",
                f"plan {plan_name!r}: phase dependency cycle "
                + " -> ".join(cycle),
            ))
    return out


def _check_resources(
    rel: str, spec, host_models: Sequence[HostModel], anchor,
    hint: str = "",
) -> List[Finding]:
    out = []
    for pod in spec.pods:
        cpus = sum(t.resources.cpus for t in pod.tasks)
        mem = sum(t.resources.memory_mb for t in pod.tasks)
        disk = sum(t.resources.disk_mb for t in pod.tasks)
        # one durable dir per instance+path: sibling tasks sharing a
        # container path share the volume, so dedupe by path
        vol_by_path: Dict[str, int] = {}
        for task in pod.tasks:
            for vol in task.volumes:
                vol_by_path[vol.container_path] = max(
                    vol_by_path.get(vol.container_path, 0), vol.size_mb
                )
        disk += sum(vol_by_path.values())
        # feasible iff SOME host shape fits every dimension; report
        # the closest fit's shortfalls when none does
        best_over: Optional[List[str]] = None
        for model in host_models:
            over = []
            if cpus > model.cpus:
                over.append(f"cpus {cpus} > {model.cpus}")
            if mem > model.memory_mb:
                over.append(f"memory {mem}MB > {model.memory_mb}MB")
            if disk > model.disk_mb:
                over.append(f"disk {disk}MB > {model.disk_mb}MB")
            if not over:
                best_over = None
                break
            if best_over is None or len(over) < len(best_over):
                best_over = over
        if best_over:
            out.append(Finding(
                rel, anchor(pod.type), "spec-resources",
                f"pod {pod.type!r}: one instance needs "
                + ", ".join(best_over)
                + " — exceeds any single host" + hint,
            ))
    return out

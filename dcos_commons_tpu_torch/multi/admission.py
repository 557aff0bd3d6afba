"""Admission control for the dynamic add-service path.

Reference: the Cosmos/ServiceStore flow accepts any payload and lets
the deploy fail later; here the analyzers that already gate CI
(speccheck's spec checks, shardcheck's mesh derivation) run as
PRODUCTION guardrails: ``PUT /v1/multi/<name>`` validates the spec
BEFORE ``ServiceStore`` persists anything, and a rejected spec
returns 422 with the same line-anchored findings the CLI would print.

Scope: every speccheck spec-level rule (validators, placement
feasibility, port conflicts, plan shape, per-host resources, gpus
vocabulary) plus — when the spec targets a torch workload (a GPU pod
whose task cmd matches a shardcheck profile) — the mesh-derivation
half of shardcheck: the declared topology must derive a MeshSpec and
the mesh must span exactly the chips the spec reserves.  The full
eval_shape footprint analysis stays in CI; admission must answer in
request time.

Port of ``dcos_commons_tpu/multi/admission.py``, line for line but the
imports, ``pod.gpu`` where the reference reads ``pod.tpu``, and
``_targets_torch_profile`` for the reference's ``_targets_jax``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from dcos_commons_tpu_torch.analysis.linter import Finding


# tails spec-resources rejections on THIS enforcement point: the CI
# walker's --host-cpus/--host-mem/--host-disk flags do not exist for
# an operator PUTting a spec — their remediation is the fleet itself
_FEASIBILITY_HINT = " (no up host fits; add larger hosts or shrink the pod)"


class AdmissionError(Exception):
    """A spec refused by admission control; carries the findings the
    HTTP layer serializes into the 422 body."""

    def __init__(self, findings: List[Finding]):
        super().__init__(
            f"{len(findings)} admission finding(s): "
            + "; ".join(f.render() for f in findings[:3])
        )
        self.findings = findings


def host_models_for(inventory) -> list:
    """Feasibility host models from the LIVE fleet: one per DISTINCT
    up-host shape.  speccheck's CI walker assumes a default shape (it
    has no fleet); admission knows the real ones — a spec sized for
    this fleet's hosts must not be rejected against a smaller
    hypothetical, and a pod is feasible only if SOME actual shape
    fits it (per-dimension maxima across different hosts would build
    a composite host that exists nowhere).  EMPTY when no hosts are
    up (scheduler bootstrap, transient fleet outage): feasibility is
    then SKIPPED rather than judged against the CI default shape —
    registration must not depend on fleet availability; the deploy
    plan simply waits for hosts."""
    from dcos_commons_tpu_torch.analysis.speccheck import HostModel

    hosts = inventory.up_hosts() if inventory is not None else []
    shapes = sorted({(h.cpus, h.memory_mb, h.disk_mb) for h in hosts})
    return [
        HostModel(cpus=c, memory_mb=m, disk_mb=d) for c, m, d in shapes
    ]


def validate_service_yaml(
    text: str, name: str, inventory=None
) -> Tuple[Optional[object], List[Finding]]:
    """Render + validate one service YAML body.  Returns the rendered
    spec (None when it cannot render) and every finding; an empty
    finding list means the spec is admitted UNCHANGED — admission
    never rewrites what the operator sent."""
    from dcos_commons_tpu_torch.analysis.speccheck import (
        check_spec_lines,
        render_spec,
    )
    from dcos_commons_tpu_torch.specification.yaml_spec import from_yaml

    rel = f"{name}.yml"
    lines = text.splitlines()
    spec, render_error = render_spec(rel, lambda: from_yaml(text))
    # apply_suppressions=False: suppression comments live in the
    # operator-submitted body here — honoring them would let any
    # payload waive its own rejection
    findings = check_spec_lines(
        rel, lines, spec, render_error, host_models_for(inventory),
        apply_suppressions=False, feasibility_hint=_FEASIBILITY_HINT,
    )
    if spec is None and not findings:
        # unreachable with suppressions off (a render failure always
        # carries its finding), but admitting None must be impossible
        findings.append(Finding(rel, 1, "spec-render", "spec did not render"))
    if spec is not None and spec.name != name:
        findings.append(Finding(
            rel, 1, "spec-render",
            f"spec name {spec.name!r} does not match URL {name!r}",
        ))
    if spec is not None:
        findings += _mesh_findings(rel, lines, spec)
        findings += _multislice_findings(rel, lines, spec, inventory)
    return spec, findings


def check_rendered_spec(rel: str, lines, spec, inventory=None) -> List[Finding]:
    """Admission findings for an ALREADY-RENDERED spec (the
    package-install path: svc.yml was rendered against its
    options.json env before this runs)."""
    from dcos_commons_tpu_torch.analysis.speccheck import check_spec_lines

    return check_spec_lines(
        rel, lines, spec, None, host_models_for(inventory),
        apply_suppressions=False, feasibility_hint=_FEASIBILITY_HINT,
    ) + _mesh_findings(rel, lines, spec) + _multislice_findings(
        rel, lines, spec, inventory
    )


def _mesh_findings(rel: str, lines, spec) -> List[Finding]:
    """shardcheck's mesh-derivation rule as an admission gate: run
    only for torch workloads (a GPU pod whose cmd names a known
    workload profile) — CPU services skip it.

    The mesh comes from the SAME per-profile workload builder CI
    uses (``_analyze_pod_task``), not a bare ``derive(env)``: the
    serve profiles pin their own meshes (single chip / tp=gang), so
    deriving here would admit specs CI rejects and vice versa."""
    from dcos_commons_tpu_torch.analysis.shardcheck import _match_profile

    findings: List[Finding] = []
    torch_tasks = []
    for pod in spec.pods:
        if pod.gpu is None:
            continue
        for task in pod.tasks:
            builder = _match_profile(task.cmd)
            if builder is not None:
                torch_tasks.append((pod, task, builder))
    if not torch_tasks:
        return findings
    from dcos_commons_tpu_torch.analysis.shardcheck import (
        _make_anchor,
        declared_chips,
        mesh_span_message,
        pod_task_mesh_env,
    )
    from dcos_commons_tpu_torch.specification.specs import SpecError

    anchor = _make_anchor(lines)
    for pod, task, builder in torch_tasks:
        where = f"pod {pod.type!r} task {task.name!r}"
        env = pod_task_mesh_env(pod, task)
        try:
            workload = builder(env, pod.gpu, pod, task)
        except SpecError as e:
            findings.append(Finding(
                rel, anchor(pod.type), "shard-mesh", f"{where}: {e}"
            ))
            continue
        except Exception as e:
            findings.append(Finding(
                rel, anchor(pod.type), "shard-mesh",
                f"{where}: workload profile "
                f"{getattr(builder, '__name__', '?')} failed: "
                f"{type(e).__name__}: {e}",
            ))
            continue
        declared = declared_chips(pod)
        if workload.mesh.total != declared:
            findings.append(Finding(
                rel, anchor(pod.type), "shard-mesh",
                mesh_span_message(where, declared, workload.mesh.total,
                                  f"{workload.script}'s mesh"),
            ))
    return findings


def _multislice_findings(rel: str, lines, spec, inventory) -> List[Finding]:
    """The `gpu: slices: N` admission gate: a multi-slice
    spec is rejected at PUT when

    * its declared chip span disagrees with slices x hosts-per-slice
      x chips-per-host (the gang could never claim what it reserves),
    * its derived mesh lacks the dcn axis (the worker would lay a
      single-slice mesh over a slice boundary — gradient collectives
      silently riding the data-center network as if it were NVLink), or
    * the fleet registers fewer ``generation`` slices than the spec
      spans (the deploy plan would wait forever; fleet sizing uses
      the same one-formula helper as CI, shardcheck's
      ``fleet_slice_count``).

    Findings anchor to the pod's declaring line, rule ``multislice``.
    Sizing is SKIPPED (like scalar feasibility) while the inventory
    registers no GPU hosts at all — bootstrap must not reject specs.
    """
    from dcos_commons_tpu_torch.analysis.shardcheck import (
        _make_anchor,
        declared_chips,
        fleet_slice_count,
    )
    from dcos_commons_tpu_torch.parallel.mesh import derive
    from dcos_commons_tpu_torch.specification.specs import SpecError

    findings: List[Finding] = []
    multi = [
        pod for pod in spec.pods
        if pod.gpu is not None and pod.gpu.slices > 1
    ]
    if not multi:
        return findings
    anchor = _make_anchor(lines)
    for pod in multi:
        gpu = pod.gpu
        where = f"pod {pod.type!r}"
        span = pod.count * gpu.chips_per_host
        if span != declared_chips(pod):
            findings.append(Finding(
                rel, anchor(pod.type), "multislice",
                f"{where}: count x chips-per-host spans {span} chip(s) "
                f"but slices x topology declares {declared_chips(pod)} "
                f"({gpu.slices} slice(s) of {gpu.topology or '?'})",
            ))
            continue
        try:
            mesh = derive(gpu.mesh_env())
        except SpecError as e:
            findings.append(Finding(
                rel, anchor(pod.type), "multislice", f"{where}: {e}"
            ))
            continue
        if mesh.dcn != gpu.slices:
            findings.append(Finding(
                rel, anchor(pod.type), "multislice",
                f"{where}: {gpu.slices} slices declared but the derived "
                f"mesh lays dcn={mesh.dcn} — cross-slice collectives "
                "would not ride the dcn axis",
            ))
            continue
        registered = fleet_slice_count(inventory, gpu.generation)
        if registered is not None and registered < gpu.slices:
            findings.append(Finding(
                rel, anchor(pod.type), "multislice",
                f"{where}: spans {gpu.slices} slices but the fleet "
                f"registers only {registered} {gpu.generation} "
                "slice(s)",
            ))
    return findings


def _targets_torch_profile(cmd: str) -> bool:
    """True when ``cmd`` runs one of shardcheck's torch workload
    profiles (``analysis/shardcheck.py`` ``_match_profile``); the
    reference's ``_targets_jax``."""
    from dcos_commons_tpu_torch.analysis.shardcheck import _match_profile

    return _match_profile(cmd) is not None

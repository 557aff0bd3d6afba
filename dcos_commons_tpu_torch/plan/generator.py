"""PlanGenerator: the YAML ``plans:`` section -> Plan objects.

Reference: specification/PlanGenerator.java + yaml RawPlan/RawPhase
(specification/yaml/RawServiceSpec beans).  YAML shape:

    plans:
      deploy:
        strategy: serial
        phases:
          first-phase:
            strategy: parallel
            pod: hello
            steps:            # optional explicit per-instance steps
              - 0: [[task-a, task-b]]
              - 1: [[task-a]]

Without ``steps`` a phase covers every instance of the pod with every
task (gang pods: one step for the whole slice).

Port of ``dcos_commons_tpu/plan/generator.py``,
line for line but the imports.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from dcos_commons_tpu_torch.plan.backoff import Backoff
from dcos_commons_tpu_torch.plan.builders import DeployPlanFactory
from dcos_commons_tpu_torch.plan.phase import Phase
from dcos_commons_tpu_torch.plan.plan import Plan
from dcos_commons_tpu_torch.plan.step import DeploymentStep, PodInstanceRequirement
from dcos_commons_tpu_torch.plan.strategy import strategy_for_name
from dcos_commons_tpu_torch.specification.specs import ServiceSpec, SpecError
from dcos_commons_tpu_torch.state.state_store import StateStore


def dependency_cycle(edges: Dict[str, List[str]]) -> Optional[List[str]]:
    """First cycle in a name -> prerequisites graph (as a closed node
    list), or None.  Shared by plan generation and the spec analyzer."""
    WHITE, GRAY, BLACK = 0, 1, 2
    color = {name: WHITE for name in edges}
    path: List[str] = []

    def visit(name: str) -> Optional[List[str]]:
        color[name] = GRAY
        path.append(name)
        for dep in edges.get(name, ()):
            if color.get(dep, WHITE) == GRAY:
                return path[path.index(dep):] + [dep]
            if color.get(dep, WHITE) == WHITE and dep in edges:
                found = visit(dep)
                if found:
                    return found
        path.pop()
        color[name] = BLACK
        return None

    for name in sorted(edges):
        if color[name] == WHITE:
            found = visit(name)
            if found:
                return found
    return None


class PlanGenerator:
    def __init__(self, backoff: Optional[Backoff] = None):
        self._factory = DeployPlanFactory(backoff)
        self._backoff = backoff

    def generate(
        self,
        spec: ServiceSpec,
        plan_name: str,
        raw_plan: Dict[str, Any],
        state_store: StateStore,
        target_config_id: str,
    ) -> Plan:
        phases: List[Phase] = []
        phases_raw = raw_plan.get("phases") or {}
        for phase_name, raw_phase in phases_raw.items():
            phases.append(
                self._generate_phase(
                    spec, phase_name, raw_phase or {}, state_store, target_config_id
                )
            )
        # phase-level `dependencies: [other-phase, ...]` builds a DAG
        # plan (reference: DependencyStrategy/DependencyStrategyHelper)
        # instead of the flat serial/parallel strategies.  Unknown
        # names and cycles are CONFIG errors caught here (and by the
        # spec analyzer at lint time), never a silently-stuck plan.
        edges: Dict[str, List[str]] = {}
        for phase_name, raw_phase in phases_raw.items():
            deps = [str(d) for d in (raw_phase or {}).get("dependencies") or []]
            if deps:
                edges[str(phase_name)] = deps
        if edges:
            if "strategy" in raw_plan:
                # an explicit plan strategy AND a dependency DAG both
                # claim to order the phases; silently preferring one
                # would break whichever the YAML author believed in
                raise SpecError(
                    f"plan {plan_name!r}: 'strategy: "
                    f"{raw_plan['strategy']}' cannot be combined with "
                    "phase 'dependencies' (the DAG defines the order; "
                    "drop one)"
                )
            known = set(map(str, phases_raw))
            unknown = sorted(
                {d for deps in edges.values() for d in deps} - known
            )
            if unknown:
                raise SpecError(
                    f"plan {plan_name!r}: dependencies name unknown "
                    f"phase(s) {unknown} (have: {sorted(known)})"
                )
            cycle = dependency_cycle(edges)
            if cycle:
                raise SpecError(
                    f"plan {plan_name!r}: phase dependency cycle "
                    + " -> ".join(cycle)
                )
            from dcos_commons_tpu_torch.plan.strategy import DependencyStrategy

            return Plan(plan_name, phases, DependencyStrategy(edges))
        return Plan(
            plan_name,
            phases,
            strategy_for_name(str(raw_plan.get("strategy", "serial"))),
        )

    def _generate_phase(
        self,
        spec: ServiceSpec,
        phase_name: str,
        raw_phase: Dict[str, Any],
        state_store: StateStore,
        target_config_id: str,
    ) -> Phase:
        pod_name = raw_phase.get("pod")
        if not pod_name:
            raise SpecError(f"phase {phase_name!r} requires a pod")
        pod = spec.pod(str(pod_name))
        strategy_name = str(raw_phase.get("strategy", "serial"))
        raw_steps = raw_phase.get("steps")
        if not raw_steps:
            return self._factory.build_phase(
                pod, state_store, target_config_id, strategy_name,
                phase_name=phase_name,
            )
        steps: List[DeploymentStep] = []
        # '- default: [[tasks]]' covers every instance not explicitly
        # listed (reference: cassandra svc.yml deploy steps use
        # 'default' to stay count-agnostic)
        explicit = set()
        expanded = []
        for entry in raw_steps:
            if not isinstance(entry, dict) or len(entry) != 1:
                raise SpecError(
                    f"phase {phase_name!r}: each step must be one "
                    "{index: [[tasks...]]} mapping"
                )
            ((raw_index, task_groups),) = entry.items()
            if str(raw_index) == "default":
                if any(i is None for i, _ in expanded):
                    raise SpecError(
                        f"phase {phase_name!r}: multiple 'default' step "
                        "entries would deploy the same instances twice"
                    )
                expanded.append((None, task_groups))
                continue
            try:
                index = int(raw_index)
            except (TypeError, ValueError):
                raise SpecError(
                    f"phase {phase_name!r}: step index {raw_index!r} "
                    "is not an integer or 'default'"
                )
            if not 0 <= index < pod.count:
                raise SpecError(
                    f"phase {phase_name!r}: step index {index} out of "
                    f"range for pod {pod.type!r} (count {pod.count})"
                )
            explicit.add(index)
            expanded.append((index, task_groups))
        flat: List = []
        for index, task_groups in expanded:
            if index is None:
                covered = [
                    i for i in range(pod.count) if i not in explicit
                ]
                if pod.gang:
                    # gang pods deploy slice-atomically: 'default' is
                    # ONE step over every covered instance (matching
                    # DeployPlanFactory's whole-slice step)
                    flat.append((covered, task_groups))
                else:
                    flat.extend((([i], task_groups)) for i in covered)
            else:
                flat.append(([index], task_groups))
        for instances, task_groups in flat:
            for tasks in task_groups:
                task_list = [str(t) for t in tasks]
                unknown = [
                    t for t in task_list
                    if t not in {s.name for s in pod.tasks}
                ]
                if unknown:
                    raise SpecError(
                        f"phase {phase_name!r}: unknown tasks {unknown} "
                        f"for pod {pod.type!r}"
                    )
                requirement = PodInstanceRequirement(
                    pod=pod, instances=list(instances),
                    tasks_to_launch=task_list,
                )
                label = (
                    f"{pod.type}-{instances[0]}"
                    if len(instances) == 1
                    else f"{pod.type}-gang"
                )
                step = DeploymentStep(
                    f"{label}:[{','.join(task_list)}]",
                    requirement,
                    backoff=self._backoff,
                )
                self._factory.seed_step_from_state(
                    step, pod, list(instances), state_store, target_config_id
                )
                steps.append(step)
        return Phase(phase_name, steps, strategy_for_name(strategy_name))

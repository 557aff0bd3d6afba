"""Config-update validators: what may change between target configs
(port of ``dcos_commons_tpu/specification/validation.py``, line for
line but the resource block).

Reference: sdk/scheduler/.../config/validate/ (19 validator classes,
run by DefaultConfigurationUpdater.updateConfiguration,
config/DefaultConfigurationUpdater.java:159).  Each validator compares
the previous target spec against the candidate and emits errors; any
error keeps the old target active and surfaces via /v1/plans errors.

GPU port: ``gpu_topology_cannot_change`` — a live gang's shape cannot
change by rolling update; that requires pod replace.
``gpu_generation_supported`` accepts the generations the port runs on
(``h100``) and ``gpu_chips_per_host_fit_a_node`` holds a host to one
8-GPU NVLink node (1, 2, 4 or 8 cards).
"""

from __future__ import annotations

import inspect
import re
from dataclasses import dataclass
from typing import Callable, List, Optional

from dcos_commons_tpu_torch.specification.specs import ServiceSpec


class ConfigValidationError(Exception):
    def __init__(self, errors: List[str]):
        super().__init__("; ".join(errors))
        self.errors = errors


Validator = Callable[[Optional[ServiceSpec], ServiceSpec], List[str]]


@dataclass
class ValidationContext:
    """Deployment-state context some validators need (reference:
    validators like ServiceRoleCannotChangeOnIncompleteDeployment take
    a StateStore; ours take this snapshot instead so the validator
    functions stay pure).  ``None`` fields mean "unknown — skip the
    check" so pure two-argument callers are unaffected."""

    # has the initial deploy plan ever completed?
    deployment_completed: Optional[bool] = None
    # is a secrets provider wired (SECRETS_DIR / set_secrets_provider)?
    secrets_provider_present: Optional[bool] = None
    # is the control plane authenticated (cluster bearer token set)?
    auth_token_present: Optional[bool] = None


def service_name_cannot_change(old, new):
    """Reference: config/validate/ServiceNameCannotContainDoubleUnderscores
    + the implicit identity check in DefaultConfigurationUpdater."""
    errs = []
    if "__" in new.name:
        errs.append(f"service name {new.name!r} may not contain '__'")
    if old is not None and old.name != new.name:
        errs.append(f"service name cannot change: {old.name!r} -> {new.name!r}")
    return errs


def user_cannot_change(old, new):
    """Reference: config/validate/UserCannotChange.java."""
    if old is not None and old.user and old.user != new.user:
        return [f"user cannot change: {old.user!r} -> {new.user!r}"]
    return []


def region_cannot_change(old, new):
    """Reference: config/validate/RegionCannotChange.java."""
    if old is not None and old.region != new.region:
        return [f"region cannot change: {old.region!r} -> {new.region!r}"]
    return []


def pod_specs_cannot_shrink(old, new):
    """Reference: config/validate/PodSpecsCannotShrink.java — pod count
    may only shrink via explicit decommission (allow_decommission)."""
    errs = []
    if old is None:
        return errs
    new_pods = {p.type: p for p in new.pods}
    for old_pod in old.pods:
        new_pod = new_pods.get(old_pod.type)
        if new_pod is None:
            if not old_pod.allow_decommission:
                errs.append(f"pod {old_pod.type!r} cannot be removed")
        elif new_pod.count < old_pod.count and not old_pod.allow_decommission:
            errs.append(
                f"pod {old_pod.type!r} count cannot shrink "
                f"{old_pod.count} -> {new_pod.count} without allow-decommission"
            )
    return errs


def _effective_volumes(pod, task):
    """Pod-level volumes merged over the task's own, keyed by path —
    the view the evaluator places with.  Comparing EFFECTIVE volumes
    keeps target configs stored before the yaml-spec merge (tasks
    without the pod volume copied in) compatible with re-renders after
    it."""
    merged = {v.container_path: v for v in pod.volumes}
    merged.update({v.container_path: v for v in task.volumes})
    return tuple(sorted(merged.items()))


def task_volumes_cannot_change(old, new):
    """Reference: config/validate/TaskVolumesCannotChange.java."""
    errs = []
    if old is None:
        return errs
    new_pods = {p.type: p for p in new.pods}
    for old_pod in old.pods:
        new_pod = new_pods.get(old_pod.type)
        if new_pod is None:
            continue
        if tuple(old_pod.volumes) != tuple(new_pod.volumes):
            errs.append(f"pod {old_pod.type!r} volumes cannot change")
        old_tasks = {t.name: t for t in old_pod.tasks}
        for new_task in new_pod.tasks:
            old_task = old_tasks.get(new_task.name)
            if old_task and _effective_volumes(old_pod, old_task) != \
                    _effective_volumes(new_pod, new_task):
                errs.append(
                    f"task {old_pod.type}-{new_task.name} volumes cannot change"
                )
    return errs


def gpu_topology_cannot_change(old, new):
    """The gang shape of a live pod cannot change by rolling update —
    its ranks form one process group over a fixed mesh.  Changing
    generation/topology requires pod replace."""
    errs = []
    if old is None:
        return errs
    new_pods = {p.type: p for p in new.pods}
    for old_pod in old.pods:
        new_pod = new_pods.get(old_pod.type)
        if new_pod is None or old_pod.gpu is None:
            continue
        if new_pod.gpu is None:
            errs.append(f"pod {old_pod.type!r} cannot drop its gpu block")
        elif (
            old_pod.gpu.generation != new_pod.gpu.generation
            or old_pod.gpu.topology != new_pod.gpu.topology
            or old_pod.gpu.slices != new_pod.gpu.slices
        ):
            errs.append(
                f"pod {old_pod.type!r} GPU topology cannot change "
                f"({old_pod.gpu.generation}/{old_pod.gpu.topology}"
                f"x{old_pod.gpu.slices} -> "
                f"{new_pod.gpu.generation}/{new_pod.gpu.topology}"
                f"x{new_pod.gpu.slices}); use pod replace"
            )
    return errs


def gang_pods_need_topology(old, new):
    """A gang pod with a multi-host topology must have count matching
    slices x the per-slice host count (total_chips / chips_per_host)."""
    errs = []
    for pod in new.pods:
        if pod.gpu is None:
            continue
        if not pod.gpu.topology:
            if pod.gpu.slices > 1:
                # a slices request without a topology (or gang) would
                # silently take the per-instance placement path with
                # no slice contract — reject, don't drop on the floor
                errs.append(
                    f"pod {pod.type!r}: gpu slices: {pod.gpu.slices} "
                    "requires a topology (the per-slice gang shape)"
                )
            continue
        if pod.gpu.slices > 1 and not pod.gang:
            errs.append(
                f"pod {pod.type!r}: gpu slices: {pod.gpu.slices} "
                "requires gang: true (sub-gangs place atomically)"
            )
            continue
        total = pod.gpu.total_chips
        per_host = pod.gpu.chips_per_host
        if pod.gpu.slices < 1:
            errs.append(f"pod {pod.type!r}: slices must be >= 1")
            continue
        if total % per_host != 0:
            errs.append(
                f"pod {pod.type!r}: topology {pod.gpu.topology} total chips "
                f"{total} not divisible by chips-per-host {per_host}"
            )
            continue
        hosts = (total // per_host) * pod.gpu.slices
        if pod.count != hosts:
            errs.append(
                f"pod {pod.type!r}: count {pod.count} != {hosts} hosts implied "
                f"by {pod.gpu.slices} slice(s) of topology "
                f"{pod.gpu.topology} at {per_host} chips/host"
            )
    return errs


def placement_rules_must_parse(old, new):
    """A bad placement string is a CONFIG error, not a runtime crash in
    the offer cycle (reference: InvalidPlacementRule records parse
    failures so the scheduler surfaces them instead of wedging)."""
    from dcos_commons_tpu_torch.offer.placement import parse_placement

    errs = []
    for pod in new.pods:
        try:
            parse_placement(pod.placement)
        except ValueError as e:
            errs.append(f"pod {pod.type!r}: bad placement: {e}")
    return errs


_DNS_LABEL = re.compile(r"^[a-z0-9]([a-z0-9-]*[a-z0-9])?$")


def service_name_cannot_break_dns(old, new):
    """Reference: config/validate/ServiceNameCannotBreakDNS.java — task
    DNS names are derived from the service name, so every /-separated
    folder component must be a valid DNS label."""
    errs = []
    for part in new.name.strip("/").split("/"):
        if len(part) > 63 or not _DNS_LABEL.match(part):
            errs.append(
                f"service name component {part!r} is not a valid DNS "
                "label (lowercase alphanumerics and dashes, max 63 chars)"
            )
    return errs


def zone_cannot_change(old, new):
    """Reference: config/validate/ZoneValidator.java — zone-aware
    placement may only transition unset->off, on->on, off->off; here
    the service-level zone pin follows RegionCannotChange semantics."""
    if old is not None and old.zone != new.zone:
        return [f"zone cannot change: {old.zone!r} -> {new.zone!r}"]
    return []


def _placement_references_zone(placement: str) -> bool:
    """Walk the PARSED rule tree for field_name == 'zone' terms — a
    substring test would misfire on e.g. hostname:like:tpu-zone1-.*."""
    from dcos_commons_tpu_torch.offer.placement import parse_placement

    try:
        rule = parse_placement(placement)
    except ValueError:
        return False  # placement_rules_must_parse reports this one
    stack = [rule]
    while stack:
        node = stack.pop()
        if getattr(node, "field_name", None) == "zone":
            return True
        stack.extend(getattr(node, "rules", []))
        child = getattr(node, "rule", None)
        if child is not None:
            stack.append(child)
    return False


def zone_placement_cannot_change(old, new):
    """Reference: ZoneValidator.java:14-21 — a pod cannot start or stop
    *referencing zones* in its placement rules on update (the running
    tasks were placed without zone bookkeeping, so the scheduler cannot
    retroactively enforce it)."""
    errs = []
    if old is None:
        return errs
    new_pods = {p.type: p for p in new.pods}
    for old_pod in old.pods:
        new_pod = new_pods.get(old_pod.type)
        if new_pod is None:
            continue
        old_zonal = _placement_references_zone(old_pod.placement)
        new_zonal = _placement_references_zone(new_pod.placement)
        if old_zonal != new_zonal:
            errs.append(
                f"pod {old_pod.type!r} cannot "
                f"{'start' if new_zonal else 'stop'} referencing zones "
                "in placement after deployment"
            )
    return errs


def pod_networks_cannot_change(old, new):
    """Reference: config/validate/PodSpecsCannotChangeNetworkRegime.java
    — a pod on the host network holds real host ports; moving it onto a
    virtual network (or back) would strand those reservations."""
    errs = []
    if old is None:
        return errs
    new_pods = {p.type: p for p in new.pods}
    for old_pod in old.pods:
        new_pod = new_pods.get(old_pod.type)
        if new_pod is None:
            continue
        if sorted(old_pod.networks) != sorted(new_pod.networks):
            errs.append(
                f"pod {old_pod.type!r} networks cannot change "
                f"{sorted(old_pod.networks)} -> {sorted(new_pod.networks)}"
            )
    return errs


def pre_reserved_role_cannot_change(old, new):
    """Reference: config/validate/PreReservationCannotChange.java —
    reservations are stamped with the pre-reserved role at create time;
    a different role cannot adopt them."""
    errs = []
    if old is None:
        return errs
    new_pods = {p.type: p for p in new.pods}
    for old_pod in old.pods:
        new_pod = new_pods.get(old_pod.type)
        if new_pod is None:
            continue
        if old_pod.pre_reserved_role != new_pod.pre_reserved_role:
            errs.append(
                f"pod {old_pod.type!r} pre-reserved-role cannot change "
                f"{old_pod.pre_reserved_role!r} -> "
                f"{new_pod.pre_reserved_role!r}"
            )
    return errs


def task_env_cannot_change_for_finished(old, new):
    """Reference: config/validate/TaskEnvCannotChange.java — the env of
    a ONCE/FINISH-goal task that already ran defines what it *did*;
    changing it would silently not re-run with the new values."""
    from dcos_commons_tpu_torch.specification.specs import GoalState

    errs = []
    if old is None:
        return errs
    new_pods = {p.type: p for p in new.pods}
    for old_pod in old.pods:
        new_pod = new_pods.get(old_pod.type)
        if new_pod is None:
            continue
        new_tasks = {t.name: t for t in new_pod.tasks}
        for old_task in old_pod.tasks:
            new_task = new_tasks.get(old_task.name)
            if new_task is None:
                continue
            if (
                old_task.goal in (GoalState.ONCE, GoalState.FINISH)
                and old_task.env != new_task.env
            ):
                errs.append(
                    f"task {old_pod.type}-{old_task.name} "
                    f"(goal {old_task.goal.value}) env cannot change; "
                    "use pod replace to re-run it"
                )
    return errs


def gang_flag_cannot_change(old, new):
    """Gang scheduling is burned into how a pod's instances were placed
    (atomically, one gang) — toggling it needs replace."""
    errs = []
    if old is None:
        return errs
    new_pods = {p.type: p for p in new.pods}
    for old_pod in old.pods:
        new_pod = new_pods.get(old_pod.type)
        if new_pod is not None and old_pod.gang != new_pod.gang:
            errs.append(
                f"pod {old_pod.type!r} cannot toggle gang scheduling "
                f"({old_pod.gang} -> {new_pod.gang}); use pod replace"
            )
    return errs


_KNOWN_GENERATIONS = ("h100",)
# the cards one host may give a pod: at most one 8-GPU NVLink node, in
# a power of two that a tp axis of the mesh can split heads by
_NODE_GPUS = (1, 2, 4, 8)


def gpu_generation_supported(old, new):
    """Reference: PodSpecsCannotUseUnsupportedFeatures.java /
    TaskSpecsCannotUseUnsupportedFeatures.java — a spec demanding a
    capability the substrate lacks is a config error, not a forever-
    pending deploy plan.  Here: the GPU generation must be one the port
    runs on."""
    errs = []
    for pod in new.pods:
        if pod.gpu is not None and pod.gpu.generation not in _KNOWN_GENERATIONS:
            errs.append(
                f"pod {pod.type!r}: unknown GPU generation "
                f"{pod.gpu.generation!r} (supported: "
                f"{', '.join(_KNOWN_GENERATIONS)})"
            )
    return errs


def gpu_chips_per_host_fit_a_node(old, new):
    """A host gives a pod at most one 8-GPU NVLink node: chips-per-host
    is 1, 2, 4 or 8."""
    errs = []
    for pod in new.pods:
        if pod.gpu is not None and pod.gpu.chips_per_host not in _NODE_GPUS:
            errs.append(
                f"pod {pod.type!r}: chips-per-host "
                f"{pod.gpu.chips_per_host} is not one NVLink node's share "
                f"(supported: {', '.join(str(n) for n in _NODE_GPUS)})"
            )
    return errs


def role_cannot_change_on_incomplete_deployment(old, new, context=None):
    """Reference: ServiceRoleCannotChangeOnIncompleteDeployment.java —
    a role migration is only safe once the initial deployment finished
    (mid-deploy, half the reservations would carry the old role)."""
    if old is None or old.role == new.role:
        return []
    completed = context.deployment_completed if context else None
    if completed is None:
        # no deployment-state context: allow (the completed-deploy
        # role-migration path is legitimate and must not be blocked)
        return []
    if not completed:
        return [
            f"service role cannot change ({old.role!r} -> {new.role!r}) "
            "while the initial deployment is incomplete"
        ]
    return []


def secrets_require_provider(old, new, context=None):
    """Reference: config/validate/TLSRequiresServiceAccount.java — a
    spec whose tasks need credentials must fail CONFIGURATION when the
    backing credential plane is absent, not the eventual launch."""
    present = context.secrets_provider_present if context else None
    if present is None or present:
        return []
    errs = []
    for pod in new.pods:
        if pod.secrets:
            errs.append(
                f"pod {pod.type!r} references secrets but no secrets "
                "provider is configured (set SECRETS_DIR / --secrets-dir "
                "or SchedulerBuilder.set_secrets_provider)"
            )
    return errs


def tls_requires_credentials(old, new, context=None):
    """Reference: config/validate/TLSRequiresServiceAccount.java — a
    spec requesting transport encryption needs the credential plane
    behind it: per-task certs are only trustworthy when the control
    plane itself is authenticated (agents pull cert material over it),
    so TLS without a cluster auth token is a misconfiguration caught
    at CONFIGURATION time, not at launch."""
    present = context.auth_token_present if context else None
    if present is None or present:
        return []
    errs = []
    for pod in new.pods:
        for task in pod.tasks:
            if task.transport_encryption:
                errs.append(
                    f"task {pod.type}/{task.name} requests "
                    "transport-encryption but the control plane has no "
                    "auth token (set AUTH_TOKEN/--auth-token-file; the "
                    "reference requires a service account for TLS the "
                    "same way)"
                )
    return errs


def default_validators() -> List[Validator]:
    return [
        service_name_cannot_change,
        service_name_cannot_break_dns,
        user_cannot_change,
        region_cannot_change,
        zone_cannot_change,
        zone_placement_cannot_change,
        pod_specs_cannot_shrink,
        task_volumes_cannot_change,
        task_env_cannot_change_for_finished,
        pod_networks_cannot_change,
        pre_reserved_role_cannot_change,
        role_cannot_change_on_incomplete_deployment,
        secrets_require_provider,
        tls_requires_credentials,
        gpu_generation_supported,
        gpu_chips_per_host_fit_a_node,
        gang_flag_cannot_change,
        gpu_topology_cannot_change,
        gang_pods_need_topology,
        placement_rules_must_parse,
    ]


def _takes_context(validator) -> bool:
    try:
        return len(inspect.signature(validator).parameters) >= 3
    except (TypeError, ValueError):
        return False


def validate_spec_change(
    old: Optional[ServiceSpec],
    new: ServiceSpec,
    validators: Optional[List[Validator]] = None,
    context: Optional[ValidationContext] = None,
) -> None:
    """Run all validators; raise ConfigValidationError on any failure.

    Reference: DefaultConfigurationUpdater.updateConfiguration flow —
    validation errors keep the previous target config active.  A
    validator that RAISES (instead of returning errors) must not let
    a candidate config slip past the other checks or crash the
    update endpoint: a raised ConfigValidationError's entries are
    folded in, and any other exception becomes a validation error
    naming the broken validator (the config is rejected, the operator
    sees which check to fix).
    """
    errors: List[str] = []
    for validator in validators if validators is not None else default_validators():
        try:
            if _takes_context(validator):
                errors.extend(validator(old, new, context))
            else:
                errors.extend(validator(old, new))
        except ConfigValidationError as e:
            errors.extend(e.errors)
        except Exception as e:
            name = getattr(validator, "__name__", repr(validator))
            errors.append(f"validator {name} crashed: {e!r}")
    if errors:
        raise ConfigValidationError(errors)

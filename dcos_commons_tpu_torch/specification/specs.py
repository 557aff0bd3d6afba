"""Typed service specification object model (port of
``dcos_commons_tpu/specification/specs.py``, line for line but the
resource block).

Reference: sdk/scheduler/.../specification/ — ServiceSpec, PodSpec,
TaskSpec, ResourceSpec/PortSpec/VolumeSpec, GoalState.java,
ReplacementFailurePolicy (DefaultServiceSpec.java).  Specs are pure
data: JSON-serializable, comparable, stored in the ConfigStore and
diffed on config update.

GPU port: ResourceSpec has no ``gpus`` scalar; pods request GPUs via
:class:`GpuSpec`, the counterpart of the JAX package's ``TpuSpec`` with
the same fields, whose topology string ("2x2", "4x4") names the shape
of the gang's cards and whose host holds at most one 8-GPU NVLink node.
The port's spec has no ``tpu`` block.
"""

from __future__ import annotations

import dataclasses
import enum
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


class SpecError(Exception):
    pass


class GoalState(enum.Enum):
    """Reference: specification/GoalState.java.

    RUNNING: stay up forever (restart on exit).
    FINISH: run to successful completion, re-run on config change.
    ONCE: run to successful completion exactly once ever.
    """

    RUNNING = "RUNNING"
    FINISH = "FINISH"
    ONCE = "ONCE"


@dataclass(frozen=True)
class GpuSpec:
    """A pod's GPU requirement: the counterpart of the JAX package's
    ``TpuSpec``, field for field.

    Replaces the reference's ``gpus:`` Mesos scalar resources.  A pod
    instance runs on one host and consumes ``chips_per_host`` GPUs
    there, at most one 8-GPU NVLink node (the validators hold it to 1,
    2, 4 or 8); ``topology`` names the shape of the whole multi-host
    gang the pod's instances form (e.g. "4x4" = 16 GPUs over 4 hosts
    of 4).
    """

    generation: str = "h100"
    chips_per_host: int = 4
    topology: str = ""               # "" = no multi-host shape required
    # multi-slice gangs: the pod spans `slices` groups of hosts, each
    # forming one `topology` gang; the groups talk over the data-center
    # network (data parallel across them — the dcn mesh axis).  count
    # must equal slices * hosts-per-slice.
    slices: int = 1
    # elastic re-slicing: a DP-sharded trainer gang that
    # cannot re-place at full size after preemption may restart on a
    # smaller mesh (a divisor of the gang size, never below
    # ``min_hosts``) instead of waiting for capacity that is not
    # coming back.  Opt-in — shrinking changes the effective batch
    # layout and the operator must have designed for it.
    elastic: bool = False
    min_hosts: int = 1

    def topology_dims(self) -> Tuple[int, ...]:
        if not self.topology:
            return ()
        try:
            dims = tuple(int(d) for d in self.topology.lower().split("x"))
        except ValueError:
            raise SpecError(f"bad topology {self.topology!r}")
        if not dims or any(d <= 0 for d in dims):
            raise SpecError(f"bad topology {self.topology!r}")
        return dims

    @property
    def total_chips(self) -> int:
        dims = self.topology_dims()
        total = 1
        for d in dims:
            total *= d
        return total if dims else self.chips_per_host

    def mesh_env(self) -> Dict[str, str]:
        """The mesh slice of the scheduler's task env contract.

        One source of truth for the launch path and the static
        sharding analyzer (analysis/shardcheck.py): the port's workers
        derive their mesh from exactly these variables
        (parallel/mesh.py ``derive``, parallel/distributed.py,
        frameworks/train_worker.py), so an analyzer that assembled them
        independently could approve a mesh the launched task never
        builds.  The names keep the JAX package's ``TPU_`` prefix: the
        port's workers read them as they are.  Multi-slice pods grow
        the dcn axis here (TPU_NUM_SLICES widens the declared shape)
        plus the static half of the per-slice coordinator addressing
        (TPU_HOSTS_PER_SLICE — slice-major worker numbering means
        ``worker_id // hosts_per_slice`` is the slice index); which
        HOST anchors each slice (TPU_SLICE_COORDS) and which slice a
        worker landed on (TPU_SLICE_INDEX) are claim-time facts and
        stay with the claim path (the offer side of the scheduler).
        """
        env = {
            "TPU_CHIPS_PER_HOST": str(self.chips_per_host),
            "TPU_GENERATION": self.generation,
        }
        if self.topology:
            env["TPU_TOPOLOGY"] = self.topology
        if self.slices > 1:
            env["TPU_NUM_SLICES"] = str(self.slices)
            env["TPU_HOSTS_PER_SLICE"] = str(
                max(1, self.total_chips // max(1, self.chips_per_host))
            )
        return env


@dataclass(frozen=True)
class PortSpec:
    """Reference: specification/PortSpec.java + NamedVIPSpec.java."""

    name: str
    port: int = 0                    # 0 = dynamically assigned
    vip: str = ""                    # "name:port" service VIP
    env_key: str = ""                # env var to expose the port under
    # endpoints list the port the worker ACTUALLY bound (advertised
    # via its servestats snapshot) instead of the reserved one — for
    # HTTP servers that fall back to an ephemeral bind when the
    # assigned port is taken on a shared machine
    advertise: bool = False


@dataclass(frozen=True)
class VolumeSpec:
    """Reference: specification/VolumeSpec.java (ROOT/MOUNT/profile)."""

    container_path: str
    size_mb: int
    type: str = "ROOT"               # ROOT (shared disk) | MOUNT (dedicated)
    profiles: Tuple[str, ...] = ()


@dataclass(frozen=True)
class ResourceSpec:
    """Per-task scalar resources.  No ``gpus`` — GPUs are per-pod GpuSpec."""

    cpus: float = 0.1
    memory_mb: int = 32
    disk_mb: int = 0
    ports: Tuple[PortSpec, ...] = ()


@dataclass(frozen=True)
class HealthCheckSpec:
    """Reference: specification/HealthCheckSpec.java."""

    cmd: str
    interval_s: float = 30.0
    grace_period_s: float = 30.0
    timeout_s: float = 20.0
    max_consecutive_failures: int = 3
    delay_s: float = 0.0


@dataclass(frozen=True)
class ReadinessCheckSpec:
    """Reference: specification/ReadinessCheckSpec.java — gates a step's
    STARTED->COMPLETE transition (stored as a task label in the
    reference, PodInfoBuilder.java:511-526)."""

    cmd: str
    interval_s: float = 5.0
    timeout_s: float = 10.0


@dataclass(frozen=True)
class SecretSpec:
    """One secret ref (reference: specification/DefaultSecretSpec +
    RawSecret {secret, env-key, file}).  ``secret`` is the provider
    path; the value lands as a 0600 sandbox ``file`` and/or an
    ``env_key`` env var.  With neither, the env key is derived from
    the ref path (reference behavior for bare refs)."""

    secret: str
    env_key: str = ""
    file: str = ""

    def effective_env_key(self) -> str:
        if self.env_key or self.file:
            return self.env_key
        import re as _re

        return _re.sub(r"[^A-Z0-9]", "_", self.secret.upper())


# "unlimited" sentinel for rlimit values (reference:
# RLimitSpec.RLIMIT_INFINITY)
RLIMIT_INFINITY = -1


def valid_rlimit_names() -> frozenset:
    """The rlimits this host can enforce (``man setrlimit(2)``).

    Derived from the stdlib ``resource`` module so the set matches
    what the agent can actually apply; a static POSIX core is the
    fallback for exotic platforms."""
    try:
        import resource

        return frozenset(
            n for n in dir(resource) if n.startswith("RLIMIT_")
        )
    except ImportError:  # pragma: no cover — non-POSIX dev box
        return frozenset({
            "RLIMIT_AS", "RLIMIT_CORE", "RLIMIT_CPU", "RLIMIT_DATA",
            "RLIMIT_FSIZE", "RLIMIT_MEMLOCK", "RLIMIT_NOFILE",
            "RLIMIT_NPROC", "RLIMIT_RSS", "RLIMIT_STACK",
        })


@dataclass(frozen=True)
class RLimitSpec:
    """One per-task resource limit (reference:
    specification/RLimitSpec.java — name plus optional soft/hard,
    both-or-neither, soft <= hard; enforced at task exec time by the
    agent via ``setrlimit(2)``).

    On a shared GPU host this is a real isolation feature: an fd
    or nproc leak in one service's task must not take out the
    co-scheduled services on the same host.  ``-1`` means unlimited
    (RLIMIT_INFINITY)."""

    name: str
    soft: int = RLIMIT_INFINITY
    hard: int = RLIMIT_INFINITY

    def __post_init__(self) -> None:
        if self.name not in valid_rlimit_names():
            raise SpecError(
                f"{self.name!r} is not a valid rlimit; expected one of "
                f"{sorted(valid_rlimit_names())} (man setrlimit(2))"
            )
        soft_set = self.soft != RLIMIT_INFINITY
        hard_set = self.hard != RLIMIT_INFINITY
        if soft_set != hard_set:
            raise SpecError(
                f"rlimit {self.name}: soft and hard limits must be "
                "set together (or both left unlimited)"
            )
        if self.soft < RLIMIT_INFINITY or self.hard < RLIMIT_INFINITY:
            raise SpecError(
                f"rlimit {self.name}: limits must be >= 0 "
                f"(or -1 for unlimited)"
            )
        if soft_set and self.soft > self.hard:
            raise SpecError(
                f"rlimit {self.name}: soft limit {self.soft} exceeds "
                f"hard limit {self.hard}"
            )


@dataclass(frozen=True)
class TransportEncryptionSpec:
    """Reference: specification/TransportEncryptionSpec (tls.yml
    `transport-encryption:` entries).  ``type`` TLS emits
    <name>.crt/<name>.key/<name>.ca PEMs into the sandbox."""

    name: str
    type: str = "TLS"


@dataclass(frozen=True)
class UriSpec:
    """A sandbox artifact the agent downloads before launch.

    Reference: the ``uris:`` list in service YAML
    (frameworks/helloworld/src/main/dist/uri.yml:8,37), mapped at
    specification/yaml/YAMLToInternalMappers.java:397 and fetched by
    the Mesos fetcher before the task command runs.  Additions
    over the reference: ``sha256`` pins the artifact (a corpus or
    tokenizer staged per host must be the bytes the operator vetted,
    and pinning enables the per-host cache), ``extract`` unpacks
    tar archives, ``executable`` sets +x.
    """

    uri: str
    dest: str = ""            # sandbox-relative; default: URI basename
    sha256: str = ""          # hex digest pin; also the cache key
    extract: bool = False     # tar/tgz: unpack into dirname(dest)
    executable: bool = False

    def effective_dest(self) -> str:
        if self.dest:
            return self.dest
        name = self.uri.rstrip("/").rsplit("/", 1)[-1].split("?")[0]
        if not name:
            raise SpecError(f"cannot derive a dest from uri {self.uri!r}")
        return name


@dataclass(frozen=True)
class TaskSpec:
    """Reference: specification/TaskSpec.java."""

    name: str
    goal: GoalState = GoalState.RUNNING
    cmd: str = ""
    env: Dict[str, str] = field(default_factory=dict)
    resources: ResourceSpec = field(default_factory=ResourceSpec)
    volumes: Tuple[VolumeSpec, ...] = ()
    health_check: Optional[HealthCheckSpec] = None
    readiness_check: Optional[ReadinessCheckSpec] = None
    config_templates: Tuple[Tuple[str, str], ...] = ()   # (template, dest)
    # default matches the Mesos KillPolicy default grace (3s);
    # an explicit 0 in YAML means kill immediately
    kill_grace_period_s: float = 3.0
    essential: bool = True           # reference: TaskSpec.isEssential
    transport_encryption: Tuple[TransportEncryptionSpec, ...] = ()
    # sandbox artifacts fetched before launch (pod-level uris merge in
    # here, task-level declarations winning on dest clashes)
    uris: Tuple[UriSpec, ...] = ()
    # custom discovery name prefix (reference: discovery.yml `discovery:
    # prefix:` -> DiscoveryInfo; tasks advertise as <prefix>-<index>
    # instead of <pod>-<index>-<task> in the endpoint/DNS listing)
    discovery_prefix: str = ""

    def __post_init__(self) -> None:
        if isinstance(self.goal, str):
            object.__setattr__(self, "goal", GoalState(self.goal))


@dataclass(frozen=True)
class PodSpec:
    """Reference: specification/PodSpec.java.

    ``gang=True``: all ``count`` instances form one scheduling unit (one
    process group over the gang's GPUs), deployed and recovered
    together, with rolling updates at pod granularity.
    """

    type: str
    count: int = 1
    tasks: Tuple[TaskSpec, ...] = ()
    gpu: Optional[GpuSpec] = None
    gang: bool = False
    image: str = ""
    networks: Tuple[str, ...] = ()
    placement: str = ""              # placement DSL (offer/placement.py)
    volumes: Tuple[VolumeSpec, ...] = ()   # pod-level shared volumes
    uris: Tuple[UriSpec, ...] = ()   # pod-level artifacts (all tasks)
    pre_reserved_role: str = ""
    allow_decommission: bool = False
    share_pid_namespace: bool = False
    # pod-level secret refs applied to every task of the pod
    # (reference: RawPod secrets block, secrets.yml)
    secrets: Tuple[SecretSpec, ...] = ()
    # per-task resource limits applied to every task of the pod at
    # exec time (reference: RawPod rlimits block, svc.yml:9-13)
    rlimits: Tuple[RLimitSpec, ...] = ()

    def task(self, name: str) -> TaskSpec:
        for t in self.tasks:
            if t.name == name:
                return t
        raise SpecError(f"no task {name!r} in pod {self.type!r}")


@dataclass(frozen=True)
class ReplacementFailurePolicy:
    """Reference: DefaultServiceSpec ReplacementFailurePolicy — governs
    TRANSIENT->PERMANENT escalation (TimedFailureMonitor)."""

    permanent_failure_timeout_s: float = 1200.0
    min_replace_delay_s: float = 600.0


@dataclass(frozen=True)
class ServiceSpec:
    """Reference: specification/ServiceSpec.java."""

    name: str
    role: str = ""
    user: str = ""
    region: str = ""
    zone: str = ""
    web_url: str = ""
    # DNS suffix tasks advertise under in /v1/endpoints (reference:
    # custom_tld.yml + bootstrap's custom-TLD resolution; wiring the
    # names into a resolver is the fleet operator's job)
    service_tld: str = "fleet.local"
    pods: Tuple[PodSpec, ...] = ()
    replacement_failure_policy: Optional[ReplacementFailurePolicy] = None
    # raw plans section from YAML; compiled by plan.PlanGenerator
    plans: Dict[str, Any] = field(default_factory=dict)

    def pod(self, pod_type: str) -> PodSpec:
        for p in self.pods:
            if p.type == pod_type:
                return p
        raise SpecError(f"no pod {pod_type!r} in service {self.name!r}")

    # -- serde (ConfigStore stores dicts; reference stores Jackson JSON
    #    of DefaultServiceSpec) --------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return _to_jsonable(self)

    @staticmethod
    def from_dict(data: Dict[str, Any]) -> "ServiceSpec":
        return _decode_service(data)

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, ServiceSpec):
            return NotImplemented
        return self.to_dict() == other.to_dict()

    def __hash__(self) -> int:
        return hash(json.dumps(self.to_dict(), sort_keys=True))


def _to_jsonable(value: Any) -> Any:
    """The JAX package's ``common._to_jsonable``: enums by value,
    dataclasses as dicts, tuples as lists."""
    if isinstance(value, enum.Enum):
        return value.value
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return {
            f.name: _to_jsonable(getattr(value, f.name))
            for f in dataclasses.fields(value)
        }
    if isinstance(value, dict):
        return {k: _to_jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_to_jsonable(v) for v in value]
    return value


def _decode_service(data: Dict[str, Any]) -> ServiceSpec:
    pods = tuple(_decode_pod(p) for p in data.get("pods", []))
    rfp = data.get("replacement_failure_policy")
    return ServiceSpec(
        name=data["name"],
        role=data.get("role", ""),
        user=data.get("user", ""),
        region=data.get("region", ""),
        zone=data.get("zone", ""),
        web_url=data.get("web_url", ""),
        service_tld=data.get("service_tld", "fleet.local"),
        pods=pods,
        replacement_failure_policy=(
            ReplacementFailurePolicy(**rfp) if rfp else None
        ),
        plans=data.get("plans", {}),
    )


def merge_pod_volumes(tasks, pod_volumes):
    """Pod-level volumes are shared by every task of the pod
    (reference: pod volumes land in each task's resource set): copy
    them into each task's volume list, task-level declarations winning
    on path clashes.  Applied by BOTH the YAML mapper and from_dict so
    stored target configs written before the merge existed normalize
    to the same shape on load — keeping the builder's spec-equality
    check (and so the target-config pointer) stable across upgrades."""
    import dataclasses as _dc

    if not pod_volumes:
        return tuple(tasks)
    return tuple(
        _dc.replace(
            t,
            volumes=tuple(
                v for v in pod_volumes
                if v.container_path not in {
                    tv.container_path for tv in t.volumes
                }
            ) + t.volumes,
        )
        for t in tasks
    )


def merge_pod_uris(tasks, pod_uris):
    """Pod-level ``uris:`` apply to every task of the pod (reference:
    YAMLToInternalMappers.java:397 builder.uris(podUris)); task-level
    declarations win on dest clashes.  Applied by BOTH the YAML mapper
    and from_dict so stored configs normalize identically."""
    import dataclasses as _dc

    if not pod_uris:
        return tuple(tasks)
    return tuple(
        _dc.replace(
            t,
            uris=tuple(
                u for u in pod_uris
                if u.effective_dest() not in {
                    tu.effective_dest() for tu in t.uris
                }
            ) + t.uris,
        )
        for t in tasks
    )


def _decode_pod(data: Dict[str, Any]) -> PodSpec:
    if data.get("tpu"):
        raise SpecError(
            f"pod {data.get('type')!r} stores a tpu block: the GPU port's "
            "spec requests cards with a gpu block"
        )
    gpu = data.get("gpu")
    pod_volumes = tuple(
        VolumeSpec(**_vol(v)) for v in data.get("volumes", [])
    )
    pod_uris = tuple(UriSpec(**u) for u in data.get("uris", []))
    return PodSpec(
        type=data["type"],
        count=data.get("count", 1),
        tasks=merge_pod_uris(
            merge_pod_volumes(
                tuple(_decode_task(t) for t in data.get("tasks", [])),
                pod_volumes,
            ),
            pod_uris,
        ),
        gpu=GpuSpec(**gpu) if gpu else None,
        gang=data.get("gang", False),
        image=data.get("image", ""),
        networks=tuple(data.get("networks", ())),
        placement=data.get("placement", ""),
        volumes=pod_volumes,
        uris=pod_uris,
        pre_reserved_role=data.get("pre_reserved_role", ""),
        allow_decommission=data.get("allow_decommission", False),
        share_pid_namespace=data.get("share_pid_namespace", False),
        secrets=tuple(SecretSpec(**s) for s in data.get("secrets", [])),
        rlimits=tuple(RLimitSpec(**r) for r in data.get("rlimits", [])),
    )


def _vol(v: Dict[str, Any]) -> Dict[str, Any]:
    v = dict(v)
    if "profiles" in v:
        v["profiles"] = tuple(v["profiles"])
    return v


def _decode_task(data: Dict[str, Any]) -> TaskSpec:
    res = data.get("resources") or {}
    ports = tuple(PortSpec(**p) for p in res.get("ports", []))
    hc = data.get("health_check")
    rc = data.get("readiness_check")
    return TaskSpec(
        name=data["name"],
        goal=GoalState(data.get("goal", "RUNNING")),
        cmd=data.get("cmd", ""),
        env=dict(data.get("env", {})),
        resources=ResourceSpec(
            cpus=res.get("cpus", 0.1),
            memory_mb=res.get("memory_mb", 32),
            disk_mb=res.get("disk_mb", 0),
            ports=ports,
        ),
        volumes=tuple(VolumeSpec(**_vol(v)) for v in data.get("volumes", [])),
        health_check=HealthCheckSpec(**hc) if hc else None,
        readiness_check=ReadinessCheckSpec(**rc) if rc else None,
        config_templates=tuple(
            (t[0], t[1]) for t in data.get("config_templates", [])
        ),
        kill_grace_period_s=data.get("kill_grace_period_s", 3.0),
        essential=data.get("essential", True),
        transport_encryption=tuple(
            TransportEncryptionSpec(**t)
            for t in data.get("transport_encryption", [])
        ),
        uris=tuple(UriSpec(**u) for u in data.get("uris", [])),
        discovery_prefix=data.get("discovery_prefix", ""),
    )


def pod_instance_name(pod_type: str, index: int) -> str:
    """"<pod>-<index>" (reference: PodInstance.getName())."""
    return f"{pod_type}-{index}"


def task_full_name(pod_type: str, index: int, task_name: str) -> str:
    """"<pod>-<index>-<task>" (reference: TaskSpec.getInstanceName())."""
    return f"{pod_type}-{index}-{task_name}"

"""YAML front end: svc.yml -> ServiceSpec (port of
``dcos_commons_tpu/specification/yaml_spec.py``, line for line but the
resource block and the lazy ``yaml`` import).

Reference: specification/yaml/ — RawServiceSpec et al. (Jackson beans),
TemplateUtils.java (mustache env substitution with missing-value
errors), YAMLToInternalMappers.java (Raw -> Default* conversion, 805
LoC).  The YAML shape mirrors the reference svc.yml dialect
(frameworks/helloworld/src/main/dist/*.yml): pods and tasks are maps,
scalar resources are inline task keys, plans name phases over pods.

GPU port: a pod-level ``gpu:`` block (the ``tpu:`` block's sub-keys:
``generation``, ``chips-per-host``, ``topology``, ``slices``,
``elastic``, ``min-hosts``) replaces per-task ``gpus:`` scalars; a
``tpu:`` block is an error.  ``gang: true`` requests gang scheduling.
``yaml`` is imported inside the loading functions only: a host with the
card need not have PyYAML, and ``analysis.shardcheck`` imports without
it.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Mapping, Optional

from dcos_commons_tpu_torch.specification.specs import (
    GoalState,
    GpuSpec,
    HealthCheckSpec,
    PodSpec,
    PortSpec,
    ReadinessCheckSpec,
    ReplacementFailurePolicy,
    ResourceSpec,
    SecretSpec,
    ServiceSpec,
    SpecError,
    TaskSpec,
    TransportEncryptionSpec,
    VolumeSpec,
)

_TEMPLATE_RE = re.compile(r"\{\{([A-Za-z_][A-Za-z0-9_]*)(?::-([^}]*))?\}\}")


_SECTION_RE = re.compile(
    r"\{\{([#^])([A-Za-z0-9_]+)\}\}\n?(.*?)\{\{/\2\}\}\n?", re.DOTALL
)


def _truthy(value) -> bool:
    """Mustache truthiness for section tags: unset/empty/false/0 hide
    a ``{{#VAR}}`` block (and show a ``{{^VAR}}`` one)."""
    return str(value).strip().lower() not in ("", "false", "0", "no")


def render_template(text: str, env: Mapping[str, str]) -> str:
    """Mustache-style ``{{VAR}}`` substitution from an env map, plus
    boolean sections ``{{#VAR}}...{{/VAR}}`` (kept when VAR is truthy)
    and ``{{^VAR}}...{{/VAR}}`` (kept when falsy).

    Reference: specification/yaml/TemplateUtils.java — missing values
    are an error (listing every missing variable), so a bad install
    fails loudly at spec-render time rather than at task runtime.
    ``{{VAR:-default}}`` supplies a default.  Sections are the
    enable-disable plane (enable-disable.yml): a plan can include or
    exclude whole steps from one boolean option, and flipping it via
    a config update adds/removes the tasks with a rolling update.
    """
    # sections first (innermost-out via repeated passes), so variables
    # inside a hidden block are never "missing"
    def section_sub(match: re.Match) -> str:
        kind, var, body = match.groups()
        show = _truthy(env.get(var, ""))
        if kind == "^":
            show = not show
        return body if show else ""

    prev = None
    while prev != text:
        prev, text = text, _SECTION_RE.sub(section_sub, text)
    # an unbalanced or malformed tag ({{#VAR}} missing its {{/VAR}},
    # a stray closer, a typo like {{#MY-FLAG}} or {{# FLAG}}) never
    # matched _SECTION_RE and would otherwise pass through SILENTLY
    # into the rendered YAML — fail loudly like missing variables do
    # (TemplateUtils-style).  The detector is deliberately wider than
    # the section grammar: anything section-shaped that survived
    # expansion is an error.
    leftover = re.findall(r"\{\{\s*[#^/][^}]*\}\}", text)
    if leftover:
        raise SpecError(
            f"unbalanced or malformed section tags: "
            f"{sorted(set(leftover))} — every {{{{#VAR}}}}/{{{{^VAR}}}} "
            f"needs a matching {{{{/VAR}}}} and names are [A-Za-z0-9_]"
        )
    missing = []

    def sub(match: re.Match) -> str:
        var, default = match.group(1), match.group(2)
        if var in env:
            return str(env[var])
        if default is not None:
            return default
        missing.append(var)
        return ""

    rendered = _TEMPLATE_RE.sub(sub, text)
    if missing:
        raise SpecError(
            f"missing template values: {sorted(set(missing))}"
        )
    return rendered


def from_yaml_file(path: str, env: Optional[Mapping[str, str]] = None) -> ServiceSpec:
    with open(path, "r", encoding="utf-8") as f:
        # config template paths resolve relative to the YAML's own
        # directory (the reference ships templates next to svc.yml in
        # the scheduler's dist dir)
        return from_yaml(
            f.read(), env, base_dir=os.path.dirname(os.path.abspath(path))
        )


def from_yaml(
    text: str,
    env: Optional[Mapping[str, str]] = None,
    base_dir: str = "",
) -> ServiceSpec:
    import yaml

    raw = yaml.safe_load(render_template(text, env or {}))
    if not isinstance(raw, dict):
        raise SpecError("service YAML must be a mapping")
    return _map_service(raw, env or {}, base_dir)


def _env_name(pod_type: str) -> str:
    """Pod type -> env-var fragment (reference: EnvUtils.toEnvName —
    uppercase, non-alphanumerics to underscores)."""
    return re.sub(r"[^A-Z0-9]", "_", pod_type.upper())


def route_task_env(env: Mapping[str, str], pod_type: str) -> Dict[str, str]:
    """Per-task config-plane routing: ``TASKCFG_ALL_FOO=x`` lands as
    ``FOO=x`` in every task; ``TASKCFG_<PODTYPE>_FOO=x`` only in tasks
    of that pod and wins over the ALL form.

    Reference: config/TaskEnvRouter.java:17-30 — scheduler-process env
    is the routing source, and routed values override YAML task env so
    end users can retune a packaged service without editing its YAML.
    """
    routed: Dict[str, str] = {}
    all_prefix = "TASKCFG_ALL_"
    pod_prefix = f"TASKCFG_{_env_name(pod_type)}_"
    for key, value in env.items():
        if key.startswith(all_prefix) and key not in (all_prefix,):
            routed.setdefault(key[len(all_prefix):], str(value))
    for key, value in env.items():
        if pod_prefix != all_prefix and key.startswith(pod_prefix):
            routed[key[len(pod_prefix):]] = str(value)
    return {k: v for k, v in routed.items() if k}


def _map_service(
    raw: Dict[str, Any],
    env: Optional[Mapping[str, str]] = None,
    base_dir: str = "",
) -> ServiceSpec:
    name = raw.get("name")
    if not name:
        raise SpecError("service requires a name")
    pods_raw = raw.get("pods") or {}
    if not pods_raw:
        raise SpecError(f"service {name!r} requires at least one pod")
    pods = tuple(
        _map_pod(pod_name, pod_raw or {}, env or {}, base_dir)
        for pod_name, pod_raw in pods_raw.items()
    )
    # 'recovery'/'decommission'/'uninstall' are built-in plan names; a
    # custom YAML plan with one of them would shadow the real plan in
    # scheduler.plans() and make its state unobservable
    reserved = {"recovery", "decommission", "uninstall"}
    clash = reserved & set((raw.get("plans") or {}).keys())
    if clash:
        raise SpecError(
            f"service {name!r}: plan names {sorted(clash)} are reserved"
        )
    rfp_raw = raw.get("replacement-failure-policy")
    rfp = None
    if rfp_raw:
        rfp = ReplacementFailurePolicy(
            permanent_failure_timeout_s=float(
                rfp_raw.get("permanent-failure-timeout-secs", 1200)
            ),
            min_replace_delay_s=float(rfp_raw.get("min-replace-delay-secs", 600)),
        )
    return ServiceSpec(
        name=str(name),
        role=str(raw.get("role", "") or f"{name}-role"),
        user=str(raw.get("user", "")),
        region=str(raw.get("region", "")),
        zone=str(raw.get("zone", "")),
        web_url=str(raw.get("web-url", "")),
        service_tld=str(raw.get("service-tld", "fleet.local")),
        pods=pods,
        replacement_failure_policy=rfp,
        plans=raw.get("plans") or {},
    )


def _map_pod(
    pod_name: str,
    raw: Dict[str, Any],
    env: Optional[Mapping[str, str]] = None,
    base_dir: str = "",
) -> PodSpec:
    tasks_raw = raw.get("tasks") or {}
    if not tasks_raw:
        raise SpecError(f"pod {pod_name!r} requires at least one task")
    routed_env = route_task_env(env or {}, pod_name)
    if "tpu" in raw:
        raise SpecError(
            f"pod {pod_name!r} declares a tpu: block; the GPU port requests "
            "cards with a gpu: block (generation, chips-per-host, "
            "topology, slices, elastic, min-hosts)"
        )
    gpu_raw = raw.get("gpu")
    gpu = None
    if gpu_raw:
        gpu = GpuSpec(
            generation=str(gpu_raw.get("generation", "h100")),
            chips_per_host=int(gpu_raw.get("chips-per-host", 4)),
            topology=str(gpu_raw.get("topology", "")),
            slices=int(gpu_raw.get("slices", 1)),
            elastic=bool(gpu_raw.get("elastic", False)),
            min_hosts=int(gpu_raw.get("min-hosts", 1)),
        )
    from dcos_commons_tpu_torch.specification.specs import (
        merge_pod_uris,
        merge_pod_volumes,
    )

    pod_volumes = _map_volumes(raw)
    pod_uris = _map_uris(raw)
    # shared with from_dict: the evaluator's sibling-sharing then gives
    # all tasks ONE durable key per container path
    tasks = merge_pod_uris(
        merge_pod_volumes(
            tuple(
                _map_task(task_name, task_raw or {}, routed_env, base_dir)
                for task_name, task_raw in tasks_raw.items()
            ),
            pod_volumes,
        ),
        pod_uris,
    )
    return PodSpec(
        type=str(pod_name),
        count=int(raw.get("count", 1)),
        tasks=tasks,
        gpu=gpu,
        gang=bool(raw.get("gang", False)),
        image=str(raw.get("image", "")),
        networks=_map_networks(raw),
        placement=str(raw.get("placement", "")),
        volumes=pod_volumes,
        uris=pod_uris,
        pre_reserved_role=str(raw.get("pre-reserved-role", "")),
        allow_decommission=bool(raw.get("allow-decommission", False)),
        share_pid_namespace=bool(raw.get("share-pid-namespace", False)),
        secrets=_map_secrets(pod_name, raw),
        rlimits=_map_rlimits(pod_name, raw),
    )


def _map_rlimits(pod_name: str, raw: Dict[str, Any]):
    """Reference dialect (svc.yml:9-13): a map of rlimit name ->
    {soft, hard}; both omitted means "named but unlimited"."""
    from dcos_commons_tpu_torch.specification.specs import (
        RLIMIT_INFINITY,
        RLimitSpec,
    )

    rlimits = []
    for rl_name, rl_raw in (raw.get("rlimits") or {}).items():
        rl_raw = rl_raw or {}
        if not isinstance(rl_raw, dict):
            raise SpecError(
                f"pod {pod_name!r}: rlimit {rl_name} must be a "
                f"{{soft, hard}} mapping, got {rl_raw!r}"
            )
        try:
            rlimits.append(RLimitSpec(
                name=str(rl_name),
                soft=int(rl_raw.get("soft", RLIMIT_INFINITY)),
                hard=int(rl_raw.get("hard", RLIMIT_INFINITY)),
            ))
        except SpecError as e:
            raise SpecError(f"pod {pod_name!r}: {e}")
        except (TypeError, ValueError) as e:
            raise SpecError(
                f"pod {pod_name!r}: rlimit {rl_name} has a non-integer "
                f"limit: {e}"
            )
    return tuple(rlimits)


def _map_secrets(pod_name: str, raw: Dict[str, Any]):
    secrets = []
    for sec_name, sec_raw in (raw.get("secrets") or {}).items():
        sec_raw = sec_raw or {}
        source = str(sec_raw.get("secret", ""))
        if not source:
            raise SpecError(
                f"secret {sec_name!r} in pod {pod_name!r} needs a "
                "'secret' ref"
            )
        secrets.append(SecretSpec(
            secret=source,
            env_key=str(sec_raw.get("env-key", "")),
            file=str(sec_raw.get("file", "")),
        ))
    return tuple(secrets)


def _map_task(
    task_name: str,
    raw: Dict[str, Any],
    routed_env: Optional[Dict[str, str]] = None,
    base_dir: str = "",
) -> TaskSpec:
    ports = []
    for port_name, port_raw in (raw.get("ports") or {}).items():
        port_raw = port_raw or {}
        ports.append(
            PortSpec(
                name=str(port_name),
                port=int(port_raw.get("port", 0)),
                vip=str(port_raw.get("vip", "")),
                env_key=str(port_raw.get("env-key", "")),
                advertise=_truthy(port_raw.get("advertise", False)),
            )
        )
    hc_raw = raw.get("health-check")
    hc = None
    if hc_raw:
        hc = HealthCheckSpec(
            cmd=str(hc_raw["cmd"]),
            interval_s=float(hc_raw.get("interval", 30)),
            grace_period_s=float(hc_raw.get("grace-period", 30)),
            timeout_s=float(hc_raw.get("timeout", 20)),
            max_consecutive_failures=int(hc_raw.get("max-consecutive-failures", 3)),
            delay_s=float(hc_raw.get("delay", 0)),
        )
    rc_raw = raw.get("readiness-check")
    rc = None
    if rc_raw:
        rc = ReadinessCheckSpec(
            cmd=str(rc_raw["cmd"]),
            interval_s=float(rc_raw.get("interval", 5)),
            timeout_s=float(rc_raw.get("timeout", 10)),
        )
    templates = []
    for cfg_name, cfg_raw in (raw.get("configs") or {}).items():
        cfg_raw = cfg_raw or {}
        if "template" not in cfg_raw or "dest" not in cfg_raw:
            raise SpecError(
                f"config {cfg_name!r} in task {task_name!r} needs template+dest"
            )
        template_path = str(cfg_raw["template"])
        if base_dir and not os.path.isabs(template_path):
            template_path = os.path.join(base_dir, template_path)
        templates.append((template_path, str(cfg_raw["dest"])))
    return TaskSpec(
        name=str(task_name),
        goal=GoalState(str(raw.get("goal", "RUNNING")).upper()),
        cmd=str(raw.get("cmd", "")),
        env={
            **{str(k): str(v) for k, v in (raw.get("env") or {}).items()},
            **(routed_env or {}),
        },
        resources=ResourceSpec(
            cpus=float(raw.get("cpus", 0.1)),
            memory_mb=int(raw.get("memory", 32)),
            disk_mb=int(raw.get("disk", 0)),
            ports=tuple(ports),
        ),
        volumes=_map_volumes(raw),
        health_check=hc,
        readiness_check=rc,
        config_templates=tuple(templates),
        uris=_map_uris(raw),
        discovery_prefix=str(
            (raw.get("discovery") or {}).get("prefix", "")
        ),
        kill_grace_period_s=float(raw.get("kill-grace-period", 3)),
        essential=bool(raw.get("essential", True)),
        transport_encryption=tuple(
            TransportEncryptionSpec(
                name=str(t.get("name", task_name)),
                type=str(t.get("type", "TLS")).upper(),
            )
            for t in (raw.get("transport-encryption") or [])
        ),
    )


def _map_networks(raw: Dict[str, Any]) -> tuple:
    # reference YAML uses a map (network name -> options); lists accepted too
    nets = raw.get("networks") or ()
    if isinstance(nets, dict):
        return tuple(str(n) for n in nets)
    return tuple(str(n) for n in nets)


def _map_uris(raw: Dict[str, Any]) -> tuple:
    """``uris:`` at pod or task level — the reference's plain-string
    list (uri.yml:8), plus mapping entries for the additions::

        uris:
          - "https://repo/artifact.bin"
          - uri: "https://repo/corpus.tar"
            dest: data/corpus.tar
            sha256: ab34...
            extract: true
    """
    from dcos_commons_tpu_torch.specification.specs import UriSpec

    uris = []
    for entry in raw.get("uris") or []:
        if isinstance(entry, str):
            uris.append(UriSpec(uri=entry))
            continue
        if not isinstance(entry, dict) or not entry.get("uri"):
            raise SpecError(f"uris entries need a 'uri': {entry!r}")
        uris.append(UriSpec(
            uri=str(entry["uri"]),
            dest=str(entry.get("dest", "")),
            sha256=str(entry.get("sha256", "")).lower(),
            extract=bool(entry.get("extract", False)),
            executable=bool(entry.get("executable", False)),
        ))
    return tuple(uris)


def _map_volumes(raw: Dict[str, Any]) -> tuple:
    vols = []
    single = raw.get("volume")
    multi = raw.get("volumes") or {}
    entries = []
    if single:
        entries.append(single)
    if isinstance(multi, dict):
        entries.extend(v for v in multi.values() if v)
    for v in entries:
        vols.append(
            VolumeSpec(
                container_path=str(v["path"]),
                size_mb=int(v.get("size", 0)),
                type=str(v.get("type", "ROOT")).upper(),
                profiles=tuple(v.get("profiles", ()) or ()),
            )
        )
    return tuple(vols)

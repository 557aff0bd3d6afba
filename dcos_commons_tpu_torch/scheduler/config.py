"""SchedulerConfig: process-level configuration from env.

Reference: scheduler/SchedulerConfig.java (666 LoC, ~45 env vars) +
framework/EnvStore.java.  The same plane-(a) config surface
(SURVEY.md section 5.6): process env -> typed config; service YAML and
per-task env are the other two planes.

Port of ``dcos_commons_tpu/scheduler/config.py``, line for line but the imports.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Mapping, Optional


@dataclass
class SchedulerConfig:
    api_port: int = 8080
    state_dir: str = "./state"
    # networked persistence: when set, scheduler state lives on the
    # cluster state server (reference: ZK via CuratorPersister) and the
    # instance lock is a TTL lease there (CuratorLocker) — the
    # scheduler process becomes host-agnostic and failover is real
    state_url: str = ""
    state_lease_ttl_s: float = 15.0
    # HA leader election (dcos_commons_tpu_torch/ha/): with remote state,
    # `serve --ha` (or SDK_HA=1) makes extra scheduler processes hot
    # STANDBYS — they candidate for the leader lease instead of
    # exiting, and every store mutation is fenced by the lease epoch
    ha_enabled: bool = False
    # secrets provider root (reference: DC/OS secrets service; here an
    # operator-managed directory tree read by FileSecretsProvider)
    secrets_dir: str = ""
    service_namespace: str = ""
    uninstall: bool = False              # reference: SDK_UNINSTALL
    state_cache_enabled: bool = True     # reference: DISABLE_STATE_CACHE
    # launch backoff (reference: ExponentialBackoff env knobs)
    backoff_enabled: bool = True
    backoff_initial_s: float = 1.0
    backoff_factor: float = 1.15
    backoff_max_s: float = 300.0
    # recovery escalation (overridden by ServiceSpec's policy)
    permanent_failure_timeout_s: float = 1200.0
    # revive throttling (reference: ReviveManager token bucket)
    revive_capacity: int = 4
    revive_refill_s: float = 5.0
    # agent sandbox root
    sandbox_root: str = "./sandboxes"
    # traceview flight recorder: span ring-buffer capacity per
    # scheduler (0 disables tracing; drop-oldest above the cap, with
    # evictions counted in the `trace.dropped` metric)
    trace_capacity: int = 2048
    # coordinator port range for pjit rendezvous
    coordinator_port_base: int = 8476
    # fleet health plane (dcos_commons_tpu_torch/health/): durable event
    # journal capacity (0 disables the whole plane — detectors AND
    # journal, the bench_health_overhead disabled arm), sandbox/wire
    # telemetry fan-in cadence, metric-history sampling cadence, and
    # the straggler detector's median-ratio threshold/window.  Serving
    # SLO thresholds default off here; per-task env (the options.json
    # serving.*_slo knobs ride the task env contract) overrides.
    health_enabled: bool = True
    health_journal_capacity: int = 512
    health_telemetry_interval_s: float = 5.0
    health_history_interval_s: float = 1.0
    health_straggler_ratio: float = 2.0
    health_straggler_window: int = 32
    # health -> action seam, DEFAULT OFF: a
    # confirmed straggler episode on a host carrying a gang member
    # triggers at most one automated pod replace (riding the gang
    # recovery plan) per episode.  Opt-in — automated eviction must
    # be an operator decision.
    health_auto_replace: bool = False
    # the CLOSED health->action loop (health/actions.py):
    # SLO-breach scale-out + quiet-pod scale-in for non-gang serve
    # pods, and general straggler remediation.  Both families default
    # OFF — automated resizing/eviction is an operator decision.  The
    # hysteresis/cooldown/drain knobs feed the ActionPolicy verbatim.
    health_autoscale: bool = False
    health_remediation: bool = False
    autoscale_max_instances: int = 4
    autoscale_breach_hold_s: float = 10.0
    autoscale_quiet_hold_s: float = 60.0
    autoscale_quiet_factor: float = 0.25
    autoscale_cooldown_out_s: float = 60.0
    autoscale_cooldown_in_s: float = 300.0
    autoscale_drain_grace_s: float = 5.0
    health_ttft_p95_slo_s: float = 0.0
    health_queue_depth_slo: float = 0.0
    health_kv_occupancy_slo: float = 0.0
    health_kv_pages_free_slo: float = 0.0
    # control-plane credentials (security/auth.py): one cluster bearer
    # token shared by scheduler API, agent daemons, and state server;
    # TLS material for serving HTTPS / verifying peers
    auth_token: str = ""
    tls_ca_file: str = ""
    tls_cert_file: str = ""
    tls_key_file: str = ""

    @property
    def api_tls(self):
        """(cert, key) for the scheduler's own HTTPS, or None.
        Raises ValueError on half a pair (no silent plaintext)."""
        from dcos_commons_tpu_torch.security.auth import tls_pair

        return tls_pair(self.tls_cert_file, self.tls_key_file)

    @staticmethod
    def from_env(env: Optional[Mapping[str, str]] = None) -> "SchedulerConfig":
        env = env if env is not None else os.environ
        return SchedulerConfig(
            api_port=int(env.get("PORT_API", "8080")),
            state_dir=env.get("STATE_DIR", "./state"),
            state_url=env.get("STATE_URL", ""),
            state_lease_ttl_s=float(env.get("STATE_LEASE_TTL_S", "15")),
            ha_enabled=env.get("SDK_HA", "") not in ("", "0", "false"),
            secrets_dir=env.get("SECRETS_DIR", ""),
            service_namespace=env.get("SERVICE_NAMESPACE", ""),
            uninstall=env.get("SDK_UNINSTALL", "") not in ("", "0", "false"),
            state_cache_enabled=env.get("DISABLE_STATE_CACHE", "")
            in ("", "0", "false"),
            backoff_enabled=env.get("ENABLE_BACKOFF", "true")
            not in ("0", "false"),
            backoff_initial_s=float(env.get("BACKOFF_INITIAL_S", "1.0")),
            backoff_factor=float(env.get("BACKOFF_FACTOR", "1.15")),
            backoff_max_s=float(env.get("BACKOFF_MAX_S", "300")),
            permanent_failure_timeout_s=float(
                env.get("PERMANENT_FAILURE_TIMEOUT_S", "1200")
            ),
            revive_capacity=int(env.get("REVIVE_CAPACITY", "4")),
            revive_refill_s=float(env.get("REVIVE_REFILL_S", "5.0")),
            sandbox_root=env.get("SANDBOX_ROOT", "./sandboxes"),
            trace_capacity=int(env.get("TRACE_CAPACITY", "2048")),
            coordinator_port_base=int(env.get("COORDINATOR_PORT_BASE", "8476")),
            health_enabled=env.get("HEALTH_ENABLED", "true")
            not in ("0", "false"),
            health_journal_capacity=int(
                env.get("HEALTH_JOURNAL_CAPACITY", "512")
            ),
            health_telemetry_interval_s=float(
                env.get("HEALTH_TELEMETRY_INTERVAL_S", "5.0")
            ),
            health_history_interval_s=float(
                env.get("HEALTH_HISTORY_INTERVAL_S", "1.0")
            ),
            health_straggler_ratio=float(
                env.get("HEALTH_STRAGGLER_RATIO", "2.0")
            ),
            health_straggler_window=int(
                env.get("HEALTH_STRAGGLER_WINDOW", "32")
            ),
            health_auto_replace=env.get("HEALTH_AUTO_REPLACE", "")
            not in ("", "0", "false"),
            health_autoscale=env.get("HEALTH_AUTOSCALE", "")
            not in ("", "0", "false"),
            health_remediation=env.get("HEALTH_REMEDIATION", "")
            not in ("", "0", "false"),
            autoscale_max_instances=int(
                env.get("AUTOSCALE_MAX_INSTANCES", "4")
            ),
            autoscale_breach_hold_s=float(
                env.get("AUTOSCALE_BREACH_HOLD_S", "10")
            ),
            autoscale_quiet_hold_s=float(
                env.get("AUTOSCALE_QUIET_HOLD_S", "60")
            ),
            autoscale_quiet_factor=float(
                env.get("AUTOSCALE_QUIET_FACTOR", "0.25")
            ),
            autoscale_cooldown_out_s=float(
                env.get("AUTOSCALE_COOLDOWN_OUT_S", "60")
            ),
            autoscale_cooldown_in_s=float(
                env.get("AUTOSCALE_COOLDOWN_IN_S", "300")
            ),
            autoscale_drain_grace_s=float(
                env.get("AUTOSCALE_DRAIN_GRACE_S", "5")
            ),
            health_ttft_p95_slo_s=float(env.get("SERVE_TTFT_SLO_S", "0")),
            health_queue_depth_slo=float(
                env.get("SERVE_QUEUE_DEPTH_SLO", "0")
            ),
            health_kv_occupancy_slo=float(
                env.get("SERVE_KV_OCCUPANCY_SLO", "0")
            ),
            health_kv_pages_free_slo=float(
                env.get("SERVE_KV_PAGES_FREE_SLO", "0")
            ),
            auth_token=_load_token(env),
            tls_ca_file=env.get("TLS_CA_FILE", ""),
            tls_cert_file=env.get("TLS_CERT_FILE", ""),
            tls_key_file=env.get("TLS_KEY_FILE", ""),
        )


def _load_token(env: Mapping[str, str]) -> str:
    from dcos_commons_tpu_torch.security.auth import load_token

    return load_token(env=env)

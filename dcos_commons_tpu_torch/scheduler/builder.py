"""SchedulerBuilder: wire persister -> stores -> config update -> plans.

Reference: scheduler/SchedulerBuilder.java:331 (744 LoC): persister +
state/config store wiring, DefaultConfigurationUpdater invocation
(config update validation + target flip), plan selection including
selectDeployPlan's deploy-vs-update choice (:644), namespacing, and
the final DefaultScheduler assembly (DefaultScheduler.java:147).

Port of ``dcos_commons_tpu/scheduler/builder.py``, line for line but the imports.
"""

from __future__ import annotations

import logging
from typing import List, Optional

from dcos_commons_tpu_torch.agent.base import Agent
from dcos_commons_tpu_torch.offer.evaluate import OfferEvaluator
from dcos_commons_tpu_torch.offer.inventory import SliceInventory
from dcos_commons_tpu_torch.offer.ledger import ReservationLedger
from dcos_commons_tpu_torch.plan.backoff import (
    Backoff,
    DisabledBackoff,
    ExponentialBackoff,
)
from dcos_commons_tpu_torch.plan.builders import DeployPlanFactory
from dcos_commons_tpu_torch.plan.generator import PlanGenerator
from dcos_commons_tpu_torch.plan.plan import DEPLOY_PLAN_NAME, UPDATE_PLAN_NAME
from dcos_commons_tpu_torch.plan.plan_manager import DefaultPlanManager
from dcos_commons_tpu_torch.recovery.manager import (
    DefaultRecoveryPlanManager,
    RecoveryPlanOverrider,
)
from dcos_commons_tpu_torch.recovery.monitor import (
    FailureMonitor,
    NeverFailureMonitor,
    TimedFailureMonitor,
)
from dcos_commons_tpu_torch.scheduler.config import SchedulerConfig
from dcos_commons_tpu_torch.scheduler.scheduler import DefaultScheduler
from dcos_commons_tpu_torch.specification.specs import ServiceSpec
from dcos_commons_tpu_torch.specification.validation import (
    ConfigValidationError,
    ValidationContext,
    validate_spec_change,
)
from dcos_commons_tpu_torch.state.config_store import ConfigStore
from dcos_commons_tpu_torch.state.schema import SchemaVersionStore
from dcos_commons_tpu_torch.state.state_store import StateStore
from dcos_commons_tpu_torch.storage import (
    FileWalPersister,
    Persister,
    PersisterCache,
)

LOG = logging.getLogger(__name__)


def make_persister(config: SchedulerConfig) -> Persister:
    """The one place persister selection lives: remote state server
    (behind the full-tree cache) when --state-url is set, else the
    local file WAL (reference: CuratorPersister-vs-local selection in
    SchedulerRunner)."""
    if config.state_url:
        from dcos_commons_tpu_torch.storage.remote import RemotePersister

        persister: Persister = RemotePersister(
            config.state_url,
            auth_token=config.auth_token,
            ca_file=config.tls_ca_file,
        )
        if config.state_cache_enabled:
            persister = PersisterCache(persister)
        return persister
    return FileWalPersister(config.state_dir)


def _apply_autoscale_counts(spec: ServiceSpec, state_store: StateStore):
    """Overlay persisted ``autoscale-count-<pod>`` properties onto the
    target spec's non-gang pod counts.  The property is stamped
    ``count@floor`` with the YAML count it was written against: an
    override only applies while the YAML count is UNCHANGED — the
    moment an operator's config update moves the declared count in
    either direction, the stale autoscale decision is dropped and the
    spec wins (otherwise a scaled-out width would permanently
    neutralize an operator's count decrease).  Applied counts are
    clamped to >= the YAML floor.  Returns
    (spec, {pod_type: yaml_count}) — the baselines the action engine
    scales back down to."""
    import dataclasses

    from dcos_commons_tpu_torch.health.actions import COUNT_PROPERTY_PREFIX

    baselines = {
        pod.type: pod.count for pod in spec.pods if not pod.gang
    }
    new_pods = []
    changed = False
    for pod in spec.pods:
        count = pod.count
        if not pod.gang:
            raw = state_store.fetch_property(
                f"{COUNT_PROPERTY_PREFIX}{pod.type}"
            )
            if raw is not None:
                try:
                    text = raw.decode("utf-8")
                    stored, _sep, floor = text.partition("@")
                    if not floor or int(floor) == pod.count:
                        count = max(pod.count, int(stored))
                except (ValueError, UnicodeDecodeError):
                    count = pod.count
        if count != pod.count:
            pod = dataclasses.replace(pod, count=count)
            changed = True
        new_pods.append(pod)
    if changed:
        spec = dataclasses.replace(spec, pods=tuple(new_pods))
    return spec, baselines


class SchedulerBuilder:
    def __init__(
        self,
        spec: ServiceSpec,
        scheduler_config: Optional[SchedulerConfig] = None,
        persister: Optional[Persister] = None,
    ):
        self._spec = spec
        self._config = scheduler_config or SchedulerConfig()
        self._persister = persister
        self._inventory: Optional[SliceInventory] = None
        self._agent: Optional[Agent] = None
        self._plan_customizer = None
        self._recovery_overriders: List[RecoveryPlanOverrider] = []
        self._failure_monitor: Optional[FailureMonitor] = None
        self._namespace = self._config.service_namespace
        self._secrets_provider = None
        self._leader_lease = None

    # -- fluent wiring (reference: SchedulerBuilder setters) ----------

    def set_inventory(self, inventory: SliceInventory) -> "SchedulerBuilder":
        self._inventory = inventory
        return self

    def set_agent(self, agent: Agent) -> "SchedulerBuilder":
        self._agent = agent
        return self

    def set_plan_customizer(self, customizer) -> "SchedulerBuilder":
        """customizer(plan) -> plan, applied to every built plan
        (reference: PlanCustomizer hook)."""
        self._plan_customizer = customizer
        return self

    def add_recovery_overrider(
        self, overrider: RecoveryPlanOverrider
    ) -> "SchedulerBuilder":
        self._recovery_overriders.append(overrider)
        return self

    def set_failure_monitor(self, monitor: FailureMonitor) -> "SchedulerBuilder":
        self._failure_monitor = monitor
        return self

    def set_secrets_provider(self, provider) -> "SchedulerBuilder":
        """Reference: the SecretsClient the X2 subsystem talks to."""
        self._secrets_provider = provider
        return self

    def set_leader_lease(self, lease) -> "SchedulerBuilder":
        """HA mode (dcos_commons_tpu_torch/ha/): wrap every store mutation
        in the lease-fenced writer, so a deposed leader's writes are
        rejected rather than racing its successor's (reference:
        CuratorLocker's one-scheduler guarantee, upgraded from mutual
        exclusion to fencing)."""
        self._leader_lease = lease
        return self

    # -- build --------------------------------------------------------

    def build(self) -> DefaultScheduler:
        persister = self._persister
        if persister is None:
            persister = make_persister(self._config)
        if self._leader_lease is not None:
            from dcos_commons_tpu_torch.ha.election import FencedPersister

            # every store below is constructed over the fenced writer:
            # no scheduler-path mutation can bypass the lease check.
            # Reuse an already-fenced persister (the HA runner fences
            # its own handle) so rejection counters stay in one place.
            if not (isinstance(persister, FencedPersister)
                    and persister.lease is self._leader_lease):
                persister = FencedPersister(persister, self._leader_lease)
        SchemaVersionStore(persister).check()
        state_store = StateStore(persister, self._namespace)
        config_store = ConfigStore(persister, self._namespace)
        ledger = ReservationLedger(persister, self._namespace)

        if self._config.uninstall:
            # SDK_UNINSTALL set: tear down instead of deploying
            # (reference: SchedulerBuilder.build returning
            # UninstallScheduler).  Over already-wiped state every
            # phase is trivially complete = the skeleton scheduler.
            from dcos_commons_tpu_torch.state.framework_store import FrameworkStore
            from dcos_commons_tpu_torch.uninstall import UninstallScheduler

            inventory = self._inventory or SliceInventory()
            agent = self._agent
            if agent is None:
                from dcos_commons_tpu_torch.agent.local import LocalProcessAgent

                agent = LocalProcessAgent(self._config.sandbox_root)
            return UninstallScheduler(
                spec=self._spec,
                state_store=state_store,
                ledger=ledger,
                inventory=inventory,
                agent=agent,
                persister=persister,
                config_store=config_store,
                framework_store=FrameworkStore(persister),
            )

        target_id, config_errors = self._update_configuration(
            state_store, config_store
        )
        target_spec = self._load_target_spec(config_store, target_id)
        # the autoscale desired-count overrides: a prior
        # incarnation's set_pod_count verb persisted the scaled width;
        # applying it BEFORE plan construction means the deploy plan
        # covers the scaled instances (seeding COMPLETE from state)
        # and the decommission factory sees a mid-scale-in victim as
        # surplus.  The YAML counts stay recorded as the scale-in
        # floor (engine baselines).
        target_spec, autoscale_baselines = _apply_autoscale_counts(
            target_spec, state_store
        )

        backoff = self._make_backoff()
        factory = DeployPlanFactory(backoff)
        generator = PlanGenerator(backoff)
        plans_raw = target_spec.plans or {}
        has_completed = state_store.deployment_was_completed()
        plan_name = UPDATE_PLAN_NAME if has_completed else DEPLOY_PLAN_NAME
        raw_deploy = plans_raw.get("deploy")
        raw_update = plans_raw.get("update")
        if has_completed and raw_update:
            # a custom update plan replaces the deploy plan once the
            # initial deployment has completed (reference:
            # SchedulerBuilder.selectDeployPlan, SchedulerBuilder.java:644)
            deploy_plan = generator.generate(
                target_spec, UPDATE_PLAN_NAME, raw_update, state_store,
                target_id,
            )
        elif raw_deploy:
            deploy_plan = generator.generate(
                target_spec, plan_name, raw_deploy, state_store, target_id
            )
        else:
            deploy_plan = factory.build(
                target_spec, state_store, target_id, plan_name
            )
        deploy_plan.errors.extend(config_errors)
        if self._plan_customizer is not None:
            deploy_plan = self._plan_customizer(deploy_plan) or deploy_plan
        deploy_manager = DefaultPlanManager(deploy_plan)

        monitor = self._failure_monitor
        if monitor is None:
            policy = target_spec.replacement_failure_policy
            if policy is not None:
                monitor = TimedFailureMonitor(policy.permanent_failure_timeout_s)
            else:
                monitor = NeverFailureMonitor()

        def externally_managed(asset: str) -> bool:
            for step in deploy_plan.all_steps():
                if asset in step.get_asset_names() and not step.is_complete:
                    return True
            return False

        recovery_manager = DefaultRecoveryPlanManager(
            target_spec,
            state_store,
            failure_monitor=monitor,
            backoff=backoff,
            overriders=self._recovery_overriders,
            externally_managed=externally_managed,
        )

        evaluator = OfferEvaluator(
            state_store, ledger, target_spec.name, target_id
        )
        inventory = self._inventory or SliceInventory()
        # gang recovery's elastic step probes maintenance windows
        # through the shared inventory (wait-for-window beats shrink)
        recovery_manager.inventory = inventory
        agent = self._agent
        if agent is None:
            from dcos_commons_tpu_torch.agent.local import LocalProcessAgent

            agent = LocalProcessAgent(self._config.sandbox_root)

        # scale-down: stored pod instances the target spec no longer
        # covers get a decommission plan (kill -> unreserve -> erase)
        from dcos_commons_tpu_torch.decommission import DecommissionPlanFactory

        other_managers: List = []
        # custom YAML plans (sidecar: backup/restore/repair...) are
        # built interrupted and kicked off by `plan start` (reference:
        # SchedulerBuilder.java:155 createInterrupted; cassandra's
        # backup plans are the canonical consumer)
        for custom_name, raw_custom in plans_raw.items():
            if custom_name in ("deploy", "update") or not raw_custom:
                continue
            custom_plan = generator.generate(
                target_spec, custom_name, raw_custom, state_store, target_id
            )
            custom_plan.interrupt()
            if self._plan_customizer is not None:
                custom_plan = self._plan_customizer(custom_plan) or custom_plan
            other_managers.append(DefaultPlanManager(custom_plan))
        # the durable event journal is created HERE (and handed to the
        # health monitor below) because the decommission scan needs
        # it: an in-flight scale-in latched in the journal owns its
        # victim's teardown — the re-synthesized scale-in phase tears
        # down through the router drain grace, while this plan's kill
        # step has no drain.  Excluding the victim keeps the failover
        # path honoring the full grace instead of racing past it.
        from dcos_commons_tpu_torch.health import (
            EventJournal,
            StatePropertyBackend,
        )
        from dcos_commons_tpu_torch.health.actions import seed_latches
        from dcos_commons_tpu_torch.specification.specs import (
            pod_instance_name,
        )

        health_journal = None
        scale_in_victims: set = set()
        if self._config.health_enabled and \
                self._config.health_journal_capacity > 0:
            health_journal = EventJournal(
                StatePropertyBackend(state_store),
                capacity=self._config.health_journal_capacity,
            )
            in_flight, _done, _replace = seed_latches(
                health_journal.events(kinds=("health",))
            )
            scale_in_victims = {
                pod_instance_name(pod_type, latch["from"] - 1)
                for pod_type, latch in in_flight.items()
                if latch["direction"] == "in"
            }
        decommission_plan = DecommissionPlanFactory().build(
            target_spec, state_store, exclude=scale_in_victims
        )
        if decommission_plan.phases:
            if self._plan_customizer is not None:
                decommission_plan = self._plan_customizer(
                    decommission_plan
                ) or decommission_plan
            other_managers.append(DefaultPlanManager(decommission_plan))

        # security plane: a secrets provider must exist BEFORE a spec
        # that references secrets may deploy (reference: the
        # TLSRequiresServiceAccount gating pattern — fail configuration,
        # not the eventual launch); TLS just needs a persisted CA
        secrets_provider = self._secrets_provider
        if secrets_provider is None and self._config.secrets_dir:
            from dcos_commons_tpu_torch.security import FileSecretsProvider

            secrets_provider = FileSecretsProvider(self._config.secrets_dir)
        uses_secrets = any(pod.secrets for pod in target_spec.pods)
        if uses_secrets and secrets_provider is None:
            raise ConfigValidationError([
                "service references secrets but no secrets provider is "
                "configured (set SECRETS_DIR / --secrets-dir or wire one "
                "via SchedulerBuilder.set_secrets_provider)"
            ])
        certificate_authority = None
        if any(
            task.transport_encryption
            for pod in target_spec.pods
            for task in pod.tasks
        ):
            from dcos_commons_tpu_torch.security import CertificateAuthority

            certificate_authority = CertificateAuthority.load_or_create(
                persister
            )

        from dcos_commons_tpu_torch.state.framework_store import FrameworkStore

        from dcos_commons_tpu_torch.runtime.token_bucket import TokenBucket

        from dcos_commons_tpu_torch.trace.recorder import TraceRecorder

        # health plane: config-driven monitor (journal capacity 0 =
        # the whole plane off).  The journal persists through
        # state_store, i.e. the (possibly lease-fenced) wired
        # persister — a deposed leader's flush is rejected, the
        # successor replays the journal and resumes the seq.
        from dcos_commons_tpu_torch.health import (
            HealthMonitor,
            ServingSloWatcher,
            StragglerDetector,
        )
        from dcos_commons_tpu_torch.health.monitor import NullHealthMonitor

        if health_journal is not None:
            health_monitor = HealthMonitor(
                journal=health_journal,
                straggler=StragglerDetector(
                    threshold=self._config.health_straggler_ratio,
                    window=self._config.health_straggler_window,
                ),
                slo=ServingSloWatcher(
                    ttft_p95_slo_s=self._config.health_ttft_p95_slo_s,
                    queue_depth_slo=self._config.health_queue_depth_slo,
                    kv_occupancy_slo=self._config.health_kv_occupancy_slo,
                    kv_pages_free_slo=(
                        self._config.health_kv_pages_free_slo
                    ),
                ),
                telemetry_interval_s=(
                    self._config.health_telemetry_interval_s
                ),
                history_interval_s=self._config.health_history_interval_s,
                auto_replace=self._config.health_auto_replace,
                quiet_factor=self._config.autoscale_quiet_factor,
            )
        else:
            health_monitor = NullHealthMonitor()

        from dcos_commons_tpu_torch.health.actions import ActionPolicy

        action_policy = ActionPolicy(
            autoscale=self._config.health_autoscale,
            remediation=self._config.health_remediation,
            max_instances=self._config.autoscale_max_instances,
            breach_hold_s=self._config.autoscale_breach_hold_s,
            quiet_hold_s=self._config.autoscale_quiet_hold_s,
            quiet_factor=self._config.autoscale_quiet_factor,
            cooldown_out_s=self._config.autoscale_cooldown_out_s,
            cooldown_in_s=self._config.autoscale_cooldown_in_s,
            drain_grace_s=self._config.autoscale_drain_grace_s,
        )

        scheduler = DefaultScheduler(
            spec=target_spec,
            state_store=state_store,
            ledger=ledger,
            inventory=inventory,
            agent=agent,
            evaluator=evaluator,
            deploy_manager=deploy_manager,
            recovery_manager=recovery_manager,
            other_managers=other_managers,
            config_store=config_store,
            framework_store=FrameworkStore(persister),
            revive_bucket=TokenBucket(
                capacity=self._config.revive_capacity,
                refill_interval_s=self._config.revive_refill_s,
            ),
            tracer=TraceRecorder(
                capacity=self._config.trace_capacity,
                service=target_spec.name,
            ),
            health_monitor=health_monitor,
            action_policy=action_policy,
        )
        # the YAML instance counts are the scale-in floor; recorded
        # here because the live spec may already carry a scaled width
        scheduler.actions.baselines.update(autoscale_baselines)
        # scale-out deployment steps back off like deploy-plan steps
        # (a crash-looping scaled instance must not hot-retry)
        scheduler.actions.backoff = backoff
        scheduler.secrets_provider = secrets_provider
        scheduler.certificate_authority = certificate_authority
        if self._leader_lease is not None:
            from dcos_commons_tpu_torch.ha.election import HAState

            HAState(
                persister, self._leader_lease.name,
                lease=self._leader_lease,
            ).attach(scheduler)
        return scheduler

    # -- config update (reference: DefaultConfigurationUpdater:159) ---

    def _update_configuration(self, state_store, config_store):
        errors: List[str] = []
        old_target_id = config_store.get_target_config()
        old_spec = None
        if old_target_id:
            old_dict = config_store.fetch(old_target_id)
            if old_dict is not None:
                old_spec = ServiceSpec.from_dict(old_dict)
        if old_spec is not None and old_spec == self._spec:
            return old_target_id, errors
        context = ValidationContext(
            deployment_completed=state_store.deployment_was_completed(),
            secrets_provider_present=(
                self._secrets_provider is not None
                or bool(self._config.secrets_dir)
            ),
            # only meaningful when launches cross a network: a local
            # agent writes cert material straight to disk, so TLS
            # without a token is fine there (None = skip the check)
            auth_token_present=(
                bool(self._config.auth_token)
                if getattr(self._agent, "is_remote", False) else None
            ),
        )
        try:
            validate_spec_change(old_spec, self._spec, context=context)
        except ConfigValidationError as e:
            errors.extend(e.errors)
            if old_target_id is not None:
                LOG.error(
                    "config update rejected, keeping target %s: %s",
                    old_target_id, e.errors,
                )
                return old_target_id, errors
            raise  # invalid initial config: refuse to start
        new_id = config_store.store(self._spec.to_dict())
        config_store.set_target_config(new_id)
        if old_spec is not None:
            # a fresh rollout begins: the update plan must redeploy
            # changed pods, tracked against the new target id
            LOG.info("target config %s -> %s", old_target_id, new_id)
            referenced = set()
            for info in state_store.fetch_tasks():
                cfg = info.labels.get("target_configuration")
                if cfg:
                    referenced.add(cfg)
            config_store.prune(list(referenced))
        return new_id, errors

    def _load_target_spec(self, config_store, target_id) -> ServiceSpec:
        data = config_store.fetch(target_id)
        return ServiceSpec.from_dict(data) if data else self._spec

    def _make_backoff(self) -> Backoff:
        if not self._config.backoff_enabled:
            return DisabledBackoff()
        return ExponentialBackoff(
            initial_s=self._config.backoff_initial_s,
            factor=self._config.backoff_factor,
            max_s=self._config.backoff_max_s,
        )

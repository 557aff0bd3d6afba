"""MultiServiceScheduler: fan-out event loop over N services.

Reference: scheduler/multi/MultiServiceEventClient.java:48 (offer/
status fan-out, auto-uninstall and removal of finished clients) +
MultiServiceManager.java (add/remove/lookup) + MultiServiceRunner.
Each service gets namespaced stores inside the shared persister and
competes for the shared slice inventory through its own evaluator;
the reservation ledgers are namespaced too, so the inventory view
subtracts every service's claims (snapshots take a merged ledger).

Port of ``dcos_commons_tpu/multi/scheduler.py``, line for line but the
imports and the reference's jax warm-up before an install, which the
port has no need of (``parallel/mesh.py`` imports no framework at
module level).
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Dict, List, Optional

from dcos_commons_tpu_torch.agent.base import Agent
from dcos_commons_tpu_torch.multi.discipline import AnyFootprintDiscipline
from dcos_commons_tpu_torch.multi.store import ServiceStore
from dcos_commons_tpu_torch.offer.inventory import SliceInventory
from dcos_commons_tpu_torch.runtime.task_killer import TaskKiller
from dcos_commons_tpu_torch.scheduler.builder import SchedulerBuilder
from dcos_commons_tpu_torch.scheduler.config import SchedulerConfig
from dcos_commons_tpu_torch.scheduler.scheduler import DefaultScheduler
from dcos_commons_tpu_torch.specification.specs import ServiceSpec
from dcos_commons_tpu_torch.state.framework_store import FrameworkStore
from dcos_commons_tpu_torch.state.state_store import StateStore
from dcos_commons_tpu_torch.storage import Persister
from dcos_commons_tpu_torch.uninstall import UninstallScheduler

LOG = logging.getLogger(__name__)


class _ServiceAgentAdapter:
    """Per-service view of the shared agent.

    The shared agent's poll() drains its queue, so the multi scheduler
    polls ONCE per cycle and routes each status to the owning service
    (reference: MultiServiceEventClient.taskStatus fan-out,
    MultiServiceEventClient.java:169-290).  Launch/kill pass through.
    """

    def __init__(self, agent: Agent):
        self._agent = agent
        self._queue: List = []

    def launch(self, task_infos):
        self._agent.launch(task_infos)

    def launch_one(self, info, readiness=None, health=None, templates=None,
                   **kwargs):
        launch_one = getattr(self._agent, "launch_one", None)
        if launch_one is not None:
            launch_one(
                info, readiness=readiness, health=health,
                templates=templates, **kwargs,
            )
        else:
            self._agent.launch([info])

    def kill(self, task_id, grace_period_s=0.0):
        self._agent.kill(task_id, grace_period_s)

    def active_task_ids(self):
        return self._agent.active_task_ids()

    def poll(self):
        out = list(self._queue)
        self._queue.clear()
        return out

    def deliver(self, status) -> None:
        self._queue.append(status)

    # worker telemetry pass-through: each service's /v1/debug/trace,
    # /v1/debug/serving and health monitor read sandbox steplogs /
    # serving gauges through ITS agent handle — without forwarding,
    # multi mode (the production topology) was blind to both
    def steplog_of(self, task_name, agent_id=None):
        reader = getattr(self._agent, "steplog_of", None)
        if not callable(reader):
            return []
        return reader(task_name, agent_id=agent_id) if agent_id \
            else reader(task_name)

    def serving_stats_of(self, task_name, agent_id=None):
        reader = getattr(self._agent, "serving_stats_of", None)
        if not callable(reader):
            return {}
        return reader(task_name, agent_id=agent_id) if agent_id \
            else reader(task_name)

    def advertised_port_of(self, task_name, agent_id=None):
        # the /v1/endpoints `advertise: true` contract:
        # without this forward, multi mode would list the reserved
        # port even when the worker bound (and advertised) another
        reader = getattr(self._agent, "advertised_port_of", None)
        if not callable(reader):
            return None
        return reader(task_name, agent_id=agent_id) if agent_id \
            else reader(task_name)


class _MergedLedgerView:
    """Union view over every service's reservation ledger, handed to
    SliceInventory snapshot sync so one service's free-capacity view
    excludes every other service's claims.

    Implements the incremental-sync protocol (generation_token /
    changed_hosts_since): any service's commit/GC — or a service
    appearing/disappearing — changes the composite token, and the
    dirty set is the union of every member ledger's dirty set, so a
    10k-host fleet re-synthesizes only the hosts someone touched."""

    def __init__(self, multi: "MultiServiceScheduler"):
        self._multi = multi
        self._items_cache = None
        self._items_version = -1

    def _items(self):
        # memoized on the multi's service-set version: a full sync
        # pass calls host_generation once per host, and re-taking the
        # services lock + copy + sort per HOST would be O(hosts x
        # services) — the version counter keeps it one sort per
        # service add/remove/rebuild
        version = self._multi.services_version
        if self._items_cache is None or self._items_version != version:
            self._items_cache = sorted(self._multi.services().items())
            self._items_version = version
        return self._items_cache

    def reserved_on(self, host_id: str):
        out = []
        for _name, service in self._items():
            out.extend(service.ledger.reserved_on(host_id))
        return out

    def host_generation(self, host_id: str):
        """Composite per-host change token (legacy full-pass path):
        (service, ledger epoch, per-host generation) triples, compared
        only by equality — the epoch keeps a rebuilt service's rebased
        generations from aliasing a stale token."""
        return tuple(
            (
                name,
                getattr(service.ledger, "epoch", ""),
                service.ledger.host_generation(host_id),
            )
            for name, service in self._items()
        )

    def generation_token(self):
        """Composite whole-view token: each member ledger's own
        (epoch, generation) token — any commit/GC anywhere, a service
        set change, or a service REBUILD (fresh ledger object over
        the same tree) makes it compare unequal."""
        return tuple(
            (name, service.ledger.generation_token())
            for name, service in self._items()
        )

    def changed_hosts_since(self, token):
        if not isinstance(token, tuple):
            return None
        items = self._items()
        old = dict(token)
        if len(old) != len(token) or set(old) != {n for n, _ in items}:
            # a service appeared or disappeared: its claims (dis)appear
            # on hosts no member journal will report — all dirty
            return None
        out = set()
        for name, service in items:
            changed = service.ledger.changed_hosts_since(old[name])
            if changed is None:
                return None
            out |= changed
        return out


class MultiServiceScheduler:
    def __init__(
        self,
        persister: Persister,
        inventory: SliceInventory,
        agent: Agent,
        scheduler_config: Optional[SchedulerConfig] = None,
        discipline=None,
        builder_hook: Optional[Callable[[SchedulerBuilder], None]] = None,
        ha_state=None,
    ):
        # HA (dcos_commons_tpu_torch/ha/): one election per PROCESS — the
        # shared (already lease-fenced) persister carries the fence;
        # the HAState handle is propagated onto every service scheduler
        # so each serves GET /v1/debug/ha
        self.ha_state = ha_state
        self.persister = persister
        self.inventory = inventory
        self.agent = agent
        self.config = scheduler_config or SchedulerConfig()
        self.discipline = discipline or AnyFootprintDiscipline()
        self.service_store = ServiceStore(persister)
        self.framework_store = FrameworkStore(persister)
        self._builder_hook = builder_hook
        self._services: Dict[str, object] = {}  # name -> scheduler
        # bumped on every service add/remove/rebuild; the merged
        # ledger view memoizes its sorted service list on it
        self._services_version = 0
        # merged orphan sweep goes through a TaskKiller so lost kill
        # requests are retried and acked like every other kill
        self.task_killer = TaskKiller(agent)
        # incremental orphan index: per-service expected-task-id sets cached on the
        # service's task-subtree generation stamp, so the per-cycle
        # sweep is O(services) stamp compares on a quiet fleet instead
        # of O(services x tasks) store scans.  The stamp is
        # epoch-qualified (StateStore.task_generation), so a service
        # REBUILD (upgrade, failover) re-bases under a fresh epoch and
        # can never alias a stale cached set.
        self._orphan_index: Dict[str, tuple] = {}
        # wedge detection (mirrors DefaultScheduler.run_forever): a
        # service failing this many consecutive cycles flags the whole
        # process fatal for supervised restart
        self.max_consecutive_failures = 5
        self._cycle_failures: Dict[str, int] = {}
        # per-service offer discipline (reference: suppress/revive,
        # framework/ReviveManager.java): a service whose plans hold no
        # pending/in-flight work after its cycle is SUPPRESSED —
        # skipped entirely by run_cycle — until a routed status or a
        # nudge() (HTTP mutation) revives it
        self._suppressed_services: set = set()
        self._fatal_error: Optional[str] = None
        self._lock = threading.RLock()
        self._stop = threading.Event()
        # event-driven wake (mirrors DefaultScheduler): service
        # add/remove and agent status arrival cut the fallback wait
        self._wake = threading.Event()
        add_listener = getattr(agent, "add_status_listener", None)
        if callable(add_listener):
            add_listener(self.nudge)
        # fleet-level event journal (health plane): admission
        # rejections target services that may not exist yet, so no
        # per-service store can own them — this one persists at a raw
        # tree path through the (fenced-in-HA) shared persister and is
        # served at GET /v1/multi/events
        from dcos_commons_tpu_torch.health import EventJournal, PersisterBackend

        self.journal = EventJournal(
            PersisterBackend(persister),
            capacity=self.config.health_journal_capacity,
        ) if self.config.health_enabled else EventJournal(
            backend=None, capacity=0
        )
        # ONE merged view shared by every service's evaluator: the
        # shared inventory keys its snapshot cache on the view object,
        # so per-service view instances would clear it on every
        # service switch within a cycle
        self._merged_view = _MergedLedgerView(self)
        with self._lock:
            self._reload_locked()

    # -- add/remove/lookup (reference: MultiServiceManager) -----------

    def _reload_locked(self) -> None:
        """Restart resume: rebuild every persisted service, including
        those mid-uninstall."""
        for name in self.service_store.list_names():
            entry = self.service_store.fetch(name)
            if entry is None:
                continue
            spec = ServiceSpec.from_dict(entry["spec"])
            if entry.get("uninstalling"):
                self._services[name] = self._make_uninstaller(spec)
            else:
                self._services[name] = self._build(spec)
            self._services_version += 1

    def add_service(self, spec: ServiceSpec,
                    options: Optional[dict] = None) -> None:
        with self._lock:
            if spec.name in self._services:
                raise ValueError(f"service {spec.name!r} already exists")
            # build BEFORE persisting: a spec that cannot build must
            # not be stored, or _reload poisons every restart.  ONE
            # store: options must never be persisted separately from
            # the spec they rendered (a crash between two stores would
            # silently drop them).
            built = self._build(spec)
            self.service_store.store(
                spec.name, spec.to_dict(), options=options
            )
            self._services[spec.name] = built
            self._services_version += 1
            self._suppressed_services.discard(spec.name)
        self.journal.append("operator", verb="add-service",
                            service=spec.name)
        self.journal.flush()
        self.nudge()  # deploy work just became pending

    @property
    def artifact_base(self):
        return getattr(self, "_artifact_base", None)

    @artifact_base.setter
    def artifact_base(self, value) -> None:
        """Apply to every service, existing AND future: the runner can
        only learn the URL after the API server starts, which is after
        seeded/reloaded services were built."""
        self._artifact_base = value
        for name, svc in self.services().items():
            if hasattr(svc, "artifact_base"):
                svc.artifact_base = (
                    f"{value.rstrip('/')}/v1/multi/{name}" if value else None
                )

    def install_package(
        self, name: str, payload: bytes, upgrade: bool = False,
        options: Optional[dict] = None,
    ) -> None:
        """Install a framework package tarball (the Cosmos flow): the
        bundle is extracted into this scheduler's packages dir, its
        svc.yml loads with template paths anchored there, and the
        service joins the framework.

        ``upgrade=True`` pushes a NEW package version to a RUNNING
        service (reference: Cosmos `update --package-version`): the
        bundle replaces the package dir and the service rebuilds over
        its existing state — the config diff validates, a rejected
        diff keeps the old target (errors surface on the plan), and an
        accepted one rolls the update plan.

        Reference: Cosmos rendering a universe package into a running
        scheduler (tools/universe/ + marathon.json.mustache)."""
        import os as _os
        import re as _re

        from dcos_commons_tpu_torch.specification.yaml_spec import from_yaml_file
        from dcos_commons_tpu_torch.tools.packaging import extract_package

        import shutil as _shutil

        from dcos_commons_tpu_torch.specification.specs import SpecError

        # the name comes straight off the URL: validate BEFORE it
        # touches a filesystem path ('..' would extract into state_dir)
        if not _re.fullmatch(r"[A-Za-z0-9][A-Za-z0-9._-]*", name) or \
                name in (".", ".."):
            raise SpecError(f"invalid service name {name!r}")
        # the reference warms its mesh module here, outside the lock,
        # so a cold jax import does not stall every service's cycle
        # (run_cycle takes the same lock); the port's parallel/mesh.py
        # imports only numpy at module level (torch lazily, inside the
        # functions that need it), so there is nothing to warm
        # the whole exists-check -> extract -> commit -> register
        # sequence holds the lock: the API server is threaded, and two
        # concurrent PUTs for one name must not interleave their
        # filesystem commits (the loser would clobber the winner's
        # live templates before failing)
        with self._lock:
            existing = self._services.get(name)
            if isinstance(existing, UninstallScheduler):
                raise SpecError(f"service {name!r} is uninstalling")
            if existing is not None and not upgrade:
                raise SpecError(
                    f"service {name!r} already exists (pass upgrade=true "
                    "to push a new package version)"
                )
            if existing is None and upgrade:
                raise SpecError(f"no service {name!r} to upgrade")
            # stage the extraction: a rejected install must never
            # clobber a running service's templates (launches read them)
            packages_root = _os.path.join(self.config.state_dir, "packages")
            staging = _os.path.join(packages_root, f".staging-{name}")
            _shutil.rmtree(staging, ignore_errors=True)
            try:
                manifest = extract_package(payload, staging)
                # the Cosmos options plane: validate the operator's
                # options against the NEW package's options.json and
                # render them to env for the YAML interpolation.
                # Upgrades keep prior options and overlay new ones
                # (`dcos package update` semantics).
                from dcos_commons_tpu_torch.tools.options import (
                    OptionsError,
                    load_schema,
                    merge_options,
                    prune_unknown,
                    render_options,
                )

                try:
                    schema = load_schema(staging)
                except OptionsError as e:
                    raise SpecError(
                        "options rejected: " + "; ".join(e.errors)
                    )
                prior_options = {}
                if existing is not None:
                    prior_entry = self.service_store.fetch(name) or {}
                    prior_options = prior_entry.get("options") or {}
                    # a new package version may DROP options: stored
                    # values for them must not brick every future
                    # upgrade (freshly-passed unknowns below still
                    # reject — there, unknown = typo)
                    prior_options, dropped = prune_unknown(
                        schema, prior_options
                    )
                    if dropped:
                        LOG.warning(
                            "%s: dropping stored options the new "
                            "package no longer defines: %s",
                            name, ", ".join(dropped),
                        )
                effective_options = merge_options(prior_options, options)
                try:
                    options_env = render_options(schema, effective_options)
                except OptionsError as e:
                    raise SpecError(
                        "options rejected: " + "; ".join(e.errors)
                    )
                render_env = {**_os.environ, **options_env}
                spec = from_yaml_file(
                    _os.path.join(staging, "svc.yml"), env=render_env
                )
                if spec.name != name:
                    raise SpecError(
                        f"package {manifest['name']!r} defines service "
                        f"{spec.name!r}, not {name!r}"
                    )
                # admission control on the rendered package spec: the
                # CI analyzers gate the dynamic path too.  Runs while
                # everything is still STAGED — a rejected package
                # leaves no trace on disk or in the store.
                from dcos_commons_tpu_torch.multi.admission import (
                    AdmissionError,
                    check_rendered_spec,
                )

                with open(
                    _os.path.join(staging, "svc.yml"),
                    "r", encoding="utf-8",
                ) as f:
                    svc_lines = f.read().splitlines()
                findings = check_rendered_spec(
                    f"{name}/svc.yml", svc_lines, spec,
                    inventory=self.inventory,
                )
                if findings:
                    raise AdmissionError(findings)
                # VERSIONED final location: upgrades never delete the
                # dir a still-active (or kept-after-rejected-diff)
                # target config's templates live in — a rejected v2
                # must leave v1's templates untouched on disk
                import hashlib as _hashlib

                digest = _hashlib.sha256(payload).hexdigest()[:12]
                version = str(manifest.get("version", "0")).replace(
                    _os.sep, "_"
                )
                target = _os.path.join(
                    packages_root, name, f"{version}-{digest}"
                )
                _shutil.rmtree(target, ignore_errors=True)
                _os.makedirs(_os.path.dirname(target), exist_ok=True)
                _os.replace(staging, target)
            finally:
                _shutil.rmtree(staging, ignore_errors=True)
            # re-anchor template paths in the final location
            spec = from_yaml_file(
                _os.path.join(target, "svc.yml"), env=render_env
            )
            if existing is not None:
                # rebuild over the SAME namespace/state: the builder's
                # config-update pass validates the diff and selects
                # the update plan; the swapped-in scheduler resumes
                # running tasks instead of redeploying.  BUILD FIRST —
                # persisting a spec that cannot build would poison
                # every restart's _reload
                rebuilt = self._build(spec)
                self.service_store.store(
                    name, spec.to_dict(), options=effective_options
                )
                self._services[name] = rebuilt
                self._services_version += 1
                self._suppressed_services.discard(name)
                # prune superseded version dirs: repeated upgrades
                # otherwise grow state_dir without bound.  Keep the new
                # target plus every dir any STORED config still
                # references — a rejected-diff upgrade keeps the old
                # target config live, and relaunches read its templates
                # from disk (rejected v2/v3 must not orphan v1).
                import json as _json

                keep = {_os.path.basename(target)}
                marker = _re.escape(f"packages/{name}/") + r"([^/\"\\]+)"
                cfg_store = getattr(rebuilt, "config_store", None)
                if cfg_store is not None:
                    for cfg_id in cfg_store.list_ids():
                        data = cfg_store.fetch(cfg_id)
                        if data:
                            for m in _re.finditer(
                                marker, _json.dumps(data)
                            ):
                                keep.add(m.group(1))
                svc_root = _os.path.join(packages_root, name)
                for entry_name in _os.listdir(svc_root):
                    if entry_name in keep or entry_name.startswith("."):
                        continue
                    _shutil.rmtree(
                        _os.path.join(svc_root, entry_name),
                        ignore_errors=True,
                    )
            else:
                self.add_service(spec, options=effective_options)

    def uninstall_service(self, name: str) -> None:
        """Flip the service to teardown; it is dropped from the set
        once its uninstall plan completes (reference: uninstall flag +
        client removal, MultiServiceEventClient.java:169-290)."""
        with self._lock:
            service = self._services.get(name)
            if service is None:
                raise KeyError(name)
            if isinstance(service, UninstallScheduler):
                return
            entry = self.service_store.fetch(name)
            self.service_store.store(name, entry["spec"], uninstalling=True)
            self._services[name] = self._make_uninstaller(
                ServiceSpec.from_dict(entry["spec"])
            )
            self._services_version += 1
            self._suppressed_services.discard(name)
        self.journal.append("operator", verb="uninstall-service",
                            service=name)
        self.journal.flush()
        self.nudge()  # teardown work just became pending

    def get_service(self, name: str):
        with self._lock:
            return self._services.get(name)

    @property
    def services_version(self) -> int:
        """Monotonic counter of service add/remove/rebuild events
        (merged-view memoization key)."""
        return self._services_version

    def services(self) -> Dict[str, object]:
        with self._lock:
            return dict(self._services)

    def suppress_state(self, name: Optional[str] = None) -> Dict[str, object]:
        """Per-service offer-discipline state for /v1/debug/offers:
        which services are currently suppressed (skipped by
        run_cycle), optionally focused on one service.  Called from
        HTTP threads while run_cycle mutates the set — the C-level
        set() copy is atomic under the GIL, so sorting can never see
        a mid-mutation resize."""
        snapshot = set(self._suppressed_services)
        out: Dict[str, object] = {
            "suppressed_services": sorted(snapshot),
            "total_services": len(self._services),
        }
        if name is not None:
            out["service"] = name
            out["suppressed"] = name in snapshot
        return out

    def service_names(self) -> List[str]:
        with self._lock:
            return sorted(self._services)

    # -- construction -------------------------------------------------

    def _build(self, spec: ServiceSpec) -> DefaultScheduler:
        import dataclasses

        config = dataclasses.replace(
            self.config, service_namespace=spec.name, uninstall=False
        )
        builder = SchedulerBuilder(spec, config, self.persister)
        builder.set_inventory(self.inventory)
        builder.set_agent(_ServiceAgentAdapter(self.agent))
        if self._builder_hook is not None:
            self._builder_hook(builder)
        scheduler = builder.build()
        # served multi mode: agents pull config templates from the one
        # shared API server; per-service artifact paths route through
        # /v1/multi/<name>/v1/artifacts/...
        base = self.artifact_base
        scheduler.artifact_base = (
            f"{base.rstrip('/')}/v1/multi/{spec.name}" if base else None
        )
        # snapshots must subtract EVERY service's reservations, not
        # just this service's own namespaced ledger
        scheduler.evaluator.set_snapshot_view(self._merged_view)
        # the shared agent's task set spans every service: per-service
        # orphan sweeps would kill siblings' tasks, so the multi loop
        # runs ONE merged sweep instead (_kill_merged_orphans)
        scheduler.kill_orphaned_tasks = False
        # offer-discipline observability: every service's metrics
        # snapshot and /v1/debug/offers can show the fleet's suppress
        # state (len() on a set is atomic under the GIL)
        scheduler.metrics.gauge(
            "cycle.suppressed_services",
            lambda: float(len(self._suppressed_services)),
        )
        scheduler.offer_discipline = (
            lambda name=spec.name: self.suppress_state(name)
        )
        if self.ha_state is not None:
            # one process-wide election; every service serves it at
            # its own /v1/debug/ha and exports the ha.* gauges
            self.ha_state.attach(scheduler)
        return scheduler

    def _make_uninstaller(self, spec: ServiceSpec) -> UninstallScheduler:
        from dcos_commons_tpu_torch.offer.ledger import ReservationLedger
        from dcos_commons_tpu_torch.state.config_store import ConfigStore

        return UninstallScheduler(
            spec=spec,
            state_store=StateStore(self.persister, spec.name),
            ledger=ReservationLedger(self.persister, spec.name),
            inventory=self.inventory,
            agent=_ServiceAgentAdapter(self.agent),
            persister=self.persister,
            config_store=ConfigStore(self.persister, spec.name),
            framework_store=self.framework_store,
            namespace=spec.name,
            deregister=False,
        )

    # -- host lifecycle verbs -----------------------------------------
    # fleet-level: the inventory is SHARED, so the mark lands once,
    # but preemption's task stamping fans out to every service that
    # has tasks on the host (routes: /v1/multi/hosts/<id>/<verb>)

    def drain_host(self, host_id: str, window_s: float = 0.0) -> bool:
        import time as _time

        with self._lock:
            if self.inventory.host(host_id) is None:
                raise KeyError(host_id)
            window_end = _time.time() + window_s if window_s > 0 else 0.0
            changed = self.inventory.set_maintenance(host_id, window_end)
        if changed:
            self.journal.append(
                "host", verb="drain", host=host_id, window_s=window_s,
                message=f"host {host_id} entering maintenance",
            )
            self.journal.flush()
        self.nudge()
        return changed

    def undrain_host(self, host_id: str) -> bool:
        with self._lock:
            if self.inventory.host(host_id) is None:
                raise KeyError(host_id)
            changed = self.inventory.clear_host_state(host_id)
        if changed:
            self.journal.append(
                "host", verb="up", host=host_id,
                message=f"host {host_id} back in service",
            )
            self.journal.flush()
        self.nudge()
        return changed

    def preempt_host(self, host_id: str) -> Dict[str, List[str]]:
        """Mark the host preempted once, then stamp every service's
        tasks on it (each service synthesizes its own LOST statuses
        and gang recovery).  The per-service calls run OUTSIDE the
        multi lock — they take each service's own lock, and holding
        both here would order-invert against run_cycle."""
        with self._lock:
            if self.inventory.host(host_id) is None:
                raise KeyError(host_id)
            self.inventory.set_preempted(host_id)
            services = dict(self._services)
        lost: Dict[str, List[str]] = {}
        for name, service in services.items():
            noter = getattr(service, "note_host_preempted", None)
            if callable(noter):
                touched = noter(host_id)
                if touched:
                    lost[name] = touched
        self.journal.append(
            "host", verb="preempt", host=host_id,
            tasks=sum(len(v) for v in lost.values()),
            message=f"host {host_id} preempted "
                    f"({sum(len(v) for v in lost.values())} task(s) "
                    f"across {len(lost)} service(s))",
        )
        self.journal.flush()
        self.nudge()
        return lost

    # -- the loop (reference: MultiServiceEventClient fan-out) --------

    def run_cycle(self) -> None:
        with self._lock:
            services = dict(self._services)
            revived = self._route_statuses(services)
            # offer discipline: a suppressed service is skipped
            # entirely — no status intake (it got none), no candidate
            # scan, no GC — unless a status arrival or nudge() revived
            # it.  take_nudge() is only CONSUMED here, so a nudge
            # racing the post-cycle suppress decision is never lost.
            runnable: Dict[str, object] = {}
            for name, service in services.items():
                if (
                    isinstance(service, DefaultScheduler)
                    and name in self._suppressed_services
                    and name not in revived
                    and not service.take_nudge()
                ):
                    continue
                runnable[name] = service
            growing = [
                name
                for name, s in runnable.items()
                if isinstance(s, DefaultScheduler) and self._is_growing(s)
            ]
            selected = self.discipline.select(growing)
            for name, service in runnable.items():
                try:
                    if isinstance(service, DefaultScheduler):
                        service.run_cycle(
                            allow_footprint_growth=(
                                name in selected or name not in growing
                            )
                        )
                        if service.work_pending():
                            self._suppressed_services.discard(name)
                        else:
                            self._suppressed_services.add(name)
                    else:
                        service.run_cycle()
                    self._cycle_failures[name] = 0
                except Exception as exc:
                    # a failed cycle must leave the service RUNNABLE:
                    # its revive trigger (nudge/status) was already
                    # consumed this cycle, so staying suppressed here
                    # would skip it forever — silently dropping the
                    # operator verb and making the wedge detection
                    # below unreachable
                    self._suppressed_services.discard(name)
                    failures = self._cycle_failures.get(name, 0) + 1
                    self._cycle_failures[name] = failures
                    LOG.exception(
                        "service %s cycle failed (%d consecutive)",
                        name, failures,
                    )
                    if failures >= self.max_consecutive_failures:
                        self._fatal_error = f"service {name}: {exc!r}"
                        LOG.critical(
                            "service %s wedged after %d consecutive cycle "
                            "failures; flagging fatal for supervised restart",
                            name, failures,
                        )
            self._kill_merged_orphans(services)
            self.task_killer.retry_pending()
            # drop services whose uninstall finished
            for name, service in services.items():
                if isinstance(service, UninstallScheduler) and \
                        service.is_complete:
                    self.service_store.remove(name)
                    del self._services[name]
                    self._services_version += 1
                    self._suppressed_services.discard(name)
                    LOG.info("service %s uninstalled and removed", name)

    def _expected_task_ids(self, services: Dict[str, object]) -> set:
        """Union of every service's stored task ids, served from the
        incremental orphan index: a service whose task-generation
        stamp is unchanged reuses its cached id set (one string
        compare), only mutated services pay the store scan.  Must be
        EXACTLY equivalent to the full scan — an over-approximation
        would shelter a real orphan, an under-approximation would
        kill a live task (equivalence-tested in test_multi_service)."""
        expected: set = set()
        for name, service in services.items():
            store = service.state_store
            gen = getattr(store, "task_generation", None)
            hit = self._orphan_index.get(name)
            if gen is not None and hit is not None and hit[0] == gen:
                ids = hit[1]
            else:
                ids = frozenset(
                    info.task_id for info in store.fetch_tasks()
                )
                if gen is not None:
                    # re-read the stamp AFTER the scan: a mutation
                    # racing the scan must invalidate, not be masked
                    # behind the pre-scan stamp
                    post = store.task_generation
                    if post == gen:
                        # racecheck: handoff=only the multi-loop thread (or a test driving run_cycle inline) reaches the orphan sweep; cycles never overlap
                        self._orphan_index[name] = (gen, ids)
            expected |= ids
        if len(self._orphan_index) > len(services):
            # drop removed/rebuilt-away services so the index cannot
            # grow without bound across add/uninstall churn
            self._orphan_index = {
                n: v for n, v in self._orphan_index.items()
                if n in services
            }
        return expected

    def _kill_merged_orphans(self, services: Dict[str, object]) -> None:
        """Kill agent tasks NO service's store owns (lost-kill safety
        net; the per-service sweep is disabled in multi mode because
        each service sees the shared agent's full task set)."""
        expected = self._expected_task_ids(services)
        for task_id in self.agent.active_task_ids() - expected:
            if task_id in self.task_killer.pending_ids():
                continue  # retry_pending re-issues until acked
            LOG.info("killing orphaned task %s (no owning service)", task_id)
            self.task_killer.kill(task_id)

    def _route_statuses(self, services: Dict[str, object]) -> set:
        """Poll the shared agent once and deliver each status to the
        service whose stored TaskInfo owns the task id; unroutable
        statuses go to every service (their stale guards drop them).
        Returns the names of services that received a delivery — a
        status arrival REVIVES a suppressed service (it must never
        miss work its own tasks caused)."""
        from dcos_commons_tpu_torch.common import task_name_of

        revived: set = set()
        for status in self.agent.poll():
            self.task_killer.handle_status(status)
            try:
                task_name = task_name_of(status.task_id)
            except ValueError:
                LOG.warning("dropped unparseable task id %s", status.task_id)
                continue
            routed = False
            holders = []  # services holding a TaskInfo under this name
            for name, service in services.items():
                info = service.state_store.fetch_task(task_name)
                if info is None:
                    continue
                if info.task_id == status.task_id:
                    service.agent.deliver(status)
                    revived.add(name)
                    routed = True
                    break
                holders.append((name, service))
            if routed:
                continue
            # no exact id owner: deliver only to services that hold a
            # stored TaskInfo for the NAME (their stale-id guards drop
            # it); broadcasting to everyone would persist stray status
            # nodes in services that never owned the task, which can
            # later wedge their uninstall kill-all
            if holders:
                for name, service in holders:
                    service.agent.deliver(status)
                    revived.add(name)
            else:
                LOG.info(
                    "dropped status for unknown task %s", status.task_id
                )
        return revived

    @staticmethod
    def _is_growing(scheduler: DefaultScheduler) -> bool:
        """A service 'grows' while any plan that can take new
        reservations is incomplete."""
        for plan in scheduler.plans().values():
            if plan.name == "recovery":
                continue
            if not plan.is_complete and not plan.has_errors():
                return True
        return False

    def run_forever(
        self,
        interval_s: float = 0.5,
        max_consecutive_failures: int = 5,
    ) -> threading.Thread:
        """Same crash-to-restart contract as DefaultScheduler: stop the
        loop with ``fatal_error`` set once the outer cycle (or any one
        service, tracked in run_cycle) is permanently wedged."""
        def loop():
            failures = 0
            while not self._stop.is_set():
                self._wake.clear()
                try:
                    self.run_cycle()
                    failures = 0
                except Exception as exc:
                    failures += 1
                    LOG.exception(
                        "multi cycle failed (%d consecutive)", failures
                    )
                    if failures >= max_consecutive_failures:
                        with self._lock:
                            self._fatal_error = repr(exc)
                if self._fatal_error is not None:
                    LOG.critical(
                        "multi scheduler wedged (%s); stopping loop for "
                        "supervised restart", self._fatal_error,
                    )
                    self._stop.set()
                    break
                timeout = interval_s
                if self._work_in_flight():
                    timeout = min(interval_s, 0.05)
                self._wake.wait(timeout)

        thread = threading.Thread(target=loop, name="multi-loop", daemon=True)
        thread.start()
        return thread

    def nudge(self) -> None:
        """Wake run_forever for an immediate merged cycle (status
        arrival, service add/remove, HTTP mutation)."""
        self._wake.set()

    def _work_in_flight(self) -> bool:
        """True while any service's plan step awaits task statuses."""
        for service in self.services().values():
            managers = getattr(
                getattr(service, "coordinator", None), "plan_managers", []
            )
            if any(m.in_progress_assets() for m in managers):
                return True
        return False

    @property
    def fatal_error(self) -> Optional[str]:
        return self._fatal_error

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()

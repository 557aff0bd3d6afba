"""FrameworkRunner: the scheduler-process entrypoint.

Reference: framework/FrameworkRunner.java:90 (registerAndRunFramework)
+ scheduler/SchedulerRunner.java:82-101 (lock -> metrics -> build ->
run) + curator/CuratorLocker.java (single-instance mutex).  This is
what makes the framework startable as a *service*:

    python -m dcos_commons_tpu_torch serve svc.yml --topology cluster.yml

takes an exclusive file lock on the state directory (two schedulers
over one state store corrupt plans — the CuratorLocker's job), loads
the fleet topology, connects the per-host agent daemons, starts the
API server BEFORE the event loop accepts work (FrameworkRunner.java:
130-138), and runs until stopped or wedged.

Exit codes (reference: framework/ProcessExit.java):
    0  uninstall completed / clean stop
    2  scheduler wedged (fatal_error set by run_forever)
    3  another scheduler instance holds the lock
    4  invalid configuration

Port of ``dcos_commons_tpu/runtime/runner.py``, line for line but the imports and
``load_topology``, which reads ``GpuHost`` fields.
"""

from __future__ import annotations

import fcntl
import logging
import os
import signal
import sys
import threading
from typing import Dict, List, Optional, Tuple

import yaml

from dcos_commons_tpu_torch.offer.inventory import SliceInventory, GpuHost
from dcos_commons_tpu_torch.scheduler.builder import SchedulerBuilder
from dcos_commons_tpu_torch.scheduler.config import SchedulerConfig

LOG = logging.getLogger(__name__)

EXIT_WEDGED = 2
EXIT_LOCKED = 3
EXIT_BAD_CONFIG = 4


class InstanceLock:
    """Exclusive advisory lock: one scheduler per state directory.

    Reference: curator/CuratorLocker.java — taken in
    SchedulerRunner.run() before anything touches the state store."""

    def __init__(self, state_dir: str):
        os.makedirs(state_dir, exist_ok=True)
        self._path = os.path.join(state_dir, "scheduler.lock")
        self._fd: Optional[int] = None

    def acquire(self) -> bool:
        fd = os.open(self._path, os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            os.close(fd)
            return False
        os.ftruncate(fd, 0)
        os.write(fd, str(os.getpid()).encode())
        self._fd = fd
        return True

    def release(self) -> None:
        if self._fd is not None:
            fcntl.flock(self._fd, fcntl.LOCK_UN)
            os.close(self._fd)
            self._fd = None


def make_instance_lock(config: SchedulerConfig, name: str):
    """One active scheduler per service: a TTL lease on the state
    server when remote state is configured (failover-capable), else a
    per-host file lock (reference: CuratorLocker vs local mutex).

    With ``SDK_HA`` set (``config.ha_enabled``) the lease upgrades to
    a LEADER ELECTION: ``acquire`` candidates — blocking until the
    current leader's lease expires — instead of exiting, and the
    lease's fencing epoch is wired through the builder so a deposed
    leader's store writes are rejected (dcos_commons_tpu_torch/ha/)."""
    if config.state_url:
        import socket as _socket

        owner = f"{_socket.gethostname()}-{os.getpid()}"
        if config.ha_enabled:
            from dcos_commons_tpu_torch.ha.election import LeaderLock
            from dcos_commons_tpu_torch.storage.remote import RemotePersister

            return LeaderLock(
                RemotePersister(
                    config.state_url,
                    auth_token=config.auth_token,
                    ca_file=config.tls_ca_file,
                ),
                name=name,
                owner=owner,
                ttl_s=config.state_lease_ttl_s,
            )
        from dcos_commons_tpu_torch.storage.remote import RemoteLocker

        return RemoteLocker(
            config.state_url,
            name=name,
            owner=owner,
            ttl_s=config.state_lease_ttl_s,
            auth_token=config.auth_token,
            ca_file=config.tls_ca_file,
        )
    return InstanceLock(config.state_dir)


def load_topology(path: str) -> Tuple[List[GpuHost], Dict[str, str]]:
    """Parse a fleet topology YAML into hosts + agent-daemon URLs.

    Format (one entry per GPU host, an NVLink node of its fabric)::

        hosts:
          - host_id: fabric-0-n0
            agent_url: http://10.0.0.1:8476   # omit for in-process mode
            slice_id: fabric-0
            generation: h100
            node: 0
            gpus: 8
            cpus: 16
            memory_mb: 65536
            ports: [[10000, 12000]]           # optional
            zone: z0

    Every host must either have an ``agent_url`` (remote fleet) or none
    may (single-process local mode) — mixing the two would leave some
    placements unlaunchable.
    """
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    hosts: List[GpuHost] = []
    urls: Dict[str, str] = {}
    for entry in raw.get("hosts", []):
        entry = dict(entry)
        url = entry.pop("agent_url", "")
        optional = {}
        if "ports" in entry:
            optional["ports"] = tuple(
                (int(lo), int(hi)) for lo, hi in entry["ports"]
            )
        host = GpuHost(
            host_id=entry["host_id"],
            hostname=entry.get("hostname", ""),
            slice_id=entry.get("slice_id", ""),
            generation=entry.get("generation", ""),
            node=int(entry.get("node", 0)),
            gpus=int(entry.get("gpus", 0)),  # sdklint: disable=no-gpus-resource — the fleet file's card count of a host, not a task resource
            cpus=float(entry.get("cpus", 8.0)),
            memory_mb=int(entry.get("memory_mb", 16384)),
            disk_mb=int(entry.get("disk_mb", 102400)),
            attributes=dict(entry.get("attributes", {})),
            zone=entry.get("zone", ""),
            region=entry.get("region", ""),
            **optional,
        )
        hosts.append(host)
        if url:
            urls[host.host_id] = url
    if not hosts:
        raise ValueError(f"topology {path} defines no hosts")
    if urls and len(urls) != len(hosts):
        missing = [h.host_id for h in hosts if h.host_id not in urls]
        raise ValueError(
            f"topology mixes remote and local hosts; no agent_url for: "
            f"{missing}"
        )
    return hosts, urls


from dcos_commons_tpu_torch.state.config_store import OptionsStore

OPTIONS_NODE = OptionsStore.NODE


class FrameworkRunner:
    """Build and run one service scheduler as a long-lived process."""

    def __init__(
        self,
        spec,
        config: Optional[SchedulerConfig] = None,
        topology_hosts: Optional[List[GpuHost]] = None,
        agent_urls: Optional[Dict[str, str]] = None,
        builder_hook=None,
        spec_source: Optional[Tuple[str, Dict[str, str]]] = None,
    ):
        self.spec = spec
        self.config = config or SchedulerConfig.from_env()
        self.topology_hosts = topology_hosts or []
        self.agent_urls = agent_urls or {}
        # (svc_yml_path, base_env): when present the runner can
        # RE-RENDER the spec with new option env — the live `update`
        # flow (reference: Cosmos update pushing new options to a
        # running scheduler, cli/commands.go:39,56).  Applied overrides
        # persist in the state tree so restarts/failovers keep them.
        self.spec_source = spec_source
        # hook(builder, spec): framework-specific wiring (recovery
        # overriders, plan customizers) — the Main.java analogue
        self.builder_hook = builder_hook
        # framework-specific HTTP endpoints (reference: Cassandra's
        # SeedsResource): routes_hook(scheduler) -> [(method, pattern,
        # handler(match, query))], called after build so handlers can
        # close over the live scheduler
        self.routes_hook = None
        self._lock = make_instance_lock(
            self.config, f"scheduler-{spec.name}"
        )
        self.scheduler = None
        self.api_server = None
        self.fleet = None
        # when set, '<url>' is written here once the API is listening
        # (lets launchers discover an ephemeral port)
        self.announce_file: str = ""
        # API bind address; 127.0.0.1 suits single-machine fleets, a
        # real multi-host deployment binds 0.0.0.0 (or the DCN address)
        self.api_bind: str = "127.0.0.1"
        # externally-reachable URL agents use to pull /v1/artifacts;
        # REQUIRED for remote fleets not on this machine — the default
        # (the server's own loopback URL) is meaningless on other hosts
        self.advertise_url: str = ""
        self._stop_requested = threading.Event()
        self._reload_requested = threading.Event()
        self._lease_lost: Optional[str] = None
        self._persister = None
        self._inventory = None
        self._agent = None
        # serializes update_options' read-merge-write of the options
        # node (ThreadingHTTPServer handles requests concurrently)
        self._update_lock = threading.Lock()
        # pre-update options node value, kept so a failed rebuild can
        # un-poison the store.  _options_dirty gates it: the snapshot
        # is taken only when no rollback is already pending (stacked
        # updates must roll back to the last BUILD-VALIDATED value,
        # not an unvalidated intermediate), and cleared only under
        # _update_lock once a rebuild succeeds with no update pending.
        self._options_rollback: Optional[bytes] = None
        self._options_dirty = False
        self._wire_lease_loss()

    def _wire_lease_loss(self) -> None:
        """Lease loss is fatal (reference: CuratorLocker exits the
        process on ZK lock loss) — a second active scheduler over the
        same state tree corrupts plans, so stop immediately."""
        if not hasattr(self._lock, "on_lost"):
            return

        def on_lost(reason: str) -> None:
            LOG.critical("instance lease lost: %s — stopping", reason)
            self._lease_lost = reason
            self.stop()

        self._lock.on_lost = on_lost

    # -- assembly -----------------------------------------------------

    def _build_infra(self) -> None:
        """Inventory, agent fleet, and persister live for the whole
        process — a live options update rebuilds only the scheduler
        over them (daemon connections and running sandboxes survive)."""
        if self._inventory is not None:
            return
        from dcos_commons_tpu_torch.scheduler.builder import make_persister

        self._inventory = SliceInventory(self.topology_hosts)
        if self.agent_urls:
            from dcos_commons_tpu_torch.agent.remote import RemoteFleet

            fleet = RemoteFleet(
                on_host_down=self._inventory.mark_down,
                on_host_up=self._inventory.mark_up,
                auth_token=self.config.auth_token,
                ca_file=self.config.tls_ca_file,
            )
            for host_id, url in self.agent_urls.items():
                fleet.add_host(host_id, url)
            self._agent = fleet
            self.fleet = fleet
        else:
            from dcos_commons_tpu_torch.agent.local import LocalProcessAgent

            self._agent = LocalProcessAgent(self.config.sandbox_root)
        self._persister = make_persister(self.config)
        lease = getattr(self._lock, "lease", None)
        if lease is not None:
            from dcos_commons_tpu_torch.ha.election import FencedPersister

            # the runner's own writes (options update/rollback) must
            # be lease-fenced too, not just the builder-wired stores —
            # a deposed leader's in-flight update would otherwise
            # clobber its successor's options
            self._persister = FencedPersister(self._persister, lease)

    def _stored_options(self) -> Dict[str, str]:
        return OptionsStore(self._persister).fetch()

    def _render_spec(self, overrides: Dict[str, str]):
        """Re-render svc.yml with base env + option overrides."""
        from dcos_commons_tpu_torch.specification.yaml_spec import from_yaml_file

        yaml_path, base_env = self.spec_source
        env = dict(base_env)
        env.update(overrides)
        return from_yaml_file(yaml_path, env)

    def build(self) -> None:
        self._build_infra()
        if self.spec_source is not None:
            overrides = self._stored_options()
            if overrides:
                LOG.info(
                    "applying %d persisted option override(s): %s",
                    len(overrides), sorted(overrides),
                )
            self.spec = self._render_spec(overrides)
        builder = SchedulerBuilder(
            self.spec, self.config, persister=self._persister
        )
        builder.set_inventory(self._inventory)
        builder.set_agent(self._agent)
        lease = getattr(self._lock, "lease", None)
        if lease is not None:
            # HA mode: every store mutation is lease-fenced, and the
            # scheduler carries its HAState (gauges + /v1/debug/ha)
            builder.set_leader_lease(lease)
        if self.builder_hook is not None:
            self.builder_hook(builder, self.spec)
        self.scheduler = builder.build()

    # -- live options update (reference: Cosmos `update` flow) --------

    def update_options(self, env: Dict[str, str]):
        """Validate + persist new option env, then rebuild the
        scheduler in-process; returns an HTTP (code, body) pair.

        Reference: the Cosmos package `update` + CLI update section
        (cli/commands.go:39,56) push new options to a RUNNING
        scheduler; the rolling update then proceeds under the new
        target config exactly as a restart-with-new-env would."""
        if self.spec_source is None:
            return 409, {
                "message": "scheduler was not started from a YAML source; "
                           "live update is unavailable"
            }
        if not isinstance(env, dict) or not env or not all(
            isinstance(k, str) and isinstance(v, str) for k, v in env.items()
        ):
            return 400, {"message": "body must be {\"env\": {str: str}}"}
        with self._update_lock:
            return self._update_options_locked(env)

    def _update_options_locked(self, env: Dict[str, str]):
        from dcos_commons_tpu_torch.specification.validation import (
            ConfigValidationError,
            ValidationContext,
            validate_spec_change,
        )

        merged = self._stored_options()
        merged.update(env)
        try:
            new_spec = self._render_spec(merged)
        except Exception as e:
            return 400, {"message": f"spec render failed: {e}"}
        scheduler = self.scheduler
        old_spec = None
        if scheduler is not None and scheduler.config_store is not None:
            target = scheduler.config_store.get_target_config()
            if target:
                data = scheduler.config_store.fetch(target)
                if data is not None:
                    from dcos_commons_tpu_torch.specification.specs import (
                        ServiceSpec,
                    )

                    old_spec = ServiceSpec.from_dict(data)
        try:
            validate_spec_change(
                old_spec,
                new_spec,
                context=ValidationContext(
                    deployment_completed=(
                        scheduler.state_store.deployment_was_completed()
                        if scheduler is not None else None
                    ),
                    # a provider may also be wired programmatically
                    # (builder_hook -> set_secrets_provider); the built
                    # scheduler carries it
                    secrets_provider_present=(
                        bool(self.config.secrets_dir)
                        or getattr(scheduler, "secrets_provider", None)
                        is not None
                    ),
                    auth_token_present=(
                        bool(self.config.auth_token)
                        if self.agent_urls else None
                    ),
                ),
            )
        except ConfigValidationError as e:
            return 400, {"message": "invalid update", "errors": e.errors}
        # remember the pre-update node so a rebuild failure (build()
        # can fail for non-validation reasons) can roll it back —
        # otherwise the poisoned overrides re-apply and re-fail on
        # every restart.  Only the FIRST update since the last
        # successful rebuild snapshots: its value is the last one a
        # build actually validated.
        options_store = OptionsStore(self._persister)
        if not self._options_dirty:
            self._options_rollback = options_store.snapshot_raw()
            self._options_dirty = True
        options_store.store(merged)
        # stop only the event-loop thread; _run_locked sees the reload
        # flag, rebuilds over the same persister/agent, and swaps the
        # API server's scheduler — the process and socket survive
        self._reload_requested.set()
        if scheduler is not None:
            scheduler.stop()
        return 200, {
            "message": "update accepted; rolling update beginning",
            "env": sorted(env),
        }

    def _rollback_options(self) -> None:
        """Restore the options node to its pre-update value after a
        failed rebuild, so the next restart renders the last-good
        spec instead of re-failing on the poisoned overrides."""
        with self._update_lock:
            if not self._options_dirty:
                return
            if self._reload_requested.is_set():
                # another update was validated, persisted, and
                # acknowledged (HTTP 200) while this rebuild was
                # failing — its node value must survive; the restart
                # will render IT, not the poisoned intermediate
                LOG.warning(
                    "rebuild failed but a newer accepted update is "
                    "pending; leaving its options in place"
                )
                return
            prev = self._options_rollback
            try:
                OptionsStore(self._persister).restore_raw(prev)
                LOG.warning(
                    "rolled options back to pre-update value after "
                    "rebuild failure"
                )
                self._options_rollback = None
                self._options_dirty = False
            except Exception:
                LOG.exception("options rollback failed")

    def run(self) -> int:
        """Lock -> build -> serve -> loop.  Returns a process exit code."""
        if not self._lock.acquire():
            if self._stop_requested.is_set():
                # an HA standby asked to stop while candidating: a
                # clean exit, not a lock conflict — a supervisor must
                # not treat the operator's own stop as a crash
                LOG.info("stopped while standing by for the lease")
                return 0
            LOG.error(
                "another scheduler instance holds the lock for %s",
                self.config.state_dir,
            )
            return EXIT_LOCKED
        try:
            return self._run_locked()
        finally:
            self._lock.release()

    def _run_locked(self) -> int:
        from dcos_commons_tpu_torch.http.server import ApiServer

        try:
            self.build()
        except Exception:
            LOG.exception("invalid configuration")
            return EXIT_BAD_CONFIG
        # API up before the loop starts taking work, so operators can
        # always observe (FrameworkRunner.java:130-138)
        extra_routes = self._make_extra_routes()
        self.api_server = ApiServer(
            self.scheduler,
            port=self.config.api_port,
            host=self.api_bind,
            extra_routes=extra_routes,
            auth_token=self.config.auth_token,
            tls=self.config.api_tls,
        ).start()
        thread = None
        try:
            self._set_artifact_base()
            if self.announce_file:
                from dcos_commons_tpu_torch.common import atomic_write_text

                atomic_write_text(
                    self.announce_file, self.api_server.url + "\n"
                )
            LOG.info(
                "serving %s on %s (%d hosts, %s agents)",
                self.spec.name,
                self.api_server.url,
                len(self.topology_hosts),
                "remote" if self.agent_urls else "local",
            )
            lease = getattr(self._lock, "lease", None)
            if lease is not None:
                LOG.info(
                    "HA leader for %s at lease epoch %d "
                    "(failover state at %s/v1/debug/ha)",
                    self.spec.name, lease.epoch, self.api_server.url,
                )
            tracer = getattr(self.scheduler, "tracer", None)
            if tracer is not None and tracer.enabled:
                # the causal timeline operators join sandbox logs
                # against: GET /v1/debug/trace (text) or ?fmt=chrome
                # (Perfetto-loadable)
                LOG.info(
                    "flight recorder: %d spans at %s/v1/debug/trace",
                    tracer.capacity, self.api_server.url,
                )
            thread = self.scheduler.run_forever()
            try:
                while not self._stop_requested.is_set():
                    thread.join(timeout=0.5)
                    if self._reload_requested.is_set():
                        # live update: the loop (not the HTTP thread)
                        # owns the swap.  Checked EVERY iteration so an
                        # update landing at any moment — including just
                        # after a previous rebuild — is applied; stop
                        # is idempotent.  Rebuild over the SAME
                        # persister/agent/inventory; the process and
                        # its socket survive.
                        self.scheduler.stop()
                        thread.join(timeout=10)
                        self._reload_requested.clear()
                        try:
                            self.build()
                        except Exception:
                            LOG.exception("rebuild after update failed")
                            self._rollback_options()
                            return EXIT_BAD_CONFIG
                        # clear the rollback only when no further
                        # update is already pending — and under the
                        # update lock, so a concurrent handler's
                        # snapshot can't be clobbered
                        with self._update_lock:
                            if not self._reload_requested.is_set():
                                self._options_rollback = None
                                self._options_dirty = False
                        self._set_artifact_base()
                        self.api_server.set_scheduler(self.scheduler)
                        self.api_server.set_extra_routes(
                            self._make_extra_routes()
                        )
                        LOG.info("live update applied; scheduler rebuilt")
                        thread = self.scheduler.run_forever()
                        continue
                    if not thread.is_alive():
                        break  # loop died on its own (wedge etc.)
                    if self._uninstall_finished():
                        break
            except KeyboardInterrupt:
                pass
        finally:
            self.scheduler.stop()
            if thread is not None:
                thread.join(timeout=10)
            self.api_server.stop()
        if self._lease_lost:
            # another scheduler may already be active over this state
            LOG.critical("exiting after lease loss: %s", self._lease_lost)
            return EXIT_LOCKED
        fatal = getattr(self.scheduler, "fatal_error", None)
        if fatal:
            LOG.critical("scheduler wedged: %s", fatal)
            return EXIT_WEDGED
        return 0

    def _make_extra_routes(self) -> list:
        """Custom framework endpoints + the live-update route.  Rebuilt
        on every live update because routes_hook handlers close over
        the scheduler object."""
        extra = (
            list(self.routes_hook(self.scheduler))
            if self.routes_hook is not None else []
        )
        # live options update (reference: the Cosmos/CLI `update` flow)
        extra.append((
            "POST", r"/v1/update",
            lambda m, q, body: self.update_options(body.get("env")),
            True,
        ))
        return extra

    def _set_artifact_base(self) -> None:
        if hasattr(self.scheduler, "artifact_base") and self.agent_urls:
            # URL-mode template pulls are for REMOTE agents only: an
            # in-process agent fetching from this scheduler's own API
            # while the event loop holds its lock would deadlock —
            # local agents get template content inline
            self.scheduler.artifact_base = (
                self.advertise_url.rstrip("/") or self.api_server.url
            )

    def _uninstall_finished(self) -> bool:
        if not self.config.uninstall:
            return False
        is_complete = getattr(self.scheduler, "is_complete", None)
        if callable(is_complete):
            is_complete = is_complete()
        return bool(is_complete)

    def stop(self) -> None:
        self._stop_requested.set()
        abort = getattr(self._lock, "abort", None)
        if callable(abort):
            abort()  # release a candidate parked in acquire()
        if self.scheduler is not None:
            self.scheduler.stop()


class MultiFrameworkRunner:
    """One framework process hosting N services (reference:
    MultiServiceRunner + Multi*Resource routing).  Services are seeded
    from svc.yml args and managed dynamically over
    PUT/DELETE /v1/multi/<name>; the ServiceStore persists the set so
    restarts reload every service mid-plan."""

    def __init__(
        self,
        specs: List,
        config: Optional[SchedulerConfig] = None,
        topology_hosts: Optional[List[GpuHost]] = None,
        agent_urls: Optional[Dict[str, str]] = None,
        builder_hook=None,
    ):
        self.specs = list(specs)
        self.config = config or SchedulerConfig.from_env()
        self.topology_hosts = topology_hosts or []
        self.agent_urls = agent_urls or {}
        self.builder_hook = builder_hook
        self.multi = None
        self.api_server = None
        self.announce_file: str = ""
        self.api_bind: str = "127.0.0.1"
        self.advertise_url: str = ""
        self._stop_requested = threading.Event()
        self._lock = make_instance_lock(self.config, "multi-scheduler")
        self._lease_lost: Optional[str] = None
        # same CuratorLocker-style fatality as FrameworkRunner
        FrameworkRunner._wire_lease_loss(self)

    def build(self) -> None:
        from dcos_commons_tpu_torch.multi import MultiServiceScheduler
        from dcos_commons_tpu_torch.offer.inventory import SliceInventory

        inventory = SliceInventory(self.topology_hosts)
        if self.agent_urls:
            from dcos_commons_tpu_torch.agent.remote import RemoteFleet

            fleet = RemoteFleet(
                on_host_down=inventory.mark_down,
                on_host_up=inventory.mark_up,
                auth_token=self.config.auth_token,
                ca_file=self.config.tls_ca_file,
            )
            for host_id, url in self.agent_urls.items():
                fleet.add_host(host_id, url)
            agent = fleet
        else:
            from dcos_commons_tpu_torch.agent.local import LocalProcessAgent

            agent = LocalProcessAgent(self.config.sandbox_root)
        from dcos_commons_tpu_torch.scheduler.builder import make_persister

        persister = make_persister(self.config)
        ha_state = None
        lease = getattr(self._lock, "lease", None)
        if lease is not None:
            from dcos_commons_tpu_torch.ha.election import (
                FencedPersister,
                HAState,
            )

            persister = FencedPersister(persister, lease)
            ha_state = HAState(persister, lease.name, lease=lease)
        self.multi = MultiServiceScheduler(
            persister=persister,
            inventory=inventory,
            agent=agent,
            scheduler_config=self.config,
            builder_hook=(
                (lambda b: self.builder_hook(b, None))
                if self.builder_hook else None
            ),
            ha_state=ha_state,
        )
        for spec in self.specs:
            if self.multi.get_service(spec.name) is None:
                self.multi.add_service(spec)

    def run(self) -> int:
        if not self._lock.acquire():
            if self._stop_requested.is_set():
                # see FrameworkRunner.run: an aborted HA candidate is
                # a clean stop, not a lock conflict
                LOG.info("stopped while standing by for the lease")
                return 0
            LOG.error("another scheduler instance holds the lock")
            return EXIT_LOCKED
        try:
            return self._run_locked()
        finally:
            self._lock.release()

    def _run_locked(self) -> int:
        from dcos_commons_tpu_torch.http.server import ApiServer

        try:
            self.build()
        except Exception:
            LOG.exception("invalid configuration")
            return EXIT_BAD_CONFIG
        self.api_server = ApiServer(
            port=self.config.api_port, host=self.api_bind, multi=self.multi,
            auth_token=self.config.auth_token, tls=self.config.api_tls,
        ).start()
        thread = None
        try:
            if self.agent_urls:
                # see FrameworkRunner: URL-mode templates only for
                # remote fleets; local agents take content inline
                self.multi.artifact_base = (
                    self.advertise_url.rstrip("/") or self.api_server.url
                )
            if self.announce_file:
                from dcos_commons_tpu_torch.common import atomic_write_text

                atomic_write_text(
                    self.announce_file, self.api_server.url + "\n"
                )
            LOG.info(
                "serving %d services on %s (%d hosts)",
                len(self.multi.service_names()),
                self.api_server.url,
                len(self.topology_hosts),
            )
            thread = self.multi.run_forever()
            try:
                while thread.is_alive() and not self._stop_requested.is_set():
                    thread.join(timeout=0.5)
            except KeyboardInterrupt:
                pass
        finally:
            self.multi.stop()
            if thread is not None:
                thread.join(timeout=10)
            self.api_server.stop()
        if self._lease_lost:
            LOG.critical("exiting after lease loss: %s", self._lease_lost)
            return EXIT_LOCKED
        if getattr(self.multi, "fatal_error", None):
            LOG.critical("multi scheduler wedged: %s", self.multi.fatal_error)
            return EXIT_WEDGED
        return 0

    def stop(self) -> None:
        self._stop_requested.set()
        abort = getattr(self._lock, "abort", None)
        if callable(abort):
            abort()  # release a candidate parked in acquire()
        if self.multi is not None:
            self.multi.stop()


def serve_main(
    argv: Optional[List[str]] = None, builder_hook=None, routes_hook=None
) -> int:
    """``python -m dcos_commons_tpu_torch serve`` argument handling."""
    import argparse

    from dcos_commons_tpu_torch.specification.yaml_spec import from_yaml_file

    parser = argparse.ArgumentParser(
        prog="dcos_commons_tpu_torch serve",
        description="Run a service scheduler process",
    )
    parser.add_argument(
        "svc_yml",
        nargs="*",
        help="service definition YAML(s); exactly one unless --multi",
    )
    parser.add_argument(
        "--topology", required=True, help="fleet topology YAML (hosts)"
    )
    parser.add_argument(
        "--multi",
        action="store_true",
        help="host MANY services in one framework process; services are "
             "seeded from svc_yml args and managed dynamically over "
             "PUT/DELETE /v1/multi/<name>",
    )
    parser.add_argument("--port", type=int, default=None, help="API port")
    parser.add_argument("--state-dir", default=None)
    parser.add_argument(
        "--state-url",
        default=None,
        help="cluster state server URL (remote persistence + lease "
             "lock; omit for local file WAL state)",
    )
    parser.add_argument(
        "--ha",
        action="store_true",
        help="HA leader election (requires --state-url): extra "
             "scheduler processes become hot standbys that take over "
             "on leader death; store writes are lease-epoch fenced "
             "(also $SDK_HA)",
    )
    parser.add_argument(
        "--secrets-dir",
        default=None,
        help="operator-managed secrets directory (FileSecretsProvider)",
    )
    parser.add_argument("--sandbox-root", default=None)
    parser.add_argument(
        "--trace-capacity",
        type=int,
        default=None,
        help="flight-recorder span capacity (0 disables tracing; "
             "also $TRACE_CAPACITY)",
    )
    parser.add_argument(
        "--env",
        action="append",
        default=[],
        metavar="KEY=VALUE",
        help="extra env for svc.yml template interpolation",
    )
    parser.add_argument(
        "--announce-file",
        default="",
        help="write the API URL here once listening (ephemeral ports)",
    )
    parser.add_argument(
        "--bind",
        default="127.0.0.1",
        help="API bind address (0.0.0.0 for multi-host fleets)",
    )
    parser.add_argument(
        "--advertise-url",
        default="",
        help="externally-reachable API URL handed to agents for "
             "artifact pulls (required when agents run on other hosts)",
    )
    parser.add_argument(
        "--auth-token-file",
        default="",
        help="cluster bearer token file — required on every control-"
             "plane request (API, agents, state server) when set; "
             "also $AUTH_TOKEN(_FILE)",
    )
    parser.add_argument("--tls-cert", default="",
                        help="serve the API over HTTPS: cert PEM")
    parser.add_argument("--tls-key", default="",
                        help="serve the API over HTTPS: key PEM")
    parser.add_argument(
        "--tls-ca", default="",
        help="CA bundle for verifying agent/state-server HTTPS; "
             "also $TLS_CA_FILE",
    )
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=os.environ.get("LOG_LEVEL", "INFO"),
        format="%(asctime)s %(levelname)s %(name)s %(message)s",
    )
    env = dict(os.environ)
    for pair in args.env:
        key, _, value = pair.partition("=")
        env[key] = value
    config = SchedulerConfig.from_env(env)
    if args.port is not None:
        config.api_port = args.port
    if args.state_dir is not None:
        config.state_dir = args.state_dir
    if args.state_url is not None:
        config.state_url = args.state_url
    if args.ha:
        config.ha_enabled = True
    if config.ha_enabled and not config.state_url:
        print(
            "configuration error: --ha requires --state-url (the "
            "leader lease lives in the replicated state tree)",
            file=sys.stderr,
        )
        return EXIT_BAD_CONFIG
    if args.secrets_dir is not None:
        config.secrets_dir = args.secrets_dir
    if args.sandbox_root is not None:
        config.sandbox_root = args.sandbox_root
    if args.trace_capacity is not None:
        config.trace_capacity = args.trace_capacity
    if args.auth_token_file:
        from dcos_commons_tpu_torch.security.auth import load_token

        config.auth_token = load_token(token_file=args.auth_token_file)
    if args.tls_cert:
        config.tls_cert_file = args.tls_cert
    if args.tls_key:
        config.tls_key_file = args.tls_key
    if args.tls_ca:
        config.tls_ca_file = args.tls_ca
    try:
        config.api_tls  # half a cert/key pair is a config error
    except ValueError as e:
        print(f"configuration error: {e}", file=sys.stderr)
        return EXIT_BAD_CONFIG
    if not config.auth_token and args.bind not in (
        "127.0.0.1", "localhost", "::1"
    ):
        print(
            "WARNING: scheduler API bound on a non-loopback address with "
            "NO auth token — any reachable client can drive plans and "
            "kill tasks. Pass --auth-token-file "
            "(see security/auth.py trust model).",
            file=sys.stderr,
        )
    try:
        if not args.multi and len(args.svc_yml) != 1:
            raise ValueError(
                "exactly one svc.yml required (or pass --multi)"
            )
        specs = [from_yaml_file(path, env) for path in args.svc_yml]
        hosts, urls = load_topology(args.topology)
    except Exception as e:
        print(f"configuration error: {e}", file=sys.stderr)
        return EXIT_BAD_CONFIG
    if args.multi:
        if routes_hook is not None:
            # silent dropping would make a framework's discovery
            # endpoint vanish with no hint; refuse loudly
            print(
                "configuration error: custom routes (routes_hook) are "
                "not supported with --multi",
                file=sys.stderr,
            )
            return EXIT_BAD_CONFIG
        runner = MultiFrameworkRunner(
            specs, config, topology_hosts=hosts, agent_urls=urls,
            builder_hook=builder_hook,
        )
    else:
        runner = FrameworkRunner(
            specs[0], config, topology_hosts=hosts, agent_urls=urls,
            builder_hook=builder_hook,
            spec_source=(args.svc_yml[0], env),
        )
        runner.routes_hook = routes_hook
    runner.announce_file = args.announce_file
    runner.api_bind = args.bind
    runner.advertise_url = args.advertise_url

    def _sigterm(signum, frame):
        runner.stop()

    signal.signal(signal.SIGTERM, _sigterm)
    signal.signal(signal.SIGINT, _sigterm)
    return runner.run()

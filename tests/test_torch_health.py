"""The port's health plane (``dcos_commons_tpu_torch/health``) against
the JAX package's, on the CPU.

- The journal: the same seeded events (kinds, messages, attributes,
  times) through both packages' ``EventJournal`` over a
  ``PersisterBackend`` with a bounded capacity, flushed as they come:
  the same persisted bytes after every flush, the same replay by a
  second journal over the store, and each package's journal replays
  and continues the other's.
- The detectors on one seeded numpy metric series: straggler scores
  and alerts over steplogs with a slowed host, serving-SLO breaches,
  quiet episodes and stale discards over engine gauges, and lease
  churn over an epoch series: the same events, scores and episode
  state after every round; the pure rule (``decide``,
  ``scale_out_target``, ``median_ratio_scores``) on a seeded grid.
- The monitor and the action engine on twin schedulers
  (``test_torch_scheduler``'s wiring) serving the port's svc_serve.yml
  against frameworks/jax/'s, the agents' serving gauges a seeded
  breach then a quiet tail: the same launches, kills and plan statuses
  every cycle, the same detector events, scale-out and scale-in
  phases, ``describe`` output and sampled counter history, and the
  same WAL.
- The reference's property cases (tests/test_health_properties.py) run
  on the port."""

import itertools
import os

import numpy as np
import pytest

import dcos_commons_tpu.health.journal as j_journal
import dcos_commons_tpu_torch.health.journal as t_journal
from dcos_commons_tpu.health import actions as j_actions
from dcos_commons_tpu.health import detectors as j_detectors
from dcos_commons_tpu.storage import MemPersister as JMem
from dcos_commons_tpu_torch.health import actions as t_actions
from dcos_commons_tpu_torch.health import detectors as t_detectors
from dcos_commons_tpu_torch.storage import MemPersister as TMem
from test_torch_plan import _port_cases
from test_torch_scheduler import (
    PACKAGES,
    Clock,
    compare_wals,
    _render_with,
    make_test_fleet,
    pinned,  # noqa: F401 — a fixture
    twins,
)

JOURNAL = {"jax": j_journal, "port": t_journal}
MEM = {"jax": JMem, "port": TMem}
DETECTORS = {"jax": j_detectors, "port": t_detectors}
ACTIONS = {"jax": j_actions, "port": t_actions}

PROPERTY_CASES = _port_cases("test_health_properties.py")


def _case_names(module):
    return sorted(n for n in vars(module) if n.startswith("test_"))


def test_every_reference_case_is_run():
    assert len(_case_names(PROPERTY_CASES)) == 3


@pytest.mark.parametrize("name", _case_names(PROPERTY_CASES))
def test_health_property_on_the_port(name):
    getattr(PROPERTY_CASES, name)()


# -- the journal --------------------------------------------------------


def _events(seed=0, n=40):
    """A seeded event stream: (kind, message, attrs, seconds since the
    last event)."""
    rng = np.random.default_rng(seed)
    kinds = ("plan", "operator", "alert", "health", "recovery")
    out = []
    for i in range(n):
        kind = kinds[int(rng.integers(len(kinds)))]
        attrs = {"step": f"s-{int(rng.integers(5))}",
                 "value": round(float(rng.normal(1.0, 0.3)), 6),
                 "count": int(rng.integers(100)),
                 "flag": bool(rng.integers(2)),
                 "skip": None}
        out.append((kind, f"event {i}" if i % 3 else "", attrs,
                    float(rng.uniform(0.0, 2.0))))
    return out


def _journal_run(name, monkeypatch, capacity=16):
    mod = JOURNAL[name]
    clock = Clock()
    monkeypatch.setattr(mod, "time", clock)
    persister = MEM[name]()
    journal = mod.EventJournal(mod.PersisterBackend(persister),
                               capacity=capacity)
    blobs = []
    for i, (kind, message, attrs, dt) in enumerate(_events()):
        clock.t += dt
        journal.append(kind, message=message, **attrs)
        if i % 5 == 4:
            assert journal.flush()
            blobs.append(persister.get(mod.JOURNAL_PATH))
    assert not journal.flush()   # clean after the last flush
    replay = mod.EventJournal(mod.PersisterBackend(persister),
                              capacity=capacity)
    return persister, blobs, (replay.events(), replay.last_seq,
                              replay.events(since=30, kinds=("alert",)),
                              replay.describe())


def test_journal_bytes_and_replay_match(monkeypatch):
    jax_run = _journal_run("jax", monkeypatch)
    port_run = _journal_run("port", monkeypatch)
    assert port_run[1] == jax_run[1]
    assert port_run[2] == jax_run[2]
    events, seq, _, described = jax_run[2]
    assert seq == 40 and len(events) == 16   # the capacity bound
    assert described["capacity"] == 16


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_journal_continues_across_packages(writer, reader, monkeypatch):
    """The reader's journal over the writer's store picks up its seq and
    events, appends and flushes: the bytes equal the writer's own
    journal doing the same."""
    persister, _, _ = _journal_run(writer, monkeypatch)
    out = []
    for name in (writer, reader):
        mod = JOURNAL[name]
        clock = Clock(2_000_000_000.0)
        monkeypatch.setattr(mod, "time", clock)
        store = MEM[name]()
        store.set(mod.JOURNAL_PATH, persister.get(mod.JOURNAL_PATH))
        journal = mod.EventJournal(mod.PersisterBackend(store), capacity=16)
        journal.append("operator", message="after", verb="restart")
        journal.flush()
        out.append(store.get(mod.JOURNAL_PATH))
    assert out[1] == out[0]


# -- the detectors ------------------------------------------------------


def _straggler_run(name, rounds=14, hosts=6, seed=1):
    det = DETECTORS[name].StragglerDetector(threshold=2.0, window=6)
    rng = np.random.default_rng(seed)
    logs = {f"h{i}": [] for i in range(hosts)}
    out = []
    for r in range(rounds):
        for i in range(hosts):
            wall = float(rng.lognormal(0.0, 0.1))
            if i == 3 and 4 <= r < 9:
                wall *= 3.0            # a slowed host, then its recovery
            logs[f"h{i}"].append({"wall_s": wall,
                                  "blocked_s": float(rng.uniform(0, 0.1))})
        # host h5 runs two tasks: two series
        view = {h: list(v) for h, v in logs.items()}
        view["h5"] = [list(logs["h5"]), list(logs["h4"])]
        out.append((det.observe(view), dict(det.scores),
                    dict(det.suspects)))
    return out


def _serving_series(seed=2, rounds=16, tasks=3):
    rng = np.random.default_rng(seed)
    series = []
    for r in range(rounds):
        stats = {}
        for i in range(tasks):
            load = 1.6 if 3 <= r < 8 else (0.02 if r >= 11 else 0.4)
            stats[f"server-{i}-api"] = {
                "ttft_p95_s": float(load * rng.uniform(0.8, 1.2)),
                "queue_depth": float(rng.integers(0, 12)),
                "kv_occupancy": float(rng.uniform(0.1, 0.99)),
                "kv_pages_free": float(rng.integers(0, 64)),
                "t": 1000.0 + r - (40.0 if (i == 2 and r == 6) else 0.0),
            }
        if r % 5 == 2:
            stats["server-1-api"]["serving_role"] = "prefill"
        series.append(stats)
    return series


def _slo_run(name):
    mod = DETECTORS[name]
    slo = mod.ServingSloWatcher(ttft_p95_slo_s=0.5, queue_depth_slo=10,
                                kv_occupancy_slo=0.95, kv_pages_free_slo=4,
                                stale_stats_s=30.0)
    quiet = mod.QuietPodWatcher(slo, quiet_factor=0.25)
    env = {"server-0-api": {"SERVE_TTFT_SLO_S": "0.6"}}
    out = []
    for r, stats in enumerate(_serving_series()):
        now = 1000.0 + r
        out.append((slo.observe(stats, env, now=now),
                    quiet.observe(stats, env, now=now),
                    dict(slo.breaches), dict(slo.breach_since),
                    dict(slo.breach_severity), slo.stale_discards,
                    dict(quiet.quiet_since)))
    return out


def _churn_run(name, seed=3):
    mod = DETECTORS[name]
    watcher = mod.LeaseChurnWatcher(churn_n=3, window_s=60.0)
    rng = np.random.default_rng(seed)
    epoch, t, out = 1, 0.0, []
    for _ in range(40):
        t += float(rng.uniform(1.0, 30.0))
        if rng.uniform() < 0.4:
            epoch += 1
        out.append((watcher.observe(epoch, t=t), watcher.alerted))
    return out


@pytest.mark.parametrize("run", [_straggler_run, _slo_run, _churn_run],
                         ids=["straggler", "serving-slo-and-quiet",
                              "lease-churn"])
def test_detectors_alert_as_the_jax_ones(run):
    jax_out, port_out = run("jax"), run("port")
    assert port_out == jax_out
    assert any(round_[0] for round_ in jax_out)   # the series alerts


def test_decision_rule_matches_on_a_seeded_grid():
    """``decide`` over a seeded grid of episode states, and the pure
    helpers beside it; ``scale_out_target`` keeps the reference's clamp
    to ``max_instances``, below the current count too."""
    rng = np.random.default_rng(4)
    grid = []
    for _ in range(400):
        now = float(rng.uniform(0, 1000))
        grid.append(dict(
            now=now, count=int(rng.integers(1, 6)),
            baseline=int(rng.integers(1, 4)),
            breach_since=(None if rng.uniform() < 0.4
                          else now - float(rng.uniform(0, 40))),
            severity=float(rng.uniform(1.0, 8.0)),
            quiet_since=(None if rng.uniform() < 0.4
                         else now - float(rng.uniform(0, 120))),
            active=[None, "out", "in"][int(rng.integers(3))] if
            rng.uniform() < 0.3 else None,
            hold=bool(rng.uniform() < 0.1),
            cooldown_out_until=now + float(rng.uniform(-60, 60)),
            cooldown_in_until=now + float(rng.uniform(-60, 60))))
    out = []
    for name in ("jax", "port"):
        mod = ACTIONS[name]
        policy = mod.ActionPolicy(autoscale=True, max_instances=4)
        decisions = []
        for point in grid:
            args = dict(point)
            d = mod.decide(args.pop("now"), policy=policy, **args)
            decisions.append(None if d is None else (d.direction, d.target))
        targets = [mod.scale_out_target(c, m, s)
                   for c, m, s in itertools.product(range(1, 7), range(1, 5),
                                                    (1.0, 1.9, 2.0, 4.5, 9.0))]
        scores = DETECTORS[name].median_ratio_scores(
            {f"h{i}": [float(v) for v in rng_row]
             for i, rng_row in enumerate(
                 np.random.default_rng(5).lognormal(0, 0.3, (7, 5)))})
        out.append((decisions, targets, scores))
    assert out[1] == out[0]
    assert {d[0] for d in out[0][0] if d} == {"out", "in"}
    # the kept defect: a pod above max_instances is "scaled out" to it
    assert ACTIONS["port"].scale_out_target(6, 4, 2.0) == 4


# -- the monitor and the action engine on twin schedulers ---------------


def _serve_specs():
    """svc_serve.yml with its TTFT SLO on (its knob defaults off)."""
    return [_render_with(pkg, os.path.join(pkg.frameworks, "svc_serve.yml"),
                         SERVE_TTFT_SLO_S="0.5")
            for pkg in PACKAGES]


def test_monitor_and_action_engine_act_as_the_jax_ones(pinned, tmp_path):
    """The svc_serve.yml server pod, the health plane inline (every
    observe samples, scores and flushes), autoscale on: a seeded TTFT
    breach scales it out, the quiet tail scales it back in."""
    series = _serving_series(rounds=40, tasks=4)
    stats_now = {}

    def extra(pkg):
        mod = pkg.health
        return {
            "health_monitor": mod.HealthMonitor(
                slo=mod.ServingSloWatcher(ttft_p95_slo_s=0.5,
                                          stale_stats_s=0.0),
                telemetry_interval_s=0.0, history_interval_s=0.0,
                flush_interval_s=0.0),
            "action_policy": mod.ActionPolicy(
                autoscale=True, max_instances=3, breach_hold_s=2.0,
                quiet_hold_s=4.0, cooldown_out_s=3.0, cooldown_in_s=3.0,
                drain_grace_s=1.0, drain_migrate=False),
        }

    sides = twins(_serve_specs(), make_test_fleet(host_grid=(3, 1),
                                                  chip_block=(2, 2)),
                  tmp_path, pinned, extra=extra)
    traces = []
    for side in sides:
        side.agent.serving_stats_of = (
            lambda name, agent_id=None, _s=stats_now: dict(
                _s.get(name, {})))
        trace = []
        for r in range(40):
            stats_now.clear()
            stats_now.update({k: {g: v for g, v in s.items() if g != "t"}
                              for k, s in series[r].items()})
            trace.append(side.cycle(fail_every=0))
            trace.append(("health", side.sched.health.describe(side.sched)
                          ["slo"], side.sched.actions.describe()))
        monitor = side.sched.health
        described = monitor.describe(side.sched)
        history = side.sched.metrics.history
        trace.append(("describe", {k: v for k, v in described.items()
                                   if k != "history"}))
        trace.append(("counters", {
            name: history.series(name)
            for name in sorted(history._counter_names)}))
        trace.append(("journal", side.sched.journal.events()))
        traces.append(trace)
        side.close()
    assert traces[1] == traces[0]
    verbs = [e.get("verb") for e in traces[0][-1][1]]
    assert "scale-out" in verbs and "scale-in" in verbs
    assert any(obs[0] == "cycle" and obs[1] for obs in traces[0][2:])
    compare_wals(sides[0].directory, sides[1].directory)

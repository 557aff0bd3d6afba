"""The port's multi-service mode (``dcos_commons_tpu_torch/multi``:
``MultiServiceScheduler``, ``ServiceStore``, the footprint disciplines
and admission) against the JAX package's, on the CPU.

Each case is a scenario of ``tests/test_multi_service.py`` written once
and run on twin objects: a JAX ``MultiServiceScheduler`` over a
``FakeAgent`` and three ``TpuHost``s, then the port's over three
``GpuHost``s.  Ids and store-visible clocks are pinned per package
(``pinned``).  A scenario returns what it observed (launches, kills,
plan statuses, service lists, HTTP bodies), and the two packages'
observations must be equal; so must the namespaced state trees, value
by value but for the designed differences (``same_tree``).

Admission (``PUT /v1/multi/<name>``) on GPU specs: the port's findings
for a ``gpu:`` spec equal the JAX package's for its ``tpu:`` twin by
rule and line, and by message but for the designed wording; a ``gpu:``
gang whose mesh does not span its cards is refused with a 422 carrying
them, and nothing is stored.  ``fleet_slice_count`` is held against the
JAX one on twin fleets."""

import importlib
import json
import random
import types
import urllib.error
import urllib.request

import pytest

from test_torch_builder import pinned, same_tree  # noqa: F401 — fixture
from test_torch_offer import gpu_yaml
from test_torch_speccheck import as_reference


def package(root, host):
    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    common = mod("common")
    multi = mod("multi")
    return types.SimpleNamespace(
        root=root, multi=multi,
        MultiServiceScheduler=multi.MultiServiceScheduler,
        Parallel=multi.ParallelFootprintDiscipline,
        ApiServer=mod("http").ApiServer,
        TaskState=common.TaskState, TaskStatus=common.TaskStatus,
        Host=getattr(mod("offer.inventory"), host),
        SliceInventory=mod("offer.inventory").SliceInventory,
        SchedulerConfig=mod("scheduler").SchedulerConfig,
        from_yaml=mod("specification.yaml_spec").from_yaml,
        MemPersister=mod("storage").MemPersister,
        FakeAgent=mod("testing").FakeAgent,
        admission=mod("multi.admission"),
        shardcheck=mod("analysis.shardcheck"),
    )


JAX = package("dcos_commons_tpu", "TpuHost")
PORT = package("dcos_commons_tpu_torch", "GpuHost")


def twin(scenario, *args):
    """Run ``scenario`` on both packages; the observations must be
    equal and so must the persisted trees.  Returns the port's
    observations."""
    want, jtree = scenario(JAX, *args)
    got, ttree = scenario(PORT, *args)
    assert got == want
    same_tree(jtree, ttree)
    return got


def svc_yaml(name, count=1):
    return f"""
name: {name}
pods:
  app:
    count: {count}
    tasks:
      main:
        goal: RUNNING
        cmd: "serve-{name}"
        cpus: 0.1
        memory: 32
"""


def make_multi(P, persister=None, agent=None, discipline=None, hosts=3):
    return P.MultiServiceScheduler(
        persister=persister or P.MemPersister(),
        inventory=P.SliceInventory(
            [P.Host(host_id=f"h{i}") for i in range(hosts)]),
        agent=agent or P.FakeAgent(),
        scheduler_config=P.SchedulerConfig(backoff_enabled=False),
        discipline=discipline,
    )


def running(P, task_id):
    return P.TaskStatus(task_id=task_id, state=P.TaskState.RUNNING,
                        ready=True)


def ack_running(P, multi, task_name):
    task_id = multi.agent.task_id_of(task_name)
    assert task_id, f"no launch for {task_name}"
    multi.agent.send(running(P, task_id))


def ack_active(P, multi):
    for info in multi.agent.launched:
        if info.task_id in multi.agent.active_task_ids():
            multi.agent.send(running(P, info.task_id))


def launches(multi):
    return [(info.name, info.agent_id, info.command)
            for info in multi.agent.launched]


def complete(multi, name):
    return multi.get_service(name).deploy_manager.get_plan().is_complete


def scenario_namespaced(P):
    multi = make_multi(P)
    multi.add_service(P.from_yaml(svc_yaml("alpha")))
    multi.add_service(P.from_yaml(svc_yaml("beta")))
    multi.run_cycle()
    ack_running(P, multi, "app-0-main")
    multi.run_cycle()
    for _ in range(4):
        for info in multi.agent.launched:
            multi.agent.send(running(P, info.task_id))
        multi.run_cycle()
    out = [complete(multi, "alpha"), complete(multi, "beta"),
           [multi.get_service(n).state_store.fetch_task("app-0-main").command
            for n in ("alpha", "beta")],
           launches(multi), multi.service_names(),
           multi.persister.get_children_or_empty("/")]
    return out, multi.persister.dump()


def test_two_services_share_fleet_with_namespaced_state(pinned):
    out = twin(scenario_namespaced)
    assert out[:3] == [True, True, ["serve-alpha", "serve-beta"]]
    assert len(out[3]) == 2


def scenario_footprint(P):
    multi = make_multi(P, discipline=P.Parallel(1))
    multi.add_service(P.from_yaml(svc_yaml("one")))
    multi.add_service(P.from_yaml(svc_yaml("two")))
    multi.run_cycle()
    out = [len(multi.agent.launched)]
    multi.agent.send(running(P, multi.agent.launched[0].task_id))
    multi.run_cycle()
    multi.run_cycle()
    out.append(launches(multi))
    return out, multi.persister.dump()


def test_footprint_discipline_serializes_growth(pinned):
    out = twin(scenario_footprint)
    assert out[0] == 1 and len(out[1]) == 2


def scenario_remove(P):
    multi = make_multi(P)
    multi.add_service(P.from_yaml(svc_yaml("gone")))
    multi.run_cycle()
    ack_running(P, multi, "app-0-main")
    multi.run_cycle()
    out = [complete(multi, "gone")]
    multi.uninstall_service("gone")
    for _ in range(5):
        multi.run_cycle()
    out += [multi.service_names(), multi.agent.killed_names(),
            multi.persister.get_children_or_empty("/gone"),
            multi.framework_store is not None]
    return out, multi.persister.dump()


def test_remove_service_uninstalls_and_drops(pinned):
    out = twin(scenario_remove)
    assert out[0] is True and out[1] == [] and "app-0-main" in out[2]
    assert out[3:] == [[], True]


def scenario_restart(P):
    persister = P.MemPersister()
    agent = P.FakeAgent()
    multi = make_multi(P, persister=persister, agent=agent)
    multi.add_service(P.from_yaml(svc_yaml("keep")))
    multi.run_cycle()
    ack_running(P, multi, "app-0-main")
    multi.run_cycle()
    reborn = make_multi(P, persister=persister, agent=agent)
    out = [reborn.service_names()]
    reborn.run_cycle()
    out += [complete(reborn, "keep"), len(agent.launched)]
    return out, persister.dump()


def test_restart_reloads_services_from_store(pinned):
    assert twin(scenario_restart) == [["keep"], True, 1]


def scenario_http(P):
    multi = make_multi(P)
    server = P.ApiServer(multi=multi).start()
    out = []
    try:
        def get(path):
            with urllib.request.urlopen(server.url + path) as resp:
                return json.loads(resp.read().decode())

        def send(method, path, data=None):
            req = urllib.request.Request(
                server.url + path, method=method,
                data=data.encode() if data else b"")
            with urllib.request.urlopen(req) as resp:
                return json.loads(resp.read().decode())

        out.append(get("/v1/multi"))
        out.append(send("PUT", "/v1/multi/websvc", svc_yaml("websvc")))
        out.append(get("/v1/multi"))
        multi.run_cycle()
        ack_running(P, multi, "app-0-main")
        multi.run_cycle()
        out.append(get("/v1/multi/websvc/v1/plans/deploy")["status"])
        out.append(get("/v1/multi/websvc/v1/pod"))
        out.append(send("DELETE", "/v1/multi/websvc"))
        for _ in range(5):
            multi.run_cycle()
        out.append(get("/v1/multi"))
    finally:
        server.stop()
    return out, multi.persister.dump()


def test_multi_http_surface(pinned):
    out = twin(scenario_http)
    assert out[0] == [] and out[2] == ["websvc"]
    assert out[3:5] == ["COMPLETE", ["app-0"]] and out[6] == []


def scenario_second_launch(P):
    multi = make_multi(P)
    multi.add_service(P.from_yaml(svc_yaml("alpha")))
    multi.run_cycle()
    ack_running(P, multi, "app-0-main")
    multi.run_cycle()
    alpha = multi.get_service("alpha")
    alpha_id = alpha.state_store.fetch_task("app-0-main").task_id
    multi.add_service(P.from_yaml(svc_yaml("beta")))
    for _ in range(4):
        multi.run_cycle()
        ack_active(P, multi)
    out = [alpha_id in multi.agent.kills,
           alpha_id in multi.agent.active_task_ids(),
           complete(multi, "alpha"), complete(multi, "beta"),
           launches(multi)]
    return out, multi.persister.dump()


def test_second_service_launch_does_not_kill_first(pinned):
    assert twin(scenario_second_launch)[:4] == [False, True, True, True]


def scenario_uninstall_one(P):
    multi = make_multi(P)
    multi.add_service(P.from_yaml(svc_yaml("keep")))
    multi.add_service(P.from_yaml(svc_yaml("gone")))
    for _ in range(4):
        multi.run_cycle()
        ack_active(P, multi)
    keep_id = multi.get_service("keep").state_store.fetch_task(
        "app-0-main").task_id
    gone_id = multi.get_service("gone").state_store.fetch_task(
        "app-0-main").task_id
    out = [complete(multi, "keep")]
    multi.uninstall_service("gone")
    for _ in range(5):
        multi.run_cycle()
    out += [multi.service_names(), gone_id in multi.agent.kills,
            keep_id in multi.agent.kills,
            keep_id in multi.agent.active_task_ids()]
    return out, multi.persister.dump()


def test_uninstall_one_service_spares_others(pinned):
    assert twin(scenario_uninstall_one) == [True, ["keep"], True, False,
                                            True]


def scenario_orphan_index(P):
    multi = make_multi(P, hosts=6)
    rng = random.Random(7)
    multi.add_service(P.from_yaml(svc_yaml("alpha", count=2)))
    multi.add_service(P.from_yaml(svc_yaml("beta", count=2)))
    trace = []

    def full_scan():
        return {info.task_id for service in multi.services().values()
                for info in service.state_store.fetch_tasks()}

    def check():
        services = multi.services()
        incremental = multi._expected_task_ids(services)
        assert incremental == full_scan()
        assert multi._expected_task_ids(services) == full_scan()
        trace.append(sorted(incremental))

    check()
    for _ in range(30):
        op = rng.choice(["cycle", "ack", "fail", "clear"])
        launched = list(multi.agent.launched)
        if op == "cycle":
            multi.run_cycle()
        elif op in ("ack", "fail") and launched:
            info = rng.choice(launched)
            state = P.TaskState.RUNNING if op == "ack" else \
                P.TaskState.FAILED
            multi.agent.send(P.TaskStatus(task_id=info.task_id,
                                          state=state, ready=op == "ack"))
            multi.run_cycle()
        elif op == "clear":
            service = multi.get_service(rng.choice(["alpha", "beta"]))
            names = service.state_store.fetch_task_names()
            if names:
                service.state_store.clear_task(rng.choice(names))
        check()
    multi.uninstall_service("beta")
    deadline = 40
    while "beta" in multi.services() and deadline:
        multi.run_cycle()
        check()
        deadline -= 1
    multi._expected_task_ids(multi.services())
    trace.append(["beta" in multi.services(), "beta" in multi._orphan_index])
    return trace, multi.persister.dump()


def test_orphan_index_equivalent_to_full_scan(pinned):
    trace = twin(scenario_orphan_index)
    assert trace[-1] == [False, False]


# -- admission on GPU specs ----------------------------------------------

TRAINER = """name: trainer
pods:
  trainer:
    count: {count}
    gang: true
    tpu:
      generation: v5e
      chips-per-host: {per_host}
      topology: {topology}
      slices: {slices}
    tasks:
      worker:
        goal: RUNNING
        cmd: "python {frameworks}/{script}"
        cpus: 1
        memory: 1024
        env:
          TRAIN_STEPS: "2"
"""
FRAMEWORKS = {"dcos_commons_tpu": "frameworks/jax",
              "dcos_commons_tpu_torch": "dcos_commons_tpu_torch/frameworks"}

# (script, count, chips per host, topology, slices): admitted; a gang
# whose single-card serve mesh does not span its 4 cards; a gang the
# validators refuse; a multi-slice span that disagrees with count; a
# multi-slice gang the fleet has too few slices for; a bad topology
ADMISSION_CASES = {
    "admitted": ("train_worker.py", 1, 4, "2x2", 1),
    "mesh-span": ("serve_worker.py", 2, 2, "2x2", 1),
    "validators": ("train_worker.py", 1, 1, "2x2", 1),
    "slice-span": ("train_worker.py", 3, 4, "2x2", 2),
    "too-few-slices": ("train_worker.py", 2, 4, "2x2", 2),
    "bad-topology": ("train_worker.py", 1, 4, "2xq", 1),
}


def trainer_yaml(P, script, count, per_host, topology, slices):
    text = TRAINER.format(count=count, per_host=per_host, topology=topology,
                          slices=slices, frameworks=FRAMEWORKS[P.root],
                          script=script)
    return gpu_yaml(text) if P is PORT else text


def admission_fleet(P):
    """One registered slice of four 4-chip hosts."""
    if P is JAX:
        hosts = [P.Host(host_id=f"h{i}", slice_id="s0", generation="v5e",
                        grid=(i, 0), chip_block=(2, 2), cpus=16,
                        memory_mb=65536) for i in range(4)]
    else:
        hosts = [P.Host(host_id=f"h{i}", slice_id="s0", generation="h100",
                        node=i, gpus=4, cpus=16, memory_mb=65536)
                 for i in range(4)]
    return P.SliceInventory(hosts)


def reference_wording(P):
    """The port's message in the JAX package's wording (the designed
    differences, and the fleet's generation by name)."""
    if P is JAX:
        return lambda m: m
    return lambda m: as_reference(m).replace(" h100 slice", " v5e slice")


def findings_of(P, case):
    text = trainer_yaml(P, *ADMISSION_CASES[case])
    try:
        spec, findings = P.admission.validate_service_yaml(
            text, "trainer", admission_fleet(P))
    except Exception as e:  # noqa: BLE001 — compared across packages
        return type(e).__name__, str(e)
    fix = reference_wording(P)
    return spec is not None, [(f.file, f.line, f.rule, fix(f.message))
                              for f in findings]


@pytest.mark.parametrize("case", sorted(ADMISSION_CASES))
def test_admission_findings_as_the_jax_package(case):
    """The port's findings for a ``gpu:`` trainer spec equal the JAX
    package's for its ``tpu:`` twin: the same rules at the same lines,
    the same messages once the ``gpu`` wording is mapped."""
    want = findings_of(JAX, case)
    got = findings_of(PORT, case)
    assert got == want
    if case == "bad-topology":
        assert got == ("SpecError", "bad topology '2xq'")
        return
    rules = {rule for _, _, rule, _ in got[1]}
    assert rules == {
        "admitted": set(), "mesh-span": {"shard-mesh"},
        "validators": {"spec-validators"},
        "slice-span": {"spec-validators", "multislice"},
        "too-few-slices": {"multislice"}}[case], got


def test_admission_tests_for_a_torch_profile():
    """``_targets_torch_profile`` (the reference's ``_targets_jax``)
    answers as the reference does for the same command shapes."""
    cmds = ["python dcos_commons_tpu_torch/frameworks/train_worker.py",
            "python x/serve_gang_worker.py", "python train_mnist.py",
            "sleep 10", "", "python serve_worker.py --port 1"]
    assert [PORT.admission._targets_torch_profile(c) for c in cmds] == [
        JAX.admission._targets_jax(c.replace("dcos_commons_tpu_torch/"
                                             "frameworks", "frameworks/jax"))
        for c in cmds] == [True, True, True, False, False, True]


def put_status(P, text):
    """PUT ``text`` at /v1/multi/trainer of an ``ApiServer`` over a
    multi scheduler on the admission fleet: (status, body, services,
    state tree under the service's name)."""
    multi = P.MultiServiceScheduler(
        persister=P.MemPersister(), inventory=admission_fleet(P),
        agent=P.FakeAgent(),
        scheduler_config=P.SchedulerConfig(backoff_enabled=False))
    server = P.ApiServer(multi=multi).start()
    try:
        req = urllib.request.Request(server.url + "/v1/multi/trainer",
                                     method="PUT", data=text.encode())
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                code, body = resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            code, body = e.code, json.loads(e.read())
    finally:
        server.stop()
    return (code, body, multi.service_names(),
            multi.persister.get_children_or_empty("/trainer"))


def test_put_refuses_a_gpu_gang_whose_mesh_does_not_span_its_cards():
    """A 2x2 ``gpu:`` gang of two 2-card hosts running the single-card
    serve worker reserves 4 cards for a 1-card mesh: 422, shardcheck's
    finding at the pod's line, nothing stored; the JAX package refuses
    its ``tpu:`` twin the same way.  The admitted trainer is stored and
    answers 200."""
    refused = {}
    for P in (JAX, PORT):
        code, body, names, tree = put_status(
            P, trainer_yaml(P, *ADMISSION_CASES["mesh-span"]))
        assert (code, names, tree) == (422, [], [])
        fix = reference_wording(P)
        refused[P.root] = [dict(f, message=fix(f["message"]))
                           for f in body["findings"]]
    assert refused["dcos_commons_tpu_torch"] == refused["dcos_commons_tpu"]
    assert [f["rule"] for f in refused["dcos_commons_tpu"]] == ["shard-mesh"]
    assert refused["dcos_commons_tpu"][0]["line"] == 3
    for P in (JAX, PORT):
        code, _body, names, _tree = put_status(
            P, trainer_yaml(P, *ADMISSION_CASES["admitted"]))
        assert (code, names) == (200, ["trainer"])


def fleets():
    """Twin fleets for ``fleet_slice_count``: (JAX hosts, port hosts)."""
    layouts = {
        "empty": [],
        "cpu only": [("c0", "", ""), ("c1", "", "")],
        "one slice": [("a0", "s0", "g"), ("a1", "s0", "g")],
        "two slices": [("a0", "s0", "g"), ("b0", "s1", "g"),
                       ("c0", "", "")],
        "mixed generations": [("a0", "s0", "g"), ("b0", "s1", "other"),
                              ("b1", "s2", "other")],
    }
    out = {}
    for name, hosts in layouts.items():
        out[name] = tuple(
            [P.Host(host_id=h, slice_id=s,
                    generation={"g": G, "other": O}.get(gen, ""))
             for h, s, gen in hosts]
            for P, G, O in ((JAX, "v5e", "v4"), (PORT, "h100", "a100")))
    return out


@pytest.mark.parametrize("layout", sorted(fleets()))
def test_fleet_slice_count_as_the_jax_one(layout):
    jhosts, thosts = fleets()[layout]
    jinv, tinv = JAX.SliceInventory(jhosts), PORT.SliceInventory(thosts)
    for jgen, tgen in (("v5e", "h100"), ("v4", "a100"), ("v6e", "b200")):
        want = JAX.shardcheck.fleet_slice_count(jinv, jgen)
        assert PORT.shardcheck.fleet_slice_count(tinv, tgen) == want
    assert PORT.shardcheck.fleet_slice_count(None, "h100") is None
    assert JAX.shardcheck.fleet_slice_count(None, "v5e") is None
    expected = {"empty": None, "cpu only": None, "one slice": 1,
                "two slices": 2, "mixed generations": 1}[layout]
    assert PORT.shardcheck.fleet_slice_count(tinv, "h100") == expected

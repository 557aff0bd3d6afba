"""The port's spec side of the GPU resource model against the JAX
package's: ``dcos_commons_tpu_torch/specification`` (specs, the YAML
front end, the validators), the placement parser and the options
renderer it needs, and the port's framework YAMLs, on the CPU.

Every YAML under frameworks/helloworld, hdfs and cassandra, rendered
with its options.json defaults, parses to the same ServiceSpec through
both packages (neither has a resource block there), or is refused by
both with an error of the same class; the port's five YAMLs equal
their frameworks/jax counterparts field for field but the resource
block and the script path; ``GpuSpec.mesh_env`` gives the env contract
of ``TpuSpec.mesh_env`` for the same fields but the generation."""

import dataclasses
import enum
import glob
import os

import pytest

from dcos_commons_tpu.offer import placement as j_placement
from dcos_commons_tpu.specification import specs as j_specs
from dcos_commons_tpu.specification import validation as j_validation
from dcos_commons_tpu.specification import yaml_spec as j_yaml
from dcos_commons_tpu.tools import options as j_options
from dcos_commons_tpu_torch.offer import placement as t_placement
from dcos_commons_tpu_torch.specification import specs as t_specs
from dcos_commons_tpu_torch.specification import validation as t_validation
from dcos_commons_tpu_torch.specification import yaml_spec as t_yaml
from dcos_commons_tpu_torch.tools import options as t_options

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FRAMEWORKS = os.path.join(REPO, "dcos_commons_tpu_torch", "frameworks")
JAX_FRAMEWORKS = os.path.join(REPO, "frameworks", "jax")
REFERENCE_YAMLS = sorted(
    os.path.relpath(p, REPO)
    for name in ("helloworld", "hdfs", "cassandra")
    for p in glob.glob(os.path.join(REPO, "frameworks", name, "*.yml"))
)
PORT_YAMLS = ("svc.yml", "svc_mnist.yml", "svc_serve.yml",
              "svc_serve_gang.yml", "svc_router.yml")


def _plain(value):
    """``dataclasses.asdict`` output with enums by value, so the two
    packages' GoalState classes compare."""
    if isinstance(value, enum.Enum):
        return value.value
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    return value


def _asdict(spec, block):
    """The spec as plain data, each pod's resource block (``block``:
    ``tpu`` or ``gpu``) taken out and returned beside it."""
    data = _plain(dataclasses.asdict(spec))
    blocks = [pod.pop(block) for pod in data["pods"]]
    return data, blocks


def _render_env(framework_dir, options_mod):
    schema = options_mod.load_schema(framework_dir)
    return options_mod.render_options(schema, {}) if schema else {}


def _parse(yaml_mod, options_mod, path):
    env = _render_env(os.path.dirname(path), options_mod)
    try:
        return yaml_mod.from_yaml_file(path, env), None
    except Exception as e:  # noqa: BLE001 — compared across packages
        return None, e


@pytest.mark.parametrize("rel", REFERENCE_YAMLS)
def test_reference_yamls_parse_to_the_same_service_spec(rel):
    path = os.path.join(REPO, rel)
    want, want_err = _parse(j_yaml, j_options, path)
    got, got_err = _parse(t_yaml, t_options, path)
    if want_err is not None:
        assert got_err is not None, f"the port accepts what JAX refuses: {want_err}"
        assert type(got_err).__name__ == type(want_err).__name__
        assert str(got_err) == str(want_err)
        return
    assert got_err is None, got_err
    want_data, tpu = _asdict(want, "tpu")
    got_data, gpu = _asdict(got, "gpu")
    assert tpu == [None] * len(tpu) and gpu == [None] * len(gpu)
    assert got_data == want_data
    # the stored form reads back to an equal spec
    assert t_specs.ServiceSpec.from_dict(got.to_dict()) == got
    # the validators agree on a fresh deploy of it
    errors = []
    for validation in (j_validation, t_validation):
        spec = want if validation is j_validation else got
        try:
            validation.validate_spec_change(None, spec)
            errors.append(None)
        except validation.ConfigValidationError as e:
            errors.append(e.errors)
    assert errors[0] == errors[1]


@pytest.mark.parametrize("name", PORT_YAMLS)
def test_port_yamls_equal_the_jax_ones_but_the_resource_block(name):
    want, err = _parse(j_yaml, j_options, os.path.join(JAX_FRAMEWORKS, name))
    assert err is None, err
    got, err = _parse(t_yaml, t_options, os.path.join(PORT_FRAMEWORKS, name))
    assert err is None, err
    want_data, tpus = _asdict(want, "tpu")
    got_data, gpus = _asdict(got, "gpu")
    # the script paths: the port's workers, under its own package
    for pod in want_data["pods"]:
        for task in pod["tasks"]:
            task["cmd"] = task["cmd"].replace(
                "frameworks/jax", "dcos_commons_tpu_torch/frameworks"
            ).replace("dcos_commons_tpu.parallel",
                      "dcos_commons_tpu_torch.parallel")
    assert got_data == want_data
    for tpu, gpu in zip(tpus, gpus):
        assert (tpu is None) == (gpu is None)
        if tpu is None:
            continue
        assert gpu["generation"] == "h100"
        tpu.pop("generation"), gpu.pop("generation")
        assert gpu == tpu
    for path in got.pods[0].tasks[0].cmd.split():
        if path.endswith(".py"):
            assert os.path.isfile(os.path.join(REPO, path)), path
    t_validation.validate_spec_change(None, got)


def test_port_options_enum_is_one_nvlink_node():
    schema = t_options.load_schema(PORT_FRAMEWORKS)
    assert t_options.validate_schema(schema) == []
    chips = schema["properties"]["trainer"]["properties"]["chips_per_host"]
    assert chips["enum"] == [1, 2, 4, 8]
    reference = j_options.load_schema(JAX_FRAMEWORKS)
    assert (t_options.render_options(schema, {})
            == j_options.render_options(reference, {}))


FIELDS = [
    dict(),
    dict(chips_per_host=1),
    dict(chips_per_host=8, topology="2x4"),
    dict(chips_per_host=4, topology="4x4", slices=2),
    dict(chips_per_host=2, topology="1x2", slices=3, elastic=True,
         min_hosts=2),
]


@pytest.mark.parametrize("fields", FIELDS, ids=str)
def test_gpu_mesh_env_is_the_tpu_contract(fields):
    tpu = j_specs.TpuSpec(generation="v5e", **fields)
    gpu = t_specs.GpuSpec(**fields)
    want, got = tpu.mesh_env(), gpu.mesh_env()
    assert want.pop("TPU_GENERATION") == "v5e"
    assert got.pop("TPU_GENERATION") == "h100"
    assert got == want
    assert gpu.total_chips == tpu.total_chips


_GPU_POD = """
name: fix
pods:
  trainer:
    count: {count}
    gang: true
    {block}:
      generation: {generation}
      chips-per-host: {chips}
      topology: {topology}
    tasks:
      worker:
        goal: RUNNING
        cmd: "python dcos_commons_tpu_torch/frameworks/train_worker.py"
"""


def _gpu_spec(generation="h100", chips=4, topology="2x4", count=2,
              block="gpu"):
    return t_yaml.from_yaml(_GPU_POD.format(
        generation=generation, chips=chips, topology=topology, count=count,
        block=block))


def test_validators_accept_an_h100_gang():
    spec = _gpu_spec()
    assert spec.pods[0].gpu == t_specs.GpuSpec(
        generation="h100", chips_per_host=4, topology="2x4")
    t_validation.validate_spec_change(None, spec)
    t_validation.validate_spec_change(None, _gpu_spec(chips=8, count=1))


@pytest.mark.parametrize("case", ["v5e", "tpu-block", "chips-16"])
def test_validators_refuse_what_the_port_cannot_run(case):
    if case == "tpu-block":
        with pytest.raises(t_specs.SpecError, match="tpu: block"):
            _gpu_spec(block="tpu")
        with pytest.raises(t_specs.SpecError, match="tpu block"):
            t_specs.ServiceSpec.from_dict({"name": "fix", "pods": [
                {"type": "trainer", "tpu": {"generation": "v5e"}}]})
        return
    if case == "v5e":
        spec, match = _gpu_spec(generation="v5e"), "unknown GPU generation"
    else:
        spec, match = _gpu_spec(chips=16, topology="4x8"), "NVLink node"
    with pytest.raises(t_validation.ConfigValidationError, match=match):
        t_validation.validate_spec_change(None, spec)


def test_gpu_topology_cannot_change_on_update():
    old, new = _gpu_spec(), _gpu_spec(topology="1x8", count=2)
    errors = t_validation.gpu_topology_cannot_change(old, new)
    assert errors and "GPU topology cannot change" in errors[0]


PLACEMENTS = [
    "", "max-per-host:1", "max-per-zone:2", "max-per-attribute:rack:2",
    "hostname:exact:h1,h2", "hostname:regex:gpu-.*",
    "zone:exact:us-central2-b && max-per-host:1",
    "attribute:tier:premium || agent:avoid:h3", "group-by:zone:3",
    "round-robin:zone", "task-type:colocate:data", "generation:h100",
    "same-slice", '[["hostname", "UNIQUE"]]',
    '[["zone", "GROUP_BY", "3"], ["tier", "IS", "hot"]]',
    '[["zone", "LIKE", "us-.*"], ["zone", "UNLIKE", "eu"]]',
    '[["hostname", "MAX_PER", "2"]]', "max-per-host", "bogus-rule:1",
    '[["zone", "IS"]]', '[["zone", "FOO"]]', "[not json",
]


def _tree(rule):
    children = [_tree(r) for r in getattr(rule, "rules", [])]
    fields = {k: v for k, v in vars(rule).items() if k != "rules"}
    return type(rule).__name__, fields, children


@pytest.mark.parametrize("text", PLACEMENTS)
def test_placement_parses_as_the_reference_does(text):
    try:
        want = _tree(j_placement.parse_placement(text))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            t_placement.parse_placement(text)
        assert str(got.value) == str(e)
        return
    assert _tree(t_placement.parse_placement(text)) == want

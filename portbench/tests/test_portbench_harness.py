"""The harness: every cell, mix, limit and metric found by name in files;
a new one added as files and entries alone; the result line; the
command's refusal without the card; ``BENCHMARK.json`` within the
benchmark's contract."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench.lib import harness
from portbench.tests.tiny import tiny_context

ROOT = harness.ROOT
BENCH = harness.load_benchmark(ROOT)
CELLS = [c["name"] for c in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.mark.parametrize("workload", CELLS)
def test_cell_loads_by_name(workload):
    ctx = harness.build_context(workload, 1, 1.0, False, device="cpu")
    assert harness.driver_of(ctx).run
    assert ctx.limits, f"portbench/limits/{workload}.json is missing"
    for entry in harness.per_layer_entries(BENCH, workload):
        assert callable(harness.reader_of(entry["name"]))
    e2e = harness.end_to_end_names(BENCH, workload)
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.per_layer_entries(BENCH, workload)


def test_benchmark_json_keeps_its_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    used = {c["config"] for c in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        # every key changed from the source: the cuts, and what the port
        # forces, which the file keeps under "assumed"
        changed = set(cfg["reduced"]) | {
            k for k, v in cfg["assumed"].items()
            if isinstance(v, dict) and "as_run" in v}
        assert sorted(c["reduced"]) == sorted(changed)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    cells = set(CELLS)
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
        for w in m["workloads"]:
            assert m["moves"] in harness.end_to_end_names(BENCH, w)
        assert os.path.exists(os.path.join(ROOT, "portbench", "metrics",
                                           m["name"] + ".py"))


def test_result_line_keeps_its_form():
    ctx = tiny_context("mistral-7b-v0.3.train.s4096")
    result, rec = harness.execute(ctx, BENCH)
    assert list(result)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} \
        <= set(result)
    assert set(result["metrics"]) == {"train_tokens_per_s", "setup_s"}
    for check in result["checks"].values():
        assert set(check) == {"value", "limit"}
    json.dumps(result)
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_tiny_run_is_correct(workload):
    """The port in f32 at a tiny size, against the reference, under the
    cell's own limits."""
    result, _ = harness.execute(tiny_context(workload), BENCH)
    assert result["correct"], result["checks"]


def test_the_command_refuses_without_the_card():
    if _has_cuda():
        pytest.skip("a CUDA card is here")
    run = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert run.returncode != 0 and run.stdout == ""


def test_the_command_fails_without_the_port(tmp_path):
    """A directory holding only BENCHMARK.json and portbench/."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    run = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert run.returncode != 0 and run.stdout == ""


def test_a_new_cell_is_files_and_entries_alone(tmp_path):
    """A configuration, a mix, a limits file and a per-layer metric added
    as new files and new BENCHMARK.json entries, no file edited."""
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _snapshot(tmp_path / "portbench")
    bench = json.loads(json.dumps(BENCH))
    base = "mistral-7b-v0.3.serve.chat"
    pb = tmp_path / "portbench"
    cfg = json.loads((pb / "configs" / "mistral-7b-v0.3.json").read_text())
    (pb / "configs" / "dummy-model.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "mixes" / "serve.chat.json").read_text())
    (pb / "mixes" / "serve.dummy.json").write_text(json.dumps(mix))
    (pb / "limits" / "dummy-model.serve.dummy.json").write_text(
        (pb / "limits" / (base + ".json")).read_text())
    (pb / "metrics" / "dummy_requests.serve.py").write_text(
        "def read(ctx, rec):\n    return float(rec.attempted)\n")
    bench["configs"].append(dict(BENCH["configs"][-1], name="dummy-model",
                                 file="portbench/configs/dummy-model.json"))
    bench["workloads"].append({"name": "dummy-model.serve.dummy",
                               "config": "dummy-model",
                               "traffic": "serve.dummy", "chips": 1,
                               "why": "a dummy"})
    for m in bench["end_to_end"]:
        if "workloads" in m and base in m["workloads"]:
            m["workloads"].append("dummy-model.serve.dummy")
    bench["per_layer"].append({
        "name": "dummy_requests.serve", "unit": "requests",
        "better": "higher", "source": "program_counter", "layer": "engine",
        "moves": "serve_latency_p95_s",
        "workloads": ["dummy-model.serve.dummy"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    ctx = tiny_context("dummy-model.serve.dummy", trace=True,
                       root=str(tmp_path), bench=bench)
    result, rec = harness.execute(ctx, bench)
    assert result["metrics"]["dummy_requests.serve"]["value"] == \
        rec.attempted > 0
    after = _snapshot(tmp_path / "portbench")
    assert {k: v for k, v in after.items() if k in before} == before


def _snapshot(path):
    out = {}
    for dirpath, dirs, files in os.walk(path):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for name in files:
            full = os.path.join(dirpath, name)
            with open(full, "rb") as f:
                out[os.path.relpath(full, path)] = f.read()
    return out


def _has_cuda():
    import torch

    return torch.cuda.is_available()

"""The port's collective and roofline probes
(``dcos_commons_tpu_torch/parallel/collectives.py``) on the CPU: the
four collectives over a gloo world of 2 processes report positive bus
GB/s, an axis of one rank degenerates to the bookkeeping keys alone
(as the reference's ``tests/test_collectives.py`` expects of its own),
and the rooflines report positive rates; the sidecar CLI (``main``)
prints its one JSON line.  CPU rates measure nothing of a card; only
that every probe runs, chains and reports."""

import functools
import json

import pytest
from test_torch_parallel import run_gang

from dcos_commons_tpu_torch.parallel import collectives
from dcos_commons_tpu_torch.parallel import mesh as t_mesh
from dcos_commons_tpu_torch.parallel.collectives import (
    collective_bandwidth,
    single_chip_rooflines,
)

NAMES = ("psum", "all_gather", "reduce_scatter", "ppermute")


def _rank_bandwidth(_payload):
    mesh = t_mesh.make_mesh(t_mesh.MeshSpec(dp=2))
    return collective_bandwidth(mesh, "dp", payload_mb=0.5, iters=2,
                                device="cpu")


def test_collective_bandwidth_over_gloo(tmp_path):
    report = run_gang(tmp_path, 2, "_rank_bandwidth", None,
                      module=__name__)
    assert report["axis_size"] == 2.0 and report["iters"] == 2.0
    assert report["payload_mb_per_chip"] == 0.5
    for name in NAMES:
        assert report[f"{name}_gbps_per_chip"] > 0, report
        low, high = report[f"{name}_gbps_per_chip_range"]
        assert 0 < low <= report[f"{name}_gbps_per_chip"] <= high, report


def test_collective_bandwidth_on_one_rank_degenerates():
    mesh = t_mesh.make_mesh(t_mesh.MeshSpec())
    report = collective_bandwidth(mesh, "dp", payload_mb=0.5, iters=2,
                                  device="cpu")
    assert report == {"axis_size": 1.0, "payload_mb_per_chip": 0.5,
                      "iters": 2.0}


def test_single_chip_rooflines_report():
    report = single_chip_rooflines(payload_mb=4.0, iters=2, matmul_dim=256,
                                   device="cpu")
    assert report["hbm_copy_gbps"] > 0
    assert report["matmul_bf16_tflops"] > 0


def test_sidecar_cli_prints_one_report(monkeypatch, capsys):
    """The bench task of the port's svc.yml on one CPU rank (the card
    sizes of its rooflines cut down here)."""
    monkeypatch.setenv("TORCH_DEVICE", "cpu")
    monkeypatch.setattr(collectives, "single_chip_rooflines", functools.partial(
        single_chip_rooflines, payload_mb=4.0, matmul_dim=256))
    assert collectives.main(["--payload-mb", "0.5", "--iters", "2"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["devices"] == 1 and report["platform"] == "cpu"
    assert report["axis_size"] == 1.0 and report["hbm_copy_gbps"] > 0


def test_sidecar_cli_needs_the_card_unless_asked(monkeypatch):
    monkeypatch.delenv("TORCH_DEVICE", raising=False)
    if collectives.torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        collectives.main(["--iters", "1"])

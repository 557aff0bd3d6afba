"""Collective and roofline probes (port of
``dcos_commons_tpu/parallel/collectives.py``).

``collective_bandwidth`` times each collective that the sharded step and
the long-context paths call (psum, all_gather, reduce_scatter and the
ring's ppermute hop) over one axis of the port's mesh: NCCL on the
card, gloo on the CPU.  Each is chained ``iters`` times, every call
reading the last one's output, timed as a whole (CUDA events on the
card, the host clock on the CPU) and converted to bus bandwidth by the
reference's model (``_ALGO_FACTOR``: the bytes a rank moves per byte of
its shard on a ring of n).  ``single_chip_rooflines`` gives the
ceilings those numbers sit under: HBM copy GB/s and bf16 matmul
TFLOP/s on one device.

``main`` is the sidecar bench task of the port's ``svc.yml``
(``python -m dcos_commons_tpu_torch.parallel.collectives``).

The reference subtracts a measured dispatch overhead and stretches its
chains to thousands of calls, to see past the latency of a relay in
front of its device.  The port reaches its card directly, and the CUDA
events time the device's own work, so neither has a counterpart here.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch

from dcos_commons_tpu_torch.device import resolve_device
from dcos_commons_tpu_torch.parallel.mesh import Mesh
from dcos_commons_tpu_torch.parallel.sharding import (
    _gather_dim,
    _scatter_dim,
    all_reduce,
    ppermute,
)

# each collective is timed this many times: its median and range
REPEATS = 5
# bytes moved per rank per byte of its shard S on a ring of n (NCCL's
# bus-bandwidth convention): an all-reduce 2(n-1)/n S, an all-gather
# and a reduce-scatter (n-1) S each, a ring permute S
_ALGO_FACTOR = {
    "psum": lambda n: 2.0 * (n - 1) / n,
    "all_gather": lambda n: float(n - 1),
    "reduce_scatter": lambda n: float(n - 1),
    "ppermute": lambda n: 1.0,
}


def _timed_s(fn, x, iters: int) -> float:
    """Seconds of ``iters`` chained calls ``x = fn(x)``, after one
    untimed call: CUDA events on the card, the host clock elsewhere."""
    x = fn(x)
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            x = fn(x)
        end.record()
        torch.cuda.synchronize(x.device)
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    for _ in range(iters):
        x = fn(x)
    return time.perf_counter() - t0


def _one(collective: str, mesh: Mesh, axes, n: int):
    """One call of ``collective`` whose output has its input's shape
    and finite values, so calls chain."""
    group = mesh.group(axes)
    if collective == "psum":
        return lambda x: all_reduce(x.clone(), group) / n
    if collective == "all_gather":
        return lambda x: _gather_dim(x, 0, group, n).reshape(
            (n,) + tuple(x.shape)).mean(0)
    if collective == "reduce_scatter":
        return lambda x: _scatter_dim(x.repeat(n, 1), 0, group, n) / n
    if collective == "ppermute":
        return lambda x: ppermute(x, mesh, axes)
    raise ValueError(collective)


def collective_bandwidth(
    mesh: Mesh,
    axis: str = "dp",
    payload_mb: float = 32.0,
    iters: int = 20,
    dtype=torch.bfloat16,
    device=None,
) -> Dict[str, float]:
    """Bus GB/s a rank for each collective over ``axis`` of ``mesh``
    (every rank calls it together), ``payload_mb`` being each rank's
    shard, on ``device`` (default the card), timed ``REPEATS`` times
    (each a chain of ``iters`` calls).  Returns ``{collective +
    "_gbps_per_chip": the median GB/s}`` and ``{collective +
    "_gbps_per_chip_range": [least, most]}`` with ``axis_size``,
    ``payload_mb_per_chip`` and ``iters``; an axis of one rank has no
    collective to time and returns those three alone."""
    dev = resolve_device(device)
    axes = (axis,)
    n = mesh.size(axes)
    itemsize = torch.empty((), dtype=dtype).element_size()
    rows = max(int(payload_mb * 1e6 / itemsize) // 128, 8)
    payload_bytes = rows * 128 * itemsize
    results: Dict[str, float] = {
        "axis_size": float(n),
        "payload_mb_per_chip": round(payload_bytes / 1e6, 2),
        "iters": float(iters),
    }
    if n < 2:
        return results
    shard = torch.ones((rows, 128), dtype=dtype, device=dev)
    for name, factor in _ALGO_FACTOR.items():
        moved = factor(n) * payload_bytes * iters
        rates = sorted(
            moved / max(_timed_s(_one(name, mesh, axes, n), shard, iters),
                        1e-9) / 1e9
            for _ in range(REPEATS))
        results[name + "_gbps_per_chip"] = float(np.median(rates))
        results[name + "_gbps_per_chip_range"] = [rates[0], rates[-1]]
    return results


def single_chip_rooflines(
    payload_mb: float = 256.0,
    iters: int = 20,
    matmul_dim: int = 4096,
    device=None,
) -> Dict[str, float]:
    """HBM copy GB/s (``x + 1`` over a ``payload_mb`` bf16 array: a read
    and a write a call) and bf16 matmul TFLOP/s (``matmul_dim``
    squared, ``2 m^3`` operations a call) on ``device`` (default the
    card), each over ``iters`` chained calls."""
    dev = resolve_device(device)
    rows = max(int(payload_mb * 1e6 / 2) // 128, 8)
    x = torch.ones((rows, 128), dtype=torch.bfloat16, device=dev)
    copy_s = _timed_s(lambda t: t + 1.0, x, iters)
    m = matmul_dim
    a = torch.ones((m, m), dtype=torch.bfloat16, device=dev)
    w = torch.full((m, m), 1.0 / m, dtype=torch.bfloat16, device=dev)
    mm_s = _timed_s(lambda t: t @ w, a, iters)  # ones stay ones
    return {
        "hbm_copy_gbps": 2 * x.numel() * 2 * iters / max(copy_s, 1e-9) / 1e9,
        "matmul_bf16_tflops": 2 * m ** 3 * iters / max(mm_s, 1e-9) / 1e12,
    }


def _bench_rank(local_rank: int, local_devices: int, kind: str,
                init_method: Optional[str], payload_mb: float,
                iters: int) -> None:
    """One rank of the bench: every rank of the gang on one dp axis,
    the rooflines on its own device; the gang's rank 0 prints the
    report."""
    import torch.distributed as dist

    from dcos_commons_tpu_torch.parallel.distributed import (
        initialize_from_env,
    )
    from dcos_commons_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    device = resolve_device(kind if kind == "cpu" else f"cuda:{local_rank}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    initialize_from_env(os.environ,
                        "nccl" if device.type == "cuda" else "gloo",
                        local_rank, local_devices, init_method=init_method)
    world = dist.get_world_size() if dist.is_initialized() else 1
    report: Dict[str, object] = {"devices": world,
                                 "platform": device.type}
    report.update(collective_bandwidth(
        make_mesh(MeshSpec(dp=world)), "dp", payload_mb=payload_mb,
        iters=iters, device=device))
    report.update(single_chip_rooflines(iters=iters, device=device))
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(json.dumps(report, sort_keys=True), flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()


def main(argv: Optional[list] = None) -> int:
    """CLI for the sidecar bench task (the collectives plan of the
    port's svc.yml): one rank a local card (``TORCH_DEVICE=cpu``: one
    rank on the CPU), the gang's ranks meeting at
    ``COORDINATOR_ADDRESS`` (a lone worker's at a file store of its
    own), the four collectives over all of them and the rooflines on
    each card; one JSON line from rank 0."""
    import argparse

    parser = argparse.ArgumentParser(prog="collective-bench")
    parser.add_argument("--payload-mb", type=float, default=32.0)
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args(argv)

    kind = os.environ.get("TORCH_DEVICE") or "cuda"
    local_devices = (torch.cuda.device_count()
                     if kind == "cuda" and torch.cuda.is_available() else 1)
    if local_devices == 1:
        _bench_rank(0, 1, kind, None, args.payload_mb, args.iters)
        return 0
    with tempfile.TemporaryDirectory(prefix="rendezvous-") as meet:
        init_method = None
        if int(os.environ.get("TPU_WORKER_COUNT", "1") or 1) == 1:
            init_method = "file://" + os.path.join(meet, "store")
        torch.multiprocessing.spawn(
            _bench_rank, nprocs=local_devices,
            args=(local_devices, kind, init_method, args.payload_mb,
                  args.iters))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

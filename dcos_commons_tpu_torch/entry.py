"""Entry points of the port (the counterpart of the JAX package's
``__graft_entry__.py``).

``entry()``: ``(fn, example_args)`` for the flagship forward at the
reference's width (vocab 8192, d_model 512, 4 layers, 8 heads, d_ff
1408, seq 1024, bf16, batch 4), its weights and tokens on the card
unless the caller passes ``device="cpu"``.  On the card the forward
runs the RMSNorm kernel (K1) and the flash-attention forward (K2).

``dryrun_multichip(n)``: ONE step of every sharded layout over ``n``
processes joined by gloo on the CPU, the way the reference dryruns its
layouts on a virtual CPU mesh: the dp x fsdp x tp train step, the
2-slice dcn mesh the slice env derives, sharded serving under dp x tp
(native, int8 KV, int8 weights with int8 KV), ring and Ulysses
sequence parallelism, the GPipe pipeline over pp, the four
collectives, the MoE flagship's train step and the expert-parallel
MoE FFN.  Every loss is held against one process's loss of the same
batch and weights, and sharded greedy serving against one process's
tokens.  A mesh the port refuses by design (ROADMAP "Refusals") is
named with the refusal's own message.  It prints
``dryrun_multichip: OK`` only when every layout ran.

``python -m dcos_commons_tpu_torch.entry [--device cpu] [--dryrun N]``
runs the forward and then the dryrun (N defaults to 4).
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import json
import math
import os
import signal
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the reference entry's flagship (``__graft_entry__.py`` ``entry``)
ENTRY_FIELDS = dict(vocab=8192, d_model=512, n_layers=4, n_heads=8,
                    n_kv_heads=8, d_ff=1408, max_seq=1024, remat=False)
ENTRY_BATCH, ENTRY_SEQ = 4, 1024

# the dryrun's model (``dryrun_multichip``'s config), f32
DRYRUN_FIELDS = dict(vocab=256, d_model=64, n_layers=2, n_heads=4,
                     n_kv_heads=4, d_ff=128, max_seq=32, remat=True,
                     loss_chunk=16)
DRYRUN_SEQ = 32
# |sharded loss - one process's loss| on f32 (the reductions differ in
# order only)
LOSS_TOL = 1e-4


def entry_config():
    """The flagship of ``entry()``."""
    import torch

    from dcos_commons_tpu_torch.models import TransformerConfig

    return TransformerConfig(**ENTRY_FIELDS, dtype=torch.bfloat16)


def entry(device=None):
    """Returns ``(fn, example_args)``: the flagship forward ``fn(params,
    tokens) -> logits [4, 1024, 8192]`` (f32) and its random weights
    (seed 0) and tokens (seed 1) on ``device`` (default the card)."""
    from dcos_commons_tpu_torch.device import generator, resolve_device
    from dcos_commons_tpu_torch.models import forward, init_params
    from dcos_commons_tpu_torch.utils import synthetic_tokens

    dev = resolve_device(device)
    config = entry_config()
    params = init_params(config, seed=0, device=dev)
    tokens, _ = synthetic_tokens(ENTRY_BATCH, ENTRY_SEQ, config.vocab,
                                 generator(dev, 1))

    def fn(params, tokens):
        return forward(config, params, tokens)

    return fn, (params, tokens)


# -- the dryrun: what each rank runs ----------------------------------------


def _layouts(n: int) -> Dict[str, dict]:
    """The meshes of the dryrun over ``n`` ranks, as the reference
    factors them."""
    tp = 2
    fsdp = 2 if n % (tp * 2) == 0 else 1
    sp = 4 if n % 4 == 0 else 2
    ep = 4 if n % 4 == 0 else 2
    return {
        "train": dict(dp=n // (tp * fsdp), fsdp=fsdp, tp=tp),
        "dcn": {"TPU_NUM_SLICES": "2", "TPU_CHIPS_PER_HOST": "2"},
        "serve": dict(dp=n // 2, tp=2),
        "ring": dict(sp=sp, tp=n // sp),
        "ulysses": dict(sp=sp, tp=n // sp),
        "pipeline": dict(pp=2, dp=n // 2),
        "collectives": dict(dp=n),
        "collectives-dcn": dict(dcn=2, dp=n // 2),
        "moe-flagship": dict(ep=2, dp=n // 2),
        "moe-ep": dict(ep=ep, dp=n // ep),
    }


LAYOUT_NAMES = ("train", "dcn", "serve", "ring", "ulysses", "pipeline",
                "collectives", "moe-flagship", "moe-ep")


class _Rank:
    """One rank's run of every layout, in the same order on every rank
    (each ``make_mesh`` builds process groups over the whole world)."""

    def __init__(self, world: int):
        import torch
        import torch.distributed as dist

        self.torch = torch
        self.dist = dist
        self.world = world
        self.layouts = _layouts(world)
        self.report: Dict[str, dict] = {}
        self.refused: Dict[str, str] = {}

    # -- helpers --------------------------------------------------------

    def config(self, **extra):
        from dcos_commons_tpu_torch.models import TransformerConfig

        return TransformerConfig(**{**DRYRUN_FIELDS, **extra},
                                 dtype=self.torch.float32)

    def batch(self, rows: int, seed: int, seq: int = DRYRUN_SEQ):
        from dcos_commons_tpu_torch.device import generator
        from dcos_commons_tpu_torch.utils import synthetic_tokens

        return synthetic_tokens(rows, seq, DRYRUN_FIELDS["vocab"],
                                generator(self.torch.device("cpu"), seed))

    @staticmethod
    def rows(t, mesh):
        from dcos_commons_tpu_torch.parallel.mesh import BATCH_AXES

        n, i = mesh.size(BATCH_AXES), mesh.index(BATCH_AXES)
        return t[i * len(t) // n:(i + 1) * len(t) // n]

    @staticmethod
    def chunk(t, mesh):
        n, j = mesh.size(("sp",)), mesh.index(("sp",))
        s = t.shape[1]
        return t[:, j * s // n:(j + 1) * s // n]

    def dense_loss(self, config, params, tokens, targets, shards=1
                   ) -> float:
        """One process's loss of the whole batch (no mesh), as the mean
        of its ``shards`` equal row blocks: the MoE routes each rank's
        rows as one group, so its one-process loss groups them alike
        (for a dense model the mean is the same)."""
        from dcos_commons_tpu_torch.models import loss_fn

        plain = self.config(**{
            k: getattr(config, k) for k in ("n_experts", "loss_chunk",
                                            "remat")})
        rows = len(tokens) // shards
        with self.torch.no_grad():
            return sum(float(loss_fn(plain, params,
                                     tokens[g * rows:(g + 1) * rows],
                                     targets[g * rows:(g + 1) * rows]))
                       for g in range(shards)) / shards

    def check_loss(self, name: str, got: float, want: float) -> dict:
        if not math.isfinite(got):
            raise AssertionError(f"{name}: non-finite loss {got}")
        if abs(got - want) > LOSS_TOL * max(1.0, abs(want)):
            raise AssertionError(
                f"{name}: sharded loss {got} against one process's {want}")
        return {"loss": got, "one_process_loss": want}

    def refusal(self, name: str, fn) -> None:
        """A mesh the port refuses by design: the refusal's message,
        kept by name."""
        try:
            fn()
        except (NotImplementedError, ValueError) as e:
            self.refused[name] = str(e)
            return
        raise AssertionError(f"{name}: expected a refusal by design")

    def train_step(self, name, config, mesh, seed, rows):
        from dcos_commons_tpu_torch.models import (
            adamw,
            init_params,
            make_train_step,
            shard_params,
        )

        from dcos_commons_tpu_torch.parallel.mesh import BATCH_AXES

        full = init_params(config, seed=seed, device="cpu")
        tokens, targets = self.batch(rows, seed + 1)
        want = self.dense_loss(config, full, tokens, targets,
                               mesh.size(BATCH_AXES))
        local = shard_params(full, config, mesh)
        step = make_train_step(config, adamw(local, 1e-3), mesh=mesh)
        got = float(step(local, self.rows(tokens, mesh),
                          self.rows(targets, mesh)))
        self.report[name] = dict(self.check_loss(name, got, want),
                                 mesh=dict(mesh.shape))

    # -- the layouts ----------------------------------------------------

    def run_train(self):
        from dcos_commons_tpu_torch.parallel.mesh import MeshSpec, make_mesh

        fields = self.layouts["train"]
        mesh = make_mesh(MeshSpec(**fields))
        self.train_step(
            "train", self.config(), mesh, 0,
            max(fields["dp"] * fields["fsdp"], 2))

    def run_dcn(self):
        from dcos_commons_tpu_torch.parallel.mesh import mesh_from_env

        mesh = mesh_from_env(self.layouts["dcn"], n_devices=self.world)
        if mesh.shape["dcn"] != 2:
            raise AssertionError(f"dcn mesh {mesh.shape}")
        self.train_step("dcn", self.config(), mesh, 6, max(self.world, 2))

    def run_serve(self):
        """dp x tp: params over tp, the prompts over dp; each dp replica
        is a tp gang of its own (the cached paths shard over tp only)."""
        from dcos_commons_tpu_torch.models import (
            generate,
            init_params,
            quantize_params_int8,
            shard_params,
        )
        from dcos_commons_tpu_torch.parallel.mesh import (
            Mesh,
            MeshSpec,
            make_mesh,
        )

        torch = self.torch
        fields = self.layouts["serve"]
        mesh = make_mesh(MeshSpec(**fields))
        tp_gang = Mesh(MeshSpec(tp=fields["tp"]), mesh.index(("tp",)),
                       {("tp",): mesh.group(("tp",))}, mesh.control_device)
        config = self.config(remat=False, loss_chunk=0)
        params = init_params(config, seed=0, device="cpu")
        if fields["dp"] > 1:
            self.refusal("serve dp x tp in one cache",
                         lambda: generate(
                             config, params,
                             torch.zeros((1, 4), dtype=torch.long), 1,
                             mesh=mesh))
        prompt, _ = self.batch(4, 10, seq=16)
        n, i = mesh.size(("dp",)), mesh.index(("dp",))
        mine = prompt[i * len(prompt) // n:(i + 1) * len(prompt) // n]
        out = {}
        with torch.inference_mode():
            for label, weights, kv in (("native", params, "native"),
                                       ("int8-kv", params, "int8"),
                                       ("int8-weights-kv",
                                        quantize_params_int8(params),
                                        "int8")):
                local = shard_params(weights, config, tp_gang)
                got = generate(config, local, mine, max_new_tokens=4,
                               max_len=32, kv_dtype=kv, mesh=tp_gang)
                if got.shape != (len(mine), 4):
                    raise AssertionError(f"serve {label}: {got.shape}")
                if not bool(((got >= 0) & (got < config.vocab)).all()):
                    raise AssertionError(f"serve {label}: token range")
                if label == "native":
                    want = generate(config, weights, mine, max_new_tokens=4,
                                    max_len=32)
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"serve native: tp {got.tolist()} against one "
                            f"process's {want.tolist()}")
                out[label] = got.tolist()
        self.report["serve"] = dict(mesh=dict(mesh.shape),
                                    rows=len(mine), tokens=out)

    def run_sequence_parallel(self, recipe: str):
        from dcos_commons_tpu_torch.models import init_params, loss_fn
        from dcos_commons_tpu_torch.models import shard_params
        from dcos_commons_tpu_torch.models.transformer import check_mesh
        from dcos_commons_tpu_torch.parallel.mesh import MeshSpec, make_mesh
        from dcos_commons_tpu_torch.parallel.sharding import batch_mean

        fields = self.layouts[recipe]
        flag = ("use_ring_attention" if recipe == "ring"
                else "use_ulysses_attention")
        config = self.config(remat=False, **{flag: True})
        spec = MeshSpec(**fields)
        mesh = make_mesh(spec)
        try:
            check_mesh(config, mesh)
        except ValueError as e:
            # Ulysses splits each tp rank's heads over sp: where they do
            # not split, the sp axis runs beside dp instead of tp
            self.refused[f"{recipe} over {dict(mesh.shape)}"] = str(e)
            spec = MeshSpec(sp=fields["sp"], dp=self.world // fields["sp"])
            mesh = make_mesh(spec)
        if recipe == "ring":
            self.refusal(
                "sp without a recipe",
                lambda: check_mesh(self.config(), mesh))
        full = init_params(config, seed=2, device="cpu")
        seq = DRYRUN_SEQ * fields["sp"]
        tokens, targets = self.batch(2, 3, seq=seq)
        want = self.dense_loss(config, full, tokens, targets)
        local = shard_params(full, config, mesh)
        with self.torch.no_grad():
            loss = loss_fn(config, local,
                           self.chunk(self.rows(tokens, mesh), mesh),
                           self.chunk(self.rows(targets, mesh), mesh), mesh)
            got = float(batch_mean(loss, mesh))
        self.report[recipe] = dict(self.check_loss(recipe, got, want),
                                   mesh=dict(mesh.shape), seq=seq)

    def run_pipeline(self):
        from dcos_commons_tpu_torch.models import (
            adamw,
            init_params,
            make_train_step,
            pipeline_param_specs,
            pipeline_value_and_grad,
            shard_params,
        )
        from dcos_commons_tpu_torch.parallel.mesh import MeshSpec, make_mesh
        from dcos_commons_tpu_torch.utils.tree import tree_leaves

        fields = self.layouts["pipeline"]
        config = self.config()
        mesh = make_mesh(MeshSpec(**fields))
        full = init_params(config, seed=4, device="cpu")
        self.refusal("make_train_step over pp",
                     lambda: make_train_step(config, adamw(full), mesh=mesh))
        specs = pipeline_param_specs(config)
        local = shard_params(full, config, mesh, rules=specs)
        for leaf in tree_leaves(local):
            leaf.requires_grad_(True)
        tokens, targets = self.batch(fields["dp"] * 2, 5)
        want = self.dense_loss(config, full, tokens, targets, fields["dp"])
        loss, grads = pipeline_value_and_grad(
            config, local, self.rows(tokens, mesh), self.rows(targets, mesh),
            2, mesh)
        norms = [float(g.norm()) for g in tree_leaves(grads)]
        if not all(math.isfinite(x) for x in norms) or not any(norms):
            raise AssertionError(f"pipeline gradients {norms}")
        self.report["pipeline"] = dict(
            self.check_loss("pipeline", float(loss), want),
            mesh=dict(mesh.shape), n_micro=2)

    def run_collectives(self):
        from dcos_commons_tpu_torch.parallel.collectives import (
            collective_bandwidth,
        )
        from dcos_commons_tpu_torch.parallel.mesh import MeshSpec, make_mesh

        names = ("psum", "all_gather", "reduce_scatter", "ppermute")
        out = {}
        for key, axis in (("collectives", "dp"), ("collectives-dcn", "dcn")):
            mesh = make_mesh(MeshSpec(**self.layouts[key]))
            rates = collective_bandwidth(
                mesh, axis, payload_mb=0.25, iters=2,
                dtype=self.torch.float32, device="cpu")
            got = {c: rates.get(f"{c}_gbps_per_chip", 0.0) for c in names}
            for c, gbps in got.items():
                if not gbps > 0:
                    raise AssertionError(f"{key} {c}: {rates}")
            # the four move comparable bytes a rank at this payload
            fastest = max(got.values())
            for c, gbps in got.items():
                if gbps * 1000 < fastest:
                    raise AssertionError(
                        f"{key}: {c} is >1000x slower than the fastest "
                        f"collective {got}")
            out[axis] = dict(got, axis_size=rates["axis_size"])
        self.report["collectives"] = out

    def run_moe_flagship(self):
        from dcos_commons_tpu_torch.parallel.mesh import MeshSpec, make_mesh

        fields = self.layouts["moe-flagship"]
        config = self.config(n_experts=fields["ep"] * 2, remat=False,
                             loss_chunk=0)
        mesh = make_mesh(MeshSpec(**fields))
        self.train_step("moe-flagship", config, mesh, 8,
                        max(self.world, 2))

    def run_moe_ep(self):
        from dcos_commons_tpu_torch.device import generator
        from dcos_commons_tpu_torch.models import (
            MoEConfig,
            expert_shard_spec,
            init_moe_params,
            moe_ffn,
        )
        from dcos_commons_tpu_torch.parallel import sharding
        from dcos_commons_tpu_torch.parallel.mesh import MeshSpec, make_mesh

        torch = self.torch
        fields = self.layouts["moe-ep"]
        ep = fields["ep"]
        config = MoEConfig(d_model=64, d_ff=128, n_experts=ep * 2, top_k=2,
                           capacity_factor=4.0, dtype=torch.float32)
        mesh = make_mesh(MeshSpec(**fields))
        cpu = torch.device("cpu")
        full = init_moe_params(config, generator(cpu, 4), cpu)
        x = torch.randn((self.world * 8, 64), generator=generator(cpu, 5))
        rules = expert_shard_spec()
        local = {k: sharding.shard(v, rules[k], mesh).requires_grad_(True)
                 for k, v in full.items()}
        n, i = mesh.size(("dp", "ep")), mesh.index(("dp", "ep"))
        rows = len(x) // n
        with mesh:
            y, aux = moe_ffn(config, local, x[i * rows:(i + 1) * rows],
                             axis_name="ep")
        share = ((y ** 2).mean() + 0.01 * aux) / n
        grads = torch.autograd.grad(share, list(local.values()))
        loss = float(sharding.all_reduce(share.detach().clone(),
                                         self.dist.group.WORLD))
        with torch.no_grad():
            # one process's loss: every token group of the world, each
            # with all the experts (rows group as the ranks' do)
            parts = [moe_ffn(config, full, x[r * rows:(r + 1) * rows])
                     for r in range(n)]
            want = sum(float((py ** 2).mean() + 0.01 * pa)
                       for py, pa in parts) / n
        norms = [float(g.norm()) for g in grads]
        if not all(math.isfinite(v) for v in norms) or not any(norms):
            raise AssertionError(f"ep moe gradients {norms}")
        self.report["moe-ep"] = dict(self.check_loss("moe-ep", loss, want),
                                     mesh=dict(mesh.shape))

    def run(self) -> dict:
        self.run_train()
        self.run_dcn()
        self.run_serve()
        self.run_sequence_parallel("ring")
        self.run_sequence_parallel("ulysses")
        self.run_pipeline()
        self.run_collectives()
        self.run_moe_flagship()
        self.run_moe_ep()
        return {"world": self.world, "layouts": self.report,
                "refused": self.refused}


def _rank_main(rank: int, world: int, work: str, timeout_s: float) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(work, "store"),
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        report = _Rank(world).run()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    path = os.path.join(work, f"rank{rank}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(report, f, sort_keys=True)
    os.replace(path + ".tmp", path)


# -- the dryrun: the parent process -----------------------------------------


def _kill_all(procs: List[subprocess.Popen]) -> None:
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
    for p in procs:
        p.wait()


def dryrun_multichip(n_devices: int = 4, deadline_s: float = 600.0,
                     work_dir: Optional[str] = None) -> dict:
    """Run every sharded layout over ``n_devices`` gloo processes on the
    CPU; return rank 0's report.  Each rank is its own process group
    (killed with all it started at the deadline or when a rank fails);
    a rank's output goes to ``<work>/rank<i>.log``."""
    if n_devices < 2 or n_devices % 2:
        raise ValueError(
            f"dryrun_multichip needs an even world of 2 or more for its "
            f"tp, pp, ep and dcn layouts, not {n_devices}")
    work = work_dir or tempfile.mkdtemp(prefix="dryrun-")
    os.makedirs(work, exist_ok=True)
    # a file store left by an earlier run would hand out its stale
    # rendezvous
    for name in ["store"] + [f"rank{r}.json" for r in range(n_devices)]:
        if os.path.exists(os.path.join(work, name)):
            os.remove(os.path.join(work, name))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    procs, logs = [], []
    t0 = time.monotonic()
    try:
        for rank in range(n_devices):
            log_file = open(os.path.join(work, f"rank{rank}.log"), "w")
            logs.append(log_file)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "dcos_commons_tpu_torch.entry",
                 "--rank", str(rank), "--world", str(n_devices),
                 "--work", work, "--timeout", str(deadline_s)],
                stdout=log_file, stderr=subprocess.STDOUT, env=env,
                cwd=REPO, start_new_session=True))
        end = t0 + deadline_s
        # wait on each live rank in turn; a failed rank or the deadline
        # ends the run (the finally kills the rest)
        while any(p.poll() is None for p in procs):
            if time.monotonic() > end or any(
                    p.poll() not in (None, 0) for p in procs):
                break
            live = next(p for p in procs if p.poll() is None)
            with contextlib.suppress(subprocess.TimeoutExpired):
                live.wait(timeout=0.1)
    finally:
        _kill_all(procs)
        for f in logs:
            f.close()
    codes = [p.returncode for p in procs]
    if any(code != 0 for code in codes):
        tails = []
        for rank in range(n_devices):
            with open(os.path.join(work, f"rank{rank}.log")) as f:
                tails.append(f"rank {rank} (exit {codes[rank]}):\n"
                             f"{f.read()[-3000:]}")
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) failed or passed its "
            f"{deadline_s:.0f} s deadline:\n" + "\n".join(tails))
    with open(os.path.join(work, "rank0.json")) as f:
        report = json.load(f)
    missing = [name for name in LAYOUT_NAMES
               if name not in report["layouts"]]
    if missing:
        raise RuntimeError(f"dryrun_multichip: layouts not run: {missing}")
    for name in LAYOUT_NAMES:
        print(f"dryrun_multichip {name}: "
              f"{json.dumps(report['layouts'][name], sort_keys=True)}")
    for name, why in sorted(report["refused"].items()):
        print(f"dryrun_multichip refused by design, {name}: {why}")
    report["seconds"] = round(time.monotonic() - t0, 3)
    print(f"dryrun_multichip: OK ({n_devices} ranks, "
          f"{report['seconds']} s)", flush=True)
    return report


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m dcos_commons_tpu_torch.entry",
        description="the flagship forward, then the multi-process dryrun")
    parser.add_argument("--device", default=None,
                        help="where the forward runs (default: the card)")
    parser.add_argument("--dryrun", type=int, default=4,
                        help="gloo processes of the dryrun (0: none)")
    parser.add_argument("--rank", type=int, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--world", type=int, default=0,
                        help=argparse.SUPPRESS)
    parser.add_argument("--work", default="", help=argparse.SUPPRESS)
    parser.add_argument("--timeout", type=float, default=600.0,
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.rank is not None:
        _rank_main(args.rank, args.world, args.work, args.timeout)
        return 0
    import torch

    fn, example = entry(args.device)
    with torch.no_grad():
        out = fn(*example)
    print(f"entry forward: {tuple(out.shape)} {out.dtype} on {out.device}",
          flush=True)
    if args.dryrun:
        dryrun_multichip(args.dryrun)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""shardcheck: static sharding, device-memory-footprint, and
collective-cost analysis for the port's frameworks (port of
``dcos_commons_tpu/analysis/shardcheck.py``).

The one launch failure none of the other analyzers can see is a LAYOUT
failure: a ServiceSpec whose declared gang cannot lay the mesh its
worker derives, a sharding rule whose axis the mesh does not divide
into a param dim, or a model whose per-card footprint exceeds the
card's memory — all of which would otherwise surface as an error (or an
OOM) minutes into a multi-GPU deploy.  For every YAML of the port's
framework directory (``dcos_commons_tpu_torch/frameworks/*.yml``),
rendered with its ``options.json`` defaults, it rebuilds the EXACT
workload the task command would run — ``models.config_from_env`` for
the model, ``parallel.mesh.derive`` for the mesh (both the very
functions the worker calls), the real ``sharding_rules`` /
``init_params`` / ``init_kv_cache`` / ``mlp_init`` evaluated on the
``meta`` device (shapes and dtypes only: no storage, no FLOPs, the
counterpart of ``jax.eval_shape``) — and walks params + optimizer
state + gradient + activation/KV estimates through the rules.

Rules (YAML-suppressible, anchored to the pod's declaring line):

- ``shard-mesh``          the declared topology cannot lay a
  host-aligned mesh (``derive`` raises SpecError), the workload's
  mesh spans a different card count than the pod reserves (idle or
  oversubscribed cards), or a mesh axis of size > 1 shards nothing.
- ``shard-divisibility``  a mesh axis product does not divide the
  param/activation dim its rule shards.
- ``shard-unknown-axis``  a rule names an axis outside the mesh-axis
  vocabulary (the port's ``MeshSpec`` fields).
- ``shard-replicated-giant``  a param above ``--giant-mb`` is
  replicated across mesh axes of size > 1 — usually a missing fsdp/tp
  entry in the rules, each replica burning memory on every card.
- ``shard-hbm-overcommit``  the per-card footprint exceeds the
  generation's memory (``--hbm-mb`` overrides the table), or the
  per-host footprint exceeds the task's declared ``memory:``.

Beyond findings, every analyzed pod emits a footprint breakdown and a
ring-vs-all-gather collective-cost estimate per training step over
NVLink (``--json`` keys ``shard.footprint`` / ``shard.cost``).

Footprint model: the reference's, with the optimizer the port's workers
really build.  Params at their init dtype (int8 + per-channel scale when
``WEIGHT_DTYPE=int8``), gradients mirroring params (training), optimizer
state as ``torch.optim.AdamW`` (the train worker) or ``torch.optim.Adam``
(the MNIST job) keeps it — ``exp_avg`` and ``exp_avg_sq`` in the param's
dtype and sharding, plus one f32 ``step`` a param (torch keeps the steps
on the host unless the optimizer is capturable; counting them
overcharges the card by 4 bytes a param leaf, where optax's state has
one int32 ``count``) — live activations = per-layer residual boundaries
(remat's floor) + the f32 logits block, and the KV cache via the real
``init_kv_cache`` (serving).  Per-card bytes divide each dim by the
product of its mesh-axis sizes; everything a rule does not shard
replicates.
"""

from __future__ import annotations

import dataclasses
import math
import os
import re
from dataclasses import dataclass, field
from typing import (
    Any,
    Callable,
    Dict,
    FrozenSet,
    List,
    Mapping,
    Optional,
    Sequence,
    Tuple,
)

from dcos_commons_tpu_torch.analysis.linter import (
    Finding,
    LintResult,
    Suppressions,
)

# device memory a card gives (MB of 2^20 bytes) — the capacity the
# footprint is judged against.  What the card reports, not its
# marketing size: torch.cuda.get_device_properties(0).total_memory =
# 85,017,493,504 bytes on an NVIDIA H100 80GB HBM3, power limit
# 700.00 W (torch 2.11.0+cu128; chip_smoke.py phase 17 holds the table
# to the card it runs on)
GENERATION_HBM_MB = {
    "h100": 81079,
}
# bus bandwidth a rank (GB/s of 1e9 bytes) over NVLink for the cost
# estimate: the psum of parallel/collectives.py over four NVIDIA H100
# 80GB HBM3 cards at 700.00 W, 64 MB a rank (chip_smoke.py --nccl-gang;
# the same run's ring hop read 151.2)
NVLINK_GBPS = {"h100": 220.2}
# cross-host data-center network (dcn axis collectives): an ASSUMED
# 100 Gb/s link; no chip run has measured it
DCN_GBPS = 12.5


# the port's framework directory, relative to the repo root
FRAMEWORK_DIR = os.path.join("dcos_commons_tpu_torch", "frameworks")


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


def normalize_spec(spec, rank: int) -> Tuple[Tuple[str, ...], ...]:
    """PartitionSpec -> per-dim tuples of axis names, length ``rank``.

    ``P("tp", ("dp", "fsdp"), None)`` at rank 4 becomes
    ``(("tp",), ("dp", "fsdp"), (), ())``.
    """
    entries: List[Tuple[str, ...]] = []
    for entry in tuple(spec or ()):
        if entry is None:
            entries.append(())
        elif isinstance(entry, str):
            entries.append((entry,))
        else:
            entries.append(tuple(entry))
    while len(entries) < rank:
        entries.append(())
    return tuple(entries[:rank])


@dataclass(frozen=True)
class AbstractLeaf:
    """One abstract array: a param, grad, optimizer, activation, or
    KV-cache tensor with its sharding rule."""

    path: str                       # e.g. "params/layers/wq"
    shape: Tuple[int, ...]
    dtype_bytes: int
    spec: Tuple[Tuple[str, ...], ...]
    section: str                    # params|grads|opt|activations|kv
    # the sharding-rule path this leaf's spec came from: the dedup
    # identity, so the params/grads/opt copies of one bad rule report
    # ONE finding (defaults to the path minus its section prefix)
    rule_path: str = ""

    @property
    def bytes(self) -> int:
        return _prod(self.shape) * self.dtype_bytes

    @property
    def dedup_path(self) -> str:
        return self.rule_path or self.path.split("/", 1)[-1]


@dataclass
class LeafReport:
    """The sharding arithmetic of one leaf over one mesh."""

    leaf: AbstractLeaf
    per_chip_bytes: int = 0
    shard_product: int = 1
    replication: int = 1
    # (rule-id, dedup-key, message) triples
    problems: List[Tuple[str, str, str]] = field(default_factory=list)


def shard_leaf(
    leaf: AbstractLeaf,
    axes: Mapping[str, int],
    vocab: FrozenSet[str] = frozenset(),
) -> LeafReport:
    """Divide one leaf over the mesh; the exactness property
    (tests/test_shard_properties.py) is
    ``per_chip_bytes * total_chips == bytes * replication``
    whenever every sharded dim divides evenly."""
    report = LeafReport(leaf)
    bare = leaf.dedup_path
    per_chip_elems = 1
    for i, dim in enumerate(leaf.shape):
        names = leaf.spec[i] if i < len(leaf.spec) else ()
        q = 1
        for name in names:
            size = axes.get(name)
            if size is None:
                if name not in vocab:
                    report.problems.append((
                        "shard-unknown-axis",
                        f"{bare}:{name}",
                        f"{leaf.path} dim {i}: PartitionSpec names "
                        f"axis {name!r}, which is in no mesh-axis "
                        "vocabulary of the tree",
                    ))
                # harvested-but-unlaid axes act as size 1 (replicated)
                continue
            q *= size
        if q > 1 and dim % q:
            report.problems.append((
                "shard-divisibility",
                f"{bare}:{i}",
                f"{leaf.path}: mesh axes {'*'.join(names)} (size {q}) "
                f"do not divide dim {i} of shape "
                f"{tuple(leaf.shape)} ({dim} % {q} = {dim % q})",
            ))
        report.shard_product *= q
        per_chip_elems *= math.ceil(dim / q)
    total = _prod(axes.values()) or 1
    report.per_chip_bytes = per_chip_elems * leaf.dtype_bytes
    report.replication = max(total // report.shard_product, 1)
    return report


def _walk_shapes(tree, rules: Mapping[str, Any], section: str,
                 dtype_bytes=None, prefix: str = "") -> List[AbstractLeaf]:
    """Flatten an eval_shape dict tree into AbstractLeafs via the
    path->PartitionSpec rules (the transformer's sharding_rules
    layout)."""
    out: List[AbstractLeaf] = []
    if isinstance(tree, dict):
        for name, sub in sorted(tree.items()):
            out += _walk_shapes(
                sub, rules, section, dtype_bytes,
                f"{prefix}/{name}" if prefix else name,
            )
        return out
    shape = tuple(int(d) for d in tree.shape)
    spec = normalize_spec(rules.get(prefix), len(shape))
    out.append(AbstractLeaf(
        path=f"{section}/{prefix}",
        shape=shape,
        dtype_bytes=int(dtype_bytes or tree.dtype.itemsize),
        spec=spec,
        section=section,
    ))
    return out


@dataclass
class Workload:
    """The abstract workload one pod task runs: its mesh and every
    tensor the footprint model tracks."""

    script: str
    mesh: Any                       # parallel.mesh.MeshSpec
    leaves: List[AbstractLeaf]
    train: bool = False
    # tp-axis activation payload per train step (bytes, pre-sharding)
    # for the cost model; 0 when the profile has no layer activations
    tp_act_bytes: int = 0


# -- workload profiles -------------------------------------------------
#
# script basename -> builder(env, gpu, pod, task) -> Workload.  The
# env is the task's YAML env merged under GpuSpec.mesh_env() — the
# contract the launch path hands the worker.  Tests (and future
# frameworks) register new entries by assignment.


def _abstract_params(config):
    """(meta param tree, sharding rules) for one config — built once per
    workload and threaded to every consumer."""
    from dcos_commons_tpu_torch.models.transformer import (
        init_params,
        sharding_rules,
    )

    return init_params(config, 0, "meta"), sharding_rules(config)


def _param_leaves(shapes, rules, quantized: bool = False,
                  section: str = "params") -> List[AbstractLeaf]:
    # quantized (serve workers' WEIGHT_DTYPE=int8): matmul weights at
    # ~1 byte/elem (per-output-channel f32 scales, <1%, folded in).
    # Training never quantizes, so its profile never sets this.
    leaves = _walk_shapes(shapes, rules, section)
    if quantized:
        leaves = [
            AbstractLeaf(l.path, l.shape, 1, l.spec, l.section)
            if len(l.shape) >= 2 and l.dtype_bytes > 1 else l
            for l in leaves
        ]
    return leaves


def _opt_leaves(param_leaves: Sequence[AbstractLeaf]) -> List[AbstractLeaf]:
    """torch.optim.Adam/AdamW state: ``exp_avg`` and ``exp_avg_sq`` of
    each param, in its dtype and with its sharding (the same
    inheritance make_train_step applies), and its f32 ``step``
    scalar, replicated."""
    out: List[AbstractLeaf] = []
    for l in param_leaves:
        rule_path = l.dedup_path
        for moment in ("exp_avg", "exp_avg_sq"):
            out.append(AbstractLeaf(
                f"opt/{moment}/{rule_path}", l.shape, l.dtype_bytes,
                l.spec, "opt", rule_path=rule_path,
            ))
        out.append(AbstractLeaf(
            f"opt/step/{rule_path}", (), 4, (), "opt",
            rule_path=rule_path,
        ))
    return out


def _batch_entry() -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """(batch-dim axes, seq-dim axes) of the train step's batch: rows
    over the batch axes, the sequence over sp."""
    from dcos_commons_tpu_torch.parallel.mesh import BATCH_AXES

    return tuple(BATCH_AXES), ("sp",)


def _train_profile(env, gpu, pod, task, batch: int = 0) -> Workload:
    """The train worker's step; ``batch`` (0: the worker's rule,
    ``max(2, 2 * cards)``) sizes the activations of another caller's
    step."""
    from dcos_commons_tpu_torch.models.transformer import config_from_env
    from dcos_commons_tpu_torch.parallel.mesh import derive

    config = config_from_env(env)
    mesh = derive(env)          # SpecError -> shard-mesh at the caller
    shapes, rules = _abstract_params(config)
    leaves = _param_leaves(shapes, rules)
    leaves += [
        AbstractLeaf(l.path.replace("params/", "grads/", 1), l.shape,
                     l.dtype_bytes, l.spec, "grads")
        for l in leaves
    ]
    leaves += _opt_leaves([l for l in leaves if l.section == "params"])
    batch_axes, seq_axes = _batch_entry()
    b = batch or max(2, 2 * mesh.total)
    s, d = config.max_seq, config.d_model
    act_bytes = config.dtype.itemsize
    # remat's floor: one residual-stream boundary per layer stays live
    leaves.append(AbstractLeaf(
        "act/layer-boundaries", (config.n_layers, b, s, d), act_bytes,
        ((), batch_axes, seq_axes, ()), "activations",
    ))
    # the f32 logits block (loss_chunk bounds it when set)
    chunk = config.loss_chunk if 0 < config.loss_chunk < s else s
    leaves.append(AbstractLeaf(
        "act/logits", (b, chunk, config.vocab), 4,
        (batch_axes, seq_axes, ()), "activations",
    ))
    # fwd+bwd activation collectives over tp ride 2 allreduces/layer
    tp_act = 4 * config.n_layers * b * s * d * act_bytes
    return Workload(
        script="train_worker.py", mesh=mesh, leaves=leaves, train=True,
        tp_act_bytes=tp_act,
    )


def _mnist_profile(env, gpu, pod, task) -> Workload:
    from dcos_commons_tpu_torch.models.mlp import MlpConfig, mlp_init
    from dcos_commons_tpu_torch.parallel.mesh import MeshSpec

    leaves = _walk_shapes(mlp_init(MlpConfig(), 0, "meta"), {}, "params")
    leaves += _opt_leaves(leaves)
    # train_mnist.py runs on one card: its "mesh" is one card, whatever
    # the pod reserves
    return Workload(
        script="train_mnist.py", mesh=MeshSpec(), leaves=leaves,
        train=True,
    )


def _serve_leaves(env, mesh_total_tp: int) -> Tuple[Any, List[AbstractLeaf]]:
    from dcos_commons_tpu_torch.models.decode import init_kv_cache
    from dcos_commons_tpu_torch.models.transformer import config_from_env

    config = config_from_env(env, remat=False)
    shapes, rules = _abstract_params(config)
    leaves = _param_leaves(
        shapes, rules,
        quantized=env.get("WEIGHT_DTYPE", "native") == "int8",
    )
    # the serving KV footprint IS the runtime allocation, exactly:
    # by default the PAGED ARENA (serve/paging.py) — KV_PAGES usable
    # pages + the trash page, each KV_PAGE_TOKENS positions, shaped by
    # the SAME paged_config_from_env contract the workers consume (an
    # under-budgeted arena is a SpecError at derivation) — or, when
    # KV_PAGE_TOKENS=0 selects the legacy slot pool, the SLOTS x
    # MAX_LEN carve.  Both honor KV_DTYPE (int8 halves the bytes).
    # A managed budget, not a per-request guess: occupancy within
    # this allocation is the runtime gauge (kv_occupancy /
    # kv_pages_free), the allocation itself is what the card must hold.
    from dcos_commons_tpu_torch.serve.paging import paged_config_from_env

    slots = int(env.get("SERVE_SLOTS") or 0) or int(
        # mirrors the serve workers' conservative single-request
        # fallback, not the options.json deploy default
        # sdklint: disable=config-default-drift — dev fallback
        env.get("SERVE_BATCH", "1")
    )
    max_len = int(env.get("MAX_LEN", "256"))
    kv_dtype = env.get("KV_DTYPE", "native")
    paged = paged_config_from_env(env)
    if paged is not None:
        from dcos_commons_tpu_torch.models.decode import (
            init_paged_kv_cache,
        )

        cache_shapes = init_paged_kv_cache(
            config, paged.arena_pages, paged.page_tokens, kv_dtype,
            device="meta",
        )
    else:
        cache_shapes = init_kv_cache(
            config, slots, max_len, kv_dtype, device="meta"
        )
    # cache dims (layers, pages-or-slots, tokens, kv_heads, head_dim):
    # heads ride tp like the attention weights when divisible (the
    # gang worker's cache_sharding — kv heads sit on dim 3 in BOTH
    # layouts), else the cache replicates; pages/slots replicate
    # across the gang (every rank steps the same broadcast pool)
    kv_sharded = (
        mesh_total_tp > 1 and config.n_kv_heads % mesh_total_tp == 0
    )
    kv_spec = {
        name: ((), (), (), ("tp",) if kv_sharded else (), ())
        for name in cache_shapes
    }
    leaves += _walk_shapes(cache_shapes, kv_spec, "kv")
    # pool decode-step residual + final logits: every slot computes
    # each step (static shapes); small next to params + the pool
    leaves.append(AbstractLeaf(
        "act/decode-step", (slots, 1, config.d_model),
        config.dtype.itemsize,
        ((), (), ()), "activations",
    ))
    leaves.append(AbstractLeaf(
        "act/logits", (slots, 1, config.vocab), 4,
        ((), (), ()), "activations",
    ))
    return config, leaves


def _serve_profile(env, gpu, pod, task) -> Workload:
    from dcos_commons_tpu_torch.parallel.mesh import MeshSpec

    # serve_worker.py is the single-card path
    _, leaves = _serve_leaves(env, mesh_total_tp=1)
    return Workload(script="serve_worker.py", mesh=MeshSpec(),
                    leaves=leaves)


def _serve_gang_profile(env, gpu, pod, task) -> Workload:
    from dcos_commons_tpu_torch.parallel.mesh import MeshSpec

    # serve_gang_worker.py lays the WHOLE gang as one tp axis
    total = gpu.total_chips * max(gpu.slices, 1)
    _, leaves = _serve_leaves(env, mesh_total_tp=total)
    return Workload(script="serve_gang_worker.py",
                    mesh=MeshSpec(tp=total), leaves=leaves)


PROFILES: Dict[str, Callable] = {
    "train_worker.py": _train_profile,
    "train_mnist.py": _mnist_profile,
    "serve_worker.py": _serve_profile,
    "serve_gang_worker.py": _serve_gang_profile,
}


# -- the analysis ------------------------------------------------------


@dataclass
class ShardReport:
    """Machine-readable per-pod output (--json shard.footprint/cost)."""

    key: str                        # "<framework dir>/svc.yml:trainer"
    script: str
    mesh: Dict[str, int]
    chips: int
    footprint: Dict[str, Any]
    cost: Optional[Dict[str, Any]] = None


@dataclass
class ShardResult(LintResult):
    reports: List[ShardReport] = field(default_factory=list)


def axis_vocabulary() -> FrozenSet[str]:
    """Every axis a mesh of the port can lay: the ``MeshSpec`` fields."""
    from dcos_commons_tpu_torch.parallel.mesh import MeshSpec

    return frozenset(f.name for f in dataclasses.fields(MeshSpec))


def _check_workload(
    workload: Workload,
    vocab: FrozenSet[str],
) -> Tuple[List[LeafReport], List[Tuple[str, str, str]]]:
    """Shard every leaf; returns (reports, deduped problems)."""
    axes = workload.mesh.axes()
    reports = [shard_leaf(leaf, axes, vocab) for leaf in workload.leaves]
    seen: Dict[Tuple[str, str], str] = {}
    for report in reports:
        for rule, key, message in report.problems:
            seen.setdefault((rule, key), message)
    problems = [(rule, key, msg) for (rule, key), msg in seen.items()]
    # a laid mesh axis no PartitionSpec consumes is dead weight: every
    # chip along it computes the identical program
    used = {
        name
        for leaf in workload.leaves
        for names in leaf.spec
        for name in names
    }
    for name, size in axes.items():
        if size > 1 and name not in used:
            problems.append((
                "shard-mesh", f"idle-axis:{name}",
                f"mesh lays axis {name}={size} but no PartitionSpec "
                "of the workload shards anything over it",
            ))
    return reports, sorted(problems)


def _footprint(
    workload: Workload, reports: Sequence[LeafReport]
) -> Dict[str, Any]:
    sections: Dict[str, float] = {}
    for report in reports:
        mb = report.per_chip_bytes / (1024.0 * 1024.0)
        sections[report.leaf.section] = (
            sections.get(report.leaf.section, 0.0) + mb
        )
    per_chip = sum(sections.values())
    return {
        "per_chip_mb": round(per_chip, 2),
        "sections_mb": {k: round(v, 2) for k, v in sorted(sections.items())},
        "mesh_chips": workload.mesh.total,
    }


def _ring_vs_allgather(payload_bytes: float, k: int, gbps: float,
                       axis: str, op: str) -> Dict[str, Any]:
    """Wire bytes per chip for a k-way exchange of ``payload_bytes``:
    ring allreduce moves 2(k-1)/k × B; the all-gather-then-reduce
    spelling moves (k-1) × B (every chip pulls every shard).  For
    all_to_all both spellings move (k-1)/k × B."""
    if op == "all_to_all":
        ring = gather = payload_bytes * (k - 1) / k
    else:
        ring = 2.0 * payload_bytes * (k - 1) / k
        gather = payload_bytes * (k - 1)
    # the probe's GB/s are of 1e9 bytes
    to_us = 1e6 / (gbps * 1e9)
    return {
        "axis": axis,
        "participants": k,
        "op": op,
        "payload_mb": round(payload_bytes / 2 ** 20, 3),
        "ring_mb_per_chip": round(ring / 2 ** 20, 3),
        "allgather_mb_per_chip": round(gather / 2 ** 20, 3),
        "ring_us": round(ring * to_us, 1),
        "allgather_us": round(gather * to_us, 1),
        "recommend": "ring" if ring <= gather else "all-gather",
    }


def _cost_model(
    workload: Workload,
    reports: Sequence[LeafReport],
    generation: str,
) -> Optional[Dict[str, Any]]:
    """Per-training-step collective bytes/latency over NVLink.

    Gradient reduction rides the data axes (dcn over the data-center
    network, dp/fsdp over NVLink) at the PER-CARD gradient size; tp moves 2 activation
    allreduces per layer each direction; ep moves the two dispatch
    all_to_alls.  Estimates, not measurements — their value is the
    TREND across config changes, tracked via ``--json``.
    """
    if not workload.train:
        return None
    axes = workload.mesh.axes()
    nvlink = NVLINK_GBPS.get(generation, NVLINK_GBPS["h100"])
    grad_per_chip = sum(
        r.per_chip_bytes for r in reports if r.leaf.section == "grads"
    )
    entries: List[Dict[str, Any]] = []
    for axis in ("dcn", "dp", "fsdp"):
        k = axes[axis]
        if k <= 1:
            continue
        gbps = DCN_GBPS if axis == "dcn" else nvlink
        op = "reduce_scatter+all_gather" if axis == "fsdp" else "allreduce"
        entries.append(
            _ring_vs_allgather(grad_per_chip, k, gbps, axis, op)
        )
    if axes["tp"] > 1 and workload.tp_act_bytes:
        batch_shard = _prod(
            axes[a] for a in ("dcn", "dp", "fsdp", "sp")
        )
        entries.append(_ring_vs_allgather(
            workload.tp_act_bytes / max(batch_shard, 1), axes["tp"],
            nvlink, "tp", "allreduce",
        ))
    if axes["ep"] > 1:
        moe_per_chip = sum(
            r.per_chip_bytes for r in reports
            if r.leaf.section == "activations"
            and "layer-boundaries" in r.leaf.path
        )
        entries.append(_ring_vs_allgather(
            2.0 * moe_per_chip, axes["ep"], nvlink, "ep", "all_to_all",
        ))
    if not entries:
        return {"per_step": [], "total_ring_us": 0.0,
                "total_allgather_us": 0.0}
    return {
        "per_step": entries,
        "total_ring_us": round(sum(e["ring_us"] for e in entries), 1),
        "total_allgather_us": round(
            sum(e["allgather_us"] for e in entries), 1
        ),
    }


def stepcompare(
    cost: Optional[Dict[str, Any]],
    records: Sequence[Dict[str, Any]],
    floor_us: float = 0.0,
    slack: float = 0.25,
    skip: int = 1,
) -> Dict[str, Any]:
    """Predicted-vs-measured step time: the ``shard.cost`` wire-time
    model held against a worker's steplog JSONL records.

    ``cost`` is a :func:`_cost_model` dict (or None when the mesh has
    no collectives — a single chip); its wire floor sums, PER AXIS,
    the cheaper of the ring and all-gather spellings — each axis's
    collective picks its own spelling independently, and the dcn
    entry rides the DCN bandwidth table, so a multi-slice gang's
    floor includes its cross-slice gradient leg instead of letting
    the slow DCN hop hide inside a whole-model min (the gate would
    otherwise read an honest multi-slice step as a regression — or a
    regressed one as fine).  ``floor_us`` is the
    caller's calibrated compute floor (the cost model speaks only for
    the interconnect; bench_train_step calibrates compute by running
    the bare device loop).  ``records`` are steplog dicts — ``wall_s``
    is what each step actually took, ``blocked_s`` what the gang skew
    cost on top.

    The verdict: ``measured_over_floor_x`` is MEAN measured wall over
    the combined floor, and ``regression`` trips when it exceeds
    ``1 + slack`` — the perf gate "measured step time regressed >X%
    against the cost-model floor".  The mean is the gate statistic
    (not p50) because the window's billing conserves TOTAL wall —
    each step is billed ready-to-ready time, so host-side stalls and
    pipeline-fill land somewhere in the stream even when event
    clustering skews individual records; p50/p95 are reported for
    shape.  ``regression`` is None (ungated) when there is nothing to
    gate against: no records, or a zero combined floor.

    ``skip`` drops the first records in LOG ORDER (default 1): a cold
    worker's step 0 bills the jit compile plus pipeline fill — one
    multi-second record that would dominate the mean of a short log
    and is not a property of the steady-state step.
    """
    from dcos_commons_tpu_torch.metrics.registry import percentile

    records = list(records)[max(0, int(skip)):]
    walls = sorted(
        float(r["wall_s"]) for r in records
        if isinstance(r.get("wall_s"), (int, float))
    )
    blocked = sorted(
        float(r["blocked_s"]) for r in records
        if isinstance(r.get("blocked_s"), (int, float))
    )
    wire_us = 0.0
    dcn_wire_us = 0.0
    if cost and cost.get("per_step"):
        # per-axis cheaper-of: each collective runs ONE spelling, so
        # the floor is the sum of per-axis minima (<= the min of the
        # whole-model sums — the gate only loosens for old specs)
        for e in cost["per_step"]:
            leg = min(
                float(e.get("ring_us", 0.0)),
                float(e.get("allgather_us", 0.0)),
            )
            wire_us += leg
            if e.get("axis") == "dcn":
                dcn_wire_us += leg
    predicted_floor_us = wire_us + max(0.0, float(floor_us))
    out: Dict[str, Any] = {
        "steps": len(walls),
        "predicted_wire_us": round(wire_us, 1),
        "predicted_wire_dcn_us": round(dcn_wire_us, 1),
        "compute_floor_us": round(float(floor_us), 1),
        "predicted_floor_us": round(predicted_floor_us, 1),
        "slack": slack,
        "measured_mean_us": None,
        "measured_p50_us": None,
        "measured_p95_us": None,
        "blocked_p50_us": None,
        "measured_over_floor_x": None,
        "regression": None,
    }
    if not walls:
        return out
    mean_us = sum(walls) / len(walls) * 1e6
    out["measured_mean_us"] = round(mean_us, 1)
    out["measured_p50_us"] = round(percentile(walls, 50) * 1e6, 1)
    out["measured_p95_us"] = round(percentile(walls, 95) * 1e6, 1)
    if blocked:
        out["blocked_p50_us"] = round(percentile(blocked, 50) * 1e6, 1)
    if predicted_floor_us > 0:
        ratio = mean_us / predicted_floor_us
        out["measured_over_floor_x"] = round(ratio, 3)
        out["regression"] = bool(ratio > 1.0 + slack)
    return out


def _yml_files(framework_dir: str) -> List[str]:
    return sorted(
        os.path.join(framework_dir, f)
        for f in os.listdir(framework_dir)
        if f.endswith(".yml")
    )


def _match_profile(cmd: str) -> Optional[Callable]:
    for script, builder in PROFILES.items():
        if script in (cmd or ""):
            return builder
    return None


def analyze_framework(
    framework_dir: str,
    root: str,
    vocab: FrozenSet[str],
    hbm_mb: int = 0,
    giant_mb: float = 256.0,
) -> ShardResult:
    from dcos_commons_tpu_torch.specification.yaml_spec import (
        from_yaml_file,
    )
    from dcos_commons_tpu_torch.tools import options as options_mod

    result = ShardResult()
    disabled: set = set()
    try:
        schema = options_mod.load_schema(framework_dir)
        if schema is not None:
            disabled = {str(r) for r in schema.get("x-sdklint-disable") or []}
        env = options_mod.render_options(schema, {}) if schema else {}
    except options_mod.OptionsError:
        env = {}  # speccheck owns schema errors

    for path in _yml_files(framework_dir):
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        with open(path, "r", encoding="utf-8") as f:
            lines = f.read().splitlines()
        try:
            spec = from_yaml_file(path, env)
        except Exception:  # sdklint: disable=swallowed-exception — speccheck owns render/spec errors; shardcheck only reads specs that render
            continue
        anchor = _make_anchor(lines)
        suppressions = Suppressions(lines)
        checked_any = False
        raw: List[Finding] = []
        for pod in spec.pods:
            if pod.gpu is None:
                continue
            for task in pod.tasks:
                builder = _match_profile(task.cmd)
                if builder is None:
                    continue
                checked_any = True
                raw += _analyze_pod_task(
                    rel, pod, task, builder, anchor, vocab,
                    hbm_mb, giant_mb, result.reports,
                )
        if checked_any:
            result.files_checked += 1
        for finding in raw:
            if finding.rule in disabled or "all" in disabled \
                    or suppressions.covers(finding):
                result.suppressed.append(finding)
            else:
                result.findings.append(finding)
    result.findings.sort(key=lambda f: (f.file, f.line, f.rule))
    return result


def _make_anchor(lines: Sequence[str]):
    """Pod findings anchor to (and suppress at) the declaring
    ``<name>:`` line, like speccheck's."""
    def anchor(name: str) -> int:
        pattern = re.compile(rf"^\s*{re.escape(str(name))}\s*:")
        for i, text in enumerate(lines, start=1):
            if pattern.match(text):
                return i
        return 1
    return anchor


def pod_task_mesh_env(pod, task) -> dict:
    """The one env→mesh contract: the task's env overlaid with the
    pod's gpu mesh env, exactly what the launch path hands the
    worker."""
    env = dict(task.env)
    env.update(pod.gpu.mesh_env())
    return env


def declared_chips(pod) -> int:
    """Cards the spec reserves for ONE workload: the whole gang for
    gang/topology pods, one instance's host cards otherwise."""
    gpu = pod.gpu
    return (
        gpu.total_chips * max(gpu.slices, 1)
        if pod.gang or gpu.topology else gpu.chips_per_host
    )


def mesh_span_message(where: str, declared: int, total: int,
                      laid_by: str) -> str:
    """The shard-mesh reserved-vs-laid mismatch text."""
    return (
        f"{where}: the spec reserves {declared} chip(s) but "
        f"{laid_by} spans {total} — "
        + ("reserved chips sit idle" if declared > total
           else "the workload cannot get the chips it lays")
    )


def fleet_slice_count(inventory, generation: str) -> Optional[int]:
    """Distinct registered fabrics (``slice_id``) of ``generation`` GPU
    hosts — the one formula the multi-slice admission gate sizes
    `gpu: slices: N` against (multi/admission.py).  None when the
    inventory holds no GPU hosts at all (scheduler bootstrap): sizing
    against an empty fleet would reject every multi-slice spec exactly
    when registration must not depend on fleet availability."""
    if inventory is None:
        return None
    slices = set()
    any_gpu = False
    for host in inventory.hosts():
        if not host.generation:
            continue
        any_gpu = True
        if host.generation == generation:
            slices.add(host.slice_id)
    return len(slices) if any_gpu else None


def _analyze_pod_task(
    rel: str, pod, task, builder, anchor, vocab,
    hbm_mb: int, giant_mb: float, reports_out: List[ShardReport],
) -> List[Finding]:
    from dcos_commons_tpu_torch.specification.specs import SpecError

    gpu = pod.gpu
    line = anchor(pod.type)
    where = f"pod {pod.type!r} task {task.name!r}"
    env = pod_task_mesh_env(pod, task)
    try:
        workload = builder(env, gpu, pod, task)
    except SpecError as e:
        return [Finding(rel, line, "shard-mesh", f"{where}: {e}")]
    except Exception as e:
        # a malformed env value (VOCAB: "not-a-number") or a broken
        # profile must fail THIS pod with a suppressible, anchored
        # finding — not abort the whole analysis CLI with a traceback
        return [Finding(
            rel, line, "shard-mesh",
            f"{where}: workload profile {builder.__name__} failed: "
            f"{type(e).__name__}: {e}",
        )]
    findings: List[Finding] = []

    declared = declared_chips(pod)
    if workload.mesh.total != declared:
        findings.append(Finding(
            rel, line, "shard-mesh",
            mesh_span_message(where, declared, workload.mesh.total,
                              f"{workload.script}'s mesh"),
        ))

    leaf_reports, problems = _check_workload(workload, vocab)
    for rule, _key, message in problems:
        findings.append(Finding(rel, line, rule, f"{where}: {message}"))

    threshold = giant_mb * 1024 * 1024
    for report in leaf_reports:
        leaf = report.leaf
        if leaf.section == "params" and leaf.bytes >= threshold \
                and report.replication > 1:
            findings.append(Finding(
                rel, line, "shard-replicated-giant",
                f"{where}: {leaf.path} "
                f"({leaf.bytes / 2 ** 20:.0f} MB) is replicated "
                f"{report.replication}x across the mesh — add an "
                "fsdp/tp entry to its PartitionSpec or raise "
                "--giant-mb if intentional",
            ))

    footprint = _footprint(workload, leaf_reports)
    per_chip_mb = footprint["per_chip_mb"]
    hbm_budget = hbm_mb or GENERATION_HBM_MB.get(gpu.generation, 0)
    if hbm_budget and per_chip_mb > hbm_budget:
        findings.append(Finding(
            rel, line, "shard-hbm-overcommit",
            f"{where}: per-card footprint {per_chip_mb:.0f} MB exceeds "
            f"{gpu.generation} HBM ({hbm_budget} MB); shard more axes "
            "or shrink the model",
        ))
    chips_per_host_used = min(gpu.chips_per_host, workload.mesh.total)
    per_host_mb = per_chip_mb * max(chips_per_host_used, 1)
    declared_mem = task.resources.memory_mb
    if declared_mem and per_host_mb > declared_mem:
        findings.append(Finding(
            rel, line, "shard-hbm-overcommit",
            f"{where}: per-host footprint {per_host_mb:.0f} MB exceeds "
            f"the declared memory: {declared_mem} MB — raise the "
            "task's memory or shard the state further",
        ))
    footprint["per_host_mb"] = round(per_host_mb, 2)
    footprint["hbm_budget_mb"] = hbm_budget
    footprint["declared_memory_mb"] = declared_mem

    reports_out.append(ShardReport(
        key=f"{rel}:{pod.type}",
        script=workload.script,
        mesh={k: v for k, v in workload.mesh.axes().items() if v > 1},
        chips=workload.mesh.total,
        footprint=footprint,
        cost=_cost_model(workload, leaf_reports, gpu.generation),
    ))
    return findings


def analyze_all(
    root: str, hbm_mb: int = 0, giant_mb: float = 256.0
) -> ShardResult:
    """Every YAML of the port's framework directory under ``root``."""
    result = analyze_framework(
        os.path.join(root, FRAMEWORK_DIR), root, axis_vocabulary(),
        hbm_mb, giant_mb,
    )
    result.findings.sort(key=lambda f: (f.file, f.line, f.rule))
    return result


SHARD_RULES = (
    ("shard-mesh",
     "topology cannot lay a host-aligned mesh / reserved vs laid chip "
     "mismatch / idle mesh axis"),
    ("shard-divisibility",
     "a mesh axis product does not divide the dim it shards"),
    ("shard-unknown-axis",
     "a PartitionSpec axis outside the mesh-axis vocabulary"),
    ("shard-replicated-giant",
     "a giant param replicated across mesh axes (above --giant-mb)"),
    ("shard-hbm-overcommit",
     "per-card footprint exceeds generation HBM or declared memory"),
)


def shard_rule_catalog() -> str:
    lines = ["shardcheck rules (static sharding / HBM / layout):", ""]
    for rule_id, description in SHARD_RULES:
        lines.append(f"  {rule_id}")
        lines.append(f"      {description}")
    return "\n".join(lines)

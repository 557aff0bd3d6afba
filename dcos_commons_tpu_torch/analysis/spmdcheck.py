"""spmdcheck: whole-program SPMD collective-safety analysis (port of
``dcos_commons_tpu/analysis/spmdcheck.py``: the summaries, the taint
engine and the five rules unchanged; the scope, the collectives and
the sources of host identity are the port's).

The production failure this hunts is CROSS-HOST DIVERGENCE: a
multi-process ``torch.distributed`` gang is one SPMD program replicated
per process (one a GPU), and every process must issue the *same
sequence of collectives* (all_reduce, all_gather_into_tensor,
reduce_scatter_tensor, all_to_all_single, broadcast, barrier, the
rendezvous).  One host
taking a branch the others don't — because it branched on its own
rank, its own disk, its own clock, or an unordered container — makes
the gang's collective schedules disagree, and the slice deadlocks at
the next collective with no stack trace worth reading.  That bug
class is invisible to single-file lint (sdklint) because the
collective is usually three calls away from the divergent branch, so
this pass is interprocedural: it builds a per-function collective
summary, propagates it over the call graph to a fixpoint, and then
checks five named hazard rules at the AST level.

Rules (each suppressible with ``# sdklint: disable=<rule>`` and
absorbable by the shared ``.sdklint-baseline.json``):

- ``spmd-host-branch``: a collective reachable under an ``if``/
  ``while`` whose test depends on a host-identity value
  (``dist.get_rank()``, ``worker_id``/``rank``, per-host env such as
  ``RANK``/``LOCAL_RANK``/``CUDA_VISIBLE_DEVICES``, the card index,
  hostname, urandom, wall clock).
- ``spmd-traced-cond``: a collective under data-dependent control
  flow on a device-varying value (``axis_index`` derived) — Python
  ``if`` or ``cond``/``switch`` branches.  The port's ranks hold their
  mesh coordinate as a host value (``Mesh.index``), so on its tree
  this is the host-branch rule's business; the rule stays for the
  reference's vocabulary.
- ``spmd-unknown-axis``: a collective names a mesh axis that appears
  in no ``Mesh``/``MeshSpec``/axis-name vocabulary of the tree (the
  port's wrappers name theirs as a tuple, ``pmean(x, mesh, ("dp",))``).
- ``spmd-unordered-iter``: a collective schedule built by iterating a
  ``set``/``frozenset`` or ``os.environ`` — iteration order is not
  guaranteed identical across hosts.
- ``spmd-per-host-trip-count``: a loop that executes collectives (or
  jit-compiled mesh programs) whose trip count derives from a
  per-host value (checkpoint restore, ``torch.cuda.device_count()``,
  ``get_rank``, clock, urandom).

Scope: ``dcos_commons_tpu_torch/{parallel,models,ops,utils,storage,
frameworks}`` — the layers that run inside or drive the SPMD data
plane.  The tables below keep the reference's jax names beside the
port's, so a fixture in either vocabulary is judged the same way.
Findings reuse the sdklint ``Finding``/``Suppressions``
machinery so the CLI, baseline, and gate treatment are identical.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from dcos_commons_tpu_torch.analysis.linter import (
    Finding,
    LintResult,
    Suppressions,
)

# directories (relative to the repo root) the analyzer walks
SPMD_SUBDIRS = (
    "dcos_commons_tpu_torch/parallel",
    "dcos_commons_tpu_torch/models",
    "dcos_commons_tpu_torch/ops",
    "dcos_commons_tpu_torch/utils",
    "dcos_commons_tpu_torch/storage",
    "dcos_commons_tpu_torch/frameworks",
)

# the mesh-axis collectives (axis name = 2nd arg / axis_name kwarg, or
# a literal tuple of axes for the port's wrappers)
LAX_COLLECTIVES = {
    "psum", "pmean", "pmax", "pmin", "ppermute", "pshuffle",
    "all_gather", "all_to_all", "psum_scatter",
    # the port's mesh wrappers (parallel/sharding.py): over ``axes``
    "gather", "gather_fsdp", "copy_to", "reduce_from",
}
# the torch.distributed calls the port makes, each over a process group
TORCH_COLLECTIVES = {
    "all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
    "all_to_all_single", "broadcast", "barrier",
}
# explicit cross-process synchronization points: every process of the
# gang must execute these the same number of times in the same order
COLLECTIVE_OPS = LAX_COLLECTIVES | TORCH_COLLECTIVES | {
    "broadcast_one_to_all", "process_allgather", "sync_global_devices",
    "assert_equal",
    # the rendezvous: jax.distributed.initialize in the reference;
    # init_process_group and the port's gang helpers over it
    "initialize", "init_process_group", "init_gang",
    "initialize_from_env",
    # the port's mesh wrappers that reduce over fixed axes
    # (parallel/sharding.py) and its gang helpers
    # (parallel/distributed.py)
    "reduce_gradients", "batch_mean", "broadcast_int", "gather_ints",
    "broadcast_arrays",
}
# results of these are gang-uniform by construction: consuming them
# does NOT taint, and assigning from them CLEANSES a tainted name
UNIFORMIZERS = {"broadcast_one_to_all", "process_allgather", "psum",
                "pmean", "pmax", "pmin", "all_gather",
                "broadcast_int", "gather_ints", "broadcast_arrays",
                "all_reduce"}
# producers of mesh programs: calling their result executes whatever
# collectives XLA/GSPMD inserts, so loops driving them are schedules.
# The reference's names, kept for fixtures in its vocabulary: the
# port's path has no counterpart, because its steps run eagerly (no
# torch.compile, no captured graph), so every collective they issue is
# a call this pass sees in the source.
TRACER_ENTRY_POINTS = {"jit", "pjit", "shard_map", "pmap", "xmap"}

# host-identity taint seeds ------------------------------------------------
_HOST_CALLS = {
    "process_index", "getpid", "gethostname", "urandom", "uuid1",
    "uuid4", "time", "monotonic", "perf_counter", "time_ns",
    # the port's: the process group's rank, the card this process
    # drives, the gang rank of the scheduler's contract
    # (parallel/distributed.py; contract_from_env's per-host values
    # ride its worker_id and slice_index keys, below)
    "get_rank", "current_device", "gang_rank",
}
# per-host but NOT host-identity (don't flag branches, do flag trip
# counts): local device topology and local disk state
_PER_HOST_CALLS = _HOST_CALLS | {
    "local_devices", "local_device_count", "restore_checkpoint",
    "latest_step", "device_count",
}
# subscript/attribute keys that carry host identity through dicts
# (the scheduler's env contract: TPU_WORKER_ID differs per host,
# TPU_WORKER_COUNT etc. are gang-uniform)
_HOST_KEYS = {"worker_id", "process_id", "host_id", "rank", "hostname",
              "local_rank", "slice_index"}
_HOST_ENV_MARKERS = ("WORKER_ID", "PROCESS_ID", "HOSTNAME", "HOST_ID",
                     "NODE_ID", "RANK", "CUDA_VISIBLE_DEVICES")


def _call_name(node: ast.Call) -> str:
    """Rightmost name of the called expression: ``a.b.c(...)`` -> c."""
    func = node.func
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


def _const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _collective_axis(node: ast.Call) -> Optional[str]:
    """Literal axis name of a collective call, if statically visible."""
    for kw in node.keywords:
        if kw.arg in ("axis_name", "axis"):
            return _const_str(kw.value)
    if len(node.args) >= 2:
        return _const_str(node.args[1])
    return None


def _passed_collectives(node: ast.Call) -> Set[Tuple[str, Optional[str]]]:
    """``torch.distributed`` collectives handed to a call as a function
    (the port's wrappers time them: ``_collective(dist.all_reduce, t,
    ...)``): the callee runs them."""
    out: Set[Tuple[str, Optional[str]]] = set()
    for arg in node.args:
        name = (arg.attr if isinstance(arg, ast.Attribute)
                else arg.id if isinstance(arg, ast.Name) else "")
        if name in TORCH_COLLECTIVES:
            out.add((name, None))
    return out


def _collective_axes(node: ast.Call) -> List[str]:
    """Every literal axis name of a collective call: the reference's
    single axis, or the literal tuple of axes a port wrapper takes
    (``gather(x, 0, mesh, ("dp", "fsdp"))``)."""
    axis = _collective_axis(node)
    if axis is not None:
        return [axis]
    out: List[str] = []
    candidates = list(node.args[1:]) + [
        kw.value for kw in node.keywords if kw.arg == "axes"
    ]
    for arg in candidates:
        if isinstance(arg, (ast.Tuple, ast.List)) and arg.elts:
            names = [_const_str(elt) for elt in arg.elts]
            if all(names):
                out.extend(names)
    return out


@dataclass
class FunctionSummary:
    """What one function may do, transitively, to the gang."""

    qualname: str
    file: str
    lineno: int
    # (op, axis-or-None) pairs this function may execute
    collectives: Set[Tuple[str, Optional[str]]] = field(default_factory=set)
    # resolved callee keys + unresolved simple names
    calls: Set[str] = field(default_factory=set)
    # builds a jit/shard_map program (calling its RESULT runs a mesh
    # program, i.e. collectives from the runtime's point of view)
    traces: bool = False

    @property
    def may_collect(self) -> bool:
        return bool(self.collectives)


class ProgramSummary:
    """All function summaries of the scanned tree + the call graph
    fixpoint.  Call resolution is name-based: imports map simple names
    to module-qualified keys; a simple name defined in exactly one
    scanned module resolves across files."""

    def __init__(self) -> None:
        self.functions: Dict[str, FunctionSummary] = {}
        # simple name -> set of summary keys carrying that name
        self.by_name: Dict[str, Set[str]] = {}
        # axis-name vocabulary harvested from Mesh(...)/MeshSpec/axis
        # parameter defaults across the tree
        self.axis_vocab: Set[str] = set()

    def add(self, key: str, summary: FunctionSummary) -> None:
        self.functions[key] = summary
        simple = key.rsplit(".", 1)[-1]
        self.by_name.setdefault(simple, set()).add(key)

    def resolve(self, name: str) -> List[FunctionSummary]:
        """Summaries a call to ``name`` may land in."""
        if name in self.functions:
            return [self.functions[name]]
        keys = self.by_name.get(name.rsplit(".", 1)[-1], ())
        return [self.functions[k] for k in keys]

    def propagate(self) -> None:
        """Union callee collectives/traces into callers to fixpoint."""
        changed = True
        rounds = 0
        while changed and rounds < 50:
            changed = False
            rounds += 1
            for summary in self.functions.values():
                for callee_name in summary.calls:
                    for callee in self.resolve(callee_name):
                        if callee is summary:
                            continue
                        if not callee.collectives <= summary.collectives:
                            summary.collectives |= callee.collectives
                            changed = True
                        if callee.traces and not summary.traces:
                            summary.traces = True
                            changed = True

    def call_effects(
        self, call: ast.Call
    ) -> Tuple[Set[Tuple[str, Optional[str]]], bool]:
        """(collectives, traces) a call site may trigger."""
        name = _call_name(call)
        if not name:
            return set(), False
        if name in COLLECTIVE_OPS:
            return {(name, _collective_axis(call))}, False
        if name in TRACER_ENTRY_POINTS:
            return set(), True
        out: Set[Tuple[str, Optional[str]]] = _passed_collectives(call)
        traces = False
        for summary in self.resolve(name):
            out |= summary.collectives
            traces = traces or summary.traces
        return out, traces


# -- pass 1: build summaries ------------------------------------------------


class _SummaryBuilder(ast.NodeVisitor):
    """Collects one file's function summaries + axis vocabulary.

    Nested functions fold into their enclosing def's summary: calling
    a factory (or the closure it returns) may run the closure's
    collectives, and that over-approximation is the safe direction
    for divergence hazards.
    """

    def __init__(self, rel: str, program: ProgramSummary):
        self.rel = rel
        self.module = rel[:-3].replace("/", ".")
        self.program = program
        self._stack: List[FunctionSummary] = []

    # vocabulary ------------------------------------------------------

    def _harvest_vocab(self, node: ast.Call) -> None:
        name = _call_name(node)
        if name == "Mesh" and len(node.args) >= 2:
            names_arg = node.args[1]
            if isinstance(names_arg, (ast.Tuple, ast.List)):
                for elt in names_arg.elts:
                    axis = _const_str(elt)
                    if axis:
                        self.program.axis_vocab.add(axis)
        elif name == "MeshSpec":
            for kw in node.keywords:
                if kw.arg:
                    self.program.axis_vocab.add(kw.arg)

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        # MeshSpec-style axis dataclasses: field names are axes
        if any(
            isinstance(d, ast.Name) and d.id == "dataclass"
            or isinstance(d, ast.Call) and _call_name(d) == "dataclass"
            for d in node.decorator_list
        ) and "mesh" in node.name.lower():
            for stmt in node.body:
                if isinstance(stmt, ast.AnnAssign) and \
                        isinstance(stmt.target, ast.Name):
                    self.program.axis_vocab.add(stmt.target.id)
        self.generic_visit(node)

    # functions -------------------------------------------------------

    def _enter(self, node) -> None:
        if self._stack:
            # nested def: keep folding into the enclosing summary
            self._harvest_defaults(node)
            for stmt in node.body:
                self.visit(stmt)
            return
        summary = FunctionSummary(
            qualname=f"{self.module}.{node.name}",
            file=self.rel,
            lineno=node.lineno,
        )
        for decorator in node.decorator_list:
            for sub in ast.walk(decorator):
                if (isinstance(sub, ast.Name)
                        and sub.id in TRACER_ENTRY_POINTS) or (
                        isinstance(sub, ast.Attribute)
                        and sub.attr in TRACER_ENTRY_POINTS):
                    summary.traces = True
        self._stack.append(summary)
        self._harvest_defaults(node)
        for stmt in node.body:
            self.visit(stmt)
        self._stack.pop()
        self.program.add(summary.qualname, summary)

    def _harvest_defaults(self, node) -> None:
        """axis_name="sp" parameter defaults feed the vocabulary."""
        args = node.args
        pos = args.posonlyargs + args.args
        for arg, default in zip(pos[len(pos) - len(args.defaults):],
                                args.defaults):
            if arg.arg in ("axis_name", "axis") :
                axis = _const_str(default)
                if axis:
                    self.program.axis_vocab.add(axis)
        for arg, default in zip(args.kwonlyargs, args.kw_defaults):
            if default is not None and arg.arg in ("axis_name", "axis"):
                axis = _const_str(default)
                if axis:
                    self.program.axis_vocab.add(axis)

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._enter(node)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._enter(node)

    def visit_Call(self, node: ast.Call) -> None:
        self._harvest_vocab(node)
        name = _call_name(node)
        if self._stack and name:
            summary = self._stack[-1]
            if name in COLLECTIVE_OPS:
                summary.collectives.add((name, _collective_axis(node)))
            elif name in TRACER_ENTRY_POINTS:
                summary.traces = True
            else:
                summary.calls.add(name)
                summary.collectives |= _passed_collectives(node)
        self.generic_visit(node)


def build_summary(files: Iterable[Tuple[str, str, str]]) -> ProgramSummary:
    """files: (abs_path, rel_path, source) triples."""
    program = ProgramSummary()
    for _, rel, source in files:
        try:
            tree = ast.parse(source)
        except SyntaxError:
            continue
        _SummaryBuilder(rel, program).visit(tree)
    program.propagate()
    return program


# -- taint engine -----------------------------------------------------------


class _Taint:
    """Flow-ordered name taint for one function body.

    Three colors: ``host`` (host-identity: rank/pid/clock/urandom),
    ``perhost`` (host-local but not identity: checkpoint stamp, local
    device count — superset of host), ``varying`` (device-varying:
    lax.axis_index derived).  Assignment from a uniformizing
    collective cleanses all three.
    """

    def __init__(self, program: ProgramSummary):
        self.program = program
        self.host: Set[str] = set()
        self.perhost: Set[str] = set()
        self.varying: Set[str] = set()

    # -- expression coloring -----------------------------------------

    def _env_key_is_host(self, call: ast.Call) -> bool:
        for arg in list(call.args) + [kw.value for kw in call.keywords]:
            key = _const_str(arg)
            if key and any(m in key.upper() for m in _HOST_ENV_MARKERS):
                return True
        return False

    @staticmethod
    def _env_name_is_host(key: Optional[str]) -> bool:
        """An env var name read by subscript (``os.environ["RANK"]``)
        that carries host identity."""
        return bool(key) and key.isupper() and any(
            m in key for m in _HOST_ENV_MARKERS)

    def expr_colors(self, node: ast.AST) -> Set[str]:
        colors: Set[str] = set()
        for sub in ast.walk(node):
            if isinstance(sub, ast.Name):
                if sub.id in self.host:
                    colors |= {"host", "perhost"}
                if sub.id in self.perhost:
                    colors.add("perhost")
                if sub.id in self.varying:
                    colors.add("varying")
            elif isinstance(sub, ast.Call):
                name = _call_name(sub)
                if name in UNIFORMIZERS:
                    # a uniformizer's ARGUMENTS don't leak through it
                    return colors
                if name == "axis_index":
                    colors.add("varying")
                if name in _HOST_CALLS:
                    colors |= {"host", "perhost"}
                elif name in _PER_HOST_CALLS:
                    colors.add("perhost")
                elif name in ("get", "getenv") and self._env_key_is_host(sub):
                    colors |= {"host", "perhost"}
            elif isinstance(sub, ast.Subscript):
                key = _const_str(sub.slice)
                if key in _HOST_KEYS or self._env_name_is_host(key):
                    colors |= {"host", "perhost"}
            elif isinstance(sub, ast.Attribute):
                if sub.attr in _HOST_KEYS:
                    colors |= {"host", "perhost"}
        return colors

    def _is_uniformizer_result(self, value: ast.AST) -> bool:
        for sub in ast.walk(value):
            if isinstance(sub, ast.Call) and \
                    _call_name(sub) in UNIFORMIZERS:
                return True
        return False

    # -- statement-order updates -------------------------------------

    def _target_names(self, target: ast.AST) -> List[str]:
        out = []
        for sub in ast.walk(target):
            if isinstance(sub, ast.Name):
                out.append(sub.id)
        return out

    def assign(self, targets: Sequence[ast.AST], value: ast.AST) -> None:
        if isinstance(value, (ast.Dict, ast.DictComp)):
            # dict literals are not tainted wholesale: consumers are
            # discriminated per key at the subscript (the env-contract
            # dict mixes per-host worker_id with gang-uniform values)
            return
        colors = self.expr_colors(value)
        cleanse = self._is_uniformizer_result(value) and not colors
        names = [n for t in targets for n in self._target_names(t)]
        for name in names:
            if cleanse:
                self.host.discard(name)
                self.perhost.discard(name)
                self.varying.discard(name)
                continue
            if "host" in colors:
                self.host.add(name)
            if "perhost" in colors:
                self.perhost.add(name)
            if "varying" in colors:
                self.varying.add(name)
            if not colors:
                self.host.discard(name)
                self.perhost.discard(name)
                self.varying.discard(name)


# -- pass 2: the rules ------------------------------------------------------


class SpmdRule:
    id = ""
    description = ""

    def check(self, ctx: "SpmdContext") -> List[Finding]:
        raise NotImplementedError


class SpmdContext:
    """One file + the whole-program summary, pre-chewed for rules."""

    def __init__(self, rel: str, tree: ast.AST, program: ProgramSummary):
        self.rel = rel
        self.tree = tree
        self.program = program

    def finding(self, node: ast.AST, rule: str, message: str) -> Finding:
        return Finding(self.rel, getattr(node, "lineno", 1), rule, message)

    def may_collect(self, node: ast.AST) -> Set[Tuple[str, Optional[str]]]:
        """All collectives any call inside ``node`` may execute."""
        out: Set[Tuple[str, Optional[str]]] = set()
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                ops, _ = self.program.call_effects(sub)
                out |= ops
        return out

    def may_run_mesh_program(self, node: ast.AST,
                             traced_names: Set[str]) -> bool:
        """True when ``node`` may execute collectives OR call a
        jit/shard_map-produced function (implicit GSPMD collectives)."""
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            ops, traces = self.program.call_effects(sub)
            if ops or traces:
                return True
            func = sub.func
            if isinstance(func, ast.Name) and func.id in traced_names:
                return True
        return False

    def functions(self):
        """Every def in the file, plus the module body as one
        pseudo-function — a worker driver script whose collective loop
        sits at top level (no main() wrapper) is the same hazard."""
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield node
        toplevel = [
            stmt for stmt in self.tree.body
            if not isinstance(stmt, (ast.FunctionDef,
                                     ast.AsyncFunctionDef,
                                     ast.ClassDef))
        ]
        if toplevel:
            shell = ast.parse("def f():\n    pass").body[0]
            shell.name = "<module>"
            shell.body = toplevel
            yield shell


def _walk_statements(body: Sequence[ast.stmt], taint: _Taint,
                     traced_names: Set[str], program: ProgramSummary,
                     visit_stmt) -> None:
    """Source-order statement walk maintaining taint + the set of
    names bound to jit/shard_map program objects."""
    for stmt in body:
        if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = (
                stmt.targets if isinstance(stmt, ast.Assign)
                else [stmt.target]
            )
            value = stmt.value
            if value is not None:
                for sub in ast.walk(value):
                    if isinstance(sub, ast.Call):
                        _, traces = program.call_effects(sub)
                        if traces:
                            for t in targets:
                                if isinstance(t, ast.Name):
                                    traced_names.add(t.id)
                taint.assign(targets, value)
        visit_stmt(stmt)
        for child_body in _stmt_bodies(stmt):
            _walk_statements(child_body, taint, traced_names, program,
                             visit_stmt)


def _stmt_bodies(stmt: ast.stmt) -> List[Sequence[ast.stmt]]:
    out = []
    for name in ("body", "orelse", "finalbody"):
        body = getattr(stmt, name, None)
        if body and not isinstance(
            stmt, (ast.FunctionDef, ast.AsyncFunctionDef)
        ):
            out.append(body)
    for handler in getattr(stmt, "handlers", ()):
        out.append(handler.body)
    if isinstance(stmt, ast.For):
        pass  # body already covered above
    return out


class HostBranchRule(SpmdRule):
    """A collective below an ``if``/``while`` whose test carries host
    identity (rank, pid, hostname, urandom, clock, per-host env).  If
    any host takes the branch and another doesn't, their collective
    schedules disagree and the gang deadlocks.  Driver loops where
    leader and followers deliberately meet in the SAME collective
    sequence (broadcast fan-out) are the legitimate annotated
    exception."""

    id = "spmd-host-branch"
    description = "collective reachable under a host-identity branch"

    def check(self, ctx: SpmdContext) -> List[Finding]:
        out = []
        for func in ctx.functions():
            taint = _Taint(ctx.program)
            # parameters named like host identity are tainted (a
            # helper taking `rank` is still a divergence site)
            for arg in func.args.posonlyargs + func.args.args \
                    + func.args.kwonlyargs:
                if arg.arg in _HOST_KEYS:
                    taint.host.add(arg.arg)
            traced: Set[str] = set()

            def visit(stmt, _taint=taint, _out=out, _func=func):
                if isinstance(stmt, (ast.If, ast.While)):
                    if "host" not in _taint.expr_colors(stmt.test):
                        return
                    ops = ctx.may_collect(stmt)
                    if ops:
                        names = sorted({op for op, _ in ops})
                        _out.append(ctx.finding(
                            stmt, self.id,
                            f"collective {'/'.join(names)} reachable "
                            "under a branch on host identity in "
                            f"{_func.name}(); all hosts must issue the "
                            "same collective sequence (annotate driver "
                            "loops that meet in a broadcast)",
                        ))

            _walk_statements(func.body, taint, traced, ctx.program, visit)
        return out


class TracedCondRule(SpmdRule):
    """A collective under control flow on a DEVICE-VARYING value
    (``lax.axis_index`` derived): each mesh position takes its own
    branch, so a collective inside any branch is entered by some
    devices and not others.  Compute per-rank values with masks
    (``jnp.where``, one-hot psum — see pipeline_loss_fn) and keep
    branch bodies collective-free."""

    id = "spmd-traced-cond"
    description = "collective under device-varying lax.cond/if"

    def check(self, ctx: SpmdContext) -> List[Finding]:
        out = []
        for func in ctx.functions():
            taint = _Taint(ctx.program)
            traced: Set[str] = set()

            def visit(stmt, _taint=taint, _out=out, _func=func):
                # python control flow on a varying value
                if isinstance(stmt, (ast.If, ast.While)):
                    if "varying" in _taint.expr_colors(stmt.test):
                        ops = ctx.may_collect(stmt)
                        if ops:
                            names = sorted({op for op, _ in ops})
                            _out.append(ctx.finding(
                                stmt, self.id,
                                f"collective {'/'.join(names)} under "
                                "control flow on a device-varying value "
                                f"in {_func.name}(); use a mask/where "
                                "instead of a branch",
                            ))
                # lax.cond / lax.switch with a varying predicate and a
                # collective-bearing branch function.  Only simple
                # statements are scanned here — compound bodies reach
                # this visitor statement by statement already.
                simple = isinstance(stmt, (
                    ast.Assign, ast.AnnAssign, ast.AugAssign,
                    ast.Expr, ast.Return,
                ))
                for sub in ast.walk(stmt) if simple else ():
                    if not isinstance(sub, ast.Call):
                        continue
                    if _call_name(sub) not in ("cond", "switch"):
                        continue
                    if not sub.args:
                        continue
                    if "varying" not in _taint.expr_colors(sub.args[0]):
                        continue
                    for branch in sub.args[1:]:
                        ops = self._branch_collectives(ctx, branch)
                        if ops:
                            names = sorted({op for op, _ in ops})
                            _out.append(ctx.finding(
                                sub, self.id,
                                f"lax.cond/switch branch runs collective "
                                f"{'/'.join(names)} under a device-"
                                f"varying predicate in {_func.name}(); "
                                "ranks will take different branches",
                            ))
                            break

            _walk_statements(func.body, taint, traced, ctx.program, visit)
        return out

    @staticmethod
    def _branch_collectives(ctx: SpmdContext, branch: ast.AST):
        if isinstance(branch, ast.Lambda):
            return ctx.may_collect(branch.body)
        if isinstance(branch, ast.Name):
            out = set()
            for summary in ctx.program.resolve(branch.id):
                out |= summary.collectives
            return out
        return ctx.may_collect(branch)


class UnknownAxisRule(SpmdRule):
    """A collective's literal axis name must exist in the tree's mesh
    vocabulary (``Mesh((...), names)`` tuples, ``MeshSpec`` axes,
    ``axis_name=`` parameter defaults).  An axis absent from every
    mesh raises at trace time in the best case — and silently reduces
    over the wrong group if a mesh elsewhere happens to define it."""

    id = "spmd-unknown-axis"
    description = "collective axis name absent from the mesh vocabulary"

    def check(self, ctx: SpmdContext) -> List[Finding]:
        vocab = ctx.program.axis_vocab
        if not vocab:
            return []  # no meshes in scope: nothing to judge against
        out = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node)
            if name not in LAX_COLLECTIVES:
                continue
            for axis in _collective_axes(node):
                if axis in vocab:
                    continue
                out.append(ctx.finding(
                    node, self.id,
                    f"{name} over axis {axis!r}, which no Mesh/MeshSpec/"
                    f"axis default in the tree declares "
                    f"(known: {', '.join(sorted(vocab))})",
                ))
                break
        return out


class UnorderedIterRule(SpmdRule):
    """A collective schedule built by iterating a ``set``/
    ``frozenset`` or ``os.environ``: set iteration order depends on
    per-process hash seeding, so two hosts iterating the "same" set
    can build different permute tables or issue collectives in
    different orders — the textbook silent-divergence bug.  Iterate a
    ``sorted(...)`` copy instead."""

    id = "spmd-unordered-iter"
    description = "collective schedule iterates a set/os.environ"

    @staticmethod
    def _is_unordered(iter_node: ast.AST) -> bool:
        node = iter_node
        # x.keys()/values()/items() — look through to the receiver
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in ("keys", "values", "items"):
            node = node.func.value
        if isinstance(node, ast.Set):
            return True
        if isinstance(node, ast.Call) and _call_name(node) in (
            "set", "frozenset"
        ):
            return True
        if isinstance(node, ast.Attribute) and node.attr == "environ":
            return True
        if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitOr, ast.BitAnd, ast.Sub)
        ):
            # set algebra: a | b, a & b, a - b
            return UnorderedIterRule._is_unordered(node.left) or \
                UnorderedIterRule._is_unordered(node.right)
        return False

    def check(self, ctx: SpmdContext) -> List[Finding]:
        out = []
        for func in ctx.functions():
            # names assigned from comprehensions over unordered iters
            unordered_names: Set[str] = set()
            for node in ast.walk(func):
                if isinstance(node, ast.Assign) and isinstance(
                    node.value, (ast.ListComp, ast.GeneratorExp)
                ):
                    if any(self._is_unordered(gen.iter)
                           for gen in node.value.generators):
                        for t in node.targets:
                            if isinstance(t, ast.Name):
                                unordered_names.add(t.id)
            for node in ast.walk(func):
                # a loop over an unordered iterable containing a
                # collective: per-iteration schedule diverges
                if isinstance(node, ast.For) and \
                        self._is_unordered(node.iter):
                    ops = ctx.may_collect(node)
                    if ops:
                        names = sorted({op for op, _ in ops})
                        out.append(ctx.finding(
                            node, self.id,
                            f"collective {'/'.join(names)} issued while "
                            "iterating an unordered set/env mapping in "
                            f"{func.name}(); iteration order differs "
                            "across hosts — iterate sorted(...)",
                        ))
                # an unordered-built name fed into a collective call
                if isinstance(node, ast.Call) and \
                        _call_name(node) in COLLECTIVE_OPS:
                    args = list(node.args) + [
                        kw.value for kw in node.keywords
                    ]
                    for arg in args:
                        for sub in ast.walk(arg):
                            if isinstance(sub, ast.Name) and \
                                    sub.id in unordered_names:
                                out.append(ctx.finding(
                                    node, self.id,
                                    f"{_call_name(node)} consumes "
                                    f"{sub.id!r}, built from an "
                                    "unordered set — the schedule can "
                                    "differ across hosts",
                                ))
                                break
                        else:
                            continue
                        break
        return out


class PerHostTripCountRule(SpmdRule):
    """A loop executing collectives (or jit/shard_map mesh programs)
    whose trip count derives from a PER-HOST value — a checkpoint
    stamp read from local disk, ``torch.cuda.device_count()`` (or
    ``jax.local_devices()``), the clock, ``get_rank``.  If one host runs
    99 iterations and its neighbor runs 100, the neighbor blocks forever in iteration 100's
    collective.  Agree on the bound first (``process_allgather`` /
    ``broadcast_one_to_all``), then loop."""

    id = "spmd-per-host-trip-count"
    description = "collective loop trip count from a per-host value"

    def check(self, ctx: SpmdContext) -> List[Finding]:
        out = []
        for func in ctx.functions():
            taint = _Taint(ctx.program)
            traced: Set[str] = set()

            def visit(stmt, _taint=taint, _traced=traced, _out=out,
                      _func=func):
                bound: Optional[ast.AST] = None
                if isinstance(stmt, ast.For):
                    bound = stmt.iter
                elif isinstance(stmt, ast.While):
                    bound = stmt.test
                if bound is None:
                    return
                if "perhost" not in _taint.expr_colors(bound):
                    return
                if ctx.may_run_mesh_program(stmt, _traced):
                    _out.append(ctx.finding(
                        stmt, self.id,
                        f"loop in {_func.name}() executes collectives "
                        "but its trip count derives from a per-host "
                        "value; hosts that disagree on the bound "
                        "deadlock — agree via process_allgather/"
                        "broadcast first",
                    ))

            _walk_statements(func.body, taint, traced, ctx.program, visit)
        return out


def all_spmd_rules() -> List[SpmdRule]:
    return [
        HostBranchRule(),
        TracedCondRule(),
        UnknownAxisRule(),
        UnorderedIterRule(),
        PerHostTripCountRule(),
    ]


def spmd_rule_catalog() -> str:
    blocks = []
    for rule in all_spmd_rules():
        doc = " ".join((rule.__doc__ or "").split())
        blocks.append(f"{rule.id}: {rule.description}\n    {doc}")
    return "\n\n".join(blocks)


# -- driver -----------------------------------------------------------------


def _collect_files(root: str,
                   subdirs: Sequence[str]) -> List[Tuple[str, str, str]]:
    out = []
    for sub in subdirs:
        top = os.path.join(root, sub)
        if not os.path.isdir(top):
            continue
        for dirpath, dirs, files in os.walk(top):
            dirs[:] = sorted(d for d in dirs if d != "__pycache__")
            for name in sorted(files):
                if not name.endswith(".py"):
                    continue
                path = os.path.join(dirpath, name)
                with open(path, "r", encoding="utf-8") as f:
                    source = f.read()
                rel = os.path.relpath(path, root).replace(os.sep, "/")
                out.append((path, rel, source))
    return out


def analyze_paths(files: Sequence[Tuple[str, str, str]],
                  rules: Optional[Sequence[SpmdRule]] = None) -> LintResult:
    """Run spmdcheck over pre-read (path, rel, source) triples."""
    program = build_summary(files)
    active = list(rules) if rules is not None else all_spmd_rules()
    result = LintResult()
    for _, rel, source in files:
        try:
            tree = ast.parse(source)
        except SyntaxError:
            continue
        result.files_checked += 1
        ctx = SpmdContext(rel, tree, program)
        suppressions = Suppressions(source.splitlines())
        for rule in active:
            for finding in rule.check(ctx):
                if suppressions.covers(finding):
                    result.suppressed.append(finding)
                else:
                    result.findings.append(finding)
    result.findings.sort(key=lambda f: (f.file, f.line, f.rule))
    return result


def analyze_tree(root: str,
                 subdirs: Sequence[str] = SPMD_SUBDIRS) -> LintResult:
    """Run spmdcheck over the SPMD-relevant subtrees of ``root``."""
    return analyze_paths(_collect_files(root, subdirs))

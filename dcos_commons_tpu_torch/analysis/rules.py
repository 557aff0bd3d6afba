# sdklint: disable-file=no-gpus-resource — the rule definitions below
# necessarily name the banned token to detect it
"""The sdklint rule catalog (port of ``dcos_commons_tpu/analysis/rules.py``:
the same eleven rules, each path scope moved to ``dcos_commons_tpu_torch/``).

Each rule is a class with an ``id`` (the suppression token), a
docstring (rendered by ``--catalog``), ``applies_to`` (path scoping)
and ``check`` (AST pass -> findings).  Rules encode invariants this
codebase actually relies on — the PR-1 offer-cycle fast path's
generation stamps and event-driven loop, the BASELINE resource
vocabulary, and the lock discipline the runtime's 20+ ``_lock``
owners promise — not generic style nits (those live in the build
gate, tests/test_build_gate.py).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Set, Tuple

from dcos_commons_tpu_torch.analysis.linter import Finding, LintContext

_MUTATOR_METHODS = {
    "append", "add", "extend", "insert", "pop", "popitem", "clear",
    "update", "setdefault", "discard", "remove", "appendleft",
}


def _self_attr_writes(node: ast.AST) -> Iterator[Tuple[str, ast.AST]]:
    """Yield (attr_name, node) for every write/mutation of a ``self``
    attribute inside ``node``: plain/aug/ann assignment, subscript
    stores and deletes (``self.x[k] = v``), and calls to mutating
    container methods (``self.x.pop(...)``)."""
    for sub in ast.walk(node):
        targets: List[ast.AST] = []
        if isinstance(sub, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            # copy: the tuple-unpacking expansion below appends to this
            # list, which must never mutate the AST node itself
            targets = (
                list(sub.targets) if isinstance(sub, ast.Assign)
                else [sub.target]
            )
        elif isinstance(sub, ast.Delete):
            targets = list(sub.targets)
        for target in targets:
            if isinstance(target, ast.Tuple):
                targets.extend(target.elts)
                continue
            base = target
            if isinstance(base, ast.Subscript):
                base = base.value
            if (
                isinstance(base, ast.Attribute)
                and isinstance(base.value, ast.Name)
                and base.value.id == "self"
            ):
                yield base.attr, sub
        if (
            isinstance(sub, ast.Call)
            and isinstance(sub.func, ast.Attribute)
            and sub.func.attr in _MUTATOR_METHODS
        ):
            owner = sub.func.value
            if (
                isinstance(owner, ast.Attribute)
                and isinstance(owner.value, ast.Name)
                and owner.value.id == "self"
            ):
                yield owner.attr, sub


def _is_self_attr(node: ast.AST, names: Set[str]) -> bool:
    return (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
        and node.attr in names
    )


# the package's subtrees that the package-wide rules skip: the tick
# harnesses, and the workers, which the reference keeps outside its
# package (top-level ``frameworks/``) and so outside these rules
_UNSCOPED = (
    "dcos_commons_tpu_torch/testing/",
    "dcos_commons_tpu_torch/frameworks/",
)


class Rule:
    id = ""
    description = ""

    def applies_to(self, ctx: LintContext) -> bool:
        return ctx.tree is not None

    def check(self, ctx: LintContext) -> List[Finding]:
        raise NotImplementedError


class NoBlockingSleepRule(Rule):
    """``time.sleep`` in library code busy-waits what the event-driven
    scheduler loop already signals: status arrival and HTTP mutations
    ``nudge()`` the loop awake (scheduler/scheduler.py:232), so hot
    paths must park on ``Event.wait``/``Condition.wait`` instead of
    sleeping.  Scope: all of ``dcos_commons_tpu_torch/`` except
    ``testing/`` (tick harnesses legitimately pace fake time) and
    ``frameworks/`` (the task workers, which run outside the scheduler
    loop, as the reference's top-level ``frameworks/`` workers lie
    outside its scope).  Polling a resource
    no event covers (e.g. a foreign pid you cannot ``wait()`` on)
    belongs under an explaining ``# sdklint: disable``."""

    id = "no-blocking-sleep"
    description = "time.sleep in scheduler/plan/offer hot paths"

    def applies_to(self, ctx: LintContext) -> bool:
        return (
            ctx.tree is not None
            and ctx.rel.startswith("dcos_commons_tpu_torch/")
            and not ctx.rel.startswith(_UNSCOPED)
        )

    def check(self, ctx: LintContext) -> List[Finding]:
        out = []
        sleep_aliases = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ImportFrom) and node.module == "time":
                sleep_aliases |= {
                    a.asname or a.name for a in node.names if a.name == "sleep"
                }
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            hit = (
                isinstance(func, ast.Attribute)
                and func.attr == "sleep"
                and isinstance(func.value, ast.Name)
                and func.value.id in ("time", "_time")
            ) or (
                isinstance(func, ast.Name) and func.id in sleep_aliases
            )
            if hit:
                out.append(ctx.finding(
                    node, self.id,
                    "time.sleep blocks the event-driven loop; wake on "
                    "nudge()/Event.wait (or document why polling is "
                    "correct here)",
                ))
        return out


class LedgerMutationRule(Rule):
    """``SliceInventory``'s per-view snapshot caches, inverted field
    indexes, and free-chip buckets are all synced off the generation
    counters (``ReservationLedger._generation`` / per-host journal,
    ``SliceInventory._topology_gen``), so host state may only change
    through methods that bump the generation counter — a mutation
    that skips the bump serves stale offers AND stale placement
    candidates forever (an index that silently diverges from the
    ledger mis-routes every future placement).  Two checks: public
    methods of the two classes that mutate tracked host state must
    write the generation attribute in the same method, and no code
    anywhere may write the cache/index internals through a
    non-``self`` receiver — index maintenance goes through the
    generation-bumping mutators, full stop."""

    id = "ledger-mutation"
    description = "ledger/inventory host state mutated without a generation bump"

    _TRACKED = {
        "ReservationLedger": (
            {"_cache", "_by_host", "_by_task", "_host_gen"}, "_generation",
        ),
        "SliceInventory": (
            {"_hosts", "_down", "_preempted", "_maintenance",
             "_host_topo_gen"}, "_topology_gen",
        ),
    }
    # every tracked attr plus the generation counters and the snapshot
    # cache / index structures: writable through `self` inside the
    # owning class only
    _INTERNALS = (
        {attr for attrs, _ in _TRACKED.values() for attr in attrs}
        | {gen for _, gen in _TRACKED.values()}
        | {
            "_view_caches", "_field_indexes", "_ordinal_cache",
            "_up_ids_cache", "_hosts_by_id",
            # scan-order state (health plane's suspect demotion): an
            # external write would desync ordinals from the per-view
            # ordered lists and break indexed-vs-full-scan equivalence
            "_suspect", "_suspect_sources", "_order_gen",
            "_scan_cache", "_scan_cache_gen",
        }
    )

    def check(self, ctx: LintContext) -> List[Finding]:
        out = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef) and node.name in self._TRACKED:
                out += self._check_class(ctx, node)
        out += self._check_reach_in(ctx)
        return out

    def _check_class(self, ctx, cls) -> List[Finding]:
        tracked, gen_attr = self._TRACKED[cls.name]
        out = []
        for method in cls.body:
            if not isinstance(method, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if method.name.startswith("_"):
                # underscore helpers (_index/_unindex/_load/__init__)
                # run under a bumping public caller; the public surface
                # is where the discipline is enforced
                continue
            touched = [
                (attr, sub) for attr, sub in _self_attr_writes(method)
                if attr in tracked
            ]
            if not touched:
                continue
            bumps = any(
                attr == gen_attr for attr, _ in _self_attr_writes(method)
            )
            if not bumps:
                for attr, sub in touched:
                    out.append(ctx.finding(
                        sub, self.id,
                        f"{cls.name}.{method.name} mutates self.{attr} "
                        f"without bumping self.{gen_attr}: snapshot "
                        "caches keyed on the generation go stale",
                    ))
        return out

    def _check_reach_in(self, ctx) -> List[Finding]:
        out = []
        for node in ast.walk(ctx.tree):
            for attr, sub in self._external_writes(node):
                out.append(ctx.finding(
                    sub, self.id,
                    f"external write to ledger/inventory internal "
                    f".{attr}: go through the generation-bumping API",
                ))
        return out

    def _external_writes(self, node) -> Iterator[Tuple[str, ast.AST]]:
        targets: List[ast.AST] = []
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (
                node.targets if isinstance(node, ast.Assign) else [node.target]
            )
        for target in targets:
            base = target
            # unwrap nested subscripts: index maintenance writes like
            # inv._field_indexes['zone']['z'] = ... are still writes
            # to the internal
            while isinstance(base, ast.Subscript):
                base = base.value
            if (
                isinstance(base, ast.Attribute)
                and base.attr in self._INTERNALS
                and not (
                    isinstance(base.value, ast.Name)
                    and base.value.id == "self"
                )
            ):
                yield base.attr, node
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _MUTATOR_METHODS
        ):
            owner = node.func.value
            if (
                isinstance(owner, ast.Attribute)
                and owner.attr in self._INTERNALS
                and not (
                    isinstance(owner.value, ast.Name)
                    and owner.value.id == "self"
                )
            ):
                yield owner.attr, node


class LockDisciplineRule(Rule):
    """A class that creates a ``threading.Lock``/``RLock``/``Condition``
    in ``__init__`` promises its shared mutable state is written under
    that lock.  The guarded set is inferred: any ``self`` attribute
    written inside a ``with self.<lock>:`` block (outside ``__init__``)
    is shared state, and every other write to it must also hold the
    lock.  Methods named ``*_locked`` declare "caller holds the lock"
    (the runtime/runner.py convention) and count as guarded.  Reads
    stay un-flagged (lock-free reads of snapshots are a deliberate
    idiom here); a genuinely single-threaded write path carries an
    explaining ``# sdklint: disable``."""

    id = "lock-discipline"
    description = "guarded attribute written outside `with self._lock`"

    def check(self, ctx: LintContext) -> List[Finding]:
        out = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef):
                out += self._check_class(ctx, node)
        return out

    @staticmethod
    def _lock_attrs(cls: ast.ClassDef) -> Set[str]:
        """Names of self attrs assigned a threading lock in __init__."""
        locks: Set[str] = set()
        for method in cls.body:
            if not isinstance(method, ast.FunctionDef) or \
                    method.name != "__init__":
                continue
            for sub in ast.walk(method):
                if not isinstance(sub, ast.Assign):
                    continue
                value = sub.value
                if not (
                    isinstance(value, ast.Call)
                    and isinstance(value.func, ast.Attribute)
                    and value.func.attr in ("Lock", "RLock", "Condition")
                    and isinstance(value.func.value, ast.Name)
                    and value.func.value.id == "threading"
                ):
                    continue
                for target in sub.targets:
                    if isinstance(target, ast.Attribute) and \
                            isinstance(target.value, ast.Name) and \
                            target.value.id == "self":
                        locks.add(target.attr)
        return locks

    def _method_writes(
        self, method: ast.AST, lock_attrs: Set[str]
    ) -> List[Tuple[str, ast.AST, bool]]:
        """(attr, node, under_lock) for every self-attr write, walking
        the statement tree with a with-lock depth counter."""
        writes: List[Tuple[str, ast.AST, bool]] = []

        def visit(node: ast.AST, held: bool) -> None:
            if isinstance(node, ast.With):
                holds = held or any(
                    _is_self_attr(item.context_expr, lock_attrs)
                    for item in node.items
                )
                for child in node.body:
                    visit(child, holds)
                return
            for attr, sub in _direct_writes(node):
                writes.append((attr, sub, held))
            for child in ast.iter_child_nodes(node):
                # excepthandler is not an ast.stmt but carries a
                # statement body — error-recovery paths are exactly
                # where forgotten locking hides
                if isinstance(child, (ast.stmt, ast.excepthandler)):
                    visit(child, held)

        def _direct_writes(node):
            """Writes attributable to THIS statement (not recursing
            into compound bodies, which visit() handles)."""
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign,
                                 ast.Delete, ast.Expr)):
                yield from _self_attr_writes(node)

        for stmt in method.body:
            visit(stmt, False)
        return writes

    def _check_class(self, ctx, cls) -> List[Finding]:
        lock_attrs = self._lock_attrs(cls)
        if not lock_attrs:
            return []
        per_method: Dict[str, List[Tuple[str, ast.AST, bool]]] = {}
        for method in cls.body:
            if not isinstance(method, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    or method.name == "__init__":
                continue
            writes = self._method_writes(method, lock_attrs)
            if method.name.endswith("_locked"):
                writes = [(attr, node, True) for attr, node, _ in writes]
            per_method[method.name] = writes
        guarded: Set[str] = {
            attr
            for writes in per_method.values()
            for attr, _, held in writes
            if held
        } - lock_attrs
        out = []
        for name, writes in per_method.items():
            for attr, node, held in writes:
                if attr in guarded and not held:
                    out.append(ctx.finding(
                        node, self.id,
                        f"{cls.name}.{name} writes self.{attr} outside "
                        f"`with self.{sorted(lock_attrs)[0]}` but other "
                        "methods guard it — racy write",
                    ))
        return out


class NoGpusVocabularyRule(Rule):
    """BASELINE invariant: the resource model has no ``gpus`` scalar —
    accelerators are the pod-level ``gpu:`` block
    (specification/specs.py:11).  Any identifier, dict key, or exact
    string ``"gpus"`` reintroduces the vocabulary this rebuild
    deliberately removed (prose in docstrings is fine)."""

    id = "no-gpus-resource"
    description = "`gpus` resource vocabulary (BASELINE bans it)"

    def check(self, ctx: LintContext) -> List[Finding]:
        out = []
        for node in ast.walk(ctx.tree):
            hit = None
            if isinstance(node, ast.Name) and node.id == "gpus":
                hit = "identifier"
            elif isinstance(node, ast.Attribute) and node.attr == "gpus":
                hit = "attribute"
            elif isinstance(node, ast.arg) and node.arg == "gpus":
                hit = "argument"
            elif isinstance(node, ast.keyword) and node.arg == "gpus":
                hit = "keyword"
            elif isinstance(node, ast.Constant) and node.value == "gpus":
                hit = "string"
            if hit is not None:
                out.append(ctx.finding(
                    node, self.id,
                    f"{hit} 'gpus': accelerators are the pod-level "
                    "gpu: block, not a gpus scalar",
                ))
        return out


class SwallowedExceptionRule(Rule):
    """``except Exception: pass`` hides the stack trace the on-call
    engineer needed.  A broad handler must do *something* — log,
    count, return a fallback, or re-raise; a handler whose body is
    only ``pass``/``continue`` is flagged.  Where drop-and-continue
    is genuinely correct (a broken listener must not break intake),
    say so next to a ``# sdklint: disable``."""

    id = "swallowed-exception"
    description = "except Exception/bare except with a pass-only body"

    _BROAD = ("Exception", "BaseException")

    def _is_broad(self, type_node) -> bool:
        if type_node is None:
            return True
        if isinstance(type_node, ast.Name):
            return type_node.id in self._BROAD
        if isinstance(type_node, ast.Attribute):
            return type_node.attr in self._BROAD
        if isinstance(type_node, ast.Tuple):
            return any(self._is_broad(e) for e in type_node.elts)
        return False

    def check(self, ctx: LintContext) -> List[Finding]:
        out = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not self._is_broad(node.type):
                continue
            swallows = all(
                isinstance(stmt, (ast.Pass, ast.Continue)) or (
                    isinstance(stmt, ast.Expr)
                    and isinstance(stmt.value, ast.Constant)
                )
                for stmt in node.body
            )
            if swallows:
                out.append(ctx.finding(
                    node, self.id,
                    "broad except with a pass-only body swallows the "
                    "error; log it, narrow the type, or re-raise",
                ))
        return out


class TracerUnsafeCastRule(Rule):
    """Inside a ``jit``/``shard_map``/``pmap``-decorated function the
    arguments are tracers; ``float()``/``int()``/``bool()`` and
    ``np.asarray``/``np.array`` force host materialization and raise
    ``TracerConversionError`` at trace time — or worse, silently
    constant-fold a value that should have stayed symbolic.  Use
    ``jnp`` ops and let values stay on device.  The port has no traced
    decorator (no ``torch.compile``, no ``torch.jit.script``), so here
    the rule guards only against one coming in under these names."""

    id = "jit-tracer-cast"
    description = "host-side cast (float/int/np.asarray) under jit/shard_map"

    _DECORATOR_NAMES = {"jit", "shard_map", "pmap"}
    _CAST_NAMES = {"float", "int", "bool"}
    _NP_MODULES = {"np", "numpy", "onp"}
    _NP_FUNCS = {"asarray", "array"}

    def _is_traced_decorator(self, decorator: ast.AST) -> bool:
        for sub in ast.walk(decorator):
            if isinstance(sub, ast.Name) and sub.id in self._DECORATOR_NAMES:
                return True
            if isinstance(sub, ast.Attribute) and \
                    sub.attr in self._DECORATOR_NAMES:
                return True
        return False

    def check(self, ctx: LintContext) -> List[Finding]:
        out = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if not any(
                self._is_traced_decorator(d) for d in node.decorator_list
            ):
                continue
            for sub in ast.walk(node):
                if not isinstance(sub, ast.Call):
                    continue
                func = sub.func
                bad = None
                if isinstance(func, ast.Name) and \
                        func.id in self._CAST_NAMES and sub.args:
                    bad = f"{func.id}()"
                elif (
                    isinstance(func, ast.Attribute)
                    and func.attr in self._NP_FUNCS
                    and isinstance(func.value, ast.Name)
                    and func.value.id in self._NP_MODULES
                ):
                    bad = f"{func.value.id}.{func.attr}()"
                if bad:
                    out.append(ctx.finding(
                        sub, self.id,
                        f"{bad} inside jit/shard_map-traced "
                        f"{node.name}() materializes a tracer on host; "
                        "keep it in jnp",
                    ))
        return out


class SpanLeakRule(Rule):
    """A ``.span(...)`` call on a trace recorder returns a LIVE span:
    it enters the flight recorder only when closed, and its children
    reference its id — a leaked span silently drops a region of the
    timeline and leaves orphan children.  Every ``<tracer>.span(...)``
    result must therefore be closed on all paths: used directly as a
    ``with`` context, or bound to a name that is ``end()``-ed (or
    returned/yielded — ownership moves to the caller).  A bare
    expression statement discards the span and always leaks.
    ``event()`` closes itself and is exempt.  Receivers are recognized
    by name (``trace``/``tracer``/``recorder`` variants), so the rule
    follows the subsystem's own naming convention."""

    id = "span-leak"
    description = "trace span not closed via `with` or end()"

    _RECEIVERS = {
        "trace", "tracer", "_tracer", "recorder", "_recorder",
        "NULL_TRACER",
    }

    def _is_span_call(self, node: ast.AST) -> bool:
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "span"):
            return False
        owner = node.func.value
        name = None
        if isinstance(owner, ast.Name):
            name = owner.id
        elif isinstance(owner, ast.Attribute):
            name = owner.attr
        return name in self._RECEIVERS

    @staticmethod
    def _iter_scope(node: ast.AST) -> Iterator[ast.AST]:
        """Walk a function (or module) body without descending into
        nested function scopes — each scope is analyzed once, against
        its own end()/return statements."""
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            yield child
            yield from SpanLeakRule._iter_scope(child)

    def check(self, ctx: LintContext) -> List[Finding]:
        out: List[Finding] = []
        scopes: List[ast.AST] = [ctx.tree] + [
            n for n in ast.walk(ctx.tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]
        for scope in scopes:
            out += self._check_scope(ctx, scope)
        return out

    def _check_scope(self, ctx: LintContext, scope: ast.AST) -> List[Finding]:
        nodes = list(self._iter_scope(scope))
        # span calls that are a `with` context expression are closed
        with_exprs = {
            id(item.context_expr)
            for node in nodes if isinstance(node, ast.With)
            for item in node.items
        }
        # names with a .end() call, returned, or yielded in this scope
        closed_names: Set[str] = set()
        for node in nodes:
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "end"
                    and isinstance(node.func.value, ast.Name)):
                closed_names.add(node.func.value.id)
            if isinstance(node, (ast.Return, ast.Yield)) and \
                    isinstance(node.value, ast.Name):
                closed_names.add(node.value.id)
            if isinstance(node, ast.With):
                # `s = tracer.span(...)` later entered as `with s:`
                for item in node.items:
                    if isinstance(item.context_expr, ast.Name):
                        closed_names.add(item.context_expr.id)
        out: List[Finding] = []
        for node in nodes:
            # bare `tracer.span(...)` statement: discarded, never closed
            if isinstance(node, ast.Expr) and self._is_span_call(node.value):
                out.append(ctx.finding(
                    node, self.id,
                    "span discarded unclosed; use `with ....span(...)` "
                    "(or .event() for instantaneous records)",
                ))
                continue
            if not isinstance(node, ast.Assign) or \
                    not self._is_span_call(node.value):
                continue
            if id(node.value) in with_exprs:
                continue
            targets = [
                t.id for t in node.targets if isinstance(t, ast.Name)
            ]
            if targets and not any(t in closed_names for t in targets):
                out.append(ctx.finding(
                    node, self.id,
                    f"span bound to {targets[0]!r} is never end()-ed "
                    "on this scope's paths; close it with `with` or an "
                    "explicit end()",
                ))
        return out


class LeaseGatedMutationRule(Rule):
    """HA invariant (dcos_commons_tpu_torch/ha/): in scheduler-path modules,
    every persisted mutation must flow through a store class
    (StateStore/ConfigStore/ReservationLedger/OptionsStore/...) —
    store objects are constructed over the wired persister, which in
    HA mode is the lease-fenced writer, so a raw
    ``persister.set/apply/recursive_delete`` in scheduler logic is a
    write that could bypass the failover fence (and definitely
    bypasses the one place the layering is auditable).  Scope: the
    scheduler-path packages below; store/fence modules themselves
    (state/, storage/, multi/store.py, ha/election.py) and testing/
    are exempt.  A deliberate raw write carries an explaining
    ``# sdklint: disable``.

    Division of labor with durcheck's ``dur-unfenced-write``: this
    rule owns DIRECT raw mutations inside ``_SCOPED`` (single-file,
    cheap, runs on every lint); durcheck owns raw mutations OUTSIDE
    the scope that are nevertheless reachable from scheduler-path
    code over the interprocedural call graph — durcheck skips every
    site in ``_SCOPED``, so one site is never double-reported."""

    id = "lease-gated-mutation"
    description = "raw persister mutation in a scheduler path (bypasses the lease-fenced store layer)"

    _MUTATIONS = {"set", "apply", "recursive_delete", "clear_all_data"}
    _SCOPED = (
        "dcos_commons_tpu_torch/scheduler/",
        "dcos_commons_tpu_torch/runtime/",
        "dcos_commons_tpu_torch/recovery/",
        "dcos_commons_tpu_torch/plan/",
        "dcos_commons_tpu_torch/http/",
        "dcos_commons_tpu_torch/multi/",
        "dcos_commons_tpu_torch/decommission/",
        "dcos_commons_tpu_torch/uninstall/",
        "dcos_commons_tpu_torch/ha/",
    )
    _EXEMPT = (
        # store classes: the layer raw mutations BELONG in
        "dcos_commons_tpu_torch/multi/store.py",
        # the fence itself: lease-record writes run below the fence
        "dcos_commons_tpu_torch/ha/election.py",
    )

    def applies_to(self, ctx: LintContext) -> bool:
        return (
            ctx.tree is not None
            and any(ctx.rel.startswith(p) for p in self._SCOPED)
            and ctx.rel not in self._EXEMPT
        )

    @staticmethod
    def _receiver_name(node: ast.AST):
        if isinstance(node, ast.Name):
            return node.id
        if isinstance(node, ast.Attribute):
            return node.attr
        return None

    def check(self, ctx: LintContext) -> List[Finding]:
        out = []
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in self._MUTATIONS):
                continue
            name = self._receiver_name(node.func.value)
            if name is None:
                continue
            lowered = name.lower()
            if "persister" not in lowered and "backend" not in lowered:
                continue
            out.append(ctx.finding(
                node, self.id,
                f"raw {name}.{node.func.attr}(...) in a scheduler "
                "path: route the mutation through a store class so it "
                "flows through the (lease-fenced) wired persister",
            ))
        return out


class MetricCardinalityRule(Rule):
    """Metric names built from unbounded runtime values (task ids,
    request ids, host ids interpolated into ``Metrics.incr``/
    ``gauge``/``time`` names) grow the registry — and every
    Prometheus scrape, snapshot, and history ring — without bound:
    ten thousand relaunches mint ten thousand immortal series.
    Dynamic name parts must be BOUNDED vocabularies (enum ``.value``,
    a literal loop), registered in ``METRIC_CARDINALITY_ALLOWLIST``
    (for prefixes whose id-space is bounded elsewhere, with the bound
    stated), or carry an explaining ``# sdklint: disable``.  The
    check flags f-string/%%/.format()/concat name arguments whose
    interpolated expression terminates in an id-shaped identifier
    (``*_id``, ``task_id``, ``request_id``, ``pid``, ``task_name``,
    ...)."""

    id = "metric-cardinality"
    description = "metric name built from an unbounded runtime id"

    _METHODS = {"incr", "gauge", "time"}
    _ID_SHAPED = {
        "pid", "tid", "uuid", "task_name", "task", "request",
        "hostname",
    }

    def applies_to(self, ctx: LintContext) -> bool:
        return (
            ctx.tree is not None
            and ctx.rel.startswith("dcos_commons_tpu_torch/")
            and not ctx.rel.startswith(_UNSCOPED)
        )

    @classmethod
    def _is_id_shaped(cls, name: str) -> bool:
        lowered = name.lower().lstrip("_")
        return (
            lowered in cls._ID_SHAPED
            or lowered.endswith("_id")
            or lowered == "id"
            or lowered.endswith("_uuid")
        )

    @classmethod
    def _terminal_name(cls, node: ast.AST):
        """The identifier a dynamic expression terminates in:
        ``pid`` for ``pid``, ``task_id`` for ``status.task_id``,
        ``task_id`` for ``info.task_id.upper()``."""
        if isinstance(node, ast.Name):
            return node.id
        if isinstance(node, ast.Attribute):
            return node.attr
        if isinstance(node, ast.Call):
            return cls._terminal_name(node.func.value) if isinstance(
                node.func, ast.Attribute
            ) else None
        if isinstance(node, ast.FormattedValue):
            return cls._terminal_name(node.value)
        return None

    def _dynamic_parts(self, arg: ast.AST):
        """Yield the non-literal sub-expressions of a metric-name
        argument, however it was concatenated."""
        if isinstance(arg, ast.JoinedStr):
            for part in arg.values:
                if isinstance(part, ast.FormattedValue):
                    yield part.value
        elif isinstance(arg, ast.BinOp) and isinstance(
            arg.op, (ast.Add, ast.Mod)
        ):
            for side in (arg.left, arg.right):
                if isinstance(side, ast.Tuple):
                    for elt in side.elts:
                        if not isinstance(elt, ast.Constant):
                            yield elt
                elif isinstance(side, (ast.BinOp, ast.JoinedStr)):
                    yield from self._dynamic_parts(side)
                elif not isinstance(side, ast.Constant):
                    yield side
        elif isinstance(arg, ast.Call) and isinstance(
            arg.func, ast.Attribute
        ) and arg.func.attr == "format":
            yield from arg.args
            yield from (kw.value for kw in arg.keywords)

    @staticmethod
    def _literal_prefix(arg: ast.AST) -> str:
        if isinstance(arg, ast.JoinedStr) and arg.values and isinstance(
            arg.values[0], ast.Constant
        ):
            return str(arg.values[0].value)
        if isinstance(arg, ast.BinOp) and isinstance(
            arg.left, ast.Constant
        ):
            return str(arg.left.value)
        return ""

    def check(self, ctx: LintContext) -> List[Finding]:
        out = []
        for node in ast.walk(ctx.tree):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in self._METHODS
                and node.args
            ):
                continue
            receiver = node.func.value
            receiver_name = (
                receiver.id if isinstance(receiver, ast.Name)
                else receiver.attr if isinstance(receiver, ast.Attribute)
                else ""
            )
            if "metric" not in receiver_name.lower() and \
                    receiver_name.lower() != "registry":
                continue
            name_arg = node.args[0]
            prefix = self._literal_prefix(name_arg)
            if any(
                prefix.startswith(allowed)
                for allowed in METRIC_CARDINALITY_ALLOWLIST
            ):
                continue
            for part in self._dynamic_parts(name_arg):
                terminal = self._terminal_name(part)
                if terminal is not None and self._is_id_shaped(terminal):
                    out.append(ctx.finding(
                        node, self.id,
                        f"metric name interpolates {terminal!r} (an "
                        "unbounded runtime id): every distinct value "
                        "mints an immortal series in the registry, "
                        "scrape, and history ring — key by a bounded "
                        "vocabulary, register the prefix in "
                        "METRIC_CARDINALITY_ALLOWLIST with its bound, "
                        "or suppress with the bound stated",
                    ))
                    break
        return out


class RouterStatsStalenessRule(Rule):
    """Router invariant: every pod gauge the router acts
    on must cross the staleness gate — ``router/telemetry.py`` parses
    raw ``GET /stats`` dicts exactly once into ``PodTelemetry`` and
    answers load questions through freshness-aware accessors, so a
    wedged pod's last-good numbers can never steer placement.  Any
    OTHER router module subscripting or ``.get()``-ing a stats-named
    dict is reaching around the gate: flagged.  Scope:
    ``dcos_commons_tpu_torch/router/`` except the telemetry module itself.
    A genuinely gauge-free read (router's own snapshot assembly)
    carries an explaining ``# sdklint: disable``."""

    id = "router-stats-staleness"
    description = "router code reads a raw stats dict outside the telemetry staleness gate"

    _GATE_MODULE = "dcos_commons_tpu_torch/router/telemetry.py"

    def applies_to(self, ctx: LintContext) -> bool:
        return (
            ctx.tree is not None
            and ctx.rel.startswith("dcos_commons_tpu_torch/router/")
            and ctx.rel != self._GATE_MODULE
        )

    @staticmethod
    def _terminal_name(node: ast.AST):
        if isinstance(node, ast.Name):
            return node.id
        if isinstance(node, ast.Attribute):
            return node.attr
        return None

    @classmethod
    def _is_stats_named(cls, node: ast.AST) -> bool:
        name = cls._terminal_name(node)
        return name is not None and "stats" in name.lower()

    def check(self, ctx: LintContext) -> List[Finding]:
        out = []
        for node in ast.walk(ctx.tree):
            hit = None
            if isinstance(node, ast.Subscript) and \
                    self._is_stats_named(node.value):
                hit = f"{self._terminal_name(node.value)}[...]"
            elif (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "get"
                and self._is_stats_named(node.func.value)
            ):
                hit = f"{self._terminal_name(node.func.value)}.get(...)"
            if hit is not None:
                out.append(ctx.finding(
                    node, self.id,
                    f"raw stats access {hit}: parse pod gauges in "
                    "router/telemetry.py (PodTelemetry.observe) and "
                    "read them through its staleness-gated accessors "
                    "— a wedged pod's last-good numbers must not "
                    "steer placement",
                ))
        return out


# metric-name prefixes whose dynamic part is bounded by something
# other than the interpolated identifier's type — each entry states
# the bound, which is the contract a reviewer checks when one is
# added.  (Deliberately empty at ship: the one in-tree dynamic-id
# metric, ha.replication.lag.<puller>, carries an inline suppression
# with its bound instead, keeping the waiver next to the code.)
METRIC_CARDINALITY_ALLOWLIST: tuple = ()


class HealthActionPurityRule(Rule):
    """The health plane's layering invariant: it DECIDES, and
    only the plan engine and journaled scheduler verbs ACT.  Code in
    ``dcos_commons_tpu_torch/health/`` (detectors, the action governor)
    must not mutate the ledger, state store, or persister directly —
    a detector that writes state bypasses the audit trail, the
    operator's plan-verb interrupt surface, and the failover
    re-synthesis contract all at once.  Mutations belong in
    factory-built plan steps (decommission/factory.py,
    plan/builders.py) or scheduler verbs (``set_pod_count``,
    ``restart_pod``).  ``journal.py`` is exempt: the journal IS the
    audit surface and owns its own persistence backend.  A deliberate
    exception carries an explaining ``# sdklint: disable``."""

    id = "health-plan-only"
    description = (
        "health-plane code mutating ledger/state-store directly "
        "(actions must ride the plan/verb surface)"
    )

    _SCOPED = ("dcos_commons_tpu_torch/health/",)
    _EXEMPT = ("dcos_commons_tpu_torch/health/journal.py",)
    _MUTATIONS = {
        # ledger
        "commit", "release",
        # state store
        "store_tasks", "store_status", "store_property", "clear_task",
        "store_goal_override", "set_target_config", "clear_all_data",
        # raw persister
        "set", "apply", "recursive_delete", "wipe_namespace",
        # launch WAL
        "record",
    }

    def applies_to(self, ctx: LintContext) -> bool:
        return (
            ctx.tree is not None
            and any(ctx.rel.startswith(p) for p in self._SCOPED)
            and ctx.rel not in self._EXEMPT
        )

    @staticmethod
    def _receiver_name(node: ast.AST):
        if isinstance(node, ast.Name):
            return node.id
        if isinstance(node, ast.Attribute):
            return node.attr
        return None

    def check(self, ctx: LintContext) -> List[Finding]:
        out = []
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in self._MUTATIONS):
                continue
            name = self._receiver_name(node.func.value)
            if name is None:
                continue
            lowered = name.lower()
            if not (
                "ledger" in lowered
                or "persister" in lowered
                or "recorder" in lowered
                or lowered == "store"
                or lowered.endswith("_store")
            ):
                continue
            out.append(ctx.finding(
                node, self.id,
                f"{name}.{node.func.attr}(...) mutates system state "
                "from the health plane: route the action through a "
                "plan step (decommission/plan factories) or a "
                "journaled scheduler verb so it stays audited and "
                "operator-interruptible",
            ))
        return out


def all_rules() -> List[Rule]:
    return [
        NoBlockingSleepRule(),
        LedgerMutationRule(),
        LockDisciplineRule(),
        NoGpusVocabularyRule(),
        SwallowedExceptionRule(),
        TracerUnsafeCastRule(),
        SpanLeakRule(),
        LeaseGatedMutationRule(),
        MetricCardinalityRule(),
        RouterStatsStalenessRule(),
        HealthActionPurityRule(),
    ]


def rule_catalog() -> str:
    """Human-readable rule list for ``--catalog`` and the docs."""
    blocks = []
    for rule in all_rules():
        doc = " ".join((rule.__doc__ or "").split())
        blocks.append(f"{rule.id}: {rule.description}\n    {doc}")
    return "\n\n".join(blocks)

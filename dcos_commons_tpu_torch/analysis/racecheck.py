"""racecheck: thread-ownership static analysis + happens-before race
detection — the concurrency half of the analysis suite (port of
``dcos_commons_tpu/analysis/racecheck.py``: the static pass and the
vector clocks unchanged, the scope moved to ``dcos_commons_tpu_torch/``,
the collective vocabulary widened to ``torch.distributed`` and the
port's mesh wrappers, and ``install()`` made safe beside the JAX
package's checker).

The reference SDK's scheduler is a single-threaded offer loop; this
rebuild is deliberately not.  SlotEngine/PagedEngine loop threads,
HTTP verb threads, the async checkpoint writer, replication pullers,
the health monitor's telemetry collector, and router poll loops all
share mutable state, and the repo's worst latent bugs have been
cross-thread interleavings caught late.  racecheck finds them the way
plancheck finds plan-state bugs: statically, exhaustively, gated.

Two cooperating halves:

**Static thread-ownership analysis** (``analyze_tree``): an AST pass
that discovers thread-spawn sites (``threading.Thread(target=...)``,
``threading.Timer``, executor ``.submit``, HTTP ``do_*`` handlers,
``Thread`` subclass ``run``) and colors each class's methods by
thread role — the spawn's literal ``name=`` when given, the target
method name otherwise, plus the implicit ``caller`` role every public
method carries.  Roles propagate through the intra-class ``self.``
call graph (nested-closure thread targets become pseudo-methods).
Any attribute written from >= 2 roles must be (a) guarded by the same
lock in every write (``with self.<lock>:`` inference shared with
sdklint's lock-discipline rule, ``*_locked`` = "caller holds it"),
(b) handed off through a recognized channel (``queue.Queue``,
``collections.deque``), or (c) carry an explicit
``# racecheck: handoff=<reason>`` annotation — otherwise it is a
``race-unguarded-shared-write`` finding.  Reads are deliberately
exempt: lock-free reads of wholesale-swapped snapshots are this
codebase's idiom, and the swap itself is what the rule audits.
Writes inside non-spawned nested functions are not attributed (the
callback rule covers registrar-passed closures).

**Dynamic happens-before checker**: vector-clock instrumentation that
subsumes the lockcheck.  ``install()`` patches the
``threading.Lock``/``RLock``/``Condition`` factories (queue.Queue and
threading.Event resolve those at call time, so channels are
instrumented for free) and ``Thread.start``/``join``.  Lock release
publishes the holder's clock to the lock; acquire joins it; start and
join establish fork/join edges; ``Condition.wait`` flows through the
instrumented lock's ``_release_save``/``_acquire_restore``.  Writes
to watched attributes (``watch_type`` — fed by the static pass's
shared-write map) are probed: a write whose previous writer is
neither the same thread nor ordered before it by the clocks is a race,
reported with both stacks.  Lock-order cycle detection (the
``race-lock-cycle`` rule) is unchanged from lockcheck.  Enabled via
``SDKLINT_RACECHECK=1`` (``SDKLINT_LOCKCHECK=1`` stays an alias).

The JAX package's checker reads the same switch and patches the same
factories.  This module's ``install()`` wraps the interpreter's own
lock primitives, never a factory another checker put in their place,
and ``uninstall()`` puts back exactly the factories it found: the two
checkers never wrap each other's locks, and either can be removed
first.
"""

from __future__ import annotations

import _thread
import ast
import functools
import os
import re
import sys
import threading
import traceback
import weakref
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterator, List, Optional, Sequence, Set, Tuple

from dcos_commons_tpu_torch.analysis.linter import (
    Finding,
    LintContext,
    LintResult,
    Suppressions,
    _walk_py_files,
)
from dcos_commons_tpu_torch.analysis.rules import _MUTATOR_METHODS, _is_self_attr

# -- rule ids ----------------------------------------------------------

RULE_UNGUARDED = "race-unguarded-shared-write"
RULE_CALLBACK = "race-callback-thread"
RULE_COLLECTIVE = "race-collective-offloop"
RULE_CHECK_THEN_ACT = "race-check-then-act"
RULE_LOCK_CYCLE = "race-lock-cycle"
RULE_UNORDERED = "race-unordered-write"

_RULE_DOCS = {
    RULE_UNGUARDED: (
        "shared attribute written from >= 2 thread roles unguarded",
        "An attribute written from two or more thread roles must hold "
        "one common lock at every write, be a queue/deque handoff "
        "channel, live in a `*_locked` method (caller holds the lock), "
        "or carry `# racecheck: handoff=<reason>` stating the ordering "
        "invariant.  Reads are exempt (snapshot-swap idiom).",
    ),
    RULE_CALLBACK: (
        "registered callback mutates owner-thread state unguarded",
        "A callback handed to a registrar (gauge/subscribe/"
        "add_listener/add_callback) in a thread-spawning class runs on "
        "whatever thread fires it; if it mutates self attributes "
        "without a lock, that is a write from an uncolored role.",
    ),
    RULE_COLLECTIVE: (
        "collective reachable from a non-main thread",
        "Collectives (all_reduce/all_gather_into_tensor/broadcast/...) must "
        "run on the thread that owns the device order — a collective "
        "issued from a spawned thread can interleave with the main "
        "thread's program order and deadlock the mesh.",
    ),
    RULE_CHECK_THEN_ACT: (
        "lock released between a guarded read and its dependent write",
        "A local bound from self.<attr> inside one `with self.<lock>:` "
        "block and written back (or used to mutate the same attribute) "
        "inside a LATER guarded block is stale: the lock was released "
        "in between.  Re-read the attribute in the writing block or "
        "merge the critical sections.",
    ),
    RULE_LOCK_CYCLE: (
        "runtime lock-order cycle (latent deadlock) [dynamic]",
        "The instrumented run observed lock sites nesting in a cycle: "
        "thread A holds L1 wanting L2 while thread B can hold L2 "
        "wanting L1.  Reported by the SDKLINT_RACECHECK=1 fixtures; "
        "unchanged from lockcheck.",
    ),
    RULE_UNORDERED: (
        "concurrent unordered writes to one attribute [dynamic]",
        "The vector-clock probe saw two writes to the same attribute "
        "of the same object with no happens-before edge between them "
        "(no common lock, no queue handoff, no start/join ordering). "
        "Both stacks are reported.",
    ),
}


def race_rule_catalog() -> str:
    """Human-readable rule list for ``--catalog`` and the docs."""
    blocks = []
    for rid in sorted(_RULE_DOCS):
        short, doc = _RULE_DOCS[rid]
        blocks.append(f"{rid}: {short}\n    {' '.join(doc.split())}")
    return "\n\n".join(blocks)


# =====================================================================
# Static half: thread-ownership analysis
# =====================================================================

# handoff annotation grammar, on the write line or the line above:
#   # racecheck: handoff=<free-text reason naming the ordering edge>
_HANDOFF_RE = re.compile(r"#.*?\bracecheck:\s*handoff\s*=\s*\S")

_CHANNEL_FACTORIES = {
    "Queue", "SimpleQueue", "LifoQueue", "PriorityQueue", "deque",
}
_CALLBACK_REGISTRARS = {
    "gauge", "subscribe", "add_listener", "add_callback",
    "register_callback", "add_done_callback",
}
_COLLECTIVES = {
    "psum", "pmean", "pmax", "pmin", "psum_scatter", "all_gather",
    "all_reduce", "all_to_all", "ppermute", "pshuffle",
    "broadcast_one_to_all", "process_allgather",
    "sync_global_devices", "reached_barrier",
    # the torch.distributed calls the port makes
    "all_gather_into_tensor", "reduce_scatter_tensor",
    "all_to_all_single", "broadcast", "barrier",
    # the port's mesh wrappers (parallel/sharding.py)
    "gather", "gather_fsdp", "reduce_gradients", "batch_mean",
    # ...and its gang helpers (parallel/distributed.py)
    "broadcast_int", "gather_ints", "broadcast_arrays",
}

CALLER_ROLE = "caller"
HTTP_ROLE = "http"


def _call_name(func: ast.AST) -> str:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return ""


def _iter_spawns(node: ast.AST) -> Iterator[Tuple[ast.Call, ast.AST, str]]:
    """Yield (call, target_expr, role_hint) for every thread-spawn
    site under ``node``: threading.Thread/Timer and executor
    ``.submit`` calls."""
    for call in ast.walk(node):
        if not isinstance(call, ast.Call):
            continue
        func = call.func
        target: Optional[ast.AST] = None
        role = ""
        if (
            isinstance(func, ast.Attribute)
            and isinstance(func.value, ast.Name)
            and func.value.id == "threading"
            and func.attr in ("Thread", "Timer")
        ):
            if func.attr == "Thread":
                for kw in call.keywords:
                    if kw.arg == "target":
                        target = kw.value
                    elif kw.arg == "name" and isinstance(
                        kw.value, ast.Constant
                    ) and isinstance(kw.value.value, str):
                        role = kw.value.value
            else:  # Timer(interval, function)
                for kw in call.keywords:
                    if kw.arg == "function":
                        target = kw.value
                if target is None and len(call.args) >= 2:
                    target = call.args[1]
                role = role or "timer"
        elif isinstance(func, ast.Attribute) and func.attr == "submit":
            if call.args:
                target = call.args[0]
            role = "executor"
        if target is not None:
            yield call, target, role


@dataclass
class _Write:
    attr: str
    node: ast.AST
    guards: FrozenSet[str]
    wildcard: bool      # written in a *_locked method: caller holds it
    method: str


class _ClassModel:
    """One class's merged (module-local inheritance resolved) thread
    model: methods incl. spawned-closure pseudo-methods, lock/channel
    attrs, per-method roles, and the write map."""

    def __init__(self, ctx: LintContext, cls: ast.ClassDef,
                 by_name: Dict[str, ast.ClassDef]):
        self.ctx = ctx
        self.cls = cls
        self.name = cls.name
        self.methods: Dict[str, ast.AST] = self._merge_methods(cls, by_name)
        self.is_http_handler = self._is_http_handler(cls, by_name)
        self.is_thread_subclass = self._is_thread_subclass(cls, by_name)
        # pseudo-methods: nested defs spawned as thread targets, keyed
        # "<outer>.<name>"; their bodies are skipped when walking the
        # enclosing method
        self.spawned_nested: Set[int] = set()
        self.roles: Dict[str, Set[str]] = {}
        self._discover_spawns()
        self._seed_roles()
        self.lock_attrs = self._find_lock_attrs()
        self.channel_attrs = self._find_channel_attrs()
        self.calls: Dict[str, Set[str]] = {
            name: self._self_calls(node)
            for name, node in self.methods.items()
        }
        self._propagate_roles()
        self.writes: Dict[str, List[_Write]] = {}
        for name, node in self.methods.items():
            if name == "__init__" or name.endswith(".__init__"):
                continue  # pre-publication writes are single-threaded
            wildcard = name.rsplit(".", 1)[-1].endswith("_locked")
            for attr, sub, guards in self._walk_writes(node):
                self.writes.setdefault(attr, []).append(_Write(
                    attr, sub, frozenset(guards), wildcard, name,
                ))

    # -- structure ----------------------------------------------------

    @staticmethod
    def _merge_methods(cls, by_name) -> Dict[str, ast.AST]:
        chain: List[ast.ClassDef] = []

        def add(c: ast.ClassDef, seen: Set[str]) -> None:
            if c.name in seen:
                return
            seen.add(c.name)
            for b in c.bases:
                if isinstance(b, ast.Name) and b.id in by_name:
                    add(by_name[b.id], seen)
            chain.append(c)

        add(cls, set())
        methods: Dict[str, ast.AST] = {}
        for c in chain:  # base-first: derived overrides win
            for item in c.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    methods[item.name] = item
        return methods

    @staticmethod
    def _base_names(cls, by_name) -> Set[str]:
        out: Set[str] = set()

        def add(c: ast.ClassDef) -> None:
            for b in c.bases:
                name = _call_name(b) if not isinstance(b, ast.Name) else b.id
                if name and name not in out:
                    out.add(name)
                    if name in by_name:
                        add(by_name[name])

        add(cls)
        return out

    def _is_http_handler(self, cls, by_name) -> bool:
        return any(
            b.endswith("HTTPRequestHandler")
            for b in self._base_names(cls, by_name)
        )

    def _is_thread_subclass(self, cls, by_name) -> bool:
        return "Thread" in self._base_names(cls, by_name)

    def _discover_spawns(self) -> None:
        """Find spawn sites in every method; self.<m> targets color m,
        nested-closure targets become pseudo-methods."""
        for mname, mnode in list(self.methods.items()):
            nested = {
                item.name: item
                for item in ast.walk(mnode)
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
                and item is not mnode
            }
            for _call, target, role in _iter_spawns(mnode):
                if (
                    isinstance(target, ast.Attribute)
                    and isinstance(target.value, ast.Name)
                    and target.value.id == "self"
                ):
                    tname = target.attr
                    self.roles.setdefault(tname, set()).add(
                        role or tname.lstrip("_")
                    )
                elif isinstance(target, ast.Name) and target.id in nested:
                    closure = nested[target.id]
                    pseudo = f"{mname}.{target.id}"
                    self.methods[pseudo] = closure
                    self.spawned_nested.add(id(closure))
                    self.roles.setdefault(pseudo, set()).add(
                        role or target.id
                    )

    def _seed_roles(self) -> None:
        if self.is_http_handler:
            # every handler method runs on a per-request HTTP thread;
            # nothing in a handler class runs on the caller thread, so
            # no caller seeding (instances are per-request anyway)
            for name in self.methods:
                if name.startswith("do_"):
                    self.roles.setdefault(name, set()).add(HTTP_ROLE)
            return
        if self.is_thread_subclass and "run" in self.methods:
            self.roles.setdefault("run", set()).add(f"run:{self.name}")
        for name in self.methods:
            if "." in name or name.startswith("_"):
                continue
            self.roles.setdefault(name, set()).add(CALLER_ROLE)

    def _find_lock_attrs(self) -> Set[str]:
        """Lock attrs: assigned a threading.Lock/RLock/Condition in any
        __init__ of the chain, or used as ``with self.<attr>:``
        anywhere (covers locks received as constructor parameters,
        e.g. StandbyTail's backend_lock)."""
        locks: Set[str] = set()
        for name, node in self.methods.items():
            if name.rsplit(".", 1)[-1] == "__init__":
                for sub in ast.walk(node):
                    if not isinstance(sub, ast.Assign):
                        continue
                    value = sub.value
                    if (
                        isinstance(value, ast.Call)
                        and isinstance(value.func, ast.Attribute)
                        and value.func.attr in ("Lock", "RLock", "Condition")
                        and isinstance(value.func.value, ast.Name)
                        and value.func.value.id == "threading"
                    ):
                        for target in sub.targets:
                            if (
                                isinstance(target, ast.Attribute)
                                and isinstance(target.value, ast.Name)
                                and target.value.id == "self"
                            ):
                                locks.add(target.attr)
            for sub in ast.walk(node):
                if isinstance(sub, ast.With):
                    for item in sub.items:
                        expr = item.context_expr
                        if (
                            isinstance(expr, ast.Attribute)
                            and isinstance(expr.value, ast.Name)
                            and expr.value.id == "self"
                        ):
                            locks.add(expr.attr)
        return locks

    def _find_channel_attrs(self) -> Set[str]:
        chans: Set[str] = set()
        for name, node in self.methods.items():
            if name.rsplit(".", 1)[-1] != "__init__":
                continue
            for sub in ast.walk(node):
                if not isinstance(sub, ast.Assign):
                    continue
                value = sub.value
                if (
                    isinstance(value, ast.Call)
                    and _call_name(value.func) in _CHANNEL_FACTORIES
                ):
                    for target in sub.targets:
                        if (
                            isinstance(target, ast.Attribute)
                            and isinstance(target.value, ast.Name)
                            and target.value.id == "self"
                        ):
                            chans.add(target.attr)
        return chans

    def _self_calls(self, node: ast.AST) -> Set[str]:
        out: Set[str] = set()
        for sub in self._walk_skipping_nested(node):
            if (
                isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and isinstance(sub.func.value, ast.Name)
                and sub.func.value.id == "self"
            ):
                out.add(sub.func.attr)
        return out

    def _walk_skipping_nested(self, root: ast.AST) -> Iterator[ast.AST]:
        """Pre-order walk that does not descend into nested function
        definitions (their execution time is unknown; spawned closures
        are analyzed as pseudo-methods instead)."""

        def rec(n: ast.AST) -> Iterator[ast.AST]:
            yield n
            for child in ast.iter_child_nodes(n):
                if isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
                ):
                    continue
                yield from rec(child)

        yield root
        body = root.body if hasattr(root, "body") else []
        for child in (body if isinstance(body, list) else []):
            yield from rec(child)

    def _propagate_roles(self) -> None:
        """Fixpoint: a method's roles flow to every self.<m> callee."""
        changed = True
        while changed:
            changed = False
            for name, roles in list(self.roles.items()):
                for callee in self.calls.get(name, ()):
                    if callee not in self.methods:
                        continue
                    have = self.roles.setdefault(callee, set())
                    add = roles - have
                    if add:
                        have |= add
                        changed = True

    # -- write walker ---------------------------------------------------

    def _walk_writes(
        self, method: ast.AST
    ) -> List[Tuple[str, ast.AST, FrozenSet[str]]]:
        """(attr, node, held_locks) for every self-attr write, with a
        set-valued with-lock tracker (same traversal discipline as
        sdklint's lock-discipline rule)."""
        writes: List[Tuple[str, ast.AST, FrozenSet[str]]] = []
        from dcos_commons_tpu_torch.analysis.rules import _self_attr_writes

        def visit(node: ast.AST, held: FrozenSet[str]) -> None:
            if isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef)
            ) and node is not method:
                return  # nested def: execution time unknown
            if isinstance(node, ast.With):
                locks_here = {
                    item.context_expr.attr
                    for item in node.items
                    if _is_self_attr(item.context_expr, self.lock_attrs)
                }
                held = held | frozenset(locks_here)
                for child in node.body:
                    visit(child, held)
                return
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign,
                                 ast.Delete, ast.Expr)):
                for attr, sub in _self_attr_writes(node):
                    writes.append((attr, sub, held))
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.stmt, ast.excepthandler)):
                    visit(child, held)

        for stmt in method.body:
            visit(stmt, frozenset())
        return writes

    # -- summaries ------------------------------------------------------

    def attr_roles(self, attr: str) -> Set[str]:
        roles: Set[str] = set()
        for w in self.writes.get(attr, ()):
            roles |= self.roles.get(w.method, set())
        return roles

    def shared_attrs(self) -> Dict[str, Set[str]]:
        """attr -> writing roles, for attrs written from >= 2 roles
        (the dynamic probe set, guarded or not)."""
        out = {}
        for attr in self.writes:
            if attr in self.lock_attrs or attr in self.channel_attrs:
                continue
            roles = self.attr_roles(attr)
            if len(roles) >= 2:
                out[attr] = roles
        return out

    def thread_roles(self) -> Set[str]:
        return {
            r for roles in self.roles.values() for r in roles
            if r != CALLER_ROLE
        }


def _has_handoff(ctx: LintContext, line: int) -> bool:
    for lineno in (line, line - 1):
        if 1 <= lineno <= len(ctx.lines) and _HANDOFF_RE.search(
            ctx.lines[lineno - 1]
        ):
            return True
    return False


def _rhs_names(sub: ast.AST) -> Set[str]:
    """Locals referenced by a write's value side."""
    values: List[ast.AST] = []
    if isinstance(sub, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
        if sub.value is not None:
            values.append(sub.value)
    elif isinstance(sub, ast.Call):
        values += list(sub.args)
        values += [kw.value for kw in sub.keywords]
    names: Set[str] = set()
    for value in values:
        for n in ast.walk(value):
            if isinstance(n, ast.Name):
                names.add(n.id)
    return names


def _self_reads(expr: ast.AST) -> Set[str]:
    return {
        n.attr
        for n in ast.walk(expr)
        if isinstance(n, ast.Attribute)
        and isinstance(n.value, ast.Name)
        and n.value.id == "self"
    }


def _ordered(node: ast.AST) -> Iterator[ast.AST]:
    yield node
    for child in ast.iter_child_nodes(node):
        yield from _ordered(child)


class _ClassChecker:
    """Runs the four static rules over one _ClassModel."""

    def __init__(self, model: _ClassModel):
        self.model = model
        self.ctx = model.ctx

    def check(self) -> Tuple[List[Finding], List[Finding]]:
        """-> (findings, handoff_exempted)."""
        findings: List[Finding] = []
        exempted: List[Finding] = []
        self._unguarded_shared_writes(findings, exempted)
        self._check_then_act(findings)
        self._collective_offloop(findings)
        self._callback_thread(findings)
        return findings, exempted

    def _unguarded_shared_writes(self, findings, exempted) -> None:
        m = self.model
        for attr, roles in sorted(m.shared_attrs().items()):
            recs = m.writes[attr]
            non_wild = [w for w in recs if not w.wildcard]
            ok = all(w.guards for w in non_wild)
            if ok and non_wild:
                common = set(non_wild[0].guards)
                for w in non_wild[1:]:
                    common &= set(w.guards)
                ok = bool(common)
            if ok:
                continue
            bad = next(
                (w for w in non_wild if not w.guards),
                recs[0] if recs else None,
            )
            if bad is None:
                continue
            guard_note = sorted({
                g for w in recs for g in w.guards
            })
            finding = self.ctx.finding(
                bad.node, RULE_UNGUARDED,
                f"{m.name}.{attr} is written from roles "
                f"{sorted(roles)} without one common lock"
                + (f" (locks seen: {guard_note})" if guard_note else "")
                + " — guard every write, hand off via a queue, or "
                  "annotate `# racecheck: handoff=<reason>`",
            )
            # the attr rides on the finding so analyze_paths can drop
            # declared-legal sharing from the dynamic probe set (an
            # annotated monotonic flip would otherwise be re-flagged
            # by the vector-clock checker as the exact benign race the
            # annotation blesses)
            finding._race_attr = attr
            if any(
                _has_handoff(self.ctx, w.node.lineno) for w in recs
            ):
                exempted.append(finding)
            else:
                findings.append(finding)

    def _check_then_act(self, findings) -> None:
        m = self.model
        if not m.thread_roles() or not m.lock_attrs:
            return
        for mname, mnode in m.methods.items():
            if mname.rsplit(".", 1)[-1] == "__init__":
                continue
            self._check_then_act_method(findings, mname, mnode)

    def _check_then_act_method(self, findings, mname, mnode) -> None:
        m = self.model
        regions: List[ast.With] = []

        def find_regions(n: ast.AST, held: bool) -> None:
            if isinstance(
                n, (ast.FunctionDef, ast.AsyncFunctionDef)
            ) and n is not mnode:
                return
            if isinstance(n, ast.With):
                guarded = any(
                    _is_self_attr(item.context_expr, m.lock_attrs)
                    for item in n.items
                )
                if guarded and not held:
                    regions.append(n)
                    held = True
            for child in ast.iter_child_nodes(n):
                find_regions(child, held)

        for stmt in mnode.body:
            find_regions(stmt, False)
        if len(regions) < 2:
            return

        bound: Dict[str, Tuple[Set[str], int]] = {}
        for idx, region in enumerate(regions):
            for sub in _ordered(region):
                if (
                    isinstance(sub, ast.Assign)
                    and len(sub.targets) == 1
                    and isinstance(sub.targets[0], ast.Name)
                ):
                    attrs_read = _self_reads(sub.value)
                    if attrs_read:
                        bound[sub.targets[0].id] = (attrs_read, idx)
                write_attr = None
                if isinstance(sub, (ast.Assign, ast.AugAssign)):
                    targets = (
                        sub.targets if isinstance(sub, ast.Assign)
                        else [sub.target]
                    )
                    for t in targets:
                        base = t.value if isinstance(t, ast.Subscript) else t
                        if (
                            isinstance(base, ast.Attribute)
                            and isinstance(base.value, ast.Name)
                            and base.value.id == "self"
                        ):
                            write_attr = base.attr
                elif (
                    isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Attribute)
                    and sub.func.attr in _MUTATOR_METHODS
                    and isinstance(sub.func.value, ast.Attribute)
                    and isinstance(sub.func.value.value, ast.Name)
                    and sub.func.value.value.id == "self"
                ):
                    write_attr = sub.func.value.attr
                if write_attr is None:
                    continue
                for local in _rhs_names(sub):
                    if local not in bound:
                        continue
                    attrs_read, bidx = bound[local]
                    if write_attr in attrs_read and bidx < idx:
                        findings.append(self.ctx.finding(
                            sub, RULE_CHECK_THEN_ACT,
                            f"{m.name}.{mname}: `{local}` was read from "
                            f"self.{write_attr} in an earlier critical "
                            "section; the lock was released before this "
                            "guarded write derived from it — re-read "
                            "under the lock or merge the sections",
                        ))

    def _collective_offloop(self, findings) -> None:
        m = self.model
        for mname, mnode in m.methods.items():
            roles = m.roles.get(mname, set()) - {CALLER_ROLE}
            if not roles:
                continue
            for sub in m._walk_skipping_nested(mnode):
                if (
                    isinstance(sub, ast.Call)
                    and _call_name(sub.func) in _COLLECTIVES
                ):
                    findings.append(self.ctx.finding(
                        sub, RULE_COLLECTIVE,
                        f"{m.name}.{mname} (thread role(s) "
                        f"{sorted(roles)}) calls collective "
                        f"`{_call_name(sub.func)}` off the main "
                        "thread — collectives must follow one "
                        "thread's program order",
                    ))

    def _callback_thread(self, findings) -> None:
        m = self.model
        if not m.thread_roles():
            return
        unguarded_methods = {
            name for name, node in m.methods.items()
            if any(
                not w.guards and not w.wildcard
                for writes in (m.writes.values())
                for w in writes
                if w.method == name
            )
        }
        for mname, mnode in m.methods.items():
            for sub in m._walk_skipping_nested(mnode):
                if not (
                    isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Attribute)
                    and sub.func.attr in _CALLBACK_REGISTRARS
                ):
                    continue
                for arg in list(sub.args) + [
                    kw.value for kw in sub.keywords
                ]:
                    attr = self._callback_mutation(arg, unguarded_methods)
                    if attr:
                        findings.append(self.ctx.finding(
                            sub, RULE_CALLBACK,
                            f"{m.name}.{mname} registers a callback "
                            f"via .{sub.func.attr}() that mutates "
                            f"{attr} unguarded — callbacks fire on "
                            "the registrar's thread, not the owner's",
                        ))

    def _callback_mutation(self, arg, unguarded_methods) -> str:
        if isinstance(arg, ast.Lambda):
            for sub in ast.walk(arg.body):
                if (
                    isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Attribute)
                    and sub.func.attr in _MUTATOR_METHODS
                    and isinstance(sub.func.value, ast.Attribute)
                    and isinstance(sub.func.value.value, ast.Name)
                    and sub.func.value.value.id == "self"
                ):
                    owner = sub.func.value.attr
                    if owner not in self.model.lock_attrs:
                        return f"self.{owner}"
        if (
            isinstance(arg, ast.Attribute)
            and isinstance(arg.value, ast.Name)
            and arg.value.id == "self"
            and arg.attr in unguarded_methods
        ):
            return f"self.{arg.attr}() state"
        return ""


@dataclass
class RaceResult(LintResult):
    """LintResult + the thread model the dynamic half probes."""

    shared_attrs: Dict[str, List[str]] = field(default_factory=dict)
    roles: Dict[str, List[str]] = field(default_factory=dict)


def analyze_paths(paths: Sequence[str], root: str) -> RaceResult:
    result = RaceResult()
    for path in paths:
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
        ctx = LintContext(path, os.path.relpath(path, root), source)
        result.files_checked += 1
        if ctx.tree is None:
            continue
        suppressions = Suppressions(ctx.lines)
        by_name = {
            node.name: node
            for node in ast.walk(ctx.tree)
            if isinstance(node, ast.ClassDef)
        }
        seen: Set[Tuple[str, int, str]] = set()
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            model = _ClassModel(ctx, node, by_name)
            findings, exempted = _ClassChecker(model).check()
            result.suppressed += exempted
            # sharing declared legal (handoff annotation) or triaged
            # with a rationale (sdklint suppression) leaves the
            # dynamic probe set — the stated invariant, not a lock,
            # is what orders those writes
            legal = {
                getattr(f, "_race_attr", None) for f in exempted
            }
            for finding in findings:
                key = (finding.file, finding.line, finding.rule)
                if key in seen:
                    continue  # inheritance merge re-visits base writes
                seen.add(key)
                if suppressions.covers(finding):
                    result.suppressed.append(finding)
                    legal.add(getattr(finding, "_race_attr", None))
                else:
                    result.findings.append(finding)
            shared = {
                attr: roles
                for attr, roles in model.shared_attrs().items()
                if attr not in legal
            }
            if shared:
                attrs = set(
                    result.shared_attrs.get(model.name, [])
                ) | set(shared)
                result.shared_attrs[model.name] = sorted(attrs)
            all_roles = {
                r for roles in model.roles.values() for r in roles
            }
            if all_roles - {CALLER_ROLE}:
                merged = set(
                    result.roles.get(model.name, [])
                ) | all_roles
                result.roles[model.name] = sorted(merged)
    result.findings.sort(key=lambda f: (f.file, f.line, f.rule))
    return result


def analyze_tree(
    root: str,
    subdirs: Sequence[str] = ("dcos_commons_tpu_torch",),
) -> RaceResult:
    return analyze_paths(_walk_py_files(root, subdirs), root)


@functools.lru_cache(maxsize=4)
def shared_write_map(root: str) -> Dict[str, Tuple[str, ...]]:
    """class name -> attrs written from >= 2 thread roles: the set the
    dynamic fixtures probe (``watch_type``).  Cached — the threaded
    test modules all ask for the same map."""
    result = analyze_tree(root)
    return {
        cls: tuple(attrs)
        for cls, attrs in sorted(result.shared_attrs.items())
    }


# =====================================================================
# Dynamic half: vector-clock happens-before instrumentation
# (subsumes the lockcheck; SDKLINT_LOCKCHECK stays an alias)
# =====================================================================

ENV_VAR = "SDKLINT_RACECHECK"
LEGACY_ENV_VAR = "SDKLINT_LOCKCHECK"

# the interpreter's own primitives: what every InstrumentedLock wraps,
# whatever factory another checker has put on ``threading``
_REAL_LOCK = _thread.allocate_lock
_REAL_RLOCK = _thread.RLock


def _real_condition() -> type:
    """``threading.Condition``'s class, also while another checker has
    replaced the name with a factory function."""
    cond = threading.Condition
    return cond if isinstance(cond, type) else type(cond(_REAL_LOCK()))


_state_lock = _REAL_LOCK()  # guards the module-level maps below
_enabled = False
_originals: Optional[Tuple] = None
_thread_originals: Optional[Tuple] = None
# the factories and Thread methods this module put in place, so that
# uninstall() restores only where they are still the ones in place
_patched: Optional[Tuple] = None
_thread_patched: Optional[Tuple] = None
_tls = threading.local()

# lock-order graph: (outer_site, inner_site) -> one sample acquiring
# stack (the first observed, enough to locate the nesting)
_edges: Dict[Tuple[str, str], str] = {}
# site -> set of thread names that ever acquired it
_threads_per_site: Dict[str, Set[str]] = {}
# (class_name, attr) -> {thread: ALL writes held a lock}
_watched_writes: Dict[Tuple[str, str], Dict[str, bool]] = {}
# vector clocks: (class, attr, id(obj)) -> last write record; the
# record keeps a strong ref to obj so an id() can't be reused while
# its entry is live (reset() drops them)
_last_write: Dict[Tuple[str, str, int], Tuple] = {}
_races: List["RaceRecord"] = []
_RACE_CAP = 64
_tid_counter = [0]
_final_vcs: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_watched_types: List[Tuple[type, Optional[object]]] = []


def _alloc_tid() -> int:
    with _state_lock:
        _tid_counter[0] += 1
        return _tid_counter[0]


def _thread_vc() -> Tuple[int, Dict[int, int]]:
    tid = getattr(_tls, "tid", None)
    if tid is None:
        tid = _tls.tid = _alloc_tid()
        _tls.vc = {tid: 1}
    return tid, _tls.vc


def _join_vc(vc: Dict[int, int], other: Dict[int, int]) -> None:
    for k, v in other.items():
        if v > vc.get(k, 0):
            vc[k] = v


def _held_stack() -> List["InstrumentedLock"]:
    stack = getattr(_tls, "held", None)
    if stack is None:
        stack = _tls.held = []
    return stack


def _enter_probe() -> bool:
    """Reentrancy guard for every recording path.  Recording calls
    ``threading.current_thread()``, which on a still-bootstrapping
    thread mints a ``_DummyThread`` whose own ``Event.set()`` walks
    back into the instrumented condition — without this flag that
    recursion never terminates.  Inside a probe, locks delegate
    without recording."""
    if getattr(_tls, "in_probe", False):
        return False
    _tls.in_probe = True
    return True


def _exit_probe() -> None:
    _tls.in_probe = False


def _creation_site() -> str:
    """file:line of the frame that called threading.Lock()/RLock(),
    relative to the repo so sites read like lint findings."""
    for frame in reversed(traceback.extract_stack(limit=8)[:-2]):
        if os.sep + "analysis" + os.sep + "racecheck" in frame.filename:
            continue
        if frame.filename.startswith("<"):
            continue
        name = frame.filename
        for marker in ("dcos_commons_tpu_torch", "frameworks", "tests"):
            idx = name.find(os.sep + marker + os.sep)
            if idx >= 0:
                name = name[idx + 1:]
                break
        return f"{name.replace(os.sep, '/')}:{frame.lineno}"
    return "<unknown>"


def _short_stack(skip: int = 3, limit: int = 7) -> str:
    """Cheap frame walk (no traceback formatting) for per-write
    capture — racecheck probes hot loops."""
    try:
        frame = sys._getframe(skip)
    except ValueError:
        return "<no stack>"
    out = []
    while frame is not None and len(out) < limit:
        code = frame.f_code
        name = code.co_filename
        for marker in ("dcos_commons_tpu_torch", "frameworks", "tests"):
            idx = name.find(os.sep + marker + os.sep)
            if idx >= 0:
                name = name[idx + 1:]
                break
        out.append(
            f"{name.replace(os.sep, '/')}:{frame.f_lineno} "
            f"in {code.co_name}"
        )
        frame = frame.f_back
    return "\n      ".join(out)


class InstrumentedLock:
    """Wraps one real Lock/RLock: records nesting edges on acquire and
    carries the vector clock releases publish / acquires join.  Also
    implements the private Condition protocol (``_release_save`` /
    ``_acquire_restore`` / ``_is_owned``) so ``threading.Condition``
    built on an instrumented lock keeps working — and cv-guarded state
    gets happens-before edges through wait/notify."""

    def __init__(self, inner, site: str, reentrant: bool):
        self._inner = inner
        self.site = site
        self._reentrant = reentrant
        self._vc: Dict[int, int] = {}

    # -- recording ----------------------------------------------------

    def _record_acquire(self) -> None:
        if not _enabled or not _enter_probe():
            return
        try:
            # the calling thread holds the inner lock here, so _vc
            # reads/writes are serialized by the lock itself
            tid, vc = _thread_vc()
            _join_vc(vc, self._vc)
            stack = _held_stack()
            if self._reentrant and any(h is self for h in stack):
                stack.append(self)  # reentry: no new edges
                return
            held_sites = {h.site for h in stack if h is not self}
            new_edges = [
                (outer, self.site) for outer in held_sites
                if outer != self.site and (outer, self.site) not in _edges
            ]
            if new_edges:
                # format the (expensive) sample stack only for a
                # first-seen edge; steady-state nested acquires just
                # re-confirm known edges
                sample = "".join(traceback.format_stack(limit=12)[:-2])
                with _state_lock:
                    for edge in new_edges:
                        _edges.setdefault(edge, sample)
            with _state_lock:
                _threads_per_site.setdefault(self.site, set()).add(
                    threading.current_thread().name
                )
            stack.append(self)
        except Exception:  # sdklint: disable=swallowed-exception — the checker must never break the code under test
            pass
        finally:
            _exit_probe()

    def _record_release(self, pop_all: bool = False) -> int:
        popped = 0
        if not _enabled or not _enter_probe():
            return popped
        try:
            tid, vc = _thread_vc()
            self._vc = dict(vc)
            vc[tid] = vc.get(tid, 0) + 1
            stack = _held_stack()
            for i in range(len(stack) - 1, -1, -1):
                if stack[i] is self:
                    del stack[i]
                    popped += 1
                    if not pop_all:
                        break
        except Exception:  # sdklint: disable=swallowed-exception — see _record_acquire
            pass
        finally:
            _exit_probe()
        return popped

    # -- the lock protocol -------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._record_acquire()
        return got

    def release(self) -> None:
        self._record_release()
        self._inner.release()

    def locked(self) -> bool:
        locked = getattr(self._inner, "locked", None)
        if locked is not None:
            return locked()
        # RLock pre-3.12 has no locked(); _is_owned is close enough
        return bool(self._inner._is_owned())

    # -- Condition protocol ------------------------------------------

    def _release_save(self):
        """Condition.wait: drop ALL recursion levels before parking."""
        popped = self._record_release(pop_all=True)
        inner = self._inner
        if hasattr(inner, "_release_save"):
            return (popped, inner._release_save())
        inner.release()
        return (popped, None)

    def _acquire_restore(self, state) -> None:
        popped, saved = state
        inner = self._inner
        if hasattr(inner, "_acquire_restore"):
            inner._acquire_restore(saved)
        else:
            inner.acquire()
        if _enabled and _enter_probe():
            try:
                tid, vc = _thread_vc()
                _join_vc(vc, self._vc)
                stack = _held_stack()
                for _ in range(popped):
                    stack.append(self)
            except Exception:  # sdklint: disable=swallowed-exception — see _record_acquire
                pass
            finally:
                _exit_probe()

    def _is_owned(self) -> bool:
        inner = self._inner
        if hasattr(inner, "_is_owned"):
            return inner._is_owned()
        if inner.acquire(False):
            inner.release()
            return False
        return True

    def __enter__(self) -> bool:
        self.acquire()
        return True

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<InstrumentedLock {self.site} wrapping {self._inner!r}>"


def install() -> None:
    """Patch threading's lock factories and Thread start/join;
    idempotent.  The factories wrap the interpreter's primitives, not
    the ones found (another checker's), so no lock is instrumented
    twice; Thread start/join chain to what was found, so a checker
    installed first keeps its fork/join edges."""
    global _enabled, _originals, _thread_originals, _patched, \
        _thread_patched
    with _state_lock:
        if _originals is None:
            found = (threading.Lock, threading.RLock, threading.Condition)
            real_lock, real_rlock = _REAL_LOCK, _REAL_RLOCK
            real_condition = _real_condition()

            # after uninstall() a factory left in place (another
            # checker restored it) hands out plain locks
            def make_lock():
                if not _enabled:
                    return real_lock()
                return InstrumentedLock(real_lock(), _creation_site(), False)

            def make_rlock():
                if not _enabled:
                    return real_rlock()
                return InstrumentedLock(real_rlock(), _creation_site(), True)

            def make_condition(lock=None):
                # InstrumentedLock implements the private Condition
                # protocol, so the cv runs ON the wrapper and wait/
                # notify inherit its happens-before edges (queue.Queue
                # and threading.Event resolve these factories at call
                # time and come out instrumented for free)
                if lock is None:
                    lock = make_rlock()
                return real_condition(lock)

            threading.Lock = make_lock
            threading.RLock = make_rlock
            threading.Condition = make_condition
            _originals = found
            _patched = (make_lock, make_rlock, make_condition)
        if _thread_originals is None:
            real_start = threading.Thread.start
            real_join = threading.Thread.join

            def patched_start(self):
                if _enabled:
                    try:
                        ptid, pvc = _thread_vc()
                        pvc[ptid] = pvc.get(ptid, 0) + 1
                        snapshot = dict(pvc)
                        orig_run = self.run

                        def run_shim():
                            tid, vc = _thread_vc()
                            _join_vc(vc, snapshot)
                            vc[tid] = vc.get(tid, 0) + 1
                            try:
                                orig_run()
                            finally:
                                try:
                                    with _state_lock:
                                        _final_vcs[self] = dict(vc)
                                except Exception:  # sdklint: disable=swallowed-exception — teardown must not mask the run's outcome
                                    pass

                        self.run = run_shim
                    except Exception:  # sdklint: disable=swallowed-exception — never break Thread.start
                        pass
                real_start(self)

            def patched_join(self, timeout=None):
                real_join(self, timeout)
                if _enabled and not self.is_alive():
                    try:
                        with _state_lock:
                            final = _final_vcs.get(self)
                        if final:
                            _tid, vc = _thread_vc()
                            _join_vc(vc, final)
                    except Exception:  # sdklint: disable=swallowed-exception — never break Thread.join
                        pass

            threading.Thread.start = patched_start
            threading.Thread.join = patched_join
            _thread_originals = (real_start, real_join)
            _thread_patched = (patched_start, patched_join)
        _enabled = True


def uninstall() -> None:
    """Restore the factories found at ``install()`` and stop recording.
    Wrappers already handed out keep delegating to their inner locks.
    Where another checker has since put its own (or the originals)
    in place, that is left as it is: checkers come off in the reverse
    order of their installs."""
    global _enabled, _originals, _thread_originals, _patched, \
        _thread_patched
    with _state_lock:
        if _originals is not None:
            current = (threading.Lock, threading.RLock, threading.Condition)
            if current == _patched:
                (threading.Lock, threading.RLock,
                 threading.Condition) = _originals
            _originals = _patched = None
        if _thread_originals is not None:
            current = (threading.Thread.start, threading.Thread.join)
            if current == _thread_patched:
                (threading.Thread.start,
                 threading.Thread.join) = _thread_originals
            _thread_originals = _thread_patched = None
        _enabled = False


def reset() -> None:
    with _state_lock:
        _edges.clear()
        _threads_per_site.clear()
        _watched_writes.clear()
        _last_write.clear()
        del _races[:]


def is_enabled() -> bool:
    return _enabled


def env_requested() -> bool:
    return any(
        os.environ.get(var, "") not in ("", "0", "false")
        for var in (ENV_VAR, LEGACY_ENV_VAR)
    )


# -- write probes ------------------------------------------------------


def _record_write(obj, attr: str) -> None:
    """One monitored attribute write: legacy guarded/unguarded
    bookkeeping + the vector-clock unordered-pair check."""
    if not _enter_probe():
        return
    try:
        _record_write_inner(obj, attr)
    finally:
        _exit_probe()


def _record_write_inner(obj, attr: str) -> None:
    held = bool(_held_stack())
    thread = threading.current_thread().name
    tid, vc = _thread_vc()
    vc[tid] = vc.get(tid, 0) + 1  # every write is its own event
    own = vc[tid]
    stack = _short_stack(skip=3)
    cls_name = type(obj).__name__
    for suffix in ("_sdklint",):
        if cls_name.endswith(suffix):
            cls_name = cls_name[: -len(suffix)]
    key = (cls_name, attr, id(obj))
    with _state_lock:
        by_thread = _watched_writes.setdefault((cls_name, attr), {})
        # AND across the thread's writes: one unguarded write taints
        # the thread forever — a guarded write later must never mask it
        by_thread[thread] = by_thread.get(thread, True) and held
        prev = _last_write.get(key)
        _last_write[key] = (tid, own, thread, stack, obj)
        if prev is not None:
            ptid, pown, pname, pstack, _obj = prev
            if ptid != tid and pown > vc.get(ptid, 0):
                if len(_races) < _RACE_CAP:
                    _races.append(RaceRecord(
                        cls_name, attr, pname, pstack, thread, stack,
                    ))


def watch(obj) -> None:
    """Instrument ONE object's attribute writes by swapping in a
    one-off recording subclass (legacy lockcheck API; requires a
    ``__dict__``-backed class)."""
    cls = type(obj)
    if getattr(cls, "_sdklint_watched", False):
        return
    base_name = cls.__name__

    def recording_setattr(self, name, value):
        if _enabled:
            try:
                _record_write(self, name)
            except Exception:  # sdklint: disable=swallowed-exception — never break the watched object
                pass
        super(watched, self).__setattr__(name, value)

    watched = type(
        f"{base_name}_sdklint",
        (cls,),
        {"__setattr__": recording_setattr, "_sdklint_watched": True},
    )
    obj.__class__ = watched


def watch_type(cls: type, attrs: Optional[Sequence[str]] = None) -> None:
    """Instrument EVERY instance of ``cls`` (works with ``__slots__``)
    by patching ``__setattr__`` class-wide.  ``attrs`` narrows the
    probe to the static pass's shared-write set; None records all.
    ``unwatch_types()`` restores."""
    resolved = getattr(cls, "__setattr__", None)
    if getattr(resolved, "_rc_recorder", False):
        return  # this class (or a base) is already recording
    own = cls.__dict__.get("__setattr__")
    allowed = frozenset(attrs) if attrs is not None else None

    def recording_setattr(self, name, value, _orig=resolved):
        if _enabled and (allowed is None or name in allowed):
            try:
                _record_write(self, name)
            except Exception:  # sdklint: disable=swallowed-exception — never break the watched type
                pass
        _orig(self, name, value)

    recording_setattr._rc_recorder = True
    cls.__setattr__ = recording_setattr
    with _state_lock:
        _watched_types.append((cls, own))


def unwatch_types() -> None:
    """Undo every ``watch_type`` patch (fixtures call on teardown)."""
    with _state_lock:
        pending = list(_watched_types)
        del _watched_types[:]
    for cls, own in reversed(pending):
        if own is not None:
            cls.__setattr__ = own
        else:
            try:
                del cls.__setattr__
            except AttributeError:
                pass


# -- report -----------------------------------------------------------


@dataclass
class RaceRecord:
    """One unordered write pair, with both stacks."""

    cls: str
    attr: str
    thread_a: str
    stack_a: str
    thread_b: str
    stack_b: str

    def describe(self) -> str:
        return (
            f"[{RULE_UNORDERED}] {self.cls}.{self.attr} written "
            f"concurrently by '{self.thread_a}' and '{self.thread_b}' "
            "with no happens-before edge\n"
            f"    '{self.thread_a}' wrote at:\n      {self.stack_a}\n"
            f"    '{self.thread_b}' wrote at:\n      {self.stack_b}"
        )


@dataclass
class RaceReport:
    """The dynamic run's verdict: lock-order graph + cycles (the
    race-lock-cycle rule), legacy unguarded-write summary, and the
    vector-clock unordered write pairs."""

    edges: Dict[Tuple[str, str], str] = field(default_factory=dict)
    cycles: List[List[str]] = field(default_factory=list)
    unguarded_writes: List[str] = field(default_factory=list)
    races: List[RaceRecord] = field(default_factory=list)

    def describe(self) -> str:
        lines = [
            f"lock-order edges: {len(self.edges)}, "
            f"cycles: {len(self.cycles)}, "
            f"cross-thread unguarded writes: {len(self.unguarded_writes)}, "
            f"unordered write pairs: {len(self.races)}"
        ]
        for cycle in self.cycles:
            lines.append(
                f"  [{RULE_LOCK_CYCLE}] DEADLOCK RISK: "
                + " -> ".join(cycle + cycle[:1])
            )
            first = (cycle[0], cycle[1 % len(cycle)])
            if first in self.edges:
                lines.append("  sample acquiring stack:\n" + self.edges[first])
        lines += [f"  UNGUARDED: {w}" for w in self.unguarded_writes]
        lines += ["  " + race.describe() for race in self.races]
        return "\n".join(lines)


# lockcheck's historical name for the report type
LockReport = RaceReport


def _find_cycles(adjacency: Dict[str, Set[str]]) -> List[List[str]]:
    """Simple elementary-cycle scan: DFS from each node, reporting
    each cycle once (canonicalized by its smallest rotation)."""
    seen_cycles: Set[Tuple[str, ...]] = set()
    cycles: List[List[str]] = []

    def canonical(path: List[str]) -> Tuple[str, ...]:
        pivot = min(range(len(path)), key=lambda i: path[i])
        return tuple(path[pivot:] + path[:pivot])

    def dfs(node: str, path: List[str], on_path: Set[str]) -> None:
        for nxt in sorted(adjacency.get(node, ())):
            if nxt in on_path:
                cycle = path[path.index(nxt):]
                key = canonical(cycle)
                if key not in seen_cycles:
                    seen_cycles.add(key)
                    cycles.append(list(key))
                continue
            if len(path) < 32:  # bound pathological graphs
                dfs(nxt, path + [nxt], on_path | {nxt})

    for start in sorted(adjacency):
        dfs(start, [start], {start})
    return cycles


def report() -> RaceReport:
    with _state_lock:
        edges = dict(_edges)
        watched = {k: dict(v) for k, v in _watched_writes.items()}
        races = list(_races)
    adjacency: Dict[str, Set[str]] = {}
    for outer, inner in edges:
        adjacency.setdefault(outer, set()).add(inner)
    unguarded = [
        f"{cls}.{attr} written by threads {sorted(by_thread)} "
        "with at least one write holding no lock"
        for (cls, attr), by_thread in sorted(watched.items())
        if len(by_thread) > 1 and not all(by_thread.values())
    ]
    return RaceReport(
        edges=edges,
        cycles=_find_cycles(adjacency),
        unguarded_writes=unguarded,
        races=races,
    )

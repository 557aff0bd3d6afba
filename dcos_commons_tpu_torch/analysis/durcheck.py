"""durcheck: crash-consistency & durability-ordering analysis (port of
``dcos_commons_tpu/analysis/durcheck.py``: the classifier and the five
rules unchanged, the scope moved to ``dcos_commons_tpu_torch/``).

The HA control plane's core robustness claim is "cold start and
failover are one code path": every externally visible action is
WAL'd before it happens, every persisted record kind has a replay
consumer, every scheduler-path store mutation runs behind the
leader fence, and every file-backed persist uses tmp+fsync+rename.
Those invariants were previously enforced only by five hand-wired
chaos points (testing/chaos.py) and whatever tests remembered to
cover — this pass verifies them statically, the way spmdcheck
verifies collective schedules: a per-function *persistence-effect
summary* (store writes, journal appends, WAL records, file/
checkpoint persists, and external effects — agent launch/kill,
HTTP 2xx acks, lease resignation) is built per file, propagated
over the call graph to a fixpoint, and five flow-ordered rules run
over the result.

Rules (suppressible with ``# sdklint: disable=<rule>`` or the
rationale-carrying ``# durcheck: <rule>=<reason>`` annotation, and
absorbable by the shared ``.sdklint-torch-baseline.json``):

- ``dur-effect-before-wal``: an external effect (agent launch/kill,
  HTTP 2xx ack, lease resign) is reachable on some path *before* an
  intent-class persist (launch WAL, task-record store, raw persister
  write) later in the same flow.  A crash in that window leaves an
  effect the successor cannot derive from the store.  May-analysis:
  effect sets union at branch joins, so a persist on only one branch
  never masks the finding; loop back-edges are NOT modeled (the
  per-iteration persist-then-effect pattern is correct, and
  cross-iteration ordering is each item's own WAL's concern).
  Journal appends, property writes, file persists, and deletions do
  not trigger the rule: they are telemetry, derived state, or
  garbage collection of completed intent — not intent records.
- ``dur-replay-parity``: every property key (and journal event kind)
  written somewhere must have a rehydrate/replay reader, and vice
  versa.  A dead record is debt the store carries forever; an orphan
  reader is a replay path that can never fire (usually a typo'd key
  or a record kind that was renamed on only one side).  Keys are
  matched as normalized tokens: literals exactly, constant-prefixed
  f-strings/concats by prefix, shared symbolic prefixes
  (``PLAN_CKPT_PREFIX + name``) by the constant's resolved value or
  name, and fully dynamic keys (HTTP passthrough) are exempt.
- ``dur-unfenced-write``: the flow-sensitive upgrade of sdklint's
  ``lease-gated-mutation``: a raw persister mutation OUTSIDE the
  lint's scoped directories that is nevertheless *reachable* from
  scheduler-path code over the call graph — exactly the sites the
  single-file lint structurally cannot see.  The two rules are
  cross-referenced: any site ``lease-gated-mutation`` would report
  is skipped here, so one site is never double-reported.
- ``dur-nonatomic-pair``: two coupled store keys (same derived base
  path, different leaves — the classic task info/status pair)
  mutated by separate single-key ``set`` calls with no generation
  bump between them and no single-transaction ``apply`` batch.  A
  crash between the writes leaves a torn record a replayer can
  observe.
- ``dur-file-discipline``: a file opened for writing in a
  persistence-relevant module without BOTH an ``os.fsync`` and an
  ``os.replace``/``os.rename`` in the same function — the
  tmp+fsync+rename pattern ``storage/file_persister.compact`` is the
  in-tree exemplar of.

The pass also emits the full **persistence-point map**: every
WAL/store/property/persister/journal/checkpoint/file boundary it
discovered, as (file, line range, kind, function).  ``analysis dur
--points`` dumps it as JSON, and ``testing/chaos.py`` consumes it to
auto-derive crash-injection points — the chaos matrix grows from the
five hand-wired kinds to every statically discovered boundary, and a
boundary the harness cannot reach is reported, not silently skipped
(the map stays probe-verified the way plancheck's quotient does).

Scope: the persistence-relevant subtrees (scheduler, state, storage,
ha, health, recovery, plan, offer, http, serve, router, multi,
decommission, uninstall, runtime, utils) plus ``common.py`` (the
atomic-write helper lives there).  Findings reuse the sdklint
``Finding``/``Suppressions`` machinery so CLI, baseline, and gate
treatment are identical to every other analyzer.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from dcos_commons_tpu_torch.analysis.linter import (
    Finding,
    LintResult,
    Suppressions,
)

# directories (relative to the repo root) the analyzer walks; entries
# may also name single files (common.py holds atomic_write_text)
DUR_SUBDIRS = (
    "dcos_commons_tpu_torch/scheduler",
    "dcos_commons_tpu_torch/state",
    "dcos_commons_tpu_torch/storage",
    "dcos_commons_tpu_torch/ha",
    "dcos_commons_tpu_torch/health",
    "dcos_commons_tpu_torch/recovery",
    "dcos_commons_tpu_torch/plan",
    "dcos_commons_tpu_torch/offer",
    "dcos_commons_tpu_torch/http",
    "dcos_commons_tpu_torch/serve",
    "dcos_commons_tpu_torch/router",
    "dcos_commons_tpu_torch/multi",
    "dcos_commons_tpu_torch/decommission",
    "dcos_commons_tpu_torch/uninstall",
    "dcos_commons_tpu_torch/runtime",
    "dcos_commons_tpu_torch/utils",
    "dcos_commons_tpu_torch/common.py",
)

# persist kinds that count as INTENT records for dur-effect-before-wal
TRIGGER_KINDS = frozenset({"wal", "store", "persister"})
# every kind the persistence-point map carries
PERSIST_KINDS = (
    "wal", "store", "property", "persister", "checkpoint",
    "journal", "journal-flush", "delete", "file",
)
EFFECT_KINDS = frozenset({"launch", "kill", "http-ack", "lease-resign"})

# methods the primitive classifier owns.  When one of these is called
# on a receiver that does NOT match its pattern (outcome_tracker
# .record, metrics set, dict.set, ...), the call is treated as inert
# rather than resolved by simple name — otherwise every ``record``/
# ``set``/``commit`` in the tree would union in the WAL summaries.
_PRIMITIVE_METHODS = frozenset({
    "store_tasks", "store_status", "store_launch", "store_goal_override",
    "store_framework_id", "store_target", "set_target_config",
    "store_config", "store_property", "set_deployment_completed",
    "record", "commit", "set", "apply", "append", "flush", "store",
    "recursive_delete", "clear_task", "clear_property",
    "clear_all_data", "release", "checkpoint",
    "kill", "launch", "launch_one", "resign", "send_response",
})

# rationale-carrying inline suppression, durcheck's own grammar
# (mirrors racecheck's ``# racecheck: handoff=<reason>``):
#   self.ledger.commit(...)  # durcheck: dur-effect-before-wal=<why>
# valid on the finding's line or the line above; the reason is
# REQUIRED — an annotation without one does not suppress.
_DUR_ANNOT_RE = re.compile(
    r"#\s*durcheck:\s*(?P<rule>dur-[a-z\-]+)\s*=\s*(?P<reason>\S.*)"
)


def _receiver_name(call: ast.Call) -> str:
    """Name of the object a method is called on: ``a.b.c(...)`` -> b,
    ``x.f(...)`` -> x, bare ``f(...)`` -> ''."""
    func = call.func
    if not isinstance(func, ast.Attribute):
        return ""
    value = func.value
    if isinstance(value, ast.Name):
        return value.id
    if isinstance(value, ast.Attribute):
        return value.attr
    return ""


def _call_method(call: ast.Call) -> str:
    func = call.func
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


@dataclass(frozen=True)
class Prim:
    """One classified primitive: ``category`` is ``persist`` /
    ``delete`` / ``journal`` / ``effect``; ``kind`` the map kind or
    effect kind."""

    category: str
    kind: str


def classify_call(call: ast.Call) -> Optional[Prim]:
    """Classify a call against the persistence/effect vocabulary.

    Receiver-gated: ``record`` is a WAL write only on a *recorder*,
    ``commit`` only on a *ledger*, ``set``/``apply`` only on a
    *persister*/*backend* — everything else with a primitive method
    name is deliberately inert (see ``_PRIMITIVE_METHODS``)."""
    method = _call_method(call)
    recv = _receiver_name(call).lower()
    if method == "store_launch":
        return Prim("persist", "wal")
    if method in ("store_tasks", "store_status", "store_goal_override",
                  "store_framework_id", "store_target",
                  "set_target_config", "store_config"):
        return Prim("persist", "store")
    if method in ("store_property", "set_deployment_completed"):
        return Prim("persist", "property")
    if method == "record" and "recorder" in recv:
        return Prim("persist", "wal")
    if method == "commit" and "ledger" in recv:
        return Prim("persist", "wal")
    if method in ("set", "apply") and (
            "persister" in recv or "backend" in recv):
        return Prim("persist", "persister")
    if method == "checkpoint" and "checkpoint" in recv:
        return Prim("persist", "checkpoint")
    if method in ("recursive_delete", "clear_all_data") and (
            "persister" in recv or "backend" in recv):
        return Prim("delete", "delete")
    if method in ("clear_task", "clear_property"):
        return Prim("delete", "delete")
    if method == "release" and "ledger" in recv:
        return Prim("delete", "delete")
    if method == "append" and "journal" in recv:
        return Prim("journal", "journal")
    if method == "flush" and "journal" in recv:
        return Prim("journal", "journal-flush")
    if method == "kill" and ("killer" in recv or "agent" in recv):
        return Prim("effect", "kill")
    if method in ("launch", "launch_one") and "agent" in recv:
        return Prim("effect", "launch")
    if method == "resign" and ("lease" in recv or "lock" in recv
                               or "ha" in recv):
        return Prim("effect", "lease-resign")
    if method == "send_response" and call.args:
        code = call.args[0]
        if isinstance(code, ast.Constant) and isinstance(code.value, int) \
                and 200 <= code.value < 300:
            return Prim("effect", "http-ack")
    return None


# -- key-token normalization (dur-replay-parity) ----------------------------


def _key_descriptor(expr: ast.AST) -> Tuple[str, str]:
    """Structural descriptor of a property-key expression, resolved to
    a canonical token later (once the whole tree's constants are
    harvested): ``("lit", s)`` exact literal, ``("sym", name)`` bare
    constant/attribute, ``("prefixlit", s)`` / ``("prefixsym", name)``
    constant-prefixed f-string or concat, ``("dynamic", "")``
    anything key-shaped only at runtime."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return ("lit", expr.value)
    if isinstance(expr, ast.Name):
        return ("sym", expr.id)
    if isinstance(expr, ast.Attribute):
        return ("sym", expr.attr)
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Add):
        kind, token = _key_descriptor(expr.left)
        if kind == "lit":
            return ("prefixlit", token)
        if kind == "sym":
            return ("prefixsym", token)
        return ("dynamic", "")
    if isinstance(expr, ast.JoinedStr) and expr.values:
        head = expr.values[0]
        if isinstance(head, ast.Constant) and isinstance(head.value, str):
            if len(expr.values) == 1:
                return ("lit", head.value)
            return ("prefixlit", head.value)
        if isinstance(head, ast.FormattedValue):
            kind, token = _key_descriptor(head.value)
            if kind == "sym":
                return ("prefixsym", token)
    return ("dynamic", "")


def _canonical_token(desc: Tuple[str, str],
                     consts: Dict[str, str]) -> Optional[Tuple[str, str]]:
    """Resolve a descriptor against the harvested constant table:
    ``("exact", s)`` or ``("prefix", s)`` with symbolic names replaced
    by their string values where known.  ``None`` = dynamic, exempt
    from parity."""
    kind, token = desc
    if kind == "lit":
        return ("exact", token)
    if kind == "prefixlit":
        return ("prefix", token)
    if kind == "sym":
        value = consts.get(token)
        # an unresolved symbol (function parameter, instance field set
        # at runtime) is a dynamic key: exempt, not a pseudo-token —
        # parity is a contract over the *static* key vocabulary
        return ("exact", value) if value is not None else None
    if kind == "prefixsym":
        value = consts.get(token)
        return ("prefix", value) if value is not None else None
    return None


def _tokens_match(writer: Tuple[str, str], reader: Tuple[str, str]) -> bool:
    wk, wv = writer
    rk, rv = reader
    if wk == "exact" and rk == "exact":
        return wv == rv
    if wk == "prefix" and rk == "prefix":
        return wv.startswith(rv) or rv.startswith(wv)
    exact, prefix = (wv, rv) if wk == "exact" else (rv, wv)
    return exact.startswith(prefix)


# -- program summary --------------------------------------------------------


@dataclass
class DurSummary:
    """What one function may do, transitively, to durable state and
    the outside world."""

    qualname: str
    file: str
    lineno: int
    persists: Set[str] = field(default_factory=set)   # persist kinds
    effects: Set[str] = field(default_factory=set)    # effect kinds
    # calls: names used for summary PROPAGATION — receiver-gated, so a
    # primitive-named method on the wrong receiver (outcome_tracker
    # .record) never unions a WAL summary into its caller.
    calls: Set[str] = field(default_factory=set)
    # edge_calls: EVERY method call, used only for call-graph
    # reachability (dur-unfenced-write).  Over-approximate on purpose
    # — reachability wants "could scheduler code get here", and
    # union-by-name is the safe answer to that question.
    edge_calls: Set[str] = field(default_factory=set)


@dataclass(frozen=True)
class PersistencePoint:
    """One statically discovered durability boundary."""

    file: str
    line: int
    end_line: int
    kind: str
    function: str

    def to_dict(self) -> Dict[str, object]:
        return {
            "file": self.file,
            "line": self.line,
            "end_line": self.end_line,
            "kind": self.kind,
            "function": self.function,
        }


@dataclass
class _KeySite:
    file: str
    line: int
    desc: Tuple[str, str]
    function: str


@dataclass
class _MutationSite:
    """A raw persister mutation call site (dur-unfenced-write)."""

    file: str
    line: int
    receiver: str
    method: str
    function: str


class DurProgram:
    """All function summaries + the registries the program-level rules
    read.  Call resolution is name-based, like spmdcheck: a simple
    name resolves to every scanned function carrying it, and the
    union is the safe over-approximation."""

    def __init__(self) -> None:
        self.functions: Dict[str, DurSummary] = {}
        self.by_name: Dict[str, Set[str]] = {}
        # NAME -> string value, module/class-level str constants
        self.consts: Dict[str, str] = {}
        self.points: List[PersistencePoint] = []
        self.prop_writes: List[_KeySite] = []
        self.prop_reads: List[_KeySite] = []
        self.journal_appends: List[Tuple[str, int, str]] = []
        self.journal_filters: List[Tuple[str, int, str]] = []
        self.journal_generic_reads: int = 0
        # appends whose kind is fully dynamic — each one could emit
        # any kind, so they satisfy every filter (no orphan teeth lost
        # in this tree: the one dynamic append carries a literal
        # default that IS harvested)
        self.journal_wildcard_appends: int = 0
        self.mutation_sites: List[_MutationSite] = []

    def add(self, summary: DurSummary) -> None:
        self.functions[summary.qualname] = summary
        simple = summary.qualname.rsplit(".", 1)[-1]
        self.by_name.setdefault(simple, set()).add(summary.qualname)

    def resolve(self, name: str) -> List[DurSummary]:
        if name in self.functions:
            return [self.functions[name]]
        keys = self.by_name.get(name.rsplit(".", 1)[-1], ())
        return [self.functions[k] for k in keys]

    def propagate(self) -> int:
        """Union callee persists/effects into callers to a fixpoint.
        Monotone: sets only ever grow, so the fixpoint exists and a
        re-run is a no-op (pinned by the property tests).  Returns the
        number of rounds taken."""
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
                        if not callee.persists <= summary.persists:
                            summary.persists |= callee.persists
                            changed = True
                        if not callee.effects <= summary.effects:
                            summary.effects |= callee.effects
                            changed = True
        return rounds

    def reachable_from(self, entry_keys: Iterable[str]) -> Set[str]:
        """Transitive closure over ``edge_calls`` from ``entry_keys``
        (the full call graph, including primitive-named methods the
        propagation graph deliberately gates out)."""
        seen: Set[str] = set()
        frontier = list(entry_keys)
        while frontier:
            key = frontier.pop()
            if key in seen:
                continue
            seen.add(key)
            summary = self.functions.get(key)
            if summary is None:
                continue
            for callee_name in summary.edge_calls:
                for callee in self.resolve(callee_name):
                    if callee.qualname not in seen:
                        frontier.append(callee.qualname)
        return seen


class _SummaryBuilder(ast.NodeVisitor):
    """One file's summaries, constants, points, and key registries.

    Nested functions fold into their enclosing def's summary (calling
    a factory may run the closure; over-approximation is the safe
    direction for ordering hazards)."""

    def __init__(self, rel: str, program: DurProgram):
        self.rel = rel
        self.program = program
        self._stack: List[DurSummary] = []
        self._class: List[str] = []
        self._pending_prefix_reads: List[_KeySite] = []
        self._saw_fetch_keys = False

    # constants -------------------------------------------------------

    def _harvest_const(self, node: ast.Assign) -> None:
        if not (isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)):
            return
        for target in node.targets:
            if isinstance(target, ast.Name):
                self.program.consts.setdefault(target.id, node.value.value)
            elif isinstance(target, ast.Attribute):
                self.program.consts.setdefault(target.attr, node.value.value)

    def visit_Assign(self, node: ast.Assign) -> None:
        if not self._stack:
            self._harvest_const(node)
        self.generic_visit(node)

    # functions -------------------------------------------------------

    def _enter(self, node) -> None:
        if self._stack:
            self._stack.append(self._stack[-1])  # fold into enclosing
        else:
            qual = ".".join(
                [self.rel[:-3].replace("/", ".")]
                + self._class + [node.name]
            )
            self._stack.append(DurSummary(qual, self.rel, node.lineno))
            # startswith-prefix reads are only property-key scans when
            # the SAME function iterates fetch_property_keys — buffer
            # them until we know (every other startswith is a URL or
            # path check, not a replay reader)
            self._pending_prefix_reads: List[_KeySite] = []
            self._saw_fetch_keys = False

    def _exit(self) -> None:
        summary = self._stack.pop()
        if not self._stack:
            self.program.add(summary)
            if self._saw_fetch_keys:
                self.program.prop_reads.extend(self._pending_prefix_reads)
            self._pending_prefix_reads = []
            self._saw_fetch_keys = False

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._enter(node)
        self.generic_visit(node)
        self._exit()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        for stmt in node.body:
            if isinstance(stmt, ast.Assign):
                self._harvest_const(stmt)
        self._class.append(node.name)
        self.generic_visit(node)
        self._class.pop()

    # calls -----------------------------------------------------------

    def _record_point(self, call: ast.Call, kind: str) -> None:
        self.program.points.append(PersistencePoint(
            self.rel, call.lineno,
            getattr(call, "end_lineno", call.lineno) or call.lineno,
            kind,
            self._stack[-1].qualname if self._stack else "<module>",
        ))

    def _journal_append_kind(self, node: ast.Call) -> None:
        kind_arg = node.args[0]
        if isinstance(kind_arg, ast.Constant) and \
                isinstance(kind_arg.value, str):
            self.program.journal_appends.append(
                (self.rel, node.lineno, kind_arg.value)
            )
            return
        # ``journal.append(event.get("kind", "alert"), ...)``: the
        # literal default is a kind this call genuinely emits
        if isinstance(kind_arg, ast.Call) and \
                _call_method(kind_arg) == "get" and \
                len(kind_arg.args) >= 2 and \
                isinstance(kind_arg.args[1], ast.Constant) and \
                isinstance(kind_arg.args[1].value, str):
            self.program.journal_appends.append(
                (self.rel, node.lineno, kind_arg.args[1].value)
            )
            return
        # any other dynamic kind could emit anything: wildcard
        self.program.journal_wildcard_appends += 1

    def visit_Call(self, node: ast.Call) -> None:
        func_name = (
            self._stack[-1].qualname if self._stack else "<module>"
        )
        prim = classify_call(node)
        method = _call_method(node)
        if self._stack and method:
            self._stack[-1].edge_calls.add(method)
        if prim is not None:
            if prim.category != "effect":
                # the point map is the durability-boundary contract
                # chaos consumes — effects are rule inputs, not points
                self._record_point(node, prim.kind)
            if self._stack:
                if prim.category == "persist":
                    self._stack[-1].persists.add(prim.kind)
                elif prim.category == "effect":
                    self._stack[-1].effects.add(prim.kind)
            if prim.kind == "persister" or (
                    prim.category == "delete"
                    and method in ("recursive_delete", "clear_all_data")):
                recv = _receiver_name(node)
                if "persister" in recv.lower() or "backend" in recv.lower():
                    self.program.mutation_sites.append(_MutationSite(
                        self.rel, node.lineno, recv, method, func_name,
                    ))
            if method == "store_property" and node.args:
                self.program.prop_writes.append(_KeySite(
                    self.rel, node.lineno,
                    _key_descriptor(node.args[0]), func_name,
                ))
                # clear_property is GC of a written key, neither a
                # replay reader nor a record writer for parity
            if prim.kind == "journal" and node.args:
                self._journal_append_kind(node)
        elif method == "fetch_property" and node.args:
            self.program.prop_reads.append(_KeySite(
                self.rel, node.lineno,
                _key_descriptor(node.args[0]), func_name,
            ))
        elif method == "fetch_property_keys":
            self._saw_fetch_keys = True
        elif method == "startswith" and node.args and self._stack:
            # ``key.startswith(PREFIX)`` over fetch_property_keys is
            # the prefix-scan replay reader (checkpoint prune, the
            # /v1/state file listing) — buffered; registered only if
            # this function turns out to iterate fetch_property_keys
            desc = _key_descriptor(node.args[0])
            if desc[0] != "dynamic":
                self._pending_prefix_reads.append(_KeySite(
                    self.rel, node.lineno,
                    (
                        "prefixlit" if desc[0] == "lit" else "prefixsym",
                        desc[1],
                    ),
                    func_name,
                ))
        elif method == "events":
            kinds_arg = None
            for kw in node.keywords:
                if kw.arg == "kinds":
                    kinds_arg = kw.value
            if kinds_arg is None:
                self.program.journal_generic_reads += 1
            elif isinstance(kinds_arg, (ast.Tuple, ast.List)):
                for elt in kinds_arg.elts:
                    if isinstance(elt, ast.Constant) and \
                            isinstance(elt.value, str):
                        self.program.journal_filters.append(
                            (self.rel, node.lineno, elt.value)
                        )
        elif method == "open" or (isinstance(node.func, ast.Name)
                                  and node.func.id == "open"):
            if _open_write_mode(node):
                self._record_point(node, "file")
        if self._stack and prim is None:
            if method and method not in _PRIMITIVE_METHODS:
                self._stack[-1].calls.add(method)
        self.generic_visit(node)


def _open_write_mode(call: ast.Call) -> bool:
    """True for ``open(..., "w"/"wb"/...)`` (create/truncate modes;
    reads and r+ replay-side patching are out of scope)."""
    mode: Optional[ast.AST] = None
    if len(call.args) >= 2:
        mode = call.args[1]
    for kw in call.keywords:
        if kw.arg == "mode":
            mode = kw.value
    if mode is None:
        return False
    return (
        isinstance(mode, ast.Constant)
        and isinstance(mode.value, str)
        and "w" in mode.value
    )


def build_summary(files: Sequence[Tuple[str, str, str]]) -> DurProgram:
    program = DurProgram()
    for _, rel, source in files:
        try:
            tree = ast.parse(source)
        except SyntaxError:
            continue
        _SummaryBuilder(rel, program).visit(tree)
    program.propagate()
    return program


# -- suppression handling ---------------------------------------------------


class DurSuppressions:
    """Standard sdklint ``disable`` grammar plus durcheck's
    rationale-required ``# durcheck: <rule>=<reason>`` annotation."""

    def __init__(self, lines: Sequence[str]):
        self._std = Suppressions(lines)
        self.annotated: Dict[int, Set[str]] = {}
        for i, text in enumerate(lines, start=1):
            match = _DUR_ANNOT_RE.search(text)
            if match:
                self.annotated.setdefault(i, set()).add(match.group("rule"))

    def covers(self, finding: Finding) -> bool:
        if self._std.covers(finding):
            return True
        for lineno in (finding.line, finding.line - 1):
            if finding.rule in self.annotated.get(lineno, ()):
                return True
        return False


# -- flow walk (dur-effect-before-wal) --------------------------------------


def _calls_in_order(node: ast.AST) -> List[ast.Call]:
    calls = [n for n in ast.walk(node) if isinstance(n, ast.Call)]
    calls.sort(key=lambda c: (c.lineno, c.col_offset))
    return calls


class _EffectFlow:
    """May-analysis of effect kinds reaching each statement of one
    function: effects union at joins, a terminated branch (return/
    raise/break/continue) does not flow past its join, and loop
    bodies are walked once (no back-edges — see the rule docstring).
    Emits at most one finding per function: the FIRST intent-class
    persist reachable after an effect."""

    def __init__(self, program: DurProgram, rel: str, funcname: str):
        self.program = program
        self.rel = rel
        self.funcname = funcname
        self.finding: Optional[Finding] = None

    def run(self, func: ast.AST) -> Optional[Finding]:
        self._block(func.body, set())
        return self.finding

    # statement dispatch ----------------------------------------------

    def _block(self, stmts, effects: Set[str]) -> Tuple[Set[str], bool]:
        for stmt in stmts:
            effects, terminated = self._stmt(stmt, effects)
            if terminated:
                return effects, True
        return effects, False

    def _stmt(self, stmt, effects: Set[str]) -> Tuple[Set[str], bool]:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return effects, False  # nested defs don't execute here
        if isinstance(stmt, (ast.Return, ast.Raise)):
            self._scan(stmt, effects)
            return effects, True
        if isinstance(stmt, (ast.Break, ast.Continue)):
            return effects, True
        if isinstance(stmt, ast.If):
            self._scan(stmt.test, effects)
            body_eff, body_term = self._block(stmt.body, set(effects))
            else_eff, else_term = self._block(stmt.orelse, set(effects))
            outs = []
            if not body_term:
                outs.append(body_eff)
            if not else_term:
                outs.append(else_eff)
            if not outs:
                return effects, True
            return set().union(*outs), False
        if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
            head = stmt.iter if isinstance(stmt, (ast.For, ast.AsyncFor)) \
                else stmt.test
            self._scan(head, effects)
            body_eff, _ = self._block(stmt.body, set(effects))
            else_eff, _ = self._block(stmt.orelse,
                                      effects | body_eff)
            return effects | body_eff | else_eff, False
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._scan(item.context_expr, effects)
            return self._block(stmt.body, effects)
        if isinstance(stmt, ast.Try):
            body_eff, body_term = self._block(stmt.body, set(effects))
            # a handler can enter from anywhere in the body
            entry = effects | body_eff
            outs = [] if body_term else [body_eff]
            for handler in stmt.handlers:
                h_eff, h_term = self._block(handler.body, set(entry))
                if not h_term:
                    outs.append(h_eff)
            if stmt.orelse and not body_term:
                o_eff, o_term = self._block(stmt.orelse, set(body_eff))
                outs = [e for e in outs if e is not body_eff]
                if not o_term:
                    outs.append(o_eff)
            joined = set().union(*outs) if outs else set(entry)
            if stmt.finalbody:
                f_eff, f_term = self._block(stmt.finalbody,
                                            joined | entry)
                if f_term:
                    return f_eff, True
                joined = f_eff
            return joined, not outs and not stmt.finalbody
        self._scan(stmt, effects)
        return effects, False

    # call scan -------------------------------------------------------

    def _scan(self, node: ast.AST, effects: Set[str]) -> None:
        for call in _calls_in_order(node):
            prim = classify_call(call)
            method = _call_method(call)
            if prim is not None:
                if prim.category == "persist" and \
                        prim.kind in TRIGGER_KINDS and effects:
                    self._emit(call, effects, method)
                elif prim.category == "effect":
                    effects.add(prim.kind)
                continue
            if not method or method in _PRIMITIVE_METHODS:
                continue  # receiver-gated primitive name: inert
            # accumulate the callee's transitive effects at the call
            # site; its own persist-vs-effect ordering is checked in
            # the callee's body, where the flow is precise — flagging
            # "transitively persists" call sites here drowns the
            # signal in union-by-name resolution noise
            for callee in self.program.resolve(method):
                effects |= callee.effects

    def _emit(self, call: ast.Call, effects: Set[str],
              method: str) -> None:
        if self.finding is not None:
            return
        self.finding = Finding(
            self.rel, call.lineno, "dur-effect-before-wal",
            f"{self.funcname}() reaches {method}(...) AFTER external "
            f"effect(s) {sorted(effects)} on some path — a crash "
            "between the effect and this intent persist leaves state "
            "the successor cannot replay; persist intent first, or "
            "annotate why the effect is recovery-covered",
        )


# -- rules ------------------------------------------------------------------


class DurRule:
    id = ""
    description = ""


class EffectBeforeWalRule(DurRule):
    """An external effect (agent launch/kill, HTTP 2xx ack, lease
    resign) occurs before an intent-class persist (launch WAL,
    task-record store, raw persister write) later in the same flow.
    The WAL discipline (DefaultScheduler.java:454: reservations and
    task infos durable BEFORE the agent sees a launch) demands the
    reverse order: a crash in the effect→persist window leaves an
    externally visible action the successor's replay cannot derive.
    May-analysis over branches (union at joins, so a persist on only
    one branch never masks the finding); loop bodies single-pass.
    Deliberate orderings (the kill-before-relaunch-WAL in
    _process_candidates, which recovery covers) carry a
    ``# durcheck: dur-effect-before-wal=<reason>`` annotation."""

    id = "dur-effect-before-wal"
    description = "external effect reachable before its intent persist"

    def check_file(self, rel: str, tree: ast.AST,
                   program: DurProgram) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                flow = _EffectFlow(program, rel, node.name)
                finding = flow.run(node)
                if finding is not None:
                    out.append(finding)
        return out


class ReplayParityRule(DurRule):
    """Every property key written must have a replay reader (exact
    fetch, symbolic-prefix fetch, or a prefix scan over
    fetch_property_keys), and every reader must have a writer: a
    dead record is store debt forever, an orphan reader a replay
    path that can never fire.  Journal event kinds get the same
    treatment — a kind-filtered ``events(kinds=...)`` query for a
    kind nothing appends is an orphan reader (dead-record parity for
    journal kinds is satisfied by any generic ``events()`` consumer;
    the journal is a telemetry ring, replayed wholesale).  Fully
    dynamic keys (the /v1/state property passthrough) are exempt —
    parity is a static contract over the key vocabulary."""

    id = "dur-replay-parity"
    description = "persisted record kind without a replay reader (or vice versa)"

    def check_program(self, program: DurProgram) -> List[Finding]:
        out: List[Finding] = []
        consts = program.consts
        writers = [
            (site, _canonical_token(site.desc, consts))
            for site in program.prop_writes
        ]
        readers = [
            (site, _canonical_token(site.desc, consts))
            for site in program.prop_reads
        ]
        for site, token in writers:
            if token is None:
                continue
            if not any(
                rt is not None and _tokens_match(token, rt)
                for _, rt in readers
            ):
                out.append(Finding(
                    site.file, site.line, self.id,
                    f"property key {token[1]!r} is written in "
                    f"{site.function}() but nothing ever reads it "
                    "back — a dead record the store carries forever; "
                    "add the rehydrate/replay reader or drop the write",
                ))
        for site, token in readers:
            if token is None:
                continue
            if not any(
                wt is not None and _tokens_match(wt, token)
                for _, wt in writers
            ):
                out.append(Finding(
                    site.file, site.line, self.id,
                    f"property key {token[1]!r} is read in "
                    f"{site.function}() but nothing ever writes it — "
                    "an orphan replay path (typo'd key, or a record "
                    "kind renamed on only one side)",
                ))
        appended = {kind for _, _, kind in program.journal_appends}
        for file, line, kind in program.journal_filters:
            if program.journal_wildcard_appends and kind not in appended:
                continue  # a dynamic-kind append could emit anything
            if kind not in appended:
                out.append(Finding(
                    file, line, self.id,
                    f"journal query filters on kind {kind!r} but "
                    "nothing ever appends that kind — the filter can "
                    "never match",
                ))
        if not program.journal_generic_reads:
            for file, line, kind in program.journal_appends:
                if not any(k == kind
                           for _, _, k in program.journal_filters):
                    out.append(Finding(
                        file, line, self.id,
                        f"journal kind {kind!r} is appended but no "
                        "events() consumer exists in the tree",
                    ))
        return out


class UnfencedWriteRule(DurRule):
    """Flow-sensitive upgrade of sdklint's ``lease-gated-mutation``:
    a raw persister/backend mutation in a module OUTSIDE that lint's
    scoped directories that is reachable from scheduler-path code
    over the call graph.  The single-file lint owns the direct sites
    in its scope (this rule skips them — one site is never reported
    by both); this rule catches the helper three calls away.  The
    sanctioned store layer (state/, storage/), the fence itself
    (ha/election.py), and multi/store.py are exempt — raw mutations
    are the layer those modules ARE."""

    id = "dur-unfenced-write"
    description = "scheduler-reachable raw persister mutation outside the fenced store layer"

    _EXEMPT_PREFIXES = (
        "dcos_commons_tpu_torch/state/",
        "dcos_commons_tpu_torch/storage/",
    )
    _EXEMPT_FILES = (
        "dcos_commons_tpu_torch/ha/election.py",
        "dcos_commons_tpu_torch/multi/store.py",
    )

    def check_program(self, program: DurProgram) -> List[Finding]:
        from dcos_commons_tpu_torch.analysis.rules import LeaseGatedMutationRule

        lint_scope = LeaseGatedMutationRule._SCOPED
        lint_exempt = LeaseGatedMutationRule._EXEMPT
        entries = [
            key for key, summary in program.functions.items()
            if any(summary.file.startswith(p) for p in lint_scope)
            and summary.file not in lint_exempt
        ]
        reachable = program.reachable_from(entries)
        out: List[Finding] = []
        for site in program.mutation_sites:
            if any(site.file.startswith(p) for p in lint_scope) \
                    and site.file not in lint_exempt:
                continue  # lease-gated-mutation owns this site
            if any(site.file.startswith(p)
                   for p in self._EXEMPT_PREFIXES):
                continue
            if site.file in self._EXEMPT_FILES:
                continue
            if site.function not in reachable:
                continue
            out.append(Finding(
                site.file, site.line, self.id,
                f"raw {site.receiver}.{site.method}(...) in "
                f"{site.function.rsplit('.', 1)[-1]}() is reachable "
                "from scheduler-path code but lives outside the "
                "fenced store layer — a write here can bypass the "
                "leader fence on failover; route it through a store "
                "class or annotate why the injected persister is "
                "already fenced",
            ))
        return out


class NonatomicPairRule(DurRule):
    """Two coupled store keys — same derived base path, different
    leaves (the task info/status pair is the canonical case) —
    written by separate single-key ``set`` calls with no generation
    bump between them and no single ``apply`` transaction.  A crash
    between the two writes leaves a torn record: an info whose
    status belongs to the previous launch, exactly what
    ``StateStore.store_launch`` batches one ``apply`` to prevent."""

    id = "dur-nonatomic-pair"
    description = "coupled store keys mutated without a batch or generation bump"

    @staticmethod
    def _base_and_leaf(expr: ast.AST) -> Optional[Tuple[str, str]]:
        """(base, leaf) of a path expression, or None when unshaped.
        ``self._task_path(name, "info")`` -> ("_task_path(name)",
        "info"); an f-string/concat splits at its first dynamic part."""
        if isinstance(expr, ast.Call):
            method = _call_method(expr)
            if not method or not expr.args:
                return None
            first = ast.dump(expr.args[0])
            leaf = ""
            if len(expr.args) >= 2:
                leaf_node = expr.args[1]
                leaf = (
                    leaf_node.value
                    if isinstance(leaf_node, ast.Constant)
                    else ast.dump(leaf_node)
                )
            return (f"{method}({first})", str(leaf))
        desc = _key_descriptor(expr)
        if desc[0] in ("prefixlit", "prefixsym"):
            return (desc[1], ast.dump(expr))
        return None

    def check_file(self, rel: str, tree: ast.AST,
                   program: DurProgram) -> List[Finding]:
        out: List[Finding] = []
        for func in ast.walk(tree):
            if not isinstance(func, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            sets: List[Tuple[int, str, str]] = []
            bumps: List[int] = []
            for call in _calls_in_order(func):
                method = _call_method(call)
                if "generation" in method or "bump" in method:
                    bumps.append(call.lineno)
                    continue
                prim = classify_call(call)
                if prim is None or prim.kind != "persister" \
                        or method != "set" or not call.args:
                    continue
                shaped = self._base_and_leaf(call.args[0])
                if shaped is not None:
                    sets.append((call.lineno,) + shaped)
            for i, (line_a, base_a, leaf_a) in enumerate(sets):
                for line_b, base_b, leaf_b in sets[i + 1:]:
                    if base_a != base_b or leaf_a == leaf_b:
                        continue
                    if any(line_a < b < line_b for b in bumps):
                        continue
                    out.append(Finding(
                        rel, line_b, self.id,
                        f"{func.name}() writes coupled keys "
                        f"<base>/{leaf_a} (line {line_a}) and "
                        f"<base>/{leaf_b} as separate set() calls — "
                        "a crash between them tears the record; "
                        "batch both into one apply([...]) or bump a "
                        "generation between the writes",
                    ))
        return out


class FileDisciplineRule(DurRule):
    """A file opened for writing without BOTH an ``os.fsync`` and an
    ``os.replace``/``os.rename`` in the same function.  The
    tmp+fsync+rename pattern (``storage/file_persister.compact`` is
    the exemplar) is the only way a crashed writer leaves either the
    old file or the new one — rename-only leaves readers
    partial-free but loses the write on power failure; fsync-only
    leaves a torn file under the final name.  Telemetry mirrors that
    accept loss annotate with ``# durcheck: dur-file-discipline=``."""

    id = "dur-file-discipline"
    description = "file persist without the tmp+fsync+rename pattern"

    def check_file(self, rel: str, tree: ast.AST,
                   program: DurProgram) -> List[Finding]:
        out: List[Finding] = []
        for func in ast.walk(tree):
            if not isinstance(func, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            opens: List[ast.Call] = []
            has_fsync = False
            has_rename = False
            for call in _calls_in_order(func):
                method = _call_method(call)
                if method == "open" and _open_write_mode(call):
                    opens.append(call)
                elif method == "fsync":
                    has_fsync = True
                elif method in ("replace", "rename"):
                    has_rename = True
            if not opens or (has_fsync and has_rename):
                continue
            missing = []
            if not has_fsync:
                missing.append("os.fsync before the rename")
            if not has_rename:
                missing.append("a tmp-file os.replace")
            out.append(Finding(
                rel, opens[0].lineno, self.id,
                f"{func.name}() writes a file without "
                f"{' or '.join(missing)} — a crash mid-write leaves "
                "a torn or lost file; use the tmp+fsync+rename "
                "pattern (storage/file_persister.compact)",
            ))
        return out


def all_dur_rules() -> List[DurRule]:
    return [
        EffectBeforeWalRule(),
        ReplayParityRule(),
        UnfencedWriteRule(),
        NonatomicPairRule(),
        FileDisciplineRule(),
    ]


def dur_rule_catalog() -> str:
    blocks = []
    for rule in all_dur_rules():
        doc = " ".join((rule.__doc__ or "").split())
        blocks.append(f"{rule.id}: {rule.description}\n    {doc}")
    return "\n\n".join(blocks)


# -- driver -----------------------------------------------------------------


@dataclass
class DurResult(LintResult):
    """LintResult plus the persistence-point map and per-rule trend
    counts (fresh + suppressed — suppressions document debt, they
    don't hide it from the trend line)."""

    persistence_points: List[PersistencePoint] = field(
        default_factory=list
    )
    per_rule: Dict[str, int] = field(default_factory=dict)


def _collect_files(root: str,
                   subdirs: Sequence[str]) -> List[Tuple[str, str, str]]:
    out = []
    for sub in subdirs:
        top = os.path.join(root, sub)
        if os.path.isfile(top):
            with open(top, "r", encoding="utf-8") as f:
                out.append((top, sub, f.read()))
            continue
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
                  rules: Optional[Sequence[DurRule]] = None) -> DurResult:
    """Run durcheck over pre-read (path, rel, source) triples."""
    program = build_summary(files)
    active = list(rules) if rules is not None else all_dur_rules()
    result = DurResult()
    result.persistence_points = sorted(
        program.points, key=lambda p: (p.file, p.line, p.kind)
    )
    suppressions: Dict[str, DurSuppressions] = {}
    trees: Dict[str, ast.AST] = {}
    for _, rel, source in files:
        try:
            trees[rel] = ast.parse(source)
        except SyntaxError:
            continue
        result.files_checked += 1
        suppressions[rel] = DurSuppressions(source.splitlines())

    def sift(findings: List[Finding]) -> None:
        for finding in findings:
            result.per_rule[finding.rule] = \
                result.per_rule.get(finding.rule, 0) + 1
            sup = suppressions.get(finding.file)
            if sup is not None and sup.covers(finding):
                result.suppressed.append(finding)
            else:
                result.findings.append(finding)

    for rule in active:
        check_file = getattr(rule, "check_file", None)
        if check_file is not None:
            for rel, tree in trees.items():
                sift(check_file(rel, tree, program))
        check_program = getattr(rule, "check_program", None)
        if check_program is not None:
            sift(check_program(program))
    result.findings.sort(key=lambda f: (f.file, f.line, f.rule))
    return result


def analyze_tree(root: str,
                 subdirs: Sequence[str] = DUR_SUBDIRS) -> DurResult:
    """Run durcheck over the persistence-relevant subtrees."""
    return analyze_paths(_collect_files(root, subdirs))


@lru_cache(maxsize=4)
def _point_map_cached(root: str,
                      subdirs: Tuple[str, ...]) -> Tuple[Dict, ...]:
    program = build_summary(_collect_files(root, subdirs))
    return tuple(
        p.to_dict()
        for p in sorted(program.points,
                        key=lambda p: (p.file, p.line, p.kind))
    )


def persistence_point_map(
    root: Optional[str] = None,
    subdirs: Sequence[str] = DUR_SUBDIRS,
) -> List[Dict[str, object]]:
    """The persistence-point map as plain dicts — the contract
    ``analysis dur --points`` dumps and ``testing/chaos.py`` consumes
    to auto-derive crash-injection points.  Cached per (root,
    subdirs): every chaos run in a test session shares one AST pass
    (the ``shared_write_map`` idiom from racecheck)."""
    if root is None:
        package_dir = os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))
        )
        root = os.path.dirname(package_dir)
    return list(_point_map_cached(root, tuple(subdirs)))

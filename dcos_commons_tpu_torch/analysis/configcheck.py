"""configcheck: whole-pipeline env/config contract analysis (port of
``dcos_commons_tpu/analysis/configcheck.py``: the harvest, the joins
and the five rules unchanged; the reads are the port's package, the
YAML side its ``frameworks/``, the launch path its ``offer/evaluate.py``
and the pod's ``gpu:`` block, and ``--docs`` writes the port's own
``docs/config-reference-torch.md``).

The SDK's config contract is a PIPELINE, not a file: package options
(``options.json``) render to an env map (``tools/options.py``), the
env map interpolates the service YAML's ``{{VAR:-default}}`` templates
(``specification/yaml_spec.py``), the rendered per-task ``env:`` block
rides the launch path into the worker process
(``offer/evaluate.py``), and the worker — or a scheduler-side consumer
reading the task's env, like the health plane's SLO watcher — finally
casts the string to a typed knob.  Each hop has its own defaulting
rule, so the same knob can hold FOUR different defaults (options,
template, YAML-only, in-code) that silently disagree: the
``microbatch_window_ms`` 5-vs-0 drift and the ``TPU_CHIPS_PER_HOST``
leak were both this bug class.  configcheck rebuilds the whole flow
graph statically and cross-checks every hop.

The graph has three sides:

(a) **Reads** — an AST pass over ``dcos_commons_tpu_torch/`` (whose
    ``frameworks/`` holds the workers) harvests every env read with its
    inferred cast
    (the surrounding ``int()``/``float()``/bool-ish membership test /
    ``json.loads``) and in-code default (literal ``.get`` second arg
    or the ``... or <literal>`` fallback).  A read is any
    ``.get("X")``/``["X"]`` on ``os.environ`` or on a receiver named
    like an env-carrying parameter (``env``/``_env``/``task_env``) —
    which is how the blessed contract helpers
    (``models.config_from_env``, ``serve/paging.paged_config_from_env``,
    ``parallel/mesh.derive``, ``SchedulerConfig.from_env``) are
    modeled: a function whose env-like *parameter* is read becomes a
    helper, helpers passing that parameter to other helpers inherit
    their reads transitively, and a worker calling a helper with
    ``os.environ`` inherits the closure.  Files that read env keys
    *dynamically* (``env.get(knob)`` over a table, like the SLO
    watcher's SIGNALS rows) contribute their UPPER_SNAKE table
    constants as indirect reads.

(b) **Sets** — every ``env:`` key, ``{{VAR:-default}}`` template and
    ``{{#VAR}}`` section of each ``dcos_commons_tpu_torch/frameworks/*.yml``,
    rendered with
    the framework's real ``options.json`` defaults via the real
    renderer, joined per pod/task to the worker script its ``cmd``
    runs (shardcheck's script-basename keying, widened to every
    ``.py`` shipped in the framework dir).  The launch path's own
    injections (``offer/evaluate.py`` ``ENV_*`` contract, with
    ``CUDA_VISIBLE_DEVICES``, ``GpuSpec.mesh_env()``, port
    ``env-key``s, inline ``VAR=`` cmd
    assignments, the ambient sandbox vars) count as provided.

(c) **Options** — every ``options.json`` option and the env name it
    renders under.

Rules (YAML/inline-suppressible via ``# sdklint: disable=<rule>``;
options.json findings suppress via the schema's ``x-sdklint-disable``
list since JSON carries no comments):

- ``config-undeclared-read``   a joined worker script reads a var with
  NO default path at all (``env["X"]``) that neither the task env nor
  the launch path provides — a guaranteed KeyError at task runtime.
- ``config-dead-var``          a YAML ``env:`` key that nothing in the
  tree reads (directly, via a helper, or via a dynamic table).
- ``config-type-mismatch``     a rendered YAML value or a template
  default the read-site cast cannot parse (``int("abc")`` at launch).
- ``config-default-drift``     an in-code or template default that
  disagrees with the options.json default for the same env name — the
  microbatch bug class: which default applies depends on HOW you
  deploy.
- ``config-options-orphan``    an options.json option whose env name
  renders in no YAML of its framework: dead operator surface.

``--json`` emits trend keys ``config.env_vars`` (distinct vars in the
graph), ``config.flows`` (joined YAML-env-to-worker-read edges) and
``config.per_rule`` so the bench trajectory tracks coverage.  The
``--docs`` flag renders the graph to ``docs/config-reference-torch.md``
(``docs/config-reference.md`` is the reference analyzer's).
"""

from __future__ import annotations

import ast
import json as _json
import os
import re
from dataclasses import dataclass, field, replace
from typing import (
    Any,
    Dict,
    FrozenSet,
    List,
    Optional,
    Sequence,
    Set,
    Tuple,
)

from dcos_commons_tpu_torch.analysis.linter import (
    Finding,
    LintResult,
    Suppressions,
)

_VAR_RE = re.compile(r"^[A-Z][A-Z0-9_]*$")
# receivers whose .get("X")/["X"] counts as an env read: the process
# env itself plus the names env-carrying parameters conventionally
# take across the tree (contract helpers, scheduler-side task-env
# readers like ``info.env.get``)
_ENV_RECEIVERS = frozenset({"environ", "env", "_env", "task_env"})
# vars every task inherits outside the YAML env block: the agent's
# sandbox contract plus ambient toolchain switches the deploy wrapper
# exports (developer-guide §3)
_AMBIENT_VARS = frozenset({
    "SANDBOX", "REPO_ROOT", "JAX_PLATFORMS", "XLA_FLAGS",
    "PATH", "HOME", "PYTHONPATH",
})
# inline `VAR=value` assignments at the front of a task cmd
# the port's framework, and the file ``--docs`` writes (never the
# reference analyzer's docs/config-reference.md)
FRAMEWORK_DIR = os.path.join("dcos_commons_tpu_torch", "frameworks")
CONFIG_REFERENCE = os.path.join("docs", "config-reference-torch.md")
_CMD_ASSIGN_RE = re.compile(r"\b([A-Z][A-Z0-9_]*)=")
_SECTION_TAG_RE = re.compile(r"\{\{[#^/]([A-Za-z0-9_]+)\}\}")


@dataclass(frozen=True)
class EnvRead:
    """One harvested env read: where, how it's cast, what it defaults
    to when the var is absent."""

    var: str
    file: str                   # repo-relative posix path
    line: int
    cast: str = "str"           # int | float | bool | json | str
    default: Optional[str] = None
    # default applied via ``... or <literal>``: an EMPTY string also
    # falls back (the `{{VAR:-}}` template idiom pairs with this)
    or_default: bool = False
    # subscript read with no default path at all (env["X"])
    required: bool = False
    via: str = "direct"         # direct | helper:<name> | indirect
    comment: str = ""           # adjacent comment, for --docs


@dataclass
class _FuncInfo:
    """Per-function facts feeding the helper-closure resolution."""

    name: str
    args: FrozenSet[str]
    # env reads whose receiver is one of this function's own params
    param_reads: List[EnvRead] = field(default_factory=list)
    # (callee terminal name, params passed through) pass edges
    passes: List[Tuple[str, FrozenSet[str]]] = field(default_factory=list)


@dataclass
class FileHarvest:
    """Everything the AST pass learned about one .py file."""

    rel: str
    lines: List[str] = field(default_factory=list)
    suppressions: Suppressions = field(
        default_factory=lambda: Suppressions([])
    )
    reads: List[EnvRead] = field(default_factory=list)
    funcs: List[_FuncInfo] = field(default_factory=list)
    # helper names this file calls with a concrete env (os.environ)
    helper_calls: Set[str] = field(default_factory=set)
    # file contains a dynamic read (env.get(<name>)) — its UPPER_SNAKE
    # table constants were harvested as indirect reads
    dynamic: bool = False


def _terminal(node) -> str:
    """Terminal name of a dotted expression: os.environ -> 'environ',
    info.env -> 'env', env -> 'env'."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _unwrap(node):
    """See through ``(env or {})``-style guards to the receiver."""
    while isinstance(node, ast.BoolOp) and node.values:
        node = node.values[0]
    return node


def _const_str(value) -> Optional[str]:
    """A literal default as the string the env would carry."""
    if value is None:
        return None
    if isinstance(value, bool):
        return "true" if value else "false"
    return str(value)


def _infer_cast(node, parents) -> str:
    """The cast the read site applies: the enclosing int()/float()/
    bool()/json.loads() call, or a ``(not) in (...)`` membership test
    (the tree's bool idiom).  Climbs through ``or``-defaults."""
    cur = node
    for _ in range(5):
        par = parents.get(cur)
        if par is None:
            return "str"
        if isinstance(par, ast.BoolOp):
            cur = par
            continue
        if isinstance(par, ast.Call):
            if cur in par.args:
                name = _terminal(par.func)
                if name in ("int", "float", "bool"):
                    return name
                if name == "loads":
                    return "json"
            return "str"
        if isinstance(par, ast.Compare):
            if par.left is cur and par.ops and isinstance(
                par.ops[0], (ast.In, ast.NotIn)
            ):
                return "bool"
            return "str"
        return "str"
    return "str"


def _adjacent_comment(lines: Sequence[str], lineno: int) -> str:
    """The trailing comment on the read line, else the contiguous
    comment block directly above — the --docs description source."""
    if 1 <= lineno <= len(lines):
        text = lines[lineno - 1]
        if "#" in text:
            frag = text.split("#", 1)[1].strip()
            if frag and "sdklint:" not in frag:
                return frag
    out: List[str] = []
    i = lineno - 2
    while i >= 0 and lines[i].strip().startswith("#"):
        frag = lines[i].strip().lstrip("#").strip()
        if frag and "sdklint:" not in frag:
            out.insert(0, frag)
        i -= 1
    return " ".join(out)


def _harvest_file(path: str, rel: str) -> FileHarvest:
    with open(path, "r", encoding="utf-8") as f:
        source = f.read()
    lines = source.splitlines()
    fh = FileHarvest(
        rel=rel, lines=lines, suppressions=Suppressions(lines)
    )
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError:
        # the build gate (py_compile) owns syntax errors
        return fh

    parents: Dict[ast.AST, ast.AST] = {}
    for parent in ast.walk(tree):
        for child in ast.iter_child_nodes(parent):
            parents[child] = parent

    # function spans, innermost-wins lookup by line
    spans: List[Tuple[int, int, _FuncInfo]] = []
    infos: Dict[int, _FuncInfo] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            a = node.args
            names = {x.arg for x in a.args + a.posonlyargs + a.kwonlyargs}
            if a.vararg:
                names.add(a.vararg.arg)
            if a.kwarg:
                names.add(a.kwarg.arg)
            info = _FuncInfo(name=node.name, args=frozenset(names))
            infos[id(node)] = info
            fh.funcs.append(info)
            spans.append(
                (node.lineno, node.end_lineno or node.lineno, info)
            )

    def enclosing(line: int) -> Optional[_FuncInfo]:
        best: Optional[Tuple[int, _FuncInfo]] = None
        for lo, hi, info in spans:
            if lo <= line <= hi and (best is None or lo > best[0]):
                best = (lo, info)
        return best[1] if best else None

    def add_read(node, var: str, receiver: str, cast: str,
                 default: Optional[str], or_default: bool,
                 required: bool) -> None:
        read = EnvRead(
            var=var, file=rel, line=node.lineno, cast=cast,
            default=default, or_default=or_default, required=required,
            comment=_adjacent_comment(lines, node.lineno),
        )
        fh.reads.append(read)
        enc = enclosing(node.lineno)
        if enc is not None and receiver in enc.args:
            enc.param_reads.append(read)

    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            fname = _terminal(node.func)
            recv = ""
            if isinstance(node.func, ast.Attribute):
                recv = _terminal(_unwrap(node.func.value))
            is_get = fname == "get" and recv in _ENV_RECEIVERS
            is_getenv = fname == "getenv"
            if is_get or is_getenv:
                receiver = recv if is_get else "environ"
                arg0 = node.args[0] if node.args else None
                if isinstance(arg0, ast.Constant) and isinstance(
                    arg0.value, str
                ) and _VAR_RE.match(arg0.value):
                    default, or_default = None, False
                    if len(node.args) >= 2:
                        if isinstance(node.args[1], ast.Constant):
                            default = _const_str(node.args[1].value)
                    else:
                        par = parents.get(node)
                        if isinstance(par, ast.BoolOp) and isinstance(
                            par.op, ast.Or
                        ) and par.values and par.values[0] is node \
                                and len(par.values) > 1 and isinstance(
                                    par.values[1], ast.Constant):
                            default = _const_str(par.values[1].value)
                            or_default = default is not None
                    add_read(
                        node, arg0.value, receiver,
                        _infer_cast(node, parents), default,
                        or_default, required=False,
                    )
                elif isinstance(arg0, ast.Name) and is_get:
                    # table-driven read (SIGNALS rows): the file's
                    # UPPER_SNAKE tuple constants become indirect reads
                    fh.dynamic = True
            elif fname and fname != "get":
                # helper call / pass-through edge detection
                envish: List[str] = []
                args = list(node.args) + [
                    kw.value for kw in node.keywords
                ]
                for arg in args:
                    u = _unwrap(arg)
                    if isinstance(u, ast.Attribute) \
                            and u.attr == "environ":
                        envish.append("__environ__")
                    elif isinstance(u, ast.Name) \
                            and u.id in _ENV_RECEIVERS:
                        envish.append(u.id)
                if envish:
                    enc = enclosing(node.lineno)
                    enc_args = enc.args if enc else frozenset()
                    passed = frozenset(
                        e for e in envish if e in enc_args
                    )
                    if passed and enc is not None:
                        enc.passes.append((fname, passed))
                    if "__environ__" in envish or any(
                        e not in enc_args for e in envish
                        if e != "__environ__"
                    ):
                        fh.helper_calls.add(fname)
        elif isinstance(node, ast.Subscript) and isinstance(
            node.ctx, ast.Load
        ):
            recv = _terminal(_unwrap(node.value))
            if recv in _ENV_RECEIVERS and isinstance(
                node.slice, ast.Constant
            ) and isinstance(node.slice.value, str) \
                    and _VAR_RE.match(node.slice.value):
                add_read(
                    node, node.slice.value, recv,
                    _infer_cast(node, parents), None, False,
                    required=True,
                )

    if fh.dynamic:
        for node in ast.walk(tree):
            if isinstance(node, (ast.Tuple, ast.List)):
                for elt in node.elts:
                    if isinstance(elt, ast.Constant) and isinstance(
                        elt.value, str
                    ) and "_" in elt.value \
                            and _VAR_RE.match(elt.value):
                        fh.reads.append(EnvRead(
                            var=elt.value, file=rel,
                            line=elt.lineno, via="indirect",
                            comment=_adjacent_comment(
                                lines, elt.lineno
                            ),
                        ))
    return fh


@dataclass
class Harvest:
    """The resolved read side of the flow graph."""

    files: Dict[str, FileHarvest] = field(default_factory=dict)
    # helper name -> reads reachable through its env parameter
    helpers: Dict[str, List[EnvRead]] = field(default_factory=dict)

    def reads_by_var(self) -> Dict[str, List[EnvRead]]:
        out: Dict[str, List[EnvRead]] = {}
        for rel in sorted(self.files):
            for read in self.files[rel].reads:
                out.setdefault(read.var, []).append(read)
        return out

    def vars_read(self) -> Set[str]:
        return {
            read.var
            for fh in self.files.values()
            for read in fh.reads
        }

    def script_reads(self, rel: str) -> List[EnvRead]:
        """A worker script's full read set: its own file reads plus
        the closure of every helper it calls with ``os.environ``."""
        fh = self.files.get(rel)
        if fh is None:
            return []
        out = list(fh.reads)
        seen = {(r.file, r.line, r.var) for r in out}
        for name in sorted(fh.helper_calls):
            for read in self.helpers.get(name, []):
                key = (read.file, read.line, read.var)
                if key not in seen:
                    seen.add(key)
                    out.append(replace(read, via=f"helper:{name}"))
        return out


def _resolve_helpers(
    files: Dict[str, FileHarvest]
) -> Dict[str, List[EnvRead]]:
    """Merge env-param reads by function name, then propagate along
    pass-through edges (``mesh_from_env(env)`` calling ``derive(env)``
    inherits derive's reads) to a fixpoint."""
    reads: Dict[str, Dict[Tuple[str, int, str], EnvRead]] = {}
    edges: Dict[str, Set[str]] = {}
    for fh in files.values():
        for info in fh.funcs:
            if info.param_reads:
                bucket = reads.setdefault(info.name, {})
                for r in info.param_reads:
                    bucket[(r.file, r.line, r.var)] = r
            for callee, _passed in info.passes:
                edges.setdefault(info.name, set()).add(callee)
    for _ in range(len(edges) + 2):
        changed = False
        for caller, callees in edges.items():
            bucket = reads.setdefault(caller, {})
            for callee in callees:
                if callee == caller:
                    continue
                for key, r in reads.get(callee, {}).items():
                    if key not in bucket:
                        bucket[key] = r
                        changed = True
        if not changed:
            break
    return {
        name: sorted(
            bucket.values(), key=lambda r: (r.file, r.line, r.var)
        )
        for name, bucket in reads.items()
        if bucket
    }


def harvest_tree(
    root: str,
    subdirs: Sequence[str] = ("dcos_commons_tpu_torch",),
) -> Harvest:
    harvest = Harvest()
    for sub in subdirs:
        top = os.path.join(root, sub)
        for dirpath, dirs, names in os.walk(top):
            dirs[:] = sorted(d for d in dirs if d != "__pycache__")
            for name in sorted(names):
                if not name.endswith(".py"):
                    continue
                path = os.path.join(dirpath, name)
                rel = os.path.relpath(path, root).replace(os.sep, "/")
                harvest.files[rel] = _harvest_file(path, rel)
    harvest.helpers = _resolve_helpers(harvest.files)
    return harvest


def runtime_provided_vars(root: str) -> FrozenSet[str]:
    """Vars the launch path injects beyond the YAML env block: the
    ``ENV_*`` contract constants of offer/evaluate.py (harvested, so
    the vocabulary can never drift from the launch code) plus the
    ambient sandbox set."""
    out = set(_AMBIENT_VARS)
    path = os.path.join(root, "dcos_commons_tpu_torch", "offer",
                        "evaluate.py")
    try:
        with open(path, "r", encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=path)
    except (OSError, SyntaxError):
        return frozenset(out)
    for node in ast.iter_child_nodes(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id.startswith("ENV_") \
                and isinstance(node.value, ast.Constant) \
                and isinstance(node.value.value, str):
            out.add(node.value.value)
    return frozenset(out)


# -- the YAML / options side -------------------------------------------


def template_occurrences(
    lines: Sequence[str],
) -> List[Tuple[str, Optional[str], int, str]]:
    """Every ``{{VAR:-default}}`` / ``{{VAR}}`` / ``{{#VAR}}`` in a
    YAML, as (var, default-or-None, line, kind) — the same grammar the
    real renderer applies (yaml_spec._TEMPLATE_RE)."""
    from dcos_commons_tpu_torch.specification.yaml_spec import _TEMPLATE_RE

    occ: List[Tuple[str, Optional[str], int, str]] = []
    for i, text in enumerate(lines, start=1):
        # ignore comment tails: a '#' at BOL or after whitespace
        code = re.split(r"(?:^|\s)#", text, 1)[0]
        for m in _TEMPLATE_RE.finditer(code):
            occ.append((m.group(1), m.group(2), i, "var"))
        for m in _SECTION_TAG_RE.finditer(code):
            occ.append((m.group(1), None, i, "section"))
    return occ


def _truthy(value: str) -> bool:
    # yaml_spec._truthy's vocabulary, shared with PREFIX_CACHE-style
    # "not in ('0', 'false')" reads
    return str(value).strip().lower() not in ("", "false", "0", "no")


def _defaults_equal(candidate: Optional[str], opt: Dict[str, Any]) -> bool:
    """Does a code/template default agree with the options default,
    normalized per the option's declared type?  Empty string counts
    as 0/false (the ``{{VAR:-}}`` + ``int(... or 0)`` idiom)."""
    if candidate is None or "default" not in opt:
        return True
    default = opt["default"]
    otype = opt.get("type")
    if otype == "boolean":
        return _truthy(candidate) == bool(default)
    if otype in ("integer", "number"):
        text = str(candidate).strip() or "0"
        try:
            return float(text) == float(default)
        except (TypeError, ValueError):
            return False
    return str(candidate) == str(default)


def _value_fails_cast(value: Any, read: EnvRead) -> bool:
    """Would this YAML string crash the read site's cast at launch?"""
    if read.cast not in ("int", "float", "json"):
        return False
    text = str(value)
    if text == "" and read.or_default:
        return False  # `... or default` readers fall back on empty
    try:
        if read.cast == "int":
            int(text)
        elif read.cast == "float":
            float(text)
        else:
            _json.loads(text)
    except (TypeError, ValueError):
        return True
    return False


def _make_anchor(lines: Sequence[str]):
    """Findings anchor to (and suppress at) the declaring ``<name>:``
    line, like speccheck's and shardcheck's."""
    def anchor(name: str) -> int:
        pattern = re.compile(rf"^\s*{re.escape(str(name))}\s*:")
        for i, text in enumerate(lines, start=1):
            if pattern.match(text):
                return i
        return 1
    return anchor


def _key_line(lines: Sequence[str], key: str, start: int) -> int:
    """The line declaring env key ``key`` at/after ``start`` (the pod
    anchor), so per-key findings suppress at their own line."""
    pattern = re.compile(rf"^\s*{re.escape(key)}\s*:")
    for i in range(max(start - 1, 0), len(lines)):
        if pattern.match(lines[i]):
            return i + 1
    return start


def _options_env_line(lines: Sequence[str], env_name: str) -> int:
    needle = f'"{env_name}"'
    for i, text in enumerate(lines, start=1):
        if '"env"' in text and needle in text:
            return i
    return 1


@dataclass
class ConfigResult(LintResult):
    """LintResult plus the flow-graph surfaces the CLI's trend keys
    and the --docs generator render from."""

    # var -> {type, default, options, set_by, read_by, description}
    env_vars: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    # joined YAML-env -> worker-script edges
    flows: List[Dict[str, str]] = field(default_factory=list)
    per_rule: Dict[str, int] = field(default_factory=dict)


def _yml_files(framework_dir: str) -> List[str]:
    return sorted(
        os.path.join(framework_dir, f)
        for f in os.listdir(framework_dir)
        if f.endswith(".yml")
    )


def analyze_framework(
    framework_dir: str,
    root: str,
    harvest: Harvest,
    runtime: FrozenSet[str],
    var_table: Dict[str, Dict[str, Any]],
    flows: List[Dict[str, str]],
) -> ConfigResult:
    from dcos_commons_tpu_torch.specification.yaml_spec import from_yaml_file
    from dcos_commons_tpu_torch.tools import options as options_mod

    result = ConfigResult()
    fw_rel = os.path.relpath(framework_dir, root).replace(os.sep, "/")
    disabled: Set[str] = set()
    schema = None
    options_env: Dict[str, str] = {}
    try:
        schema = options_mod.load_schema(framework_dir)
        if schema is not None:
            disabled = {
                str(r) for r in schema.get("x-sdklint-disable") or []
            }
            options_env = options_mod.render_options(schema, {})
    except options_mod.OptionsError:
        schema = None  # speccheck owns schema errors

    options_info: Dict[str, Dict[str, Any]] = {}
    options_rel = f"{fw_rel}/options.json"
    if schema is not None:
        with open(
            os.path.join(framework_dir, "options.json"),
            "r", encoding="utf-8",
        ) as f:
            opt_lines = f.read().splitlines()
        for section, option, opt in options_mod._iter_options(schema):
            env_name = opt.get("env") or options_mod.default_env_name(
                section, option
            )
            options_info[env_name] = {
                "section": section,
                "option": option,
                "opt": opt,
                "line": _options_env_line(opt_lines, env_name),
            }
        result.files_checked += 1

    scripts = sorted(
        f for f in os.listdir(framework_dir) if f.endswith(".py")
    )
    all_read_vars = harvest.vars_read()
    reads_by_var = harvest.reads_by_var()
    rendered_vars: Set[str] = set()

    def record_set(var: str, where: str, desc: str = "") -> None:
        info = var_table.setdefault(var, {
            "set_by": set(), "read_by": set(), "casts": set(),
            "code_defaults": set(), "options": "",
            "options_default": None, "options_type": "",
            "description": "",
        })
        info["set_by"].add(where)
        if desc and not info["description"]:
            info["description"] = desc

    for path in _yml_files(framework_dir):
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        with open(path, "r", encoding="utf-8") as f:
            lines = f.read().splitlines()
        suppressions = Suppressions(lines)
        anchor = _make_anchor(lines)
        result.files_checked += 1
        yml_findings: List[Finding] = []
        raw_text = "\n".join(lines)
        occurrences = template_occurrences(lines)
        occ_lines: Dict[str, Set[int]] = {}
        for var, _default, line, _kind in occurrences:
            occ_lines.setdefault(var, set()).add(line)

        for var, default, line, kind in occurrences:
            rendered_vars.add(var)
            info = options_info.get(var)
            if info is None or kind != "var":
                continue
            # drift only bites the env→code contract: a template that
            # feeds a harvested read can hand the worker a different
            # default per deploy mode.  Pure spec-field templates
            # (cpus/memory/count sizing) legitimately vary per
            # example YAML and are speccheck's domain.
            if default is not None and var in reads_by_var \
                    and not _defaults_equal(default, info["opt"]):
                yml_findings.append(Finding(
                    rel, line, "config-default-drift",
                    f"template default {{{{{var}:-{default}}}}} drifts "
                    f"from options.json {info['section']}."
                    f"{info['option']} default "
                    f"{info['opt'].get('default')!r} — a YAML-only "
                    "deploy and an options-rendered deploy disagree",
                ))
            if default is not None:
                for r in reads_by_var.get(var, []):
                    if _value_fails_cast(default, r):
                        yml_findings.append(Finding(
                            rel, line, "config-type-mismatch",
                            f"template default {{{{{var}:-{default}}}}} "
                            f"cannot pass the {r.cast}() cast at "
                            f"{r.file}:{r.line} — a YAML-only deploy "
                            "crashes the reader",
                        ))
                        break

        try:
            spec = from_yaml_file(path, options_env)
        except Exception:  # sdklint: disable=swallowed-exception — speccheck owns render/spec errors; configcheck only walks specs that render
            spec = None
        if spec is not None:
            for pod in spec.pods:
                pod_line = anchor(pod.type)
                mesh_keys = (
                    set(pod.gpu.mesh_env()) if pod.gpu else set()
                )
                for task in pod.tasks:
                    port_keys = {
                        p.env_key
                        for p in task.resources.ports if p.env_key
                    }
                    cmd_keys = set(
                        _CMD_ASSIGN_RE.findall(task.cmd or "")
                    )
                    provided = (
                        set(task.env) | mesh_keys | port_keys
                        | cmd_keys | runtime
                    )
                    script = next(
                        (s for s in scripts if s in (task.cmd or "")),
                        None,
                    )
                    script_rel = f"{fw_rel}/{script}" if script else ""
                    sreads = (
                        harvest.script_reads(script_rel)
                        if script else []
                    )
                    sreads_by_var: Dict[str, List[EnvRead]] = {}
                    for r in sreads:
                        sreads_by_var.setdefault(r.var, []).append(r)
                    seen_required: Set[str] = set()
                    for r in sreads:
                        if r.required and r.var not in provided \
                                and r.var not in seen_required:
                            seen_required.add(r.var)
                            yml_findings.append(Finding(
                                rel, pod_line,
                                "config-undeclared-read",
                                f"pod {pod.type!r} task "
                                f"{task.name!r}: {script} reads "
                                f"${r.var} ({r.file}:{r.line}) with "
                                "no default, but the task env does "
                                "not set it and the launch path does "
                                "not inject it",
                            ))
                    for key, value in task.env.items():
                        key_line = _key_line(lines, key, pod_line)
                        desc = _adjacent_comment(lines, key_line)
                        record_set(
                            key, f"{rel} pod {pod.type}", desc
                        )
                        readers = sreads_by_var.get(key, [])
                        if readers:
                            flows.append({
                                "yaml": rel,
                                "pod": pod.type,
                                "task": task.name,
                                "script": script_rel,
                                "var": key,
                            })
                        for r in readers:
                            if _value_fails_cast(value, r):
                                yml_findings.append(Finding(
                                    rel, key_line,
                                    "config-type-mismatch",
                                    f"pod {pod.type!r} env "
                                    f"{key}={value!r} cannot pass "
                                    f"the {r.cast}() cast at "
                                    f"{r.file}:{r.line}",
                                ))
                                break
                        # a var the YAML itself consumes elsewhere
                        # (a {{KEY}} template outside this env line,
                        # or a $KEY shell expansion in a cmd) is
                        # alive even with no Python reader
                        alive_in_yaml = bool(
                            occ_lines.get(key, set()) - {key_line}
                        ) or f"${key}" in raw_text \
                            or f"${{{key}}}" in raw_text
                        if key not in all_read_vars \
                                and not alive_in_yaml:
                            yml_findings.append(Finding(
                                rel, key_line, "config-dead-var",
                                f"pod {pod.type!r} sets env {key} "
                                "but nothing in the tree reads it "
                                "(directly, via a contract helper, "
                                "a dynamic table, or the YAML's own "
                                "templates/cmds)",
                            ))

        for f in yml_findings:
            if f.rule in disabled or "all" in disabled \
                    or suppressions.covers(f):
                result.suppressed.append(f)
            else:
                result.findings.append(f)

    # options side: orphans + code-default drift against the schema
    for env_name, info in sorted(options_info.items()):
        opt = info["opt"]
        record_set(
            env_name,
            f"{options_rel} {info['section']}.{info['option']}",
            str(opt.get("description", "")),
        )
        var_table[env_name]["options"] = (
            f"{info['section']}.{info['option']}"
        )
        var_table[env_name]["options_default"] = opt.get("default")
        var_table[env_name]["options_type"] = opt.get("type", "")
        if env_name not in rendered_vars:
            f = Finding(
                options_rel, info["line"], "config-options-orphan",
                f"option {info['section']}.{info['option']} renders "
                f"env {env_name}, which no {fw_rel} YAML template "
                "consumes — dead operator surface",
            )
            if f.rule in disabled or "all" in disabled:
                result.suppressed.append(f)
            else:
                result.findings.append(f)
        for r in reads_by_var.get(env_name, []):
            if r.default is None or r.via == "indirect":
                continue
            if not _defaults_equal(r.default, opt):
                f = Finding(
                    r.file, r.line, "config-default-drift",
                    f"in-code default {r.default!r} for {env_name} "
                    f"drifts from options.json {info['section']}."
                    f"{info['option']} default "
                    f"{opt.get('default')!r} — which default applies "
                    "depends on how the worker is launched",
                )
                fh = harvest.files.get(r.file)
                if f.rule in disabled or "all" in disabled or (
                    fh is not None and fh.suppressions.covers(f)
                ):
                    result.suppressed.append(f)
                else:
                    result.findings.append(f)

    result.findings.sort(key=lambda f: (f.file, f.line, f.rule))
    return result


def _finalize_var_table(
    var_table: Dict[str, Dict[str, Any]],
) -> Dict[str, Dict[str, Any]]:
    out: Dict[str, Dict[str, Any]] = {}
    for var in sorted(var_table):
        info = var_table[var]
        casts = info["casts"] - {"str"}
        if info["options_type"]:
            vtype = {
                "integer": "int", "number": "float",
                "boolean": "bool", "string": "str",
            }.get(info["options_type"], info["options_type"])
        elif casts:
            vtype = sorted(casts)[0]
        else:
            vtype = "str"
        if info["options_default"] is not None:
            default = _const_str(info["options_default"])
        elif len(info["code_defaults"]) == 1:
            default = next(iter(info["code_defaults"]))
        elif info["code_defaults"]:
            default = "varies: " + ", ".join(
                sorted(info["code_defaults"])
            )
        else:
            default = ""
        out[var] = {
            "type": vtype,
            "default": default,
            "options": info["options"],
            "set_by": sorted(info["set_by"]),
            "read_by": sorted(info["read_by"]),
            "description": info["description"],
        }
    return out


def analyze_all(root: str) -> ConfigResult:
    result = ConfigResult()
    harvest = harvest_tree(root)
    runtime = runtime_provided_vars(root)
    var_table: Dict[str, Dict[str, Any]] = {}
    flows: List[Dict[str, str]] = []

    # the port keeps one framework, its YAMLs and options.json side
    # by side in the package's frameworks/
    framework_dir = os.path.join(root, FRAMEWORK_DIR)
    if os.path.isdir(framework_dir):
        sub = analyze_framework(
            framework_dir, root, harvest, runtime,
            var_table, flows,
        )
        result.findings += sub.findings
        result.suppressed += sub.suppressed
        result.files_checked += sub.files_checked

    result.files_checked += len(harvest.files)
    for rel in sorted(harvest.files):
        for r in harvest.files[rel].reads:
            info = var_table.setdefault(r.var, {
                "set_by": set(), "read_by": set(), "casts": set(),
                "code_defaults": set(), "options": "",
                "options_default": None, "options_type": "",
                "description": "",
            })
            info["read_by"].add(f"{r.file}:{r.line}")
            info["casts"].add(r.cast)
            if r.default is not None:
                info["code_defaults"].add(r.default)
            if r.comment and not info["description"]:
                info["description"] = r.comment

    # dedup (two frameworks can re-report the same code-drift site)
    seen: Set[Tuple[str, int, str, str]] = set()
    deduped: List[Finding] = []
    for f in result.findings:
        key = (f.file, f.line, f.rule, f.message)
        if key not in seen:
            seen.add(key)
            deduped.append(f)
    result.findings = sorted(
        deduped, key=lambda f: (f.file, f.line, f.rule)
    )
    result.flows = sorted(
        flows, key=lambda e: (e["yaml"], e["pod"], e["task"], e["var"])
    )
    result.env_vars = _finalize_var_table(var_table)
    result.per_rule = {rule: 0 for rule, _ in CONFIG_RULES}
    for f in result.findings:
        result.per_rule[f.rule] = result.per_rule.get(f.rule, 0) + 1
    return result


# -- docs generation (--docs) ------------------------------------------


def _first_sentence(text: str) -> str:
    text = " ".join(str(text).split())
    for sep in (". ", "; "):
        if sep in text:
            text = text.split(sep, 1)[0] + sep.strip()
            break
    return text.replace("|", "\\|")


def render_config_reference(result: ConfigResult) -> str:
    """The committed ``docs/config-reference-torch.md``: one row per env
    var in the flow graph.  Deterministic (sorted, no timestamps) so
    the lint gate can assert the committed copy is current."""
    lines = [
        "# Config reference",
        "",
        "<!-- generated by `python -m dcos_commons_tpu_torch.analysis "
        "config --docs`; do not edit by hand — the port's lint gate "
        "(tests/test_torch_configcheck.py) asserts this file matches "
        "the analyzer's output -->",
        "",
        f"Every environment variable configcheck's flow graph tracks "
        f"({len(result.env_vars)} vars, {len(result.flows)} joined "
        "YAML-env-to-worker edges) across the options.json → YAML "
        "template → task env → reader pipeline.  *Set by* lists the "
        "YAML pods / options that produce the var (empty = the "
        "process env or launch path provides it); *read by* lists "
        "every harvested read site.",
        "",
        "| Variable | Type | Default | Set by | Read by |"
        " Description |",
        "|---|---|---|---|---|---|",
    ]
    for var, info in sorted(result.env_vars.items()):
        set_by = "; ".join(info["set_by"]) or "(process env)"
        read_by = "; ".join(info["read_by"]) or "—"
        default = str(info["default"]).replace("|", "\\|")
        lines.append(
            f"| `{var}` | {info['type']} | {default or '—'} | "
            f"{set_by} | {read_by} | "
            f"{_first_sentence(info['description']) or '—'} |"
        )
    return "\n".join(lines) + "\n"


def write_config_reference(root: str, result: ConfigResult) -> str:
    path = os.path.join(root, CONFIG_REFERENCE)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        f.write(render_config_reference(result))
    return path


CONFIG_RULES = (
    ("config-undeclared-read",
     "a joined worker script reads a var with no default that "
     "neither the task env nor the launch path provides"),
    ("config-dead-var",
     "a YAML env key nothing in the tree reads"),
    ("config-type-mismatch",
     "a YAML value or template default the read-site cast cannot "
     "parse"),
    ("config-default-drift",
     "an in-code or template default disagreeing with the "
     "options.json default for the same knob"),
    ("config-options-orphan",
     "an options.json option whose env name renders in no YAML of "
     "its framework"),
)


def config_rule_catalog() -> str:
    lines = ["configcheck rules (env/config contract):", ""]
    for rule_id, description in CONFIG_RULES:
        lines.append(f"  {rule_id}")
        lines.append(f"      {description}")
    return "\n".join(lines)

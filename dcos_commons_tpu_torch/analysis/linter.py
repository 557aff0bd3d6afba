"""sdklint core: findings, suppressions, and the file walker.

The shape mirrors the build-gate's inline AST lint
(tests/test_build_gate.py) but as a library: each rule is a small
class with an id and docstring (the rule catalog renders from these),
findings carry a stable fingerprint so a repo-level baseline file can
track pre-existing debt, and ``# sdklint: disable=<rule>`` on (or
immediately above) the offending line suppresses a finding the way
the reference's ``@SuppressWarnings`` / checkstyle-off comments do.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set

# comment grammar, valid in .py and .yml alike:
#   # sdklint: disable=rule-a,rule-b     (this line / the line below)
#   # sdklint: disable-file=rule-a       (anywhere: whole file)
# "all" disables every rule.  The marker may share a comment with
# other tooling ("# noqa: BLE001, sdklint: disable=...").
# the rule list ends at a second '#', EOL, or a rationale separator:
# em-dash, '--', or a lone ' - ' (rule ids contain hyphens only
# WITHOUT surrounding whitespace, so '- ' is unambiguous)
_SUPPRESS_RE = re.compile(
    r"#.*?\bsdklint:\s*disable(?P<scope>-file)?\s*=\s*"
    r"(?P<rules>[A-Za-z0-9_,\-\s]+?)\s*(?:#|$|—|--|-\s)"
)


@dataclass
class Finding:
    """One rule violation at one source location."""

    file: str          # repo-relative posix path
    line: int          # 1-based
    rule: str          # rule id
    message: str

    @property
    def fingerprint(self) -> str:
        """Line-number-free identity used by the baseline file, so
        unrelated edits above a baselined finding don't resurface it."""
        return f"{self.file}::{self.rule}"

    def render(self) -> str:
        return f"{self.file}:{self.line}: [{self.rule}] {self.message}"

    def to_dict(self) -> Dict[str, object]:
        """Machine form for the CLI's ``--json`` output."""
        return {
            "file": self.file,
            "line": self.line,
            "rule": self.rule,
            "message": self.message,
        }


class LintContext:
    """Everything a rule needs about one source file."""

    def __init__(self, path: str, rel: str, source: str):
        self.path = path
        self.rel = rel.replace(os.sep, "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree: Optional[ast.AST] = None
        try:
            self.tree = ast.parse(source, filename=path)
        except SyntaxError:
            # the build gate (py_compile) owns syntax errors; lint
            # rules simply don't run on an unparseable file
            self.tree = None

    def finding(self, node_or_line, rule_id: str, message: str) -> Finding:
        line = getattr(node_or_line, "lineno", node_or_line)
        return Finding(self.rel, int(line), rule_id, message)


class Suppressions:
    """The parsed suppression comments of ONE file — build once per
    file, query per finding (a per-finding re-scan would be
    O(findings x lines))."""

    def __init__(self, lines: Sequence[str]):
        self.per_line: Dict[int, Set[str]] = {}
        self.whole_file: Set[str] = set()
        for i, text in enumerate(lines, start=1):
            match = _SUPPRESS_RE.search(text)
            if not match:
                continue
            rules = {
                r.strip()
                for r in match.group("rules").split(",") if r.strip()
            }
            if match.group("scope"):
                self.whole_file |= rules
            else:
                self.per_line.setdefault(i, set()).update(rules)

    def covers(self, finding: Finding) -> bool:
        if "all" in self.whole_file or finding.rule in self.whole_file:
            return True
        for lineno in (finding.line, finding.line - 1):
            rules = self.per_line.get(lineno, ())
            if "all" in rules or finding.rule in rules:
                return True
        return False


def is_suppressed(finding: Finding, lines: Sequence[str]) -> bool:
    return Suppressions(lines).covers(finding)


@dataclass
class LintResult:
    findings: List[Finding] = field(default_factory=list)
    suppressed: List[Finding] = field(default_factory=list)
    files_checked: int = 0

    def render(self) -> str:
        return "\n".join(f.render() for f in self.findings)


def _walk_py_files(root: str, subdirs: Iterable[str]) -> List[str]:
    out = []
    for sub in subdirs:
        top = os.path.join(root, sub)
        for dirpath, dirs, files in os.walk(top):
            dirs[:] = sorted(d for d in dirs if d != "__pycache__")
            out += [
                os.path.join(dirpath, f)
                for f in sorted(files)
                if f.endswith(".py")
            ]
    return out


def lint_paths(
    paths: Iterable[str],
    root: str,
    rules: Optional[Sequence] = None,
) -> LintResult:
    from dcos_commons_tpu_torch.analysis.rules import all_rules

    result = LintResult()
    active = list(rules) if rules is not None else all_rules()
    for path in paths:
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
        ctx = LintContext(path, os.path.relpath(path, root), source)
        suppressions = Suppressions(ctx.lines)
        result.files_checked += 1
        for rule in active:
            if not rule.applies_to(ctx):
                continue
            for finding in rule.check(ctx):
                if suppressions.covers(finding):
                    result.suppressed.append(finding)
                else:
                    result.findings.append(finding)
    result.findings.sort(key=lambda f: (f.file, f.line, f.rule))
    return result


def lint_tree(
    root: str,
    subdirs: Sequence[str] = ("dcos_commons_tpu_torch",),
    rules: Optional[Sequence] = None,
) -> LintResult:
    """Lint every .py file under ``root``'s ``subdirs`` (the library,
    whose ``frameworks/`` holds the packaged workers; tests are the
    build gate's problem)."""
    return lint_paths(_walk_py_files(root, subdirs), root, rules)

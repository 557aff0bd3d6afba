"""Baseline file: tracked pre-existing debt, not hidden debt (port of
``dcos_commons_tpu/analysis/baseline.py``; the port keeps its own file,
``.sdklint-torch-baseline.json``, beside the reference's).

Reference: the checkstyle/findbugs suppression-file idiom — a gate
adopted by an existing codebase records current violations in a
reviewed file so (a) the gate can land green immediately, (b) NEW
violations still fail, and (c) the debt is visible and burned down
deliberately.  Entries key on ``file::rule`` with a count, so line
drift from unrelated edits never resurfaces a baselined finding,
while adding one MORE violation of the same rule in the same file
does fail the gate.
"""

from __future__ import annotations

import json
import os
from collections import Counter
from typing import Dict, Iterable, List, Tuple

from dcos_commons_tpu_torch.analysis.linter import Finding

BASELINE_NAME = ".sdklint-torch-baseline.json"


def baseline_path(root: str) -> str:
    return os.path.join(root, BASELINE_NAME)


def load_baseline(path: str) -> Dict[str, int]:
    """{fingerprint: allowed count}; a missing file is an empty one."""
    if not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as f:
        raw = json.load(f)
    entries = raw.get("entries", {})
    return {str(k): int(v) for k, v in entries.items()}


def save_baseline(
    path: str,
    findings: Iterable[Finding],
    retain: Dict[str, int] = None,
) -> Dict[str, int]:
    """Write the baseline from ``findings``; ``retain`` carries
    fingerprint counts that must survive the rewrite verbatim — the
    entries of an analyzer that did NOT run this invocation (lint and
    spmd share this file, and `--lint --update-baseline` must not
    erase the dur or shard debt it never recomputed)."""
    counts = Counter(f.fingerprint for f in findings)
    for fingerprint, count in (retain or {}).items():
        counts[fingerprint] = max(counts[fingerprint], count)
    doc = {
        "comment": (
            "sdklint baseline: pre-existing violations tracked, not "
            "hidden.  Regenerate with `python -m dcos_commons_tpu_torch."
            "analysis --lint --update-baseline` after deliberate "
            "triage; shrink it, don't grow it."
        ),
        "entries": dict(sorted(counts.items())),
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    return dict(counts)


def apply_baseline(
    findings: List[Finding], baseline: Dict[str, int]
) -> Tuple[List[Finding], List[Finding]]:
    """-> (new findings that fail the gate, baselined findings).

    Per fingerprint, up to the baselined count is absorbed; anything
    beyond it is new debt and fails.
    """
    budget = dict(baseline)
    fresh: List[Finding] = []
    absorbed: List[Finding] = []
    for finding in findings:
        if budget.get(finding.fingerprint, 0) > 0:
            budget[finding.fingerprint] -= 1
            absorbed.append(finding)
        else:
            fresh.append(finding)
    return fresh, absorbed

"""Static analysis of the port (the counterpart of
``dcos_commons_tpu/analysis``), the analyzers behind one CLI,
``python -m dcos_commons_tpu_torch.analysis lint|specs|plan|shard|dur|all``:

- **Framework lint** (`linter`, `rules`, `baseline`): the reference's
  eleven AST rules over the port's package, with their path scopes
  moved to ``dcos_commons_tpu_torch/``; suppressible in-line
  (``# sdklint: disable=<rule>``), pre-existing debt tracked in the
  port's own ``.sdklint-torch-baseline.json``.
- **Spec analyzer** (`speccheck`): deploy-time spec failures at lint
  time, over the port's ``frameworks/`` YAMLs.
- **Sharding analyzer** (`shardcheck`): sharding, the per-card memory
  footprint against the card, collective cost.
- **Durability analyzer** (`durcheck`): WAL-before-effect, replay
  parity, fence coverage, atomic pairs, file discipline, and the
  persistence-point map ``testing/chaos.py`` derives kill points from.
- **Plan model checker** (`plancheck`): exhaustive BFS over the port's
  ``plan/`` objects under status arrivals, restarts and operator verbs.

The reference's ``spmdcheck``, ``racecheck``, ``lockcheck`` and
``configcheck`` are not ported yet.
"""

from dcos_commons_tpu_torch.analysis.linter import (  # noqa: F401
    Finding,
    LintContext,
    lint_paths,
    lint_tree,
)
from dcos_commons_tpu_torch.analysis.rules import all_rules  # noqa: F401

"""Static analysis of the port (the counterpart of
``dcos_commons_tpu/analysis``), every analyzer of the reference behind
one CLI, ``python -m dcos_commons_tpu_torch.analysis
lint|specs|spmd|plan|shard|race|config|dur|all``:

- **Framework lint** (`linter`, `rules`, `baseline`): the reference's
  eleven AST rules over the port's package, with their path scopes
  moved to ``dcos_commons_tpu_torch/``; suppressible in-line
  (``# sdklint: disable=<rule>``), pre-existing debt tracked in the
  port's own ``.sdklint-torch-baseline.json``.
- **Spec analyzer** (`speccheck`): deploy-time spec failures at lint
  time, over the port's ``frameworks/`` YAMLs.
- **SPMD collective-safety analyzer** (`spmdcheck`): per-function
  collective summaries over the data-plane layers, with the
  ``torch.distributed`` calls and the port's mesh wrappers as the
  collectives and the rank, the card and the rank env as host
  identity; flags cross-rank divergence hazards.
- **Sharding analyzer** (`shardcheck`): sharding, the per-card memory
  footprint against the card, collective cost.
- **Race analyzer** (`racecheck`, with `lockcheck` its old name):
  thread-ownership analysis of shared attribute writes, and the
  dynamic vector-clock checker (``install()``) that reports lock-order
  cycles and unordered writes at run time.
- **Config contract analyzer** (`configcheck`): options.json, the YAML
  templates, the task env and the launch path's injections joined to
  every env read of the package; ``--docs`` renders
  ``docs/config-reference-torch.md``.
- **Durability analyzer** (`durcheck`): WAL-before-effect, replay
  parity, fence coverage, atomic pairs, file discipline, and the
  persistence-point map ``testing/chaos.py`` derives kill points from.
- **Plan model checker** (`plancheck`): exhaustive BFS over the port's
  ``plan/`` objects under status arrivals, restarts and operator verbs.
"""

from dcos_commons_tpu_torch.analysis.linter import (  # noqa: F401
    Finding,
    LintContext,
    lint_paths,
    lint_tree,
)
from dcos_commons_tpu_torch.analysis.rules import all_rules  # noqa: F401
from dcos_commons_tpu_torch.analysis import (  # noqa: F401
    configcheck,
    lockcheck,
    racecheck,
    spmdcheck,
)

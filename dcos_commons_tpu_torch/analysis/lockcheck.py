"""Back-compat alias: lockcheck grew into racecheck (a copy of
``dcos_commons_tpu/analysis/lockcheck.py`` over the port's racecheck).

The runtime lock-order checker is now the dynamic half of
``dcos_commons_tpu_torch.analysis.racecheck`` — same ``install``/``watch``/
``report`` API, plus vector-clock happens-before tracking, Thread
start/join edges, and ``watch_type``.  Lock-order cycle detection is
unchanged (reported as the ``race-lock-cycle`` rule).  This module
keeps every historical import site and the ``SDKLINT_LOCKCHECK=1``
opt-in working; new code should import racecheck directly.
"""

from __future__ import annotations

from dcos_commons_tpu_torch.analysis.racecheck import (  # noqa: F401
    InstrumentedLock,
    LockReport,
    RaceRecord,
    RaceReport,
    env_requested,
    install,
    is_enabled,
    report,
    reset,
    uninstall,
    unwatch_types,
    watch,
    watch_type,
)
from dcos_commons_tpu_torch.analysis.racecheck import (  # noqa: F401
    LEGACY_ENV_VAR as ENV_VAR,
)

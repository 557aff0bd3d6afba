"""L5 state: task state over a Persister (port of
``dcos_commons_tpu/state/state_store.py``; the config, framework,
launch-recorder and schema stores are not ported yet).

Reference: sdk/scheduler/.../state/ — StateStore.java:58,213-569,
GoalStateOverride.java.
"""

from dcos_commons_tpu_torch.state.state_store import (
    GoalStateOverride,
    OverrideProgress,
    StateStore,
    StateStoreException,
)

__all__ = [
    "GoalStateOverride",
    "OverrideProgress",
    "StateStore",
    "StateStoreException",
]

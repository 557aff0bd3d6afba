"""Test harness: the scripted agent the scheduler runs against with
no processes, and the poll loop for tests that drive a scheduler
against a real agent.

Port of ``dcos_commons_tpu/testing/__init__.py`` but the simulation
runner and its ticks (``testing/runner.py``, ``testing/ticks.py``),
which the port does not have yet.
"""

from dcos_commons_tpu_torch.testing.fake_agent import FakeAgent


def drive_until(scheduler, predicate, timeout_s: float = 30.0,
                interval_s: float = 0.05) -> bool:
    """Run real scheduler cycles until ``predicate()`` is truthy.

    The shared poll loop for tests that drive a scheduler against a
    REAL agent (process launches) rather than scripted ticks."""
    import time as _time

    deadline = _time.monotonic() + timeout_s
    while _time.monotonic() < deadline:
        scheduler.run_cycle()
        if predicate():
            return True
        _time.sleep(interval_s)
    return False


__all__ = ["FakeAgent", "drive_until"]

"""Rollout strategies: which children of an element may work now.

Reference: scheduler/plan/strategy/ — SerialStrategy, ParallelStrategy,
CanaryStrategy.java:30-58 (N manual proceed() calls then delegate),
DependencyStrategy + DependencyStrategyHelper (arbitrary DAG),
RandomStrategy, StrategyGenerator (YAML names "serial", "parallel",
"serial-canary", "parallel-canary", "random").

Note (SURVEY.md section 2): these are *service-rollout* strategies.
ML tensor parallelism lives in dcos_commons_tpu/parallel/.

Port of ``dcos_commons_tpu/plan/strategy.py``,
line for line but the imports.
"""

from __future__ import annotations

import random
import threading
from typing import Dict, List, Optional, Sequence, Set

from dcos_commons_tpu_torch.plan.element import Element


class Strategy:
    """Yields the children eligible to work, given exclusion assets."""

    interruptible = True

    def __init__(self) -> None:
        self._interrupted = False
        self._lock = threading.Lock()

    def candidates(
        self, children: Sequence[Element], dirty_assets: Set[str]
    ) -> List[Element]:
        if self._interrupted:
            return []
        return self._candidates(children, dirty_assets)

    def _candidates(
        self, children: Sequence[Element], dirty_assets: Set[str]
    ) -> List[Element]:
        raise NotImplementedError

    # interrupt/proceed (reference: Interruptible on strategies)

    def interrupt(self) -> None:
        if self.interruptible:
            self._interrupted = True

    def proceed(self) -> None:
        self._interrupted = False

    def is_interrupted(self) -> bool:
        return self._interrupted


def _eligible(child: Element, dirty_assets: Set[str]) -> bool:
    from dcos_commons_tpu_torch.plan.step import Step  # avoid import cycle

    if child.is_complete or child.is_interrupted():
        return False
    if isinstance(child, Step) and child.get_asset_names() & dirty_assets:
        return False
    return True


class SerialStrategy(Strategy):
    """One child at a time, in order (reference: SerialStrategy.java)."""

    def _candidates(self, children, dirty_assets):
        for child in children:
            if child.is_complete:
                continue
            if _eligible(child, dirty_assets):
                return [child]
            return []  # blocked child gates everything after it
        return []


class ParallelStrategy(Strategy):
    """All incomplete children at once (reference: ParallelStrategy.java)."""

    def _candidates(self, children, dirty_assets):
        return [c for c in children if _eligible(c, dirty_assets)]


class CanaryStrategy(Strategy):
    """Deploy a canary, wait for operator confirmation, then the rest.

    Reference: CanaryStrategy.java:30-58 — starts interrupted; each
    ``proceed()`` releases one child until ``canary_count`` children
    have been individually released, after which the delegate strategy
    governs the remainder.  YAML "serial-canary" / "parallel-canary".
    """

    def __init__(self, delegate: Optional[Strategy] = None, canary_count: int = 1):
        super().__init__()
        self._delegate = delegate or SerialStrategy()
        self._canary_count = canary_count
        self._proceeds = 0

    def _candidates(self, children, dirty_assets):
        with self._lock:
            released = self._proceeds
        if released == 0:
            return []
        if released <= self._canary_count:
            # canary phase: only the first `released` children may work
            eligible = [
                c for c in children[:released] if _eligible(c, dirty_assets)
            ]
            return eligible[:1] if isinstance(self._delegate, SerialStrategy) \
                else eligible
        return self._delegate.candidates(children, dirty_assets)

    def proceed(self) -> None:
        with self._lock:
            if self._proceeds <= self._canary_count:
                self._proceeds += 1
        self._interrupted = False

    def interrupt(self) -> None:
        self._interrupted = True

    def is_interrupted(self) -> bool:
        # before first proceed the canary reads as interrupted/waiting
        return self._interrupted or self._proceeds == 0


class DependencyStrategy(Strategy):
    """Arbitrary DAG: a child runs once all its dependencies complete.

    Reference: DependencyStrategy + DependencyStrategyHelper.
    ``edges`` maps child name -> list of prerequisite child names.
    """

    def __init__(self, edges: Dict[str, List[str]]):
        super().__init__()
        self._edges = {k: list(v) for k, v in edges.items()}

    def _candidates(self, children, dirty_assets):
        by_name = {c.name: c for c in children}
        out = []
        for child in children:
            if not _eligible(child, dirty_assets):
                continue
            deps = self._edges.get(child.name, [])
            unknown = [d for d in deps if d not in by_name]
            if unknown:
                continue  # mis-specified dependency: never a candidate
            if all(by_name[d].is_complete for d in deps):
                out.append(child)
        return out


class RandomStrategy(Strategy):
    """Random order, one at a time (reference: RandomStrategy.java)."""

    def __init__(self, rng: Optional[random.Random] = None):
        super().__init__()
        self._rng = rng or random.Random()

    def _candidates(self, children, dirty_assets):
        eligible = [c for c in children if _eligible(c, dirty_assets)]
        return [self._rng.choice(eligible)] if eligible else []


def strategy_for_name(name: str, canary_count: int = 1) -> Strategy:
    """Reference: strategy/StrategyFactory + StrategyGenerator YAML names."""
    name = (name or "serial").strip().lower()
    if name == "serial":
        return SerialStrategy()
    if name == "parallel":
        return ParallelStrategy()
    if name in ("serial-canary", "canary"):
        return CanaryStrategy(SerialStrategy(), canary_count)
    if name == "parallel-canary":
        return CanaryStrategy(ParallelStrategy(), canary_count)
    if name == "random":
        return RandomStrategy()
    raise ValueError(f"unknown strategy {name!r}")

"""Training triggers: the part of the JAX package's
``common/triggers.py`` the estimator uses.

A trigger fires on a ``TriggerState`` snapshot; ``Estimator.train`` ends
when its end trigger fires, checked after every step and at every epoch
end.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class TriggerState:
    """What a trigger can observe at a step boundary."""
    epoch: int = 0             # 1-based, current epoch
    iteration: int = 0         # global step count
    epoch_finished: bool = False
    loss: Optional[float] = None   # the epoch's mean loss, at epoch end
    score: Optional[float] = None  # the epoch's first validation score


class Trigger:
    def __call__(self, state: TriggerState) -> bool:
        raise NotImplementedError


class EveryEpoch(Trigger):
    def __call__(self, s: TriggerState) -> bool:
        return s.epoch_finished


class MaxIteration(Trigger):
    def __init__(self, max_iteration: int):
        self.max_iteration = max_iteration

    def __call__(self, s: TriggerState) -> bool:
        return s.iteration >= self.max_iteration


class MaxScore(Trigger):
    """Stop when the validation score exceeds ``max_score``."""

    def __init__(self, max_score: float):
        self.max_score = max_score

    def __call__(self, s: TriggerState) -> bool:
        return s.score is not None and s.score > self.max_score

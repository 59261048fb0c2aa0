"""Composable training triggers: a copy of the JAX package's
``common/triggers.py`` (host-only, copied because any ``analytics_zoo_tpu``
import loads jax).

A trigger fires on a ``TriggerState`` snapshot: an end trigger stops
training, an interval trigger drives checkpoint and validation cadence.
``next_possible_fire`` bounds how far the estimator may chain steps into
one dispatch (CUDA graph replays on the card) without moving an action
off the step it lands on.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence


@dataclass
class TriggerState:
    """What a trigger can observe at a step boundary."""
    epoch: int = 0             # 1-based, current epoch
    iteration: int = 0         # global step count
    epoch_finished: bool = False
    loss: Optional[float] = None
    score: Optional[float] = None  # last validation score


class Trigger:
    def __call__(self, state: TriggerState) -> bool:
        raise NotImplementedError

    def next_possible_fire(self, iteration: int) -> Optional[int]:
        """Earliest iteration > ``iteration`` at which this trigger COULD
        fire at an in-epoch step boundary, or ``None`` if it cannot fire
        before the epoch ends (epoch/score triggers).  Lets the training
        engine chain dispatches up to the next action boundary without
        changing when trigger actions land.  The base default —
        "could fire at the very next step" — is the conservative answer
        for custom or data-dependent triggers: it disables chaining."""
        return iteration + 1

    def __and__(self, other: "Trigger") -> "Trigger":
        return TriggerAnd(self, other)

    def __or__(self, other: "Trigger") -> "Trigger":
        return TriggerOr(self, other)


class EveryEpoch(Trigger):
    def __call__(self, s: TriggerState) -> bool:
        return s.epoch_finished

    def next_possible_fire(self, iteration: int) -> Optional[int]:
        return None  # only at epoch end


class SeveralIteration(Trigger):
    def __init__(self, interval: int):
        if interval <= 0:
            raise ValueError("interval must be positive")
        self.interval = interval

    def __call__(self, s: TriggerState) -> bool:
        return s.iteration > 0 and s.iteration % self.interval == 0

    def next_possible_fire(self, iteration: int) -> Optional[int]:
        return (iteration // self.interval + 1) * self.interval


class MaxEpoch(Trigger):
    def __init__(self, max_epoch: int):
        self.max_epoch = max_epoch

    def __call__(self, s: TriggerState) -> bool:
        return s.epoch_finished and s.epoch >= self.max_epoch

    def next_possible_fire(self, iteration: int) -> Optional[int]:
        return None  # only at epoch end


class MaxIteration(Trigger):
    def __init__(self, max_iteration: int):
        self.max_iteration = max_iteration

    def __call__(self, s: TriggerState) -> bool:
        return s.iteration >= self.max_iteration

    def next_possible_fire(self, iteration: int) -> Optional[int]:
        return max(self.max_iteration, iteration + 1)


class MaxScore(Trigger):
    """Stop when validation score exceeds threshold (ZooTrigger.scala:109)."""

    def __init__(self, max_score: float):
        self.max_score = max_score

    def __call__(self, s: TriggerState) -> bool:
        return s.score is not None and s.score > self.max_score

    def next_possible_fire(self, iteration: int) -> Optional[int]:
        return None  # score only exists after epoch-end validation


class MinLoss(Trigger):
    def __init__(self, min_loss: float):
        self.min_loss = min_loss

    def __call__(self, s: TriggerState) -> bool:
        return s.loss is not None and s.loss < self.min_loss
    # data-dependent: inherits the conservative next_possible_fire


class TriggerAnd(Trigger):
    def __init__(self, *triggers: Trigger):
        self.triggers: Sequence[Trigger] = triggers

    def __call__(self, s: TriggerState) -> bool:
        return all(t(s) for t in self.triggers)

    def next_possible_fire(self, iteration: int) -> Optional[int]:
        # fires only when ALL fire: cannot fire before the LATEST child
        # bound; any child that can't fire this epoch blocks the AND
        bounds = [t.next_possible_fire(iteration) for t in self.triggers]
        if any(b is None for b in bounds):
            return None
        return max(bounds) if bounds else None


class TriggerOr(Trigger):
    def __init__(self, *triggers: Trigger):
        self.triggers: Sequence[Trigger] = triggers

    def __call__(self, s: TriggerState) -> bool:
        return any(t(s) for t in self.triggers)

    def next_possible_fire(self, iteration: int) -> Optional[int]:
        bounds = [t.next_possible_fire(iteration) for t in self.triggers]
        bounds = [b for b in bounds if b is not None]
        return min(bounds) if bounds else None

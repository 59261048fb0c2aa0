"""Scoped timers with the ``Utils.timeIt`` ergonomics.

Port of ``Timers``, ``time_it`` and ``default_timers`` from
``analytics_zoo_tpu/common/timer.py`` (copied: any ``analytics_zoo_tpu``
import loads jax).  The bridge of every observation into the metrics
registry (``metrics_prefix``) belongs to observability, ROADMAP Queue 1
item 6: the argument is taken at its JAX default, None, and any other
value raises naming the item.  ``profile_trace`` (the JAX profiler) has no
port here; ``torch.profiler`` is the card's.
"""

from __future__ import annotations

import contextlib
import logging
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

from analytics_zoo_tpu_torch.common.unported import reject

logger = logging.getLogger("analytics_zoo_tpu_torch.timer")


class Timers:
    """Accumulating named timers; ``report()`` gives totals, counts and
    averages."""

    def __init__(self, metrics_prefix: Optional[str] = None):
        reject("Timers", 6, metrics_prefix=metrics_prefix)
        self._total: Dict[str, float] = defaultdict(float)
        self._count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def time(self, name: str, log: bool = False) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            elapsed = time.perf_counter() - start
            self._total[name] += elapsed
            self._count[name] += 1
            if log:
                logger.info("%s: %.3fs", name, elapsed)

    def report(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": self._total[name],
                "count": self._count[name],
                "mean_s": self._total[name] / max(self._count[name], 1),
            }
            for name in self._total
        }

    def reset(self) -> None:
        self._total.clear()
        self._count.clear()


_default = Timers()


@contextlib.contextmanager
def time_it(name: str, timers: Optional[Timers] = None,
            log: bool = True) -> Iterator[None]:
    with (timers or _default).time(name, log=log):
        yield


def default_timers() -> Timers:
    return _default

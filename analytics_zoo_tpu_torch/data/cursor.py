"""Per-epoch random streams and the resume cursor of the data plane.

A copy of ``epoch_rng``, ``_stream_key`` and ``DataCursor`` from
``analytics_zoo_tpu/data/cursor.py`` (host-only numpy, copied because any
``analytics_zoo_tpu`` import loads jax): the same (seed, epoch, stream
path) gives the same numpy Generator, so a seed gives the same shuffled
batch order in both packages, and a checkpoint's ``data_cursor`` reads the
same in either.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Any, Dict

import numpy as np


def _stream_key(part: Any) -> int:
    """A stable 32-bit key for one stream-path element (``hash()`` is
    salted per process for str)."""
    if isinstance(part, (int, np.integer)):
        return int(part) & 0xFFFFFFFF
    return zlib.crc32(str(part).encode("utf-8"))


def epoch_rng(seed: int, epoch: int, *stream: Any) -> np.random.Generator:
    """Deterministic, collision-free Generator for (seed, epoch, path)."""
    entropy = [int(seed) & 0xFFFFFFFF, int(epoch) & 0xFFFFFFFF]
    entropy.extend(_stream_key(p) for p in stream)
    return np.random.default_rng(np.random.SeedSequence(entropy))


@dataclass
class DataCursor:
    """Position of an epoch-ordered ingest stream: ``step`` batches of
    ``epoch`` have been consumed by completed train steps.  The estimator
    writes ``cursor.state()`` into its checkpoint meta as
    ``meta["data_cursor"]`` and reads it back with ``from_state`` on resume
    or retry."""

    epoch: int = 0
    step: int = 0

    def state(self) -> Dict[str, int]:
        return {"epoch": int(self.epoch), "step": int(self.step)}

    @staticmethod
    def from_state(state: Dict[str, int]) -> "DataCursor":
        return DataCursor(epoch=int(state.get("epoch", -1)),
                          step=int(state.get("step", 0)))

"""Per-epoch random streams for every epoch-shuffling data surface.

A copy of ``epoch_rng`` and ``_stream_key`` from
``analytics_zoo_tpu/data/cursor.py`` (host-only numpy, copied because any
``analytics_zoo_tpu`` import loads jax): the same (seed, epoch, stream
path) gives the same numpy Generator, so a seed gives the same shuffled
batch order in both packages.
"""

from __future__ import annotations

import zlib
from typing import Any

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

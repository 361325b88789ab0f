"""Seeds of every stream the benchmark draws, derived from the run's seed.

A stream is named, and optionally indexed by a call, so that two streams
of one run never share draws and a stream's draws do not depend on what
the run drew before it."""
from __future__ import annotations

import zlib

import numpy as np
import torch


def derive(seed: int, stream: str, index: int | None = None) -> int:
    """A 63-bit seed for ``stream`` (and call ``index``) of run ``seed``."""
    words = [int(seed) & 0xFFFFFFFFFFFFFFFF, zlib.crc32(stream.encode())]
    if index is not None:
        words.append((int(index) + 1) & 0xFFFFFFFFFFFFFFFF)
    ss = np.random.SeedSequence(words)
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def generator(device, seed: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g

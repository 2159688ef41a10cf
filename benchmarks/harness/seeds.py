"""Seeds of the parts of a run, all drawn from ``--seed``."""

from __future__ import annotations

import zlib

import numpy as np


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for the part ``tag`` of a run with ``seed``: the same
    pair always gives the same seed, other tags other streams. ``seed`` is
    any whole number a run may be given (more than 32 bits)."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF, zlib.crc32(tag.encode())]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])

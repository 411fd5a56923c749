"""Seeds and the open-loop arrival schedule.

Every seed gets the same work: the same number of requests and the same
multiset of gaps between them (the quantiles of an exponential
distribution, a Poisson process's gaps), put in another order by the seed.
"""

from __future__ import annotations

import zlib

import numpy as np


def sub_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one named stream of the run with `seed`."""
    state = np.random.SeedSequence([abs(int(seed)), int(seed < 0),
                                    zlib.crc32(stream.encode())])
    return int(state.generate_state(1, np.uint64)[0] & (2**63 - 1))


def rng(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, stream))


def arrivals(mix: dict, seconds: float, seed: int) -> np.ndarray:
    """Sorted offsets in seconds from the window's start of every request
    due in it: round(rate x seconds) requests over (0, seconds]."""
    n = max(1, int(round(mix["rate_per_s"] * seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
    rng(seed, "arrivals").shuffle(gaps)
    return np.cumsum(gaps) * (seconds / gaps.sum())

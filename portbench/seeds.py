"""Seeds derived from a run's ``--seed``: one stream of numbers per use, so
that the same seed gives the same inputs and weights and two uses never
share a stream."""

from __future__ import annotations

import hashlib


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed for ``tag`` from the run's seed (any whole number)."""
    digest = hashlib.sha256(f"{int(seed)}/{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def numpy_seed(seed: int, tag: str) -> int:
    """:func:`subseed` cut to what ``np.random.RandomState`` takes."""
    return subseed(seed, tag) % (2 ** 32)

"""Seeds: every random number of a run comes from ``--seed`` through here.

``sub_seed(seed, tag)`` gives an independent 63-bit seed per purpose, so
the weights, the event pool and the traffic's order never share a stream.
Any whole number is a valid ``--seed``, negative or beyond 64 bits.
"""
from __future__ import annotations

import numpy as np

# One tag per purpose: adding a purpose adds a tag, never renumbers one.
WEIGHTS, POOL, ORDER = 1, 2, 3


def sub_seed(seed: int, tag: int) -> int:
    entropy = int(seed) & ((1 << 128) - 1)
    state = np.random.SeedSequence(entropy, spawn_key=(tag,)).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def rng(seed: int, tag: int) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, tag))

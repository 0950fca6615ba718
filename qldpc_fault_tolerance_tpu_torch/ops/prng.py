"""Threefry-2x32 and the JAX key stream, on the host.

  * ``threefry2x32``: the block cipher of ``jax.random``'s default generator
    (20 rounds), on Python ints or int64 tensors masked to 32 bits (torch has
    no uint32 arithmetic).
  * ``prng_key``, ``split_key``, ``fold_in``: ``jax.random.PRNGKey``,
    ``split`` and ``fold_in`` (default ``threefry_partitionable``) on Python
    ints, so deriving a batch's key costs no device sync.  A key is a pair of
    ints, its two 32-bit words.
"""
from __future__ import annotations

import numpy as np

__all__ = ["MASK", "threefry2x32", "key_words", "prng_key", "split_key",
           "fold_in"]

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY_CONST = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32 (20 rounds): (key words, counter words) -> (x0, x1).

    Inputs are Python ints or int64 tensors holding values in [0, 2**32),
    broadcast together; outputs are of the same kind.  Every add and shift
    is masked to 32 bits, so the values stay unsigned words."""
    ks = (k0 & MASK, k1 & MASK, (k0 ^ k1 ^ _PARITY_CONST) & MASK)
    x0 = (c0 + ks[0]) & MASK
    x1 = (c1 + ks[1]) & MASK
    for block in range(5):
        for r in _ROTATIONS[block % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & MASK
        x1 = (x1 + ks[(block + 2) % 3] + block + 1) & MASK
    return x0, x1


def key_words(key) -> tuple[int, int]:
    """A key (two 32-bit words: a tuple, list, numpy or torch array) as a
    pair of Python ints."""
    words = [int(w) for w in np.asarray(key, dtype=np.uint64).reshape(-1)]
    if len(words) != 2 or any(w > MASK for w in words):
        raise ValueError(f"a key is two 32-bit words, got {key!r}")
    return words[0], words[1]


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)``'s words with 64-bit mode off (the JAX
    package's default): the seed's low 32 bits."""
    return 0, int(seed) & MASK


def split_key(key, num: int = 2) -> tuple:
    """``jax.random.split(key, num)``: key ``i`` is Threefry(key, (0, i))."""
    k0, k1 = key_words(key)
    return tuple(threefry2x32(k0, k1, 0, i) for i in range(int(num)))


def fold_in(key, data: int) -> tuple[int, int]:
    """``jax.random.fold_in(key, data)``: Threefry(key, (0, data))."""
    k0, k1 = key_words(key)
    return threefry2x32(k0, k1, 0, int(data) & MASK)

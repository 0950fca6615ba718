"""Threefry-2x32 and the JAX key stream, on the host.

  * ``threefry2x32``: the block cipher of ``jax.random``'s default generator
    (20 rounds), on Python ints or int64 tensors masked to 32 bits (torch has
    no uint32 arithmetic).
  * ``prng_key``, ``split_key``, ``fold_in``: ``jax.random.PRNGKey``,
    ``split`` and ``fold_in`` (default ``threefry_partitionable``) on Python
    ints, so deriving a batch's key costs no device sync.  A key is a pair of
    ints, its two 32-bit words.
  * ``fold_in_device``: ``fold_in`` of one key with many batch indices on
    the device, as the JAX package folds inside its scan; a captured CUDA
    graph derives its batches' keys with it.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["MASK", "threefry2x32", "key_words", "prng_key", "split_key",
           "fold_in", "fold_in_device", "key_tensor", "key_parts"]

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


def _as_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) as int32 bit patterns."""
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(
        torch.int32)


def fold_in_device(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``fold_in(key, d)`` for every ``d`` of ``data`` on the device:
    ``key`` (2,) int64 words, ``data`` int64 indices; returns
    ``(len(data), 2)`` int32 bit patterns, one key per row, in the layout
    the counter-PRNG kernels read."""
    x0, x1 = threefry2x32(key[0], key[1], 0, data & MASK)
    return _as_int32(torch.stack([x0.expand_as(x1), x1], dim=-1))


def key_tensor(key, device) -> torch.Tensor:
    """A key's two words as a (2,) int32 tensor on ``device`` (the kernels'
    layout); a tensor already in that layout passes through."""
    if isinstance(key, torch.Tensor):
        if (key.dtype != torch.int32 or tuple(key.shape) != (2,)
                or key.device.type != torch.device(device).type):
            raise ValueError(f"a device key is a (2,) int32 tensor on "
                             f"{device}, got {key.dtype} {tuple(key.shape)} "
                             f"on {key.device}")
        return key
    words = torch.tensor(key_words(key), dtype=torch.int64)
    return _as_int32(words).to(device)


def key_parts(key):
    """The key's words as Python ints, or, for a key tensor, as int64 device
    scalars in [0, 2**32) (no host read)."""
    if isinstance(key, torch.Tensor):
        k = key.to(torch.int64) & MASK
        return k[0], k[1]
    return key_words(key)

"""Megabatch driver: many Monte-Carlo batches per host read.

``MegabatchDriver`` runs ``stats_fn(batch_input(seed, j), *extra)`` for
``k_inner`` batches per megabatch and folds the results on the device
(counts summed, min-weights minimized); the carry stays a tuple of device
tensors, so a megabatch costs the host one read, made by the caller.  The
stream is positional, so batch j's draws depend only on (seed, j): the
caller's ``batch_input`` makes them, for example ``batch_generator`` (a
``torch.Generator`` seeded by ``batch_seed(seed, j)``) or, for the
counter-PRNG engines, ``ops/prng.py`` ``fold_in`` (the key words the JAX
package's driver folds).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["batch_seed", "batch_generator", "MegabatchDriver",
           "count_min_driver"]


def batch_seed(seed, j: int) -> int:
    """Deterministic 63-bit generator seed of batch ``j`` of stream
    ``seed`` (an int or a tuple of ints)."""
    entropy = list(seed) if isinstance(seed, (tuple, list)) else [int(seed)]
    state = np.random.SeedSequence(entropy + [int(j)]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def batch_generator(seed, j: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(batch_seed(seed, j))
    return gen


class MegabatchDriver:
    """Fold ``stats_fn(batch_input(seed, j), *extra)`` over batches,
    ``k_inner`` per megabatch.

    stats_fn:    (batch input, *extra) -> tuple of device tensors.
    combine:     (carry, out) -> carry — the on-device fold.
    init_fn:     () -> initial carry (device tensors).
    batch_input: (seed, j) -> what batch ``j`` draws from.
    """

    def __init__(self, stats_fn, combine, init_fn, batch_input,
                 k_inner: int = 8):
        self.k_inner = max(1, int(k_inner))
        self._stats_fn = stats_fn
        self._combine = combine
        self._init_fn = init_fn
        self._batch_input = batch_input
        self.megabatches = 0  # cumulative

    def _megabatch(self, carry, seed, offset, *extra):
        for j in range(self.k_inner):
            batch = self._batch_input(seed, offset + j)
            carry = self._combine(carry, self._stats_fn(batch, *extra))
        self.megabatches += 1
        return carry

    def run(self, seed, n_batches: int, *extra):
        """Fold ``n_batches`` batches (rounded up to a k_inner multiple).
        Returns ``(carry, batches_run)``; the carry is unread device
        tensors."""
        carry, done = self._init_fn(), 0
        for carry, done in self.stream(seed, n_batches, *extra):
            pass
        return carry, done

    def stream(self, seed, n_batches: int, *extra):
        """Yield ``(carry, batches_done)`` after every megabatch, for callers
        that read intermediate values (target-failure early stopping)."""
        k = self.k_inner
        n_run = -(-int(n_batches) // k) * k
        carry = self._init_fn()
        for s in range(0, n_run, k):
            carry = self._megabatch(carry, seed, s, *extra)
            yield carry, s + k


def count_min_driver(stats_fn, min_init: int, device, k_inner: int,
                     batch_input) -> MegabatchDriver:
    """MegabatchDriver for the ``(failure count, min logical weight)`` fold
    on ``device``; ``min_init`` seeds the min-weight track (the code length
    N)."""

    def combine(c, o):
        return (c[0] + o[0], torch.minimum(c[1], o[1]))

    def init():
        return (torch.zeros((), dtype=torch.int32, device=device),
                torch.full((), int(min_init), dtype=torch.int32,
                           device=device))

    return MegabatchDriver(stats_fn, combine, init, batch_input,
                           k_inner=k_inner)

"""Reference ``parmap`` surface (src/Simulators.py:37-61).

The reference forks one process per CPU and feeds shots one at a time through
an mp.Queue — its entire "distributed backend".  Here every engine is already
batched on the card, so parmap exists only for API compatibility with
notebook code that calls it directly.  It maps serially: forking workers
after CUDA initialization is unsafe (a forked child cannot use the parent's
CUDA context), and the per-item closures notebooks pass wrap engines whose
batch path is faster than any process pool.
"""
from __future__ import annotations

__all__ = ["parmap", "fun"]


def fun(f, q_in, q_out):  # pragma: no cover - compat signature only
    """Worker loop of the reference pool (src/Simulators.py:37-42)."""
    while True:
        i, x = q_in.get()
        if i is None:
            break
        q_out.put((i, f(x)))


def parmap(f, X, nprocs=None):
    """Order-preserving map (reference signature, src/Simulators.py:45-61)."""
    del nprocs
    return [f(x) for x in X]

"""Hypergraph-product code construction.

Convention:

    hx = [ h1 (x) I_n2  |  I_m1 (x) h2^T ]
    hz = [ I_n1 (x) h2  |  h1^T (x) I_m2 ]

with qubits ordered (n1*n2 "primal" block, m1*m2 "dual" block).
"""
from __future__ import annotations

import numpy as np

from . import gf2
from .css import CssCode

__all__ = ["hgp", "ring_code", "rep_code"]


def hgp(h1, h2, name: str = "") -> CssCode:
    """Hypergraph product of two classical parity-check matrices."""
    h1 = gf2.to_gf2(h1)
    h2 = gf2.to_gf2(h2)
    m1, n1 = h1.shape
    m2, n2 = h2.shape
    hx = np.concatenate(
        [np.kron(h1, np.eye(n2, dtype=np.uint8)), np.kron(np.eye(m1, dtype=np.uint8), h2.T)],
        axis=1,
    )
    hz = np.concatenate(
        [np.kron(np.eye(n1, dtype=np.uint8), h2), np.kron(h1.T, np.eye(m2, dtype=np.uint8))],
        axis=1,
    )
    return CssCode(hx=hx, hz=hz, name=name)


def rep_code(d: int) -> np.ndarray:
    """(d-1) x d repetition-code parity-check matrix."""
    h = np.zeros((d - 1, d), dtype=np.uint8)
    for i in range(d - 1):
        h[i, i] = 1
        h[i, i + 1] = 1
    return h


def ring_code(d: int) -> np.ndarray:
    """d x d closed-loop repetition code (toric constructions:
    ``hgp(ring_code(d), ring_code(d))``)."""
    h = np.zeros((d, d), dtype=np.uint8)
    for i in range(d):
        h[i, i] = 1
        h[i, (i + 1) % d] = 1
    return h

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

__all__ = ["hgp", "ring_code", "rep_code", "classical_code_distance"]


def hgp(h1, h2, compute_distance: bool = False, name: str = "") -> CssCode:
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
    code = CssCode(hx=hx, hz=hz, name=name)
    if compute_distance:
        code.D = _hgp_distance_upper_bound(code)
    return code


def _hgp_distance_upper_bound(code: CssCode) -> int:
    """Cheap distance estimate: min weight over logical representatives
    reduced by stabilizer rows (upper bound; exact for small codes is done
    via classical_code_distance of the seeds)."""
    best = code.N
    for l, h in ((code.lx, code.hx), (code.lz, code.hz)):
        for row in l:
            w = int(row.sum())
            # greedy weight reduction by stabilizer additions
            cur = row.copy()
            improved = True
            while improved:
                improved = False
                for s in h:
                    cand = cur ^ s
                    if cand.sum() < cur.sum():
                        cur = cand
                        improved = True
            best = min(best, int(cur.sum()), w)
    return best


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


def classical_code_distance(h, max_k: int = 22) -> int:
    """Exhaustive minimum distance of the classical code ker(h)
    (``ldpc.code_util.compute_code_distance``).  Exponential in k; refuses
    beyond ``max_k``.
    """
    ker = gf2.nullspace(h)
    k, n = ker.shape
    if k == 0:
        return int(1e9)  # ldpc's convention for "no codewords"
    if k > max_k:
        raise ValueError(f"k={k} too large for exhaustive distance")
    best = n + 1
    # enumerate non-zero combinations via gray-code accumulation
    cur = np.zeros(n, dtype=np.uint8)
    prev_gray = 0
    for i in range(1, 2**k):
        gray = i ^ (i >> 1)
        changed = (gray ^ prev_gray).bit_length() - 1
        prev_gray = gray
        cur = cur ^ ker[changed]
        w = int(cur.sum())
        if 0 < w < best:
            best = w
    return best

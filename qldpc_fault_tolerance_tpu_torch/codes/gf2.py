"""GF(2) linear algebra on the host (numpy).

The port's own copy of the host routines: rank, reduced row echelon form,
kernels and solutions of {0,1} systems, used once per code (logical
operators, the OSD rank, the reference-name shims).  All matrices are dense ``uint8`` arrays holding
{0,1}.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "to_gf2",
    "rref",
    "rank",
    "nullspace",
    "row_basis",
    "solve",
    "gf2_mul",
    "block_diag",
    "row_reduce_augmented",
    "pack_bitplane",
    "unpack_bitplane",
    "IncrementalRowReducer",
]


def to_gf2(a) -> np.ndarray:
    """Coerce an array-like to a uint8 {0,1} matrix (mod 2)."""
    arr = np.asarray(a)
    if arr.dtype != np.uint8:
        arr = np.mod(np.round(arr).astype(np.int64), 2).astype(np.uint8)
    else:
        arr = arr & 1
    return np.ascontiguousarray(arr)


def rref(a, ncols: int | None = None):
    """Row-reduce ``a`` over GF(2).

    Returns ``(r, pivots)`` where ``r`` is the reduced matrix (same shape)
    and ``pivots`` the list of pivot column indices.  Only the first
    ``ncols`` columns are eligible as pivots (used for augmented systems).
    """
    r = to_gf2(a).copy()
    m, n = r.shape
    if ncols is None:
        ncols = n
    pivots: list[int] = []
    row = 0
    for col in range(ncols):
        if row >= m:
            break
        nz = np.nonzero(r[row:, col])[0]
        if nz.size == 0:
            continue
        piv = row + nz[0]
        if piv != row:
            r[[row, piv]] = r[[piv, row]]
        # eliminate col from every other row with a 1 there
        mask = r[:, col].astype(bool)
        mask[row] = False
        r[mask] ^= r[row]
        pivots.append(col)
        row += 1
    return r, pivots


def rank(a) -> int:
    """GF(2) rank."""
    _, pivots = rref(a)
    return len(pivots)


def nullspace(a) -> np.ndarray:
    """Basis of the right kernel of ``a`` over GF(2), as rows.

    Returns shape ``(n - rank, n)``; empty ``(0, n)`` if full column rank.
    """
    a = to_gf2(a)
    m, n = a.shape
    r, pivots = rref(a)
    pivot_set = set(pivots)
    free = [c for c in range(n) if c not in pivot_set]
    basis = np.zeros((len(free), n), dtype=np.uint8)
    for i, fc in enumerate(free):
        basis[i, fc] = 1
        # back-substitute: pivot row j has leading 1 at pivots[j]
        for j, pc in enumerate(pivots):
            if r[j, fc]:
                basis[i, pc] = 1
    return basis


def row_basis(a) -> np.ndarray:
    """A basis (subset of reduced rows) of the row space of ``a``."""
    r, pivots = rref(a)
    return r[: len(pivots)].copy()


def solve(a, b):
    """One solution ``x`` of ``a @ x = b (mod 2)``, or None if inconsistent."""
    a = to_gf2(a)
    b = to_gf2(np.atleast_1d(b)).ravel()
    m, n = a.shape
    aug = np.concatenate([a, b[:, None]], axis=1)
    r, pivots = rref(aug, ncols=n)
    x = np.zeros(n, dtype=np.uint8)
    nrows = len(pivots)
    # inconsistent iff a zero row of A maps to 1 in b
    if np.any(r[nrows:, n]):
        return None
    for i, pc in enumerate(pivots):
        x[pc] = r[i, n]
    return x


def row_reduce_augmented(a, b):
    """Solve ``x @ a = b`` row-wise for many b: returns coefficients or None per row."""
    a = to_gf2(a)
    b = to_gf2(np.atleast_2d(b))
    return [solve(a.T, row) for row in b]


def block_diag(a, copies: int) -> np.ndarray:
    """The block-diagonal stack of ``copies`` copies of the 0/1 matrix
    ``a`` (uint8): ``copies`` independent codes as one graph."""
    a = to_gf2(a)
    m, n = a.shape
    out = np.zeros((copies * m, copies * n), np.uint8)
    for k in range(copies):
        out[k * m:(k + 1) * m, k * n:(k + 1) * n] = a
    return out


def gf2_mul(a, b) -> np.ndarray:
    """Matrix product over GF(2) (host)."""
    a = to_gf2(a)
    b = to_gf2(b)
    return (a.astype(np.int64) @ b.astype(np.int64) % 2).astype(np.uint8)


def pack_bitplane(bits) -> np.ndarray:
    """Host reference of ``ops.gf2_packed.pack_shots``: (B, ...) {0,1} ->
    (ceil(B/32), ...) uint32, shot ``32*w + j`` in bit ``j`` (LSB-first).
    numpy only, so host artifacts need no device and the device layout is
    pinned by an independent implementation."""
    bits = to_gf2(bits)
    b = bits.shape[0]
    w = -(-b // 32)
    pad = w * 32 - b
    if pad:
        bits = np.concatenate(
            [bits, np.zeros((pad,) + bits.shape[1:], np.uint8)], axis=0)
    x = bits.reshape((w, 32) + bits.shape[1:]).astype(np.uint64)
    shifts = np.arange(32, dtype=np.uint64).reshape(
        (1, 32) + (1,) * (bits.ndim - 1))
    return (x << shifts).sum(axis=1).astype(np.uint32)


def unpack_bitplane(packed, batch_size: int) -> np.ndarray:
    """Inverse of ``pack_bitplane``: (W, ...) uint32 -> (batch_size, ...)
    uint8."""
    packed = np.asarray(packed, dtype=np.uint32)
    w = packed.shape[0]
    shifts = np.arange(32, dtype=np.uint32).reshape(
        (1, 32) + (1,) * (packed.ndim - 1))
    bits = (packed[:, None] >> shifts) & np.uint32(1)
    return bits.reshape((w * 32,) + packed.shape[1:]).astype(
        np.uint8)[:batch_size]


class IncrementalRowReducer:
    """Maintains an online GF(2) row echelon basis.

    Feed candidate vectors and keep the ones that increase the rank — how
    ``css_logicals`` picks logical operators independent of the stabilizers.
    """

    def __init__(self, n: int):
        self.n = n
        self.rows: list[np.ndarray] = []
        self.pivot_cols: list[int] = []

    def reduce(self, v) -> np.ndarray:
        v = to_gf2(np.atleast_1d(v)).ravel().copy()
        for row, pc in zip(self.rows, self.pivot_cols):
            if v[pc]:
                v ^= row
        return v

    def add(self, v) -> bool:
        """Reduce ``v`` against the basis; add if independent. Returns True if added."""
        v = self.reduce(v)
        nz = np.nonzero(v)[0]
        if nz.size == 0:
            return False
        pc = int(nz[0])
        # keep existing rows reduced against the new row
        for i in range(len(self.rows)):
            if self.rows[i][pc]:
                self.rows[i] = self.rows[i] ^ v
        self.rows.append(v)
        self.pivot_cols.append(pc)
        return True

    @property
    def rank(self) -> int:
        return len(self.rows)

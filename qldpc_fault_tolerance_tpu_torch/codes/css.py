"""CSS code objects.

The simulators touch exactly the attributes ``.N, .K, .hx, .hz, .lx, .lz``,
so that is the stable contract here.  A ``CssCode`` is treated as
immutable.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import gf2

__all__ = ["CssCode", "css_logicals"]


def css_logicals(hx: np.ndarray, hz: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Compute logical operator bases (lx, lz) for a CSS code.

    lx: basis of ker(hz) / rowspace(hx)  (X-logicals commute with Z checks)
    lz: basis of ker(hx) / rowspace(hz)

    Any basis of the quotient is valid for the failure checks the simulators
    perform; no symplectic pairing is required.
    """
    hx = gf2.to_gf2(hx)
    hz = gf2.to_gf2(hz)
    n = hx.shape[1]
    if hz.shape[1] != n:
        raise ValueError(f"hx and hz widths differ: {hx.shape} vs {hz.shape}")

    def quotient_basis(ker_of: np.ndarray, im_of: np.ndarray) -> np.ndarray:
        ker = gf2.nullspace(ker_of)
        red = gf2.IncrementalRowReducer(n)
        for row in gf2.row_basis(im_of):
            red.add(row)
        logs = []
        for v in ker:
            if red.add(v):
                logs.append(red.rows[-1])
        if not logs:
            return np.zeros((0, n), dtype=np.uint8)
        return np.stack(logs).astype(np.uint8)

    lx = quotient_basis(hz, hx)
    lz = quotient_basis(hx, hz)
    return lx, lz


@dataclasses.dataclass
class CssCode:
    """A CSS quantum code.

    Attributes
    ----------
    hx, hz : (mx, n), (mz, n) uint8 parity-check matrices
    lx, lz : (K, n) uint8 logical operator bases
    """

    hx: np.ndarray
    hz: np.ndarray
    lx: np.ndarray = None
    lz: np.ndarray = None
    name: str = ""
    D: int | None = None  # distance, when known

    def __post_init__(self):
        self.hx = gf2.to_gf2(self.hx)
        self.hz = gf2.to_gf2(self.hz)
        if self.hx.shape[1] != self.hz.shape[1]:
            raise ValueError(
                f"hx and hz must act on the same qubits: {self.hx.shape} vs {self.hz.shape}"
            )
        if gf2.gf2_mul(self.hx, self.hz.T).any():
            raise ValueError("hx @ hz.T != 0 (mod 2): not a valid CSS code")
        if self.lx is None or self.lz is None:
            self.lx, self.lz = css_logicals(self.hx, self.hz)
        else:
            self.lx = gf2.to_gf2(self.lx)
            self.lz = gf2.to_gf2(self.lz)

    @property
    def N(self) -> int:
        return int(self.hx.shape[1])

    @property
    def K(self) -> int:
        return int(self.lx.shape[0])

    def validate(self) -> None:
        """Assert the full CSS contract: the checks commute, each logical
        basis commutes with the other type's checks, K = N - rank(hx) -
        rank(hz), and no logical row lies in the row space of its own
        type's checks."""
        assert not gf2.gf2_mul(self.hx, self.hz.T).any()
        assert not gf2.gf2_mul(self.hx, self.lz.T).any(), \
            "lz must commute with hx"
        assert not gf2.gf2_mul(self.hz, self.lx.T).any(), \
            "lx must commute with hz"
        assert self.K == self.N - gf2.rank(self.hx) - gf2.rank(self.hz)
        for checks, logicals, name in ((self.hx, self.lx, "lx"),
                                       (self.hz, self.lz, "lz")):
            red = gf2.IncrementalRowReducer(self.N)
            for row in checks:
                red.add(row)
            for row in logicals:
                assert red.add(row), f"{name} row lies in its checks' rowspace"

    def __repr__(self):
        tag = f" {self.name!r}" if self.name else ""
        return f"CssCode{tag}[[{self.N},{self.K}{',' + str(self.D) if self.D else ''}]]"

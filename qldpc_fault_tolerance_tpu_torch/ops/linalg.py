"""GF(2) linear algebra on tensors: syndromes and residual checks of
unpacked {0,1} planes."""
from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device

__all__ = ["ParityOp", "parity_apply", "gf2_matmul", "syndrome",
           "as_device_gf2"]


def gf2_matmul(x, h_t) -> torch.Tensor:
    """Batched GF(2) product ``x @ h_t`` (mod 2).

    x: (..., n) any integer/bool dtype; h_t: (n, m) 0/1.  Returns (..., m)
    uint8.  float32 accumulation is exact for row sums below 2**24."""
    acc = torch.matmul(x.to(torch.float32), h_t.to(torch.float32))
    return torch.remainder(acc, 2.0).to(torch.uint8)


def syndrome(h, e) -> torch.Tensor:
    """Syndrome ``H @ e % 2`` of batched errors e: (..., n) -> (..., m)
    uint8, on e's device."""
    h = torch.as_tensor(np.asarray(h), device=e.device)
    return gf2_matmul(e, h.t())


def as_device_gf2(a, device="cuda") -> torch.Tensor:
    """Host {0,1} matrix -> uint8 tensor on ``device``."""
    return torch.as_tensor(np.asarray(a), dtype=torch.uint8,
                           device=resolve_device(device))


class ParityOp:
    """Sparse GF(2) product ``x @ H.T % 2`` as a padded-adjacency gather.

    Built once per H on the host; ``nbr``/``mask`` are (m, rw) tensors on
    ``device``."""

    def __init__(self, h, device="cuda"):
        device = resolve_device(device)
        h = (np.asarray(h) != 0).astype(np.uint8)
        m, n = h.shape
        rows = [np.nonzero(h[i])[0] for i in range(m)]
        rw = max((len(r) for r in rows), default=1) or 1
        nbr = np.zeros((m, rw), dtype=np.int32)
        mask = np.zeros((m, rw), dtype=bool)
        for i, r in enumerate(rows):
            nbr[i, : len(r)] = r
            mask[i, : len(r)] = True
        self.shape = (m, n)
        self.nbr = torch.from_numpy(nbr).to(device)
        self.mask = torch.from_numpy(mask).to(device)

    def __call__(self, bits):
        """bits: (..., n) {0,1} -> (..., m) uint8 parity."""
        return parity_apply(self.nbr, self.mask, bits)


def parity_apply(nbr, mask, bits) -> torch.Tensor:
    """Padded-adjacency gather parity (the body of ParityOp)."""
    g = bits.to(torch.uint8)[..., nbr.long()]
    s = torch.where(mask, g, 0).sum(dim=-1, dtype=torch.uint8)
    return s & 1

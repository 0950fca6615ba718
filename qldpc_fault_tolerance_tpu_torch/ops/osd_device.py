"""Batched ordered-statistics decoding (OSD-0 / OSD-E) on the device, and
the GF(2) eliminations that OSD-CS (``ops/osd_cs_device.py``) shares.

  * One GF(2) rank serves all shots: H's rank r* is a property of the matrix,
    so every per-shot array has a static shape — only the column order (by
    posterior reliability) differs per shot.
  * Each shot's H is eliminated with its columns in reliability order
    ``perm``.  The GF(2) elimination (``osd_elim(rows, perm, synd)``)
    returns the reduced syndrome, the pivots and a "free panel": for every
    row, the bits at the first ``fcap`` pivotless columns, so OSD-E's T
    matrix is the panel read at the pivot rows.  On CUDA tensors
    ``osd_elim`` launches the Hopper kernel ``csrc/osd_elim.cu``, which
    replaces the TPU kernel ``_elim_blocked_kernel``
    (``qldpc_fault_tolerance_tpu/ops/osd_device.py:547``) and builds each
    shot's permuted columns itself from the column-packed H (``col_pack``,
    built once per rows tensor) at the launch ``elim_layout`` chooses (in
    shared memory; where one shot's matrix does not fit there, as its m x m
    row transform in shared memory, ``osd_elim.transform_launches``, built
    from each column's rows, ``col_rows``; past that in a device-memory
    scratch, ``osd_elim.device_launches``); on
    CPU tensors it packs the permuted rows (W, m, B) (``_permute_and_pack``)
    and runs ``eliminate_plain``, a port of that kernel's blocked twin
    ``_eliminate_blocked_twin`` (:719).  Both are integer-exact and agree
    bit for bit.  ``osd_elim(..., full=True)`` (the OSD-CS route; TPU
    kernel ``_elim_blocked_full_kernel`` :632) also returns the fully
    reduced matrix.
  * The per-column route (``cfg[4] == "pallas_percol"``, the JAX package's
    ``QLDPC_OSD_ELIM=pallas_percol``): ``osd_elim_percol`` returns the
    reduced matrix and the pivot-column flags instead of a free panel, and
    T is read from the reduced pivot rows; its kernel replaces
    ``_elim_kernel`` (:343), its plain version ``eliminate_percol_plain``
    ports ``_eliminate`` (:259).  Both routes give the same pivots and T.
  * OSD-E scores all 2^w free-bit patterns with float32 matmuls (T @ P mod 2
    and cost contractions), chunked so nothing of size (B, r*, 2^w) is
    materialized; only the winning pattern's solution is reconstructed.

Semantics follow the JAX package: the same stable reliability sort,
first-available-row pivoting, strict-< candidate preference in pattern order.
Costs are float32 (the host oracle uses float64): candidates whose costs tie
within float32 may legitimately differ, so comparisons are made on costs.
Keep ``torch.backends.cuda.matmul.allow_tf32`` False on the card.
"""
from __future__ import annotations

import copy
import ctypes
import functools
import os
import weakref
from typing import NamedTuple

import numpy as np
import torch

from ..codes import gf2
from ..decoders.osd import OSD_CS_MAX_ORDER, _channel_cost, _check_osd_order
from ..utils.device import resolve_device
from . import _kernels
from .bp_kernel import _sm_count
from .gf2_packed import to_int32

__all__ = ["OsdPlan", "build_osd_plan", "osd_elim", "eliminate_plain",
           "osd_elim_percol", "eliminate_percol_plain", "elimination_work",
           "col_pack", "col_rows", "ElimLayout", "elim_layout",
           "elim_smem_bytes", "elim_state_bytes", "elim_transform_bytes",
           "card_elim_layout", "eliminate_transform_plain", "transform_work",
           "ELIM_ROUTES", "elim_route", "osd_decode_values",
           "osd_decode_device"]


def pack_rows(h) -> np.ndarray:
    """(m, n) {0,1} -> (m, ceil(n/32)) int32 rows, column c at word c >> 5,
    bit c & 31 (the JAX package's uint32 words, read as int32)."""
    h = (np.asarray(h) != 0).astype(np.uint8)
    m, n = h.shape
    words = (n + 31) // 32
    hp = np.pad(h, ((0, 0), (0, words * 32 - n)))
    packed = (hp.reshape(m, words, 32).astype(np.uint64)
              << np.arange(32, dtype=np.uint64)).sum(axis=2).astype(np.uint32)
    return packed.view(np.int32)


class OsdPlan:
    """Static per-H data for device OSD: rank, packed rows, signed costs."""

    def __init__(self, h, channel_cost, device="cuda"):
        dev = resolve_device(device)
        h = (np.asarray(h) != 0).astype(np.uint8)
        self.m, self.n = h.shape
        self.words = (self.n + 31) // 32
        self.rank = int(gf2.rank(h))
        self.packed = torch.from_numpy(pack_rows(h)).to(dev)
        self.cost = torch.from_numpy(
            np.asarray(channel_cost, np.float32)).to(dev)

    def with_cost(self, channel_cost) -> "OsdPlan":
        """This plan (its rank and packed rows, shared) with other costs."""
        plan = copy.copy(self)
        plan.cost = torch.from_numpy(
            np.asarray(channel_cost, np.float32)).to(self.packed.device)
        return plan


def build_osd_plan(h, channel_probs, device="cuda") -> OsdPlan:
    return OsdPlan(h, _channel_cost(channel_probs), device=device)


def _unpack_rows(packed, n: int) -> torch.Tensor:
    """(m, W) int32 -> (m, n) uint8."""
    m, W = packed.shape
    shifts = torch.arange(32, device=packed.device)
    bits = ((packed[:, :, None] >> shifts) & 1).to(torch.uint8)
    return bits.reshape(m, W * 32)[:, :n]


def col_pack(h01) -> torch.Tensor:
    """(m, n) {0,1} -> (n, ceil(m/32)) int32 columns: row r of column c at
    word r >> 5, bit r & 31."""
    m, n = h01.shape
    mW = (m + 31) // 32
    ht = torch.zeros((n, mW * 32), dtype=torch.int64, device=h01.device)
    ht[:, :m] = h01.t().to(torch.int64)
    shifts = torch.arange(32, device=h01.device)
    return to_int32((ht.reshape(n, mW, 32) << shifts).sum(dim=2))


def col_rows(h01) -> torch.Tensor:
    """(m, n) {0,1} -> (n, cw) int16: each column's rows, ascending, -1 past
    its weight; cw is the heaviest column's weight (at least 1)."""
    ht = h01.t().to(torch.int64)
    weight = ht.sum(dim=1, keepdim=True)
    cw = max(1, int(weight.max())) if ht.numel() else 1
    first = torch.sort(1 - ht, dim=1, stable=True).indices[:, :cw]
    k = torch.arange(first.shape[1], device=h01.device)
    return torch.where(k[None, :] < weight, first, -1).to(torch.int16)


def _permute_and_pack(h01, perm) -> torch.Tensor:
    """Per-shot column-permuted bit-packed rows, batch-last: (W, m, B) int32
    with permuted column t at word t >> 5, bit t & 31 (``_cols_to_rows`` of
    the permuted columns of ``col_pack``)."""
    return _cols_to_rows(col_pack(h01)[perm], h01.shape[0])


def _cols_to_rows(g, m: int) -> torch.Tensor:
    """Column-packed words (B, n, mW) int32 (each column's bits over m rows)
    -> row-packed (W, m, B) int32, column t at word t >> 5, bit t & 31: a
    32x32 bit-matrix transpose (5 masked shift/combine rounds, Hacker's
    Delight 7-3).  Right shifts are arithmetic on int32; each is masked to
    bits it cannot pollute."""
    B, n, mW = g.shape
    W = (n + 31) // 32
    pad = W * 32 - n
    if pad:
        g = torch.cat([g, g.new_zeros((B, pad, mW))], dim=1)
    x = g.permute(1, 2, 0).reshape(W, 32, mW, B)               # j-axis = 1
    # 32x32 bit transpose of (word-index j, bit-index r) -> (r, j); the shift
    # network transposes the bit-reversed orientation, so reverse the j-axis
    # going in and the r-axis coming out
    x = x.flip(1)
    for sh in (16, 8, 4, 2, 1):
        mask = sum(((1 << sh) - 1) << off for off in range(0, 32, 2 * sh))
        x2 = x.reshape(W, 32 // (2 * sh), 2, sh, mW, B)
        lo, hi = x2[:, :, 0], x2[:, :, 1]
        t = (lo ^ (hi >> sh)) & mask
        lo = lo ^ t
        hi = hi ^ (t << sh)
        x = torch.stack([lo, hi], dim=2).reshape(W, 32, mW, B)
    x = x.flip(1)                                              # (W, r, rw, B)
    out = x.permute(0, 2, 1, 3).reshape(W, mW * 32, B)         # row = rw*32+r
    return out[:, :m].contiguous()


def _int32_bit(j: int) -> int:
    """1 << j as an int32 value (bit 31 is negative)."""
    return (1 << j) - (1 << 32 if j == 31 else 0)


def _select_sum(onehot, x) -> torch.Tensor:
    """Sum of ``onehot * x`` over rows: the one selected row (or 0), exact."""
    return (onehot * x).sum(dim=0).to(torch.int32)


def eliminate_plain(packed0, synd0, *, n: int, r_star: int, fcap: int,
                    full: bool = False, count_work: bool = False):
    """Plain PyTorch version of the elimination kernel: a port of the JAX
    package's ``_eliminate_blocked_twin`` (32 columns per block step: a
    micro-elimination on the block's word, then one fused update of the
    words to its right).

    packed0: (W, m, B) int32; synd0: (m, B) int32.  Returns ``(synd (m, B),
    pivot_rows (r*, B), pivot_cols (r*, B), fword (m, B), fpos (32, B))``,
    all int32.  ``full`` (the OSD-CS route) applies each block's update to
    every word, the current one included, and appends the fully reduced
    matrix (W, m, B).  ``count_work`` appends the per-shot word-operation
    count of the column-by-column elimination (see ``elimination_work``)."""
    W, m, B = packed0.shape
    dev = packed0.device
    i32 = torch.int32
    packed = packed0.clone()
    synd = synd0.clone()
    used = torch.zeros((m, B), dtype=i32, device=dev)
    fword = torch.zeros((m, B), dtype=i32, device=dev)
    rank = torch.zeros(B, dtype=i32, device=dev)
    fcnt = torch.zeros(B, dtype=i32, device=dev)
    pr = torch.zeros((r_star, B), dtype=i32, device=dev)
    pc = torch.zeros((r_star, B), dtype=i32, device=dev)
    fpos = torch.zeros((32, B), dtype=i32, device=dev)
    work = torch.zeros(B, dtype=torch.int64, device=dev)
    rows_m = torch.arange(m, dtype=i32, device=dev)[:, None]
    slots = torch.arange(r_star, dtype=i32, device=dev)[:, None]
    k32 = torch.arange(32, dtype=i32, device=dev)[:, None]
    t_word = 0
    while t_word < W and bool(((rank < r_star) | (fcnt < fcap)).any()):
        cw = packed[t_word].clone()
        aug = torch.zeros((m, B), dtype=i32, device=dev)
        pivword = torch.zeros((m, B), dtype=i32, device=dev)
        for j in range(32):
            t = t_word * 32 + j
            live = ((rank < r_star) | (fcnt < fcap)) & (t < n)
            bits = (cw >> j) & 1
            active = (rank < r_star).to(i32)
            avail = bits * (1 - used) * active[None, :]
            cand = torch.where(avail == 1, rows_m, m)
            piv = cand.min(dim=0).values
            has = ((piv < m) & (t < n)).to(i32)
            piv = torch.where(piv < m, piv, 0)
            onehot = torch.where(rows_m == piv[None, :], has[None, :], 0)
            prow = _select_sum(onehot, cw)
            ps = _select_sum(onehot, synd)
            paug = _select_sum(onehot, aug)
            pf = _select_sum(onehot, fword)
            clear = bits * (1 - onehot) * has[None, :]
            cw = cw ^ (clear * prow[None, :])
            synd = synd ^ (clear * ps[None, :])
            aug = aug ^ (clear * (paug ^ _int32_bit(j))[None, :])
            fword = fword ^ (clear * pf[None, :])
            pivword = pivword | (onehot << j)
            # free-column panel: no pivot at a real column -> record its
            # (current, reduced) bits at free slot fcnt
            grow = (1 - has) * ((fcnt < fcap) & (t < n)).to(i32)
            kshift = torch.clamp(fcnt, max=31)
            fword = fword ^ ((bits << kshift[None, :]) * grow[None, :])
            fpos = torch.where((k32 == fcnt[None, :]) & (grow[None, :] == 1),
                               t, fpos)
            at = (slots == rank[None, :]) & (has[None, :] == 1)
            pr = torch.where(at, piv[None, :], pr)
            pc = torch.where(at, t, pc)
            used = used | onehot
            rank = rank + has
            fcnt = fcnt + grow
            if count_work:
                cleared = clear.sum(dim=0) * (W - t_word + 1 + (fcap > 0))
                work += torch.where(live, m + cleared, 0)
        # each delta is computed on block-start values, so applied to the
        # current word too it reproduces phase A exactly
        lo = 0 if full else t_word + 1
        if lo < W:
            rows = packed[lo:]
            packed[lo:] = rows ^ _phase_b_delta(rows, pivword, aug)
        t_word += 1
    out = (synd, pr, pc, fword, fpos) + ((packed,) if full else ())
    return out + (work,) if count_work else out


def _phase_b_delta(rows, pivword, aug) -> torch.Tensor:
    """Fused 32-term block update of words ``rows`` (K, m, B), read at their
    block-start values: bit j of ``aug[r]`` selects step j's pivot row into
    row r's XOR accumulator."""
    acc = torch.zeros_like(rows)
    for j in range(32):
        oh = (pivword >> j) & 1
        g0 = (oh[None] * rows).sum(dim=1).to(torch.int32)     # (K, B)
        sel = -((aug >> j) & 1)
        acc = acc ^ (sel[None] & g0[:, None, :])
    return acc


def eliminate_percol_plain(packed0, synd0, *, n: int, r_star: int):
    """Plain PyTorch version of the per-column elimination kernel: a port of
    the JAX package's ``_eliminate`` (one pivot column per step, every word
    of every other row with the column's bit cleared).

    packed0: (W, m, B) int32; synd0: (m, B) int32.  Returns ``(u_piv (r*, B)
    reduced syndrome at the pivot rows, pivot_rows (r*, B), pivot_cols
    (r*, B), ip (n, B) bool pivot-column flags, packed (W, m, B) reduced
    matrix)``, int32 but ``ip``.  Its kernel's work is
    ``elimination_work(..., fcap=0)``."""
    W, m, B = packed0.shape
    dev = packed0.device
    i32 = torch.int32
    packed = packed0.clone()
    synd = synd0.clone()
    used = torch.zeros((m, B), dtype=torch.bool, device=dev)
    rank = torch.zeros(B, dtype=i32, device=dev)
    pr = torch.zeros((r_star, B), dtype=i32, device=dev)
    pc = torch.zeros((r_star, B), dtype=i32, device=dev)
    ip = torch.zeros((n, B), dtype=torch.bool, device=dev)
    rows_m = torch.arange(m, dtype=i32, device=dev)[:, None]
    slots = torch.arange(r_star, dtype=i32, device=dev)[:, None]
    t = 0
    while t < n and bool((rank < r_star).any()):
        bits = ((packed[t >> 5] >> (t & 31)) & 1) == 1         # (m, B)
        active = rank < r_star
        avail = bits & ~used & active[None, :]
        has = avail.any(dim=0)
        piv = torch.where(avail, rows_m, m).min(dim=0).values  # first avail
        onehot = rows_m == piv[None, :]
        prow = (onehot[None] * packed).sum(dim=1).to(i32)       # (W, B)
        ps = (onehot * synd).sum(dim=0).to(i32)
        clear = bits & ~onehot & has[None, :]
        packed = packed ^ torch.where(clear[None], prow[:, None, :], 0)
        synd = synd ^ torch.where(clear, ps[None, :], 0)
        at = (slots == rank[None, :]) & has[None, :]
        pr = torch.where(at, piv[None, :], pr)
        pc = torch.where(at, t, pc)
        ip[t] = has
        used = used | (onehot & has[None, :])
        rank = rank + has.to(i32)
        t += 1
    return synd.gather(0, pr.long()), pr, pc, ip, packed


def eliminate_transform_plain(rows, perm, synd0, *, r_star: int, fcap: int,
                              full: bool = False, count_work: bool = False):
    """Plain PyTorch model of the elimination kernel's transform mode: the
    same column walk as ``eliminate_plain`` (first available row, free
    columns recorded while fewer than ``fcap``), run on each shot's row
    transform T (m x m, the identity at first, with the syndrome as its
    column m) instead of its matrix.  A walked column is gathered as the
    XOR of T's columns at its rows (``rows`` (n, cw) int16, ``col_rows``;
    the permuted column t of shot b is ``rows[perm[b, t]]``), and a pivot
    step XORs the pivot column, without its pivot bit, into every column
    of T whose bit at the pivot row is set.  Once the rank is r*, T is
    frozen; the free panel and the reduced matrix (``full``) are T a_c of
    their columns.

    synd0: (m, B) int32.  Returns ``eliminate_plain``'s arrays, bit for
    bit.  ``count_work`` appends the per-shot word operations of the
    transform walk (``transform_work``)."""
    B, n = perm.shape
    m = synd0.shape[0]
    mW = (m + 31) // 32
    Q = m + 2  # m columns, the syndrome and a zero column
    dev = perm.device
    i32, i64 = torch.int32, torch.int64
    bidx = torch.arange(B, device=dev)
    j = torch.arange(m, device=dev)
    T = torch.zeros((B, mW, Q), dtype=i64, device=dev)
    T[:, j >> 5, j] = torch.ones_like(j) << (j & 31)
    T[:, :, m] = _pack_bits(synd0.t().to(i64) & 1, mW)
    r = rows.to(dev, i64)
    r = torch.where((r >= 0) & (r < m), r, m + 1)            # (n, cw)
    cw = r.shape[1]
    weight = (r <= m).sum(dim=1)                              # (n,)

    def gather(cols):
        """The columns ``cols`` (B, k) of T A: (B, mW, k) words."""
        rc = r[cols]                                          # (B, k, cw)
        k = cols.shape[1]
        g = T.gather(2, rc.reshape(B, 1, k * cw).expand(B, mW, k * cw))
        g = g.reshape(B, mW, k, cw)
        x = g[..., 0]
        for kk in range(1, cw):
            x = x ^ g[..., kk]
        return x

    used = torch.zeros((B, mW), dtype=i64, device=dev)
    rank = torch.zeros(B, dtype=i64, device=dev)
    fcnt = torch.zeros(B, dtype=i64, device=dev)
    pr = torch.zeros((r_star, B), dtype=i32, device=dev)
    pc = torch.zeros((r_star, B), dtype=i32, device=dev)
    fpos = torch.zeros((32, B), dtype=i32, device=dev)
    work = torch.zeros(B, dtype=i64, device=dev)
    slots = torch.arange(r_star, device=dev)[:, None]
    k32 = torch.arange(32, device=dev)[:, None]
    for t in range(n):
        live = (rank < r_star) | (fcnt < fcap)
        if not bool(live.any()):
            break
        active = rank < r_star
        col = gather(perm[:, t:t + 1])[..., 0]               # (B, mW)
        avail = col & ~used
        nz = avail != 0
        has = nz.any(dim=1) & active
        w0 = nz.to(torch.int8).argmax(dim=1)                  # first such word
        word = avail[bidx, w0]
        low = torch.where(has, word & -word, 1)
        bit = torch.log2(low.double()).round().to(i64)       # exact: 2^k
        piv = torch.where(has, w0 * 32 + bit, 0)
        pw, pbit = piv >> 5, (torch.ones_like(piv) << (piv & 31)) * has
        hit = ((T[bidx, pw, :] >> (piv & 31)[:, None]) & 1) * has[:, None]
        pcol = col.clone()
        pcol[bidx, pw] ^= pbit
        T ^= hit[:, None, :] * pcol[:, :, None]
        used[bidx, pw] |= pbit
        at = (slots == rank[None, :]) & has[None, :]
        pr = torch.where(at, piv[None, :].to(i32), pr)
        pc = torch.where(at, t, pc)
        grow = ~has & (fcnt < fcap)
        fpos = torch.where((k32 == fcnt[None, :]) & grow[None, :], t, fpos)
        if count_work:
            # the gather and its test, then a step's m + 1 tests and the
            # set columns' XORs
            step = weight[perm[:, t]] * mW + mW * active
            step = step + has * (m + 1 + hit.sum(dim=1) * mW)
            work += torch.where(live, step, 0)
        rank = rank + has
        fcnt = fcnt + grow
    synd = _unpack_bits(T[:, :, m], m).t().to(i32).contiguous()
    fword = torch.zeros((m, B), dtype=i64, device=dev)
    if fcap > 0:
        free = perm.gather(1, fpos.t().long())                 # (B, 32)
        bits = _unpack_bits(gather(free).permute(0, 2, 1), m)  # (B, 32, m)
        live_k = (k32.t() < fcnt[:, None]).to(i64)             # (B, 32)
        fword = ((bits * live_k[:, :, None])
                 << torch.arange(32, device=dev)[None, :, None]).sum(dim=1).t()
        if count_work:
            work += (weight[free] * live_k).sum(dim=1) * mW
    out = (synd, pr, pc, to_int32(fword).contiguous(), fpos)
    if full:
        cols = torch.cat([gather(perm[:, c0:c0 + 256])
                          for c0 in range(0, n, 256)], dim=2)  # (B, mW, n)
        out = out + (_cols_to_rows(to_int32(cols.permute(0, 2, 1)), m),)
        if count_work:
            work += weight[perm].sum(dim=1) * mW
    return out + (work,) if count_work else out


def transform_work(rows, perm, synd, *, r_star: int, fcap: int,
                   full: bool = False) -> int:
    """Word operations the transform walk of these inputs needs
    (``eliminate_transform_plain``): per walked column the XOR of T's words
    at its rows and the test of its words against the used rows; per pivot
    step one test of each of T's m + 1 columns and the pivot column's words
    XORed into each set one; the free panel's (and with ``full`` every
    column's) gathers after the walk."""
    out = eliminate_transform_plain(rows, perm, synd, r_star=r_star,
                                    fcap=fcap, full=full, count_work=True)
    return int(out[-1].sum())


def _pack_bits(bits, words: int) -> torch.Tensor:
    """(..., k) {0,1} int64 -> (..., words) 32-bit words in int64, bit i at
    word i >> 5, bit i & 31."""
    pad = words * 32 - bits.shape[-1]
    bits = torch.nn.functional.pad(bits, (0, pad))
    shifts = torch.arange(32, device=bits.device)
    return (bits.reshape(*bits.shape[:-1], words, 32) << shifts).sum(dim=-1)


def _unpack_bits(words, k: int) -> torch.Tensor:
    """(..., W) 32-bit words -> (..., k) {0,1} int64, bit i of word i >> 5."""
    shifts = torch.arange(32, device=words.device)
    bits = (words.to(torch.int64)[..., None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], -1)[..., :k]


def _elim_argtypes(n_ptrs: int, n_ints: int):
    p, i = ctypes.c_void_p, ctypes.c_int
    return [p] * n_ptrs + [i] * n_ints + [p, p, i, p]


# shared memory a block may take on Hopper (227 KB), and an SM's (228 KB,
# 1 KB of it reserved per block); threads an SM holds
SMEM_LIMIT = 232448
SM_SMEM = 233472
SM_THREADS = 2048
# elim_layout: a shot's threads, from ELIM_MIN_THREADS (2048 shots: more
# blocks per SM) to one lane per column of the first pivot step (at most
# ELIM_MAX_THREADS), so that the shots an SM holds share its ELIM_SM_THREADS;
# an even number of warps: warp 0 walks, and the others' columns (every
# (warps - 1)-th) hit 32 banks.  The kernel's ~64 registers a thread let an
# SM hold 1024 of its threads.
ELIM_SM_THREADS = 1024
# the transform mode's shots share 512 threads an SM: 256 a shot at two
# shots an SM took 5.96 ms at phase 30's 2048 shots, 384 6.18, 512 6.53
# (chip runs, NVIDIA H100 80GB HBM3, 700.00 W)
ELIM_TRANSFORM_SM_THREADS = 512
ELIM_MIN_THREADS = 64
ELIM_MAX_THREADS = 1024
ELIM_MODES = ("skip", "full", "percol")


class ElimLayout(NamedTuple):
    threads: int     # threads per block, all on one shot
    shots: int       # shots per block
    grid: int        # blocks launched: one per shot
    smem_bytes: int  # dynamic shared memory per block
    resident: int    # blocks per SM by threads and shared memory
    # _kernels.ELIM_MEMORY_MODES: "shared", the shot's matrix in shared
    # memory; "device", in a device-memory scratch of scratch_bytes per
    # shot; "transform", its m x m row transform in shared memory
    memory: str = "shared"
    scratch_bytes: int = 0


def elim_smem_bytes(m: int, n: int) -> int:
    """Dynamic shared memory of csrc/osd_elim.cu per shot: the column-packed
    matrix and syndrome (ceil(m/32) words per column, a row of (n + 1) | 1
    columns per word), the used rows, 6 words of the walk's state, 32 free
    positions and the pivots' rows and columns (r* <= m each)."""
    mW = (m + 31) // 32
    return 4 * (mW * ((n + 1) | 1) + mW + 6 + 32 + 2 * m)


def elim_state_bytes(m: int) -> int:
    """Dynamic shared memory of csrc/osd_elim.cu's device-memory mode per
    shot: ``elim_smem_bytes`` without the matrix, which lives in a
    device-memory scratch of ``elim_smem_bytes(m, n) - elim_state_bytes(m)``
    bytes per shot."""
    return 4 * ((m + 31) // 32 + 6 + 32 + 2 * m)


def elim_transform_bytes(m: int, n: int, cw: int) -> int:
    """Dynamic shared memory of csrc/osd_elim.cu's transform mode per shot:
    the row transform T with the syndrome (ceil(m/32) words per column, a
    row of (m + 2) | 1 columns per word: T's m, the syndrome and a zero
    column), the used rows, two pivot columns and two windows of 8 columns,
    6 words of the walk's state, 32 free positions, the pivots' rows and
    columns, and each permuted column's ``cw`` rows in 16 bits.  It grows
    with m^2 and only by the rows with n."""
    mW = (m + 31) // 32
    return (4 * (mW * (((m + 2) | 1) + 3 + 16) + 6 + 32 + 2 * m)
            + 4 * ((cw * n + 1) // 2))


def elim_layout(B: int, m: int, n: int, fcap: int, mode: str, sm_count: int,
                threads: int | None = None, memory: str = "shared",
                cw: int = 4) -> ElimLayout:
    """The launch of csrc/osd_elim.cu for B shots of an (m, n) matrix whose
    columns have at most ``cw`` rows (4 in the hypergraph-product codes and
    their [H|I]; the wrappers pass their H's).

    One block per shot (a step's barriers are the shot's own).  The shots
    an SM holds at once (ceil(B / sm_count), at most what shared memory
    allows) share ELIM_SM_THREADS threads (ELIM_TRANSFORM_SM_THREADS in the
    transform mode); a shot takes at least
    ELIM_MIN_THREADS and at most one lane per column that the first pivot
    step tests (n + 1 in the matrix, m + 1 in the transform), in an even
    number of warps.  ``threads`` fixes the threads per shot instead.
    ``memory`` (_kernels.ELIM_MEMORY_MODES): ``"shared"``, the
    shared-memory mode, raises with the bytes where one shot's matrix does
    not fit; ``"transform"`` (``skip`` and ``full`` only) keeps the shot's
    row transform in shared memory instead (``elim_transform_bytes``; it
    raises where that does not fit); ``"device"`` is the kernel's
    device-memory mode, whose matrix lives in a scratch of
    ``scratch_bytes`` per shot (it raises only where not even the walk's
    state fits); ``"auto"``, as the card's wrappers ask, the first of the
    three that fits (the per-column route has no transform mode).  (The
    elimination has no ``"device_planes"`` or ``"checks"`` mode: it reads
    no graph planes and keeps no check records.)"""
    if mode not in ELIM_MODES:
        raise ValueError(f"elimination mode {mode!r} is not one of {ELIM_MODES}")
    if not 0 <= fcap <= (0 if mode == "percol" else 32):
        raise ValueError(f"the {mode} elimination takes fcap in 0.."
                         f"{0 if mode == 'percol' else 32}, got {fcap}")
    if memory not in ("auto",) + _kernels.ELIM_MEMORY_MODES:
        raise ValueError(f"elimination memory {memory!r} is not 'auto' or "
                         f"one of {_kernels.ELIM_MEMORY_MODES}")
    smem = elim_smem_bytes(m, n)
    t_smem = elim_transform_bytes(m, n, cw)
    if memory == "auto":
        memory = ("shared" if smem <= SMEM_LIMIT
                  else "transform" if mode != "percol" and t_smem <= SMEM_LIMIT
                  else "device")
    scratch, useful, sm_threads = 0, n + 1, ELIM_SM_THREADS
    if memory == "device":
        scratch, smem = smem - elim_state_bytes(m), elim_state_bytes(m)
    elif memory == "transform":
        if mode == "percol":
            raise ValueError("the per-column elimination has no transform "
                             "mode")
        smem, useful, sm_threads = t_smem, m + 1, ELIM_TRANSFORM_SM_THREADS
    if smem > SMEM_LIMIT:
        raise ValueError(f"the elimination kernels: a {m}x{n} matrix needs "
                         f"{smem} bytes of shared memory per shot"
                         f"{' in its transform' if memory == 'transform' else ''}"
                         f", above {SMEM_LIMIT}")
    if threads is None:
        per_sm = max(1, min(-(-B // sm_count), SM_SMEM // (smem + 1024)))
        threads = max(ELIM_MIN_THREADS,
                      min(-(-useful // 32) * 32, ELIM_MAX_THREADS,
                          sm_threads // per_sm // 32 * 32))
        threads -= threads % 64
    if threads % 64 or not 64 <= threads <= ELIM_MAX_THREADS:
        raise ValueError(f"the elimination kernels take 64..{ELIM_MAX_THREADS} "
                         f"threads per shot in an even number of warps, got "
                         f"{threads}")
    resident = max(1, min(SM_THREADS // threads, SM_SMEM // (smem + 1024)))
    return ElimLayout(threads, 1, max(B, 1), smem, resident, memory, scratch)


@functools.lru_cache(maxsize=None)
def elim_resident(index: int, mode: str, m: int, threads: int,
                  smem_bytes: int, memory: str = "shared") -> int:
    """Blocks of csrc/osd_elim.cu (the kernel for m rows, in ``memory``)
    that one SM of CUDA device ``index`` holds at once
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    fn = _kernels.library("osd_elim").osd_elim_resident
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    with torch.cuda.device(index):
        rc = fn(ELIM_MODES.index(mode), m, threads, smem_bytes,
                _kernels.ELIM_MEMORY_MODES.index(memory),
                ctypes.addressof(blocks))
    _kernels.check_launch("osd_elim_resident", rc)
    return blocks.value


def card_elim_layout(dev, B: int, m: int, n: int, fcap: int,
                     mode: str, memory: str = "auto",
                     cw: int = 4) -> ElimLayout:
    """``elim_layout`` on CUDA device ``dev`` (by default the transform or
    device-memory mode where the matrix does not fit shared memory): its SM
    count, and the resident blocks the card reports, registers included."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    lay = elim_layout(B, m, n, fcap, mode, _sm_count(index), memory=memory,
                      cw=cw)
    held = elim_resident(index, mode, m, lay.threads, lay.smem_bytes,
                         lay.memory)
    if held < 1:
        raise ValueError(f"the elimination kernels: a block of {lay.threads} "
                         f"threads and {lay.smem_bytes} bytes does not fit")
    return lay._replace(resident=held)


_COLPACK: dict = {}


def _cached(table: dict, build, h_packed, n: int) -> torch.Tensor:
    """``build`` of the rows ``h_packed``' bits (m, n), made once for as
    long as the tensor lives."""
    key = (id(h_packed), n)
    hit = table.get(key)
    if hit is not None and hit[0]() is h_packed:
        return hit[1]
    out = build(_unpack_rows(h_packed, n))
    table[key] = (weakref.ref(h_packed, lambda _, k=key: table.pop(k, None)),
                  out)
    return out


def _colpack_of(h_packed, n: int) -> torch.Tensor:
    """``col_pack`` of the rows ``h_packed``, built once for as long as the
    tensor lives."""
    return _cached(_COLPACK, col_pack, h_packed, n)


_COLROWS: dict = {}


def _colrows_of(h_packed, n: int) -> torch.Tensor:
    """``col_rows`` of the rows ``h_packed`` (the transform mode's input),
    built once for as long as the tensor lives."""
    return _cached(_COLROWS, col_rows, h_packed, n)


def _check_elim(name, h_packed, perm, synd, n: int, r_star: int,
                fcap: int) -> int:
    """Raise on inputs the elimination kernels cannot take; returns m."""
    m, W = h_packed.shape
    B = perm.shape[0]
    if (h_packed.dtype != torch.int32 or synd.dtype != torch.int32
            or perm.dtype != torch.int64):
        raise ValueError(f"{name} takes int32 rows and syndromes and an int64 "
                         f"permutation")
    if (W != (n + 31) // 32 or perm.dim() != 2 or perm.shape[1] != n
            or tuple(synd.shape) != (m, B)):
        raise ValueError(f"{name} shape mismatch: rows {tuple(h_packed.shape)}, "
                         f"perm {tuple(perm.shape)}, syndromes "
                         f"{tuple(synd.shape)}, n={n}")
    if (len({h_packed.device, perm.device, synd.device}) != 1
            or not perm.is_contiguous() or not synd.is_contiguous()):
        raise ValueError(f"{name} takes contiguous inputs on one device")
    if not 0 <= r_star <= m:
        raise ValueError(f"{name} takes r* <= m, got r*={r_star}")
    if W * m * B >= 2 ** 31 or n * B >= 2 ** 31:
        raise ValueError(f"{name} batch too large for int32 indexing")
    return m


def _elim_call(name, fn, mode, h_packed, perm, synd, outs, n, r_star,
               fcap) -> str:
    """Launch ``fn`` of csrc/osd_elim.cu on the column-packed H (or, in the
    transform mode, each column's rows), the permutation and the syndromes,
    writing ``outs``, in the memory mode ``card_elim_layout`` picks (or
    ``_kernels.force_memory`` fixes); returns that mode."""
    m = _check_elim(name, h_packed, perm, synd, n, r_star, fcap)
    B = perm.shape[0]
    dev = perm.device
    colrows = _colrows_of(h_packed, n)
    lay = card_elim_layout(dev, B, m, n, fcap, mode, _kernels.memory_mode(),
                           cw=colrows.shape[1])
    colpack = _colpack_of(h_packed, n)
    fixed = [m, n, r_star] + ([] if mode == "percol" else [fcap])
    scratch = rows = None
    if lay.memory == "device":
        scratch = torch.empty((B * lay.scratch_bytes // 4,),
                              dtype=torch.int32, device=dev)
    elif lay.memory == "transform":
        rows = colrows
    fn.argtypes = _elim_argtypes(3 + len(outs), len(fixed) + 3)
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(colpack.data_ptr(), perm.data_ptr(), synd.data_ptr(),
                *(o.data_ptr() for o in outs), *fixed, B, lay.threads,
                lay.smem_bytes, None if scratch is None else scratch.data_ptr(),
                None if rows is None else rows.data_ptr(),
                colrows.shape[1], stream)
    _kernels.check_launch(name, rc)
    return lay.memory


def osd_elim(h_packed, perm, synd, *, n: int, r_star: int, fcap: int,
             full: bool = False):
    """GF(2) elimination of H (rows ``h_packed`` (m, W) int32) with its
    columns in each shot's order ``perm`` (B, n) int64 and the (m, B) int32
    0/1 syndromes augmented.  Returns the int32 arrays of
    ``eliminate_plain`` on ``_permute_and_pack``'s matrix: five, and with
    ``full`` the fully reduced matrix as a sixth.  CUDA tensors launch
    ``csrc/osd_elim.cu`` (``osd_elim_launch``, or ``osd_elim_full_launch``
    with ``full``), which builds each shot's columns itself, or raise; CPU
    tensors pack and run ``eliminate_plain``.  ``launches`` counts the
    first kernel, ``full_launches`` the second; ``device_launches`` and
    ``full_device_launches`` those of theirs that ran in device memory,
    ``transform_launches`` and ``full_transform_launches`` those in the
    transform mode."""
    if not perm.is_cuda or _kernels.plain_forced():
        packed = _permute_and_pack(_unpack_rows(h_packed, n), perm)
        return eliminate_plain(packed, synd, n=n, r_star=r_star, fcap=fcap,
                               full=full)
    m, W = h_packed.shape
    B = perm.shape[0]
    dev = perm.device
    synd_out = torch.empty((m, B), dtype=torch.int32, device=dev)
    # the kernel writes the free panel only when it has one
    fword = (torch.empty if fcap else torch.zeros)((m, B), dtype=torch.int32,
                                                   device=dev)
    pr = torch.zeros((r_star, B), dtype=torch.int32, device=dev)
    pc = torch.zeros((r_star, B), dtype=torch.int32, device=dev)
    fpos = torch.zeros((32, B), dtype=torch.int32, device=dev)
    outs = [synd_out, pr, pc, fword, fpos]
    lib = _kernels.library("osd_elim")
    if full:
        outs.append(torch.empty((W, m, B), dtype=torch.int32, device=dev))
    memory = _elim_call("osd_elim", lib.osd_elim_full_launch if full
                        else lib.osd_elim_launch, "full" if full else "skip",
                        h_packed, perm, synd, outs, n, r_star, fcap)
    prefix = "full_" if full else ""
    _kernels.count_launch(osd_elim, prefix + "launches", dev)
    for mem in ("device", "transform"):
        _kernels.count_launch(osd_elim, f"{prefix}{mem}_launches", dev,
                              memory == mem)
    return tuple(outs)


osd_elim.launches = 0
osd_elim.full_launches = 0
osd_elim.device_launches = 0
osd_elim.full_device_launches = 0
osd_elim.transform_launches = 0
osd_elim.full_transform_launches = 0


def osd_elim_percol(h_packed, perm, synd, *, n: int, r_star: int):
    """Per-column GF(2) elimination of H (rows ``h_packed``) in each shot's
    column order ``perm`` (B, n) with the (m, B) int32 0/1 syndromes
    augmented.  Returns the arrays of ``eliminate_percol_plain`` on
    ``_permute_and_pack``'s matrix.  CUDA tensors launch
    ``csrc/osd_elim.cu`` (``osd_elim_percol_launch``; ``device_launches``
    counts those in device memory) or raise; CPU tensors pack and run
    ``eliminate_percol_plain``."""
    if not perm.is_cuda or _kernels.plain_forced():
        packed = _permute_and_pack(_unpack_rows(h_packed, n), perm)
        return eliminate_percol_plain(packed, synd, n=n, r_star=r_star)
    m, W = h_packed.shape
    B = perm.shape[0]
    dev = perm.device
    synd_out = torch.empty((m, B), dtype=torch.int32, device=dev)
    pr = torch.zeros((r_star, B), dtype=torch.int32, device=dev)
    pc = torch.zeros((r_star, B), dtype=torch.int32, device=dev)
    ip = torch.zeros((n, B), dtype=torch.int32, device=dev)
    packed_out = torch.empty((W, m, B), dtype=torch.int32, device=dev)
    memory = _elim_call(
        "osd_elim_percol",
        _kernels.library("osd_elim").osd_elim_percol_launch, "percol",
        h_packed, perm, synd, [synd_out, pr, pc, ip, packed_out], n, r_star, 0)
    _kernels.count_launch(osd_elim_percol, "launches", dev)
    _kernels.count_launch(osd_elim_percol, "device_launches", dev,
                          memory == "device")
    return synd_out.gather(0, pr.long()), pr, pc, ip == 1, packed_out


osd_elim_percol.launches = 0
osd_elim_percol.device_launches = 0


def elimination_work(packed, synd, *, n: int, r_star: int,
                     fcap: int) -> int:
    """Word operations the column-by-column elimination of these inputs
    needs, in any of the three kernel modes (the per-column route at
    ``fcap=0``): per processed column, one test of each of the m rows, plus
    for every row it clears (W - w + 1) word XORs (the row's words from the
    pivot's word rightwards and its syndrome), and its free-panel word when
    ``fcap > 0``.  The pivot row is zero left of its word, so no mode needs
    more."""
    out = eliminate_plain(packed, synd, n=n, r_star=r_star, fcap=fcap,
                          count_work=True)
    return int(out[-1].sum())


#: elimination routes of the ``cfg[4]`` slot: the blocked route (kernel
#: ``osd_elim_launch``, or ``osd_elim_full_launch`` for OSD-CS) and the
#: per-column route (``osd_elim_percol_launch``)
ELIM_ROUTES = ("pallas", "pallas_percol")


def elim_route(elim=None) -> str:
    """The elimination route ``elim``, or when None ``QLDPC_OSD_ELIM``
    (default ``"pallas"``).  Raises on a route the port does not have."""
    if elim is None:
        elim = os.environ.get("QLDPC_OSD_ELIM", "pallas")
    if elim not in ELIM_ROUTES:
        raise ValueError(f"unknown OSD elimination route {elim!r}; the port "
                         f"has {ELIM_ROUTES}")
    return elim


def _reduced_bits(rows, cols) -> torch.Tensor:
    """Bits of the reduced pivot rows ``rows`` (W, r*, B) at the permuted
    columns ``cols`` (k, B): (k, r*, B) int32 {0, 1}."""
    k, B = cols.shape
    word = (cols >> 5)[:, None, :].expand(k, rows.shape[1], B)
    return (rows.gather(0, word) >> (cols & 31)[:, None, :]) & 1


def free_positions(n: int, k: int, *, ip=None, pc=None) -> torch.Tensor:
    """The first ``k`` free (non-pivot) permuted positions of every shot,
    ascending, which is reliability order: (k, B) int64.  From the
    pivot-column flags ``ip`` (n, B), or when None from the pivot columns
    ``pc`` (r*, B) (every shot reaches rank r*, so every slot is a real
    permuted column)."""
    if ip is None:
        ip = torch.zeros((n, pc.shape[1]), dtype=torch.bool,
                         device=pc.device).scatter_(0, pc.long(), True)
    # stable: the non-pivot positions (0) keep their ascending order
    return torch.sort(ip.to(torch.uint8), dim=0, stable=True).indices[:k]


def pivot_rows(packed, pr) -> torch.Tensor:
    """The reduced matrix (W, m, B) read at the pivot rows pr (r*, B)."""
    W = packed.shape[0]
    return packed.gather(1, pr.long()[None].expand(W, *pr.shape))


def osd_decode_values(cfg, h_packed, cost, syndromes, posterior_llrs, *,
                      device="cuda"):
    """OSD decode of a (B, m) syndrome batch from BP posteriors (B, n).

    ``cfg`` = (n, rank, osd_order, pat_chunk[, elim]), ``elim`` one of
    ``ELIM_ROUTES`` (see ``elim_route``); ``h_packed`` (m, W) int32 rows and
    ``cost`` (n,) float32 signed costs.  Returns (B, n) uint8."""
    n, r_star, osd_order, pat_chunk = cfg[:4]
    elim = elim_route(cfg[4] if len(cfg) > 4 else None)
    dev = resolve_device(device)
    h_packed = torch.as_tensor(h_packed).to(dev)
    cost = torch.as_tensor(cost).to(dev, torch.float32)
    syndromes = torch.as_tensor(syndromes).to(dev)
    posterior_llrs = torch.as_tensor(posterior_llrs).to(dev, torch.float32)
    B = syndromes.shape[0]
    perm = torch.sort(posterior_llrs, dim=1, stable=True).indices  # (B, n)
    w = min(_check_osd_order(osd_order), n - r_star, OSD_CS_MAX_ORDER)
    synd0 = syndromes.to(torch.int32).t().contiguous()
    if elim == "pallas":
        synd_r, pr, pc, fword, fpos = osd_elim(
            h_packed, perm, synd0, n=n, r_star=r_star, fcap=max(w, 0))
        u_piv = synd_r.gather(0, pr.long()).t()                # (B, r*)
    else:
        u_piv, pr, pc, ip, packed = osd_elim_percol(h_packed, perm, synd0,
                                                    n=n, r_star=r_star)
        u_piv = u_piv.t()
    piv_cols = perm.gather(1, pc.t().long())                   # original ids
    cost_piv = cost[piv_cols]                                  # (B, r*)
    out = torch.zeros((B, n), dtype=torch.uint8, device=dev)
    if w <= 0:
        return out.scatter_(1, piv_cols, u_piv.to(torch.uint8))

    ar_w = torch.arange(w, device=dev)
    if elim == "pallas":
        # T is the free panel at the pivot rows
        fw_piv = fword.gather(0, pr.long())                    # (r*, B)
        T = ((fw_piv.t()[:, :, None] >> ar_w) & 1).to(torch.float32)
        free_perm = fpos[:w]                                   # (w, B)
    else:
        # T reads the reduced pivot rows at the first w free columns
        free_perm = free_positions(n, w, ip=ip)
        T = _reduced_bits(pivot_rows(packed, pr), free_perm).permute(
            2, 1, 0).to(torch.float32)                         # (B, r*, w)
    free = perm.gather(1, free_perm.t().long())                # (B, w)
    cost_free = cost[free]                                     # (B, w)
    n_pat = 1 << w
    # chunk starts must never clamp: round a non-dividing chunk down to a
    # power of two, which always divides the power-of-two n_pat
    pat_chunk = min(int(pat_chunk), n_pat)
    if n_pat % pat_chunk:
        pat_chunk = 1 << (pat_chunk.bit_length() - 1)
    pats = torch.arange(n_pat, device=dev)
    pmat = ((pats[None, :] >> ar_w[:, None]) & 1).to(torch.float32)  # (w, n_pat)

    # pivot bit of candidate p: u_i XOR parity(T_i . p).  Linearized:
    #   sum_i c_i*(u_i ^ par_i) = sum_i c_i*u_i + sum_i c_i*(1-2u_i)*par_i
    u_f = u_piv.to(torch.float32)
    signed_piv = cost_piv * (1.0 - 2.0 * u_f)
    # pattern 0 (pure OSD-0) is the base candidate
    best_cost = torch.einsum("br,br->b", u_f, cost_piv)
    base_cost = best_cost
    best_pat = torch.zeros(B, dtype=torch.int64, device=dev)
    for start in range(0, n_pat, pat_chunk):
        pchunk = pmat[:, start:start + pat_chunk]
        s = torch.einsum("brw,wp->brp", T, pchunk)             # (B, r*, C)
        par = s - 2.0 * torch.floor(s * 0.5)                   # exact ints
        c = (base_cost[:, None]
             + torch.einsum("brp,br->bp", par, signed_piv)
             + torch.matmul(cost_free, pchunk))                # (B, C)
        idx = torch.argmin(c, dim=1)                           # first min
        cmin = c.gather(1, idx[:, None])[:, 0]
        better = cmin < best_cost                              # strict <
        best_pat = torch.where(better, start + idx, best_pat)
        best_cost = torch.where(better, cmin, best_cost)

    # reconstruct only the winning pattern's solution
    pbest = ((best_pat[:, None] >> ar_w[None, :]) & 1).to(torch.float32)
    piv_bits = torch.remainder(
        u_f + torch.einsum("brw,bw->br", T, pbest), 2.0).to(torch.uint8)
    out.scatter_(1, piv_cols, piv_bits)
    out.scatter_(1, free, pbest.to(torch.uint8))
    return out


def osd_decode_device(plan: OsdPlan, syndromes, posterior_llrs,
                      osd_order: int = 10, pat_chunk: int = 256):
    """OSD-E decode a batch on the plan's device. Returns (B, n) uint8.
    ``osd_order=0`` gives OSD-0; the elimination route is
    ``QLDPC_OSD_ELIM`` (default ``"pallas"``)."""
    return osd_decode_values(
        (plan.n, plan.rank, int(osd_order), int(pat_chunk), elim_route()),
        plan.packed, plan.cost, syndromes, posterior_llrs,
        device=plan.packed.device)

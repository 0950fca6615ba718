"""Batched order-w combination-sweep OSD (OSD-CS) on the device.

After the GF(2) elimination, OSD-CS considers every weight-1 flip over ALL
``f = n - rank`` free columns and every weight-2 pair over the first ``w =
min(osd_order, f)`` (lowest-cost) free columns, and keeps the strictly
cheapest syndrome-consistent candidate: ``1 + f + w*(w-1)/2`` candidates per
shot, walked in the host enumeration order (the reference's method 2).

Weight <= 2 costs decompose over two small per-shot planes, so the reduced
free panel T (r*, f) is never materialized per candidate:

  * ``dplane[j] = sum_i s_i * T[i, j] + cost_free[j]``   (f per shot)
  * ``X[a, c]   = sum_i s_i * T[i, a] * T[i, c]``        (a < c < w)

with ``s_i = cost_piv_i * (1 - 2*u_i)`` the signed pivot costs.  For flips
{j}: ``cost = base + dplane[j]``; for {a, b}: ``cost = base + dplane[a] +
dplane[b] - 2*X[a, b]``.  Each plane entry is a float32 sum over the pivot
rows i = 0, 1, ..., r*-1 in that order, one row at a time (``cs_planes``),
without a matrix product (no TF32 can reach them); XLA sums in another
order, so the decode is held against the JAX package by the float32
cost-tie contract.

The decode's sweep (``cs_sweep_rows``) launches ``csrc/cs_sweep.cu``'s
kernel that builds the planes in shared memory from the reduced matrix and
scores the candidates, replacing the TPU kernel ``_cs_sweep_kernel``
(``qldpc_fault_tolerance_tpu/ops/osd_cs_device.py:215``) and the XLA plane
pass that feeds it (``:414-438``), so no plane reaches device memory; its
plain version is ``cs_planes`` then ``cs_sweep_plain``, a port of the
kernel's XLA twin ``_cs_sweep_xla`` (first minimum within a chunk, strict-<
across chunks: the global first minimum, whatever the chunk).
``cs_sweep`` is the same sweep over given planes (the same kernel source).
CPU tensors run the plain versions.  The elimination is ``osd_elim(...,
full=True)`` (``"pallas"``) or ``osd_elim_percol`` (``"pallas_percol"``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..decoders.osd import OSD_CS_MAX_ORDER
from ..utils.device import resolve_device
# the module, not its names: decoders/ imports this module while
# osd_device is still initializing
from . import _kernels, osd_device as od

__all__ = ["osd_cs_decode_device", "osd_cs_decode_values", "cs_pat_chunk",
           "cs_sweep_shape", "cs_sweep", "cs_sweep_plain", "cs_planes",
           "cs_sweep_rows", "cs_sweep_rows_plain", "cs_rows_smem_bytes",
           "cs_sweep_feasible", "sweep_inputs", "SweepInputs"]

# per-chunk compute-tile budget of the pattern-chunk chooser (bytes); the
# JAX package's default, which its TPU calibration may override
_CS_CHUNK_LIMIT = 4 * 1024 * 1024


def _cs_counts(n: int, rank: int, osd_order: int):
    """(f, w, n_cand) of the combination sweep — the host enumeration's
    sizes (weight-1 spans ALL free columns regardless of osd_order; the
    order only widens the pair block)."""
    f = max(int(n) - int(rank), 0)
    w = min(int(osd_order), f)
    return f, w, 1 + f + w * (w - 1) // 2


def cs_pat_chunk(n: int, rank: int, osd_order: int, bt: int = 128) -> int:
    """The JAX package's pattern-chunk size for the (n, rank, osd_order)
    sweep: the largest power-of-two chunk <= 512 whose compute tile fits the
    per-chunk budget, then capped at 64.  The chunk never changes a
    result."""
    f, w, n_cand = _cs_counts(n, rank, osd_order)
    if n_cand <= 1:
        return 1
    limit = _CS_CHUNK_LIMIT
    wsq = max(w * w, 1)
    c = 512
    while c > 64 and c * (f + wsq + bt) * 4 > limit:
        c //= 2
    return min(c, max(64, 1))


def cs_sweep_shape(n: int, rank: int, osd_order: int):
    """(n_candidates, n_chunks) of the sweep for this config."""
    _f, _w, n_cand = _cs_counts(n, rank, osd_order)
    chunk = cs_pat_chunk(n, rank, osd_order)
    n_pad = -(-n_cand // chunk) * chunk
    return n_cand, n_pad // chunk


@functools.lru_cache(maxsize=64)
def _cs_plane(f: int, w: int, pat_chunk: int):
    """Candidate index plane for (f, w): the JAX package's one-hot selector
    matrices ``e1t`` (n_pad, f) / ``e2t`` (n_pad, w*w) and the int32 decode
    table (j1, j2), padded to a pat_chunk multiple with base-duplicate rows
    that can never win under strict-<.  Candidate order: 0 = base, 1..f =
    weight-1 flips ascending, then pairs (a, b), a < b < w, in lex order.
    The port's sweep reads only (j1, j2); the selectors are kept so tests
    can hand them to the JAX sweep.  Cached: treat the arrays as
    read-only."""
    n_cand = 1 + f + w * (w - 1) // 2
    n_pad = -(-n_cand // pat_chunk) * pat_chunk
    wsq = max(w * w, 1)
    e1t = np.zeros((n_pad, max(f, 1)), np.float32)
    e2t = np.zeros((n_pad, wsq), np.float32)
    j1 = np.full(n_pad, -1, np.int32)
    j2 = np.full(n_pad, -1, np.int32)
    for j in range(f):
        e1t[1 + j, j] = 1.0
        j1[1 + j] = j
    idx = 1 + f
    for a in range(w):
        for b in range(a + 1, w):
            e1t[idx, a] = 1.0
            e1t[idx, b] = 1.0
            e2t[idx, a * w + b] = 1.0
            j1[idx] = a
            j2[idx] = b
            idx += 1
    return e1t, e2t, j1, j2, n_cand, n_pad


@functools.lru_cache(maxsize=64)
def _cs_decode_table(f: int, w: int, pat_chunk: int, device):
    """``_cs_plane``'s (j1, j2) as int64 tensors on ``device``, uploaded
    once: a decode inside a CUDA-graph capture cannot copy from the
    host."""
    _e1t, _e2t, j1, j2, _n_cand, _n_pad = _cs_plane(f, w, pat_chunk)
    return tuple(torch.from_numpy(j).to(device, torch.int64) for j in (j1, j2))


def cs_sweep_plain(dplane, xflat, base, *, w: int, pat_chunk: int):
    """Plain PyTorch version of the sweep kernel: a port of the JAX
    package's ``_cs_sweep_xla``.  Every candidate's float32 cost as the
    TPU's HIGHEST-precision products give it (base; ``base + d[j]``;
    ``(base + (d[a] + d[b])) - 2*x[a*w+b]``), then a scan over chunks of
    ``pat_chunk`` candidates: first minimum within a chunk, strict-< across
    chunks.  Returns (best_cost (B,) float32, best_idx (B,) int32)."""
    f, B = dplane.shape
    _e1t, _e2t, j1, j2, _n_cand, n_pad = _cs_plane(f, w, int(pat_chunk))
    dev = dplane.device
    j1 = torch.from_numpy(j1).to(dev, torch.int64)
    j2 = torch.from_numpy(j2).to(dev, torch.int64)
    d1 = dplane[j1.clamp(min=0)]                               # (n_pad, B)
    d2 = dplane[j2.clamp(min=0)]
    pair = j2 >= 0
    x = xflat[torch.where(pair, j1 * w + j2, 0)]
    b = base[None, :].expand(n_pad, B)
    one = ((j1 >= 0) & ~pair)[:, None]
    two = pair[:, None]
    costs = torch.where(two, (b + (d1 + d2)) - 2.0 * x,
                        torch.where(one, b + d1, b))
    best_cost = base.clone()
    best_idx = torch.zeros(B, dtype=torch.int64, device=dev)
    pidx = torch.arange(pat_chunk, device=dev)[:, None]
    for start in range(0, n_pad, pat_chunk):
        c = costs[start:start + pat_chunk]
        cmin = c.min(dim=0).values
        idx = torch.where(c == cmin[None, :], pidx, pat_chunk).min(dim=0).values
        better = cmin < best_cost                              # strict <
        best_idx = torch.where(better, start + idx, best_idx)
        best_cost = torch.where(better, cmin, best_cost)
    return best_cost, best_idx.to(torch.int32)


# shots per block of the sweep kernel (csrc/cs_sweep.cu kShots)
_SWEEP_SHOTS = 8


def cs_sweep(dplane, xflat, base, *, w: int, pat_chunk: int):
    """Per shot, the first minimum-cost candidate of the combination sweep.

    dplane (f, B), xflat (max(w*w, 1), B), base (B,), all float32.  Returns
    (best_cost (B,) float32, best_idx (B,) int32).  CUDA tensors launch
    ``csrc/cs_sweep.cu`` (or raise); CPU tensors run ``cs_sweep_plain``.
    ``pat_chunk`` is the plain version's scan chunk; it never changes the
    result, and the kernel has none."""
    if not dplane.is_cuda or _kernels.plain_forced():
        return cs_sweep_plain(dplane, xflat, base, w=w, pat_chunk=pat_chunk)
    f, B = dplane.shape
    wsq = max(w * w, 1)
    if any(t.dtype != torch.float32 for t in (dplane, xflat, base)):
        raise ValueError("cs_sweep takes float32 planes")
    if f < 1 or not 0 <= w <= f or tuple(xflat.shape) != (wsq, B) \
            or tuple(base.shape) != (B,):
        raise ValueError(f"cs_sweep shape mismatch: dplane {tuple(dplane.shape)}, "
                         f"xflat {tuple(xflat.shape)}, base {tuple(base.shape)}, "
                         f"w={w}")
    if any(t.device != dplane.device or not t.is_contiguous()
           for t in (dplane, xflat, base)):
        raise ValueError("cs_sweep takes contiguous inputs on one device")
    if (f + wsq) * B >= 2 ** 31:
        raise ValueError("cs_sweep batch too large for int32 indexing")
    smem = 4 * _SWEEP_SHOTS * (f + w * (w - 1) // 2)
    if smem > od.SMEM_LIMIT:
        raise ValueError(f"cs_sweep: f={f}, w={w} need {smem} bytes of shared "
                         f"memory per block, above {od.SMEM_LIMIT}")
    dev = dplane.device
    best_cost = torch.empty(B, dtype=torch.float32, device=dev)
    best_idx = torch.empty(B, dtype=torch.int32, device=dev)
    fn = _kernels.library("cs_sweep").cs_sweep_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, i, i, i, i, p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(dplane.data_ptr(), xflat.data_ptr(), base.data_ptr(),
                best_cost.data_ptr(), best_idx.data_ptr(), f, w, B, smem, stream)
    _kernels.check_launch("cs_sweep", rc)
    _kernels.count_launch(cs_sweep, "launches", dev)
    return best_cost, best_idx


cs_sweep.launches = 0


def cs_planes(rows_piv, signed_piv, cost_free, free_perm, n: int, w: int):
    """The sweep's per-shot planes from the reduced pivot rows ``rows_piv``
    (W, r*, B) int32, the signed pivot costs (r*, B), the free columns'
    costs (f, B) and permuted positions ``free_perm`` (f, B) (each below
    ``n``, the permuted columns' count).

    Returns (dplane (f, B), xflat (max(w*w, 1), B)), float32.  xflat
    holds X[a, b] at row a*w + b for the pairs a < b, the only entries the
    sweep reads, and zeros elsewhere.  Every entry is a float32 sum over
    the pivot rows in ascending order, one row at a time, then (dplane)
    the free column's cost: the order ``csrc/cs_sweep.cu`` follows, so the
    kernel equals this bit for bit."""
    W, r, B = rows_piv.shape
    dev = rows_piv.device
    word, bit = free_perm >> 5, free_perm & 31                # (f, B)
    pairs = [(a, b) for a in range(w) for b in range(a + 1, w)]
    ia, ib = (torch.tensor([p[k] for p in pairs], dtype=torch.int64,
                           device=dev) for k in (0, 1))
    dsum = torch.zeros(free_perm.shape, dtype=torch.float32, device=dev)
    xsum = torch.zeros((len(pairs), B), dtype=torch.float32, device=dev)
    for i in range(r):
        t = ((rows_piv[:, i].gather(0, word) >> bit) & 1).to(torch.float32)
        dsum += t * signed_piv[i]
        if pairs:
            xsum += (t[ia] * signed_piv[i]) * t[ib]
    xflat = torch.zeros((max(w * w, 1), B), dtype=torch.float32, device=dev)
    if pairs:
        xflat[ia * w + ib] = xsum
    return dsum + cost_free, xflat


def cs_sweep_rows_plain(packed, pr, signed_piv, cost_free, free_perm, base,
                        *, n: int, w: int, pat_chunk: int):
    """Plain version of ``cs_sweep_rows``: the pivot rows gathered
    (``osd_device.pivot_rows``), ``cs_planes``, then ``cs_sweep_plain``."""
    dplane, xflat = cs_planes(od.pivot_rows(packed, pr), signed_piv,
                              cost_free, free_perm, n, w)
    return cs_sweep_plain(dplane, xflat, base, w=w, pat_chunk=pat_chunk)


def cs_rows_smem_bytes(W: int, r: int, f: int, w: int) -> int:
    """Dynamic shared memory of ``cs_sweep_rows``' block: a shot's r*
    pivot rows of W words, their signed costs and indices, the free
    positions, dplane and the pairs' X, 4 bytes each."""
    return 4 * (r * W + 2 * r + 2 * f + w * (w - 1) // 2)


def cs_sweep_feasible(n: int, rank: int, osd_order: int,
                      bt: int = 128) -> bool:
    """The JAX package's residency gate of its sweep kernel, with a block's
    shared memory in the place of its TPU's scoped VMEM: whether one
    shot's pivot rows and candidate planes for the (n, rank, osd_order)
    sweep (``cs_rows_smem_bytes``) fit the block of ``cs_sweep_rows``,
    the sweep the decode runs.  ``bt``, the JAX kernel's batch tile, plays
    no part: the card's sweep takes one shot a block."""
    del bt
    f, w, _ = _cs_counts(n, rank, osd_order)
    return cs_rows_smem_bytes(-(-int(n) // 32), int(rank), f,
                              w) <= od.SMEM_LIMIT


def cs_sweep_rows(packed, pr, signed_piv, cost_free, free_perm, base, *,
                  n: int, w: int, pat_chunk: int):
    """Per shot, the first minimum-cost candidate of the combination sweep,
    planes included: from the reduced matrix ``packed`` (W, m, B) int32 of
    the full elimination, its pivot rows ``pr`` (r*, B) int32, the signed
    pivot costs (r*, B), the free columns' costs (f, B) float32 and
    permuted positions ``free_perm`` (f, B) int64, and ``base`` (B,).

    Returns (best_cost (B,) float32, best_idx (B,) int32).  CUDA tensors
    launch ``csrc/cs_sweep.cu``'s ``cs_sweep_rows_launch`` (or raise), which
    builds ``cs_planes``' planes in shared memory in their stated order;
    CPU tensors run ``cs_sweep_rows_plain``.  ``pat_chunk`` is the plain
    version's scan chunk; it never changes the result."""
    if not packed.is_cuda or _kernels.plain_forced():
        return cs_sweep_rows_plain(packed, pr, signed_piv, cost_free,
                                   free_perm, base, n=n, w=w,
                                   pat_chunk=pat_chunk)
    W, m, B = packed.shape
    r = pr.shape[0]
    f = free_perm.shape[0]
    want = ((packed, torch.int32, (W, m, B)), (pr, torch.int32, (r, B)),
            (signed_piv, torch.float32, (r, B)),
            (cost_free, torch.float32, (f, B)),
            (free_perm, torch.int64, (f, B)), (base, torch.float32, (B,)))
    for t, dtype, shape in want:
        if (t.dtype != dtype or tuple(t.shape) != shape
                or t.device != packed.device or not t.is_contiguous()):
            raise ValueError(f"cs_sweep_rows takes contiguous {dtype} of "
                             f"shape {shape} on {packed.device}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if r < 1 or f < 1 or not 0 <= w <= f or W * 32 < n:
        raise ValueError(f"cs_sweep_rows: r*={r}, f={f}, w={w}, {W} words "
                         f"for n={n}")
    if W * m * B >= 2 ** 31:
        raise ValueError("cs_sweep_rows batch too large for int32 indexing")
    smem = cs_rows_smem_bytes(W, r, f, w)
    if smem > od.SMEM_LIMIT:
        raise ValueError(f"cs_sweep_rows: r*={r}, {W} words, f={f}, w={w} "
                         f"need {smem} bytes of shared memory per block, "
                         f"above {od.SMEM_LIMIT}")
    # one thread per plane entry, at most 1024
    threads = min(1024, max(64, -(-(f + w * (w - 1) // 2) // 32) * 32))
    dev = packed.device
    best_cost = torch.empty(B, dtype=torch.float32, device=dev)
    best_idx = torch.empty(B, dtype=torch.int32, device=dev)
    fn = _kernels.library("cs_sweep").cs_sweep_rows_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 8 + [i] * 8 + [p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(packed.data_ptr(), pr.data_ptr(), signed_piv.data_ptr(),
                cost_free.data_ptr(), free_perm.data_ptr(), base.data_ptr(),
                best_cost.data_ptr(), best_idx.data_ptr(), W, m, r, f, w, B,
                threads, smem, stream)
    _kernels.check_launch("cs_sweep_rows", rc)
    _kernels.count_launch(cs_sweep_rows, "launches", dev)
    return best_cost, best_idx


cs_sweep_rows.launches = 0


def _pivot_bits(packed, pr, cols):
    """Bits of the reduced matrix (W, m, B) at the pivot rows ``pr`` (r*,
    B) and the permuted columns ``cols`` (k, B): (k, r*, B) int32 {0, 1}."""
    k, B = cols.shape
    words = packed.gather(0, (cols >> 5)[:, None, :].expand(k, packed.shape[1], B))
    rows = words.gather(1, pr.long()[None].expand(k, *pr.shape))
    return (rows >> (cols & 31)[:, None, :]) & 1


class SweepInputs(NamedTuple):
    """What the sweep and the winner's reconstruction read, per shot
    (batch minor): the reduced syndrome at the pivots ``u_piv`` (r*, B),
    the pivots' original columns ``piv_cols`` (B, r*), the free columns'
    permuted positions ``free_perm`` (f, B) and original ids ``free_cols``
    (B, f), the reduced matrix ``packed`` (W, m, B) and its pivot rows
    ``pr`` (r*, B), the signed pivot costs (r*, B), the free columns'
    costs (f, B) and ``base`` (B,)."""
    u_piv: torch.Tensor
    piv_cols: torch.Tensor
    free_perm: torch.Tensor
    free_cols: torch.Tensor
    packed: torch.Tensor
    pr: torch.Tensor
    signed_piv: torch.Tensor
    cost_free: torch.Tensor
    base: torch.Tensor


def sweep_inputs(cfg, h_packed, cost, syndromes, posterior_llrs, *,
                 device="cuda"):
    """The elimination and what the sweep reads, for an OSD-CS decode
    (``cfg`` as ``osd_cs_decode_values``).  Returns ``(out, inputs)``:
    ``out`` the (B, n) uint8 correction so far, ``inputs`` a
    ``SweepInputs``, or None when the base solution is the only candidate
    (rank 0, or no free column) and ``out`` is final.  Launches nothing
    when the rank is 0."""
    n, r_star, osd_order, _pat_chunk = cfg[:4]
    elim = od.elim_route(cfg[4] if len(cfg) > 4 else None)
    if int(osd_order) > OSD_CS_MAX_ORDER:
        raise ValueError(
            f"osd_order={int(osd_order)} exceeds OSD_CS_MAX_ORDER="
            f"{OSD_CS_MAX_ORDER} (decoders.osd) — the combination sweep's "
            f"pair block is quadratic in the order; raise the constant "
            f"deliberately rather than silently clamping")
    dev = resolve_device(device)
    h_packed = torch.as_tensor(h_packed).to(dev)
    cost = torch.as_tensor(cost).to(dev, torch.float32)
    syndromes = torch.as_tensor(syndromes).to(dev)
    posterior_llrs = torch.as_tensor(posterior_llrs).to(dev, torch.float32)
    B = syndromes.shape[0]
    f, _w, _n_cand = _cs_counts(n, r_star, osd_order)
    out = torch.zeros((B, n), dtype=torch.uint8, device=dev)
    if r_star < 1:
        # rank-0 H: the base solution (all zeros) is the only candidate
        return out, None

    perm = torch.sort(posterior_llrs, dim=1, stable=True).indices  # (B, n)
    synd0 = syndromes.to(torch.int32).t().contiguous()
    if elim == "pallas":
        synd_r, pr, pc, _fw, _fp, packed = od.osd_elim(
            h_packed, perm, synd0, n=n, r_star=r_star, fcap=0, full=True)
        u_piv = synd_r.gather(0, pr.long())                    # (r*, B)
        ip = None
    else:
        u_piv, pr, pc, ip, packed = od.osd_elim_percol(h_packed, perm, synd0,
                                                       n=n, r_star=r_star)
    piv_cols = perm.gather(1, pc.t().long())                   # (B, r*)
    if f == 0:
        # full column rank: the base OSD-0 solution is the only candidate
        return out.scatter_(1, piv_cols, u_piv.t().to(torch.uint8)), None

    free_perm = od.free_positions(n, f, ip=ip, pc=pc)          # (f, B)
    free_cols = perm.gather(1, free_perm.t())                  # (B, f)
    cost_piv = cost[piv_cols].t()                              # (r*, B)
    cost_free = cost[free_cols].t()                            # (f, B)
    u_f = u_piv.to(torch.float32)
    signed_piv = cost_piv * (1.0 - 2.0 * u_f)
    return out, SweepInputs(u_piv, piv_cols, free_perm.contiguous(),
                            free_cols, packed, pr,
                            signed_piv.contiguous(), cost_free.contiguous(),
                            (u_f * cost_piv).sum(dim=0))


def osd_cs_decode_values(cfg, h_packed, cost, syndromes, posterior_llrs, *,
                         device="cuda"):
    """OSD-CS decode of a (B, m) syndrome batch from BP posteriors (B, n).

    ``cfg`` = (n, rank, osd_order, pat_chunk[, elim]) as in
    ``ops.osd_device.osd_decode_values``.  Returns (B, n) uint8."""
    n, r_star, osd_order, pat_chunk = cfg[:4]
    out, x = sweep_inputs(cfg, h_packed, cost, syndromes, posterior_llrs,
                          device=device)
    if x is None:
        return out
    f, w, _n_cand = _cs_counts(n, r_star, osd_order)
    _bc, best_idx = cs_sweep_rows(x.packed, x.pr, x.signed_piv, x.cost_free,
                                  x.free_perm, x.base, n=n, w=w,
                                  pat_chunk=int(pat_chunk))

    # reconstruct only the winning candidate's solution
    best = best_idx.long()
    j1, j2 = (j[best] for j in _cs_decode_table(
        f, w, int(pat_chunk), out.device))                     # -1 = none
    v1, v2 = (j1 >= 0).to(torch.int32), (j2 >= 0).to(torch.int32)
    t1, t2 = (_pivot_bits(x.packed, x.pr,
                          x.free_perm.gather(0, j.clamp(min=0)[None]))[0]
              for j in (j1, j2))
    piv_bits = x.u_piv ^ (t1 * v1[None, :]) ^ (t2 * v2[None, :])  # (r*, B)
    out.scatter_(1, x.piv_cols, piv_bits.t().to(torch.uint8))
    rows_b = torch.arange(out.shape[0], device=out.device)
    # flips land on free columns (disjoint from pivots, j1 != j2)
    c1, c2 = (x.free_cols.gather(1, j.clamp(min=0)[:, None])[:, 0]
              for j in (j1, j2))
    out[rows_b, c1] += v1.to(torch.uint8)
    out[rows_b, c2] += v2.to(torch.uint8)
    return out


def osd_cs_decode_device(plan, syndromes, posterior_llrs,
                         osd_order: int = 10, pat_chunk: int | None = None):
    """OSD-CS decode a batch on the plan's device (the ``OsdPlan`` OSD-E
    uses). Returns (B, n) uint8; the elimination route is
    ``QLDPC_OSD_ELIM`` (default ``"pallas"``)."""
    if pat_chunk is None:
        pat_chunk = cs_pat_chunk(plan.n, plan.rank, osd_order)
    return osd_cs_decode_values(
        (plan.n, plan.rank, int(osd_order), int(pat_chunk), od.elim_route()),
        plan.packed, plan.cost, syndromes, posterior_llrs,
        device=plan.packed.device)

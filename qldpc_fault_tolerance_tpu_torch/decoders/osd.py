"""Ordered-statistics decoding: the helpers shared by the device OSD and
the BPOSD decoder (method names, the order cap, the signed channel cost)
and the host OSD (the JAX package's ``decoders/osd.py``).

The host OSD decodes in C++ (``_native/osd.cpp``, built by g++ at first
use; a failed build raises) with float64 costs.  ``_osd_numpy`` is its
plain version and the test oracle; nothing switches to it silently.  The
host path serves ``BPOSD_Decoder(device_osd=False)``.
"""
from __future__ import annotations

import ctypes
import time

import numpy as np

from ..codes import gf2

__all__ = ["OSD_CS_MAX_ORDER", "METHODS", "DEVICE_METHODS",
           "osd_decode_batch", "osd_postprocess"]

#: reprocessing methods by name -> 0 (OSD-0), 1 (OSD-E), 2 (OSD-CS)
METHODS = {"osd_0": 0, "osd0": 0, "osd_e": 1, "osd_cs": 2, "exhaustive": 1}
#: the methods this port runs on the device
DEVICE_METHODS = ("osd_e", "osd0", "osd_0", "exhaustive", "osd_cs")

#: Shared order cap for the reprocessing stages — OSD-E's candidate count is
#: 2^order and OSD-CS's pair block is order^2/2, so an uncapped order is a
#: resource bug, not a knob; entry points raise above it instead of silently
#: clamping.
OSD_CS_MAX_ORDER = 20


def _check_osd_order(osd_order: int) -> int:
    order = int(osd_order)
    if order > OSD_CS_MAX_ORDER:
        raise ValueError(
            f"osd_order={order} exceeds OSD_CS_MAX_ORDER={OSD_CS_MAX_ORDER} — "
            f"candidate counts grow as 2^order (OSD-E) / order^2 (OSD-CS); "
            f"raise OSD_CS_MAX_ORDER deliberately rather than relying on a "
            f"silent clamp")
    return order


def _channel_cost(channel_probs) -> np.ndarray:
    """Signed per-bit cost log((1-p)/p) of setting a bit in the candidate.

    Kept signed: a channel prior > 1/2 makes setting that bit cheaper than
    leaving it clear, which a clamp-to-positive would silently invert.  Only
    the p->0/1 endpoints are clipped for finiteness."""
    p = np.clip(np.asarray(channel_probs, dtype=np.float64), 1e-12, 1 - 1e-7)
    return np.log((1 - p) / p)


def osd_decode_batch(h, syndromes, posterior_llrs, channel_probs, *,
                     osd_method: str = "osd_e", osd_order: int = 10,
                     nthreads: int = 0) -> np.ndarray:
    """OSD-decode a batch of syndromes on the host, in C++: ``(B, n)``
    uint8 errors, the most probable under the float64 channel cost among
    OSD's candidates, ordered by ``posterior_llrs``."""
    h = gf2.to_gf2(h)
    m, n = h.shape
    syndromes = np.ascontiguousarray(np.atleast_2d(syndromes).astype(np.uint8))
    b = syndromes.shape[0]
    if b == 0:
        return np.zeros((0, n), dtype=np.uint8)
    llrs = np.ascontiguousarray(
        np.broadcast_to(np.asarray(posterior_llrs, np.float64), (b, n)))
    cost = np.ascontiguousarray(_channel_cost(channel_probs))
    if cost.ndim == 0:
        cost = np.full(n, float(cost))
    method = METHODS[osd_method]
    osd_order = _check_osd_order(osd_order)
    from .._native import load_native

    lib = load_native()
    h = np.ascontiguousarray(h)
    out = np.zeros((b, n), dtype=np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    dp = ctypes.POINTER(ctypes.c_double)
    rc = lib.qldpc_osd_decode_batch(
        h.ctypes.data_as(u8p), m, n, syndromes.ctypes.data_as(u8p),
        llrs.ctypes.data_as(dp), b, cost.ctypes.data_as(dp), method,
        int(osd_order), int(nthreads), out.ctypes.data_as(u8p))
    if rc != 0:
        raise RuntimeError(f"host OSD failed with code {rc} "
                           f"(m={m}, n={n}, batch={b})")
    return out


def _osd_numpy(h, syndromes, llrs, cost, method, osd_order):
    """The host OSD's plain version (the C++'s test oracle): per shot, the
    RREF of the LLR-ordered H with the syndrome carried, then OSD-0, OSD-E
    (every pattern over the first ``osd_order`` free columns) or OSD-CS
    (every weight-1 pattern, and weight-2 within the first
    ``osd_order``), scored by the float64 cost ``cost``."""
    m, n = h.shape
    out = np.zeros((syndromes.shape[0], n), dtype=np.uint8)
    for bi in range(syndromes.shape[0]):
        order = np.argsort(llrs[bi], kind="stable")
        hp = h[:, order].copy()
        u = syndromes[bi].copy()
        pivots, free = [], []
        r = 0
        for col in range(n):
            if r >= m:
                free.append(col)
                continue
            sub = np.nonzero(hp[r:, col])[0]
            if sub.size == 0:
                free.append(col)
                continue
            piv = r + sub[0]
            if piv != r:
                hp[[r, piv]] = hp[[piv, r]]
                u[[r, piv]] = u[[piv, r]]
            for i in np.nonzero(hp[:, col])[0]:
                if i != r:
                    hp[i] ^= hp[r]
                    u[i] ^= u[r]
            pivots.append(col)
            r += 1
        pivots = np.array(pivots, dtype=int)
        free = np.array(free, dtype=int)
        perm_cost = cost[order]

        def solve(t_bits):
            e_s = u[: len(pivots)].copy()
            for fj in t_bits:
                e_s ^= hp[: len(pivots), free[fj]]
            c = perm_cost[pivots] @ e_s + sum(perm_cost[free[fj]]
                                              for fj in t_bits)
            return e_s, c

        best_es, best_c = solve([])
        best_t: list = []
        cands: list = []
        if method == 1:
            w = min(osd_order, len(free), OSD_CS_MAX_ORDER)
            for pat in range(1, 1 << w):
                cands.append([b for b in range(w) if (pat >> b) & 1])
        elif method == 2:
            cands.extend([[b] for b in range(len(free))])
            w = min(osd_order, len(free), OSD_CS_MAX_ORDER)
            cands.extend([[a, b] for a in range(w) for b in range(a + 1, w)])
        for t in cands:
            e_s, c = solve(t)
            if c < best_c:
                best_es, best_c, best_t = e_s, c, t
        e_perm = np.zeros(n, dtype=np.uint8)
        e_perm[pivots] = best_es
        for fj in best_t:
            e_perm[free[fj]] = 1
        out[bi, order] = e_perm
    return out


def osd_postprocess(h, syndromes, bp_errors, bp_converged, posterior_llrs,
                    channel_probs, *, osd_method: str = "osd_e",
                    osd_order: int = 10) -> np.ndarray:
    """BP's output with the BP-failed shots replaced by the host OSD's
    (bposd semantics); counts ``osd.invocations`` / ``osd.shots`` and
    times the host stage as ``osd_host`` (``utils.observability``)."""
    from ..utils import telemetry
    from ..utils.observability import stage_timer

    bp_errors = np.asarray(bp_errors, dtype=np.uint8)
    conv = np.asarray(bp_converged, dtype=bool)
    if conv.all():
        return bp_errors
    idx = np.nonzero(~conv)[0]
    telemetry.count("osd.invocations")
    telemetry.count("osd.shots", int(idx.size))
    t0 = time.perf_counter()
    with stage_timer("osd_host"):
        fixed = osd_decode_batch(
            h, np.asarray(syndromes)[idx], np.asarray(posterior_llrs)[idx],
            channel_probs, osd_method=osd_method, osd_order=osd_order)
    osd_postprocess.seconds += time.perf_counter() - t0
    osd_postprocess.shots += int(idx.size)
    out = bp_errors.copy()
    out[idx] = fixed
    return out


# host OSD work done in this process: its seconds and shots (chip_smoke.py
# reads them for the host OSD's time per shot)
osd_postprocess.seconds = 0.0
osd_postprocess.shots = 0

"""Min-sum BP kernel wrappers and their plain versions.

``bp_minsum`` decodes a (B, m) syndrome batch against one Tanner graph with
scaled min-sum and per-shot freeze at first convergence — ``ops/bp.py``
``bp_decode(method="minimum_sum")``.  On CUDA tensors it launches the Hopper
kernel ``csrc/bp_minsum.cu`` that replaces the TPU kernel
``_sparse_head_kernel`` (``qldpc_fault_tolerance_tpu/ops/bp_pallas.py:740``);
on CPU tensors it runs ``minsum_plain``, the same arithmetic as PyTorch ops.
Every f32 min-sum decode of the port goes through this wrapper: the two-phase
head, its compacted tail and the full-batch decode.

The plain version mirrors the kernel operation for operation (streaming
top-2 over check slots, variable totals summed in slot order), so kernel and
plain version agree bit for bit on the card; the kernels are built with FMA
contraction off for that reason.  Messages are float32, the f32 reference
numerics of ``ops/bp.py``.  The kernel and the bf16 head read the graph from
host-built 16-bit planes (``minsum_planes``, built once per graph) and are
launched by ``minsum_layout``: shots per block, threads per shot and grid
from the batch, so a large batch keeps every SM full of shots that refill
as they converge and a small one gives each shot up to a whole block.
Where one shot's messages do not fit a block's shared memory beside the
planes, the card runs the kernels' check-state mode instead (each shot's
state one record per check and the totals, in shared memory; the planes
staged or read from device memory), counted in ``checks_launches``, and
where not even that fits, their device-memory modes (the messages in a
device scratch; with 32-bit planes in device memory too when the planes
do not fit or 16 bits cannot number the graph), counted in
``device_launches`` and ``device_planes_launches``.  Row weights up to 32
run the kernels' 32-bit slot masks, up to 64 (a detector error model's
window matrix) their wide instances (``minsum_wide``), counted in
``wide_launches``; so does the int8 head B6 (``bp_head_int8.wide_launches``);
the plain versions take any row weight.  ``sectors=`` runs kernel 1's
sector mode (``bp_minsum_sectors_launch``, counted in
``sector_launches``): a block-diagonal graph decoded as independent
sectors, each freezing at its own convergence, equal to separate decodes.

The BP head family (the port's counterpart of ``ops/bp_pallas.py``'s heads),
which the two-phase decode runs when a decoder carries a head:

  * ``SparseHeadGraph`` + ``bp_head_int8``: int8 min-sum messages with one
    float32 scale per batch tile per iteration and direction
    (``quantize="int8"``); kernel ``csrc/bp_int8.cu``, plain version
    ``minsum_int8_plain``.
  * ``SparseHeadGraph`` (v2) or ``PallasHeadGraph`` (v1) + ``bp_head_bf16``:
    bf16 v2c messages and float32 totals, the JAX package's
    ``_minsum_plane_loop``; the bf16 instance of kernel 1's loop
    (``csrc/bp_minsum.cu`` ``bp_minsum_bf16_launch``) over either head's
    index planes, plain version ``minsum_dense_plain`` (the loop over the
    dense (rw, m, n) one-hot stack, as the JAX v1 kernel writes it).

Each wrapper launches its kernel on CUDA tensors (or raises) and runs its
plain version on CPU tensors or under ``_kernels.force_plain()``.
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading
import weakref
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from ..utils.device import capturing
from . import _kernels

__all__ = ["BIG", "bp_minsum", "minsum_plain", "bp_loop", "minsum_wide",
           "check_update_minsum", "KERNEL_VARIANTS", "INT8_WER_RTOL",
           "INT8_WER_NSIGMA", "int8_parity_tolerance", "SparseHeadGraph",
           "PallasHeadGraph", "build_sparse_head", "build_pallas_head",
           "sparse_head_from_planes", "pallas_head_from_planes",
           "DenseStack", "dense_stack", "check_sectors",
           "minsum_int8_plain", "bp_head_int8",
           "minsum_dense_plain", "bp_head_bf16", "slot_ordered_graph"]

BIG = 1e30  # stands in for +inf without producing NaN in exclusion arithmetic


def check_update_minsum(v2c, synd_sign, graph, scale):
    """Scaled min-sum check update with self-exclusion via a streaming top-2
    over the check's slots — the kernel's check pass.

    v2c: (m, rw, B); synd_sign: (m, B) of +-1.  Returns c2v (m, rw, B)."""
    m, rw, _ = v2c.shape
    mask = graph.chk_mask
    # filled on the device, not copied there: a CUDA graph captures this
    big = torch.full((), BIG, dtype=torch.float32, device=v2c.device)
    scale_t = torch.full((), scale, dtype=torch.float32, device=v2c.device)
    min1 = big.expand_as(synd_sign)
    min2 = min1
    amin = torch.zeros(synd_sign.shape, dtype=torch.int64, device=v2c.device)
    sgn = synd_sign
    negs = []
    for s in range(rw):
        v = v2c[:, s]
        ms = mask[:, s, None]
        mag = torch.where(ms, v.abs(), big)
        neg = ms & (v < 0)
        sgn = torch.where(neg, -sgn, sgn)
        is_new = mag < min1
        min2 = torch.where(is_new, min1, torch.minimum(min2, mag))
        amin = torch.where(is_new, s, amin)
        min1 = torch.minimum(min1, mag)
        negs.append(neg)
    out = []
    for s in range(rw):
        excl = torch.minimum(torch.where(amin == s, min2, min1), big)
        c = scale_t * excl
        c = torch.where((sgn < 0) != negs[s], -c, c)
        out.append(torch.where(mask[:, s, None], c, 0.0))
    return torch.stack(out, dim=1)


def _edge_parity(err, graph):
    """Syndrome of a hard decision, batch-last: err (n, B) -> (m, B) uint8."""
    bits = err[graph.chk_nbr.long()] & graph.chk_mask[..., None].to(err.dtype)
    return bits.sum(dim=1, dtype=torch.uint8) & 1


def _sector_split(sectors, m: int, n: int):
    """The check and variable sizes of ``sectors`` (``((m0, ...), (n0,
    ...))``, the whole graph when None), checked against (m, n)."""
    if sectors is None:
        return (m,), (n,)
    chk_sizes, var_sizes = (tuple(int(x) for x in sizes) for sizes in sectors)
    if (len(chk_sizes) != len(var_sizes) or not chk_sizes
            or sum(chk_sizes) != m or sum(var_sizes) != n
            or min(chk_sizes + var_sizes) < 0):
        raise ValueError(f"sectors {sectors} do not split a {m} x {n} graph")
    return chk_sizes, var_sizes


# each check graph's (its chk_nbr's) sector splits found block diagonal
_BLOCK_DIAGONAL = WeakIdKeyDictionary()
_BLOCK_DIAGONAL_LOCK = threading.Lock()


def check_sectors(graph, sectors):
    """``sectors`` checked against ``graph``, as ``_sector_split`` returns
    them: raises ValueError unless they split it and every check of sector
    s touches only sector s's variables.  Kernel 1's sector mode walks a
    (shot, sector) item's own check and variable ranges only, so an edge
    across sectors would read messages no one wrote.  The check reads the
    graph on the host once per (graph, sectors) pair, so a caller that
    captures ``bp_minsum(sectors=)`` in a CUDA graph calls it first
    (``FusedBPPair`` does)."""
    m, n = graph.chk_nbr.shape[0], graph.var_nbr.shape[0]
    split = _sector_split(sectors, m, n)
    key = graph.chk_nbr
    with _BLOCK_DIAGONAL_LOCK:
        if split in _BLOCK_DIAGONAL.get(key, ()):
            return split
    if capturing():
        raise ValueError("bp_minsum(sectors=) met an unchecked graph in a "
                         "CUDA graph capture: call check_sectors first")
    nbr = graph.chk_nbr.cpu().numpy()
    mask = graph.chk_mask.cpu().numpy()
    chk_sizes, var_sizes = split
    var_off = np.concatenate([[0], np.cumsum(var_sizes)])
    sec = np.repeat(np.arange(len(chk_sizes)), chk_sizes)[:, None]
    bad = mask & ((nbr < var_off[sec]) | (nbr >= var_off[sec + 1]))
    if bad.any():
        i, s = np.argwhere(bad)[0]
        raise ValueError(f"sectors {sectors} do not split this graph block "
                         f"diagonally: check {i} touches variable "
                         f"{nbr[i, s]}, outside its sector")
    with _BLOCK_DIAGONAL_LOCK:
        _BLOCK_DIAGONAL.setdefault(key, set()).add(split)
    return split


def bp_loop(graph, synd_bl, llr0_bl, max_iter: int, check_update,
            sectors=None):
    """Plain batch-last BP iteration loop shared by min-sum and product-sum.

    synd_bl: (m, B) uint8; llr0_bl: (n, B) or (n, 1) float32.  Returns
    ``(err (n, B) uint8, done (B,) bool, llr (n, B) f32, iters (B,) i32)``
    frozen at each shot's first convergence.  Messages of converged shots
    keep updating; their values never reach an output, so the loop may stop
    early when every shot has converged (a host read), which it skips while
    a CUDA graph is being captured.

    ``sectors = ((m0, m1, ...), (n0, n1, ...))`` marks the graph as a block
    diagonal of independent decodes (the JAX package's ``bp_decode(
    sectors=)``): each sector's variables freeze at that sector's first
    converged iteration; ``done`` is the AND across sectors and ``iters``
    the max (a sector that never converges counts ``max_iter``)."""
    n, cw = graph.var_nbr.shape
    B = synd_bl.shape[1]
    chk_sizes, var_sizes = _sector_split(sectors, synd_bl.shape[0], n)
    n_sec = len(chk_sizes)
    chk_off = np.concatenate([[0], np.cumsum(chk_sizes)]).astype(int)
    dev = synd_bl.device
    llr0_bl = llr0_bl.expand(n, B)
    synd_sign = 1.0 - 2.0 * synd_bl.to(torch.float32)
    chk_nbr = graph.chk_nbr.long()
    chk_slot = graph.chk_nbr_slot.long()
    var_nbr = graph.var_nbr.long()
    var_slot = graph.var_nbr_slot.long()
    var_mask = graph.var_mask[..., None]
    v2c = llr0_bl[chk_nbr]                                     # (m, rw, B)
    err = torch.zeros((n, B), dtype=torch.uint8, device=dev)
    llr = llr0_bl.clone()
    done = torch.zeros((n_sec, B), dtype=torch.bool, device=dev)
    iters = torch.full((n_sec, B), max_iter, dtype=torch.int32, device=dev)
    for it in range(max_iter):
        if not capturing() and bool(done.all()):
            break
        c2v = check_update(v2c, synd_sign, graph)              # (m, rw, B)
        c2v_var = torch.where(var_mask, c2v[var_nbr, var_slot], 0.0)
        acc = c2v_var[:, 0]
        for t in range(1, cw):
            acc = acc + c2v_var[:, t]
        total = llr0_bl + acc                                  # (n, B)
        v2c = (total[:, None, :] - c2v_var)[chk_nbr, chk_slot]
        err_new = (total < 0).to(torch.uint8)
        ok = _edge_parity(err_new, graph) == synd_bl           # (m, B)
        match = torch.stack([ok[chk_off[s]:chk_off[s + 1]].all(dim=0)
                             for s in range(n_sec)])           # (n_sec, B)
        keep = torch.cat([done[s][None].expand(var_sizes[s], B)
                          for s in range(n_sec)])              # (n, B)
        err = torch.where(keep, err, err_new)
        llr = torch.where(keep, llr, total)
        iters = torch.where(match & ~done, it + 1, iters).to(torch.int32)
        done = done | match
    return err, done.all(dim=0), llr, iters.amax(dim=0)


def minsum_plain(graph, synd_bl, llr0_bl, max_iter: int, scale: float,
                 sectors=None):
    """Plain PyTorch version of the min-sum kernel (same outputs,
    batch-last), of its sector mode with ``sectors`` (``bp_loop``)."""
    return bp_loop(graph, synd_bl, llr0_bl, max_iter,
                   functools.partial(check_update_minsum, scale=float(scale)),
                   sectors=sectors)


# shared memory a block may take on Hopper (227 KB), and an SM's (228 KB,
# of which each resident block reserves 1 KB)
SMEM_LIMIT = 232448
SM_SMEM = 233472
SM_THREADS = 2048

# csrc/bp_minsum.cu (and B5's bf16 mode, csrc/fused_decode.cu): at most 15
# shots per block (one named barrier each) and 1024 threads; index planes
# hold uint16 with 0xFFFF for padding
MINSUM_MAX_LANES = 15
MINSUM_MAX_THREADS = 1024
PAD16 = 0xFFFF
# row weights of csrc/bp_minsum.cu: a check's slots are bits of a 32-bit
# mask up to MINSUM_NARROW_RW, of a 64-bit one (the wide instances) up to
# MINSUM_MAX_RW
MINSUM_NARROW_RW = 32
MINSUM_MAX_RW = 64


def minsum_wide(rw: int) -> bool:
    """Whether csrc/bp_minsum.cu launches its wide instance (64-bit slot
    masks) for row weight ``rw``; raises above MINSUM_MAX_RW."""
    if not 1 <= rw <= MINSUM_MAX_RW:
        raise ValueError(f"the min-sum kernels take row weights "
                         f"1..{MINSUM_MAX_RW}, got {rw}")
    return rw > MINSUM_NARROW_RW


# the layout rule's two constants, from scripts/ab_minsum_body.py --sweep on
# an H100 (PERF.md): a full block's shots get at most 5 checks and 5
# variables per thread, and a batch takes one shot per block for every 4
# shots per SM (a block runs its shots at once; one block of these kernels
# fits an SM by registers)
MINSUM_ITEMS = 5
MINSUM_SPREAD = 4


class MinsumPlanes(NamedTuple):
    """The graph as csrc/bp_minsum.cu reads it, built on the host: edge
    ``s * m + i`` is check i's slot-s edge.  The 16-bit planes (staged in
    shared memory) hold uint16 values (0xFFFF for padding) in int16
    tensors; the 32-bit ones (read from device memory by the kernels'
    device-memory mode) int32 values, -1 for padding."""

    chk: torch.Tensor   # (rw, m): the variable of edge s * m + i
    edge: torch.Tensor  # (cw, n): variable j's t-th edge in summation order
    slot: torch.Tensor  # (cw, n) uint8: that edge's slot s (0 for padding)
    # (m + n,) uint8: the length of each check's list, then of each
    # variable's, up to its last live entry (255 above 254)
    lens: torch.Tensor


def _u16(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint16).view(np.int16))


def planes16(m: int, n: int, rw: int) -> bool:
    """Whether 16-bit planes number a graph's edges (rw * m) and variables
    (n), 0xFFFF being the padding."""
    return m * rw < PAD16 and n < PAD16


def minsum_planes(graph, wide: bool = False) -> MinsumPlanes:
    """The MinsumPlanes of a TannerGraph (kernel 1: each variable's terms in
    the order of its list) or of a SparseHeadGraph / PallasHeadGraph (the
    bf16 head: in ascending edge order, which is (slot, check) order), on
    the graph's device: 16-bit planes, or 32-bit with ``wide``."""
    pad = -1 if wide else PAD16
    if hasattr(graph, "chk_nbr"):
        chk_nbr, chk_mask, var_nbr, var_slot, var_mask = (
            torch.as_tensor(getattr(graph, f)).cpu().numpy().astype(np.int64)
            for f in ("chk_nbr", "chk_mask", "var_nbr", "var_nbr_slot",
                      "var_mask"))
        m = chk_nbr.shape[0]
        chk = np.where(chk_mask != 0, chk_nbr, pad).T
        live = var_mask != 0
        edge = np.where(live, var_slot * m + var_nbr, pad).T
        slot = np.where(live, var_slot, 0).T
        dev = torch.as_tensor(graph.chk_nbr).device
    else:
        chk_idx = graph.chk_idx.cpu().numpy().astype(np.int64)
        var_edge = graph.var_edge.cpu().numpy().astype(np.int64)
        m = chk_idx.shape[1]
        chk = np.where(graph.mask.cpu().numpy() > 0, chk_idx, pad)
        live = var_edge >= 0
        edge = np.where(live, var_edge, pad).T
        slot = np.where(live, var_edge // m, 0).T
        dev = graph.chk_idx.device
    # csrc/bp_minsum.cu's check-state mode walks each list up to its
    # length and reads no entry past it
    lens = [np.minimum(np.where((lists != pad).any(axis=1), lists.shape[1] - (
        lists[:, ::-1] != pad).argmax(axis=1), 0), 255)
            for lists in (chk.T, edge.T)]
    lens = torch.from_numpy(np.concatenate(lens).astype(np.uint8)).to(dev)
    slot = torch.from_numpy(np.ascontiguousarray(slot, np.uint8)).to(dev)
    if wide:
        return MinsumPlanes(*(torch.from_numpy(np.ascontiguousarray(
            a, np.int32)).to(dev) for a in (chk, edge)), slot, lens)
    if not planes16(chk.shape[1], edge.shape[1], chk.shape[0]):
        raise ValueError("the min-sum kernels number edges and variables "
                         "with 16 bits")
    return MinsumPlanes(_u16(chk).to(dev), _u16(edge).to(dev), slot, lens)


_PLANES: dict = {}


def _planes_of(graph, wide: bool = False) -> MinsumPlanes:
    """``minsum_planes(graph, wide)``, built once for as long as the graph's
    tensors live (keyed on all of them: two graphs may share some)."""
    leaves = tuple(graph)
    key = tuple(map(id, leaves)) + ((True,) if wide else ())
    hit = _PLANES.get(key)
    if hit is not None and all(r() is t for r, t in zip(hit[0], leaves)):
        return hit[1]
    planes = minsum_planes(graph, wide)
    _PLANES[key] = (tuple(weakref.ref(t, lambda _, k=key: _PLANES.pop(k, None))
                          for t in leaves), planes)
    return planes


def _align16(x: int) -> int:
    return -(-x // 16) * 16


def minsum_smem_bytes(lanes: int, m: int, n: int, rw: int, cw: int,
                      bf16: bool, llr_shared: bool = True) -> int:
    """Dynamic shared memory of csrc/bp_minsum.cu for ``lanes`` shots per
    block: the staged planes (and the shared channel LLRs), then per shot
    c2v, v2c, the totals and the syndrome, each rounded up to 16 bytes."""
    E, V = m * rw, n * cw
    staged = (_align16(2 * E) + _align16(2 * V) + (_align16(V) if bf16 else 0)
              + (_align16(4 * n) if llr_shared else 0))
    per_shot = (_align16(4 * E) + _align16((2 if bf16 else 4) * E)
                + _align16(4 * n) + _align16(m))
    return staged + lanes * per_shot


PLANE_FORMS = _kernels.PLANE_FORMS


def minsum_checks_bytes(lanes: int, m: int, n: int, rw: int, cw: int,
                        planes: str = "staged16",
                        llr_shared: bool = True) -> int:
    """Dynamic shared memory of csrc/bp_minsum.cu's check-state mode
    (``"checks"``) for ``lanes`` shots per block: with ``planes`` =
    ``"staged16"`` the 16-bit planes and the shared channel LLRs, then per
    shot one 16-byte record per check — min1 and min2, the negative signs
    of its slots (a 4-byte mask, 8 above row weight 32) and a byte for the
    first minimum's slot, the sign product and the syndrome bit, which for
    8-byte masks lies beside the records — and the totals (4 * n), each
    piece rounded up to 16 bytes."""
    if planes not in PLANE_FORMS:
        raise ValueError(f"plane form {planes!r} is not one of {PLANE_FORMS}")
    staged = 0
    if planes == "staged16":
        staged = (_align16(2 * m * rw) + _align16(2 * n * cw)
                  + (_align16(4 * n) if llr_shared else 0))
    per_shot = (16 * m + (_align16(m) if minsum_wide(rw) else 0)
                + _align16(4 * n))
    return staged + lanes * per_shot


class MinsumLayout(NamedTuple):
    lanes: int       # shots a block holds at once
    threads: int     # threads per block: lanes x threads per shot
    grid: int        # blocks launched
    smem_bytes: int  # dynamic shared memory per block
    resident: int    # blocks per SM by threads and shared memory
    # where a lane's messages live: _kernels.MEMORY_MODES, whose index is
    # csrc/bp_minsum.cu's kMem
    memory: str = "shared"
    lane_bytes: int = 0     # device scratch per lane (device modes)
    # the check-state mode's plane form (PLANE_FORMS); the other modes read
    # staged 16-bit planes, or 32-bit ones in "device_planes"
    planes: str = "staged16"


def lane_layout(B: int, fixed: int, per_shot: int, rows: int, sm_count: int,
                lanes: int | None = None, limit: int = SMEM_LIMIT,
                what: str = "the min-sum kernels",
                items: int = MINSUM_ITEMS,
                memory: str = "shared") -> MinsumLayout:
    """The launch of a kernel whose lanes of warps each decode one shot and
    refill from a claim counter (csrc/bp_minsum.cu, csrc/fused_decode.cu),
    for a batch of B shots: ``fixed`` bytes of shared memory staged per
    block, ``per_shot`` per lane, ``rows`` the larger of a shot's checks and
    variables, ``limit`` the dynamic shared memory a block may take.  With
    a device ``memory`` (_kernels.MEMORY_MODES) the lanes' ``per_shot``
    bytes live in a device scratch instead and only ``fixed`` is shared
    memory.

    A block holds ``lanes`` shots at once, each on ``threads / lanes``
    threads (1024 / lanes in whole warps, at most one check and one
    variable per thread).  A large batch fills the block with shots of at
    most ``items`` checks and ``items`` variables per thread (MINSUM_ITEMS
    for the min-sum kernels), and its lanes refill as shots converge; a
    smaller one takes one shot per block for every MINSUM_SPREAD shots per
    SM, so a two-phase tail gives each straggler up to a whole block.  At most 15 shots and what the block's
    shared memory holds; ``lanes`` fixes the shots per block instead.  The
    grid is the blocks the batch needs, at most ``resident`` (by threads
    and shared memory; the wrapper lowers it to what the card reports,
    registers included) per SM.  ``"checks"`` (the check-state mode)
    keeps its lanes in shared memory as ``"shared"`` does."""
    shared = memory in ("shared", "checks")
    cap = min(MINSUM_MAX_LANES, (limit - fixed) // per_shot if shared
              else MINSUM_MAX_LANES * (fixed <= limit))
    if cap < 1:
        raise ValueError(f"{what}: one shot's messages and planes "
                         f"({fixed + per_shot} bytes) exceed {limit} "
                         f"bytes of shared memory")
    if lanes is None:
        full = max(1, items * MINSUM_MAX_THREADS // rows)
        lanes = max(1, min(cap, full, -(-B // (MINSUM_SPREAD * sm_count))))
    if not 1 <= lanes <= cap:
        raise ValueError(f"{what} hold 1..{cap} shots per block")
    per_lane = min(-(-rows // 32) * 32, MINSUM_MAX_THREADS // lanes // 32 * 32)
    threads = lanes * per_lane
    smem = fixed + (lanes * per_shot if shared else 0)
    resident = max(1, min(SM_THREADS // threads, SM_SMEM // (smem + 1024)))
    grid = max(1, min(-(-B // lanes), sm_count * resident))
    return MinsumLayout(lanes, threads, grid, smem, resident, memory,
                        0 if shared else per_shot)


# the check-state mode's largest column weight (MinsumPlanes.lens holds a
# float32 walk's terms, a variable's live terms and one padded, in a byte)
CHECKS_MAX_CW = 254


def checks_planes(m: int, n: int, rw: int, cw: int,
                  llr_shared: bool = True) -> str | None:
    """The plane form of the check-state mode for a graph: its 16-bit
    planes staged where one shot's check records fit beside them in a
    block's shared memory, else read from device memory while 16 bits
    number the graph, else 32-bit planes; None where not even one shot's
    records fit, or a column is heavier than CHECKS_MAX_CW."""
    if cw > CHECKS_MAX_CW:
        return None
    if planes16(m, n, rw):
        for form in ("staged16", "global16"):
            if minsum_checks_bytes(1, m, n, rw, cw, form,
                                   llr_shared) <= SMEM_LIMIT:
                return form
        return None
    if minsum_checks_bytes(1, m, n, rw, cw, "global32") <= SMEM_LIMIT:
        return "global32"
    return None


def minsum_layout(B: int, m: int, n: int, rw: int, cw: int, bf16: bool,
                  sm_count: int, llr_shared: bool = True,
                  lanes: int | None = None,
                  memory: str = "shared",
                  planes: str | None = None,
                  rows: int | None = None,
                  sectors: bool = False) -> MinsumLayout:
    """The launch of csrc/bp_minsum.cu for a batch of B shots
    (``lane_layout`` with its shared memory, ``minsum_smem_bytes``) in
    ``memory``, one of _kernels.MEMORY_MODES (``"shared"`` raises where not
    one shot fits a block) or ``"auto"``, as the card's wrappers ask, in
    this order: the shared-memory mode where 16-bit planes number the
    graph and a shot fits; else ``"checks"``, the check-state mode (one
    record per check and the totals per shot in shared memory,
    ``minsum_checks_bytes``; its planes in the form ``checks_planes``
    picks, or ``planes`` fixes), wherever one shot's records fit; else
    ``"device"`` (the lanes' messages in a device scratch, the 16-bit
    planes staged) while the planes fit a block, else ``"device_planes"``
    (32-bit planes read from device memory, nothing staged).  Every mode
    takes ``lane_layout``'s shots per block.

    The sector mode (``sectors``; B counts its (shot, sector) items and
    ``rows`` is the larger of a sector's checks and variables, by which a
    lane's threads are sized) runs in the shared-memory and device-memory
    modes only: ``"auto"`` passes over ``"checks"``, which raises."""
    minsum_wide(rw)
    rows = max(m, n) if rows is None else int(rows)
    fixed = minsum_smem_bytes(0, m, n, rw, cw, bf16, llr_shared)
    per_shot = minsum_smem_bytes(1, m, n, rw, cw, bf16, llr_shared) - fixed
    narrow = planes16(m, n, rw)
    form = planes or checks_planes(m, n, rw, cw, llr_shared)
    if memory == "auto":
        memory = ("shared" if narrow and fixed + per_shot <= SMEM_LIMIT
                  else "checks" if form is not None and not sectors
                  else "device" if narrow and fixed <= SMEM_LIMIT
                  else "device_planes")
    if memory not in _kernels.MEMORY_MODES:
        raise ValueError(f"min-sum memory {memory!r} is not one of "
                         f"{_kernels.MEMORY_MODES} or 'auto'")
    if memory == "checks":
        if sectors:
            raise ValueError("the min-sum kernels' sector mode has no "
                             "check-state mode")
        if form is None or cw > CHECKS_MAX_CW:
            raise ValueError(
                f"the min-sum kernels: one shot's check records "
                f"({minsum_checks_bytes(1, m, n, rw, cw, 'global32')} "
                f"bytes) exceed {SMEM_LIMIT} bytes of shared memory, or "
                f"column weight {cw} exceeds {CHECKS_MAX_CW}")
        if form != "global32" and not narrow:
            raise ValueError("the min-sum kernels number edges and "
                             "variables with 16 bits")
        fixed = minsum_checks_bytes(0, m, n, rw, cw, form, llr_shared)
        per_shot = minsum_checks_bytes(1, m, n, rw, cw, form,
                                       llr_shared) - fixed
        return lane_layout(B, fixed, per_shot, rows, sm_count, lanes,
                           memory=memory)._replace(planes=form)
    return lane_layout(B, 0 if memory == "device_planes" else fixed,
                       per_shot, rows, sm_count, lanes, memory=memory
                       )._replace(planes="global32" if memory == "device_planes"
                                  else "staged16")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def minsum_resident(index: int, bf16: bool, threads: int, smem_bytes: int,
                    memory: str = "shared", wide: bool = False,
                    planes: str = "staged16") -> int:
    """Blocks of csrc/bp_minsum.cu (in ``memory``, with the check-state
    mode's plane form ``planes``; its wide instance with ``wide``) that one
    SM of CUDA device ``index`` holds at once
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    fn = _kernels.library("bp_minsum").bp_minsum_resident
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    with torch.cuda.device(index):
        rc = fn(int(bf16), threads, smem_bytes,
                _kernels.MEMORY_MODES.index(memory),
                PLANE_FORMS.index(planes), int(wide),
                ctypes.addressof(blocks))
    _kernels.check_launch("bp_minsum_resident", rc)
    return blocks.value


def card_minsum_layout(dev, B, m, n, rw, cw, bf16, llr_shared=True,
                       memory="auto", planes=None, rows=None,
                       sectors=False):
    """``minsum_layout`` on CUDA device ``dev`` (by default the check-state
    or a device-memory mode where the shared one does not fit): its SM
    count, and the grid lowered to the blocks the card holds at once."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    lay = minsum_layout(B, m, n, rw, cw, bf16, _sm_count(index), llr_shared,
                        memory=memory, planes=planes, rows=rows,
                        sectors=sectors)
    held = minsum_resident(index, bf16, lay.threads, lay.smem_bytes,
                           lay.memory, minsum_wide(rw), lay.planes)
    if held < 1:
        raise ValueError(f"the min-sum kernels: a block of {lay.threads} "
                         f"threads and {lay.smem_bytes} bytes does not fit")
    return lay._replace(grid=min(lay.grid, _sm_count(index) * held),
                        resident=held)


def _minsum_call(name, fn, dev, synd, inputs, graph, bf16, per_shot,
                 max_iter, scale, sectors=None):
    """Launch kernel 1 or the bf16 head on (B, m) syndromes, in the memory
    mode ``card_minsum_layout`` picks (or ``_kernels.force_memory``
    fixes): ``fn`` takes ``inputs(planes)`` (its inputs before the
    outputs, over the graph's planes), the outputs, the claim counter, the
    sizes, the layout and the device scratch of its device-memory modes,
    and with ``sectors`` (kernel 1's sector mode) the sector count and
    offsets.  Returns batch-major (err, conv, post, iters) and the mode;
    with sectors conv and iters are (B, n_sec)."""
    B, m = synd.shape
    if hasattr(graph, "chk_nbr"):  # a TannerGraph
        rw, (n, cw) = graph.chk_nbr.shape[1], graph.var_nbr.shape
    else:                          # a head's planes
        rw, (n, cw) = graph.chk_idx.shape[0], graph.var_edge.shape
    n_sec = 1 if sectors is None else len(sectors[0])
    rows = None if sectors is None else max(max(sectors[0]),
                                            max(sectors[1]))
    lay = card_minsum_layout(dev, B * n_sec, m, n, rw, cw, bf16,
                             not per_shot, _kernels.memory_mode(),
                             _kernels.planes_form(), rows=rows,
                             sectors=sectors is not None)
    lanes_g = None
    if lay.lane_bytes:
        lanes_g = torch.empty((lay.grid * lay.lanes * lay.lane_bytes,),
                              dtype=torch.uint8, device=dev)
    planes = _planes_of(graph, wide=lay.planes == "global32")
    pointers = inputs(planes)
    err = torch.empty((B, n), dtype=torch.uint8, device=dev)
    post = torch.empty((B, n), dtype=torch.float32, device=dev)
    conv = torch.empty((B, n_sec), dtype=torch.uint8, device=dev)
    iters = torch.empty((B, n_sec), dtype=torch.int32, device=dev)
    claims = torch.zeros((1,), dtype=torch.int32, device=dev)
    outs = [t.data_ptr() for t in (err, post, conv, iters, claims)]
    p, i = ctypes.c_void_p, ctypes.c_int
    tail, tail_types = [], []
    if sectors is not None:
        sec_off = sector_offsets(sectors, dev)
        tail, tail_types = [n_sec, sec_off.data_ptr()], [i, p]
    fn.argtypes = [type(a) if isinstance(a, ctypes.c_int) else p
                   for a in pointers] + [p] * 5 + [i] * 6 + [ctypes.c_float] \
        + [i] * 6 + [p, p] + tail_types + [p]
    fn.restype = ctypes.c_int
    rc = _stream_call(fn, dev, *pointers, *outs, m, n, rw, cw, B,
                      int(max_iter), float(scale), lay.lanes,
                      lay.threads // lay.lanes, lay.grid, lay.smem_bytes,
                      _kernels.MEMORY_MODES.index(lay.memory),
                      PLANE_FORMS.index(lay.planes), planes.lens.data_ptr(),
                      None if lanes_g is None else lanes_g.data_ptr(), *tail)
    _kernels.check_launch(name, rc)
    if sectors is None:
        conv, iters = conv[:, 0], iters[:, 0]
    return (err, conv.to(torch.bool), post, iters), lay.memory


@functools.lru_cache(maxsize=64)
def sector_offsets(sectors, device) -> torch.Tensor:
    """``sectors = ((m0, m1, ...), (n0, n1, ...))`` as csrc/bp_minsum.cu's
    sector mode reads them: int32 (2 * (n_sec + 1),), the check offsets
    then the variable offsets, each from 0 to its total."""
    offs = [np.concatenate([[0], np.cumsum(sizes)]) for sizes in sectors]
    return torch.from_numpy(np.concatenate(offs).astype(np.int32)).to(device)


def _launch(graph, synd, llr0, llr_per_shot, max_iter, scale, sectors=None):
    m, rw = graph.chk_nbr.shape
    n, cw = graph.var_nbr.shape
    B = synd.shape[0]
    dev = synd.device
    if synd.dtype != torch.uint8 or synd.shape[1] != m:
        raise ValueError(f"syndromes must be uint8 with {m} checks")
    want = (B, n) if llr_per_shot else (n,)
    if llr0.dtype != torch.float32 or tuple(llr0.shape) != want:
        raise ValueError(f"channel LLRs must be float32 of shape {want}")
    if max_iter < 0:
        raise ValueError(f"max_iter must be >= 0, got {max_iter}")
    if llr0.device != dev or graph.chk_nbr.device != dev:
        raise ValueError("bp_minsum needs its tensors on one device")
    if cw < 1:
        raise ValueError(f"bp_minsum needs a variable degree >= 1, got {cw}")
    minsum_wide(rw)
    if m * B >= 2 ** 31 or n * B >= 2 ** 31:
        raise ValueError("bp_minsum batch too large for int32 indexing")
    if sectors is not None:
        return _launch_sectors(graph, synd, llr0, llr_per_shot, max_iter,
                               scale, sectors)
    out, memory = _minsum_call(
        "bp_minsum", _kernels.library("bp_minsum").bp_minsum_launch, dev,
        synd, lambda planes: [synd.data_ptr(), llr0.data_ptr(),
                              ctypes.c_int(int(llr_per_shot)),
                              planes.chk.data_ptr(), planes.edge.data_ptr()],
        graph, False, llr_per_shot, max_iter, scale)
    _kernels.count_launch(bp_minsum, "launches", dev)
    _kernels.count_launch(bp_minsum, "device_launches", dev,
                          memory == "device")
    _kernels.count_launch(bp_minsum, "device_planes_launches", dev,
                          memory == "device_planes")
    _kernels.count_launch(bp_minsum, "checks_launches", dev,
                          memory == "checks")
    _kernels.count_launch(bp_minsum, "wide_launches", dev, minsum_wide(rw))
    _kernels.declare_cost(*minsum_cost(m, n, rw, cw, B, B * int(max_iter)))
    return out


def _launch_sectors(graph, synd, llr0, llr_per_shot, max_iter, scale,
                    sectors):
    """Kernel 1's sector mode: one launch whose claims hand out (shot,
    sector) items; each shot's convergence is the AND over its sectors and
    its iterations the max.  ``sectors`` as ``check_sectors`` returns
    them."""
    m, rw = graph.chk_nbr.shape
    n, cw = graph.var_nbr.shape
    B = synd.shape[0]
    dev = synd.device
    (err, conv, post, iters), _ = _minsum_call(
        "bp_minsum_sectors",
        _kernels.library("bp_minsum").bp_minsum_sectors_launch, dev, synd,
        lambda planes: [synd.data_ptr(), llr0.data_ptr(),
                        ctypes.c_int(int(llr_per_shot)),
                        planes.chk.data_ptr(), planes.edge.data_ptr()],
        graph, False, llr_per_shot, max_iter, scale, sectors=sectors)
    _kernels.count_launch(bp_minsum, "sector_launches", dev)
    _kernels.declare_cost(*minsum_cost(m, n, rw, cw, B, B * int(max_iter)))
    return err, conv.all(dim=1), post, iters.amax(dim=1)


def minsum_cost(m: int, n: int, rw: int, cw: int, B: int,
                shot_iters: int) -> tuple[float, float]:
    """(operations, bytes) of a min-sum decode of B shots running
    ``shot_iters`` shot-iterations, as the "bound" column of PERF.md's
    kernel table counts them: the syndromes, LLRs and graph read once and
    the four outputs written once; per shot-iteration 11 operations per
    edge and 2 per variable.  Edges are the graph's m x rw slots (its
    nonzeros for the regular hgp_34 codes)."""
    nbytes = (m * B + 4 * n + 5 * m * rw + 9 * n * cw
              + n * B + 4 * n * B + B + 4 * B)
    return shot_iters * (11 * m * rw + 2 * n), nbytes


def bp_minsum(graph, syndromes, channel_llr, *, max_iter: int,
              ms_scaling_factor: float = 0.625, sectors=None):
    """Min-sum decode of (B, m) uint8 syndromes; ``channel_llr`` is (n,) or
    (B, n) float32 on the same device.  Returns batch-major
    ``(error (B, n) uint8, converged (B,) bool, posterior_llr (B, n) f32,
    iterations (B,) int32)``.  CUDA tensors launch the kernel (or raise) in
    the memory mode ``minsum_layout`` picks: ``launches`` counts them,
    ``checks_launches`` those in the check-state mode,
    ``device_launches`` and ``device_planes_launches`` those in each
    device-memory mode, ``wide_launches`` those of the wide instance (row
    weights 33-64).  CPU tensors run ``minsum_plain``.

    ``sectors = ((m0, m1, ...), (n0, n1, ...))`` decodes a block-diagonal
    graph as independent sub-decodes (``bp_loop``): on the card in
    kernel 1's sector mode (``csrc/bp_minsum.cu``
    ``bp_minsum_sectors_launch``, counted in ``sector_launches`` and in no
    other count), whose claims hand out (shot, sector) items, so each lane
    decodes one sector of one shot; its outputs equal separate decodes of
    the sectors bit for bit.  Both routes raise ValueError unless the
    graph is block diagonal along ``sectors`` (``check_sectors``)."""
    per_shot = channel_llr.dim() == 2
    if sectors is not None:
        sectors = check_sectors(graph, sectors)
    if syndromes.is_cuda and not _kernels.plain_forced():
        return _launch(graph, syndromes.contiguous(), channel_llr.contiguous(),
                       per_shot, max_iter, ms_scaling_factor, sectors)
    llr0_bl = channel_llr.t() if per_shot else channel_llr[:, None]
    err, conv, llr, iters = minsum_plain(graph, syndromes.t().contiguous(),
                                         llr0_bl, max_iter, ms_scaling_factor,
                                         sectors)
    return err.t(), conv, llr.t(), iters


bp_minsum.launches = 0
bp_minsum.device_launches = 0
bp_minsum.device_planes_launches = 0
bp_minsum.checks_launches = 0
bp_minsum.wide_launches = 0
bp_minsum.sector_launches = 0


# ---------------------------------------------------------------------------
# The BP head family: int8 min-sum (B6) and the bf16 head (B1 bf16, B9)
# ---------------------------------------------------------------------------

# which BP program serves a decode, in the JAX package's vocabulary, which
# names its programs by their results:
#   sparse_gather — the bf16 head of a v2 head (SparseHeadGraph)
#   dense_onehot  — the bf16 head of a v1 head (PallasHeadGraph): the JAX v1
#                   kernel's results; the port runs the same gather kernel
#   sparse_int8   — int8 min-sum, csrc/bp_int8.cu
#   xla_twin      — exact float32 min-sum (kernel 1) and every plain version
KERNEL_VARIANTS = ("dense_onehot", "sparse_gather", "sparse_int8",
                   "xla_twin")

# The int8 quantization contract, copied from the JAX package: an int8
# decode's WER matches the unquantized decoder's within INT8_WER_RTOL
# relative, with a floor of INT8_WER_NSIGMA combined binomial standard errors.
INT8_WER_RTOL = 0.1
INT8_WER_NSIGMA = 4.0


def int8_parity_tolerance(wer_ref: float, shots: int) -> float:
    """Allowed |wer_int8 - wer_ref| per the quantization contract."""
    sigma = math.sqrt(max(wer_ref * (1.0 - wer_ref), 1e-12) / max(shots, 1))
    return max(INT8_WER_RTOL * wer_ref, INT8_WER_NSIGMA * sigma)


BIG_I32 = 2 ** 30  # padded slots' magnitude in the int8 check update
# The JAX package writes each int8 scale as tile_max / 127.0; XLA compiles a
# division by that constant into a multiplication by its float32 reciprocal,
# so the port multiplies by the same constant (0x3c010204).
INV127 = float(np.float32(1.0) / np.float32(127.0))

# The JAX package's tile rule, copied with its analytic byte counts.  These
# are not Hopper memory gates: they decide which decodes get the int8 or
# dense-head numerics and, for int8, the batch tile that shares one scale —
# so results hang on them.  No calibration file is read: the JAX package's
# table has no measured entry for these heads, so it uses the same prior.
_SCAT_VMEM_LIMIT = 8 * 1024 * 1024
_V2_ONEHOT_LIVE = 3
_V2_FIXED_LIMIT = 16 * 1024 * 1024
_TILE_BUDGET = 30 * 1024 * 1024


def _analytic_per_shot_bytes(rw: int, m: int, n: int) -> int:
    return 2 * (4 * rw * m + 20 * n + 16 * m)


def _max_block_b(per_shot: int, budget: int, b: int, want: int) -> int:
    """Largest batch tile <= ``want`` that divides ``b`` with
    ``tile * per_shot <= budget``; 0 when none does."""
    top = min(want, b)
    for bt in [top] + [1 << k for k in range(9, 2, -1)]:
        if bt <= top and b % bt == 0 and bt * per_shot <= budget:
            return bt
    return 0


class SparseHeadGraph(NamedTuple):
    """The v2 head's per-H data (int8 and bf16): slot-major edge indices.

    ``chk_idx[s, i]`` is the variable of check i's slot-s edge (0 for
    padding, which ``mask`` kills); edge ``s * m + i``.  ``var_edge`` lists
    each variable's edges in ascending order, which is (slot, check) order
    (-1 pads): the kernels' gather form of the scatter-add."""

    chk_idx: torch.Tensor   # (rw, m) int32
    mask: torch.Tensor      # (rw, m) float32, 1.0 real edge, 0.0 padding
    var_edge: torch.Tensor  # (n, cw) int32

    @property
    def rw(self) -> int:
        return self.chk_idx.shape[0]

    @property
    def m(self) -> int:
        return self.chk_idx.shape[1]

    @property
    def n(self) -> int:
        return self.var_edge.shape[0]

    @property
    def idx_bytes(self) -> int:
        return self.rw * self.m * 8

    @property
    def fixed_overhead_bytes(self) -> int:
        return self.idx_bytes + _V2_ONEHOT_LIVE * self.m * self.n * 2

    def fits_vmem(self) -> bool:
        """The JAX package's residency gate for this head (module note)."""
        return self.fixed_overhead_bytes <= _V2_FIXED_LIMIT

    def per_shot_bytes(self) -> int:
        return _analytic_per_shot_bytes(self.rw, self.m, self.n)

    def max_block_b(self, b: int, want: int = 512) -> int:
        """The JAX package's batch tile for ``b`` shots (module note)."""
        return _max_block_b(self.per_shot_bytes(),
                            _TILE_BUDGET - self.fixed_overhead_bytes, b, want)


class PallasHeadGraph(NamedTuple):
    """The v1 head's per-H data: a SparseHeadGraph's index planes, which
    the bf16 head kernel reads, under the v1 head's own gates.  The JAX
    package's v1 head is a dense slot-major one-hot stack (``scat``, rw x m
    x n bf16), and its residency gate and batch tile count that stack's
    bytes (``scat_bytes``); ``dense_stack`` builds it for the plain
    version only."""

    chk_idx: torch.Tensor   # (rw, m) int32
    mask: torch.Tensor      # (rw, m) float32
    var_edge: torch.Tensor  # (n, cw) int32

    @property
    def rw(self) -> int:
        return self.chk_idx.shape[0]

    @property
    def m(self) -> int:
        return self.chk_idx.shape[1]

    @property
    def n(self) -> int:
        return self.var_edge.shape[0]

    @property
    def scat_bytes(self) -> int:
        return self.rw * self.m * self.n * 2

    def fits_vmem(self) -> bool:
        """The JAX package's residency gate for this head (module note)."""
        return self.scat_bytes <= _SCAT_VMEM_LIMIT

    def per_shot_bytes(self) -> int:
        return _analytic_per_shot_bytes(self.rw, self.m, self.n)

    def max_block_b(self, b: int, want: int = 512) -> int:
        """The JAX package's batch tile for ``b`` shots (module note); the
        bf16 head's results do not depend on it, its engage gate does."""
        return _max_block_b(self.per_shot_bytes(),
                            _TILE_BUDGET - self.scat_bytes, b, want)


class DenseStack(NamedTuple):
    """A head's graph as the plain version of the bf16 head walks it: the
    slot-major one-hot incidence stack, ``scat[s, i, v] = 1`` iff check i's
    slot-s edge is variable v.

    ``rank[s, i]`` counts the checks before i whose slot-s edge is the same
    variable.  A slot's scatter-sum adds, for each variable, up to cw
    messages; their float32 sum is not always exact, so its order is part
    of the result.  The plain version fixes it to ascending check order —
    the order of a sequential dot product, which is what the JAX package's
    one-hot products give on the CPU — by splitting each slot's product by
    rank: every rank's product has at most one term per variable, exact in
    any order, and the ranks add in sequence."""

    scat: torch.Tensor  # (rw, m, n) bfloat16, exact 0/1
    mask: torch.Tensor  # (rw, m) float32
    rank: torch.Tensor  # (rw, m) int32


def dense_stack(head) -> DenseStack:
    """The DenseStack of a SparseHeadGraph or a PallasHeadGraph, on the
    head's device."""
    chk_idx = head.chk_idx.cpu().numpy()
    mask = head.mask.cpu().numpy()
    rw, m = chk_idx.shape
    es, ei = np.nonzero(mask > 0)
    scat = np.zeros((rw, m, head.n), np.float32)
    scat[es, ei, chk_idx[es, ei]] = 1.0
    rank = np.zeros((rw, m), np.int32)
    for s in range(rw):
        seen = np.zeros(head.n, np.int32)
        for i in np.nonzero(mask[s] > 0)[0]:
            rank[s, i] = seen[chk_idx[s, i]]
            seen[chk_idx[s, i]] += 1
    dev = head.chk_idx.device
    return DenseStack(torch.from_numpy(scat).to(dev, torch.bfloat16),
                      head.mask, torch.from_numpy(rank).to(dev))


def _planes(graph):
    """Slot-major (rw, m) index and mask planes of a TannerGraph."""
    chk_nbr = np.asarray(torch.as_tensor(graph.chk_nbr).cpu())
    chk_mask = np.asarray(torch.as_tensor(graph.chk_mask).cpu())
    n = graph.var_nbr.shape[0]
    return (np.ascontiguousarray(chk_nbr.T.astype(np.int32)),
            np.ascontiguousarray(chk_mask.T.astype(np.float32)), n)


def _var_edge(chk_idx, mask, n: int) -> np.ndarray:
    """(n, cw) int32: each variable's edges ``s * m + i`` ascending, -1
    pads."""
    m = chk_idx.shape[1]
    s, i = np.nonzero(mask > 0)
    v = chk_idx[s, i]
    order = np.argsort(v, kind="stable")
    v, e = v[order], (s * m + i)[order]
    counts = np.bincount(v, minlength=n)
    var_edge = np.full((n, max(1, int(counts.max(initial=0)))), -1, np.int32)
    starts = np.cumsum(counts) - counts
    var_edge[v, np.arange(v.size) - starts[v]] = e
    return var_edge


def _head_from_planes(cls, chk_idx, mask, n: int, device):
    chk_idx = np.asarray(chk_idx, np.int32)
    mask = np.asarray(mask, np.float32)
    var_edge = _var_edge(chk_idx, mask, n)
    return cls(*(torch.from_numpy(np.array(a, order="C")).to(device)
                 for a in (chk_idx, mask, var_edge)))


def sparse_head_from_planes(chk_idx, mask, n: int,
                            device="cuda") -> SparseHeadGraph:
    """A SparseHeadGraph from (rw, m) index and mask planes."""
    return _head_from_planes(SparseHeadGraph, chk_idx, mask, n, device)


def build_sparse_head(graph, device="cuda") -> SparseHeadGraph:
    """The v2 head's index planes from a TannerGraph."""
    return sparse_head_from_planes(*_planes(graph), device)


def pallas_head_from_planes(chk_idx, mask, n: int,
                            device="cuda") -> PallasHeadGraph:
    """A PallasHeadGraph from (rw, m) index and mask planes."""
    return _head_from_planes(PallasHeadGraph, chk_idx, mask, n, device)


def build_pallas_head(graph, device="cuda") -> PallasHeadGraph:
    """The v1 head's index planes from a TannerGraph."""
    return pallas_head_from_planes(*_planes(graph), device)


def _freeze(state, match, err_new, totals, it):
    """Each shot's outputs freeze at its first convergence."""
    err, llr, done, iters = state
    keep = done[None, :]
    return (torch.where(keep, err, err_new), torch.where(keep, llr, totals),
            done | match,
            torch.where(match & ~done, it + 1, iters).to(torch.int32))


def _head_init(n, B, llr0, head_iters, dev):
    return (torch.zeros((n, B), dtype=torch.uint8, device=dev),
            llr0[:, None].expand(n, B).clone(),
            torch.zeros(B, dtype=torch.bool, device=dev),
            torch.full((B,), head_iters, dtype=torch.int32, device=dev))


def _fma(a, b, c):
    """float32 a * b + c rounded once, as XLA's CPU backend contracts the
    JAX package's ``c + a * b`` in the int8 loop (kernel B6 calls
    ``__fmaf_rn``).  ``b`` holds small integers, so the product and, at
    these magnitudes, the sum are exact in float64 before the one rounding
    to float32."""
    return (c.double() + a.double() * b.double()).float()


def minsum_int8_plain(sgraph: SparseHeadGraph, synd_bl, llr0, *,
                      head_iters: int, scale: float, block_b: int,
                      early_stop: bool):
    """Plain version of kernel B6: ``_minsum_int8_loop`` per tile of
    ``block_b`` consecutive shots, all tiles at once.

    synd_bl: (m, B) uint8 with B a multiple of block_b; llr0: (n,) float32.
    Returns batch-last ``(err (n, B) uint8, done (B,) bool, llr (n, B) f32,
    iters (B,) int32)``.  Messages are int8 with one scale per tile per
    iteration and direction, taken over every shot of the tile, converged
    or not; converged shots' outputs freeze, their messages go on.  The
    totals and the new v2c are fused multiply-adds (``_fma``).  The
    quantizing division is a tensor division (never by a host scalar, which
    PyTorch turns into a multiplication by the reciprocal on the card)."""
    rw, m = sgraph.chk_idx.shape
    n = sgraph.n
    B = synd_bl.shape[1]
    T = B // block_b
    dev = synd_bl.device
    f32 = torch.float32
    valid = (sgraph.mask > 0)[:, :, None]                      # (rw, m, 1)
    maskf = sgraph.mask[:, :, None]
    idx = sgraph.chk_idx.long()
    scatter_idx = torch.where(valid[:, :, 0], idx, n).reshape(-1)
    synd_sign = 1.0 - 2.0 * synd_bl.to(f32)                    # (m, B)
    big = torch.tensor(BIG_I32, dtype=torch.int32, device=dev)
    scale_t = torch.tensor(scale, dtype=f32, device=dev)
    inv127 = torch.tensor(INV127, dtype=f32, device=dev)
    eps = torch.full((T, 1), 1e-30, dtype=f32, device=dev)

    def tile_scale(planes):
        """max(tile max |planes| * f32(1/127), 1e-30), one per tile, per
        shot."""
        tmax = planes.abs().reshape(rw * m, T, block_b).amax(dim=(0, 2))
        q = torch.maximum(tmax[:, None] * inv127, eps)
        return q.expand(T, block_b).reshape(B)

    def quantize(planes, q):
        return torch.round(torch.clamp(planes / q, -127.0, 127.0)).to(torch.int8)

    def gather(tot_b):
        return torch.where(valid, tot_b.to(f32)[idx], 0.0)    # (rw, m, B)

    t0 = gather(llr0.to(torch.bfloat16)[:, None].expand(n, B))
    qv = tile_scale(t0)
    v2c = quantize(t0, qv)
    state = _head_init(n, B, llr0, head_iters, dev)
    for it in range(head_iters):
        if early_stop and bool(state[2].all()):
            break
        # check update on raw int8 magnitudes, streaming top-2 over slots
        v = v2c.to(torch.int32)
        mag = torch.where(valid, v.abs(), big)
        sgn = torch.where(valid & (v < 0), -1.0, 1.0)
        min1 = big.expand(m, B)
        min2 = min1
        amin = torch.zeros((m, B), dtype=torch.int64, device=dev)
        sgn_tot = synd_sign
        for s in range(rw):
            sgn_tot = sgn_tot * sgn[s]
            is_new = mag[s] < min1
            min2 = torch.where(is_new, min1, torch.minimum(min2, mag[s]))
            amin = torch.where(is_new, s, amin)
            min1 = torch.minimum(min1, mag[s])
        slots = torch.arange(rw, device=dev)[:, None, None]
        excl = torch.minimum(torch.where(amin[None] == slots, min2[None],
                                         min1[None]), big)
        c2v_f = maskf * (scale_t * sgn_tot[None] * sgn
                         * (excl.to(f32) * qv))
        qc = tile_scale(c2v_f)
        c2v = quantize(c2v_f, qc)
        # exact int32 scatter-add; padded slots land in scratch row n
        tot_i = torch.zeros((n + 1, B), dtype=torch.int32, device=dev)
        tot_i.index_add_(0, scatter_idx, c2v.reshape(rw * m, B).to(torch.int32))
        totals = _fma(qc, tot_i[:n], llr0[:, None])
        t_e = gather(totals.to(torch.bfloat16))
        # subtract exactly what was scattered: the quantized message
        v2c_f = _fma(-qc, c2v, t_e)
        parity = ((t_e < 0.0) & valid).sum(dim=0) & 1
        match = (parity == synd_bl).all(dim=0)
        state = _freeze(state, match, (totals < 0.0).to(torch.uint8), totals, it)
        qv = tile_scale(v2c_f)
        v2c = quantize(v2c_f, qv)
    err, llr, done, iters = state
    return err, done, llr, iters


def _add_rank(part, prod):
    """One rank's product added to a slot's scatter-sum (float32)."""
    return part + prod


def minsum_dense_plain(head, synd_bl, llr0, *, head_iters: int,
                       scale: float, early_stop: bool):
    """Plain version of the bf16 head (and of B5's bf16 mode):
    ``_minsum_plane_loop`` over the dense one-hot stack of ``head`` (a
    SparseHeadGraph or a PallasHeadGraph; ``dense_stack``), line by line.
    Gathers and scatter-sums are float32 products of the one-hot planes
    with bf16-rounded operands, each slot's scatter split by rank; v2c is
    stored as bf16; the totals add the slots' sums in slot order, starting
    from the channel LLRs.  Same arguments and outputs as
    ``minsum_int8_plain`` less the tile: every shot is decoded alone."""
    pgraph = dense_stack(head)
    rw, m, n = pgraph.scat.shape
    B = synd_bl.shape[1]
    dev = synd_bl.device
    f32, bf16 = torch.float32, torch.bfloat16
    S = pgraph.scat.to(f32)
    rank = pgraph.rank[:, :, None]
    ranks = (pgraph.rank.amax(dim=1) + 1).tolist()
    valid = (pgraph.mask > 0)[:, :, None]
    maskf = pgraph.mask[:, :, None]
    synd_sign = 1.0 - 2.0 * synd_bl.to(f32)
    big = torch.tensor(BIG, dtype=f32, device=dev)
    scale_t = torch.tensor(scale, dtype=f32, device=dev)
    llr0_b = llr0.to(bf16).to(f32)[:, None]
    v2c = [(S[s] @ llr0_b).expand(m, B).to(bf16) for s in range(rw)]
    state = _head_init(n, B, llr0, head_iters, dev)
    for it in range(head_iters):
        if early_stop and bool(state[2].all()):
            break
        min1 = big.expand(m, B)
        min2 = min1
        amin = torch.zeros((m, B), dtype=torch.int64, device=dev)
        sgn_tot = synd_sign
        sgn = []
        for s in range(rw):
            v = v2c[s].to(f32)
            mag = torch.where(valid[s], v.abs(), big)
            sg = torch.where(valid[s] & (v < 0), -1.0, 1.0)
            sgn.append(sg)
            sgn_tot = sgn_tot * sg
            is_new = mag < min1
            min2 = torch.where(is_new, min1, torch.minimum(min2, mag))
            amin = torch.where(is_new, s, amin)
            min1 = torch.minimum(min1, mag)
        totals = llr0[:, None].expand(n, B)
        c2v = []
        for s in range(rw):
            excl = torch.where(amin == s, min2, min1)
            c = maskf[s] * (scale_t * sgn_tot * sgn[s] * torch.minimum(excl, big))
            c2v.append(c)
            c_b = c.to(bf16).to(f32)
            part = None
            for r in range(ranks[s]):
                prod = S[s].t() @ torch.where(rank[s] == r, c_b, 0.0)
                part = prod if part is None else _add_rank(part, prod)
            totals = totals + part
        tot_b = totals.to(bf16).to(f32)
        parity = torch.zeros((m, B), dtype=torch.int32, device=dev)
        for s in range(rw):
            t_e = S[s] @ tot_b
            v2c[s] = (t_e - c2v[s]).to(bf16)
            parity += ((t_e < 0.0) & valid[s]).to(torch.int32)
        match = ((parity & 1) == synd_bl).all(dim=0)
        state = _freeze(state, match, (totals < 0.0).to(torch.uint8), totals, it)
    err, llr, done, iters = state
    return err, done, llr, iters


def slot_ordered_graph(graph):
    """A TannerGraph whose variable lists run in (check slot, check) order —
    the order of the plain bf16 head's rank-split scatter (``DenseStack``),
    which the fused decode's bf16 mode sums in.
    Takes and returns numpy leaves; ``chk_nbr_slot`` follows the new
    lists."""
    var_nbr = np.asarray(graph.var_nbr)
    var_slot = np.asarray(graph.var_nbr_slot)
    var_mask = np.asarray(graph.var_mask)
    m = np.asarray(graph.chk_nbr).shape[0]
    order = np.argsort(np.where(var_mask, var_slot * m + var_nbr, np.iinfo(np.int64).max),
                       axis=1, kind="stable")
    var_nbr, var_slot, var_mask = (np.take_along_axis(a, order, axis=1)
                                   for a in (var_nbr, var_slot, var_mask))
    chk_nbr_slot = np.array(graph.chk_nbr_slot)
    j, t = np.nonzero(var_mask)
    chk_nbr_slot[var_nbr[j, t], var_slot[j, t]] = t
    return graph._replace(chk_nbr_slot=chk_nbr_slot, var_nbr=var_nbr,
                          var_nbr_slot=var_slot, var_mask=var_mask)


def _check_head_inputs(name, head, syndromes, channel_llr):
    b, m = syndromes.shape
    if syndromes.dtype != torch.uint8 or m != head.m:
        raise ValueError(f"{name}: syndromes must be uint8 with {head.m} checks")
    if channel_llr.dtype != torch.float32 or tuple(channel_llr.shape) != (head.n,):
        raise ValueError(f"{name}: channel LLRs must be one float32 vector of "
                         f"{head.n} (the head shares them across shots)")
    for t in (channel_llr, *head):
        if t.device != syndromes.device:
            raise ValueError(f"{name} needs its tensors on one device")
    if m * b >= 2 ** 31 or head.n * b >= 2 ** 31:
        raise ValueError(f"{name}: batch too large for int32 indexing")
    return b


def _stream_call(fn, dev, *args):
    with torch.cuda.device(dev):
        return fn(*args, torch.cuda.current_stream(dev).cuda_stream)


# shots per block of kernel B6 (a power of two dividing the tile; the tile's
# blocks form one thread-block cluster of at most INT8_MAX_CLUSTER)
INT8_MAX_LANES = 32
INT8_MAX_CLUSTER = 16
# row weights of csrc/bp_int8.cu (and B5's int8 mode): 32-bit slot masks up
# to MINSUM_NARROW_RW, 64-bit ones (the wide instances) up to INT8_MAX_RW
INT8_MAX_RW = 64


# shared memory of kernel B6's static arrays, rounded up
_INT8_STATIC = 1024


def _round16(x: int) -> int:
    return -(-x // 16) * 16


def int8_smem_bytes(lanes: int, rw: int, m: int, n: int,
                    staged: bool = False) -> int:
    """Dynamic shared memory of kernel B6: int8 messages (rounded up to 16
    bytes) and bf16 totals for each shot of the block, and with ``staged``
    the block's index plane as 16-bit indices (rounded up to 16 bytes)."""
    return (_round16(2 * rw * m) if staged else 0) \
        + _round16(lanes * rw * m) + 2 * n * lanes


def int8_staged(lanes: int, rw: int, m: int, n: int) -> bool:
    """Whether kernel B6 copies the index plane into shared memory, as
    16-bit indices: when n < 2^15 and it fits beside the messages and totals
    of ``lanes`` shots; otherwise the kernel reads it from device memory."""
    return (n < 1 << 15 and int8_smem_bytes(lanes, rw, m, n, True)
            + _INT8_STATIC <= SMEM_LIMIT)


def int8_layout(block_b: int, rw: int, m: int, n: int) -> tuple[int, int]:
    """(shots per block, blocks per cluster) of kernel B6 for a tile of
    ``block_b`` shots: the most shots per block (<= 32, dividing the tile)
    whose messages and totals fit in shared memory.  Raises when the tile
    needs a cluster of more than 16 blocks."""
    lanes = INT8_MAX_LANES
    while lanes > 1 and (block_b % lanes
                         or int8_smem_bytes(lanes, rw, m, n) > SMEM_LIMIT):
        lanes //= 2
    if int8_smem_bytes(lanes, rw, m, n) > SMEM_LIMIT \
            or not 1 <= rw <= INT8_MAX_RW:
        raise ValueError(f"bp_head_int8: rw={rw}, m={m}, n={n} do not fit the "
                         f"kernel ({SMEM_LIMIT} bytes of shared memory for "
                         f"one shot, row weights 1..{INT8_MAX_RW})")
    if block_b // lanes > INT8_MAX_CLUSTER:
        raise ValueError(f"bp_head_int8: a tile of {block_b} shots needs "
                         f"{block_b // lanes} blocks of {lanes}; a cluster "
                         f"takes at most {INT8_MAX_CLUSTER}")
    return lanes, block_b // lanes


def _launch_int8(sgraph, synd_bl, llr0, head_iters, scale, block_b, early_stop):
    rw, m = sgraph.chk_idx.shape
    n, cw = sgraph.var_edge.shape
    B = synd_bl.shape[1]
    dev = synd_bl.device
    lanes, cluster = int8_layout(block_b, rw, m, n)
    staged = int8_staged(lanes, rw, m, n)
    err = torch.empty((n, B), dtype=torch.uint8, device=dev)
    llr = torch.empty((n, B), dtype=torch.float32, device=dev)
    conv = torch.empty((B,), dtype=torch.uint8, device=dev)
    iters = torch.empty((B,), dtype=torch.int32, device=dev)
    fn = _kernels.library("bp_int8").bp_int8_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 9 + [i] * 6 + [ctypes.c_float] + [i] * 5 + [p]
    fn.restype = ctypes.c_int
    rc = _stream_call(
        fn, dev, synd_bl.data_ptr(), llr0.data_ptr(),
        sgraph.chk_idx.data_ptr(), sgraph.mask.data_ptr(),
        sgraph.var_edge.data_ptr(), err.data_ptr(), llr.data_ptr(),
        conv.data_ptr(), iters.data_ptr(), m, n, rw, cw, B, int(head_iters),
        float(scale), int(bool(early_stop)), lanes, cluster, int(staged),
        int8_smem_bytes(lanes, rw, m, n, staged))
    _kernels.check_launch("bp_int8", rc)
    _kernels.count_launch(bp_head_int8, "launches", dev)
    _kernels.count_launch(bp_head_int8, "wide_launches", dev,
                          rw > MINSUM_NARROW_RW)
    return err, conv.to(torch.bool), llr, iters


def bp_head_int8(sgraph: SparseHeadGraph, syndromes, channel_llr, *,
                 head_iters: int, ms_scaling_factor: float = 0.625,
                 block_b: int = 256, early_stop: bool = False):
    """int8 min-sum decode of (B, m) uint8 syndromes, B a multiple of
    ``block_b``: each tile of ``block_b`` consecutive shots shares its
    message scales.  ``channel_llr`` is one (n,) float32 vector.  Returns
    batch-major ``(error (B, n) uint8, converged (B,) bool, posterior_llr
    (B, n) f32, iterations (B,) int32)``.  CUDA tensors launch kernel B6
    (or raise); CPU tensors run ``minsum_int8_plain``."""
    b = _check_head_inputs("bp_head_int8", sgraph, syndromes, channel_llr)
    if block_b < 1 or b % block_b:
        raise ValueError(f"bp_head_int8: batch {b} is not a multiple of the "
                         f"tile {block_b}")
    if head_iters < 0:
        raise ValueError(f"head_iters must be >= 0, got {head_iters}")
    synd_bl = syndromes.t().contiguous()
    if syndromes.is_cuda and not _kernels.plain_forced():
        err, conv, llr, iters = _launch_int8(
            sgraph, synd_bl, channel_llr.contiguous(), head_iters,
            ms_scaling_factor, block_b, early_stop)
    else:
        err, conv, llr, iters = minsum_int8_plain(
            sgraph, synd_bl, channel_llr, head_iters=head_iters,
            scale=float(ms_scaling_factor), block_b=block_b,
            early_stop=early_stop)
    return err.t(), conv, llr.t(), iters


bp_head_int8.launches = 0
bp_head_int8.wide_launches = 0

def _launch_bf16(head, synd, llr0, head_iters, scale):
    dev = synd.device
    if head.rw > MINSUM_MAX_RW:
        raise ValueError(f"bp_head_bf16: row weight {head.rw} above "
                         f"{MINSUM_MAX_RW}")
    for t in (head.chk_idx, head.mask, head.var_edge):
        if not t.is_contiguous():
            raise ValueError("bp_head_bf16 needs contiguous index planes")
    out, memory = _minsum_call(
        "bp_minsum_bf16", _kernels.library("bp_minsum").bp_minsum_bf16_launch,
        dev, synd, lambda planes: [synd.data_ptr(), llr0.data_ptr(),
                                   planes.chk.data_ptr(),
                                   planes.edge.data_ptr(),
                                   planes.slot.data_ptr()],
        head, True, False, head_iters, scale)
    _kernels.count_launch(bp_head_bf16, "launches", dev)
    _kernels.count_launch(bp_head_bf16, "device_launches", dev,
                          memory == "device")
    _kernels.count_launch(bp_head_bf16, "device_planes_launches", dev,
                          memory == "device_planes")
    _kernels.count_launch(bp_head_bf16, "checks_launches", dev,
                          memory == "checks")
    _kernels.count_launch(bp_head_bf16, "wide_launches", dev,
                          minsum_wide(head.rw))
    _kernels.declare_cost(*minsum_cost(head.m, head.n, head.rw,
                                       head.var_edge.shape[-1],
                                       synd.shape[0],
                                       synd.shape[0] * int(head_iters)))
    return out


def bp_head_bf16(head, syndromes, channel_llr, *, head_iters: int,
                 ms_scaling_factor: float = 0.625, early_stop: bool = False):
    """bf16 min-sum decode of (B, m) uint8 syndromes (any B) over a
    SparseHeadGraph or a PallasHeadGraph: the same outputs as
    ``bp_head_int8``.  Shots are independent, so no tile enters.  CUDA
    tensors launch the bf16 head kernel (or raise; the counters as
    ``bp_minsum``'s); CPU tensors run ``minsum_dense_plain``."""
    _check_head_inputs("bp_head_bf16", head, syndromes, channel_llr)
    if head_iters < 0:
        raise ValueError(f"head_iters must be >= 0, got {head_iters}")
    if syndromes.is_cuda and not _kernels.plain_forced():
        # the kernel leaves each shot at its convergence, which is
        # early_stop's result too: outputs freeze at convergence
        return _launch_bf16(head, syndromes.contiguous(),
                            channel_llr.contiguous(), head_iters,
                            ms_scaling_factor)
    err, conv, llr, iters = minsum_dense_plain(
        head, syndromes.t().contiguous(), channel_llr, head_iters=head_iters,
        scale=float(ms_scaling_factor), early_stop=early_stop)
    return err.t(), conv, llr.t(), iters


bp_head_bf16.launches = 0
bp_head_bf16.device_launches = 0
bp_head_bf16.device_planes_launches = 0
bp_head_bf16.checks_launches = 0
bp_head_bf16.wide_launches = 0

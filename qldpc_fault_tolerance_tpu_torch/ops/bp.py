"""Batched belief-propagation decoding in PyTorch.

Scaled min-sum and product-sum BP over a sparse parity-check matrix,
syndrome-conditioned, returning a hard-decision error estimate, convergence
flags, posterior LLRs (the soft input OSD needs) and iteration counts.

  * The Tanner graph is compiled once per H into padded adjacency tensors
    (check->variable and variable->check index maps with cross slot maps).
  * The plain versions run batch-last ((m, rw, B) / (n, cw, B) / (n, B));
    the min-sum kernels (``ops/bp_kernel.py``) take one shot per row.
  * Each shot's outputs freeze at its first convergence, so results are
    independent of the batch a shot rides in and of when the loop stops.
  * Messages are float32.

Every float32 min-sum decode goes through ``bp_kernel.bp_minsum``: the CUDA
kernel on the card, its plain version on the CPU.  The two-phase decode runs
its head and tail in a BP head kernel (int8 or bf16) when the decoder
carries one.  Product-sum runs as plain PyTorch ops on either
device, and so does ``first_min_bp_decode`` (the restart decoder), which
the JAX package also computes outside any kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.device import device_cond, host_value, resolve_device
from . import bp_kernel

__all__ = [
    "TannerGraph",
    "build_tanner_graph",
    "build_tanner_graph_host",
    "bp_decode",
    "bp_decode_two_phase",
    "first_min_bp_decode",
    "BPResult",
    "llr_from_probs",
    "TWO_PHASE_HEAD_ITERS",
    "TWO_PHASE_TAIL_DIV",
    "TWO_PHASE_BIG_TIER_MULT",
    "TWO_PHASE_MIN_BATCH",
    "TWO_PHASE_MIN_ITER",
    "HEAD_BLOCK",
    "head_engages",
]


class TannerGraph(NamedTuple):
    """Padded adjacency of a parity-check matrix (numpy or torch leaves)."""

    chk_nbr: torch.Tensor       # (m, rw) int32: var index of each row nonzero (pad: 0)
    chk_nbr_slot: torch.Tensor  # (m, rw) int32: slot of this edge in the var's list
    var_nbr: torch.Tensor       # (n, cw) int32: check index of each col nonzero (pad: 0)
    var_nbr_slot: torch.Tensor  # (n, cw) int32: slot of this edge in the check's list
    chk_mask: torch.Tensor      # (m, rw) bool
    var_mask: torch.Tensor      # (n, cw) bool
    h_t: torch.Tensor           # (n, m) uint8 — transpose kept for host-side uses


def build_tanner_graph_host(h) -> TannerGraph:
    """Compile H (host 0/1 matrix) into padded adjacency index maps, as
    numpy arrays."""
    h = (np.asarray(h) != 0).astype(np.uint8)
    m, n = h.shape
    rows = [np.nonzero(h[i])[0] for i in range(m)]
    cols = [np.nonzero(h[:, j])[0] for j in range(n)]
    rw = max((len(r) for r in rows), default=1) or 1
    cw = max((len(c) for c in cols), default=1) or 1

    chk_nbr = np.zeros((m, rw), dtype=np.int32)
    chk_mask = np.zeros((m, rw), dtype=bool)
    var_nbr = np.zeros((n, cw), dtype=np.int32)
    var_mask = np.zeros((n, cw), dtype=bool)
    chk_nbr_slot = np.zeros((m, rw), dtype=np.int32)
    var_nbr_slot = np.zeros((n, cw), dtype=np.int32)

    var_fill = [0] * n
    for i, r in enumerate(rows):
        for s, j in enumerate(r):
            chk_nbr[i, s] = j
            chk_mask[i, s] = True
            t = var_fill[j]
            var_nbr[j, t] = i
            var_mask[j, t] = True
            chk_nbr_slot[i, s] = t      # where this edge sits in var j's list
            var_nbr_slot[j, t] = s      # where this edge sits in check i's list
            var_fill[j] += 1

    return TannerGraph(
        chk_nbr=chk_nbr,
        chk_nbr_slot=chk_nbr_slot,
        var_nbr=var_nbr,
        var_nbr_slot=var_nbr_slot,
        chk_mask=chk_mask,
        var_mask=var_mask,
        h_t=np.ascontiguousarray(h.T),
    )


def build_tanner_graph(h, device="cuda") -> TannerGraph:
    """``build_tanner_graph_host`` uploaded to ``device``."""
    dev = resolve_device(device)
    return graph_to(build_tanner_graph_host(h), dev)


def graph_to(graph: TannerGraph, device) -> TannerGraph:
    """A TannerGraph with every field a contiguous tensor on ``device``."""
    return TannerGraph(*(torch.as_tensor(np.array(f) if isinstance(f, np.ndarray) else f)
                         .to(device).contiguous() for f in graph))


class BPResult(NamedTuple):
    error: torch.Tensor          # (B, n) uint8 hard-decision error estimate
    converged: torch.Tensor      # (B,) bool — syndrome matched within max_iter
    posterior_llr: torch.Tensor  # (B, n) float32 posterior LLRs at the stopping iteration
    iterations: torch.Tensor     # (B,) int32 — iteration at which each shot converged


def llr_from_probs(channel_probs, device="cuda") -> torch.Tensor:
    """Channel log-likelihood ratios log((1-p)/p), clipped away from p=0,
    computed in numpy float32 and uploaded once."""
    p = np.clip(np.asarray(channel_probs, dtype=np.float32), 1e-12, 1.0 - 1e-7)
    return torch.from_numpy(np.log1p(-p) - np.log(p)).to(resolve_device(device))


def _check_update_prodsum(v2c, synd_sign, graph):
    """Product-sum (tanh rule) update in a numerically-guarded form."""
    mask = graph.chk_mask[..., None]
    t = torch.where(mask, torch.tanh(torch.clamp(v2c, -30.0, 30.0) / 2.0), 1.0)
    t = torch.where(t.abs() < 1e-12, torch.where(t < 0, -1e-12, 1e-12), t)
    total = torch.prod(t, dim=1, keepdim=True) * synd_sign[:, None, :]
    excl = torch.clamp(total / t, -0.9999999, 0.9999999)
    return torch.where(mask, 2.0 * torch.atanh(excl), 0.0)


def _inputs(graph, syndromes, channel_llr, device):
    dev = resolve_device(device)
    graph = graph_to(graph, dev)
    synd = torch.as_tensor(syndromes).to(dev, torch.uint8)
    if synd.dim() == 1:
        synd = synd[None]
    llr = torch.as_tensor(channel_llr).to(dev, torch.float32)
    return graph, synd, llr


def bp_decode(graph: TannerGraph, syndromes, channel_llr, *, max_iter: int,
              method: str = "minimum_sum", ms_scaling_factor=0.625,
              sectors: tuple | None = None, device="cuda") -> BPResult:
    """Decode a batch of syndromes against one Tanner graph.

    syndromes: (B, m) {0,1}; channel_llr: (n,) or (B, n) float32.  The
    public interface is batch-major; internally everything runs
    batch-last.

    ``sectors=((m0, m1, ...), (n0, n1, ...))`` marks the graph as a block
    diagonal of independent sub-decodes (check and variable counts per
    block, in order), as in the JAX package: each sector's outputs freeze
    at that sector's first converged iteration, so the results equal
    separate decodes of the blocks; ``converged`` / ``iterations`` are the
    AND / max across sectors.  Min-sum runs kernel 1's sector mode on the
    card (``bp_kernel.bp_minsum``)."""
    graph, synd, llr = _inputs(graph, syndromes, channel_llr, device)
    return _decode(graph, synd, llr, max_iter, method, ms_scaling_factor,
                   sectors)


def _decode(graph, synd, llr, max_iter, method, ms_scaling_factor,
            sectors=None) -> BPResult:
    if method == "minimum_sum":
        return BPResult(*bp_kernel.bp_minsum(
            graph, synd, llr, max_iter=max_iter,
            ms_scaling_factor=ms_scaling_factor, sectors=sectors))
    if method != "product_sum":
        raise ValueError(f"unknown BP method {method!r}")
    llr0_bl = llr.t() if llr.dim() == 2 else llr[:, None]
    err, done, post, iters = bp_kernel.bp_loop(
        graph, synd.t(), llr0_bl, max_iter, _check_update_prodsum,
        sectors=sectors)
    return BPResult(err.t(), done, post.t(), iters)


# two-phase defaults (same values as the JAX package)
TWO_PHASE_HEAD_ITERS = 3
TWO_PHASE_TAIL_DIV = 16           # tail_capacity default = b // 16
TWO_PHASE_BIG_TIER_MULT = 4       # big tier = 4 * tail_capacity
# engagement gate used by decoders/bp_decoders.py: two-phase only pays off
# with enough shots to compact and enough iterations to skip
TWO_PHASE_MIN_BATCH = 64
TWO_PHASE_MIN_ITER = 9


def two_phase_head2_iters(head_iters: int, max_iter: int) -> int:
    """Deepened-head depth used by the progressive branch."""
    return min(max(4 * head_iters, 12), max_iter - 1)


# the head's batch tile (the JAX package's pallas_block default)
HEAD_BLOCK = 256


def head_engages(head, b: int, method: str, llr) -> bool:
    """The JAX package's gate for running a decode's head and tail in the
    BP head kernel: a head, min-sum, the batch a multiple of 256, one
    channel-LLR vector shared by the shots, and a feasible tile."""
    return (head is not None and method == "minimum_sum"
            and b % HEAD_BLOCK == 0 and llr.dim() == 1
            and head.max_block_b(b, want=HEAD_BLOCK) > 0)


def _run_head(head, synd, llr, iters, msf, block, quantize, early_stop=False):
    """One decode through the head kernel, as the JAX package routes it:
    int8 min-sum (tile ``block``) for a SparseHeadGraph with
    ``quantize="int8"``, else the bf16 head (a v1 head ignores
    ``quantize``)."""
    if isinstance(head, bp_kernel.SparseHeadGraph) and quantize == "int8":
        return BPResult(*bp_kernel.bp_head_int8(
            head, synd, llr, head_iters=iters, ms_scaling_factor=msf,
            block_b=block, early_stop=early_stop))
    return BPResult(*bp_kernel.bp_head_bf16(
        head, synd, llr, head_iters=iters, ms_scaling_factor=msf,
        early_stop=early_stop))


def bp_decode_two_phase(graph: TannerGraph, syndromes, channel_llr, *,
                        max_iter: int, method: str = "minimum_sum",
                        ms_scaling_factor=0.625,
                        head_iters: int = TWO_PHASE_HEAD_ITERS,
                        tail_capacity: int | None = None,
                        head=None, quantize: str | None = None,
                        sectors: tuple | None = None,
                        device="cuda") -> BPResult:
    """Straggler-compacted BP: run ``head_iters`` for the whole batch, then
    decode only the unconverged shots (gathered into a fixed-capacity
    sub-batch) for the full ``max_iter``.

    Identical to ``bp_decode`` for every shot: converged head shots freeze
    at their convergence iteration, and the tail redecodes stragglers from
    scratch — BP is deterministic, so iterations 1..head replay identically
    before continuing.  The tiers are (tail_capacity, 4x, progressive
    deepened head, full batch).  Without a head results never depend on
    the tier taken; with one, the tier decides which kernel decodes a
    straggler (below).

    ``head`` (a ``bp_kernel.SparseHeadGraph``, int8 with
    ``quantize="int8"``, else bf16; or a ``bp_kernel.PallasHeadGraph``, bf16)
    runs the head and the compacted tail in that head's kernel where the
    JAX package does (``head_engages``; the tail when its capacity has a
    tile, with early exit), at the JAX package's tiles.  Their results then
    follow that head's numerics, and int8 results depend on the tile.
    Everything else (no head, a failed gate, head_iters >= max_iter, a
    tail tier with no tile, the full-batch decode) is float32 min-sum,
    so with a head the batch's straggler count can change a straggler's
    result.

    ``sectors`` (``bp_decode``) decodes a block-diagonal graph per sector,
    in every tier; the head is refused under sectors, as in the JAX
    package, so a sector decode is float32 min-sum throughout and equals
    ``bp_decode(sectors=)``.

    The tier ladder is a nest of ``device_cond``s, shaped like the JAX
    package's ``lax.cond``s: during a CUDA-graph capture it is conditional
    nodes and reads nothing on the host; elsewhere each decode reads the
    straggler count once (twice when the deepened head runs), counted in
    ``bp_decode_two_phase.host_reads``."""
    if quantize not in (None, "int8"):
        raise ValueError(f"unknown quantize mode {quantize!r}")
    graph, synd, llr = _inputs(graph, syndromes, channel_llr, device)
    b = synd.shape[0]
    if tail_capacity is None:
        tail_capacity = max(1, b // TWO_PHASE_TAIL_DIV)
    if head_iters >= max_iter or tail_capacity >= b:
        return _decode(graph, synd, llr, max_iter, method, ms_scaling_factor,
                       sectors)
    use_head = sectors is None and head_engages(head, b, method, llr)

    def run(iters):
        """A full-batch decode of ``iters`` iterations."""
        if use_head:
            return _run_head(head, synd, llr, iters, ms_scaling_factor,
                             head.max_block_b(b, want=HEAD_BLOCK), quantize)
        return _decode(graph, synd, llr, iters, method, ms_scaling_factor,
                       sectors)

    def full():
        return _decode(graph, synd, llr, max_iter, method, ms_scaling_factor,
                       sectors)

    def compacted(capacity, head_res):
        # pad the gather with an out-of-range sentinel (b): padded rows read
        # a zero scratch syndrome (row b of the extended arrays) and their
        # results land in a scratch row sliced off below; in the head's
        # kernel they take part in their tile's int8 scales, as in JAX
        idx = torch.nonzero_static(~head_res.converged, size=capacity,
                                   fill_value=b).flatten()
        synd_ext = torch.cat([synd, synd.new_zeros((1, synd.shape[1]))])
        if use_head and head.max_block_b(capacity) > 0:
            tail = _run_head(head, synd_ext[idx], llr, max_iter,
                             ms_scaling_factor, head.max_block_b(capacity),
                             quantize, early_stop=True)
        else:
            llr_c = llr
            if llr.dim() == 2:
                llr_c = torch.cat([llr, llr[:1]])[idx]
            tail = _decode(graph, synd_ext[idx], llr_c, max_iter, method,
                           ms_scaling_factor, sectors)

        def merge(head_arr, tail_arr):
            ext = torch.cat([head_arr, head_arr.new_zeros((1,) + head_arr.shape[1:])])
            ext[idx] = tail_arr
            return ext[:b]

        return BPResult(*(merge(h, t) for h, t in zip(head_res, tail)))

    def stragglers(res):
        return host_value((~res.converged).sum(dtype=torch.int32),
                          bp_decode_two_phase)

    tiers = [tail_capacity]
    if tail_capacity * TWO_PHASE_BIG_TIER_MULT < b:
        tiers.append(tail_capacity * TWO_PHASE_BIG_TIER_MULT)

    # progressive head deepening: when even the largest tier overflows, a
    # deeper full-batch head runs before conceding to the full decode
    head2_iters = two_phase_head2_iters(head_iters, max_iter)

    def deepen():
        head2 = run(head2_iters)
        return device_cond(stragglers(head2) <= tiers[-1],
                           lambda: compacted(tiers[-1], head2), full)

    head_res = run(head_iters)
    n_bad = stragglers(head_res)
    out = deepen if head2_iters > head_iters else full
    for cap in reversed(tiers):
        out = (lambda cap, nxt: lambda: device_cond(
            n_bad <= cap, lambda: compacted(cap, head_res), nxt))(cap, out)
    return out()


bp_decode_two_phase.host_reads = 0


def first_min_bp_decode(graph: TannerGraph, syndromes, channel_llr, *,
                        max_restarts: int, ms_scaling_factor=0.9,
                        device="cuda"):
    """Sequential-restart one-iteration BP (reference FirstMinBPDecoder,
    ``src/Decoders.py:49-74``; the JAX package's ``first_min_bp_decode``):
    ``max_restarts`` times, one min-sum iteration from fresh messages on
    the current syndrome; a shot accepts the hard decision into its
    correction while the syndrome weight does not grow, and stops at its
    first refusal.  A fixed loop with a per-shot active mask: no host read.

    Batch-last like ``bp_decode``; the check update is ``bp_loop``'s and
    the totals add each variable's terms in list order.  Returns
    ``(correction (B, n) uint8, final syndrome weight (B,) int32)``."""
    graph, synd, llr = _inputs(graph, syndromes, channel_llr, device)
    b = synd.shape[0]
    n, cw = graph.var_nbr.shape
    llr0_bl = llr.expand(b, n).t()                             # (n, B)
    scale = float(ms_scaling_factor)
    chk_nbr = graph.chk_nbr.long()
    var_nbr = graph.var_nbr.long()
    var_slot = graph.var_nbr_slot.long()
    var_mask = graph.var_mask[..., None]
    v2c0 = llr0_bl[chk_nbr]                                    # (m, rw, B)
    cur = synd.t().contiguous()                                # (m, B)
    corr = torch.zeros((n, b), dtype=torch.uint8, device=synd.device)
    active = torch.ones(b, dtype=torch.bool, device=synd.device)
    weight = cur.sum(dim=0, dtype=torch.int32)
    for _ in range(int(max_restarts)):
        c2v = bp_kernel.check_update_minsum(
            v2c0, 1.0 - 2.0 * cur.to(torch.float32), graph, scale)
        c2v_var = torch.where(var_mask, c2v[var_nbr, var_slot], 0.0)
        acc = c2v_var[:, 0]
        for t in range(1, cw):
            acc = acc + c2v_var[:, t]
        err = ((llr0_bl + acc) < 0).to(torch.uint8)             # (n, B)
        new = bp_kernel._edge_parity(err, graph) ^ cur
        new_weight = new.sum(dim=0, dtype=torch.int32)
        active = active & (new_weight <= weight)
        corr = torch.where(active[None, :], corr ^ err, corr)
        cur = torch.where(active[None, :], new, cur)
        weight = torch.where(active, new_weight, weight)
    return corr.t(), weight


class _LruCache:
    """Tiny bounded, thread-safe memo with per-key single-flight builds:
    the serve stack's session cache and the in-process graph cache
    (``utils/progcache.py``) are hit from concurrent request paths, where
    an unguarded ``OrderedDict`` mutation can corrupt the map or build the
    same key twice.  Concurrent first requests for ONE key build it
    exactly once (losers wait on the building thread); builds for DIFFERENT keys
    overlap — the map lock is never held across ``make()``, so a
    multi-code service cold start doesn't serialize seconds-long graph
    builds behind each other.  ``make()`` must not recursively request
    its own key (builds may consult OTHER caches freely)."""

    def __init__(self, maxsize: int = 128):
        import threading
        from collections import OrderedDict

        self._d = OrderedDict()
        self._lock = threading.Lock()
        self._building: dict = {}  # key -> Event set when the build lands
        self._gen = 0  # bumped by clear(); stale in-flight builds don't cache
        self.maxsize = maxsize
        # optional (key, value) callback on LRU eviction — the serve-layer
        # SessionCache counts/announces evicted sessions through it
        self.on_evict = None

    def get(self, key, make):
        import threading

        while True:
            with self._lock:
                try:
                    self._d.move_to_end(key)
                    return self._d[key]
                except KeyError:
                    pass
                waiter = self._building.get(key)
                if waiter is None:
                    waiter = self._building[key] = threading.Event()
                    gen = self._gen
                    break  # this thread builds
            # another thread is building this key: wait, then re-check (a
            # failed build leaves the map empty and the loop retries here)
            waiter.wait()
        try:
            val = make()
        except BaseException:
            with self._lock:
                self._building.pop(key, None)
            waiter.set()
            raise
        evicted = None
        with self._lock:
            # a clear() (reset_device_state) that landed mid-build
            # invalidates this value: hand it to THIS caller (whose
            # enclosing retry re-resolves anyway) but never cache it
            if self._gen == gen:
                self._d[key] = val
                self._d.move_to_end(key)
                if len(self._d) > self.maxsize:
                    evicted = self._d.popitem(last=False)
            self._building.pop(key, None)
        waiter.set()
        # the hook runs OUTSIDE the lock (the map lock is never held
        # across user code): hook I/O must not stall concurrent lookups,
        # and a hook touching this cache must not deadlock
        if evicted is not None and self.on_evict is not None:
            try:
                self.on_evict(*evicted)
            except Exception:  # a hook must not poison the memo
                pass
        return val

    def peek(self, key):
        """Existing entry (LRU-touched), or KeyError — never builds."""
        with self._lock:
            self._d.move_to_end(key)
            return self._d[key]

    def keys(self):
        with self._lock:
            return list(self._d)

    def __len__(self):
        with self._lock:
            return len(self._d)

    def __contains__(self, key):
        with self._lock:
            return key in self._d

    def pop(self, key) -> bool:
        """Drop one entry (no-op when absent).  An in-flight build of the
        same key still lands afterwards — callers evicting for STALENESS
        (not device death) must also bump whatever keyed the build."""
        with self._lock:
            return self._d.pop(key, None) is not None

    def clear(self):
        with self._lock:
            self._d.clear()
            self._gen += 1

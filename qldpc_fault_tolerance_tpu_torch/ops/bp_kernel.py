"""Min-sum BP kernel wrapper (``csrc/bp_minsum.cu``) and its plain version.

``bp_minsum`` decodes a (B, m) syndrome batch against one Tanner graph with
scaled min-sum and per-shot freeze at first convergence — ``ops/bp.py``
``bp_decode(method="minimum_sum")``.  On CUDA tensors it launches the Hopper
kernel that replaces the TPU kernel ``_sparse_head_kernel``
(``qldpc_fault_tolerance_tpu/ops/bp_pallas.py:740``); on CPU tensors it runs
``minsum_plain``, the same arithmetic as PyTorch ops.  Every min-sum decode
of the port goes through this wrapper: the two-phase head, its compacted
tail and the full-batch decode.

The plain version mirrors the kernel operation for operation (streaming
top-2 over check slots, variable totals summed in slot order), so kernel and
plain version agree bit for bit on the card; the kernel is built with FMA
contraction off for that reason.  Messages are float32, the f32 reference
numerics of ``ops/bp.py``; the TPU kernel stores bf16 only because VMEM and
the MXU favour it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _kernels

__all__ = ["BIG", "bp_minsum", "minsum_plain", "bp_loop",
           "check_update_minsum"]

BIG = 1e30  # stands in for +inf without producing NaN in exclusion arithmetic


def check_update_minsum(v2c, synd_sign, graph, scale):
    """Scaled min-sum check update with self-exclusion via a streaming top-2
    over the check's slots — the kernel's check pass.

    v2c: (m, rw, B); synd_sign: (m, B) of +-1.  Returns c2v (m, rw, B)."""
    m, rw, _ = v2c.shape
    mask = graph.chk_mask
    big = torch.tensor(BIG, dtype=torch.float32, device=v2c.device)
    scale_t = torch.tensor(scale, dtype=torch.float32, device=v2c.device)
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


def bp_loop(graph, synd_bl, llr0_bl, max_iter: int, check_update):
    """Plain batch-last BP iteration loop shared by min-sum and product-sum.

    synd_bl: (m, B) uint8; llr0_bl: (n, B) or (n, 1) float32.  Returns
    ``(err (n, B) uint8, done (B,) bool, llr (n, B) f32, iters (B,) i32)``
    frozen at each shot's first convergence.  Messages of converged shots
    keep updating; their values never reach an output."""
    n, cw = graph.var_nbr.shape
    B = synd_bl.shape[1]
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
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.full((B,), max_iter, dtype=torch.int32, device=dev)
    for it in range(max_iter):
        if bool(done.all()):
            break
        c2v = check_update(v2c, synd_sign, graph)              # (m, rw, B)
        c2v_var = torch.where(var_mask, c2v[var_nbr, var_slot], 0.0)
        acc = c2v_var[:, 0]
        for t in range(1, cw):
            acc = acc + c2v_var[:, t]
        total = llr0_bl + acc                                  # (n, B)
        v2c = (total[:, None, :] - c2v_var)[chk_nbr, chk_slot]
        err_new = (total < 0).to(torch.uint8)
        match = (_edge_parity(err_new, graph) == synd_bl).all(dim=0)
        keep = done[None, :]
        err = torch.where(keep, err, err_new)
        llr = torch.where(keep, llr, total)
        iters = torch.where(match & ~done, it + 1, iters).to(torch.int32)
        done = done | match
    return err, done, llr, iters


def minsum_plain(graph, synd_bl, llr0_bl, max_iter: int, scale: float):
    """Plain PyTorch version of the min-sum kernel (same outputs, batch-last)."""
    return bp_loop(graph, synd_bl, llr0_bl, max_iter,
                   functools.partial(check_update_minsum, scale=float(scale)))


def _argtypes():
    p, i = ctypes.c_void_p, ctypes.c_int
    return [p, p, i, p, p, p, p, p, p, p, p, p,
            i, i, i, i, i, i, ctypes.c_float, i, i, p]


# shared memory a block may take on Hopper (227 KB)
SMEM_LIMIT = 232448
MAX_LANES = 8  # shots per block


def block_lanes(m: int, rw: int, n: int) -> int:
    """Shots per block of the kernel: 8, halved until the block's messages
    (two f32 planes of m*rw edges) and hard decisions fit in shared
    memory; 0 when not even one shot fits."""
    lanes = MAX_LANES
    while lanes and lanes * (8 * m * rw + n) > SMEM_LIMIT:
        lanes //= 2
    return lanes


def _launch(graph, synd_bl, llr0, llr_per_shot, max_iter, scale):
    m, rw = graph.chk_nbr.shape
    n, cw = graph.var_nbr.shape
    B = synd_bl.shape[1]
    dev = synd_bl.device
    if synd_bl.dtype != torch.uint8 or synd_bl.shape[0] != m:
        raise ValueError(f"syndromes must be uint8 with {m} checks")
    want = (n, B) if llr_per_shot else (n,)
    if llr0.dtype != torch.float32 or tuple(llr0.shape) != want:
        raise ValueError(f"channel LLRs must be float32 of shape {want}")
    if max_iter < 0:
        raise ValueError(f"max_iter must be >= 0, got {max_iter}")
    tensors = (synd_bl, llr0, graph.chk_nbr, graph.chk_mask, graph.var_nbr,
               graph.var_nbr_slot, graph.var_mask)
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("bp_minsum needs contiguous tensors on one device")
    if not 1 <= rw <= 32 or cw < 1:
        raise ValueError(f"bp_minsum takes row weights 1..32, got rw={rw}")
    if m * B >= 2 ** 31 or n * B >= 2 ** 31:
        raise ValueError("bp_minsum batch too large for int32 indexing")
    lanes = block_lanes(m, rw, n)
    if not lanes:
        raise ValueError(f"bp_minsum: one shot's messages ({8 * m * rw + n} "
                         f"bytes) exceed {SMEM_LIMIT} bytes of shared memory")
    err = torch.empty((n, B), dtype=torch.uint8, device=dev)
    llr = torch.empty((n, B), dtype=torch.float32, device=dev)
    conv = torch.empty((B,), dtype=torch.uint8, device=dev)
    iters = torch.empty((B,), dtype=torch.int32, device=dev)
    fn = _kernels.library("bp_minsum").bp_minsum_launch
    fn.argtypes = _argtypes()
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(synd_bl.data_ptr(), llr0.data_ptr(), int(llr_per_shot),
                graph.chk_nbr.data_ptr(), graph.chk_mask.data_ptr(),
                graph.var_nbr.data_ptr(), graph.var_nbr_slot.data_ptr(),
                graph.var_mask.data_ptr(), err.data_ptr(), llr.data_ptr(),
                conv.data_ptr(), iters.data_ptr(), m, n, rw, cw, B,
                int(max_iter), float(scale), lanes,
                lanes * (8 * m * rw + n), stream)
    _kernels.check_launch("bp_minsum", rc)
    bp_minsum.launches += 1
    return err, conv.to(torch.bool), llr, iters


def bp_minsum(graph, syndromes, channel_llr, *, max_iter: int,
              ms_scaling_factor: float = 0.625):
    """Min-sum decode of (B, m) uint8 syndromes; ``channel_llr`` is (n,) or
    (B, n) float32 on the same device.  Returns batch-major
    ``(error (B, n) uint8, converged (B,) bool, posterior_llr (B, n) f32,
    iterations (B,) int32)``.  CUDA tensors launch the kernel (or raise);
    CPU tensors run ``minsum_plain``."""
    synd_bl = syndromes.t().contiguous()
    per_shot = channel_llr.dim() == 2
    if syndromes.is_cuda and not _kernels.plain_forced():
        llr0 = channel_llr.t().contiguous() if per_shot else channel_llr.contiguous()
        err, conv, llr, iters = _launch(graph, synd_bl, llr0, per_shot,
                                        max_iter, ms_scaling_factor)
    else:
        llr0_bl = channel_llr.t() if per_shot else channel_llr[:, None]
        err, conv, llr, iters = minsum_plain(graph, synd_bl, llr0_bl,
                                             max_iter, ms_scaling_factor)
    return err.t(), conv, llr.t(), iters


bp_minsum.launches = 0

"""Bit-packed GF(2) execution layer: 32 shots per int32 lane word.

Every {0,1} bitplane of the code-capacity pipeline (errors, syndromes,
corrections, residuals, failure flags) packs 32 Monte-Carlo shots per word:
a (B, n) uint8 plane becomes (W, n) int32 with W = ceil(B/32), and shot
``32*w + j`` is bit ``j`` (LSB-first) of ``packed[w, :]``.  The words carry
the same bit patterns as the JAX package's uint32 words.  Packing along the
shot axis turns the mod-2 accumulation of every GF(2) product into bitwise
XOR across lane words; ``popcount`` (SWAR, as torch has none) reads counts
out, masked by ``lane_mask`` so ragged batches count exactly their shots.

PyTorch's ``>>`` on int32 is an arithmetic shift: every multi-bit use of a
right shift here is masked afterwards.
"""
from __future__ import annotations

import torch

from ..utils.device import resolve_device

__all__ = [
    "LANE",
    "num_words",
    "lane_mask",
    "pack_shots",
    "unpack_shots",
    "xor_reduce",
    "or_reduce",
    "popcount",
    "packed_parity_apply",
    "packed_gf2_matmul",
    "packed_any",
    "packed_count",
    "packed_per_shot_weight",
    "packed_residual_stats",
    "packed_residual_flags",
]

LANE = 32  # shots per int32 lane word


def num_words(batch_size: int) -> int:
    """Packed words needed for ``batch_size`` shots."""
    return -(-int(batch_size) // LANE)


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 tensors with the same 32 bits."""
    return (x - ((x >> 31) & 1) * (1 << 32)).to(torch.int32)


def lane_mask(batch_size: int, device="cuda") -> torch.Tensor:
    """(W,) int32 mask of valid shot bits; ragged tails mask the padding.
    Built on ``device`` (no host-to-device copy)."""
    device = resolve_device(device)
    w = num_words(batch_size)
    valid = torch.arange(w * LANE, device=device) < batch_size
    words = valid.reshape(w, LANE).to(torch.int64) << torch.arange(LANE, device=device)
    return to_int32(words.sum(dim=1))


def _shifts(ndim: int, device) -> torch.Tensor:
    return torch.arange(LANE, device=device).reshape((1, LANE) + (1,) * ndim)


def pack_shots(bits) -> torch.Tensor:
    """Pack a (B, ...) {0,1} plane into (ceil(B/32), ...) int32 lane words;
    a ragged tail pads with zero bits."""
    bits = torch.as_tensor(bits)
    b = bits.shape[0]
    w = num_words(b)
    pad = w * LANE - b
    if pad:
        bits = torch.cat([bits, bits.new_zeros((pad,) + bits.shape[1:])])
    x = bits.reshape((w, LANE) + bits.shape[1:]).to(torch.int64)
    return to_int32((x << _shifts(bits.dim() - 1, bits.device)).sum(dim=1))


def unpack_shots(packed, batch_size: int) -> torch.Tensor:
    """Inverse of ``pack_shots``: (W, ...) int32 -> (batch_size, ...) uint8."""
    packed = torch.as_tensor(packed)
    w = packed.shape[0]
    bits = (packed[:, None] >> _shifts(packed.dim() - 1, packed.device)) & 1
    out = bits.reshape((w * LANE,) + packed.shape[1:]).to(torch.uint8)
    return out[:batch_size]


def _halving_reduce(x: torch.Tensor, dim: int, op) -> torch.Tensor:
    """Reduce ``dim`` with a bitwise ``op`` whose identity is 0, by pairwise
    halving (torch has no bitwise reductions)."""
    x = x.movedim(dim, 0)
    if x.shape[0] == 0:
        return torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    while x.shape[0] > 1:
        if x.shape[0] % 2:
            x = torch.cat([x, torch.zeros_like(x[:1])])
        x = op(x[0::2], x[1::2])
    return x[0]


def xor_reduce(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Bitwise-XOR reduction along ``dim`` (the packed mod-2 accumulator)."""
    return _halving_reduce(x, dim, torch.bitwise_xor)


def or_reduce(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Bitwise-OR reduction along ``dim`` (packed ``any`` over a plane
    axis)."""
    return _halving_reduce(x, dim, torch.bitwise_or)


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Per-word set-bit count of int32 words (SWAR), int32 out."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x & 0xFF) + ((x >> 8) & 0xFF) + ((x >> 16) & 0xFF) + ((x >> 24) & 0xFF)


def packed_parity_apply(nbr, mask, packed_bits) -> torch.Tensor:
    """Packed sparse GF(2) SpMV ``x @ H.T % 2`` on lane words.

    ``nbr``/``mask`` are a ParityOp's (m, rw) padded adjacency;
    ``packed_bits`` is (W, n) int32.  Returns (W, m) int32: the XOR of the
    <= rw gathered neighbour words of each check."""
    g = packed_bits[..., nbr.long()]                        # (W, m, rw)
    g = torch.where(mask, g, torch.zeros((), dtype=g.dtype, device=g.device))
    acc = g[..., 0]
    for s in range(1, g.shape[-1]):
        acc = acc ^ g[..., s]
    return acc


def packed_gf2_matmul(packed_bits, h_t) -> torch.Tensor:
    """Packed dense GF(2) product ``x @ h_t % 2`` on lane words.

    packed_bits: (W, n) int32; h_t: (n, k) {0,1}.  Returns (W, k) int32 —
    a masked XOR-reduction over n, meant for small k (logical checks)."""
    sel = torch.where(h_t[None, :, :] != 0, packed_bits[:, :, None],
                      torch.zeros((), dtype=packed_bits.dtype,
                                  device=packed_bits.device))  # (W, n, k)
    return xor_reduce(sel, dim=1)


def packed_any(packed_words, dim: int = -1) -> torch.Tensor:
    """Per-shot OR over a plane axis: (W, m) -> (W,) flag words."""
    return or_reduce(packed_words, dim)


def packed_count(flag_words, batch_size: int) -> torch.Tensor:
    """Count set shots in (W,) flag words, masking ragged padding lanes.
    Returns an int32 device scalar (no host sync)."""
    masked = flag_words & lane_mask(batch_size, flag_words.device)
    return popcount(masked).sum(dtype=torch.int32)


def packed_per_shot_weight(packed_bits, batch_size: int) -> torch.Tensor:
    """Per-shot Hamming weight of a packed (W, n) plane -> (batch_size,) i32."""
    w = packed_bits.shape[0]
    bits = (packed_bits[:, None] >> _shifts(packed_bits.dim() - 1,
                                            packed_bits.device)) & 1
    weights = bits.sum(dim=-1, dtype=torch.int32)           # (W, 32)
    return weights.reshape(w * LANE)[:batch_size]


def _residual_flag_words(res_x, res_z, hz_par, hx_par, lz_t, lx_t):
    """Per-shot stabilizer and logical failure flag words of packed
    residuals: ``(x_stab, x_log, z_stab, z_log)``, each (W,) int32."""
    x_stab = packed_any(packed_parity_apply(hz_par[0], hz_par[1], res_x))
    x_log = packed_any(packed_gf2_matmul(res_x, lz_t))
    z_stab = packed_any(packed_parity_apply(hx_par[0], hx_par[1], res_z))
    z_log = packed_any(packed_gf2_matmul(res_z, lx_t))
    return x_stab, x_log, z_stab, z_log


def _min_weight(res_x, res_z, x_log, wz_flags, batch_size: int, n: int):
    wx = torch.where(unpack_shots(x_log, batch_size).bool(),
                     packed_per_shot_weight(res_x, batch_size), n)
    wz = torch.where(unpack_shots(wz_flags, batch_size).bool(),
                     packed_per_shot_weight(res_z, batch_size), n)
    return torch.minimum(wx.min(), wz.min()).to(torch.int32)


def packed_residual_stats(res_x, res_z, hz_par, hx_par, lz_t, lx_t,
                          eval_type: str, batch_size: int, n: int, *,
                          z_weight_excludes_stab: bool = False):
    """Residual stabilizer/logical checks on packed planes -> two scalars.

    res_x/res_z: (W, n) packed residual planes.  hz_par/hx_par: ParityOp
    ``(nbr, mask)`` pairs (hz checks res_x, hx checks res_z).  lz_t/lx_t:
    (n, k) {0,1} logical transposes.  Returns int32 device values (failure
    count of ``eval_type`` "X", "Z" or "Total", or for "ALL" the (3,)
    counts of all three, as the JAX package's fused sweep unit takes them;
    min residual weight among logical failures).  ``z_weight_excludes_stab``
    is the phenom engine's convention (the reference's if/elif): a Z
    residual's weight counts only where its stabilizer check passed."""
    x_stab, x_log, z_stab, z_log = _residual_flag_words(
        res_x, res_z, hz_par, hx_par, lz_t, lx_t)
    x_fail = x_stab | x_log
    z_fail = z_stab | z_log
    if eval_type == "X":
        cnt = packed_count(x_fail, batch_size)
    elif eval_type == "Z":
        cnt = packed_count(z_fail, batch_size)
    elif eval_type == "ALL":
        cnt = torch.stack([packed_count(f, batch_size)
                           for f in (x_fail, z_fail, x_fail | z_fail)])
    else:
        cnt = packed_count(x_fail | z_fail, batch_size)
    wz_flags = z_log & ~z_stab if z_weight_excludes_stab else z_log
    return cnt, _min_weight(res_x, res_z, x_log, wz_flags, batch_size, n)


def packed_residual_flags(res_x, res_z, hz_par, hx_par, lz_t, lx_t,
                          batch_size: int, n: int, *,
                          z_weight_excludes_stab: bool = False):
    """Per-SHOT residual failure flags from packed planes: ``(x_fail,
    z_fail, min_w)``, the flags (batch_size,) uint8, the unit the weighted
    pipelines multiply by per-shot weights (the JAX package's function of
    that name).  The flag words of ``packed_residual_stats``, so the flags'
    sums equal its counts."""
    x_stab, x_log, z_stab, z_log = _residual_flag_words(
        res_x, res_z, hz_par, hx_par, lz_t, lx_t)
    wz_flags = z_log & ~z_stab if z_weight_excludes_stab else z_log
    return (unpack_shots(x_stab | x_log, batch_size),
            unpack_shots(z_stab | z_log, batch_size),
            _min_weight(res_x, res_z, x_log, wz_flags, batch_size, n))

"""Counter-PRNG fused code-capacity pipeline and its Hopper kernels.

The counterpart of the JAX package's ``ops/gf2_pallas.py``:

  * ``counter_draws``: Threefry-2x32 (``ops/prng.py``, re-exported here with
    the host key stream ``prng_key``, ``split_key``, ``fold_in``).  The draw
    of shot ``s`` and qubit ``v`` is word x0 at counter ``(s, v)``; the cuts
    of ``depolarizing_cuts`` turn it into an X, Z or Y error.  Bit-exact
    with the JAX package, so the fused engines draw the same errors seed for
    seed.
  * ``sample_syndrome`` (kernel ``csrc/gf2_sample.cu``), the errors' packed
    words and both syndromes; ``residual_check_stats``
    (``csrc/gf2_residual.cu``), which regenerates the errors from their
    counters, XORs the packed corrections in and reduces the residual checks
    to (failures, min weight); ``fused_decode_stats``, the whole pipeline
    with both sectors' min-sum decodes in one kernel, in the JAX fused
    kernel's two message modes: bf16 (``csrc/fused_decode.cu``) and int8
    (``quantize="int8"``, ``csrc/fused_decode_int8.cu``, one message scale
    per tile of ``block_w * 32`` shots).  Its tile comes from the JAX
    package's rule (``fused_decode_block_w``), because int8 results depend
    on it.

A key is two 32-bit words (host ints) or a (2,) int32 tensor holding them
on the spec's device (``prng.key_tensor``): the kernels read the words from
device memory, so a captured CUDA graph draws each batch from the key it
folds on the device (``prng.fold_in_device``), and the plain versions draw
from a key tensor without a host read.

Each kernel has a plain PyTorch version beside it (``*_plain``), built from
the port's packed GF(2) ops and ``bp_kernel``'s min-sum loops.  A wrapper
runs the plain version only for tensors on the CPU (or under
``_kernels.force_plain()``); on CUDA tensors it launches its kernel or
raises.  torch has no uint32 arithmetic: the generator works on int64
values masked to 32 bits, and packed words are int32 bit patterns.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..utils.device import resolve_device
from . import _kernels
from .bp import build_tanner_graph_host
from .bp_kernel import (
    MINSUM_MAX_RW,
    MINSUM_NARROW_RW,
    SMEM_LIMIT,
    MinsumLayout,
    SparseHeadGraph,
    _align16,
    _planes_of,
    _sm_count,
    build_sparse_head,
    lane_layout,
    minsum_dense_plain,
    minsum_int8_plain,
    minsum_smem_bytes,
)
from .gf2_packed import (
    num_words,
    pack_shots,
    packed_parity_apply,
    packed_residual_stats,
    unpack_shots,
)
from .linalg import ParityOp
from .prng import (
    fold_in,
    key_parts,
    key_tensor,
    key_words,
    prng_key,
    split_key,
    threefry2x32,
)

__all__ = [
    "threefry2x32",
    "counter_draws",
    "depolarizing_cuts",
    "prng_key",
    "split_key",
    "fold_in",
    "key_words",
    "FusedSpec",
    "build_fused_spec",
    "FusedDecodeSpec",
    "build_fused_decode_spec",
    "fused_spec_from_jax",
    "sample_syndrome",
    "sample_syndrome_plain",
    "residual_check_stats",
    "residual_check_plain",
    "fused_decode_stats",
    "fused_decode_plain",
    "fused_smem_bytes",
    "fused_layout",
    "card_fused_layout",
    "estimate_fused_decode_bytes",
    "fused_decode_block_w",
    "fused_decode_feasible",
    "fused_int8_smem_bytes",
    "fused_int8_staged",
    "fused_int8_active_clusters",
]

EVAL_CODES = {"X": 0, "Z": 1, "Total": 2}


# ---------------------------------------------------------------------------
# Counter draws and the depolarizing cuts
def counter_draws(k0, k1, batch_size: int, n: int,
                  device="cuda") -> torch.Tensor:
    """(batch_size, n) int64 draws in [0, 2**32): word (b, v) is
    Threefry(key, (b, v)).x0.  The key words are ints or int64 scalars on
    ``device`` (``prng.key_parts``)."""
    device = resolve_device(device)
    c0 = torch.arange(batch_size, dtype=torch.int64, device=device)[:, None]
    c1 = torch.arange(n, dtype=torch.int64, device=device)[None, :]
    x0, _ = threefry2x32(k0, k1, c0, c1)
    return x0


def depolarizing_cuts(pauli_error_probs) -> np.ndarray:
    """[pz, pz+px, pz+px+py] as uint32 thresholds on a uniform 32-bit draw
    (a draw below the first is a Z, then X, then Y)."""
    px, py, pz = (float(p) for p in pauli_error_probs)
    edges = np.cumsum([pz, px, py])
    if edges[-1] > 1.0 + 1e-9:
        raise ValueError(f"pauli probs sum to {edges[-1]} > 1")
    return np.minimum(np.round(edges * 4294967296.0), 4294967295.0).astype(
        np.uint32)


def _errors_from_draws(r: torch.Tensor, cuts):
    """int64 draws + cuts -> (error_x, error_z) uint8 {0,1} planes."""
    cz, czx, czxy = (int(c) for c in cuts)
    is_z = r < cz
    is_x = (r >= cz) & (r < czx)
    is_y = (r >= czx) & (r < czxy)
    return (is_x | is_y).to(torch.uint8), (is_z | is_y).to(torch.uint8)


# ---------------------------------------------------------------------------
# Per-code data
class FusedSpec(NamedTuple):
    """Per-(code, channel) tensors of the fused kernels, on one device.

    The checks are padded adjacencies (``ops/linalg.py`` ParityOp: (rows,
    rw) int32 neighbours, bool mask).  ``lx_t``/``lz_t`` feed the plain
    version's logical checks (``packed_residual_stats``)."""

    cuts: tuple             # 3 ints, the uint32 depolarizing thresholds
    hx_nbr: torch.Tensor    # hx: syndrome_z = hx . e_z
    hx_mask: torch.Tensor
    hz_nbr: torch.Tensor    # hz: syndrome_x = hz . e_x
    hz_mask: torch.Tensor
    lx_nbr: torch.Tensor    # lx: Z logical check of r_z
    lx_mask: torch.Tensor
    lz_nbr: torch.Tensor    # lz: X logical check of r_x
    lz_mask: torch.Tensor
    lx_t: torch.Tensor      # (n, k) uint8
    lz_t: torch.Tensor      # (n, k) uint8

    @property
    def n(self) -> int:
        return self.lx_t.shape[0]

    @property
    def device(self) -> torch.device:
        return self.hx_nbr.device


def _gf2(h) -> np.ndarray:
    return (np.asarray(h) != 0).astype(np.uint8)


def _spec(hx, hz, lx, lz, cuts, device) -> FusedSpec:
    adj = []
    for h in (hx, hz, lx, lz):
        op = ParityOp(h, device)
        adj += [op.nbr.contiguous(), op.mask.contiguous()]
    return FusedSpec(
        tuple(int(c) for c in cuts), *adj,
        torch.from_numpy(np.ascontiguousarray(lx.T)).to(device),
        torch.from_numpy(np.ascontiguousarray(lz.T)).to(device))


def build_fused_spec(hx, hz, lx, lz, pauli_error_probs,
                     device="cuda") -> FusedSpec:
    """The fused kernels' tensors for a CSS code and a depolarizing channel
    ``[px, py, pz]``."""
    return _spec(_gf2(hx), _gf2(hz), _gf2(lx), _gf2(lz),
                 depolarizing_cuts(pauli_error_probs), resolve_device(device))


class FusedDecodeSpec(NamedTuple):
    """The fused-decode pipeline's tensors: ``base`` plus, for each sector,
    its channel LLRs ((n,) float32) and its head's index planes, which both
    message modes decode over (the bf16 mode through their 16-bit planes,
    ``bp_kernel.minsum_planes``)."""

    base: FusedSpec
    llr_z: torch.Tensor
    llr_x: torch.Tensor
    sparse_z: SparseHeadGraph   # of hx: decodes syndrome_z
    sparse_x: SparseHeadGraph   # of hz: decodes syndrome_x

    @property
    def statics(self) -> tuple:
        """``(n, mx, mz, rwz, rwx)``, the JAX spec's ``_decode_statics``."""
        z, x = self.sparse_z, self.sparse_x
        return self.base.n, z.m, x.m, z.rw, x.rw


def _sector_head(h, dev):
    return build_sparse_head(build_tanner_graph_host(h), dev)


def build_fused_decode_spec(hx, hz, lx, lz, pauli_error_probs, llr_x, llr_z,
                            device="cuda") -> FusedDecodeSpec:
    """``build_fused_spec`` plus both sectors' graphs (of hx and hz) and the
    decoders' channel LLRs (``BPDecoder.llr0``)."""
    base = build_fused_spec(hx, hz, lx, lz, pauli_error_probs, device)
    dev = base.device

    def llr(v):
        if isinstance(v, torch.Tensor):
            v = v.cpu().numpy()
        return torch.from_numpy(np.array(v, np.float32).reshape(-1)).to(dev)

    return FusedDecodeSpec(base, llr(llr_z), llr(llr_x),
                           _sector_head(_gf2(hx), dev),
                           _sector_head(_gf2(hz), dev))


def fused_spec_from_jax(jspec, device="cuda"):
    """The port's ``FusedSpec`` / ``FusedDecodeSpec`` from a JAX package
    ``FusedSpec`` / ``FusedDecodeSpec`` whose leaves are numpy arrays.

    The matrices come from the JAX spec's dense transposes; the JAX
    adjacencies must equal the port's rebuilt ones, or this raises."""
    if hasattr(jspec, "base"):
        base = fused_spec_from_jax(jspec.base, device)
        hx = _gf2(np.asarray(jspec.base.hx_t).T)
        hz = _gf2(np.asarray(jspec.base.hz_t).T)
        sectors = []
        for h, idx, mask in ((hx, jspec.zg_idx, jspec.zg_mask),
                             (hz, jspec.xg_idx, jspec.xg_mask)):
            g = build_tanner_graph_host(h)
            if not (np.array_equal(g.chk_nbr.T, np.asarray(idx))
                    and np.array_equal(g.chk_mask.T, np.asarray(mask) != 0)):
                raise ValueError("JAX spec's BP incidence differs from its "
                                 "parity-check matrix")
            sectors.append(_sector_head(h, base.device))
        llr_z, llr_x = (torch.from_numpy(np.array(v, np.float32).reshape(-1))
                        .to(base.device) for v in (jspec.llr_z, jspec.llr_x))
        return FusedDecodeSpec(base, llr_z, llr_x, *sectors)
    dev = resolve_device(device)
    hx = _gf2(np.asarray(jspec.hx_t).T)
    hz = _gf2(np.asarray(jspec.hz_t).T)
    spec = _spec(hx, hz, _gf2(np.asarray(jspec.lx_t).T),
                 _gf2(np.asarray(jspec.lz_t).T),
                 np.asarray(jspec.cuts, np.uint32), dev)
    for name in ("hx_nbr", "hx_mask", "hz_nbr", "hz_mask"):
        if not np.array_equal(getattr(spec, name).cpu().numpy(),
                              np.asarray(getattr(jspec, name))):
            raise ValueError(f"JAX spec's {name} differs from its "
                             "parity-check matrix")
    return spec


# ---------------------------------------------------------------------------
# Plain versions
def _draw_errors(spec: FusedSpec, key, batch_size: int):
    k0, k1 = key_parts(key)
    r = counter_draws(k0, k1, batch_size, spec.n, spec.device)
    return _errors_from_draws(r, spec.cuts)


def sample_syndrome_plain(spec: FusedSpec, key, batch_size: int, *,
                          emit_errors: bool = True):
    """Plain version of ``sample_syndrome``: draws -> pack ->
    ``packed_parity_apply``."""
    ex, ez = _draw_errors(spec, key, batch_size)
    exp, ezp = pack_shots(ex), pack_shots(ez)
    szp = packed_parity_apply(spec.hx_nbr, spec.hx_mask, ezp)
    sxp = packed_parity_apply(spec.hz_nbr, spec.hz_mask, exp)
    return (exp, ezp, sxp, szp) if emit_errors else (sxp, szp)


def _residual_stats(spec, res_x, res_z, eval_type, batch_size):
    return packed_residual_stats(
        res_x, res_z, (spec.hz_nbr, spec.hz_mask), (spec.hx_nbr, spec.hx_mask),
        spec.lz_t, spec.lx_t, eval_type, batch_size, spec.n)


def residual_check_plain(spec: FusedSpec, key, batch_size: int, corx_p,
                         corz_p, eval_type: str = "Total"):
    """Plain version of ``residual_check_stats``: regenerate -> XOR the
    packed corrections -> ``packed_residual_stats``."""
    ex, ez = _draw_errors(spec, key, batch_size)
    return _residual_stats(spec, pack_shots(ex) ^ corx_p,
                           pack_shots(ez) ^ corz_p, eval_type, batch_size)


# The JAX package's fused-decode tile rule, copied with its constants: the
# scoped-VMEM cap its kernel compiles against, the block_w ladder and the
# calibration ratio it falls back to (calibration/vmem_table.json has no
# "fused_decode" entry; no file is read here).  On the card it is no memory
# gate: it is the tile, and int8 results depend on the tile (one message
# scale per iteration per tile of block_w * 32 shots).
LANE = 32
_KERNEL_VMEM_LIMIT = 64 * 1024 * 1024
_BLOCK_W_LADDER = (8, 4, 2, 1)
_FUSED_DECODE_RATIO = 2.0


def estimate_fused_decode_bytes(n: int, mx: int, mz: int, rwz: int,
                                rwx: int, block_w: int = 4, *,
                                quantize=None) -> float:
    """The JAX package's per-block VMEM estimate of its fused kernel
    (``gf2_pallas.estimate_fused_decode_bytes``), line for line."""
    bt = block_w * LANE
    draws = bt * n * 4
    errs = 2 * bt * n * 4
    mxu = bt * n * 4
    synd = bt * (mx + mz) * 4
    mats = (n * mx + n * mz + 2 * n * 8) * 4
    idx = (rwz * mx + rwx * mz) * 8
    onehot = 3 * max(mx, mz) * n * 2
    msg_elem = 1 if quantize else 2
    per_shot = max(
        (2 + msg_elem) * rwz * mx + 16 * n + 8 * mx,
        (2 + msg_elem) * rwx * mz + 16 * n + 8 * mz)
    analytic = draws + errs + mxu + synd + mats + idx + onehot \
        + bt * per_shot
    return analytic * _FUSED_DECODE_RATIO


def fused_decode_block_w(spec: FusedDecodeSpec, batch_size: int, *,
                         quantize=None) -> int:
    """Largest block_w of the ladder whose estimate fits the cap and whose
    tile divides the batch; 0 when none does (the JAX package's rule)."""
    n, mx, mz, rwz, rwx = spec.statics
    for bw in _BLOCK_W_LADDER:
        if batch_size % (bw * LANE):
            continue
        if estimate_fused_decode_bytes(n, mx, mz, rwz, rwx, bw,
                                       quantize=quantize) <= _KERNEL_VMEM_LIMIT:
            return bw
    return 0


def _fused_tile(spec: FusedDecodeSpec, batch_size: int, quantize,
                block_w) -> int:
    """The batch's block_w, as the JAX package's ``fused_decode_stats``
    picks it: the tile rule's, or 1 when it finds none; raises when the
    batch is not a multiple of the tile."""
    if quantize not in (None, "int8"):
        raise ValueError(f"quantize must be None or 'int8', got {quantize!r}")
    if block_w is None:
        block_w = fused_decode_block_w(spec, batch_size, quantize=quantize) or 1
    block_w = int(block_w)
    if block_w < 1 or batch_size % (block_w * LANE):
        raise ValueError(
            f"fused v2 needs batch_size divisible by {block_w * LANE}, "
            f"got {batch_size}")
    return block_w


def fused_decode_plain(spec: FusedDecodeSpec, key, batch_size: int, *,
                       eval_type: str = "Total", max_iter_z: int,
                       max_iter_x: int, ms_scaling_factor: float = 0.625,
                       quantize: str | None = None,
                       block_w: int | None = None):
    """Plain version of ``fused_decode_stats`` (the JAX package's
    ``_fused_decode_xla``): draws -> packed syndromes -> each sector's
    decode -> ``packed_residual_stats``.  The decode is the bf16 loop
    ``minsum_dense_plain`` (shots are independent, so the tiles' early exit
    changes no output), or with ``quantize="int8"`` ``minsum_int8_plain``
    per tile of ``block_w * 32`` shots with early exit."""
    block_w = _fused_tile(spec, batch_size, quantize, block_w)
    base = spec.base
    scale = float(ms_scaling_factor)
    exp, ezp, sxp, szp = sample_syndrome_plain(base, key, batch_size)
    sz, sx = unpack_shots(szp, batch_size), unpack_shots(sxp, batch_size)

    def decode(sparse, synd, llr, max_iter):
        synd_bl = synd.t().contiguous()
        if quantize is None:
            err, done, _post, iters = minsum_dense_plain(
                sparse, synd_bl, llr,
                head_iters=int(max_iter), scale=scale, early_stop=True)
        else:
            err, done, _post, iters = minsum_int8_plain(
                sparse, synd_bl, llr, head_iters=int(max_iter), scale=scale,
                block_b=block_w * LANE, early_stop=True)
        return err.t(), {"converged": done, "iterations": iters}

    cor_z, aux_z = decode(spec.sparse_z, sz, spec.llr_z, max_iter_z)
    cor_x, aux_x = decode(spec.sparse_x, sx, spec.llr_x, max_iter_x)
    cnt, min_w = _residual_stats(base, exp ^ pack_shots(cor_x),
                                 ezp ^ pack_shots(cor_z), eval_type,
                                 batch_size)
    return cnt, min_w, aux_x, aux_z


# ---------------------------------------------------------------------------
# Kernel wrappers
def _check_batch(batch_size: int) -> int:
    b = int(batch_size)
    if not 1 <= b < 2 ** 31 - 32:
        raise ValueError(f"batch_size must be in [1, 2**31 - 32), got {b}")
    return b


def _check_eval(eval_type: str) -> int:
    if eval_type not in EVAL_CODES:
        raise ValueError(f"eval_type must be X, Z or Total, got {eval_type!r}")
    return EVAL_CODES[eval_type]


def _check_spec(spec: FusedSpec, dev) -> None:
    for name in ("hx", "hz", "lx", "lz"):
        nbr, mask = getattr(spec, f"{name}_nbr"), getattr(spec, f"{name}_mask")
        if (nbr.dtype != torch.int32 or mask.dtype != torch.bool
                or nbr.shape != mask.shape or nbr.device != dev
                or mask.device != dev or not nbr.is_contiguous()
                or not mask.is_contiguous()):
            raise ValueError(f"spec {name} adjacency must be contiguous int32 "
                             f"neighbours and a bool mask on {dev}")
    if 8 * spec.n > SMEM_LIMIT:
        raise ValueError(f"{spec.n} qubits: two error words per qubit exceed "
                         f"{SMEM_LIMIT} bytes of shared memory")


def _adj(spec: FusedSpec, name: str) -> list:
    nbr, mask = getattr(spec, f"{name}_nbr"), getattr(spec, f"{name}_mask")
    return [nbr.data_ptr(), mask.data_ptr(), nbr.shape[0], nbr.shape[1]]


def _key_and_cuts(spec: FusedSpec, key) -> tuple:
    """The kernels' leading arguments: a pointer to the key's two words on
    the spec's device (a key tensor as given, host words uploaded) and the
    cuts.  Keep the returned key tensor alive until the launch."""
    key = key_tensor(key, spec.device)
    return key, [key.data_ptr(), *spec.cuts]


def _call(lib: str, fn_name: str, argtypes, args, dev) -> None:
    fn = getattr(_kernels.library(lib), fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*args, stream)
    _kernels.check_launch(lib, rc)


_U, _P, _I, _F = ctypes.c_uint32, ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _launch_sample(spec, key, batch_size, emit_errors):
    dev = spec.device
    _check_spec(spec, dev)
    n, W = spec.n, num_words(batch_size)
    mx, rwx = spec.hx_nbr.shape
    mz, rwz = spec.hz_nbr.shape
    shape_e = (W, n) if emit_errors else (0,)
    ex_p = torch.empty(shape_e, dtype=torch.int32, device=dev)
    ez_p = torch.empty(shape_e, dtype=torch.int32, device=dev)
    sx_p = torch.empty((W, mz), dtype=torch.int32, device=dev)
    sz_p = torch.empty((W, mx), dtype=torch.int32, device=dev)
    key, lead = _key_and_cuts(spec, key)
    _call("gf2_sample", "gf2_sample_launch",
          [_P] + [_U] * 3 + [_P] * 8 + [_I] * 7 + [_P],
          [*lead, spec.hx_nbr.data_ptr(),
           spec.hx_mask.data_ptr(), spec.hz_nbr.data_ptr(),
           spec.hz_mask.data_ptr(), ex_p.data_ptr(), ez_p.data_ptr(),
           sx_p.data_ptr(), sz_p.data_ptr(), int(emit_errors), n, mx, rwx,
           mz, rwz, batch_size], dev)
    _kernels.count_launch(sample_syndrome, "launches", dev)
    return (ex_p, ez_p, sx_p, sz_p) if emit_errors else (sx_p, sz_p)


def sample_syndrome(spec: FusedSpec, key, batch_size: int, *,
                    emit_errors: bool = True):
    """Counter-PRNG depolarizing sample and both syndromes, packed.

    Returns int32 words ``(ex_p, ez_p (W, n), sx_p (W, mz), sz_p (W, mx))``,
    or just ``(sx_p, sz_p)`` without ``emit_errors``; ``sx_p = hz . e_x``,
    ``sz_p = hx . e_z``.  A spec on the card launches ``csrc/gf2_sample.cu``
    (or raises); a spec on the CPU runs ``sample_syndrome_plain``.  Any
    ``batch_size >= 1``: the ragged last word's padding bits are zero."""
    batch_size = _check_batch(batch_size)
    if spec.device.type == "cuda" and not _kernels.plain_forced():
        return _launch_sample(spec, key, batch_size, emit_errors)
    return sample_syndrome_plain(spec, key, batch_size,
                                 emit_errors=emit_errors)


sample_syndrome.launches = 0


def _launch_residual(spec, key, batch_size, corx_p, corz_p, eval_code):
    dev = spec.device
    _check_spec(spec, dev)
    W = num_words(batch_size)
    for t in (corx_p, corz_p):
        if (t.dtype != torch.int32 or tuple(t.shape) != (W, spec.n)
                or t.device != dev or not t.is_contiguous()):
            raise ValueError(f"corrections must be contiguous int32 words of "
                             f"shape {(W, spec.n)} on {dev}")
    part = torch.empty((W, 2), dtype=torch.int32, device=dev)
    key, lead = _key_and_cuts(spec, key)
    _call("gf2_residual", "gf2_residual_launch",
          [_P] + [_U] * 3 + [_P] * 2 + [_P, _P, _I, _I] * 4
          + [_I, _I, _I, _P, _P],
          [*lead, corx_p.data_ptr(), corz_p.data_ptr(),
           *_adj(spec, "hx"), *_adj(spec, "hz"), *_adj(spec, "lx"),
           *_adj(spec, "lz"), eval_code, spec.n, batch_size,
           part.data_ptr()], dev)
    _kernels.count_launch(residual_check_stats, "launches", dev)
    return part[:, 0].sum(dtype=torch.int32), part[:, 1].min()


def residual_check_stats(spec: FusedSpec, key, batch_size: int, corx_p,
                         corz_p, eval_type: str = "Total"):
    """Residual stabilizer and logical checks with the errors regenerated
    from ``key`` (the key ``sample_syndrome`` drew this batch with).

    corx_p/corz_p: (W, n) int32 packed corrections.  Returns int32 device
    scalars (failure count of ``eval_type``, min residual weight among
    logical failures, n when none).  A spec on the card launches
    ``csrc/gf2_residual.cu`` (or raises); on the CPU this runs
    ``residual_check_plain``."""
    batch_size = _check_batch(batch_size)
    code = _check_eval(eval_type)
    if spec.device.type == "cuda" and not _kernels.plain_forced():
        return _launch_residual(spec, key, batch_size, corx_p, corz_p, code)
    return residual_check_plain(spec, key, batch_size, corx_p, corz_p,
                                eval_type)


residual_check_stats.launches = 0


# shared memory of the bf16 fused kernel's static arrays, rounded up
_FUSED_STATIC = 1024
# a full block's shots get at most 2 checks and 2 variables per thread
# (bp_kernel.lane_layout's ``items``): a fused shot is a chain of short
# passes (sampling, syndromes, a few iterations per sector, residual
# checks) whose latency falls with threads per shot.  From
# scripts/ab_minsum_body.py --sweep on an H100 (PERF.md): at hgp_34_n625,
# 4096 shots, 3 shots per block (2 items) ran in 0.297 ms, 4 (3 items) in
# 0.372 and the min-sum kernels' 8 (5 items) in 0.459.
FUSED_ITEMS = 2


def fused_smem_bytes(lanes: int, n: int, mx: int, rwz: int, cwz: int,
                     mz: int, rwx: int, cwx: int) -> int:
    """Dynamic shared memory of the bf16 fused decode (csrc/fused_decode.cu)
    for ``lanes`` shots per block: both sectors' staged planes and channel
    LLRs (the Z sector decodes over hx: mx checks of weight rwz, variables
    of weight cwz), then per shot the larger sector's c2v and v2c, the
    totals, the syndrome and both error planes, each rounded up to 16
    bytes."""
    staged = sum(minsum_smem_bytes(0, m, n, rw, cw, True) for m, rw, cw in
                 ((mx, rwz, cwz), (mz, rwx, cwx)))
    e = max(mx * rwz, mz * rwx)
    per_shot = (_align16(4 * e) + _align16(2 * e) + _align16(4 * n)
                + _align16(max(mx, mz)) + 2 * _align16(n))
    return staged + lanes * per_shot


def _fused_rows_ok(rw: int) -> bool:
    """Whether B5 (both modes) takes row weight ``rw``: 32-bit slot masks up
    to 32, the wide instances' 64-bit ones up to MINSUM_MAX_RW."""
    return 1 <= rw <= MINSUM_MAX_RW


def fused_wide(spec) -> bool:
    """Whether B5 launches its wide instance (64-bit slot masks) for this
    spec: a sector's row weight above 32."""
    return max(spec.sparse_z.rw, spec.sparse_x.rw) > MINSUM_NARROW_RW


def fused_layout(B: int, n: int, mx: int, rwz: int, cwz: int, mz: int,
                 rwx: int, cwx: int, sm_count: int,
                 lanes: int | None = None) -> MinsumLayout:
    """The launch of the bf16 fused decode for a batch of B shots: the
    min-sum kernels' rule (``bp_kernel.lane_layout``: shots per block,
    threads per shot, grid from the batch) at FUSED_ITEMS items per thread,
    over the fused kernel's shared memory, less its static arrays; raises
    ``ValueError`` where not one shot fits."""
    if not (_fused_rows_ok(rwz) and _fused_rows_ok(rwx)):
        raise ValueError(f"fused decode takes row weights 1..{MINSUM_MAX_RW}, "
                         f"got {rwz} and {rwx}")
    if max(mx * rwz, mz * rwx) >= 0xFFFF or n >= 0xFFFF:
        raise ValueError("the fused decode numbers edges and variables with "
                         "16 bits")
    shape = (n, mx, rwz, cwz, mz, rwx, cwx)
    fixed = fused_smem_bytes(0, *shape)
    return lane_layout(B, fixed, fused_smem_bytes(1, *shape) - fixed,
                       max(mx, mz, n), sm_count, lanes,
                       SMEM_LIMIT - _FUSED_STATIC, "fused decode", FUSED_ITEMS)


def _fused_shape(spec) -> tuple:
    """``(n, mx, rwz, cwz, mz, rwx, cwx)`` of a FusedDecodeSpec."""
    z, x = spec.sparse_z, spec.sparse_x
    return (spec.base.n, z.m, z.rw, z.var_edge.shape[1], x.m, x.rw,
            x.var_edge.shape[1])


@functools.lru_cache(maxsize=None)
def _fused_resident(index: int, threads: int, smem_bytes: int,
                    wide: bool) -> int:
    fn = _kernels.library("fused_decode").fused_decode_resident
    fn.argtypes = [_I, _I, _I, _P]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    with torch.cuda.device(index):
        rc = fn(threads, smem_bytes, int(wide), ctypes.addressof(blocks))
    _kernels.check_launch("fused_decode_resident", rc)
    return blocks.value


def card_fused_layout(spec: FusedDecodeSpec, batch_size: int) -> MinsumLayout:
    """``fused_layout`` on the spec's CUDA device: its SM count, and the
    grid lowered to the blocks the card holds at once."""
    dev = spec.base.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    lay = fused_layout(batch_size, *_fused_shape(spec), _sm_count(index))
    held = _fused_resident(index, lay.threads, lay.smem_bytes,
                           fused_wide(spec))
    if held < 1:
        raise ValueError(f"fused decode: a block of {lay.threads} threads "
                         f"and {lay.smem_bytes} bytes does not fit")
    return lay._replace(grid=min(lay.grid, _sm_count(index) * held),
                        resident=held)


# the int8 fused decode: blocks of 32 shots, a tile's blocks one cluster
INT8_FUSED_MAX_CLUSTER = 16
# shared memory of the int8 fused kernel's static arrays, rounded up
_INT8_FUSED_STATIC = 1024


def fused_int8_smem_bytes(n: int, mx: int, rwz: int, mz: int, rwx: int,
                          staged: bool = False) -> int:
    """Dynamic shared memory of the int8 fused decode's 32-shot block: the
    larger sector's int8 messages (rounded up to 16 bytes; the sampler's
    error words use the same space before the decodes start), bf16 totals,
    as 32-bit words over the block's shots both syndromes and both sectors'
    corrections (rounded up to 8 bytes), and with ``staged`` the larger
    sector's index plane as 16-bit indices."""
    edges = max(mx * rwz, mz * rwx)
    msg = max(-(-LANE * edges // 16) * 16, 8 * n)
    words = -(-(msg + 2 * n * LANE + 4 * (mx + mz) + 8 * n) // 8) * 8
    return words + (2 * edges if staged else 0)


def fused_int8_staged(n: int, mx: int, rwz: int, mz: int, rwx: int) -> bool:
    """Whether the int8 fused decode copies each sector's index plane into
    shared memory, as 16-bit indices: when n < 2^15 and it fits beside the
    rest of the block's layout; otherwise the kernel reads it from device
    memory."""
    return (n < 1 << 15 and fused_int8_smem_bytes(n, mx, rwz, mz, rwx, True)
            + _INT8_FUSED_STATIC <= SMEM_LIMIT)


def _sparse_args(sg: SparseHeadGraph, dev) -> list:
    for t in sg:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"fused decode index planes must be contiguous "
                             f"on {dev}")
    if not _fused_rows_ok(sg.rw):
        raise ValueError(f"fused decode takes row weights "
                         f"1..{MINSUM_MAX_RW}, got {sg.rw}")
    return [sg.chk_idx.data_ptr(), sg.mask.data_ptr(), sg.var_edge.data_ptr(),
            sg.m, sg.rw, sg.var_edge.shape[1]]


def _fused_outputs(spec, batch_size, blocks):
    base = spec.base
    dev = base.device
    _check_spec(base, dev)
    for llr in (spec.llr_z, spec.llr_x):
        if (llr.dtype != torch.float32 or tuple(llr.shape) != (base.n,)
                or llr.device != dev or not llr.is_contiguous()):
            raise ValueError(f"channel LLRs must be contiguous float32 "
                             f"({base.n},) on {dev}")
    conv_z = torch.empty((batch_size,), dtype=torch.uint8, device=dev)
    iter_z = torch.empty((batch_size,), dtype=torch.int32, device=dev)
    part = torch.empty((blocks, 2), dtype=torch.int32, device=dev)
    return (conv_z, iter_z, torch.empty_like(conv_z), torch.empty_like(iter_z),
            part)


def _fused_result(outs):
    conv_z, iter_z, conv_x, iter_x, part = outs
    aux_z = {"converged": conv_z.to(torch.bool), "iterations": iter_z}
    aux_x = {"converged": conv_x.to(torch.bool), "iterations": iter_x}
    return part[:, 0].sum(dtype=torch.int32), part[:, 1].min(), aux_x, aux_z


def _launch_fused(spec, key, batch_size, eval_code, max_iter_z, max_iter_x,
                  scale):
    base = spec.base
    dev = base.device
    for sparse in (spec.sparse_z, spec.sparse_x):
        _sparse_args(sparse, dev)  # device, contiguity, row weight
    lay = card_fused_layout(spec, batch_size)
    outs = _fused_outputs(spec, batch_size, lay.grid)
    claims = torch.zeros((1,), dtype=torch.int32, device=dev)
    planes = []
    for sparse, llr in ((spec.sparse_z, spec.llr_z), (spec.sparse_x, spec.llr_x)):
        p = _planes_of(sparse)
        planes += [p.chk.data_ptr(), p.edge.data_ptr(), p.slot.data_ptr(),
                   llr.data_ptr(), sparse.m, sparse.rw, p.edge.shape[0]]
    key, lead = _key_and_cuts(base, key)
    _call("fused_decode", "fused_decode_launch",
          [_P] + [_U] * 3 + ([_P] * 4 + [_I] * 3) * 2 + [_P, _P, _I, _I] * 2
          + [_I, _I, _I, _F, _I, _I, _I, _I, _I, _I] + [_P] * 7,
          [*lead, *planes, *_adj(base, "lx"),
           *_adj(base, "lz"), base.n, max_iter_z, max_iter_x, scale,
           eval_code, batch_size, lay.lanes, lay.threads // lay.lanes,
           lay.grid, lay.smem_bytes, *(t.data_ptr() for t in outs),
           claims.data_ptr()], dev)
    _kernels.count_launch(fused_decode_stats, "launches", dev)
    _kernels.count_launch(fused_decode_stats, "wide_launches", dev,
                          fused_wide(spec))
    return _fused_result(outs)


def _launch_fused_int8(spec, key, batch_size, eval_code, max_iter_z,
                       max_iter_x, scale, block_w):
    base = spec.base
    dev = base.device
    sz, sx = _sparse_args(spec.sparse_z, dev), _sparse_args(spec.sparse_x, dev)
    shape = (base.n, sz[3], sz[4], sx[3], sx[4])
    staged = fused_int8_staged(*shape)
    smem = fused_int8_smem_bytes(*shape, staged)
    if smem + _INT8_FUSED_STATIC > SMEM_LIMIT or block_w > INT8_FUSED_MAX_CLUSTER:
        raise ValueError(
            f"fused int8 decode: a block of {LANE} shots needs {smem} bytes of "
            f"shared memory (at most {SMEM_LIMIT - _INT8_FUSED_STATIC}) and a "
            f"tile of block_w={block_w} a cluster of {block_w} blocks (at "
            f"most {INT8_FUSED_MAX_CLUSTER})")
    outs = _fused_outputs(spec, batch_size, batch_size // LANE)
    key, lead = _key_and_cuts(base, key)
    _call("fused_decode_int8", "fused_decode_int8_launch",
          [_P] + [_U] * 3 + ([_P] * 3 + [_I] * 3) * 2 + [_P, _P, _I, _I] * 4
          + [_P, _P, _I, _I, _I, _F, _I, _I, _I, _I, _I] + [_P] * 6,
          [*lead, *sz, *sx, *_adj(base, "hx"),
           *_adj(base, "hz"), *_adj(base, "lx"), *_adj(base, "lz"),
           spec.llr_z.data_ptr(), spec.llr_x.data_ptr(), base.n, max_iter_z,
           max_iter_x, scale, eval_code, batch_size, block_w, int(staged),
           smem, *(t.data_ptr() for t in outs)], dev)
    _kernels.count_launch(fused_decode_stats, "int8_launches", dev)
    _kernels.count_launch(fused_decode_stats, "int8_wide_launches", dev,
                          fused_wide(spec))
    return _fused_result(outs)


def fused_int8_active_clusters(spec: FusedDecodeSpec, block_w: int) -> int:
    """How many tiles of ``block_w * 32`` shots the int8 fused kernel runs
    at once on the current card (``cudaOccupancyMaxActiveClusters``); a
    batch of T tiles runs in ceil(T / this) waves."""
    n, mx, mz, rwz, rwx = spec.statics
    staged = fused_int8_staged(n, mx, rwz, mz, rwx)
    fn = _kernels.library("fused_decode_int8").fused_decode_int8_active_clusters
    fn.argtypes = [_I, _I, _I, _I]
    fn.restype = ctypes.c_int
    with torch.cuda.device(spec.base.device):
        return fn(int(block_w), int(staged), int(fused_wide(spec)),
                  fused_int8_smem_bytes(n, mx, rwz, mz, rwx, staged))


def fused_decode_feasible(spec: FusedDecodeSpec, batch_size: int, *,
                          quantize=None) -> bool:
    """Whether the card's fused decode takes this spec and batch, without
    raising: the batch a multiple of its tile (``fused_decode_block_w``'s,
    or 1 x 32 shots), two error words per qubit in shared memory, and the
    kernel's layout: for bf16 ``fused_layout``'s (row weights 1..64, 16-bit
    edge and variable numbers, one shot beside the staged planes), for
    int8 a 32-shot block in shared memory and the tile's blocks one
    cluster.  Where it is False the engine runs fused v1 instead."""
    n, mx, mz, rwz, rwx = spec.statics
    block_w = fused_decode_block_w(spec, batch_size, quantize=quantize) or 1
    if batch_size % (block_w * LANE) or 8 * n > SMEM_LIMIT \
            or not (_fused_rows_ok(rwz) and _fused_rows_ok(rwx)):
        return False
    if quantize == "int8":
        staged = fused_int8_staged(n, mx, rwz, mz, rwx)
        return (fused_int8_smem_bytes(n, mx, rwz, mz, rwx, staged)
                + _INT8_FUSED_STATIC <= SMEM_LIMIT
                and block_w <= INT8_FUSED_MAX_CLUSTER)
    shape = _fused_shape(spec)
    return (max(mx * rwz, mz * rwx) < 0xFFFF and n < 0xFFFF
            and fused_smem_bytes(1, *shape) + _FUSED_STATIC <= SMEM_LIMIT)


def fused_decode_stats(spec: FusedDecodeSpec, key, batch_size: int, *,
                       eval_type: str = "Total", max_iter_z: int,
                       max_iter_x: int, ms_scaling_factor: float = 0.625,
                       quantize: str | None = None,
                       block_w: int | None = None):
    """Whole-pipeline batch: sample, both syndromes, the Z then the X
    sector's min-sum decode (each shot frozen at its first convergence, each
    tile leaving its loop when all its shots have converged), residual
    checks.  Returns ``(failure count, min weight, aux_x, aux_z)``: int32
    device scalars and per-shot ``converged`` (bool) and ``iterations``
    (int32) of each sector.

    Messages are bf16, or int8 with ``quantize="int8"``; the tile is
    ``block_w * 32`` shots, ``block_w`` from ``fused_decode_block_w`` unless
    given, and a batch that is not a multiple of it raises ``ValueError``.
    A spec on the card launches ``csrc/fused_decode.cu`` (bf16, counted in
    ``fused_decode_stats.launches``) or ``csrc/fused_decode_int8.cu``
    (``.int8_launches``), or raises; on the CPU this runs
    ``fused_decode_plain``."""
    batch_size = _check_batch(batch_size)
    code = _check_eval(eval_type)
    block_w = _fused_tile(spec, batch_size, quantize, block_w)
    if min(max_iter_z, max_iter_x) < 0:
        raise ValueError("max_iter must be >= 0")
    if spec.base.device.type == "cuda" and not _kernels.plain_forced():
        args = (spec, key, batch_size, code, int(max_iter_z), int(max_iter_x),
                float(ms_scaling_factor))
        if quantize is None:
            return _launch_fused(*args)
        return _launch_fused_int8(*args, block_w)
    return fused_decode_plain(spec, key, batch_size, eval_type=eval_type,
                              max_iter_z=max_iter_z, max_iter_x=max_iter_x,
                              ms_scaling_factor=ms_scaling_factor,
                              quantize=quantize, block_w=block_w)


fused_decode_stats.launches = 0
fused_decode_stats.int8_launches = 0
fused_decode_stats.wide_launches = 0
fused_decode_stats.int8_wide_launches = 0

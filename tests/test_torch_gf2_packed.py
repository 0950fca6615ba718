"""Port ops/gf2_packed.py and ops/linalg.py against the JAX package's.

The same numpy bit planes go through both; every result is compared bit for
bit (the port's int32 words read as the JAX package's uint32 words).
Tolerance: none."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qldpc_fault_tolerance_tpu.ops import gf2_packed as jgp
from qldpc_fault_tolerance_tpu.ops import linalg as jla
from qldpc_fault_tolerance_tpu_torch.codes import hgp, ring_code
from qldpc_fault_tolerance_tpu_torch.ops import gf2_packed as tgp
from qldpc_fault_tolerance_tpu_torch.ops import linalg as tla

# one intra-op thread: the suite runs several pytest workers on few cores,
# and an oversubscribed torch thread pool stalls small ops
torch.set_num_threads(1)


def _u32(x):
    return np.asarray(x).view(np.uint32) if np.asarray(x).dtype == np.int32 \
        else np.asarray(x)


def _bits(seed, shape, p=0.3):
    return (np.random.default_rng(seed).random(shape) < p).astype(np.uint8)


@pytest.mark.parametrize("b", [1, 31, 32, 33, 100])
def test_pack_unpack_and_lane_mask(b):
    bits = _bits(b, (b, 7))
    tp = tgp.pack_shots(torch.from_numpy(bits))
    assert tp.dtype == torch.int32
    assert np.array_equal(_u32(tp.numpy()), np.asarray(jgp.pack_shots(bits)))
    assert np.array_equal(tgp.unpack_shots(tp, b).numpy(), bits)
    assert np.array_equal(_u32(tgp.lane_mask(b, "cpu").numpy()),
                          np.asarray(jgp.lane_mask(b)))


def test_popcount_and_count_match_jax():
    words = np.random.default_rng(0).integers(0, 2 ** 32, 257, dtype=np.uint64)
    words = words.astype(np.uint32)
    words[:3] = [0, 0xFFFFFFFF, 0x80000000]
    tw = torch.from_numpy(words.view(np.int32))
    assert np.array_equal(tgp.popcount(tw).numpy(),
                          np.asarray(jgp.popcount(words)).astype(np.int32))
    for b in (1, 100, 257 * 32):
        assert int(tgp.packed_count(tw[: -(-b // 32)], b)) == int(
            jgp.packed_count(jnp.asarray(words[: -(-b // 32)]), b))


@pytest.mark.parametrize("b", [40, 64])
def test_packed_spmv_matmul_and_residual_stats(b):
    code = hgp(ring_code(3), ring_code(4))
    n = code.N
    jx, jz = jla.ParityOp(code.hx), jla.ParityOp(code.hz)
    tx, tz = tla.ParityOp(code.hx, "cpu"), tla.ParityOp(code.hz, "cpu")
    ex, ez = _bits(1, (b, n), 0.1), _bits(2, (b, n), 0.1)
    for jop, top, e in ((jx, tx, ez), (jz, tz, ex)):
        jp, tp = jgp.pack_shots(e), tgp.pack_shots(torch.from_numpy(e))
        js = jgp.packed_parity_apply(jop.nbr, jop.mask, jp)
        ts = tgp.packed_parity_apply(top.nbr, top.mask, tp)
        assert np.array_equal(_u32(ts.numpy()), np.asarray(js))
        assert np.array_equal(top(torch.from_numpy(e)).numpy(), np.asarray(jop(e)))
    lx_t = np.ascontiguousarray(code.lx.T)
    jm = jgp.packed_gf2_matmul(jgp.pack_shots(ex), lx_t)
    tm = tgp.packed_gf2_matmul(tgp.pack_shots(torch.from_numpy(ex)),
                               torch.from_numpy(lx_t))
    assert np.array_equal(_u32(tm.numpy()), np.asarray(jm))
    assert np.array_equal(
        tla.gf2_matmul(torch.from_numpy(ex), torch.from_numpy(lx_t)).numpy(),
        np.asarray(jla.gf2_matmul(jnp.asarray(ex), jnp.asarray(lx_t))))
    lz_t = np.ascontiguousarray(code.lz.T)
    for eval_type in ("X", "Z", "Total"):
        jc, jw = jgp.packed_residual_stats(
            jgp.pack_shots(ex), jgp.pack_shots(ez), (jz.nbr, jz.mask),
            (jx.nbr, jx.mask), lz_t, lx_t, eval_type, b, n)
        tc, tw = tgp.packed_residual_stats(
            tgp.pack_shots(torch.from_numpy(ex)),
            tgp.pack_shots(torch.from_numpy(ez)), (tz.nbr, tz.mask),
            (tx.nbr, tx.mask), torch.from_numpy(lz_t), torch.from_numpy(lx_t),
            eval_type, b, n)
        assert (int(tc), int(tw)) == (int(jc), int(jw)), eval_type


def test_xor_reduce_matches_numpy():
    x = np.random.default_rng(4).integers(-2 ** 31, 2 ** 31, (5, 13, 3),
                                          dtype=np.int64).astype(np.int32)
    for dim in range(3):
        ref = np.bitwise_xor.reduce(x, axis=dim)
        assert np.array_equal(tgp.xor_reduce(torch.from_numpy(x), dim).numpy(), ref)

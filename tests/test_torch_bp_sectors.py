"""Fused sector decodes on the CPU: the plain version of kernel 1's sector
mode (``bp_kernel.bp_minsum(sectors=)``, ``bp_loop``), ``bp_decode`` and
``bp_decode_two_phase(sectors=)``, ``FusedBPPair`` and
``CodeSimulator_DataError(fuse_sectors=True)``, each against the JAX
package's counterpart on the same inputs and against separate decodes of
the sectors.  Tolerance: none, every output bit-exact (the JAX package runs
its XLA loop in float32 with the same order of sums)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qldpc_fault_tolerance_tpu.codes import hgp as jhgp
from qldpc_fault_tolerance_tpu.codes import rep_code as jrep_code
from qldpc_fault_tolerance_tpu.decoders import BPDecoder as JBPDecoder
from qldpc_fault_tolerance_tpu.decoders.bp_decoders import \
    FusedBPPair as JFusedBPPair
from qldpc_fault_tolerance_tpu.noise import depolarizing_xz
from qldpc_fault_tolerance_tpu.ops import bp as jbp
from qldpc_fault_tolerance_tpu.ops.linalg import ParityOp as JParityOp
from qldpc_fault_tolerance_tpu_torch.codes import hgp, rep_code
from qldpc_fault_tolerance_tpu_torch.decoders import BPDecoder
from qldpc_fault_tolerance_tpu_torch.decoders.bp_decoders import FusedBPPair
from qldpc_fault_tolerance_tpu_torch.ops import bp
from qldpc_fault_tolerance_tpu_torch.ops import bp_kernel as bk
from qldpc_fault_tolerance_tpu_torch.ops.prng import prng_key
from qldpc_fault_tolerance_tpu_torch.sim import CodeSimulator_DataError


def _blocks(hs):
    m, n = sum(h.shape[0] for h in hs), sum(h.shape[1] for h in hs)
    out = np.zeros((m, n), np.uint8)
    r = c = 0
    for h in hs:
        out[r:r + h.shape[0], c:c + h.shape[1]] = h
        r, c = r + h.shape[0], c + h.shape[1]
    return out, (tuple(h.shape[0] for h in hs), tuple(h.shape[1] for h in hs))


def _random_block(m, n, rw, rng):
    h = np.zeros((m, n), np.uint8)
    for i in range(m):
        h[i, rng.choice(n, int(rng.integers(2, rw + 1)), replace=False)] = 1
    return h


def _case(hs, B, p, seed):
    rng = np.random.default_rng(seed)
    h, sectors = _blocks(hs)
    synd = [((rng.random((B, hb.shape[1])) < p).astype(np.uint8) @ hb.T % 2)
            .astype(np.uint8) for hb in hs]
    probs = rng.uniform(0.5 * p, 1.5 * p, h.shape[1])
    return h, sectors, synd, probs


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _separate(hs, synd, llr, max_iter, method="minimum_sum"):
    parts, v0 = [], 0
    for hb, sb in zip(hs, synd):
        n = hb.shape[1]
        parts.append(bp.bp_decode(bp.build_tanner_graph(hb, "cpu"), sb,
                                  llr[v0:v0 + n], max_iter=max_iter,
                                  method=method, device="cpu"))
        v0 += n
    return bp.BPResult(torch.cat([q.error for q in parts], 1),
                       torch.stack([q.converged for q in parts]).all(0),
                       torch.cat([q.posterior_llr for q in parts], 1),
                       torch.stack([q.iterations for q in parts]).amax(0))


CASES = {
    "hgp": lambda: [hgp(rep_code(4), rep_code(5)).hz,
                    hgp(rep_code(4), rep_code(5)).hx],
    "three": lambda: [_random_block(m, n, rw, np.random.default_rng(m))
                      for m, n, rw in ((20, 45, 6), (35, 80, 9), (8, 16, 3))],
}


@pytest.mark.parametrize("max_iter", [0, 1, 3, 25])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_sector_mode_equals_separate_decodes_and_jax(case, max_iter):
    hs = CASES[case]()
    h, sectors, synd, probs = _case(hs, 96, 0.06, 11)
    llr = bp.llr_from_probs(probs, "cpu")
    graph = bp.build_tanner_graph(h, "cpu")
    s = np.hstack(synd)
    got = bp.bp_decode(graph, s, llr, max_iter=max_iter, sectors=sectors,
                       device="cpu")
    assert _equal(got, _separate(hs, synd, llr, max_iter))
    raw = bk.bp_minsum(graph, torch.from_numpy(s), llr, max_iter=max_iter,
                       sectors=sectors)
    assert _equal(got, raw)
    ref = jbp.bp_decode(jbp.build_tanner_graph(h), jnp.asarray(s),
                        jbp.llr_from_probs(probs), max_iter=max_iter,
                        sectors=sectors)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_two_phase_and_product_sum_sectors():
    hs = CASES["three"]()
    h, sectors, synd, probs = _case(hs, 128, 0.08, 5)
    llr = bp.llr_from_probs(probs, "cpu")
    graph = bp.build_tanner_graph(h, "cpu")
    s = np.hstack(synd)
    one = bp.bp_decode(graph, s, llr, max_iter=20, sectors=sectors,
                       device="cpu")
    two = bp.bp_decode_two_phase(graph, s, llr, max_iter=20, sectors=sectors,
                                 device="cpu")
    assert _equal(one, two)
    ps = bp.bp_decode(graph, s, llr, max_iter=12, method="product_sum",
                      sectors=sectors, device="cpu")
    assert _equal(ps, _separate(hs, synd, llr, 12, method="product_sum"))
    per_shot = llr.expand(128, -1).contiguous()
    assert _equal(bp.bp_decode(graph, s, per_shot, max_iter=20,
                               sectors=sectors, device="cpu"), one)


def test_bad_sectors_raise():
    h, sectors, synd, probs = _case(CASES["hgp"](), 4, 0.06, 1)
    graph = bp.build_tanner_graph(h, "cpu")
    llr = bp.llr_from_probs(probs, "cpu")
    for bad in (((10, 10), (45, 40)), ((20,), (40, 40)), ((40, 0), ())):
        with pytest.raises(ValueError):
            bp.bp_decode(graph, np.hstack(synd), llr, max_iter=3,
                         sectors=bad, device="cpu")
    # sizes that add up on a graph that is not block diagonal along them:
    # one check of sector 0 touching a variable of sector 1
    cross = h.copy()
    cross[0, -1] = 1
    for decode in (bp.bp_decode, bp.bp_decode_two_phase):
        with pytest.raises(ValueError, match="block diagonally"):
            decode(bp.build_tanner_graph(cross, "cpu"), np.hstack(synd),
                   llr, max_iter=3, sectors=sectors, device="cpu")
    with pytest.raises(ValueError, match="block diagonally"):
        bk.check_sectors(bp.build_tanner_graph(h, "cpu"),
                         (sectors[0], (sectors[1][0] - 1,
                                       sectors[1][1] + 1)))
    assert bk.check_sectors(graph, sectors) == sectors


def test_fused_pair_matches_jax_and_separate_decodes():
    """tests/test_decoders.py's fused-pair case on both packages: the same
    errors (the JAX sampler's), the port's pair == JAX's pair == the
    separate decoders of either package."""
    jcode = jhgp(jrep_code(4), jrep_code(5))
    code = hgp(rep_code(4), rep_code(5))
    probs = np.full(code.N, 0.06)
    jx = JBPDecoder(jcode.hz, probs, max_iter=40)
    jz = JBPDecoder(jcode.hx, probs, max_iter=40)
    dx = BPDecoder(code.hz, probs, max_iter=40, device="cpu")
    dz = BPDecoder(code.hx, probs, max_iter=40, device="cpu")
    assert JFusedBPPair.compatible(jx, jz) and FusedBPPair.compatible(dx, dz)
    ex, ez = depolarizing_xz(jax.random.PRNGKey(7), (96, code.N),
                             (0.02, 0.02, 0.02))
    sx, sz = JParityOp(jcode.hz)(ex), JParityOp(jcode.hx)(ez)
    jcx, jcz = JFusedBPPair(jx, jz).decode_pair_device(sx, sz)
    pair = FusedBPPair(dx, dz)
    assert pair.sectors == JFusedBPPair(jx, jz).sectors
    tsx, tsz = torch.from_numpy(np.array(sx)), torch.from_numpy(np.array(sz))
    cx, cz = pair.decode_pair_device(tsx, tsz)
    np.testing.assert_array_equal(cx.numpy(), np.asarray(jcx))
    np.testing.assert_array_equal(cz.numpy(), np.asarray(jcz))
    np.testing.assert_array_equal(cx.numpy(),
                                  dx.decode_batch_device(tsx)[0].numpy())
    np.testing.assert_array_equal(cz.numpy(),
                                  dz.decode_batch_device(tsz)[0].numpy())


def test_compatible_follows_jax_and_refuses_heads():
    code = hgp(rep_code(3), rep_code(4))
    probs = np.full(code.N, 0.05)

    def dec(h, **kw):
        return BPDecoder(h, probs, kw.pop("max_iter", 20), device="cpu", **kw)

    assert FusedBPPair.compatible(dec(code.hz), dec(code.hx))
    assert not FusedBPPair.compatible(dec(code.hz), dec(code.hx, max_iter=21))
    assert not FusedBPPair.compatible(dec(code.hz),
                                      dec(code.hx, two_phase=False))
    assert not FusedBPPair.compatible(
        dec(code.hz), dec(code.hx, ms_scaling_factor=0.9))
    # an int8 head decodes in its own numerics: no fused pair
    assert not FusedBPPair.compatible(dec(code.hz, quantize="int8"),
                                      dec(code.hx, quantize="int8"))


@pytest.mark.parametrize("p", [0.03, 0.09])
def test_fuse_sectors_run_batch_equals_unfused(p):
    code = hgp(rep_code(4), rep_code(5))
    probs = np.full(code.N, 2 * p / 3)
    dx = BPDecoder(code.hz, probs, 20, device="cpu")
    dz = BPDecoder(code.hx, probs, 20, device="cpu")
    sims = [CodeSimulator_DataError(code, dx, dz, [p / 3] * 3,
                                    batch_size=96, device="cpu",
                                    fuse_sectors=fuse)
            for fuse in (True, False)]
    assert sims[0]._fused is not None and sims[1]._fused is None
    before = bk.bp_minsum.sector_launches
    for s in range(3):
        a, b = (sim.run_batch(prng_key(s)) for sim in sims)
        np.testing.assert_array_equal(a, b)
    assert sims[0].min_logical_weight == sims[1].min_logical_weight
    assert bk.bp_minsum.sector_launches == before  # the CPU runs the plain
    # an incompatible pair leaves run_batch as it was, and says so
    with pytest.warns(UserWarning, match="builds no FusedBPPair"):
        other = CodeSimulator_DataError(
            code, dx, BPDecoder(code.hx, probs, 21, device="cpu"),
            [p / 3] * 3, batch_size=96, device="cpu", fuse_sectors=True)
    assert other._fused is None

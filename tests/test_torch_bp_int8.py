"""Port int8 min-sum (``quantize="int8"``): the plain version of kernel B6
(``ops/bp_kernel.py`` ``minsum_int8_plain``), the two-phase decode and
``BPDecoder(quantize="int8")`` against the JAX package, and the int8 WER
contract.

Tolerances: none for the plain version and the decoders — the JAX package's
XLA twin ``_bp_head_sparse_xla(quantize="int8")`` and its int8 decoders are
matched bit for bit (error, converged, posterior, iterations), at the JAX
package's tiles.  The WER contract is the JAX package's
``int8_parity_tolerance`` (10% relative, at least 4 combined binomial
standard errors) between the port's int8 and float32 decoders."""
import os

import numpy as np
import pytest
import torch

import jax

from qldpc_fault_tolerance_tpu import decoders as jdec
from qldpc_fault_tolerance_tpu.ops import bp as jbp
from qldpc_fault_tolerance_tpu.ops import bp_pallas
from qldpc_fault_tolerance_tpu_torch.codes import hgp, load_code, rep_code
from qldpc_fault_tolerance_tpu_torch.decoders import (
    BP_Decoder_Class,
    BPDecoder,
    decode_device,
)
from qldpc_fault_tolerance_tpu_torch.ops import bp as tbp
from qldpc_fault_tolerance_tpu_torch.ops import bp_kernel as bk
from qldpc_fault_tolerance_tpu_torch.ops import gf2_kernel as gk
from qldpc_fault_tolerance_tpu_torch.sim import CodeSimulator_DataError

# one intra-op thread: the suite runs several pytest workers on few cores,
# and an oversubscribed torch thread pool stalls small ops
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _irregular_h(seed, m=24, n=48):
    """Row weights 2..6, so most rows have padded slots (as the JAX
    package's tests/test_bp_v2.py builds them)."""
    rng = np.random.default_rng(seed)
    h = np.zeros((m, n), np.uint8)
    for i in range(m):
        w = int(rng.integers(2, 7))
        h[i, rng.choice(n, size=w, replace=False)] = 1
    for j in np.nonzero(h.sum(0) == 0)[0]:
        h[rng.integers(0, m), j] = 1
    return h


def _n225():
    return load_code(os.path.join(REPO, "codes_lib_tpu", "hgp_34_n225.npz")).hx


def _syndromes(h, B, p, seed):
    rng = np.random.default_rng(seed)
    err = (rng.random((B, h.shape[1])) < p).astype(np.uint8)
    return (err @ h.T % 2).astype(np.uint8)


def _assert_bitexact(jax_res, port_res):
    for name, a, b in zip(("error", "converged", "posterior", "iterations"),
                          jax_res, port_res):
        a, b = np.asarray(a), b.numpy()
        if name == "posterior":
            assert np.array_equal(a.view(np.int32), b.view(np.int32)), name
        else:
            assert np.array_equal(a.astype(b.dtype), b), name


def _heads(h):
    graph = jbp.build_tanner_graph_host(h)
    return (bp_pallas.build_sparse_head(graph),
            bk.build_sparse_head(tbp.build_tanner_graph_host(h), "cpu"))


@pytest.mark.parametrize("early_stop", [False, True])
@pytest.mark.parametrize("block_b", [16, 64, 256, 512])
@pytest.mark.parametrize("code", ["irregular0", "irregular1", "hgp_34_n225"])
def test_plain_int8_bitexact_vs_jax_twin(code, block_b, early_stop):
    """Padded slots (irregular rows) and a real code; every tile size the
    two-phase decode uses, with and without early exit."""
    h = _n225() if code == "hgp_34_n225" else _irregular_h(int(code[-1]))
    p = 0.04 if code == "hgp_34_n225" else 0.05
    jsg, tsg = _heads(h)
    llr = np.array(jbp.llr_from_probs(np.full(h.shape[1], p)))
    synd = _syndromes(h, 512, p, block_b + 7 * early_stop)
    iters = 20 if code == "hgp_34_n225" else 16
    ref = bp_pallas._bp_head_sparse_xla(
        jsg, synd, llr, head_iters=iters, ms_scaling_factor=0.625,
        block_b=block_b, early_stop=early_stop, quantize="int8")
    got = bk.bp_head_int8(tsg, torch.from_numpy(synd), torch.from_numpy(llr),
                          head_iters=iters, block_b=block_b,
                          early_stop=early_stop)
    _assert_bitexact(ref, got)


def test_converged_shots_keep_their_tile_scales():
    """A tile half of whose shots converge at once (zero syndromes): their
    messages go on entering the tile's maxima.  Bit-exact with JAX, and the
    hard shots decode differently from the same shots in a tile of their
    own, so the converged shots' messages are what makes them agree."""
    h = _n225()
    jsg, tsg = _heads(h)
    llr = np.array(jbp.llr_from_probs(np.full(h.shape[1], 0.06)))
    hard = _syndromes(h, 64, 0.06, 11)
    mixed = np.concatenate([hard, np.zeros_like(hard)])
    ref = bp_pallas._bp_head_sparse_xla(
        jsg, mixed, llr, head_iters=30, ms_scaling_factor=0.625,
        block_b=128, early_stop=True, quantize="int8")
    got = bk.bp_head_int8(tsg, torch.from_numpy(mixed), torch.from_numpy(llr),
                          head_iters=30, block_b=128, early_stop=True)
    _assert_bitexact(ref, got)
    assert got[1][64:].all() and (got[3][64:] == 1).all()
    alone = bk.bp_head_int8(tsg, torch.from_numpy(hard), torch.from_numpy(llr),
                            head_iters=30, block_b=64, early_stop=True)
    assert not torch.equal(alone[2], got[2][:64])


def test_int8_rejects_a_ragged_batch():
    h = _irregular_h(0)
    _, tsg = _heads(h)
    synd = torch.zeros((96, h.shape[0]), dtype=torch.uint8)
    with pytest.raises(ValueError, match="multiple"):
        bk.bp_head_int8(tsg, synd, torch.ones(h.shape[1]), head_iters=3,
                        block_b=64)


def test_int8_layout_of_the_cluster():
    """Kernel B6's blocks: 32 shots each, a 512-shot tile a cluster of 16."""
    assert bk.int8_layout(256, 7, 300, 625) == (32, 8)
    assert bk.int8_layout(512, 7, 300, 625) == (32, 16)
    assert bk.int8_layout(16, 7, 300, 625) == (16, 1)
    with pytest.raises(ValueError, match="cluster"):
        bk.int8_layout(1024, 7, 300, 625)


@pytest.mark.parametrize("m,n,lanes,staged,fused_staged", [
    (300, 625, 32, True, True),      # hgp_34_n625
    (588, 1225, 32, True, False),    # hgp_34_n1225
    (768, 1600, 16, True, None),     # hgp_34_n1600: too large for fused int8
    (660, 1225, 32, False, None)])  # the index plane does not fit beside
def test_int8_layouts_fit_every_code(m, n, lanes, staged, fused_staged):
    """The int8 kernels' shared memory at row weight 7: B6 keeps 32 shots per
    block wherever their messages and totals fit, and stages the index
    plane only where it fits beside them; the fused int8 decode runs every
    code whose block fits without the plane (hgp_34_n1225 among them)."""
    assert bk.int8_layout(256, 7, m, n) == (lanes, 256 // lanes)
    assert bk.int8_staged(lanes, 7, m, n) is staged
    assert (bk.int8_smem_bytes(lanes, 7, m, n, staged) + bk._INT8_STATIC
            <= bk.SMEM_LIMIT)
    shape = (n, m, 7, m, 7)
    fits = (gk.fused_int8_smem_bytes(*shape) + gk._INT8_FUSED_STATIC
            <= bk.SMEM_LIMIT)
    assert fits is (fused_staged is not None)
    if fits:
        assert gk.fused_int8_staged(*shape) is fused_staged


def test_tile_rule_is_the_jax_packages():
    """max_block_b and the size gate copied exactly (analytic bytes)."""
    for h in (_irregular_h(0), _n225(),
              load_code(os.path.join(REPO, "codes_lib_tpu",
                                     "hgp_34_n625.npz")).hx):
        jsg, tsg = _heads(h)
        assert tsg.fits_vmem() == jsg.fits_vmem()
        assert tsg.fixed_overhead_bytes == jsg.fixed_overhead_bytes
        for b in (64, 96, 256, 512, 1024, 2048, 4096):
            for want in (256, 512):
                assert tsg.max_block_b(b, want) == jsg.max_block_b(b, want)


# the tiers: B/16 compacted tail, B/4 compacted tail, the deepened head
@pytest.mark.parametrize("B,p", [(512, 0.01), (512, 0.03), (1024, 0.02),
                                 (1024, 0.05)])
def test_int8_decoder_bitexact_vs_jax(B, p):
    """BPDecoder(quantize="int8") against the JAX package's, which routes to
    its bit-exact twin off the TPU: head at tile 256, tails at
    max_block_b(capacity) with sentinel rows, and the deepened head."""
    h = _n225()
    probs = np.full(h.shape[1], p)
    synd = _syndromes(h, B, p, int(p * 1000) + B)
    jd = jdec.BPDecoder(h, probs, 50, quantize="int8")
    je, jaux = jd.decode_batch_device(synd)
    td = BPDecoder(h, probs, 50, quantize="int8", device="cpu")
    assert td.device_static == jd.device_static
    te, taux = td.decode_batch_device(torch.from_numpy(synd))
    _assert_bitexact((je, jaux["converged"], jaux["posterior_llr"],
                      jaux["iterations"]),
                     (te, taux["converged"], taux["posterior_llr"],
                      taux["iterations"]))
    assert np.array_equal(td.decode_batch(synd), np.asarray(je))


def test_int8_decoder_covers_every_tier():
    """The parameters above reach both compaction tiers and the deepened
    head (straggler counts of the 3-iteration head)."""
    h = _n225()
    _, tsg = _heads(h)
    seen = set()
    for B, p in [(512, 0.01), (512, 0.03), (1024, 0.02), (1024, 0.05)]:
        synd = torch.from_numpy(_syndromes(h, B, p, int(p * 1000) + B))
        llr = tbp.llr_from_probs(np.full(h.shape[1], p), "cpu")
        bad = int((~bk.bp_head_int8(tsg, synd, llr, head_iters=3,
                                    block_b=256)[1]).sum())
        seen.add("B/16" if bad <= B // 16 else "B/4" if bad <= B // 4
                 else "deepened")
    assert seen == {"B/16", "B/4", "deepened"}


def test_int8_two_phase_vs_jax_and_f32_routes():
    """bp_decode_two_phase(head=, quantize="int8") against JAX's; outside
    the gate (B not a multiple of 256) both run float32 min-sum."""
    h = _n225()
    graph = jbp.build_tanner_graph(h)
    jsg, tsg = _heads(h)
    tgraph = tbp.build_tanner_graph(h, "cpu")
    llr = np.array(jbp.llr_from_probs(np.full(h.shape[1], 0.03)))
    for B in (512, 320):
        synd = _syndromes(h, B, 0.03, B)
        ref = jbp.bp_decode_two_phase(graph, synd, llr, max_iter=40,
                                      pallas_head=jsg, quantize="int8")
        got = tbp.bp_decode_two_phase(tgraph, torch.from_numpy(synd),
                                      torch.from_numpy(llr), max_iter=40,
                                      head=tsg, quantize="int8", device="cpu")
        _assert_bitexact(ref, got)
    f32 = tbp.bp_decode(tgraph, torch.from_numpy(synd), torch.from_numpy(llr),
                        max_iter=40, device="cpu")
    for a, b in zip(got, f32):
        assert torch.equal(a, b)


def test_int8_factory_and_errors():
    h = _irregular_h(0)
    params = {"h": h, "p_data": 0.05}
    dec = BP_Decoder_Class(1, "minimum_sum", 0.625, quantize="int8",
                           device="cpu").GetDecoder(params)
    assert dec.device_static[5] == "v2_int8" and dec.quantize == "int8"
    # without quantize a CPU decoder has no head (float32, as JAX off its TPU)
    assert BP_Decoder_Class(1, "ms", 0.625, device="cpu").GetDecoder(
        params).device_static[5] == "none"
    probs = np.full(h.shape[1], 0.05)
    with pytest.raises(ValueError, match="requires the v2 kernel"):
        BPDecoder(h, probs, 10, quantize="int8", bp_kernel="v1", device="cpu")
    with pytest.raises(ValueError, match="min-sum"):
        BPDecoder(h, probs, 10, bp_method="product_sum", quantize="int8",
                  device="cpu")
    with pytest.raises(ValueError, match="unknown quantize"):
        BPDecoder(h, probs, 10, quantize="int4", device="cpu")


def test_fused_v2_with_int8_decoders_raises():
    """fused_sampler="v2" with int8 decoders runs the fused decode's int8
    mode (its results against the JAX package: tests/test_torch_fused.py
    and test_torch_fused_v2.py); mixed quantize between the sectors raises
    ValueError, as in the JAX package; fused v1 runs."""
    code = hgp(rep_code(3), rep_code(3))
    probs = np.full(code.N, 0.05)

    def sim(qx, qz, fused):
        return CodeSimulator_DataError(
            code=code,
            decoder_x=BPDecoder(code.hz, probs, 20, quantize=qx, device="cpu"),
            decoder_z=BPDecoder(code.hx, probs, 20, quantize=qz, device="cpu"),
            pauli_error_probs=[0.05 / 3] * 3, seed=3, batch_size=256,
            fused_sampler=fused, device="cpu")

    v2 = sim("int8", "int8", "v2")
    wer, _ = v2.WordErrorRate(512)
    assert 0.0 < wer < 1.0 and v2.last_shots == 512
    with pytest.raises(ValueError, match="quantize"):
        sim("int8", None, "v2")
    wer, _ = sim("int8", "int8", True).WordErrorRate(512)
    assert 0.0 <= wer < 1.0


@pytest.mark.parametrize("d", [3, 4])
def test_int8_wer_parity_contract(d):
    """The port's int8 decoders' WER matches its float32 decoders' within
    int8_parity_tolerance on the hgp_rep parity cells (the JAX package's
    tests/test_bp_v2.py cell: p=0.06, BP-20, 4096 shots, batch 512)."""
    code = hgp(rep_code(d), rep_code(d))
    p, shots = 0.06, 4096

    def run(quantize):
        probs = np.full(code.N, p)
        sim = CodeSimulator_DataError(
            code=code,
            decoder_x=BPDecoder(code.hz, probs, 20, quantize=quantize,
                                device="cpu"),
            decoder_z=BPDecoder(code.hx, probs, 20, quantize=quantize,
                                device="cpu"),
            pauli_error_probs=[p / 3] * 3, batch_size=512, seed=11,
            scan_chunk=4, device="cpu")
        return sim.WordErrorRate(shots)[0]

    wer_f32, wer_int8 = run(None), run("int8")
    tol = bk.int8_parity_tolerance(wer_f32, shots)
    assert tol == bp_pallas.int8_parity_tolerance(wer_f32, shots)
    assert abs(wer_int8 - wer_f32) <= tol, (wer_int8, wer_f32, tol)


def test_int8_decode_device_counts_no_launch_on_the_cpu():
    h = _n225()
    dec = BPDecoder(h, np.full(h.shape[1], 0.02), 50, quantize="int8",
                    device="cpu")
    before = bk.bp_head_int8.launches
    decode_device(dec.device_static, dec.device_state,
                  torch.from_numpy(_syndromes(h, 256, 0.02, 1)))
    assert bk.bp_head_int8.launches == before
    assert dec.kernel_variant == "xla_twin"
    assert jax.default_backend() == "cpu"

"""Port ops/bp.py (and the plain version of the min-sum kernel) against the
JAX package's ``bp_decode`` / ``bp_decode_two_phase`` on the CPU.

Syndromes come from numpy errors made from a seed; both packages decode the
same arrays.  Tolerances:
  * min-sum: ``error``/``converged``/``iterations`` identical and posteriors
    within rtol 1e-5, except on near-tie shots (some JAX posterior
    |LLR| < 1e-3 — summation order may flip a hard decision there); none
    are expected, and at most 1% of shots may be near-ties;
  * product-sum: the same with rtol 1e-3 on posteriors (tanh/atanh differ
    in the last bits between XLA and PyTorch, and 20 iterations compound
    it: measured up to 2.8e-4);
  * the bf16 TPU kernel (interpret mode): bounded agreement only, since
    bf16 messages round differently from f32 ones.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qldpc_fault_tolerance_tpu.ops import bp as jbp
from qldpc_fault_tolerance_tpu.ops import bp_pallas
from qldpc_fault_tolerance_tpu_torch.codes import hgp, load_code, ring_code
from qldpc_fault_tolerance_tpu_torch.ops import bp as tbp
from qldpc_fault_tolerance_tpu_torch.ops import bp_kernel

# one intra-op thread: the suite runs several pytest workers on few cores,
# and an oversubscribed torch thread pool stalls small ops
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 256


def _code(name):
    if name == "hgp_34_n225":
        return load_code(os.path.join(REPO, "codes_lib_tpu", "hgp_34_n225.npz"))
    return hgp(ring_code(5), ring_code(5))


def _case(name, p, seed=7):
    h = _code(name).hx
    n = h.shape[1]
    rng = np.random.default_rng(seed)
    err = (rng.random((B, n)) < 2 * p / 3).astype(np.uint8)
    synd = (err @ h.T % 2).astype(np.uint8)
    return h, synd, np.full(n, 2 * p / 3)


def _assert_same(jres, tres, rtol):
    j = [np.asarray(x) for x in jres]
    t = [x.numpy() for x in tres]
    tie = (np.abs(j[2]) < 1e-3).any(axis=1)
    assert tie.mean() <= 0.01
    ok = ~tie
    assert np.array_equal(j[0][ok], t[0][ok])
    assert np.array_equal(j[1][ok], t[1][ok])
    assert np.array_equal(j[3][ok], t[3][ok])
    np.testing.assert_allclose(t[2][ok], j[2][ok], rtol=rtol, atol=1e-6)


@pytest.mark.parametrize("name", ["hgp_34_n225", "ring5"])
def test_tanner_graph_matches_jax(name):
    h = _code(name).hx
    jg = jbp.build_tanner_graph_host(h)
    tg = tbp.build_tanner_graph(h, "cpu")
    for field in jbp.TannerGraph._fields:
        assert np.array_equal(np.asarray(getattr(jg, field)),
                              getattr(tg, field).numpy()), field
    assert np.array_equal(np.asarray(jbp.llr_from_probs(np.full(5, 0.03))),
                          tbp.llr_from_probs(np.full(5, 0.03), "cpu").numpy())


@pytest.mark.parametrize("p", [0.02, 0.05])
@pytest.mark.parametrize("name", ["hgp_34_n225", "ring5"])
def test_minsum_bp_decode_matches_jax(name, p):
    h, synd, probs = _case(name, p)
    jres = jbp.bp_decode(jbp.build_tanner_graph(h), jnp.asarray(synd),
                         jbp.llr_from_probs(probs), max_iter=50)
    graph = tbp.build_tanner_graph(h, "cpu")
    llr = tbp.llr_from_probs(probs, "cpu")
    tres = tbp.bp_decode(graph, synd, llr, max_iter=50, device="cpu")
    _assert_same(jres, tres, rtol=1e-5)
    # converged shots satisfy their syndrome exactly
    conv = tres.converged.numpy()
    par = tres.error.numpy().astype(np.int64) @ h.T % 2
    assert np.array_equal(par[conv], synd[conv])
    jtwo = jbp.bp_decode_two_phase(jbp.build_tanner_graph(h), jnp.asarray(synd),
                                   jbp.llr_from_probs(probs), max_iter=50)
    ttwo = tbp.bp_decode_two_phase(graph, synd, llr, max_iter=50, device="cpu")
    _assert_same(jtwo, ttwo, rtol=1e-5)


def test_product_sum_matches_jax():
    h, synd, probs = _case("ring5", 0.05)
    jres = jbp.bp_decode(jbp.build_tanner_graph(h), jnp.asarray(synd),
                         jbp.llr_from_probs(probs), max_iter=20,
                         method="product_sum")
    tres = tbp.bp_decode(tbp.build_tanner_graph(h, "cpu"), synd,
                         tbp.llr_from_probs(probs, "cpu"), max_iter=20,
                         method="product_sum", device="cpu")
    _assert_same(jres, tres, rtol=1e-3)


@pytest.mark.parametrize("tail_capacity", [4, 16, 40, None])
def test_two_phase_tiers_equal_full_decode(tail_capacity):
    """Every tier (compacted, 4x, deepened head, full) gives each shot the
    result of the full-batch decode; the tier costs one or two host reads."""
    h, synd, probs = _case("hgp_34_n225", 0.05, seed=3)
    graph = tbp.build_tanner_graph(h, "cpu")
    llr = tbp.llr_from_probs(probs, "cpu")
    full = tbp.bp_decode(graph, synd, llr, max_iter=50, device="cpu")
    reads = tbp.bp_decode_two_phase.host_reads
    two = tbp.bp_decode_two_phase(graph, synd, llr, max_iter=50,
                                  tail_capacity=tail_capacity, device="cpu")
    assert tbp.bp_decode_two_phase.host_reads - reads in (1, 2)
    for a, b in zip(full, two):
        assert torch.equal(a, b)


def test_per_shot_llr_matches_shared_llr():
    h, synd, probs = _case("ring5", 0.05)
    graph = tbp.build_tanner_graph(h, "cpu")
    llr = tbp.llr_from_probs(probs, "cpu")
    shared = tbp.bp_decode(graph, synd, llr, max_iter=30, device="cpu")
    per_shot = tbp.bp_decode(graph, synd, llr.expand(B, -1), max_iter=30,
                             device="cpu")
    for a, b in zip(shared, per_shot):
        assert torch.equal(a, b)


@pytest.mark.parametrize("p", [0.02, 0.05])
def test_bounded_agreement_with_bf16_tpu_kernel(p):
    """The TPU kernel stores bf16 messages; run in interpret mode as the JAX
    package's tests run it.  Bounds: converged flags agree on >= 95% of
    shots, converged fractions differ by <= 0.05, and shots both decoders
    converged give the same hard decision on >= 95% of them."""
    h, synd, probs = _case("hgp_34_n225", p)
    sg = bp_pallas.build_sparse_head(jbp.build_tanner_graph_host(h))
    k = bp_pallas.bp_head_sparse(sg, jnp.asarray(synd),
                                 jbp.llr_from_probs(probs), head_iters=50,
                                 block_b=64, interpret=True)
    k = [np.asarray(x) for x in k]
    t = bp_kernel.bp_minsum(tbp.build_tanner_graph(h, "cpu"),
                            torch.from_numpy(synd),
                            tbp.llr_from_probs(probs, "cpu"), max_iter=50)
    t = [x.numpy() for x in t]
    assert (k[1] == t[1]).mean() >= 0.95
    assert abs(k[1].mean() - t[1].mean()) <= 0.05
    both = k[1] & t[1]
    assert (k[0][both] == t[0][both]).all(axis=1).mean() >= 0.95

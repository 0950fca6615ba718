"""Port v1 head (``QLDPC_BP_KERNEL=v1``, a PallasHeadGraph): the plain
version of the bf16 head (``ops/bp_kernel.py`` ``minsum_dense_plain``, the
loop over the dense one-hot stack) and the v1 two-phase decode against the
JAX package.

Tolerances: none against the JAX package's v1 kernel ``bp_head_pallas`` run
in interpret mode and its v1 two-phase decode — every output bit-exact.
Against the XLA twin ``bp_head_sparse(backend="xla")`` every hard output
is bit-exact, and so is every posterior except those of shots where a
slot's float32 scatter-sum (the sum of up to cw bf16 messages onto one
variable) was not exact: the twin adds those terms in another order.  The
test names that operation: it records, per shot, the inexact scatter-sums
of the port's rank-ordered sum and requires every differing shot to have
one."""
import os

import numpy as np
import pytest
import torch

import jax

from qldpc_fault_tolerance_tpu.codes import hgp as jhgp
from qldpc_fault_tolerance_tpu.codes import rep_code as jrep_code
from qldpc_fault_tolerance_tpu.ops import bp as jbp
from qldpc_fault_tolerance_tpu.ops import bp_pallas
from qldpc_fault_tolerance_tpu_torch.codes import load_code
from qldpc_fault_tolerance_tpu_torch.decoders import BPDecoder, decode_device
from qldpc_fault_tolerance_tpu_torch.ops import bp as tbp
from qldpc_fault_tolerance_tpu_torch.ops import bp_kernel as bk

# one intra-op thread: the suite runs several pytest workers on few cores,
# and an oversubscribed torch thread pool stalls small ops
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _irregular_h(seed, m=24, n=48):
    """Row weights 2..6, so most rows have padded slots."""
    rng = np.random.default_rng(seed)
    h = np.zeros((m, n), np.uint8)
    for i in range(m):
        h[i, rng.choice(n, size=int(rng.integers(2, 7)), replace=False)] = 1
    for j in np.nonzero(h.sum(0) == 0)[0]:
        h[rng.integers(0, m), j] = 1
    return h


def _code(name):
    return load_code(os.path.join(REPO, "codes_lib_tpu", f"{name}.npz")).hx


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
    return (bp_pallas.build_pallas_head(jbp.build_tanner_graph_host(h)),
            bk.build_pallas_head(tbp.build_tanner_graph_host(h), "cpu"))


@pytest.mark.parametrize("head_iters,early_stop", [(3, False), (12, False),
                                                   (12, True)])
def test_plain_dense_bitexact_vs_v1_interpret(head_iters, early_stop):
    """hgp(rep_code(4), rep_code(5)), as the JAX package's
    tests/test_bp_pallas.py drives its v1 kernel."""
    h = jhgp(jrep_code(4), jrep_code(5)).hx
    jpg, tpg = _heads(h)
    llr = np.array(jbp.llr_from_probs(np.full(h.shape[1], 0.04)))
    synd = _syndromes(h, 128, 0.04, head_iters)
    ref = bp_pallas.bp_head_pallas(jpg, synd, llr, head_iters=head_iters,
                                   block_b=64, early_stop=early_stop,
                                   interpret=True)
    got = bk.bp_head_bf16(tpg, torch.from_numpy(synd), torch.from_numpy(llr),
                           head_iters=head_iters, early_stop=early_stop)
    _assert_bitexact(ref, got)


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_dense_bitexact_on_padded_slots(seed):
    h = _irregular_h(seed)
    jpg, tpg = _heads(h)
    llr = np.array(jbp.llr_from_probs(np.full(h.shape[1], 0.05)))
    synd = _syndromes(h, 128, 0.05, seed)
    ref = bp_pallas.bp_head_pallas(jpg, synd, llr, head_iters=16, block_b=64,
                                   interpret=True)
    got = bk.bp_head_bf16(tpg, torch.from_numpy(synd), torch.from_numpy(llr),
                           head_iters=16)
    _assert_bitexact(ref, got)


@pytest.fixture(scope="module")
def n225_run():
    """hgp_34_n225, 256 shots, 50 iterations: the port's plain dense decode
    with the shots whose rank-ordered scatter-sums rounded, the JAX v1
    kernel (interpret mode) and the JAX XLA twin."""
    h = _code("hgp_34_n225")
    jpg, tpg = _heads(h)
    sg = bp_pallas.build_sparse_head(jbp.build_tanner_graph_host(h))
    llr = np.array(jbp.llr_from_probs(np.full(h.shape[1], 0.04)))
    synd = _syndromes(h, 256, 0.04, 5)
    rounded = torch.zeros(256, dtype=torch.bool)
    add = bk._add_rank

    def recording_add(part, prod):
        out = add(part, prod)
        rounded.logical_or_((part.double() + prod.double() != out.double())
                            .any(dim=0))
        return out

    bk._add_rank = recording_add
    try:
        got = bk.bp_head_bf16(tpg, torch.from_numpy(synd),
                               torch.from_numpy(llr), head_iters=50)
    finally:
        bk._add_rank = add
    v1 = bp_pallas.bp_head_pallas(jpg, synd, llr, head_iters=50, block_b=256,
                                  interpret=True)
    twin = bp_pallas.bp_head_sparse(sg, synd, llr, head_iters=50,
                                    block_b=256, backend="xla")
    return got, v1, twin, rounded


def test_plain_dense_bitexact_vs_v1_interpret_n225(n225_run):
    got, v1, _, rounded = n225_run
    _assert_bitexact(v1, got)
    assert rounded.any()  # the order of the scatter-sums matters here


def test_plain_dense_vs_xla_twin_n225(n225_run):
    """Hard outputs bit-exact; a posterior differs only on a shot whose
    scatter-sum rounded (the twin sums in another order)."""
    got, _, twin, rounded = n225_run
    for a, b in ((twin[0], got[0]), (twin[1], got[1]), (twin[3], got[3])):
        assert np.array_equal(np.asarray(a).astype(b.numpy().dtype), b.numpy())
    post_t, post_p = np.asarray(twin[2]), got[2].numpy()
    differ = (post_t.view(np.int32) != post_p.view(np.int32)).any(axis=1)
    named = rounded.numpy()
    assert not (differ & ~named).any(), (
        f"shots {np.nonzero(differ & ~named)[0].tolist()} differ without an "
        f"inexact scatter-sum")


def test_v1_two_phase_decode_vs_jax(monkeypatch):
    """The v1 two-phase decode against JAX's bp_decode_two_phase with a
    PallasHeadGraph head.  JAX's v1 head engages only on a TPU, so the
    test runs its kernel in interpret mode (bp_head_pallas wrapped here,
    nothing in the JAX package changes)."""
    code = jhgp(jrep_code(4), jrep_code(5))
    h = code.hx
    jpg, tpg = _heads(h)
    p = 0.05
    llr = np.array(jbp.llr_from_probs(np.full(h.shape[1], p)))
    synd = _syndromes(h, 256, p, 9)
    kernel = bp_pallas.bp_head_pallas

    def interpret(*args, **kw):
        return kernel(*args, **dict(kw, interpret=True))

    monkeypatch.setattr(bp_pallas, "bp_head_pallas", interpret)
    ref = jbp.bp_decode_two_phase(jbp.build_tanner_graph(h), synd, llr,
                                  max_iter=20, pallas_head=jpg)
    got = tbp.bp_decode_two_phase(tbp.build_tanner_graph(h, "cpu"),
                                  torch.from_numpy(synd),
                                  torch.from_numpy(llr), max_iter=20,
                                  head=tpg, device="cpu")
    _assert_bitexact(ref, got)
    # the CPU decodes in float32 whatever the tag, as JAX off its TPU; the
    # "v1" program with its head is the card's
    dec = BPDecoder(h, np.full(h.shape[1], p), 20, bp_kernel="v1",
                    device="cpu")
    assert dec.device_static[5] == "none"
    err, aux = decode_device(dec.device_static[:5] + ("v1",),
                             dict(dec.device_state, pallas=tpg),
                             torch.from_numpy(synd))
    _assert_bitexact(ref, (err, aux["converged"], aux["posterior_llr"],
                           aux["iterations"]))
    assert jax.default_backend() == "cpu"


def test_dense_head_of_hgp_34_n625_fits_the_jax_gate():
    h = _code("hgp_34_n625")
    jpg, tpg = _heads(h)
    assert tpg.scat_bytes == jpg.scat_bytes and tpg.fits_vmem()
    assert tpg.max_block_b(4096, 256) == jpg.max_block_b(4096, 256) == 256
    stack = bk.dense_stack(tpg)
    assert torch.equal(stack.scat.float(),
                       torch.from_numpy(np.asarray(jpg.scat, np.float32)))
    assert int(stack.rank.max()) == 3

"""Whether a served shot's answer may depend on the other rows of its
round: the JAX package's two-phase BP with its v2 head against the port's,
on the same straggler rows at two groupings, on the CPU.

The same 64 rows of hgp_34_n225 at p = 0.06 are decoded in two rounds of
512: once beside 448 zero syndromes (few stragglers: the compacted tail
tier, which runs in the head's kernel, bf16 messages), once beside 448
more noisy rows (the tiers overflow: the deepened head, then the
full-batch float32 decode).  The JAX package's ``bp_decode_two_phase``
with its v2 head (``bp_head_sparse`` in interpret mode, as its own tests
run Pallas on the CPU) answers some of the 64 rows differently in the two
rounds, and the port's plain path (``bp_head_bf16`` through the port's
``bp_decode_two_phase``) gives the JAX answer bit for bit in each round.
So the dependence on grouping is the JAX package's semantics (its tier
choice picks the numerics), which the port keeps, not a port fault.

Tolerance: none (bit-exact between the packages in each round).
"""
import os

import numpy as np
import torch

from qldpc_fault_tolerance_tpu.ops import bp as jbp
from qldpc_fault_tolerance_tpu.ops import bp_pallas
from qldpc_fault_tolerance_tpu_torch.codes import load_code
from qldpc_fault_tolerance_tpu_torch.ops import bp as tbp
from qldpc_fault_tolerance_tpu_torch.ops import bp_kernel as bk

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_two_phase_tier_choice_changes_answers_in_jax_and_port_alike(
        monkeypatch):
    h = load_code(os.path.join(REPO, "codes_lib_tpu", "hgp_34_n225.npz")).hx
    p, max_iter, B, k = 0.06, 50, 512, 64
    llr = np.array(jbp.llr_from_probs(np.full(h.shape[1], p)))
    rng = np.random.default_rng(5)
    err = (rng.random((B + k, h.shape[1])) < p).astype(np.uint8)
    noisy = (err @ h.T % 2).astype(np.uint8)
    rows = noisy[:k]
    quiet = np.concatenate([rows, np.zeros((B - k, h.shape[0]), np.uint8)])
    busy = np.concatenate([rows, noisy[k:B]])
    sparse = bp_pallas.bp_head_sparse

    def interpret(*args, **kw):
        return sparse(*args, **dict(kw, interpret=True))

    monkeypatch.setattr(bp_pallas, "bp_head_sparse", interpret)
    jsg = bp_pallas.build_sparse_head(jbp.build_tanner_graph_host(h))
    jg = jbp.build_tanner_graph(h)
    tg = tbp.build_tanner_graph_host(h)
    head, tgc = bk.build_sparse_head(tg, "cpu"), tbp.graph_to(tg, "cpu")

    def decode(synd):
        ref = jbp.bp_decode_two_phase(jg, synd, llr, max_iter=max_iter,
                                      pallas_head=jsg)
        got = tbp.bp_decode_two_phase(tgc, torch.from_numpy(synd),
                                      torch.from_numpy(llr),
                                      max_iter=max_iter, head=head,
                                      device="cpu")
        ref_err = np.asarray(ref.error)
        assert np.array_equal(ref_err, got.error.numpy())
        assert np.array_equal(np.asarray(ref.converged),
                              got.converged.numpy())
        return ref_err[:k]

    # the quiet round's stragglers fit the smallest tail tier, the busy
    # round's overflow the largest one
    head3 = jbp.bp_decode(jg, busy, llr, max_iter=3)
    assert int((~np.asarray(head3.converged)).sum()) > 4 * (B // 16)
    differ = (decode(quiet) != decode(busy)).any(axis=1)
    assert 0 < differ.sum() < k

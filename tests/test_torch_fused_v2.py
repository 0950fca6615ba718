"""The port's fused decode (``fused_sampler="v2"``) in both message modes
against the JAX package, on the CPU.

  * The plain ``fused_decode_stats`` (bf16 messages, and int8 at every
    tile of the block_w ladder) against the JAX package's
    ``fused_decode_stats(backend="xla")``, its XLA twin, on hgp_rep3 and
    hgp_34_n225: failure count, min weight and every shot's converged flag
    and iterations in both sectors identical.  On hgp_rep3 also against the
    JAX package's Pallas kernel in interpret mode, as its own
    ``tests/test_bp_v2.py`` runs it.  Tolerance: none.
  * The tile rule (``fused_decode_block_w``) equals the JAX package's over
    codes and batch sizes, and a batch that is not a multiple of the tile
    raises ``ValueError`` in both packages.
"""
import os

import numpy as np
import pytest
import torch

import jax

from qldpc_fault_tolerance_tpu.ops import bp as jbp
from qldpc_fault_tolerance_tpu.ops import gf2_pallas as gp
from qldpc_fault_tolerance_tpu_torch.codes import hgp, load_code, rep_code
from qldpc_fault_tolerance_tpu_torch.ops import bp_kernel as bk
from qldpc_fault_tolerance_tpu_torch.ops import gf2_kernel as gk

# one intra-op thread: the suite runs several pytest workers on few cores,
# and an oversubscribed torch thread pool stalls small ops
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, P, ITERS = 256, 0.05, 20


def _code(name):
    if name == "rep3":
        return hgp(rep_code(3), rep_code(3))
    return load_code(os.path.join(REPO, "codes_lib_tpu", f"{name}.npz"))


def _specs(code, p=P):
    """Both packages' specs, with different, non-uniform channel LLRs per
    sector (min-sum is blind to a uniform scale)."""
    rng = np.random.default_rng(code.N)
    llr_x, llr_z = (np.asarray(jbp.llr_from_probs(
        rng.uniform(p / 4, p, code.N))) for _ in range(2))
    args = (code.hx, code.hz, code.lx, code.lz, [p / 3] * 3, llr_x, llr_z)
    return gp.build_fused_decode_spec(*args), gk.build_fused_decode_spec(
        *args, "cpu")


@pytest.fixture(scope="module", params=["rep3", "hgp_34_n225"])
def specs(request):
    return request.param, _specs(_code(request.param))


def _keys(seed):
    return (jax.random.fold_in(jax.random.PRNGKey(seed), 3),
            gk.fold_in(gk.prng_key(seed), 3))


def _assert_same(want, got):
    """count, min weight, and per shot converged and iterations of both
    sectors."""
    assert (int(got[0]), int(got[1])) == (int(want[0]), int(want[1]))
    for sector, w, g in (("x", want[2], got[2]), ("z", want[3], got[3])):
        for field in ("converged", "iterations"):
            assert np.array_equal(np.asarray(w[field]), g[field].numpy()), (
                sector, field)


MODES = [(None, None), ("int8", 1), ("int8", 2), ("int8", 4), ("int8", 8)]


@pytest.mark.parametrize("quantize,block_w", MODES,
                         ids=["bf16", "int8-w1", "int8-w2", "int8-w4",
                              "int8-w8"])
def test_fused_decode_matches_jax_twin(specs, quantize, block_w):
    name, (jspec, tspec) = specs
    jkey, tkey = _keys(11)
    kw = dict(eval_type="Total", max_iter_z=ITERS, max_iter_x=ITERS,
              quantize=quantize, block_w=block_w)
    got = gk.fused_decode_stats(tspec, tkey, B, **kw)
    want = gp.fused_decode_stats(jspec, jkey, B, backend="xla", **kw)
    assert 0 < int(want[0]) < B
    _assert_same(want, got)
    assert not got[3]["converged"].all()  # the loops ran to max_iter too


@pytest.mark.parametrize("quantize", [None, "int8"], ids=["bf16", "int8"])
@pytest.mark.parametrize("eval_type", ["X", "Z"])
def test_fused_decode_eval_types_and_default_tile(specs, quantize, eval_type):
    """The tile rule's block_w (8 at B=256) and one-sector counts."""
    name, (jspec, tspec) = specs
    jkey, tkey = _keys(12)
    kw = dict(eval_type=eval_type, max_iter_z=ITERS, max_iter_x=ITERS,
              quantize=quantize)
    _assert_same(gp.fused_decode_stats(jspec, jkey, B, backend="xla", **kw),
                 gk.fused_decode_stats(tspec, tkey, B, **kw))


@pytest.mark.parametrize("quantize", [None, "int8"], ids=["bf16", "int8"])
def test_fused_decode_matches_jax_kernel_interpret_rep3(quantize):
    jspec, tspec = _specs(_code("rep3"))
    jkey, tkey = _keys(13)
    kw = dict(eval_type="Total", max_iter_z=ITERS, max_iter_x=ITERS,
              quantize=quantize, block_w=8)
    want = gp.fused_decode_stats(jspec, jkey, B, backend="pallas",
                                 interpret=True, **kw)
    _assert_same(want, gk.fused_decode_stats(tspec, tkey, B, **kw))


def test_bf16_loop_sums_in_slot_then_check_order():
    """``slot_ordered_graph`` keeps every edge, sorts each variable's list by
    (slot, check), and its cross slots still name each edge."""
    from qldpc_fault_tolerance_tpu_torch.ops.bp import build_tanner_graph_host

    g = build_tanner_graph_host(_code("hgp_34_n225").hx)
    s = bk.slot_ordered_graph(g)
    for j in range(g.var_nbr.shape[0]):
        before = {(int(i), int(t)) for i, t, v in zip(
            g.var_nbr[j], g.var_nbr_slot[j], g.var_mask[j]) if v}
        after = [(int(t), int(i)) for i, t, v in zip(
            s.var_nbr[j], s.var_nbr_slot[j], s.var_mask[j]) if v]
        assert after == sorted(after)
        assert {(i, t) for t, i in after} == before
    i, slot = np.nonzero(s.chk_mask)
    assert np.array_equal(s.var_nbr[s.chk_nbr[i, slot], s.chk_nbr_slot[i, slot]], i)


def _irregular_h(seed=3, m=24, n=48):
    rng = np.random.default_rng(seed)
    h = np.zeros((m, n), np.uint8)
    for i in range(m):
        h[i, rng.choice(n, size=int(rng.integers(2, 9)), replace=False)] = 1
    for j in np.nonzero(h.sum(0) == 0)[0]:
        h[rng.integers(0, m), j] = 1
    return h


@pytest.mark.parametrize("name", ["rep3", "hgp_34_n225", "hgp_34_n625",
                                  "hgp_34_n1600", "irregular"])
def test_tile_rule_matches_jax(name):
    if name == "irregular":
        hx, hz = _irregular_h(3), _irregular_h(4)
        lx = lz = np.eye(1, 48, dtype=np.uint8)
    else:
        c = _code(name)
        hx, hz, lx, lz = c.hx, c.hz, c.lx, c.lz
    llr = np.ones(hx.shape[1], np.float32)
    args = (hx, hz, lx, lz, [0.01] * 3, llr, llr)
    jspec, tspec = gp.build_fused_decode_spec(*args), gk.build_fused_decode_spec(
        *args, "cpu")
    statics = gp._decode_statics(jspec)
    assert tspec.statics == tuple(statics[k] for k in ("n", "mx", "mz", "rwz",
                                                       "rwx"))
    for batch in (32, 64, 96, 200, 256, 768, 1024, 4096, 8192, 65536):
        for quantize in (None, "int8"):
            assert gk.fused_decode_block_w(tspec, batch, quantize=quantize) == \
                gp.fused_decode_block_w(jspec, batch, quantize=quantize), (
                batch, quantize)
    for bw in (1, 2, 4, 8, 16):
        for quantize in (None, "int8"):
            assert gk.estimate_fused_decode_bytes(
                *tspec.statics, bw, quantize=quantize) == \
                gp.estimate_fused_decode_bytes(*tspec.statics, bw,
                                               quantize=quantize)


@pytest.mark.parametrize("batch,block_w", [(200, None), (96, 2), (256, 16)])
def test_untileable_batch_raises_in_both(batch, block_w):
    jspec, tspec = _specs(_code("rep3"))
    jkey, tkey = _keys(1)
    kw = dict(max_iter_z=5, max_iter_x=5, block_w=block_w)
    with pytest.raises(ValueError, match="divisible by"):
        gp.fused_decode_stats(jspec, jkey, batch, backend="xla", **kw)
    for quantize in (None, "int8"):
        with pytest.raises(ValueError, match="divisible by"):
            gk.fused_decode_stats(tspec, tkey, batch, quantize=quantize, **kw)
    with pytest.raises(ValueError, match="quantize"):
        gk.fused_decode_stats(tspec, tkey, 256, max_iter_z=5, max_iter_x=5,
                              quantize="int4")

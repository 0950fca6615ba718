"""Row weights 33-64 in the min-sum kernels (csrc/bp_minsum.cu's wide
instances: kernel 1 and the bf16 head with 64-bit slot masks), checked on
the CPU.

The detector error model of the circuit-level space-time engine gives
window matrices whose rows are wider than 32 (``h1`` 900 x 9600 with row
weight 59 and ``h2`` 300 x 1825 with row weight 40 at hgp_34_n625; 61 and
42 at hgp_34_n225).  Held here: which instance a row weight takes and the
refusal above 64, the layouts and staged planes at those shapes (byte
counts worked out by hand from csrc/bp_minsum.cu's Offsets), and the plain
versions, which take any row weight, against the JAX package on ``h2`` of
hgp_34_n225 (row weight 42): kernel 1's plain version against JAX's
float32 min-sum (tolerances of tests/test_torch_bp.py: bit-exact hard
outputs and posteriors within rtol 1e-5 outside near-tie shots, at most 1%
of them), the bf16 head's against JAX's v1 head kernel in interpret mode
(bit-exact).

The int8 head (B6) and the fused decode (B5, both modes) take the same
rows through their own wide instances: ``int8_layout`` and the fused
decode's gates accept row weights 33..64 and refuse 65; B6's plain version
equals the JAX package's int8 XLA twin bit for bit on ``h2`` of
hgp_34_n225 (tighter than the int8 contract, ``int8_parity_tolerance``),
and B5's plain version equals the JAX package's fused XLA twin, seed for
seed, on a hypergraph product whose rows reach 40.  The kernels themselves
run in tests/test_torch_minsum_wide_cuda.py on the card."""
import functools

import numpy as np
import pytest
import torch

import jax

from qldpc_fault_tolerance_tpu.ops import bp as jbp
from qldpc_fault_tolerance_tpu.ops import bp_pallas
from qldpc_fault_tolerance_tpu.ops import gf2_pallas as gp
from qldpc_fault_tolerance_tpu_torch.codes import hgp, load_code
from qldpc_fault_tolerance_tpu_torch.ops import bp as tbp
from qldpc_fault_tolerance_tpu_torch.ops import bp_kernel as bk
from qldpc_fault_tolerance_tpu_torch.ops import gf2_kernel as gk
from qldpc_fault_tolerance_tpu_torch.sim import CodeSimulator_Circuit_SpaceTime

torch.set_num_threads(1)

SMS = 132  # an H100 SXM's SMs


@pytest.mark.parametrize("rw", [1, 7, 32, 33, 40, 59, 64])
def test_row_weight_picks_the_instance(rw):
    assert bk.minsum_wide(rw) == (rw > 32)


@pytest.mark.parametrize("rw", [0, 65, 128])
def test_row_weights_outside_1_to_64_are_refused(rw):
    with pytest.raises(ValueError, match="1..64"):
        bk.minsum_wide(rw)
    with pytest.raises(ValueError, match="1..64"):
        bk.minsum_layout(256, 100, 400, rw, 4, False, SMS)


def _graph(m, n, rw, seed):
    """A random H with row weights up to ``rw`` (row 0 exactly ``rw``)."""
    rng = np.random.default_rng(seed)
    h = np.zeros((m, n), np.uint8)
    for i in range(m):
        w = rw if i == 0 else int(rng.integers(rw // 2, rw + 1))
        h[i, rng.choice(n, w, replace=False)] = 1
    return h


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_launches_above_64_raise_before_the_kernel(bf16):
    h = _graph(20, 200, 65, 0)
    synd = torch.zeros((4, 20), dtype=torch.uint8)
    llr = torch.ones(200, dtype=torch.float32)
    g = tbp.build_tanner_graph_host(h)
    if bf16:
        with pytest.raises(ValueError, match="above 64"):
            bk._launch_bf16(bk.build_sparse_head(g, "cpu"), synd, llr, 5,
                            0.625)
    else:
        with pytest.raises(ValueError, match="1..64"):
            bk._launch(tbp.graph_to(g, "cpu"), synd, llr, False, 5, 0.625)


def test_layouts_at_the_dem_shapes():
    """h1 of hgp_34_n625 (900 x 9600, rw 59, cw 12): the staged planes are
    2 * 53,100 -> 106,208 + 2 * 115,200 + 4 * 9600 = 375,008 B, above a
    block's 232,448, so kernel 1 takes its check-state mode with 16-bit
    planes read from device memory: a shot's 900 records of 16 B, their
    900 bytes (912) and 4 * 9600 totals, 53,712 B of shared memory, one
    shot a block.  Its device-memory mode with 32-bit planes, fixed, keeps
    a lane's 4 + 4 bytes an edge, 4 * 9600 totals and 900 syndrome bits in
    the scratch (464,112 B); h2 (300 x 1825, rw 40, cw 12) fits the
    bf16 head's shared mode: 24,000 + 43,808 + 21,904 + 7,312 = 97,024 B
    staged and 48,000 + 24,000 + 7,312 + 304 = 79,616 B a shot."""
    assert bk.minsum_smem_bytes(0, 900, 9600, 59, 12, False) == 375_008
    assert bk.planes16(900, 9600, 59)
    lay = bk.minsum_layout(2048, 900, 9600, 59, 12, False, SMS,
                           memory="auto")
    assert (lay.memory, lay.planes, lay.lanes, lay.threads, lay.smem_bytes,
            lay.lane_bytes) == ("checks", "global16", 1, 1024, 53_712, 0)
    lay = bk.minsum_layout(2048, 900, 9600, 59, 12, False, SMS,
                           memory="device_planes")
    assert (lay.memory, lay.lanes, lay.threads, lay.smem_bytes,
            lay.lane_bytes) == ("device_planes", 1, 1024, 0, 464_112)
    assert bk.minsum_smem_bytes(0, 300, 1825, 40, 12, True) == 97_024
    assert bk.minsum_smem_bytes(1, 300, 1825, 40, 12, True) == 97_024 + 79_616
    lay = bk.minsum_layout(2048, 300, 1825, 40, 12, True, SMS, memory="auto")
    assert (lay.memory, lay.lanes, lay.smem_bytes) == ("shared", 1,
                                                       97_024 + 79_616)
    # 64 slots at once: the largest row weight, every memory mode
    for memory in bk._kernels.MEMORY_MODES:
        lay = bk.minsum_layout(96, 120, 600, 64, 16, True, SMS,
                               memory=memory)
        assert lay.memory == memory and lay.grid >= 1


@pytest.mark.parametrize("rw", [33, 40, 59, 64])
def test_wide_planes_match_the_graph(rw):
    """The 16- and 32-bit planes of a wide graph number its edges as the
    Tanner graph does, slots up to 63 in the uint8 slot plane."""
    h = _graph(60, 400, rw, rw)
    g = tbp.build_tanner_graph_host(h)
    narrow, wide = bk.minsum_planes(g), bk.minsum_planes(g, wide=True)
    chk = narrow.chk.numpy().view(np.uint16).astype(np.int64)
    chk[chk == bk.PAD16] = -1
    assert np.array_equal(chk, wide.chk.numpy())
    assert np.array_equal(narrow.slot, wide.slot)
    assert chk.shape == (rw, 60)
    live = chk >= 0
    assert live.sum() == h.sum()
    s, i = np.nonzero(live)
    assert (h[i, chk[s, i]] == 1).all()
    head = bk.build_sparse_head(g, "cpu")
    hp = bk.minsum_planes(head)
    assert int(hp.slot.max()) == rw - 1


@functools.lru_cache(maxsize=None)
def _h2_n225():
    """h2 and its priors of the circuit space-time engine's detector error
    model on hgp_34_n225 (CX-only noise at 0.004, windows of 3)."""
    import os
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = load_code(os.path.join(repo, "codes_lib_tpu", "hgp_34_n225.npz"))
    ep = {"p_i": 0.0, "p_state_p": 0.0, "p_m": 0.0, "p_CX": 0.004,
          "p_idling_gate": 0.0}
    sim = CodeSimulator_Circuit_SpaceTime(code=code, p=0.004, num_cycles=7,
                                          num_rep=3, error_params=ep,
                                          device="cpu")
    sim._generate_circuit_graph()
    g = sim.circuit_graph
    return g["h2"].astype(np.uint8), np.asarray(g["channel_ps2"], np.float64)


def _case(B=256, seed=5, scale=4.0):
    """Syndromes of errors drawn at ``scale`` times the priors (enough
    unconverged shots to exercise every iteration)."""
    h, ps = _h2_n225()
    assert int(h.sum(1).max()) == 42
    rng = np.random.default_rng(seed)
    err = (rng.random((B, h.shape[1])) < scale * ps).astype(np.uint8)
    synd = (err @ h.T % 2).astype(np.uint8)
    llr = np.array(jbp.llr_from_probs(ps))
    return h, synd, llr


def test_kernel1_plain_version_matches_jax_at_row_weight_42():
    h, synd, llr = _case()
    jg = jbp.build_tanner_graph(h)
    j = jbp.bp_decode(jg, synd, llr, max_iter=40, method="minimum_sum",
                      ms_scaling_factor=0.625)
    t = bk.bp_minsum(tbp.build_tanner_graph(h, "cpu"), torch.from_numpy(synd),
                     torch.from_numpy(llr), max_iter=40,
                     ms_scaling_factor=0.625)
    j = [np.asarray(x) for x in (j.error, j.converged, j.posterior_llr,
                                 j.iterations)]
    t = [x.numpy() for x in t]
    tie = (np.abs(j[2]) < 1e-3).any(axis=1)
    assert tie.mean() <= 0.01
    ok = ~tie
    for a, b in ((j[0], t[0]), (j[1], t[1]), (j[3], t[3])):
        assert np.array_equal(a[ok].astype(b.dtype), b[ok])
    np.testing.assert_allclose(t[2][ok], j[2][ok], rtol=1e-5, atol=1e-6)
    assert 0 < t[1].mean() < 1


def test_bf16_head_plain_version_matches_jax_v1_at_row_weight_42():
    h, synd, llr = _case()
    jg = jbp.build_tanner_graph_host(h)
    want = bp_pallas.bp_head_pallas(bp_pallas.build_pallas_head(jg), synd,
                                    llr, interpret=True, head_iters=30,
                                    block_b=256)
    tg = tbp.build_tanner_graph_host(h)
    got = bk.bp_head_bf16(bk.build_sparse_head(tg, "cpu"),
                          torch.from_numpy(synd), torch.from_numpy(llr),
                          head_iters=30)
    for name, a, b in zip(("error", "converged", "posterior", "iterations"),
                          want, got):
        a, b = np.asarray(a), b.numpy()
        if name == "posterior":
            assert np.array_equal(a.view(np.int32), b.view(np.int32)), name
        else:
            assert np.array_equal(a.astype(b.dtype), b), name
    assert 0 < got[1].float().mean() < 1


# ------------------------------------------- B6 and B5: rows 33-64 (wide)

@pytest.mark.parametrize("rw", [33, 40, 59, 64])
def test_int8_layout_takes_rows_to_64(rw):
    lanes, cluster = bk.int8_layout(256, rw, 120, 600)
    assert lanes * cluster == 256 and cluster <= bk.INT8_MAX_CLUSTER
    assert bk.int8_smem_bytes(lanes, rw, 120, 600) <= bk.SMEM_LIMIT
    # h2's shape at the tile its decoder takes there (128, the JAX rule)
    lanes, cluster = bk.int8_layout(128, rw, 300, 1825)
    assert lanes * cluster == 128 and cluster <= bk.INT8_MAX_CLUSTER


@pytest.mark.parametrize("rw", [0, 65, 128])
def test_int8_layout_refuses_rows_outside_1_to_64(rw):
    with pytest.raises(ValueError, match="row weights 1..64"):
        bk.int8_layout(256, rw, 120, 600)


def _wide_hgp():
    """hgp(H1, H2) of the all-ones 3 x 37 and 3 x 5 matrices: hx's rows
    have weight 37 + 3 = 40, hz's 5 + 3 = 8 (n = 194)."""
    return hgp(np.ones((3, 37), np.uint8), np.ones((3, 5), np.uint8))


def _wide_specs(code, p=0.01):
    rng = np.random.default_rng(code.N)
    llr_x, llr_z = (np.asarray(jbp.llr_from_probs(
        rng.uniform(p / 4, p, code.N))) for _ in range(2))
    args = (code.hx, code.hz, code.lx, code.lz, [p / 3] * 3, llr_x, llr_z)
    return gp.build_fused_decode_spec(*args), gk.build_fused_decode_spec(
        *args, "cpu")


def _row_spec(rw):
    """A fused spec whose hx rows reach ``rw`` (random, not a code: the
    gates read shapes only)."""
    h = _graph(40, 200, rw, rw)
    llr = tbp.llr_from_probs(np.full(200, 0.02), "cpu")
    return gk.build_fused_decode_spec(h, h, h[:2], h[:2], [0.01] * 3, llr,
                                      llr, "cpu")


@pytest.mark.parametrize("quantize", [None, "int8"], ids=["bf16", "int8"])
@pytest.mark.parametrize("rw", [33, 40, 59, 64, 65])
def test_fused_decode_gates_take_rows_to_64(rw, quantize):
    spec = _row_spec(rw)
    assert spec.sparse_z.rw == rw
    assert gk.fused_wide(spec) == (rw > 32)
    assert gk.fused_decode_feasible(spec, 256, quantize=quantize) == (rw <= 64)
    if rw <= 64:
        gk.fused_layout(256, *gk._fused_shape(spec), SMS)
        gk._sparse_args(spec.sparse_z, spec.base.device)
    else:
        with pytest.raises(ValueError, match="row weights 1..64"):
            gk.fused_layout(256, *gk._fused_shape(spec), SMS)
        with pytest.raises(ValueError, match="row weights 1..64"):
            gk._sparse_args(spec.sparse_z, spec.base.device)


def test_wide_hgp_takes_the_fused_decode():
    code = _wide_hgp()
    _, tspec = _wide_specs(code)
    assert (tspec.sparse_z.rw, tspec.sparse_x.rw) == (40, 8)
    for quantize in (None, "int8"):
        assert gk.fused_decode_feasible(tspec, 4096, quantize=quantize)


@pytest.mark.parametrize("block_b", [64, 128])
def test_int8_plain_version_matches_jax_at_row_weight_42(block_b):
    h, synd, llr = _case()
    jsg = bp_pallas.build_sparse_head(jbp.build_tanner_graph_host(h))
    tsg = bk.build_sparse_head(tbp.build_tanner_graph_host(h), "cpu")
    assert tsg.rw == 42 and bk.int8_layout(block_b, 42, *h.shape)
    want = bp_pallas._bp_head_sparse_xla(
        jsg, synd, llr, head_iters=30, ms_scaling_factor=0.625,
        block_b=block_b, early_stop=False, quantize="int8")
    got = bk.bp_head_int8(tsg, torch.from_numpy(synd), torch.from_numpy(llr),
                          head_iters=30, block_b=block_b)
    for name, a, b in zip(("error", "converged", "posterior", "iterations"),
                          want, got):
        a, b = np.asarray(a), b.numpy()
        if name == "posterior":
            assert np.array_equal(a.view(np.int32), b.view(np.int32)), name
        else:
            assert np.array_equal(a.astype(b.dtype), b), name
    assert 0 < got[1].float().mean() < 1


@pytest.mark.parametrize("quantize,block_w", [(None, None), ("int8", 2),
                                              ("int8", 8)],
                         ids=["bf16", "int8-w2", "int8-w8"])
def test_fused_plain_version_matches_jax_on_wide_rows(quantize, block_w):
    jspec, tspec = _wide_specs(_wide_hgp())
    jkey = jax.random.fold_in(jax.random.PRNGKey(4), 3)
    tkey = gk.fold_in(gk.prng_key(4), 3)
    kw = dict(eval_type="Total", max_iter_z=20, max_iter_x=20,
              quantize=quantize, block_w=block_w)
    want = gp.fused_decode_stats(jspec, jkey, 256, backend="xla", **kw)
    got = gk.fused_decode_stats(tspec, tkey, 256, **kw)
    assert (int(got[0]), int(got[1])) == (int(want[0]), int(want[1]))
    assert 0 < int(got[0]) < 256
    for w, g in ((want[2], got[2]), (want[3], got[3])):
        for field in ("converged", "iterations"):
            assert np.array_equal(np.asarray(w[field]), g[field].numpy())

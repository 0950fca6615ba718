"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU (a CUDA kernel has no interpret mode) and
skip without one; run them on a machine with a card:
``python -m pytest tests/test_torch_cuda.py``.  Tolerance: none — every
kernel reproduces its plain version bit for bit (min-sum, alone or inside
the fused decode in either message mode, int8 min-sum, the bf16 head and
the OSD-CS sweep, over given planes or building its own in their stated
summation order, are built with FMA contraction off; the eliminations, the
counter-PRNG sampler and the residual checks are integer-exact)."""
import os

import numpy as np
import pytest
import torch

from qldpc_fault_tolerance_tpu_torch.codes import hgp, load_code, rep_code, ring_code
from qldpc_fault_tolerance_tpu_torch.decoders import BPDecoder, BPOSD_Decoder
from qldpc_fault_tolerance_tpu_torch.ops import _kernels
from qldpc_fault_tolerance_tpu_torch.ops import bp as tbp
from qldpc_fault_tolerance_tpu_torch.ops import bp_kernel as bk
from qldpc_fault_tolerance_tpu_torch.ops import gf2_kernel as gk
from qldpc_fault_tolerance_tpu_torch.ops import osd_cs_device as tcs
from qldpc_fault_tolerance_tpu_torch.ops import osd_device as tod
from qldpc_fault_tolerance_tpu_torch.ops.bp_kernel import bp_minsum

# one intra-op thread: the suite runs several pytest workers on few cores,
# and an oversubscribed torch thread pool stalls small ops
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _synd(h, B, p, seed):
    rng = np.random.default_rng(seed)
    err = (rng.random((B, h.shape[1])) < p).astype(np.uint8)
    return torch.from_numpy((err @ h.T % 2).astype(np.uint8))


@pytest.mark.parametrize("code,B,per_shot", [("ring", 300, False),
                                             ("ring", 64, True),
                                             ("hgp_34_n1600", 44, False)])
def test_bp_kernel_matches_plain(cuda, code, B, per_shot):
    """hgp_34_n1600 takes 4 shots per block (shared memory), the ring code 8."""
    if code == "ring":
        h = hgp(ring_code(5), ring_code(4)).hx
    else:
        h = load_code(os.path.join(REPO, "codes_lib_tpu", f"{code}.npz")).hx
    graph = tbp.build_tanner_graph(h, cuda)
    synd = _synd(h, B, 0.06, B).to(cuda)
    llr = tbp.llr_from_probs(np.full(h.shape[1], 0.05), cuda)
    if per_shot:
        llr = llr * torch.linspace(0.5, 1.5, B, device=cuda)[:, None]
    before = bp_minsum.launches
    k = bp_minsum(graph, synd, llr.contiguous(), max_iter=25)
    assert bp_minsum.launches == before + 1
    with _kernels.force_plain():
        p = bp_minsum(graph, synd, llr.contiguous(), max_iter=25)
    assert bp_minsum.launches == before + 1
    for a, b in zip(k, p):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fcap", [0, 10, 32])
def test_elim_kernel_matches_plain(cuda, fcap):
    h = load_code(os.path.join(REPO, "codes_lib_tpu", "hgp_34_n225.npz")).hx
    n = h.shape[1]
    plan = tod.build_osd_plan(h, np.full(n, 0.03), device=cuda)
    post = torch.randn((40, n), generator=torch.Generator().manual_seed(fcap))
    perm = torch.sort(post.to(cuda), dim=1, stable=True).indices
    synd = _synd(h, 40, 0.05, fcap).to(cuda, torch.int32).t().contiguous()
    k = tod.osd_elim(plan.packed, perm, synd, n=n, r_star=plan.rank, fcap=fcap)
    packed = tod._permute_and_pack(tod._unpack_rows(plan.packed, n), perm)
    p = tod.eliminate_plain(packed, synd, n=n, r_star=plan.rank, fcap=fcap)
    for a, b in zip(k, p):
        assert torch.equal(a, b)


def _elim_inputs(cuda, seed, B=40, h=None):
    if h is None:
        h = load_code(os.path.join(REPO, "codes_lib_tpu", "hgp_34_n225.npz")).hx
    n = h.shape[1]
    plan = tod.build_osd_plan(h, np.full(n, 0.03), device=cuda)
    post = torch.randn((B, n), generator=torch.Generator().manual_seed(seed))
    perm = torch.sort(post.to(cuda), dim=1, stable=True).indices
    synd = _synd(h, B, 0.05, seed).to(cuda, torch.int32).t().contiguous()
    return plan.packed, perm, synd, n, plan.rank


@pytest.mark.parametrize("fcap", [0, 10, 32])
def test_elim_full_kernel_matches_plain(cuda, fcap):
    """B7: six outputs, the reduced matrix whole."""
    rows, perm, synd, n, rank = _elim_inputs(cuda, 100 + fcap)
    before = tod.osd_elim.full_launches
    k = tod.osd_elim(rows, perm, synd, n=n, r_star=rank, fcap=fcap, full=True)
    assert tod.osd_elim.full_launches == before + 1
    with _kernels.force_plain():
        p = tod.osd_elim(rows, perm, synd, n=n, r_star=rank, fcap=fcap,
                         full=True)
    assert len(k) == len(p) == 6
    for a, b in zip(k, p):
        assert torch.equal(a, b)


@pytest.mark.parametrize("B", [40, 1])
def test_elim_percol_kernel_matches_plain(cuda, B):
    """B10: reduced syndrome at the pivots, pivots, pivot flags, matrix."""
    rows, perm, synd, n, rank = _elim_inputs(cuda, 7, B)
    before = tod.osd_elim_percol.launches
    k = tod.osd_elim_percol(rows, perm, synd, n=n, r_star=rank)
    assert tod.osd_elim_percol.launches == before + 1
    with _kernels.force_plain():
        p = tod.osd_elim_percol(rows, perm, synd, n=n, r_star=rank)
    for a, b in zip(k, p):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _edge_code(name):
    if name == "ring":  # hgp of ring codes: r* < m
        return hgp(ring_code(5), ring_code(4)).hx
    if name == "n225":  # m = 108 and n = 225, neither a multiple of 32
        return load_code(os.path.join(REPO, "codes_lib_tpu",
                                      "hgp_34_n225.npz")).hx
    rng = np.random.default_rng(33)  # m = 33: one bit in the tail word
    h = (rng.random((33, 70)) < 0.1).astype(np.uint8)
    h[:, h.sum(0) == 0] = 1
    return h


@pytest.mark.parametrize("threads", [None, 64, 1024])
@pytest.mark.parametrize("B", [1, 37])
@pytest.mark.parametrize("fcap", [0, 10, 32])
@pytest.mark.parametrize("code", ["ring", "n225", "m33"])
def test_elim_modes_match_plain_at_edge_shapes(cuda, code, fcap, B, threads,
                                               monkeypatch):
    """All three modes against their plain versions: r* < m, m and n not
    multiples of 32, fcap 0, 10 and 32, one shot and a ragged batch, at the
    layout's threads per shot and at two warps and 1024 threads a shot;
    B10's pivots and pivot rows are B7's."""
    h = _edge_code(code)
    rows, perm, synd, n, rank = _elim_inputs(cuda, fcap + B, B, h)
    assert code != "ring" or rank < h.shape[0]
    fcap = min(fcap, n - rank)
    if threads is not None:
        orig = tod.elim_layout
        monkeypatch.setattr(tod, "elim_layout", lambda *a, **k: orig(
            *a, **k, threads=threads))
    runs = {
        "skip": lambda: tod.osd_elim(rows, perm, synd, n=n, r_star=rank,
                                     fcap=fcap),
        "full": lambda: tod.osd_elim(rows, perm, synd, n=n, r_star=rank,
                                     fcap=fcap, full=True),
        "percol": lambda: tod.osd_elim_percol(rows, perm, synd, n=n,
                                              r_star=rank)}
    got = {}
    for mode, fn in runs.items():
        got[mode] = fn()
        with _kernels.force_plain():
            plain = fn()
        for a, b in zip(got[mode], plain):
            assert a.dtype == b.dtype and torch.equal(a, b), mode
    full, percol = got["full"], got["percol"]
    assert torch.equal(percol[1], full[1]) and torch.equal(percol[2], full[2])
    assert torch.equal(tod.pivot_rows(percol[4], percol[1]),
                       tod.pivot_rows(full[5], full[1]))


@pytest.mark.parametrize("fcap", [0, 10])
def test_elim_modes_match_plain_on_a_tall_matrix(cuda, fcap):
    """m = 1100 rows: 35 words a column, more than warp 0's window lanes
    hold, so the walk rescans after every pivot and the other warps clear
    every column right of it."""
    rng = np.random.default_rng(1100 + fcap)
    h = (rng.random((1100, 1180)) < 0.004).astype(np.uint8)
    h[:, h.sum(0) == 0] = 1
    rows, perm, synd, n, rank = _elim_inputs(cuda, fcap, 5, h)
    runs = (lambda: tod.osd_elim(rows, perm, synd, n=n, r_star=rank,
                                 fcap=fcap, full=True),
            lambda: tod.osd_elim_percol(rows, perm, synd, n=n, r_star=rank))
    for fn in runs:
        got = fn()
        with _kernels.force_plain():
            plain = fn()
        for a, b in zip(got, plain):
            assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("f,w,B,ties", [(325, 10, 256, False),
                                        (325, 10, 256, True),
                                        (14, 5, 37, True), (3, 1, 9, False),
                                        (5, 0, 8, False)])
def test_cs_sweep_kernel_matches_plain(cuda, f, w, B, ties):
    """B8: best cost and index bit-exact, ragged batches and w <= 1 too."""
    rng = np.random.default_rng(f * B + ties)
    wsq = max(w * w, 1)
    if ties:
        planes = (rng.integers(-3, 4, (f, B)), rng.integers(-2, 3, (wsq, B)),
                  rng.integers(0, 3, B))
    else:
        planes = (rng.normal(size=(f, B)), rng.normal(size=(wsq, B)),
                  rng.normal(size=B))
    dplane, xflat, base = (torch.from_numpy(np.asarray(a, np.float32)).to(cuda)
                           for a in planes)
    before = tcs.cs_sweep.launches
    k = tcs.cs_sweep(dplane, xflat, base, w=w, pat_chunk=64)
    assert tcs.cs_sweep.launches == before + 1
    p = tcs.cs_sweep_plain(dplane, xflat, base, w=w, pat_chunk=64)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])


def _rows_inputs(rng, W, m, r, n, f, w, B, ties):
    """Random inputs of B8 with its planes: a reduced matrix (W, m, B), r
    distinct pivot rows and f free positions below n per shot; with
    ``ties`` small integer costs, so many candidates tie exactly."""
    packed = rng.integers(-2 ** 31, 2 ** 31, (W, m, B), dtype=np.int64)
    pr = np.stack([rng.permutation(m)[:r] for _ in range(B)], axis=1)
    fp = np.stack([np.sort(rng.permutation(n)[:f]) for _ in range(B)], axis=1)
    if ties:
        signed = rng.integers(-3, 4, (r, B)).astype(np.float32)
        cost_free = rng.integers(0, 3, (f, B)).astype(np.float32)
        base = rng.integers(0, 4, B).astype(np.float32)
    else:
        signed = rng.normal(0, 4, (r, B)).astype(np.float32)
        cost_free = rng.uniform(1, 6, (f, B)).astype(np.float32)
        base = rng.uniform(0, 40, B).astype(np.float32)
    return (packed.astype(np.int32), pr.astype(np.int32), signed, cost_free,
            fp.astype(np.int64), base)


@pytest.mark.parametrize("W,m,r,n,f,w,B,ties", [
    (20, 300, 300, 625, 325, 10, 256, False),
    (20, 300, 300, 625, 325, 10, 256, True),
    (2, 20, 18, 48, 30, 5, 37, True), (2, 20, 20, 40, 20, 1, 9, False),
    (1, 8, 5, 12, 7, 0, 8, True), (50, 768, 768, 1600, 832, 20, 16, False)])
def test_cs_sweep_rows_kernel_matches_plain(cuda, W, m, r, n, f, w, B, ties):
    """B8 with its planes: best cost and index bit-exact with cs_planes
    then cs_sweep_plain, exact cost ties included, at hgp_34_n625's and
    n1600's shapes (orders 10 and 20), ragged and w <= 1."""
    rng = np.random.default_rng(W * B + ties)
    args = [torch.from_numpy(a).to(cuda)
            for a in _rows_inputs(rng, W, m, r, n, f, w, B, ties)]
    before = tcs.cs_sweep_rows.launches
    k = tcs.cs_sweep_rows(*args, n=n, w=w, pat_chunk=64)
    assert tcs.cs_sweep_rows.launches == before + 1
    p = tcs.cs_sweep_rows_plain(*args, n=n, w=w, pat_chunk=64)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    if ties:
        assert (k[1] > 0).any()


@pytest.mark.parametrize("elim", ["pallas", "pallas_percol"])
def test_bposd_cs_on_card_matches_cpu(cuda, elim, monkeypatch):
    monkeypatch.setenv("QLDPC_OSD_ELIM", elim)
    code = hgp(ring_code(5), ring_code(5))
    probs = np.full(code.N, 0.05)
    synd = _synd(code.hx, 256, 0.06, 11).numpy()
    kw = dict(osd_method="osd_cs", osd_order=8)
    gpu = BPOSD_Decoder(code.hx, probs, 20, device=cuda, **kw)
    cpu = BPOSD_Decoder(code.hx, probs, 20, device="cpu", **kw)
    a, b = gpu.decode_batch(synd), cpu.decode_batch(synd)
    cost = np.log((1 - probs) / probs)
    assert ((a.astype(np.int64) @ code.hx.T % 2) == synd).all()
    assert ((a == b).all(axis=1) | (np.abs(a @ cost - b @ cost) < 1e-4)).all()


def test_wrappers_reject_what_the_kernels_cannot_take(cuda):
    h = hgp(ring_code(3), ring_code(3)).hx
    graph = tbp.build_tanner_graph(h, cuda)
    llr = tbp.llr_from_probs(np.full(h.shape[1], 0.05), cuda)
    with pytest.raises(ValueError):
        bp_minsum(graph, _synd(h, 8, 0.1, 0).to(cuda).float(), llr, max_iter=5)
    plan = tod.build_osd_plan(h, np.full(h.shape[1], 0.05), device=cuda)
    perm = torch.arange(h.shape[1], device=cuda).repeat(4, 1)
    synd = torch.zeros((h.shape[0], 4), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        tod.osd_elim(plan.packed, perm, synd, n=h.shape[1], r_star=plan.rank,
                     fcap=33)
    with pytest.raises(ValueError):
        tod.osd_elim_percol(plan.packed, perm[:-1], synd, n=h.shape[1],
                            r_star=plan.rank)
    with pytest.raises(ValueError):
        tod.osd_elim(plan.packed, perm.int(), synd, n=h.shape[1],
                     r_star=plan.rank, fcap=0)
    d = torch.zeros((6, 4), device=cuda)
    with pytest.raises(ValueError):
        tcs.cs_sweep(d, torch.zeros((4, 4), device=cuda), torch.zeros(4, device=cuda),
                     w=3, pat_chunk=64)
    with pytest.raises(ValueError):
        tcs.cs_sweep(d.double(), torch.zeros((1, 4), device=cuda),
                     torch.zeros(4, device=cuda), w=1, pat_chunk=64)


def test_bposd_on_card_matches_cpu(cuda):
    code = hgp(ring_code(5), ring_code(5))
    probs = np.full(code.N, 0.05)
    synd = _synd(code.hx, 256, 0.06, 9).numpy()
    gpu = BPOSD_Decoder(code.hx, probs, 20, osd_order=6, device=cuda)
    cpu = BPOSD_Decoder(code.hx, probs, 20, osd_order=6, device="cpu")
    a, b = gpu.decode_batch(synd), cpu.decode_batch(synd)
    cost = np.log((1 - probs) / probs)
    assert ((a.astype(np.int64) @ code.hx.T % 2) == synd).all()
    assert ((a == b).all(axis=1) | (np.abs(a @ cost - b @ cost) < 1e-4)).all()


KEY = gk.fold_in(gk.split_key(gk.prng_key(7))[1], 3)


def _n225():
    return load_code(os.path.join(REPO, "codes_lib_tpu", "hgp_34_n225.npz"))


@pytest.mark.parametrize("B", [256, 200, 33])
@pytest.mark.parametrize("emit_errors", [True, False])
def test_sample_kernel_matches_plain(cuda, B, emit_errors):
    code = _n225()
    spec = gk.build_fused_spec(code.hx, code.hz, code.lx, code.lz,
                               (0.02, 0.01, 0.03), cuda)
    before = gk.sample_syndrome.launches
    k = gk.sample_syndrome(spec, KEY, B, emit_errors=emit_errors)
    p = gk.sample_syndrome_plain(spec, KEY, B, emit_errors=emit_errors)
    assert gk.sample_syndrome.launches == before + 1
    assert len(k) == len(p) == (4 if emit_errors else 2)
    for a, b in zip(k, p):
        assert torch.equal(a, b)


@pytest.mark.parametrize("B", [256, 200])
@pytest.mark.parametrize("eval_type", ["X", "Z", "Total"])
def test_residual_kernel_matches_plain(cuda, B, eval_type):
    code = _n225()
    spec = gk.build_fused_spec(code.hx, code.hz, code.lx, code.lz,
                               (0.02, 0.01, 0.03), cuda)
    exp, ezp, _, _ = gk.sample_syndrome_plain(spec, KEY, B)
    rng = np.random.default_rng(B)
    flips = [torch.from_numpy((rng.random(e.shape) < 0.01).astype(np.int32)
                              << rng.integers(0, 32, e.shape).astype(np.int32))
             for e in (exp, ezp)]
    corx, corz = exp ^ flips[0].to(cuda), ezp ^ flips[1].to(cuda)
    k = gk.residual_check_stats(spec, KEY, B, corx, corz, eval_type)
    p = gk.residual_check_plain(spec, KEY, B, corx, corz, eval_type)
    assert 0 < int(p[0]) < B
    assert (int(k[0]), int(k[1])) == (int(p[0]), int(p[1]))


def _fused_spec(cuda, name, B, p=0.05):
    if name == "rep3":
        code = hgp(rep_code(3), rep_code(3))
    else:
        code = load_code(os.path.join(REPO, "codes_lib_tpu",
                                      f"hgp_34_{name}.npz"))
    rng = np.random.default_rng(B)
    llr_x, llr_z = (tbp.llr_from_probs(rng.uniform(p / 4, p, code.N), cuda)
                    for _ in range(2))
    return gk.build_fused_decode_spec(code.hx, code.hz, code.lx, code.lz,
                                      [p / 3] * 3, llr_x, llr_z, cuda)


def _fused_matches_plain(spec, B, counter, **kw):
    kw = dict(eval_type="Total", max_iter_z=20, max_iter_x=15,
              ms_scaling_factor=0.625, **kw)
    before = getattr(gk.fused_decode_stats, counter)
    k = gk.fused_decode_stats(spec, KEY, B, **kw)
    pl = gk.fused_decode_plain(spec, KEY, B, **kw)
    assert getattr(gk.fused_decode_stats, counter) == before + 1
    assert (int(k[0]), int(k[1])) == (int(pl[0]), int(pl[1]))
    for a, b in zip(k[2:], pl[2:]):
        for field in ("converged", "iterations"):
            assert torch.equal(a[field], b[field]), field


@pytest.mark.parametrize("name,B", [("rep3", 64), ("rep3", 32),
                                    ("n225", 96), ("n625", 256),
                                    ("n1600", 32)])
def test_fused_decode_kernel_matches_plain(cuda, name, B):
    """The bf16 mode on each code's layout (ops/gf2_kernel.py
    fused_layout)."""
    _fused_matches_plain(_fused_spec(cuda, name, B), B, "launches")


@pytest.mark.parametrize("name,B,block_w", [("rep3", 64, 1), ("n225", 512, 8),
                                            ("n225", 96, 1), ("n625", 512, 8),
                                            ("n625", 128, 2),
                                            ("n1225", 512, 8)])
def test_fused_decode_int8_kernel_matches_plain(cuda, name, B, block_w):
    """The int8 mode, two or more tiles per batch (each tile its own
    message scales); hgp_34_n1225 reads its index planes from device
    memory (they do not fit in shared memory beside the rest), the others
    stage them."""
    _fused_matches_plain(_fused_spec(cuda, name, B), B, "int8_launches",
                         quantize="int8", block_w=block_w)


@pytest.mark.parametrize("name,B,p,iters", [
    ("n625", 32, 0.05, 20), ("n625", 64, 0.05, 20), ("n625", 4096, 0.01, 50),
    ("n625", 64, 0.05, 0), ("n625", 64, 0.0, 20), ("n1225", 64, 0.05, 20),
    ("n1225", 512, 0.03, 30), ("n1600", 64, 0.05, 20)])
def test_fused_decode_lanes_match_plain(cuda, name, B, p, iters):
    """B5's bf16 mode: one shot per lane, lanes refilled from the claim
    counter (4096 shots are more than the card holds at once), no
    iteration at all, no error at all, and the larger codes: count, min
    weight and every shot's flags and iterations in both sectors
    bit-exact."""
    spec = _fused_spec(cuda, name, B, p)
    kw = dict(eval_type="Total", max_iter_z=iters, max_iter_x=iters,
              ms_scaling_factor=0.625)
    before = gk.fused_decode_stats.launches
    k = gk.fused_decode_stats(spec, KEY, B, **kw)
    pl = gk.fused_decode_plain(spec, KEY, B, **kw)
    assert gk.fused_decode_stats.launches == before + 1
    assert (int(k[0]), int(k[1])) == (int(pl[0]), int(pl[1]))
    for a, b in zip(k[2:], pl[2:]):
        for field in ("converged", "iterations"):
            assert torch.equal(a[field], b[field]), field
    if p == 0.0:
        assert int(k[0]) == 0 and bool(k[3]["converged"].all())
    if iters == 0:
        assert not k[2]["converged"].any() and not k[3]["iterations"].any()


@pytest.mark.parametrize("lanes", [1, 3, 12])
def test_fused_decode_any_lane_count_matches_plain(cuda, lanes, monkeypatch):
    """The layout's shots per block do not change a bit: 1, 3 and 12 lanes
    (the most hgp_34_n625 fits) on 320 shots."""
    orig = gk.fused_layout
    monkeypatch.setattr(gk, "fused_layout",
                        lambda *a, **k: orig(*a, **k, lanes=lanes))
    spec = _fused_spec(cuda, "n625", 320)
    assert gk.card_fused_layout(spec, 320).lanes == lanes
    _fused_matches_plain(spec, 320, "launches")


def test_fused_wrappers_reject_what_the_kernels_cannot_take(cuda):
    code = hgp(rep_code(3), rep_code(3))
    spec = gk.build_fused_spec(code.hx, code.hz, code.lx, code.lz,
                               (0.01, 0.01, 0.01), cuda)
    bad = torch.zeros((2, code.N), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        gk.residual_check_stats(spec, KEY, 64, bad, bad)
    with pytest.raises(ValueError):
        gk.sample_syndrome(spec, KEY, 0)
    kw = dict(max_iter_z=5, max_iter_x=5, quantize="int8")
    spec2 = _fused_spec(cuda, "rep3", 64)
    for batch, block_w in ((48, None), (1024, 32)):  # ragged; a cluster of 32
        with pytest.raises(ValueError):
            gk.fused_decode_stats(spec2, KEY, batch, block_w=block_w, **kw)
    with pytest.raises(ValueError, match="shared memory"):
        # 32 shots of hgp_34_n1600's int8 messages and totals exceed a block
        gk.fused_decode_stats(_fused_spec(cuda, "n1600", 32), KEY, 32, **kw)


def _bits(res):
    """A head decode's outputs with the posterior as its bit patterns."""
    err, conv, post, iters = res
    return err, conv, post.contiguous().view(torch.int32), iters


@pytest.mark.parametrize("code,block_b,early_stop", [
    ("irregular", 16, False), ("irregular", 64, True),
    ("hgp_34_n225", 256, False), ("hgp_34_n225", 512, True),
    ("hgp_34_n625", 512, True), ("hgp_34_n1225", 256, False),
    ("hgp_34_n1600", 256, True), ("unstaged", 256, False)])
def test_int8_kernel_matches_plain(cuda, code, block_b, early_stop):
    """B6 at every tile the two-phase decode uses; padded slots (irregular
    rows); a 512-shot tile is a cluster of 16 blocks, and so is a 256-shot
    tile of hgp_34_n1600 (16 shots per block); "unstaged", 660 checks of
    weight 7 on 1225 bits, keeps 32 shots per block and reads its index
    plane from device memory."""
    rng = np.random.default_rng(4)
    if code == "irregular":
        h = np.zeros((24, 48), np.uint8)
        for i in range(24):
            h[i, rng.choice(48, size=int(rng.integers(2, 7)), replace=False)] = 1
    elif code == "unstaged":
        h = np.zeros((660, 1225), np.uint8)
        for i in range(660):
            h[i, rng.choice(1225, size=7, replace=False)] = 1
        assert not bk.int8_staged(32, 7, 660, 1225)
    else:
        h = load_code(os.path.join(REPO, "codes_lib_tpu", f"{code}.npz")).hx
    sg = bk.build_sparse_head(tbp.build_tanner_graph_host(h), cuda)
    synd = _synd(h, 1024, 0.04, block_b).to(cuda)
    llr = tbp.llr_from_probs(np.full(h.shape[1], 0.04), cuda)
    kw = dict(head_iters=30, block_b=block_b, early_stop=early_stop)
    before = bk.bp_head_int8.launches
    k = bk.bp_head_int8(sg, synd, llr, **kw)
    assert bk.bp_head_int8.launches == before + 1
    with _kernels.force_plain():
        p = bk.bp_head_int8(sg, synd, llr, **kw)
    assert bk.bp_head_int8.launches == before + 1
    for a, b in zip(_bits(k), _bits(p)):
        assert torch.equal(a, b)


def _head(cuda, code, head_type):
    if code == "ring":
        h = hgp(ring_code(5), ring_code(4)).hx
    else:
        h = load_code(os.path.join(REPO, "codes_lib_tpu", f"{code}.npz")).hx
    graph = tbp.build_tanner_graph_host(h)
    build = bk.build_sparse_head if head_type == "v2" else bk.build_pallas_head
    return h, build(graph, cuda)


@pytest.mark.parametrize("head_type", ["v2", "v1"])
@pytest.mark.parametrize("code,B", [("ring", 300), ("hgp_34_n225", 256),
                                    ("hgp_34_n625", 100), ("hgp_34_n625", 300)])
def test_dense_kernel_matches_plain(cuda, code, B, head_type):
    """The bf16 head (which serves the v1 tag in place of the dense one-hot
    kernel) over either head type, on any batch (ragged last blocks at
    B=300 and 100)."""
    h, head = _head(cuda, code, head_type)
    synd = _synd(h, B, 0.05, B).to(cuda)
    llr = tbp.llr_from_probs(np.full(h.shape[1], 0.05), cuda)
    before = bk.bp_head_bf16.launches
    k = bk.bp_head_bf16(head, synd, llr, head_iters=40)
    assert bk.bp_head_bf16.launches == before + 1
    with _kernels.force_plain():
        p = bk.bp_head_bf16(head, synd, llr, head_iters=40)
    assert bk.bp_head_bf16.launches == before + 1
    for a, b in zip(_bits(k), _bits(p)):
        assert torch.equal(a, b)


def test_bf16_head_tail_matches_plain(cuda):
    """The compacted early-exit tail: stragglers of a 3-iteration head and
    zero sentinel rows, 50 iterations with early exit."""
    h, head = _head(cuda, "hgp_34_n625", "v2")
    synd = _synd(h, 1024, 0.05, 11).to(cuda)
    llr = tbp.llr_from_probs(np.full(h.shape[1], 0.05), cuda)
    first = bk.bp_head_bf16(head, synd, llr, head_iters=3)
    strag = torch.nonzero(~first[1]).flatten()[:192]
    rows = torch.cat([synd[strag], synd.new_zeros((256 - strag.numel(),
                                                   synd.shape[1]))])
    k = bk.bp_head_bf16(head, rows, llr, head_iters=50, early_stop=True)
    with _kernels.force_plain():
        p = bk.bp_head_bf16(head, rows, llr, head_iters=50, early_stop=True)
    for a, b in zip(_bits(k), _bits(p)):
        assert torch.equal(a, b)
    assert bool(k[1][strag.numel():].all())  # sentinel rows converge at once


def _mixed_synd(h, B, seed):
    """Syndromes whose shots converge at very different iterations: half
    of them zero, the rest of p=0.08 errors."""
    rng = np.random.default_rng(seed)
    err = (rng.random((B, h.shape[1])) < 0.08).astype(np.uint8)
    err[rng.random(B) < 0.5] = 0
    return torch.from_numpy((err @ h.T % 2).astype(np.uint8))


@pytest.mark.parametrize("kernel", ["f32", "f32_per_shot", "bf16"])
@pytest.mark.parametrize("code,B,iters", [
    ("hgp_34_n625", 4096, 50), ("hgp_34_n625", 1, 50), ("hgp_34_n625", 7, 50),
    ("hgp_34_n625", 1001, 50), ("hgp_34_n625", 300, 0),
    ("hgp_34_n225", 333, 30), ("hgp_34_n1225", 2048, 50),
    ("hgp_34_n1600", 2048, 50)])
def test_minsum_kernels_refill_match_plain(cuda, kernel, code, B, iters):
    """Kernel 1 and the bf16 head on batches whose shots converge at very
    different iterations, so lanes take new shots as theirs converge
    (4096 and 2048 shots are more than the card holds at once; 1001 is not
    a multiple of the shots per block), on one shot and seven, and with no
    iteration at all: every output bit-exact."""
    h = load_code(os.path.join(REPO, "codes_lib_tpu", f"{code}.npz")).hx
    synd = _mixed_synd(h, B, B).to(cuda)
    llr = tbp.llr_from_probs(np.full(h.shape[1], 0.05), cuda)
    if kernel == "bf16":
        head = bk.build_sparse_head(tbp.build_tanner_graph_host(h), cuda)
        counter = bk.bp_head_bf16

        def run():
            return bk.bp_head_bf16(head, synd, llr, head_iters=iters)
    else:
        graph = tbp.build_tanner_graph(h, cuda)
        if kernel == "f32_per_shot":
            llr = llr * torch.linspace(0.5, 1.5, B, device=cuda)[:, None]
        counter = bp_minsum

        def run():
            return bp_minsum(graph, synd, llr, max_iter=iters)
    before = counter.launches
    k = run()
    assert counter.launches == before + 1
    with _kernels.force_plain():
        p = run()
    assert counter.launches == before + 1
    for a, b in zip(_bits(k), _bits(p)):
        assert torch.equal(a, b)
    if iters and B > 7:
        its = k[3][k[1]]
        assert int(its.min()) <= 1 < int(its.max())  # converged far apart


@pytest.mark.parametrize("kw", [{}, {"quantize": "int8"}, {"bp_kernel": "v1"}])
def test_head_decoders_on_card_match_cpu(cuda, kw):
    """The two-phase decode through the bf16 head (tags v2 and v1) or B6 on
    the card gives the CPU's plain decode with the same head, shot for
    shot."""
    from qldpc_fault_tolerance_tpu_torch.decoders import decode_device

    h = load_code(os.path.join(REPO, "codes_lib_tpu", "hgp_34_n225.npz")).hx
    probs = np.full(h.shape[1], 0.03)
    synd = torch.from_numpy(_synd(h, 1024, 0.03, 5).numpy())
    card = BPDecoder(h, probs, 50, device=cuda, **kw)
    cpu = BPDecoder(h, probs, 50, device="cpu", **kw)
    head = card.device_state["pallas"]
    state = dict(cpu.device_state, pallas=type(head)(*(t.cpu() for t in head)))
    launches = (bk.bp_head_bf16.launches, bk.bp_head_int8.launches)
    a, aux_a = card.decode_batch_device(synd)
    b, aux_b = decode_device(card.device_static, state, synd)
    assert torch.equal(a.cpu(), b)
    for key in aux_a:
        assert torch.equal(aux_a[key].cpu(), aux_b[key]), key
    tag = card.device_static[5]
    assert tag == {"quantize": "v2_int8", "bp_kernel": "v1"}.get(
        next(iter(kw), None), "v2")
    assert card.kernel_variant == {"v2": "sparse_gather", "v1": "dense_onehot",
                                   "v2_int8": "sparse_int8"}[tag]
    ran = (bk.bp_head_bf16.launches - launches[0],
           bk.bp_head_int8.launches - launches[1])
    assert ran[tag == "v2_int8"] > 0 and ran[tag != "v2_int8"] == 0

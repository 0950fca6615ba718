"""The min-sum kernels' wide instances on the card: kernel 1 and the bf16
head at row weights 33, 40, 59 and 64, in each memory mode (shared memory,
lanes in device memory, 32-bit planes in device memory too, one record per
check in shared memory), the int8 head (B6) and the fused decode (B5) in
both message modes at the same row weights, against their plain versions.
The check-state mode (``"checks"``) also at row weight 7, in each of its
plane forms (16-bit planes staged, 16-bit or 32-bit planes read from
device memory), at 1, 256 and 2048 shots and 0, 1, 3 and 50 iterations,
and at the small random shapes that once broke the 32-bit-plane mode.  Tolerance: none, every output bit-exact (the kernels are
built with -fmad=false and keep the plain versions' order).  Needs an
NVIDIA GPU; skips without one."""
import numpy as np
import pytest
import torch

from qldpc_fault_tolerance_tpu_torch.ops import _kernels
from qldpc_fault_tolerance_tpu_torch.ops import bp as tbp
from qldpc_fault_tolerance_tpu_torch.ops import bp_kernel as bk
from qldpc_fault_tolerance_tpu_torch.ops import gf2_kernel as gk


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _case(rw, dev, m=120, n=600, B=96, p=0.02):
    """A random H with row weights up to ``rw`` (row 0 exactly ``rw``) and
    syndromes of errors at rate p."""
    rng = np.random.default_rng(rw)
    h = np.zeros((m, n), np.uint8)
    for i in range(m):
        w = rw if i == 0 else int(rng.integers(rw // 2, rw + 1))
        h[i, rng.choice(n, w, replace=False)] = 1
    err = (rng.random((B, n)) < p).astype(np.uint8)
    synd = torch.from_numpy((err @ h.T % 2).astype(np.uint8)).to(dev)
    llr = tbp.llr_from_probs(np.full(n, p), dev)
    return h, synd, llr


@pytest.mark.cuda
@pytest.mark.parametrize("memory", ["shared", "device", "device_planes"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("rw", [33, 40, 59, 64])
def test_wide_minsum_kernels_match_plain(cuda, rw, bf16, memory):
    h, synd, llr = _case(rw, cuda)
    g = tbp.build_tanner_graph_host(h)
    if bf16:
        head = bk.build_sparse_head(g, cuda)
        fn, counter = (lambda: bk.bp_head_bf16(head, synd, llr,
                                               head_iters=25)), bk.bp_head_bf16
    else:
        graph = tbp.graph_to(g, cuda)
        fn, counter = (lambda: bk.bp_minsum(graph, synd, llr,
                                            max_iter=25)), bk.bp_minsum
    before = (counter.launches, counter.wide_launches)
    with _kernels.force_memory(memory):
        k = fn()
    torch.cuda.synchronize()
    assert (counter.launches, counter.wide_launches) == (before[0] + 1,
                                                         before[1] + 1)
    with _kernels.force_plain():
        p = fn()
    for name, a, b in zip(("error", "converged", "posterior", "iterations"),
                          k, p):
        if name == "posterior":
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), name
        else:
            assert torch.equal(a, b), name
    assert int(k[3].max()) > 1  # the decode iterated


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("rw,m,n,B", [(7, 120, 600, 1), (7, 120, 600, 96),
                                      (7, 250, 600, 96), (32, 120, 600, 256)])
def test_device_planes_mode_at_small_shapes(cuda, rw, m, n, B, bf16):
    """The 32-bit-plane mode at shapes where, built with the aligned
    barrier form, it faulted or disagreed with its plain version
    (csrc/minsum_body.cuh lane_sync): bit-exact now, narrow rows too."""
    h, synd, llr = _case(rw, cuda, m=m, n=n, B=B)
    g = tbp.build_tanner_graph_host(h)
    if bf16:
        head = bk.build_sparse_head(g, cuda)
        fn = lambda: bk.bp_head_bf16(head, synd, llr, head_iters=25)  # noqa: E731
    else:
        graph = tbp.graph_to(g, cuda)
        fn = lambda: bk.bp_minsum(graph, synd, llr, max_iter=25)  # noqa: E731
    with _kernels.force_memory("device_planes"):
        k = fn()
    torch.cuda.synchronize()
    with _kernels.force_plain():
        p = fn()
    for a, b in zip(k, p):
        assert torch.equal(a.contiguous().view(torch.int32)
                           if a.dtype == torch.float32 else a,
                           b.contiguous().view(torch.int32)
                           if b.dtype == torch.float32 else b)


def _same(k, p):
    for a, b in zip(k, p):
        if a.dtype == torch.float32:
            a, b = a.contiguous().view(torch.int32), b.contiguous().view(
                torch.int32)
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("rw", [33, 40, 59, 64])
def test_wide_int8_head_matches_plain(cuda, rw):
    h, synd, llr = _case(rw, cuda, B=256)
    head = bk.build_sparse_head(tbp.build_tanner_graph_host(h), cuda)

    def fn():
        return bk.bp_head_int8(head, synd, llr, head_iters=25, block_b=128)

    before = (bk.bp_head_int8.launches, bk.bp_head_int8.wide_launches)
    k = fn()
    torch.cuda.synchronize()
    assert (bk.bp_head_int8.launches, bk.bp_head_int8.wide_launches) == (
        before[0] + 1, before[1] + 1)
    with _kernels.force_plain():
        p = fn()
    _same(k, p)
    assert int(k[3].max()) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("quantize", [None, "int8"], ids=["bf16", "int8"])
@pytest.mark.parametrize("rw", [33, 40, 59, 64])
def test_wide_fused_decode_matches_plain(cuda, rw, quantize):
    hx, _, _ = _case(rw, cuda, m=60, n=300)
    hz, _, _ = _case(rw // 2 + 1, cuda, m=60, n=300)
    llr = tbp.llr_from_probs(np.full(300, 0.02), cuda)
    spec = gk.build_fused_decode_spec(hx, hz, hz[:3], hx[:3], [0.01] * 3,
                                      llr, llr, cuda)
    assert gk.fused_wide(spec)
    assert gk.fused_decode_feasible(spec, 256, quantize=quantize)
    key = gk.fold_in(gk.prng_key(rw), 3)

    def fn():
        return gk.fused_decode_stats(spec, key, 256, max_iter_z=25,
                                     max_iter_x=25, quantize=quantize)

    name = "int8_" if quantize else ""
    count = lambda: (getattr(gk.fused_decode_stats, f"{name}launches"),  # noqa: E731
                     getattr(gk.fused_decode_stats, f"{name}wide_launches"))
    before = count()
    k = fn()
    torch.cuda.synchronize()
    assert count() == (before[0] + 1, before[1] + 1)
    with _kernels.force_plain():
        p = fn()
    assert (int(k[0]), int(k[1])) == (int(p[0]), int(p[1]))
    for a, b in ((k[2], p[2]), (k[3], p[3])):
        for field in ("converged", "iterations"):
            assert torch.equal(a[field], b[field]), field
    assert int(k[3]["iterations"].max()) > 1


def _minsum_fn(h, synd, llr, bf16, dev, iters):
    """The decode of kernel 1 (f32) or the bf16 head on H and its counter."""
    g = tbp.build_tanner_graph_host(h)
    if bf16:
        head = bk.build_sparse_head(g, dev)
        return (lambda: bk.bp_head_bf16(head, synd, llr, head_iters=iters),
                bk.bp_head_bf16)
    graph = tbp.graph_to(g, dev)
    return (lambda: bk.bp_minsum(graph, synd, llr, max_iter=iters),
            bk.bp_minsum)


def _checks_vs_plain(fn, counter, planes):
    """``fn`` in the check-state mode with ``planes``, one launch counted
    there and none in the device-memory modes, against its plain version
    bit for bit."""
    count = lambda: (counter.launches, counter.checks_launches,  # noqa: E731
                     counter.device_launches, counter.device_planes_launches)
    before = count()
    with _kernels.force_memory("checks"), _kernels.force_planes(planes):
        k = fn()
    torch.cuda.synchronize()
    assert count() == (before[0] + 1, before[1] + 1, before[2], before[3])
    with _kernels.force_plain():
        p = fn()
    _same(k, p)
    return k


@pytest.mark.cuda
@pytest.mark.parametrize("planes", _kernels.PLANE_FORMS)
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("rw", [7, 33, 40, 59, 64])
def test_check_state_mode_matches_plain(cuda, rw, bf16, planes):
    h, synd, llr = _case(rw, cuda, B=256)
    k = _checks_vs_plain(*_minsum_fn(h, synd, llr, bf16, cuda, 50), planes)
    assert int(k[3].max()) > 1  # the decode iterated


@pytest.mark.cuda
@pytest.mark.parametrize("max_iter", [0, 1, 3, 50])
@pytest.mark.parametrize("B", [1, 256, 2048])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_check_state_mode_at_each_batch_and_depth(cuda, bf16, B, max_iter):
    h, synd, llr = _case(7, cuda, B=B, p=0.03)
    fn, counter = _minsum_fn(h, synd, llr, bf16, cuda, max_iter)
    for planes in _kernels.PLANE_FORMS:
        _checks_vs_plain(fn, counter, planes)


@pytest.mark.cuda
@pytest.mark.parametrize("planes", _kernels.PLANE_FORMS)
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("rw,m,n,B", [(7, 120, 600, 1), (7, 120, 600, 96),
                                      (7, 250, 600, 96), (32, 120, 600, 256)])
def test_check_state_mode_at_small_shapes(cuda, rw, m, n, B, bf16, planes):
    h, synd, llr = _case(rw, cuda, m=m, n=n, B=B)
    _checks_vs_plain(*_minsum_fn(h, synd, llr, bf16, cuda, 25), planes)

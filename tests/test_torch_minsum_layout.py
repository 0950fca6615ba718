"""The launch layout and the staged planes of the min-sum kernels
(csrc/bp_minsum.cu: kernel 1 and the bf16 head, and the lanes of B5's bf16
mode, csrc/fused_decode.cu), checked on the CPU.

The kernels run only on the card (tests/test_torch_cuda.py); what they are
given is decided in Python and held here: for every shipped code, both
sectors and both message formats, the layout fits shared memory and covers
the batch, small batches get more threads per shot, and the host-built
16-bit planes are the Tanner graph's and the heads' planes entry for
entry.  Exact comparisons: the planes are integers."""
import functools
import os

import numpy as np
import pytest

from qldpc_fault_tolerance_tpu_torch.ops import bp as tbp
from qldpc_fault_tolerance_tpu_torch.ops import bp_kernel as bk
from qldpc_fault_tolerance_tpu_torch.ops import gf2_kernel as gk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CODES = ("hgp_34_n225", "hgp_34_n625", "hgp_34_n1225", "hgp_34_n1600")
BATCHES = (1, 7, 256, 1024, 4096)
SMS = 132  # an H100 SXM's SMs


@functools.lru_cache(maxsize=None)
def _h(code, sector):
    with np.load(os.path.join(REPO, "codes_lib_tpu", f"{code}.npz")) as z:
        return z[sector].astype(np.uint8)


@functools.lru_cache(maxsize=None)
def _shape(code, sector):
    g = tbp.build_tanner_graph_host(_h(code, sector))
    return (*g.chk_nbr.shape, *g.var_nbr.shape)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("sector", ["hx", "hz"])
@pytest.mark.parametrize("code", CODES)
@pytest.mark.parametrize("B", BATCHES)
def test_layout_fits_and_covers_the_batch(code, sector, bf16, B):
    m, rw, n, cw = _shape(code, sector)
    lay = bk.minsum_layout(B, m, n, rw, cw, bf16, SMS)
    per_shot = lay.threads // lay.lanes
    assert lay.smem_bytes == bk.minsum_smem_bytes(lay.lanes, m, n, rw, cw, bf16)
    assert lay.smem_bytes <= bk.SMEM_LIMIT
    assert 1 <= lay.lanes <= bk.MINSUM_MAX_LANES
    assert lay.threads <= bk.MINSUM_MAX_THREADS and per_shot % 32 == 0
    assert per_shot <= -(-max(m, n) // 32) * 32  # no idle rows
    assert lay.resident >= 1
    assert 1 <= lay.grid <= SMS * lay.resident
    # every shot has a lane at once, or every SM is full and lanes refill
    assert lay.lanes * lay.grid >= B or lay.grid == SMS * lay.resident
    assert lay.lanes * lay.grid < B + lay.lanes  # no block without a shot


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("code", CODES)
def test_small_batches_get_more_threads_per_shot(code, bf16):
    m, rw, n, cw = _shape(code, "hx")
    per_shot = [(lay.threads // lay.lanes, lay.lanes * lay.grid)
                for lay in (bk.minsum_layout(B, m, n, rw, cw, bf16, SMS)
                            for B in BATCHES)]
    threads = [t for t, _ in per_shot]
    assert threads == sorted(threads, reverse=True)
    assert threads[0] > threads[-1]
    # one check and one variable per thread for a lone shot, up to 1024
    assert threads[0] == min(1024, -(-max(m, n) // 32) * 32)
    # a large batch holds several shots per SM at once
    assert per_shot[-1][1] >= 3 * SMS


def test_layout_rejects_what_the_kernels_cannot_take():
    with pytest.raises(ValueError):
        bk.minsum_layout(64, 300, 625, 65, 4, False, SMS)  # row weight > 64
    with pytest.raises(ValueError):
        bk.minsum_layout(64, 300, 625, 7, 4, False, SMS, lanes=16)
    with pytest.raises(ValueError):  # one shot's messages exceed the block
        bk.minsum_layout(64, 5000, 10000, 7, 4, False, SMS)


def _u16(t):
    return t.numpy().view(np.uint16).astype(np.int64)


@pytest.mark.parametrize("sector", ["hx", "hz"])
@pytest.mark.parametrize("code", CODES)
def test_planes_equal_the_tanner_graph(code, sector):
    g = tbp.build_tanner_graph_host(_h(code, sector))
    pl = bk.minsum_planes(tbp.graph_to(g, "cpu"))
    m = g.chk_nbr.shape[0]
    chk, edge, slot = _u16(pl.chk), _u16(pl.edge), pl.slot.numpy()
    assert chk.shape == g.chk_nbr.T.shape and edge.shape == g.var_nbr.T.shape
    assert (chk == np.where(g.chk_mask, g.chk_nbr, bk.PAD16).T).all()
    live = g.var_mask.T
    assert (edge[~live] == bk.PAD16).all()
    # variable j's t-th term is edge (check var_nbr, slot var_nbr_slot)
    assert (edge[live] == (g.var_nbr_slot * m + g.var_nbr).T[live]).all()
    assert (slot[live] == g.var_nbr_slot.T[live]).all()
    assert (edge[live] // m == slot[live]).all()
    # every edge's variable, read back through the check plane
    assert (chk.reshape(-1)[edge[live]] == np.nonzero(live)[1]).all()


@pytest.mark.parametrize("build", ["sparse", "pallas"])
@pytest.mark.parametrize("sector", ["hx", "hz"])
@pytest.mark.parametrize("code", CODES)
def test_planes_equal_the_heads(code, sector, build):
    g = tbp.build_tanner_graph_host(_h(code, sector))
    head = getattr(bk, f"build_{build}_head")(g, "cpu")
    pl = bk.minsum_planes(head)
    m = head.m
    chk_idx, mask = head.chk_idx.numpy(), head.mask.numpy()
    var_edge = head.var_edge.numpy()
    chk, edge, slot = _u16(pl.chk), _u16(pl.edge), pl.slot.numpy()
    assert (chk == np.where(mask > 0, chk_idx, bk.PAD16)).all()
    assert (edge.T == np.where(var_edge >= 0, var_edge, bk.PAD16)).all()
    assert (slot.T == np.where(var_edge >= 0, var_edge // m, 0)).all()


def test_planes_are_built_once_per_graph():
    g = tbp.build_tanner_graph(_h("hgp_34_n225", "hx"), "cpu")
    assert bk._planes_of(g) is bk._planes_of(g)
    # a graph that shares its check lists but orders its variable lists
    # otherwise gets its own planes
    other = tbp.graph_to(bk.slot_ordered_graph(g)._replace(chk_nbr=g.chk_nbr), "cpu")
    assert other.chk_nbr is g.chk_nbr
    assert bk._planes_of(other) is not bk._planes_of(g)
    assert (bk._planes_of(other).edge == bk.minsum_planes(other).edge).all()
    key = tuple(map(id, g))
    del g
    assert key not in bk._PLANES  # dropped with its graph


def test_smem_bytes_match_the_kernel_note():
    """csrc/bp_minsum.cu's note gives the shared memory at hgp_34_n625."""
    for bf16, staged, per_shot in ((False, 11728, 19616), (True, 14240, 15424)):
        assert bk.minsum_smem_bytes(0, 300, 625, 7, 4, bf16) == staged
        assert bk.minsum_smem_bytes(1, 300, 625, 7, 4, bf16) == staged + per_shot


# B5's bf16 mode (csrc/fused_decode.cu) runs the same lanes over both
# sectors' planes, laid out by ops/gf2_kernel.py fused_layout


def _irregular_h(seed, m=24, n=48):
    rng = np.random.default_rng(seed)
    h = np.zeros((m, n), np.uint8)
    for i in range(m):
        h[i, rng.choice(n, size=int(rng.integers(2, 9)), replace=False)] = 1
    for j in np.nonzero(h.sum(0) == 0)[0]:
        h[rng.integers(0, m), j] = 1
    return h


@functools.lru_cache(maxsize=None)
def _fused_shape(code):
    """(n, mx, rwz, cwz, mz, rwx, cwx) of a code: the Z sector decodes over
    hx, the X sector over hz."""
    if code == "irregular":
        hx, hz = _irregular_h(3), _irregular_h(4)
    else:
        hx, hz = _h(code, "hx"), _h(code, "hz")
    (mx, rwz, n, cwz), (mz, rwx, _, cwx) = (
        (*g.chk_nbr.shape, *g.var_nbr.shape)
        for g in map(tbp.build_tanner_graph_host, (hx, hz)))
    return n, mx, rwz, cwz, mz, rwx, cwx


@pytest.mark.parametrize("code", CODES + ("irregular",))
@pytest.mark.parametrize("B", (32, 64, 256, 4096, 65536))
def test_fused_layout_fits_every_code(code, B):
    shape = _fused_shape(code)
    lay = gk.fused_layout(B, *shape, SMS)
    per_shot = lay.threads // lay.lanes
    assert lay.smem_bytes == gk.fused_smem_bytes(lay.lanes, *shape)
    assert lay.smem_bytes + gk._FUSED_STATIC <= bk.SMEM_LIMIT
    assert 1 <= lay.lanes <= bk.MINSUM_MAX_LANES
    assert lay.threads <= bk.MINSUM_MAX_THREADS and per_shot % 32 == 0
    assert per_shot <= -(-max(shape[:2] + shape[4:5]) // 32) * 32
    assert 1 <= lay.grid <= SMS * lay.resident
    assert lay.lanes * lay.grid >= B or lay.grid == SMS * lay.resident
    assert lay.lanes * lay.grid < B + lay.lanes
    # the most shots per block the code fits is allowed, one more is not
    top = max(k for k in range(1, bk.MINSUM_MAX_LANES + 1)
              if gk.fused_smem_bytes(k, *shape) + gk._FUSED_STATIC
              <= bk.SMEM_LIMIT)
    assert gk.fused_layout(B, *shape, SMS, lanes=top).lanes == top
    if top < bk.MINSUM_MAX_LANES:
        with pytest.raises(ValueError, match="shots per block"):
            gk.fused_layout(B, *shape, SMS, lanes=top + 1)


def test_fused_layout_refuses_what_no_lane_fits():
    # one shot of a 6000 x 12000 code of row weight 7 needs 12000 * 4 bytes
    # of totals and 42000 * 6 of messages: more than a block holds
    with pytest.raises(ValueError, match="shared memory"):
        gk.fused_layout(64, 12000, 6000, 7, 4, 6000, 7, 4, SMS)
    # rows above 32 take B5's wide instance, up to 64; 65 is refused
    with pytest.raises(ValueError, match="row weights"):
        gk.fused_layout(64, 625, 300, 65, 4, 300, 7, 4, SMS)
    for rw in (33, 64):
        shape = (625, 300, rw, 4, 300, 7, 4)
        lay = gk.fused_layout(64, *shape, SMS)
        assert lay.lanes >= 1 and lay.grid >= 1
        assert lay.smem_bytes == gk.fused_smem_bytes(lay.lanes, *shape)


def test_fused_smem_bytes_match_the_kernel_note():
    """csrc/fused_decode.cu's note gives the shared memory at hgp_34_n625."""
    shape = _fused_shape("hgp_34_n625")
    assert gk.fused_smem_bytes(0, *shape) == 28480
    assert gk.fused_smem_bytes(1, *shape) == 28480 + 16704

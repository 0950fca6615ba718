"""The launch layout and the planes of kernel 1's sector mode
(csrc/bp_minsum.cu ``bp_minsum_sectors_launch``), checked on the CPU.

A (shot, sector) item's lane region (c2v, v2c, totals, syndrome) is sized
by the largest sector, not by the whole block-diagonal graph, and the
sector's planes are numbered within it and padded to that sector's size.
Held here: on hz (+) hx of every shipped code the layout takes the
shared-memory mode with the items per block of a kernel-1 launch on one
sector (at least 8 at hgp_34_n625 and 3 at n1600 on 132 SMs); unequal
sectors are sized by the largest; the device-memory modes' scratch is one
sector's; the check-state mode stays refused; and each sector's host-built
planes, 16- and 32-bit, are entry for entry the planes of that sector's own
Tanner graph, padded.  The kernel itself runs only on the card
(tests/test_torch_bp_sectors_local_cuda.py).  Exact comparisons: sizes and
planes are integers."""
import functools
import os

import numpy as np
import pytest
import torch

from qldpc_fault_tolerance_tpu_torch.ops import bp as tbp
from qldpc_fault_tolerance_tpu_torch.ops import bp_kernel as bk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CODES = ("hgp_34_n225", "hgp_34_n625", "hgp_34_n1225", "hgp_34_n1600")
SMS = 132  # an H100 SXM's SMs
B = 4096   # chip_smoke.py phase 53's shots


@functools.lru_cache(maxsize=None)
def _pair(code):
    """hz, hx of ``code``, their block diagonal and its sectors."""
    with np.load(os.path.join(REPO, "codes_lib_tpu", f"{code}.npz")) as z:
        hs = [z[s].astype(np.uint8) for s in ("hz", "hx")]
    return hs, *_diag(hs)


def _diag(hs):
    h = np.zeros((sum(x.shape[0] for x in hs), sum(x.shape[1] for x in hs)),
                 np.uint8)
    r = c = 0
    for x in hs:
        h[r:r + x.shape[0], c:c + x.shape[1]] = x
        r, c = r + x.shape[0], c + x.shape[1]
    return h, (tuple(x.shape[0] for x in hs), tuple(x.shape[1] for x in hs))


def _dims(h):
    g = tbp.build_tanner_graph_host(h)
    return g.chk_nbr.shape[0], g.var_nbr.shape[0], g.chk_nbr.shape[1], \
        g.var_nbr.shape[1]


def _random_block(m, n, rw, rng):
    h = np.zeros((m, n), np.uint8)
    for i in range(m):
        h[i, rng.choice(n, int(rng.integers(2, rw + 1)), replace=False)] = 1
    return h


@pytest.mark.parametrize("code", CODES)
def test_an_item_is_sized_by_one_sector(code):
    hs, h, sectors = _pair(code)
    m, n, rw, cw = _dims(h)
    lay = bk.minsum_layout(2 * B, m, n, rw, cw, False, SMS, memory="auto",
                           sectors=sectors)
    ms, ns = max(sectors[0]), max(sectors[1])
    one = bk.minsum_layout(2 * B, ms, ns, rw, cw, False, SMS, memory="auto")
    assert lay.memory == "shared"
    assert (lay.lanes, lay.threads) == (one.lanes, one.threads)
    assert lay.smem_bytes == bk.minsum_smem_bytes(lay.lanes, m, n, rw, cw,
                                                  False, sectors=sectors)
    assert lay.smem_bytes <= bk.SMEM_LIMIT
    # the region of one item is one sector's: the staged planes of both
    # sectors (as many entries as the whole graph's) and one lane apart
    per_item = (bk.minsum_smem_bytes(1, ms, ns, rw, cw, False)
                - bk.minsum_smem_bytes(0, ms, ns, rw, cw, False))
    assert lay.smem_bytes == (bk.minsum_smem_bytes(0, m, n, rw, cw, False)
                              + lay.lanes * per_item)


@pytest.mark.parametrize("code,least", [("hgp_34_n625", 8),
                                        ("hgp_34_n1600", 3)])
def test_items_per_block_at_phase_53(code, least):
    _hs, h, sectors = _pair(code)
    m, n, rw, cw = _dims(h)
    lay = bk.minsum_layout(2 * B, m, n, rw, cw, False, SMS, memory="auto",
                           sectors=sectors)
    whole = bk.minsum_layout(2 * B, m, n, rw, cw, False, SMS, memory="auto")
    assert lay.lanes >= least > whole.lanes
    assert lay.grid == SMS


def test_unequal_sectors_are_sized_by_the_largest():
    rng = np.random.default_rng(5)
    shapes = ((40, 90, 6), (75, 160, 9), (12, 30, 4))
    hs = [_random_block(*s, rng) for s in shapes]
    h, sectors = _diag(hs)
    m, n, rw, cw = _dims(h)
    ms, ns = 75, 160
    for lanes in (1, 3):
        got = bk.minsum_smem_bytes(lanes, m, n, rw, cw, False,
                                   sectors=sectors)
        staged = (bk._align16(2 * 3 * ms * rw) + bk._align16(2 * 3 * ns * cw)
                  + bk._align16(4 * n))
        per_item = (bk.minsum_smem_bytes(1, ms, ns, rw, cw, False)
                    - bk.minsum_smem_bytes(0, ms, ns, rw, cw, False))
        assert got == staged + lanes * per_item
    lay = bk.minsum_layout(600, m, n, rw, cw, False, SMS, memory="auto",
                           sectors=sectors)
    assert lay.threads // lay.lanes == 160  # the largest sector's rows


@pytest.mark.parametrize("memory", ["device", "device_planes"])
def test_device_scratch_is_one_sector(memory):
    _hs, h, sectors = _pair("hgp_34_n1600")
    m, n, rw, cw = _dims(h)
    ms, ns = max(sectors[0]), max(sectors[1])
    lay = bk.minsum_layout(2 * B, m, n, rw, cw, False, SMS, memory=memory,
                           sectors=sectors)
    whole = bk.minsum_layout(2 * B, m, n, rw, cw, False, SMS, memory=memory)
    assert lay.lane_bytes == (bk.minsum_smem_bytes(1, ms, ns, rw, cw, False)
                              - bk.minsum_smem_bytes(0, ms, ns, rw, cw, False))
    assert 2 * lay.lane_bytes <= whole.lane_bytes + 64


def test_sector_mode_refuses_the_check_state_mode():
    _hs, h, sectors = _pair("hgp_34_n625")
    m, n, rw, cw = _dims(h)
    with pytest.raises(ValueError, match="check-state"):
        bk.minsum_layout(2 * B, m, n, rw, cw, False, SMS, memory="checks",
                         sectors=sectors)


def _padded(a, shape, pad):
    out = np.full(shape, pad, np.int64)
    out[:, :a.shape[1]] = a
    return out


@pytest.mark.parametrize("wide", [False, True], ids=["planes16", "planes32"])
@pytest.mark.parametrize("case", ["hgp_34_n225", "three"])
def test_sector_planes_are_each_sectors_own(case, wide):
    if case == "three":
        rng = np.random.default_rng(7)
        hs = [_random_block(*s, rng) for s in ((20, 45, 6), (35, 80, 9),
                                               (8, 16, 3))]
        h, sectors = _diag(hs)
    else:
        hs, h, sectors = _pair(case)
    graph = tbp.build_tanner_graph(h, "cpu")
    split = bk.check_sectors(graph, sectors)
    planes = bk.minsum_planes(graph, wide, split)
    ms, ns = max(sectors[0]), max(sectors[1])
    pad = -1 if wide else bk.PAD16
    as_int = (lambda t: t.numpy().astype(np.int64)) if wide else \
        (lambda t: t.numpy().view(np.uint16).astype(np.int64))
    chk, edge = as_int(planes.chk), as_int(planes.edge)
    assert chk.shape == (len(hs), graph.chk_nbr.shape[1], ms)
    assert edge.shape == (len(hs), graph.var_nbr.shape[1], ns)
    for k, hb in enumerate(hs):
        own = bk.minsum_planes(tbp.build_tanner_graph(hb, "cpu"), wide)
        rw_k, cw_k = own.chk.shape[0], own.edge.shape[0]
        own_chk = _padded(as_int(own.chk), (rw_k, ms), pad)
        # the sector's own edges s * m_k + i, renumbered to the stride ms
        oe = as_int(own.edge)
        m_k = hb.shape[0]
        own_edge = _padded(np.where(oe != pad, oe // m_k * ms + oe % m_k,
                                    pad), (cw_k, ns), pad)
        assert np.array_equal(chk[k, :rw_k], own_chk)
        assert (chk[k, rw_k:] == pad).all()
        assert np.array_equal(edge[k, :cw_k], own_edge)
        assert (edge[k, cw_k:] == pad).all()
    assert torch.equal(planes.lens, bk.minsum_planes(graph, wide).lens)

"""Kernel 1's sector mode with sector-local lane regions, on the card
(``bp_kernel.bp_minsum(sectors=)``, ``csrc/bp_minsum.cu``
``bp_minsum_sectors_launch``): each (shot, sector) item decodes over its
sector's own planes in a region sized by the largest sector.  Held bit-exact
against its plain version and against one kernel-1 launch per sector, for
two and three sectors of unequal shapes and for hz (+) hx of hgp_34_n1600,
in the shared-memory mode (kMem 0) and both device-memory modes (kMem 1 and
2), with the layout's items per block those of one sector.  Tolerance:
none, every output bit-exact.  Needs an NVIDIA GPU; skips without one."""
import os

import numpy as np
import pytest
import torch

from qldpc_fault_tolerance_tpu_torch.ops import _kernels
from qldpc_fault_tolerance_tpu_torch.ops import bp as tbp
from qldpc_fault_tolerance_tpu_torch.ops import bp_kernel as bk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _random_block(m, n, rw, rng):
    h = np.zeros((m, n), np.uint8)
    for i in range(m):
        h[i, rng.choice(n, int(rng.integers(2, rw + 1)), replace=False)] = 1
    return h


def _blocks(case, rng):
    if case == "n1600":
        with np.load(os.path.join(REPO, "codes_lib_tpu",
                                  "hgp_34_n1600.npz")) as z:
            return [z[s].astype(np.uint8) for s in ("hz", "hx")]
    shapes = {"two": ((60, 125, 7), (90, 170, 8)),
              "three": ((40, 90, 6), (75, 160, 9), (12, 30, 4))}[case]
    return [_random_block(m, n, rw, rng) for m, n, rw in shapes]


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("memory", ["shared", "device", "device_planes"])
@pytest.mark.parametrize("case", ["two", "three", "n1600"])
def test_sector_local_regions_match_plain_and_separate(cuda, case, memory):
    rng = np.random.default_rng(11)
    hs = _blocks(case, rng)
    m, n = sum(x.shape[0] for x in hs), sum(x.shape[1] for x in hs)
    h = np.zeros((m, n), np.uint8)
    r = c = 0
    for x in hs:
        h[r:r + x.shape[0], c:c + x.shape[1]] = x
        r, c = r + x.shape[0], c + x.shape[1]
    sectors = (tuple(x.shape[0] for x in hs), tuple(x.shape[1] for x in hs))
    B = 1024 if case == "n1600" else 300
    synds = [torch.from_numpy(((rng.random((B, x.shape[1])) < 0.03) @ x.T % 2)
                              .astype(np.uint8)).to(cuda) for x in hs]
    synd = torch.cat(synds, dim=1)
    graph = tbp.build_tanner_graph(h, cuda)
    llr = tbp.llr_from_probs(np.linspace(0.01, 0.05, n), cuda)
    rw, cw = graph.chk_nbr.shape[1], graph.var_nbr.shape[1]
    lay = bk.card_minsum_layout(cuda, B * len(hs), m, n, rw, cw, False,
                                memory=memory, sectors=sectors)
    one = bk.card_minsum_layout(cuda, B * len(hs), max(sectors[0]),
                                max(sectors[1]), rw, cw, False,
                                memory=memory)
    assert (lay.lanes, lay.threads, lay.lane_bytes) == (
        one.lanes, one.threads, one.lane_bytes)
    before = bk.bp_minsum.sector_launches
    with _kernels.force_memory(memory):
        k = bk.bp_minsum(graph, synd, llr, max_iter=50, sectors=sectors)
    assert bk.bp_minsum.sector_launches == before + 1
    with _kernels.force_plain():
        plain = bk.bp_minsum(graph, synd, llr, max_iter=50, sectors=sectors)
    assert _equal(k, plain)
    parts, v0 = [], 0
    for x, sb in zip(hs, synds):
        parts.append(bk.bp_minsum(tbp.build_tanner_graph(x, cuda), sb,
                                  llr[v0:v0 + x.shape[1]].contiguous(),
                                  max_iter=50))
        v0 += x.shape[1]
    sep = (torch.cat([q[0] for q in parts], 1),
           torch.stack([q[1] for q in parts]).all(0),
           torch.cat([q[2] for q in parts], 1),
           torch.stack([q[3] for q in parts]).amax(0))
    assert _equal(k, sep)

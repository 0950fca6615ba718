"""Kernel 1's sector mode on the card (``bp_kernel.bp_minsum(sectors=)``,
``csrc/bp_minsum.cu`` ``bp_minsum_sectors_launch``): a block-diagonal graph
decoded as independent sectors, against its plain version and against one
kernel-1 launch per sector, in the shared-memory and both device-memory
modes, at 0, 1, 3 and 50 iterations, with shared and per-shot channel LLRs,
and at two and three sectors of unequal shapes.  Tolerance: none, every
output bit-exact.  Needs an NVIDIA GPU; skips without one."""
import numpy as np
import pytest
import torch

from qldpc_fault_tolerance_tpu_torch.ops import _kernels
from qldpc_fault_tolerance_tpu_torch.ops import bp as tbp
from qldpc_fault_tolerance_tpu_torch.ops import bp_kernel as bk


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _block(m, n, rw, rng):
    h = np.zeros((m, n), np.uint8)
    for i in range(m):
        h[i, rng.choice(n, int(rng.integers(2, rw + 1)), replace=False)] = 1
    return h


def _case(shapes, dev, B=300, p=0.03, seed=0):
    """Sector matrices of ``shapes`` ((m, n, rw) each), their block
    diagonal, and per-sector syndromes of errors at rate p."""
    rng = np.random.default_rng(seed)
    hs = [_block(m, n, rw, rng) for m, n, rw in shapes]
    M, N = sum(h.shape[0] for h in hs), sum(h.shape[1] for h in hs)
    h = np.zeros((M, N), np.uint8)
    r = c = 0
    for hb in hs:
        h[r:r + hb.shape[0], c:c + hb.shape[1]] = hb
        r, c = r + hb.shape[0], c + hb.shape[1]
    synds = [torch.from_numpy(((rng.random((B, hb.shape[1])) < p) @ hb.T % 2)
                              .astype(np.uint8)).to(dev) for hb in hs]
    sectors = (tuple(hb.shape[0] for hb in hs), tuple(hb.shape[1] for hb in hs))
    return hs, h, synds, sectors


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("memory", ["auto", "shared", "device",
                                    "device_planes"])
@pytest.mark.parametrize("iters", [0, 1, 3, 50])
@pytest.mark.parametrize("shapes", [((60, 125, 7), (60, 125, 7)),
                                    ((40, 90, 6), (75, 160, 9), (12, 30, 4))],
                         ids=["two", "three"])
def test_sector_mode_matches_plain_and_separate(cuda, shapes, iters, memory):
    hs, h, synds, sectors = _case(shapes, cuda)
    graph = tbp.build_tanner_graph(h, cuda)
    p = np.linspace(0.01, 0.05, h.shape[1])
    llr = tbp.llr_from_probs(p, cuda)
    synd = torch.cat(synds, dim=1)
    before = (bk.bp_minsum.sector_launches, bk.bp_minsum.launches)
    if memory == "auto":
        k = bk.bp_minsum(graph, synd, llr, max_iter=iters, sectors=sectors)
    else:
        with _kernels.force_memory(memory):
            k = bk.bp_minsum(graph, synd, llr, max_iter=iters,
                             sectors=sectors)
    assert bk.bp_minsum.sector_launches == before[0] + 1
    assert bk.bp_minsum.launches == before[1]
    with _kernels.force_plain():
        plain = bk.bp_minsum(graph, synd, llr, max_iter=iters,
                             sectors=sectors)
    assert _equal(k, plain)
    # one kernel-1 launch per sector, then AND / max across them
    parts, v0 = [], 0
    for hb, sb in zip(hs, synds):
        n = hb.shape[1]
        parts.append(bk.bp_minsum(tbp.build_tanner_graph(hb, cuda), sb,
                                  llr[v0:v0 + n].contiguous(),
                                  max_iter=iters))
        v0 += n
    sep = (torch.cat([q[0] for q in parts], 1),
           torch.stack([q[1] for q in parts]).all(0),
           torch.cat([q[2] for q in parts], 1),
           torch.stack([q[3] for q in parts]).amax(0))
    assert _equal(k, sep)


@pytest.mark.cuda
def test_sector_mode_per_shot_llr(cuda):
    hs, h, synds, sectors = _case(((60, 125, 7), (60, 125, 7)), cuda, B=64,
                                  seed=3)
    graph = tbp.build_tanner_graph(h, cuda)
    rng = np.random.default_rng(4)
    llr = torch.from_numpy(rng.uniform(1.0, 5.0, (64, h.shape[1]))
                           .astype(np.float32)).to(cuda)
    synd = torch.cat(synds, dim=1)
    k = bk.bp_minsum(graph, synd, llr, max_iter=30, sectors=sectors)
    with _kernels.force_plain():
        plain = bk.bp_minsum(graph, synd, llr, max_iter=30, sectors=sectors)
    assert _equal(k, plain)


@pytest.mark.cuda
def test_sector_mode_refuses_check_state(cuda):
    _hs, h, synds, sectors = _case(((60, 125, 7), (60, 125, 7)), cuda, B=8)
    graph = tbp.build_tanner_graph(h, cuda)
    llr = tbp.llr_from_probs(np.full(h.shape[1], 0.03), cuda)
    with _kernels.force_memory("checks"), pytest.raises(ValueError):
        bk.bp_minsum(graph, torch.cat(synds, 1), llr, max_iter=5,
                     sectors=sectors)


@pytest.mark.cuda
def test_sector_mode_refuses_cross_sector_edge(cuda):
    """A check of one sector touching a variable of another: the sector
    mode's lanes would read messages no one wrote, so the wrapper raises
    before it launches."""
    _hs, h, synds, sectors = _case(((60, 125, 7), (60, 125, 7)), cuda, B=8)
    h = h.copy()
    h[0, -1] = 1
    graph = tbp.build_tanner_graph(h, cuda)
    llr = tbp.llr_from_probs(np.full(h.shape[1], 0.03), cuda)
    before = bk.bp_minsum.sector_launches
    with pytest.raises(ValueError, match="block diagonally"):
        bk.bp_minsum(graph, torch.cat(synds, 1), llr, max_iter=5,
                     sectors=sectors)
    assert bk.bp_minsum.sector_launches == before

"""Port ops/osd_device.py against the JAX package's device OSD on the CPU.

Bit packing and the GF(2) elimination are integer-exact: compared bit for
bit with the JAX blocked twin and with the TPU kernel in interpret mode.
OSD-E scoring is float32 matmuls whose summation order differs between XLA
and PyTorch: a decoded shot must equal the JAX one or, where it differs, be
syndrome-consistent with a total cost within 1e-4 of the JAX solution's (the
float32 tie contract of qldpc_fault_tolerance_tpu/ops/osd_device.py:20-25).
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qldpc_fault_tolerance_tpu.decoders import bp_decoders as jdec
from qldpc_fault_tolerance_tpu.decoders.osd import _channel_cost, _osd_numpy
from qldpc_fault_tolerance_tpu.ops import osd_device as jod
from qldpc_fault_tolerance_tpu_torch.codes import load_code
from qldpc_fault_tolerance_tpu_torch.decoders import osd_compaction_tiers
from qldpc_fault_tolerance_tpu_torch.ops import osd_device as tod

# one intra-op thread: the suite runs several pytest workers on few cores,
# and an oversubscribed torch thread pool stalls small ops
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _case(seed, m, n, B):
    rng = np.random.default_rng(seed)
    h = (rng.random((m, n)) < 0.25).astype(np.uint8)
    h[:, h.sum(0) == 0] = 1
    probs = rng.uniform(0.01, 0.3, n)
    post = rng.normal(0, 2, (B, n)).astype(np.float32)
    synd = ((rng.random((B, n)) < 0.1).astype(np.uint8) @ h.T % 2).astype(np.uint8)
    return h, probs, post, synd


def _both(h, probs, post, synd):
    jplan = jod.build_osd_plan(h, probs)
    tplan = tod.build_osd_plan(h, probs, device="cpu")
    jperm = jnp.argsort(jnp.asarray(post), axis=1, stable=True).astype(jnp.int32)
    tperm = torch.sort(torch.from_numpy(post), dim=1, stable=True).indices
    assert np.array_equal(np.asarray(jperm), tperm.numpy())
    tpacked = tod._permute_and_pack(tod._unpack_rows(tplan.packed, h.shape[1]),
                                    tperm)
    tsynd = torch.from_numpy(synd).to(torch.int32).t().contiguous()
    return jplan, tplan, jperm, tperm, tpacked, tsynd


@pytest.mark.parametrize("seed,m,n,B", [(0, 12, 24, 8), (1, 33, 70, 16),
                                        (2, 40, 97, 5)])
def test_plan_and_permute_and_pack_match_jax(seed, m, n, B):
    h, probs, post, synd = _case(seed, m, n, B)
    jplan, tplan, jperm, _, tpacked, _ = _both(h, probs, post, synd)
    assert tplan.rank == jplan.rank
    assert np.array_equal(tplan.packed.numpy().view(np.uint32),
                          np.asarray(jplan.packed))
    assert np.array_equal(tplan.cost.numpy(), np.asarray(jplan.cost))
    jpacked = jod._permute_and_pack(jod._unpack_rows(jplan.packed, n), jperm)
    assert np.array_equal(tpacked.numpy().view(np.uint32), np.asarray(jpacked))


@pytest.mark.parametrize("fcap", [0, 4, 10])
@pytest.mark.parametrize("seed,m,n,B", [(3, 14, 40, 16), (4, 30, 75, 9)])
def test_plain_elimination_matches_jax_twin(seed, m, n, B, fcap):
    h, probs, post, synd = _case(seed, m, n, B)
    jplan, tplan, jperm, tperm, tpacked, tsynd = _both(h, probs, post, synd)
    ref = jod._eliminate_blocked_twin(jplan, jperm, jnp.asarray(synd),
                                      fcap=fcap)
    out = tod.osd_elim(tplan.packed, tperm, tsynd, n=n, r_star=tplan.rank,
                       fcap=fcap)
    for a, b in zip(ref, out):
        assert np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("fcap", [0, 10])
@pytest.mark.parametrize("seed,m,n,B", [(3, 14, 40, 16), (4, 30, 75, 9)])
def test_full_elimination_matches_jax_twin(seed, m, n, B, fcap):
    """The OSD-CS route: all six outputs, the reduced matrix whole (its
    non-pivot rows agree too, though the decode reads only pivot rows)."""
    h, probs, post, synd = _case(seed, m, n, B)
    jplan, tplan, jperm, tperm, tpacked, tsynd = _both(h, probs, post, synd)
    ref = jod._eliminate_blocked_twin(jplan, jperm, jnp.asarray(synd),
                                      fcap=fcap, full=True)
    out = tod.osd_elim(tplan.packed, tperm, tsynd, n=n, r_star=tplan.rank,
                       fcap=fcap, full=True)
    assert len(ref) == len(out) == 6
    for a, b in zip(ref, out):
        assert np.array_equal(np.asarray(a).view(np.int32), b.numpy())
    # the first five outputs are the skip route's; a free panel adds one
    # word per cleared row to the work
    for a, b in zip(out, tod.osd_elim(tplan.packed, tperm, tsynd, n=n,
                                      r_star=tplan.rank, fcap=fcap)):
        assert torch.equal(a, b)
    work = [tod.elimination_work(tpacked, tsynd, n=n, r_star=tplan.rank,
                                 fcap=cap) for cap in (0, fcap)]
    assert work[1] > work[0] > 0 if fcap else work[1] == work[0] > 0


def test_full_elimination_matches_tpu_kernel_interpret():
    h, probs, post, synd = _case(12, 14, 40, 16)
    jplan, tplan, jperm, tperm, tpacked, tsynd = _both(h, probs, post, synd)
    ref = jod._eliminate_pallas_blocked(jplan, jperm, jnp.asarray(synd),
                                        fcap=8, bt=8, interpret=True,
                                        full=True)
    out = tod.eliminate_plain(tpacked, tsynd, n=40, r_star=tplan.rank, fcap=8,
                              full=True)
    for a, b in zip(ref, out):
        assert np.array_equal(np.asarray(a), b.numpy())



def _same_percol(ref, out):
    """(u_piv, pr, pc, ip, packed) of the JAX package against the port's."""
    for a, b in zip(ref, out):
        a = np.asarray(a)
        b = b.numpy()
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        assert np.array_equal(a.astype(b.dtype), b)


@pytest.mark.parametrize("seed,m,n,B", [(5, 14, 40, 16), (6, 30, 75, 9),
                                        (7, 24, 64, 8)])
def test_percol_elimination_matches_jax(seed, m, n, B):
    """``eliminate_percol_plain`` against ``_eliminate``; every output, the
    reduced matrix whole, and it equals the full blocked route's matrix."""
    h, probs, post, synd = _case(seed, m, n, B)
    jplan, tplan, jperm, tperm, tpacked, tsynd = _both(h, probs, post, synd)
    out = tod.osd_elim_percol(tplan.packed, tperm, tsynd, n=n,
                              r_star=tplan.rank)
    _same_percol(jod._eliminate(jplan, jperm, jnp.asarray(synd)), out)
    full = tod.eliminate_plain(tpacked, tsynd, n=n, r_star=tplan.rank, fcap=0,
                               full=True)
    assert torch.equal(out[1], full[1]) and torch.equal(out[2], full[2])
    assert torch.equal(out[4], full[5])
    assert tod.elimination_work(tpacked, tsynd, n=n, r_star=tplan.rank,
                                fcap=0) > 0


def test_percol_elimination_matches_tpu_kernel_interpret():
    h, probs, post, synd = _case(13, 14, 40, 16)
    jplan, tplan, jperm, tperm, tpacked, tsynd = _both(h, probs, post, synd)
    ref = jod._eliminate_pallas(jplan, jperm, jnp.asarray(synd), bt=8,
                                interpret=True)
    _same_percol(ref, tod.eliminate_percol_plain(tpacked, tsynd, n=40,
                                                 r_star=tplan.rank))


@pytest.mark.parametrize("order", [0, 6])
def test_osd_decode_percol_route_within_tie_contract(order):
    """The ``"pallas_percol"`` route against the JAX package's per-column
    XLA route, and equal to the port's blocked route shot for shot."""
    code = load_code(os.path.join(REPO, "codes_lib_tpu", "hgp_34_n225.npz"))
    h, n = code.hz, code.N
    rng = np.random.default_rng(40 + order)
    B = 24
    probs = np.full(n, 0.03)
    err = (rng.random((B, n)) < 0.05).astype(np.uint8)
    synd = (err @ h.T % 2).astype(np.uint8)
    post = (rng.normal(0, 1, (B, n)) + 3.0 * (1 - 2 * err)).astype(np.float32)
    jplan = jod.build_osd_plan(h, probs)
    tplan = tod.build_osd_plan(h, probs, device="cpu")
    ref = np.asarray(jod.osd_decode_values(
        (n, jplan.rank, order, 256, "percol"), jplan.packed, jplan.cost,
        jnp.asarray(synd), jnp.asarray(post)))
    args = (tplan.packed, tplan.cost, torch.from_numpy(synd),
            torch.from_numpy(post))
    out, blocked = (tod.osd_decode_values((n, tplan.rank, order, 256, elim),
                                          *args, device="cpu")
                    for elim in ("pallas_percol", "pallas"))
    assert torch.equal(out, blocked)
    out = out.numpy()
    cost = _channel_cost(probs)
    assert ((out.astype(np.int64) @ h.T % 2) == synd).all()
    assert ((out == ref).all(axis=1) | (np.abs(out @ cost - ref @ cost) < 1e-4)).all()


def test_plain_elimination_matches_tpu_kernel_interpret():
    """As tests/test_osd_device.py runs the blocked kernel: interpret mode,
    bt=8, m=14, n=40, B=16, w=8."""
    h, probs, post, synd = _case(12, 14, 40, 16)
    jplan, tplan, jperm, tperm, tpacked, tsynd = _both(h, probs, post, synd)
    ref = jod._eliminate_pallas_blocked(jplan, jperm, jnp.asarray(synd),
                                        fcap=8, bt=8, interpret=True)
    out = tod.eliminate_plain(tpacked, tsynd, n=40, r_star=tplan.rank, fcap=8)
    for a, b in zip(ref, out):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert tod.elimination_work(tpacked, tsynd, n=40, r_star=tplan.rank,
                                fcap=8) > 0


@pytest.mark.parametrize("order", [0, 4, 10])
def test_osd_decode_values_within_tie_contract(order):
    code = load_code(os.path.join(REPO, "codes_lib_tpu", "hgp_34_n225.npz"))
    h = code.hx
    n = h.shape[1]
    rng = np.random.default_rng(order)
    B = 32
    probs = np.full(n, 0.03)
    err = (rng.random((B, n)) < 0.05).astype(np.uint8)
    synd = (err @ h.T % 2).astype(np.uint8)
    post = (rng.normal(0, 1, (B, n)) + 3.0 * (1 - 2 * err)).astype(np.float32)
    jplan = jod.build_osd_plan(h, probs)
    tplan = tod.build_osd_plan(h, probs, device="cpu")
    ref = np.asarray(jod.osd_decode_values(
        (n, jplan.rank, order, 256, "twin"), jplan.packed, jplan.cost,
        jnp.asarray(synd), jnp.asarray(post)))
    out = tod.osd_decode_device(tplan, torch.from_numpy(synd),
                                torch.from_numpy(post), osd_order=order).numpy()
    cost = _channel_cost(probs)
    exact = (out == ref).all(axis=1)
    synd_ok = ((out.astype(np.int64) @ h.T % 2) == synd).all(axis=1)
    tied = np.abs(out @ cost - ref @ cost) < 1e-4
    assert synd_ok.all()
    assert (exact | tied).all()
    # and against the host numpy oracle under the same contract
    oracle = _osd_numpy(h, synd, post.astype(np.float64), cost,
                        1 if order else 0, order)
    assert ((out == oracle).all(axis=1)
            | (np.abs(out @ cost - oracle @ cost) < 1e-4)).all()


@pytest.mark.parametrize("B", [1, 63, 64, 128, 256, 2048, 4096, 1000])
def test_osd_compaction_tiers_match_jax(B):
    assert osd_compaction_tiers(B) == jdec.osd_compaction_tiers(B)

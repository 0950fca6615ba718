"""Port ops/osd_cs_device.py (device OSD-CS) against the JAX package on the CPU.

  * The sweep's static helpers (``_cs_plane``, ``cs_pat_chunk``,
    ``cs_sweep_shape``) equal the JAX package's.
  * ``cs_sweep_plain``, given the same ``dplane``, ``xflat`` and base,
    equals ``_cs_sweep_xla`` and the TPU kernel ``_cs_sweep_pallas`` in
    interpret mode bit for bit, in cost and index, and its index does not
    change with ``pat_chunk``.  Tolerance: none.
  * The whole decode: the planes' float32 sums over r* terms run in another
    order than XLA's, so each shot must equal the JAX package's device OSD-CS
    and its host oracle (``decoders.osd.osd_decode_batch``), or be
    syndrome-consistent with a total cost within 1e-4 of theirs (the float32
    tie contract of ``tests/test_osd_cs_device.py``).
  * The per-column elimination route gives the blocked route's corrections
    shot for shot; a BPOSD-CS decoder runs through the unfused engine and
    through ``fused_sampler=True``, whose failures equal the JAX engine's
    for the same key, up to shots shown to be cost ties.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import qldpc_fault_tolerance_tpu.decoders as jdec
import qldpc_fault_tolerance_tpu.sim.data_error as jde
from qldpc_fault_tolerance_tpu.decoders.osd import _channel_cost, osd_decode_batch
from qldpc_fault_tolerance_tpu.ops import osd_cs_device as jcs
from qldpc_fault_tolerance_tpu.ops import osd_device as jod
from qldpc_fault_tolerance_tpu_torch import decoders as tdec
from qldpc_fault_tolerance_tpu_torch.codes import hgp, load_code, ring_code
from qldpc_fault_tolerance_tpu_torch.ops import gf2_kernel as gk
from qldpc_fault_tolerance_tpu_torch.ops import osd_cs_device as tcs
from qldpc_fault_tolerance_tpu_torch.ops import osd_device as tod
from qldpc_fault_tolerance_tpu_torch.ops.gf2_packed import unpack_shots
from qldpc_fault_tolerance_tpu_torch.sim import CodeSimulator_DataError

# one intra-op thread: the suite runs several pytest workers on few cores,
# and an oversubscribed torch thread pool stalls small ops
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fixture_h(kind, rng):
    """tests/test_osd_cs_device.py's three fixtures."""
    if kind == "tall":
        h = (rng.random((48, 40)) < 0.2).astype(np.uint8)
    elif kind == "rank_deficient":
        h = (rng.random((24, 60)) < 0.18).astype(np.uint8)
        h[-1] = h[0]
    else:
        h = (rng.random((20, 48)) < 0.22).astype(np.uint8)
    h[:, h.sum(0) == 0] = 1
    return h


def _within_contract(out, refs, h, synd, cost):
    """Each shot bit-equal to every reference, or syndrome-consistent with a
    total cost within 1e-4 of it."""
    synd_ok = ((out.astype(np.int64) @ h.T % 2) == synd).all(axis=1)
    assert synd_ok.all()
    for ref in refs:
        exact = (out == ref).all(axis=1)
        tied = np.abs(out @ cost - ref @ cost) < 1e-4
        assert (exact | tied).all(), int((~(exact | tied)).sum())


@pytest.mark.parametrize("n,rank,order", [(625, 300, 10), (48, 20, 4),
                                          (60, 23, 10), (40, 40, 4),
                                          (1600, 700, 20), (30, 10, 0)])
def test_cs_static_helpers_match_jax(n, rank, order):
    assert tcs.cs_pat_chunk(n, rank, order) == jcs.cs_pat_chunk(n, rank, order)
    assert tcs.cs_sweep_shape(n, rank, order) == jcs.cs_sweep_shape(n, rank,
                                                                     order)
    f, w, _ = tcs._cs_counts(n, rank, order)
    chunk = tcs.cs_pat_chunk(n, rank, order)
    mine, theirs = tcs._cs_plane(f, w, chunk), jcs._cs_plane(f, w, chunk)
    for a, b in zip(mine, theirs):
        assert np.array_equal(a, b)
    if (n, rank, order) == (625, 300, 10):
        assert (f, w, mine[4], chunk) == (325, 10, 371, 64)


def _planes(rng, f, w, B, ties):
    if ties:  # coarse values: many exact cost ties exercise the first-min rule
        dplane = rng.integers(-3, 4, (f, B)).astype(np.float32)
        xflat = rng.integers(-2, 3, (w * w, B)).astype(np.float32)
        base = rng.integers(0, 3, B).astype(np.float32)
    else:
        dplane = rng.normal(size=(f, B)).astype(np.float32)
        xflat = rng.normal(size=(w * w, B)).astype(np.float32)
        base = rng.normal(size=(B,)).astype(np.float32)
    return dplane, xflat, base


@pytest.mark.parametrize("f,w,chunk,ties", [(14, 5, 8, False), (14, 5, 8, True),
                                            (325, 10, 64, False),
                                            (325, 10, 64, True)])
def test_cs_sweep_plain_matches_jax_twin_and_kernel(f, w, chunk, ties):
    """The JAX test's shape (f=14, w=5, chunk 8: a ragged final chunk of
    pad rows) and hgp_34_n625's at osd_order 10, B=256, bt=128."""
    rng = np.random.default_rng(f + ties)
    B = 256
    dplane, xflat, base = _planes(rng, f, w, B, ties)
    e1t, e2t, *_ = jcs._cs_plane(f, w, chunk)
    args = [jnp.asarray(a) for a in (e1t, e2t, dplane, xflat, base)]
    twin = jcs._cs_sweep_xla(*args, chunk)
    kern = jcs._cs_sweep_pallas(*args, chunk, bt=128, interpret=True)
    t_args = [torch.from_numpy(a) for a in (dplane, xflat, base)]
    cost, idx = tcs.cs_sweep(*t_args, w=w, pat_chunk=chunk)
    for ref in (twin, kern):
        assert np.array_equal(np.asarray(ref[0]), cost.numpy())
        assert np.array_equal(np.asarray(ref[1]), idx.numpy())
    assert (idx > 0).any()
    for other in (1, 7, 512):
        c2, i2 = tcs.cs_sweep_plain(*t_args, w=w, pat_chunk=other)
        assert torch.equal(i2, idx) and torch.equal(c2, cost)


def _decode_case(kind, order, seed=5, B=96):
    rng = np.random.default_rng(seed)
    h = _fixture_h(kind, rng)
    n = h.shape[1]
    probs = rng.uniform(0.01, 0.2, n)
    err = (rng.random((B, n)) < 0.06).astype(np.uint8)
    synd = (err @ h.T % 2).astype(np.uint8)
    post = (rng.normal(0, 1, (B, n)) + 3.0 * (1 - 2 * err)).astype(np.float32)
    return h, probs, synd, post


@pytest.mark.parametrize("order", [0, 4, 10])
@pytest.mark.parametrize("kind", ["tall", "rank_deficient", "random"])
def test_osd_cs_decode_values_within_tie_contract(kind, order):
    h, probs, synd, post = _decode_case(kind, order)
    n = h.shape[1]
    jplan = jod.build_osd_plan(h, probs)
    tplan = tod.build_osd_plan(h, probs, device="cpu")
    chunk = jcs.cs_pat_chunk(n, jplan.rank, order)
    ref = np.asarray(jcs.osd_cs_decode_values(
        (n, jplan.rank, order, chunk, "twin"), jplan.packed, jplan.cost,
        jnp.asarray(synd), jnp.asarray(post)))
    out = tcs.osd_cs_decode_device(tplan, torch.from_numpy(synd),
                                   torch.from_numpy(post),
                                   osd_order=order).numpy()
    host = osd_decode_batch(h, synd, post, probs, osd_method="osd_cs",
                            osd_order=order)
    _within_contract(out, (ref, host), h, synd, _channel_cost(probs))


@pytest.mark.parametrize("kind", ["rank_deficient", "random"])
def test_percol_route_equals_blocked_route(kind):
    """Same pivots give the same T and the same costs: the per-column route
    gives the blocked route's corrections shot for shot, for OSD-E and
    OSD-CS."""
    h, probs, synd, post = _decode_case(kind, 6, seed=8)
    n = h.shape[1]
    tplan = tod.build_osd_plan(h, probs, device="cpu")
    args = (tplan.packed, tplan.cost, torch.from_numpy(synd),
            torch.from_numpy(post))
    for decode, chunk in ((tod.osd_decode_values, 256),
                          (tcs.osd_cs_decode_values, 64)):
        a, b = (decode((n, tplan.rank, 6, chunk, elim), *args, device="cpu")
                for elim in ("pallas", "pallas_percol"))
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="route"):
        tcs.osd_cs_decode_values((n, tplan.rank, 6, 64, "twin"), *args,
                                 device="cpu")


def test_osd_cs_order_cap_and_degenerate_ranks():
    h = np.eye(6, dtype=np.uint8)
    probs = np.full(6, 0.05)
    plan = tod.build_osd_plan(h, probs, device="cpu")
    synd = torch.from_numpy(np.eye(6, dtype=np.uint8)[:3])
    post = torch.zeros((3, 6))
    with pytest.raises(ValueError, match="OSD_CS_MAX_ORDER"):
        tcs.osd_cs_decode_device(plan, synd, post, osd_order=21)
    # full column rank (f == 0): the OSD-0 solution
    assert torch.equal(tcs.osd_cs_decode_device(plan, synd, post), synd)
    # rank 0: nothing to eliminate, the zero correction
    zero = tod.build_osd_plan(np.zeros((2, 5), np.uint8), np.full(5, 0.1),
                              device="cpu")
    before = tod.osd_elim.full_launches
    out = tcs.osd_cs_decode_device(zero, torch.zeros((4, 2), dtype=torch.uint8),
                                   torch.zeros((4, 5)))
    assert torch.equal(out, torch.zeros((4, 5), dtype=torch.uint8))
    assert tod.osd_elim.full_launches == before


def test_bposd_cs_decoder_matches_jax_device_and_host():
    code = hgp(ring_code(3), ring_code(3))
    h, n = code.hx, code.N
    probs = np.full(n, 0.05)
    rng = np.random.default_rng(2)
    err = (rng.random((300, n)) < 0.1).astype(np.uint8)
    synd = (err @ h.T % 2).astype(np.uint8)
    mine = tdec.BPOSD_Decoder(h, probs, 8, osd_method="osd_cs", osd_order=6,
                              device="cpu")
    assert mine.device_static[5:] == ("pallas", "osd_cs")
    dev = jdec.BPOSD_Decoder(h, probs, 8, osd_method="osd_cs", osd_order=6)
    host = jdec.BPOSD_Decoder(h, probs, 8, osd_method="osd_cs", osd_order=6,
                              device_osd=False)
    out = mine.decode_batch(synd)
    _within_contract(out, (np.asarray(dev.decode_batch(synd)),
                           np.asarray(host.decode_batch(synd))),
                     h, synd, _channel_cost(probs))


@pytest.fixture(scope="module")
def n225():
    return load_code(os.path.join(REPO, "codes_lib_tpu", "hgp_34_n225.npz"))


def _bposd_cs(pkg, code, p, **kw):
    probs = np.full(code.N, 2 * p / 3)
    return [pkg.BPOSD_Decoder(h, probs, 20, osd_method="osd_cs", osd_order=6,
                              **kw) for h in (code.hz, code.hx)]


def _failures(wer, shots, K):
    return int(round((1 - (1 - wer) ** K) * shots))


def test_bposd_cs_fused_v1_matches_jax_engine(n225):
    """Same key, same counter-PRNG errors: the port's fused v1 engine with
    BPOSD-CS decoders gives the JAX engine's failures and min weight, up to
    the shots whose corrections differ, each of which must be a
    syndrome-consistent cost tie (float32 sums in another order)."""
    p, B, n_batches = 0.06, 256, 2
    jdx, jdz = _bposd_cs(jdec, n225, p)
    jsim = jde.CodeSimulator_DataError(
        code=n225, decoder_x=jdx, decoder_z=jdz,
        pauli_error_probs=[p / 3] * 3, seed=3, batch_size=B,
        fused_sampler=True)
    jwer = jsim.WordErrorRate(n_batches * B, jax.random.PRNGKey(9))
    tdx, tdz = _bposd_cs(tdec, n225, p, device="cpu")
    sims = {fused: CodeSimulator_DataError(
        code=n225, decoder_x=tdx, decoder_z=tdz, pauli_error_probs=[p / 3] * 3,
        seed=3, batch_size=B, fused_sampler=fused, device="cpu")
        for fused in (True, False)}
    twer = sims[True].WordErrorRate(n_batches * B, (0, 9))
    assert sims[True].last_failures > 0
    # the batches again, shot by shot: the same syndromes through both
    # packages' decoders
    spec = gk.build_fused_spec(n225.hx, n225.hz, n225.lx, n225.lz,
                               [p / 3] * 3, "cpu")
    differ = 0
    for j in range(n_batches):
        sxp, szp = gk.sample_syndrome_plain(spec, gk.fold_in((0, 9), j), B,
                                            emit_errors=False)
        for synd_p, h, tdecoder, jdecoder in ((sxp, n225.hz, tdx, jdx),
                                              (szp, n225.hx, tdz, jdz)):
            synd = unpack_shots(synd_p, B).numpy()
            mine = tdecoder.decode_batch(synd)
            ref = np.asarray(jdecoder.decode_batch(synd))
            _within_contract(mine, (ref,), h, synd,
                             _channel_cost(tdecoder.channel_probs))
            differ += int((mine != ref).any(axis=1).sum())
    got = _failures(twer[0], sims[True].last_shots, n225.K)
    want = _failures(jwer[0], n_batches * B, n225.K)
    assert got == sims[True].last_failures
    assert abs(got - want) <= differ
    if differ == 0:
        assert (twer, sims[True].min_logical_weight) == (
            jwer, jsim.min_logical_weight)
    # the unfused engine runs the same decoders (its own sampler)
    sims[False].WordErrorRate(B)
    assert sims[False].last_shots == B

"""Port ops/osd_cs_device.py (device OSD-CS) against the JAX package on the CPU.

  * The sweep's static helpers (``_cs_plane``, ``cs_pat_chunk``,
    ``cs_sweep_shape``) equal the JAX package's.
  * ``cs_sweep_plain``, given the same ``dplane``, ``xflat`` and base,
    equals ``_cs_sweep_xla`` and the TPU kernel ``_cs_sweep_pallas`` in
    interpret mode bit for bit, in cost and index, and its index does not
    change with ``pat_chunk``.  Tolerance: none.
  * ``cs_planes`` sums over the pivot rows in ascending order, equal to a
    numpy float32 sequential sum bit for bit, and within the float32 error
    bound of two summation orders of the JAX package's plane pass; the
    sweep on them picks the JAX sweep's winner or one of equal cost (the
    tie contract below); ``cs_sweep_rows`` on the CPU is its plain version.
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


def _rows_case(rng, W, r, n, f, B, ties):
    """Reduced pivot rows (W, r, B), signed pivot costs (r, B), the free
    columns' costs (f, B) and ascending free positions below n (f, B); with
    ``ties`` small integers, whose float32 sums are exact in any order."""
    rows = rng.integers(-2 ** 31, 2 ** 31, (W, r, B), dtype=np.int64)
    fp = np.stack([np.sort(rng.permutation(n)[:f]) for _ in range(B)], axis=1)
    if ties:
        signed = rng.integers(-3, 4, (r, B)).astype(np.float32)
        cost_free = rng.integers(0, 3, (f, B)).astype(np.float32)
        base = rng.integers(0, 4, B).astype(np.float32)
    else:  # channel-cost magnitudes, either sign
        signed = (rng.uniform(1, 6, (r, B)) * rng.choice([-1, 1], (r, B))
                  ).astype(np.float32)
        cost_free = rng.uniform(1, 6, (f, B)).astype(np.float32)
        base = rng.uniform(0, 60, B).astype(np.float32)
    return rows.astype(np.int32), signed, cost_free, fp.astype(np.int64), base


def _bits_at(rows, fp):
    """T[i, fp[j, b]] for every pivot row i: (f, r, B) int64 {0, 1}."""
    r = rows.shape[1]
    word = np.broadcast_to((fp >> 5)[:, None, :], (fp.shape[0], r, fp.shape[1]))
    got = np.take_along_axis(rows.view(np.uint32).astype(np.int64), word, 0)
    return (got >> (fp & 31)[:, None, :]) & 1


def _pairs(w):
    return [(a, b) for a in range(w) for b in range(a + 1, w)]


def _jax_planes(rows, signed, cost_free, fp, n, w):
    """The JAX package's plane pass (its ops/osd_cs_device.py:414-438, the
    XLA part of osd_cs_decode_values), on the CPU: dplane (f, B), xflat
    (w*w, B)."""
    W, r, B = rows.shape
    hi = jax.lax.Precision.HIGHEST
    rows_piv = jnp.asarray(rows.view(np.uint32))
    s = jnp.asarray(signed)
    shifts32 = jnp.arange(32, dtype=jnp.uint32)

    def word_term(rw):
        bits = ((rw[:, None, :] >> shifts32[None, :, None]) & 1).astype(
            jnp.float32)
        return jnp.einsum("rkb,rb->kb", bits, s, precision=hi)

    dcost = jax.lax.map(word_term, rows_piv).reshape(W * 32, B)[:n]
    fpj = jnp.asarray(fp.astype(np.int32))
    dplane = jnp.take_along_axis(dcost, fpj, axis=0) + jnp.asarray(cost_free)
    fp_w = fpj[:w]
    fword = jnp.broadcast_to((fp_w >> 5)[:, None, :], (w, r, B))
    fbit = (fp_w & 31).astype(jnp.uint32)[:, None, :]
    tw = ((jnp.take_along_axis(rows_piv, fword, axis=0) >> fbit) & 1
          ).astype(jnp.float32)
    x = jnp.einsum("arb,rb,crb->acb", tw, s, tw, precision=hi)
    return np.asarray(dplane), np.asarray(x.reshape(max(w * w, 1), B))


def _port_planes(rows, signed, cost_free, fp, n, w):
    d, x = tcs.cs_planes(*(torch.from_numpy(a) for a in (rows, signed,
                                                         cost_free, fp)), n, w)
    return d.numpy(), x.numpy()


SHAPES = [(2, 34, 48, 14, 5), (20, 300, 625, 325, 10)]  # W, r*, n, f, w


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("W,r,n,f,w", SHAPES)
def test_cs_planes_sum_pivot_rows_in_ascending_order(W, r, n, f, w, ties):
    """``cs_planes`` is a float32 sum over the pivot rows i = 0, 1, ...,
    r*-1 in that order (then the free column's cost), the order the CUDA
    kernel follows: equal to numpy's sequential float32 sums bit for bit."""
    rng = np.random.default_rng(r + ties)
    rows, signed, cost_free, fp, _ = _rows_case(rng, W, r, n, f, 16, ties)
    t = _bits_at(rows, fp)                                   # (f, r, B)
    d = np.zeros(fp.shape, np.float32)
    x = np.zeros((len(_pairs(w)), fp.shape[1]), np.float32)
    for i in range(r):
        d = d + np.where(t[:, i] == 1, signed[i], np.float32(0))
        both = np.stack([t[a, i] & t[b, i] for a, b in _pairs(w)]) if w > 1 \
            else np.zeros(x.shape, np.int64)
        x = x + np.where(both == 1, signed[i], np.float32(0))
    d = d + cost_free
    got_d, got_x = _port_planes(rows, signed, cost_free, fp, n, w)
    assert got_d.dtype == np.float32 and got_x.dtype == np.float32
    assert np.array_equal(got_d.view(np.int32), d.view(np.int32))
    rows_ab = [a * w + b for a, b in _pairs(w)]
    assert np.array_equal(got_x[rows_ab].view(np.int32), x.view(np.int32))
    assert not np.delete(got_x, rows_ab, axis=0).any()


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("W,r,n,f,w", SHAPES)
def test_cs_planes_and_sweep_match_jax_within_tie_contract(W, r, n, f, w,
                                                           ties):
    """The port's planes against the JAX package's plane pass: each entry
    within (2 r* + 2) * 2^-24 * (sum_i |s_i| + |cost_free|), the float32
    error bound of two summation orders over r* terms (exactly equal on
    small integers, whose sums are exact in any order).  Then the sweep
    (``cs_planes`` then ``cs_sweep_plain``) against the JAX package's
    ``_cs_sweep_xla`` on its own planes, at f = 14, w = 5 and at
    hgp_34_n625's f = 325, w = 10: the same winner, or two winners whose
    costs from float64 planes are within 1e-4 of each other and of the
    least (the float32 cost-tie contract)."""
    rng = np.random.default_rng(10 * r + ties)
    B = 64
    rows, signed, cost_free, fp, base = _rows_case(rng, W, r, n, f, B, ties)
    jd, jx = _jax_planes(rows, signed, cost_free, fp, n, w)
    td, tx = _port_planes(rows, signed, cost_free, fp, n, w)
    scale = np.abs(signed).astype(np.float64).sum(axis=0)
    tol = (2 * r + 2) * 2.0 ** -24
    assert (np.abs(td - jd) <= tol * (scale + np.abs(cost_free))).all()
    rows_ab = [a * w + b for a, b in _pairs(w)]
    assert (np.abs(tx[rows_ab] - jx[rows_ab]) <= tol * scale).all()
    if ties:
        assert np.array_equal(td, jd) and np.array_equal(tx[rows_ab],
                                                         jx[rows_ab])
    chunk = 8 if f == 14 else 64
    e1t, e2t, *_ = jcs._cs_plane(f, w, chunk)
    want = np.asarray(jcs._cs_sweep_xla(*(jnp.asarray(a) for a in (
        e1t, e2t, jd, jx, base)), chunk)[1])
    got = tcs.cs_sweep_plain(torch.from_numpy(td), torch.from_numpy(tx),
                             torch.from_numpy(base), w=w,
                             pat_chunk=chunk)[1].numpy()
    # every candidate's cost from float64 planes
    t = _bits_at(rows, fp).astype(np.float64)
    d64 = (t * signed[None].astype(np.float64)).sum(axis=1) + cost_free
    x64 = np.stack([(t[a] * t[b] * signed).sum(axis=0) for a, b in _pairs(w)])
    b64 = base.astype(np.float64)
    cost64 = np.concatenate([b64[None], b64 + d64] + ([np.stack(
        [b64 + d64[a] + d64[b] - 2 * x64[k]
         for k, (a, b) in enumerate(_pairs(w))])] if w > 1 else []))
    shots = np.arange(B)
    least = cost64.min(axis=0)
    for idx in (got, want):
        assert (cost64[idx, shots] - least < 1e-4).all()
    assert (np.abs(cost64[got, shots] - cost64[want, shots]) < 1e-4).all()
    if ties:
        assert np.array_equal(got, want)
    else:
        assert (got == want).mean() > 0.9
    assert (got > 0).any()


def test_cs_sweep_rows_on_the_cpu_is_its_plain_version():
    """On CPU tensors ``cs_sweep_rows`` runs ``cs_sweep_rows_plain``: the
    pivot rows gathered from the reduced matrix, ``cs_planes``, then
    ``cs_sweep_plain``; and the reconstruction's bits at the pivot rows
    are those of the gathered rows."""
    rng = np.random.default_rng(3)
    W, m, r, n, f, w, B = 2, 40, 30, 48, 18, 5, 24
    packed = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (W, m, B),
                                           dtype=np.int64).astype(np.int32))
    pr = torch.from_numpy(np.stack([rng.permutation(m)[:r] for _ in range(B)],
                                   axis=1).astype(np.int32))
    _, signed, cost_free, fp, base = (torch.from_numpy(a) for a in _rows_case(
        rng, W, r, n, f, B, False))
    before = tcs.cs_sweep_rows.launches
    got = tcs.cs_sweep_rows(packed, pr, signed, cost_free, fp, base, n=n, w=w,
                            pat_chunk=64)
    assert tcs.cs_sweep_rows.launches == before
    rows = tod.pivot_rows(packed, pr)
    want = tcs.cs_sweep_plain(*tcs.cs_planes(rows, signed, cost_free, fp, n, w),
                              base, w=w, pat_chunk=64)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(tcs._pivot_bits(packed, pr, fp[:3]),
                       tod._reduced_bits(rows, fp[:3]))


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

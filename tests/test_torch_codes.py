"""Port codes/ against the JAX package's: bit-exact GF(2) results.

Inputs are numpy matrices made from a seed; both packages see the same
arrays.  Tolerance: none — every output is an integer array."""
import os

import numpy as np
import pytest

from qldpc_fault_tolerance_tpu import codes as jcodes
from qldpc_fault_tolerance_tpu_torch import codes as tcodes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _random_h(seed, m, n, density=0.3):
    rng = np.random.default_rng(seed)
    return (rng.random((m, n)) < density).astype(np.uint8)


@pytest.mark.parametrize("seed,m,n", [(0, 6, 10), (1, 12, 9), (2, 15, 30)])
def test_gf2_routines_match_jax(seed, m, n):
    h = _random_h(seed, m, n)
    jr, jp = jcodes.gf2.rref(h)
    tr, tp = tcodes.gf2.rref(h)
    assert np.array_equal(jr, tr) and jp == tp
    assert jcodes.gf2.rank(h) == tcodes.gf2.rank(h)
    assert np.array_equal(jcodes.gf2.nullspace(h), tcodes.gf2.nullspace(h))
    assert np.array_equal(jcodes.gf2.row_basis(h), tcodes.gf2.row_basis(h))
    assert np.array_equal(jcodes.gf2.to_gf2(h * 3 + 2), tcodes.gf2.to_gf2(h * 3 + 2))


@pytest.mark.parametrize("ctor", ["rep", "ring"])
@pytest.mark.parametrize("d", [3, 4])
def test_hgp_codes_match_jax(ctor, d):
    jh = getattr(jcodes, f"{ctor}_code")(d)
    th = getattr(tcodes, f"{ctor}_code")(d)
    assert np.array_equal(jh, th)
    jc = jcodes.hgp(jh, jh)
    tc = tcodes.hgp(th, th)
    for attr in ("hx", "hz", "lx", "lz"):
        assert np.array_equal(getattr(jc, attr), getattr(tc, attr)), attr
    assert (jc.N, jc.K) == (tc.N, tc.K)


def test_css_logicals_match_jax():
    code = tcodes.hgp(tcodes.ring_code(3), tcodes.rep_code(4))
    jl = jcodes.css_logicals(code.hx, code.hz)
    tl = tcodes.css_logicals(code.hx, code.hz)
    assert all(np.array_equal(a, b) for a, b in zip(jl, tl))


@pytest.mark.parametrize("name", ["hgp_34_n225", "hgp_34_n625"])
def test_load_code_matches_jax(name):
    path = os.path.join(REPO, "codes_lib_tpu", f"{name}.npz")
    jc = jcodes.load_code(path)
    tc = tcodes.load_code(path)
    for attr in ("hx", "hz", "lx", "lz"):
        assert np.array_equal(getattr(jc, attr), getattr(tc, attr)), attr
    assert (jc.N, jc.K, jc.D, jc.name) == (tc.N, tc.K, tc.D, tc.name)


def test_invalid_css_pair_raises():
    h = np.array([[1, 1, 0]], np.uint8)
    with pytest.raises(ValueError):
        tcodes.CssCode(hx=h, hz=np.array([[1, 0, 0]], np.uint8))

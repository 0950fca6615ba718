"""The elimination kernel's transform mode (csrc/osd_elim.cu kTransform) on
the CPU: its plain PyTorch model, ``eliminate_transform_plain``, walks each
shot's m x m row transform T instead of its matrix (a walked column is the
XOR of T's columns at its rows, a pivot step updates T's m + 1 columns, T
is frozen once the rank is r*) and must give the blocked elimination's
outputs bit for bit: ``eliminate_plain``'s five (six with ``full``) and the
JAX package's ``_eliminate_blocked_twin``'s.  Integer-exact: no tolerance.
The card's kernel is held against ``eliminate_plain`` in
tests/test_torch_smem_routes.py and chip_smoke.py phase 27.
"""
import functools
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qldpc_fault_tolerance_tpu.ops import osd_device as jod
from qldpc_fault_tolerance_tpu_torch.codes import hgp, ring_code
from qldpc_fault_tolerance_tpu_torch.ops import osd_device as tod

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ext(h):
    return np.hstack([h, np.eye(h.shape[0], dtype=np.uint8)])


@functools.lru_cache(maxsize=None)
def _matrix(case):
    """(h, name): [H|I] and H of the shipped codes; hgp(ring_code(5),
    ring_code(5)) (25 x 50: m not a multiple of 32, rank 24 < m)."""
    if case == "ring5":
        return np.asarray(hgp(ring_code(5), ring_code(5)).hx, dtype=np.uint8)
    code, ext = case.rsplit("_", 1)
    with np.load(os.path.join(REPO, "codes_lib_tpu", f"{code}.npz")) as z:
        h = z["hx"].astype(np.uint8)
    return _ext(h) if ext == "ext" else h


def _inputs(h, B, seed, zero=False):
    """The JAX and port plans, the permutation (posteriors drawn with
    numpy), the syndromes of p = 0.03 errors (all zero with ``zero``), the
    port's row-packed matrix and each column's rows."""
    m, n = h.shape
    rng = np.random.default_rng(seed)
    probs = np.full(n, 0.03)
    post = rng.normal(0, 2, (B, n)).astype(np.float32)
    err = (rng.random((B, n)) < 0.03).astype(np.uint8) * (not zero)
    synd = (err @ h.T % 2).astype(np.uint8)
    jplan = jod.build_osd_plan(h, probs)
    tplan = tod.build_osd_plan(h, probs, device="cpu")
    jperm = jnp.argsort(jnp.asarray(post), axis=1, stable=True).astype(jnp.int32)
    perm = torch.sort(torch.from_numpy(post), dim=1, stable=True).indices
    h01 = tod._unpack_rows(tplan.packed, n)
    return dict(jplan=jplan, jperm=jperm, jsynd=jnp.asarray(synd),
                perm=perm, rank=tplan.rank, rows=tod.col_rows(h01),
                packed=tod._permute_and_pack(h01, perm),
                synd=torch.from_numpy(synd).to(torch.int32).t().contiguous())


def _equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = torch.from_numpy(np.array(b).view(np.int32)) if not isinstance(
            b, torch.Tensor) else b
        assert a.dtype == b.dtype and torch.equal(a, b)


CASES = ("hgp_34_n225_ext", "hgp_34_n225_h", "hgp_34_n625_ext",
         "hgp_34_n625_h", "ring5")


@pytest.mark.parametrize("fcap", [0, 10, 32])
@pytest.mark.parametrize("case", CASES)
def test_transform_model_matches_eliminate_plain(case, fcap):
    """All five outputs, and the sixth with ``full`` (the reduced matrix
    T A whole, each pivot column its unit vector)."""
    h = _matrix(case)
    x = _inputs(h, 6, 1)
    n = h.shape[1]
    fcap = min(fcap, n - x["rank"])
    for full in (False, True):
        want = tod.eliminate_plain(x["packed"], x["synd"], n=n,
                                   r_star=x["rank"], fcap=fcap, full=full)
        got = tod.eliminate_transform_plain(x["rows"], x["perm"], x["synd"],
                                            r_star=x["rank"], fcap=fcap,
                                            full=full)
        _equal(got, want)


@pytest.mark.parametrize("fcap", [0, 10, 32])
@pytest.mark.parametrize("case", ["hgp_34_n225_ext", "hgp_34_n225_h",
                                  "hgp_34_n625_ext", "ring5"])
def test_transform_model_matches_jax_twin(case, fcap):
    h = _matrix(case)
    x = _inputs(h, 4, 2)
    fcap = min(fcap, h.shape[1] - x["rank"])
    for full in (False, True):
        want = jod._eliminate_blocked_twin(x["jplan"], x["jperm"], x["jsynd"],
                                           fcap=fcap, full=full)
        got = tod.eliminate_transform_plain(x["rows"], x["perm"], x["synd"],
                                            r_star=x["rank"], fcap=fcap,
                                            full=full)
        _equal(got, want)


@pytest.mark.parametrize("case", ["hgp_34_n225_ext", "ring5"])
def test_transform_model_takes_zero_syndromes(case):
    """No syndrome bit: the reduced syndrome is zero, and the walk (which
    does not read the syndrome) is the nonzero batch's."""
    h = _matrix(case)
    x, z = _inputs(h, 5, 3), _inputs(h, 5, 3, zero=True)
    assert not bool(z["synd"].any())
    fcap = min(10, h.shape[1] - x["rank"])
    got = tod.eliminate_transform_plain(z["rows"], z["perm"], z["synd"],
                                        r_star=z["rank"], fcap=fcap, full=True)
    _equal(got, tod.eliminate_plain(z["packed"], z["synd"], n=h.shape[1],
                                    r_star=z["rank"], fcap=fcap, full=True))
    assert not bool(got[0].any())
    walk = tod.eliminate_transform_plain(x["rows"], x["perm"], x["synd"],
                                         r_star=x["rank"], fcap=fcap)
    _equal(got[1:5], walk[1:5])


def test_transform_model_freezes_t_below_full_rank():
    """r* < m: the walk ends at rank r* with rows left unused, and the free
    panel is still read from the frozen T (32 free columns, more than the
    walk meets before its last pivot)."""
    h = _matrix("ring5")
    x = _inputs(h, 8, 4)
    m, n = h.shape
    assert x["rank"] == m - 1
    out = tod.eliminate_transform_plain(x["rows"], x["perm"], x["synd"],
                                        r_star=x["rank"], fcap=n - x["rank"])
    assert n - x["rank"] == 26 and int(out[4][25].min()) > 0
    _equal(out, tod.eliminate_plain(x["packed"], x["synd"], n=n,
                                    r_star=x["rank"], fcap=n - x["rank"]))


def test_col_rows_lists_each_columns_rows():
    h = _matrix("hgp_34_n225_ext")
    rows = tod.col_rows(torch.from_numpy(h))
    assert rows.dtype == torch.int16 and rows.shape == (h.shape[1], 4)
    for c in (0, 17, 224, 225, h.shape[1] - 1):
        want = np.flatnonzero(h[:, c])
        got = rows[c].numpy()
        assert list(got[:len(want)]) == list(want)
        assert (got[len(want):] == -1).all()


def test_transform_work_at_phase_30s_shape():
    """[H|I] of hgp_34_n1600 (768 x 2368), OSD-0 (fcap 0) as phase 30's
    decoder 1 runs it: the transform walk tests m + 1 columns a step
    instead of the matrix walk's m rows of each column, and XORs a few of
    T's columns instead of most rows, so it needs fewer word operations;
    chip_smoke.py reports both counts and bounds the transform mode's rows
    by the smaller."""
    h = _matrix("hgp_34_n1600_ext")
    x = _inputs(h, 2, 5)
    m, n = h.shape
    assert (m, n, x["rank"]) == (768, 2368, 768)
    t_work = tod.transform_work(x["rows"], x["perm"], x["synd"],
                                r_star=m, fcap=0)
    a_work = tod.elimination_work(x["packed"], x["synd"], n=n, r_star=m,
                                  fcap=0)
    # at least a test of T's m + 1 columns at each of the 2 x 768 steps
    assert 2 * m * (m + 1) < t_work < a_work

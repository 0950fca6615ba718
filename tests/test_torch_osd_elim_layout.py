"""The elimination kernel's launch (``ops/osd_device.py`` ``elim_layout``)
and its inputs, on the CPU.

``elim_layout`` must fit every shipped code in every mode and at every
batch the decoders give it, cover the batch, and refuse exactly the shapes
whose shared memory exceeds a block's 232,448 bytes.  The kernel builds
each shot's columns from the code's column-packed H (``col_pack``) and the
shot's permutation; on the CPU that entry packs rows and runs the plain
version, which must give the JAX blocked twin's outputs for the same
permutation.  Integer-exact: no tolerance.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qldpc_fault_tolerance_tpu.ops import osd_device as jod
from qldpc_fault_tolerance_tpu_torch.codes import hgp, load_code, ring_code
from qldpc_fault_tolerance_tpu_torch.ops import osd_device as tod

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CODES = ("hgp_34_n225", "hgp_34_n625", "hgp_34_n1225", "hgp_34_n1600")
# (mode, fcap) of kernel 2 (OSD-E), B7 (OSD-CS, and with a free panel), B10
MODES = (("skip", 10), ("full", 0), ("full", 10), ("percol", 0))
SM_COUNT = 132  # an H100 SXM's


def _shape(code):
    with np.load(os.path.join(REPO, "codes_lib_tpu", f"{code}.npz")) as z:
        return z["hx"].shape


@pytest.mark.parametrize("mode,fcap", MODES)
@pytest.mark.parametrize("B", [1, 128, 512, 2048])
@pytest.mark.parametrize("code", CODES)
def test_layout_fits_every_shipped_code(code, B, mode, fcap):
    m, n = _shape(code)
    lay = tod.elim_layout(B, m, n, fcap, mode, SM_COUNT)
    assert lay.shots * lay.grid >= B
    assert lay.threads % 64 == 0 and 64 <= lay.threads <= 1024
    assert lay.smem_bytes == tod.elim_smem_bytes(m, n) <= tod.SMEM_LIMIT
    assert lay.resident >= 1
    assert lay.resident * (lay.smem_bytes + 1024) <= tod.SM_SMEM
    assert lay.resident * lay.threads <= tod.SM_THREADS


def test_layout_gives_the_main_path_tiers_many_threads():
    """hgp_34_n625: the straggler tiers (128 and 512 shots, 1-4 per SM) get
    many threads a shot; 2048 shots fewer, with more blocks per SM."""
    m, n = _shape("hgp_34_n625")
    tiers = [tod.elim_layout(B, m, n, 10, "skip", SM_COUNT)
             for B in (128, 512, 2048)]
    assert tiers[0].threads >= 512 and tiers[1].threads >= 256
    assert tiers[2].threads < tiers[1].threads
    assert tiers[2].resident > tiers[0].resident
    # no more threads than columns the first pivot step clears
    assert tiers[0].threads <= -(-(n + 1) // 32) * 32


@pytest.mark.parametrize("m", [1, 32, 33, 300, 768, 1000, 2000])
def test_layout_refuses_exactly_what_shared_memory_cannot_hold(m):
    # the widest matrix that fits (the bytes grow with n), then the next
    # width whose bytes do not
    lo, hi = 1, tod.SMEM_LIMIT
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if tod.elim_smem_bytes(m, mid) <= tod.SMEM_LIMIT \
            else (lo, mid - 1)
    n = lo
    assert tod.elim_smem_bytes(m, n) <= tod.SMEM_LIMIT
    tod.elim_layout(1, m, n, 0, "full", SM_COUNT)
    wider = n + 1
    while tod.elim_smem_bytes(m, wider) <= tod.SMEM_LIMIT:
        wider += 1
    need = tod.elim_smem_bytes(m, wider)
    with pytest.raises(ValueError, match=f"needs {need} bytes .* above "
                                         f"{tod.SMEM_LIMIT}"):
        tod.elim_layout(1, m, wider, 0, "full", SM_COUNT)


def test_layout_rejects_bad_arguments():
    with pytest.raises(ValueError, match="threads"):
        tod.elim_layout(8, 300, 625, 10, "skip", SM_COUNT, threads=96)
    with pytest.raises(ValueError, match="threads"):
        tod.elim_layout(8, 300, 625, 10, "skip", SM_COUNT, threads=32)
    with pytest.raises(ValueError, match="fcap"):
        tod.elim_layout(8, 300, 625, 33, "skip", SM_COUNT)
    with pytest.raises(ValueError, match="fcap"):
        tod.elim_layout(8, 300, 625, 10, "percol", SM_COUNT)
    with pytest.raises(ValueError, match="mode"):
        tod.elim_layout(8, 300, 625, 0, "blocked", SM_COUNT)
    lay = tod.elim_layout(8, 300, 625, 0, "full", SM_COUNT, threads=128)
    assert lay.threads == 128 and lay.grid == 8


def test_col_pack_holds_the_permuted_columns_of_the_packed_rows():
    """Column t of shot b's permuted matrix is ``col_pack(h)[perm[b, t]]``:
    the kernel's columns are the rows ``_permute_and_pack`` makes."""
    h = load_code(os.path.join(REPO, "codes_lib_tpu", "hgp_34_n225.npz")).hx
    m, n = h.shape
    h01 = torch.from_numpy((h != 0).astype(np.uint8))
    cols = tod.col_pack(h01)
    assert cols.shape == (n, (m + 31) // 32) and cols.dtype == torch.int32
    perm = torch.sort(torch.randn((5, n), generator=torch.Generator()
                                  .manual_seed(1)), dim=1).indices
    rows = tod._permute_and_pack(h01, perm)                     # (W, m, B)
    col_bits = tod._unpack_rows(cols, m)                       # (n, m)
    W = rows.shape[0]
    for b in range(5):
        row_bits = tod._unpack_rows(rows[..., b].t().contiguous(), W * 32)
        assert torch.equal(row_bits[:, :n].t(), col_bits[perm[b]])
        assert not row_bits[:, n:].any()


def test_col_pack_is_built_once_per_rows_tensor():
    plan = tod.build_osd_plan(hgp(ring_code(3), ring_code(3)).hx,
                              np.full(18, 0.05), device="cpu")
    first = tod._colpack_of(plan.packed, plan.n)
    assert tod._colpack_of(plan.packed, plan.n) is first
    other = plan.packed.clone()
    assert tod._colpack_of(other, plan.n) is not first
    assert torch.equal(tod._colpack_of(other, plan.n), first)


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("fcap", [0, 10, 32])
@pytest.mark.parametrize("code", ["ring", "hgp_34_n225"])
def test_perm_entry_matches_jax_blocked_twin(code, fcap, full):
    """``osd_elim(rows, perm, synd)`` gives ``_eliminate_blocked_twin``'s
    outputs for the same permutation: r* < m (the ring code) and m, n not
    multiples of 32 (hgp_34_n225)."""
    if code == "ring":
        h = hgp(ring_code(5), ring_code(4)).hx
    else:
        h = load_code(os.path.join(REPO, "codes_lib_tpu", f"{code}.npz")).hx
    m, n = h.shape
    probs = np.full(n, 0.03)
    tplan = tod.build_osd_plan(h, probs, device="cpu")
    jplan = jod.build_osd_plan(h, probs)
    fcap = min(fcap, n - tplan.rank)
    rng = np.random.default_rng(fcap + 7 * full)
    post = rng.normal(size=(6, n)).astype(np.float32)
    synd = ((rng.random((6, n)) < 0.05).astype(np.uint8) @ h.T % 2).astype(
        np.uint8)
    tperm = torch.sort(torch.from_numpy(post), dim=1, stable=True).indices
    jperm = jnp.argsort(jnp.asarray(post), axis=1, stable=True).astype(jnp.int32)
    ref = jod._eliminate_blocked_twin(jplan, jperm, jnp.asarray(synd),
                                      fcap=fcap, full=full)
    out = tod.osd_elim(tplan.packed, tperm,
                       torch.from_numpy(synd).to(torch.int32).t().contiguous(),
                       n=n, r_star=tplan.rank, fcap=fcap, full=full)
    assert len(out) == len(ref) == (6 if full else 5)
    for a, b in zip(ref, out):
        assert np.array_equal(np.asarray(a).view(np.int32), b.numpy())

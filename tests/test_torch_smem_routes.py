"""Where one shot does not fit a block's shared memory, the card routes
instead of raising: the blocked eliminations (csrc/osd_elim.cu) take their
transform mode (the shot's row transform in shared memory) where it fits
and the per-column one its device-memory mode, kernel 1 and the bf16 head
(csrc/bp_minsum.cu) their check-state or device-memory modes, and an
infeasible fused v2 runs as fused v1.

On the CPU the routes are pure arithmetic with a given SM count: the
layouts pick the device-memory modes at the shapes the phenomenological
engine reaches ([H|I] of hgp_34_n1600, 768 x 2368, for the elimination;
three copies of it, 2304 x 7104, for the min-sum kernels; eleven copies,
67,584 edges, for 32-bit planes), ``fused_decode_feasible`` refuses a code
that ``fused_layout`` refuses, and every shipped shape keeps the layout
it had (``memory="shared"``, the layouts' default, is the parent's
shared-memory rule); ``_kernels.force_memory`` fixes a mode, to time it.
The card-gated cases hold each device-memory and transform mode bit
for bit against its plain version (tolerance 0: integer words, and min-sum built
with FMA contraction off)."""
import functools
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from qldpc_fault_tolerance_tpu_torch.codes import hgp, ring_code
from qldpc_fault_tolerance_tpu_torch.codes.gf2 import block_diag
from qldpc_fault_tolerance_tpu_torch.decoders import BPDecoder
from qldpc_fault_tolerance_tpu_torch.ops import _kernels
from qldpc_fault_tolerance_tpu_torch.ops import bp as tbp
from qldpc_fault_tolerance_tpu_torch.ops import bp_kernel as bk
from qldpc_fault_tolerance_tpu_torch.ops import gf2_kernel as gk
from qldpc_fault_tolerance_tpu_torch.ops import osd_device as tod
from qldpc_fault_tolerance_tpu_torch.sim import CodeSimulator_DataError

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CODES = ("hgp_34_n225", "hgp_34_n625", "hgp_34_n1225", "hgp_34_n1600")
SMS = 132  # an H100 SXM's SMs


@functools.lru_cache(maxsize=None)
def _code(name, copies=1):
    """A shipped code's matrices (or ``copies`` independent copies of it,
    block-diagonal) with N and K: what the engines read of a code."""
    with np.load(os.path.join(REPO, "codes_lib_tpu", f"{name}.npz")) as z:
        mats = {k: block_diag(z[k], copies) for k in ("hx", "hz", "lx", "lz")}
    return SimpleNamespace(N=mats["hx"].shape[1], K=mats["lx"].shape[0],
                           **mats)


def _h(code, sector="hx"):
    return getattr(_code(code), sector)


def _ext(h):
    return np.hstack([h, np.eye(h.shape[0], dtype=np.uint8)])


@functools.lru_cache(maxsize=None)
def _shape(h_key):
    """(m, n, rw, cw) of the Tanner graph of a named matrix."""
    g = tbp.build_tanner_graph_host(_matrix(h_key))
    return (*g.chk_nbr.shape[:1], g.var_nbr.shape[0], g.chk_nbr.shape[1],
            g.var_nbr.shape[1])


@functools.lru_cache(maxsize=None)
def _matrix(h_key):
    code, copies = h_key
    return block_diag(_ext(_h(code)), copies)


# ---------------------------------------------------------------- elimination

@pytest.mark.parametrize("mode,fcap", [("skip", 10), ("full", 0),
                                       ("full", 10), ("percol", 0)])
@pytest.mark.parametrize("B", [1, 256, 2048])
def test_elim_routes_the_n1600_extended_matrix_to_device_memory(mode, fcap, B):
    """Past shared memory the blocked routes take the transform mode (the
    shot's 768 x 768 row transform in shared memory, two shots an SM), the
    per-column route the device-memory mode; the device-memory mode, fixed,
    keeps its layout for all three."""
    m, n = 768, 2368  # [H|I] of hgp_34_n1600
    assert tod.elim_smem_bytes(m, n) == 233816 > tod.SMEM_LIMIT
    with pytest.raises(ValueError, match="233816 bytes"):
        tod.elim_layout(B, m, n, fcap, mode, SMS)
    lay = tod.elim_layout(B, m, n, fcap, mode, SMS, memory="auto")
    if mode == "percol":
        assert lay == tod.elim_layout(B, m, n, fcap, mode, SMS,
                                      memory="device")
    else:
        assert lay.memory == "transform" and lay.scratch_bytes == 0
        assert lay.smem_bytes == tod.elim_transform_bytes(m, n, 4) == 101_080
        assert lay.resident == 2
        assert lay.threads == (512 if B == 1 else 256)
        lay = tod.elim_layout(B, m, n, fcap, mode, SMS, memory="device")
    assert lay.memory == "device"
    assert lay.smem_bytes == tod.elim_state_bytes(m) == 4 * (24 + 6 + 32 + 2 * m)
    # the matrix words the shared-memory mode would hold, per shot
    assert lay.scratch_bytes == 4 * 24 * ((n + 1) | 1)
    assert lay.smem_bytes + lay.scratch_bytes == tod.elim_smem_bytes(m, n)
    assert lay.grid == B and lay.threads % 64 == 0
    assert lay.resident * (lay.smem_bytes + 1024) <= tod.SM_SMEM


@pytest.mark.parametrize("m", [1, 300, 768, 2000])
def test_elim_routes_every_width_past_shared_memory(m):
    """Just past the widest matrix shared memory holds, and far past it:
    the transform mode while the shot's transform and rows fit (it grows
    with m^2 and with n only by the rows, 8 bytes a column), else the
    device-memory mode; the per-column route takes the device-memory
    mode."""
    n = 1
    while tod.elim_smem_bytes(m, n + 1) <= tod.SMEM_LIMIT:
        n += 1
    assert tod.elim_layout(1, m, n, 0, "full", SMS,
                           memory="auto").memory == "shared"
    for wider in (n + 1, 4 * n):
        lay = tod.elim_layout(1, m, wider, 0, "full", SMS, memory="auto")
        fits = tod.elim_transform_bytes(m, wider, 4) <= tod.SMEM_LIMIT
        assert lay.memory == ("transform" if fits else "device")
        assert lay.smem_bytes == (tod.elim_transform_bytes(m, wider, 4)
                                  if fits else tod.elim_state_bytes(m))
        assert lay.smem_bytes <= tod.SMEM_LIMIT
        assert tod.elim_layout(1, m, wider, 0, "percol", SMS,
                               memory="auto").memory == "device"
    # 300 and 768 rows take the transform just past shared memory; one row
    # (58,000 columns of rows) and 2000 rows (a 504 KB transform) do not
    assert (tod.elim_layout(1, m, n + 1, 0, "skip", SMS, memory="auto").memory
            == ("transform" if m in (300, 768) else "device"))


def test_elim_transform_bytes_and_resident_blocks():
    """T and the syndrome (24 words a column of a 771-column row), U, two
    pivot columns, two windows of 8 columns, the walk's state, the pivots
    and 4 rows a column in 16 bits: two shots an SM at [H|I] of
    hgp_34_n1600, and at its H."""
    m, n, mW = 768, 2368, 24
    assert tod.elim_transform_bytes(m, n, 4) == (
        4 * (mW * 771 + mW + 2 * mW + 2 * 8 * mW + 6 + 32 + 2 * m)
        + 2 * 4 * n)
    for shape in ((768, 2368), (768, 1600)):
        for B in (128, 256, 512, 2048):
            lay = tod.elim_layout(B, *shape, 10, "skip", SMS,
                                  memory="transform")
            assert lay.memory == "transform" and lay.resident == 2
            assert lay.resident * (lay.smem_bytes + 1024) <= tod.SM_SMEM
            # at most one lane per column of T that a step tests
            assert lay.threads <= -(-(m + 1) // 32) * 32
            assert lay.threads % 64 == 0
    # a heavier column stages more rows; an odd row count rounds to a word
    assert (tod.elim_transform_bytes(768, 2368, 7)
            - tod.elim_transform_bytes(768, 2368, 4)) == 2 * 3 * 2368
    assert tod.elim_transform_bytes(25, 51, 3) % 4 == 0
    # three shots an SM would need at most 76,800 bytes a shot
    assert 3 * (tod.elim_transform_bytes(768, 2368, 4) + 1024) > tod.SM_SMEM


@pytest.mark.parametrize("extra", [1600, 4000])
def test_elim_transform_m_limit(extra):
    """The largest m whose transform fits a block, for an (m, m + extra)
    matrix with columns of 4 rows ([H|I] of n1600 is 768 x 2368), whose
    matrix does not fit: 1248 rows with 1600 more columns, 1184 with 4000;
    one row more takes the device-memory mode."""
    m = 1
    while tod.elim_transform_bytes(m + 1, m + 1 + extra, 4) <= tod.SMEM_LIMIT:
        m += 1
    assert m == {1600: 1248, 4000: 1184}[extra]
    for rows, want in ((m, "transform"), (m + 1, "device")):
        assert tod.elim_layout(2048, rows, rows + extra, 10, "skip", SMS,
                               memory="auto").memory == want
    with pytest.raises(ValueError, match="in its transform"):
        tod.elim_layout(1, m + 1, m + 1 + extra, 0, "full", SMS,
                        memory="transform")


@pytest.mark.parametrize("mode", ["skip", "full", "percol"])
@pytest.mark.parametrize("memory", ["transform", "device"])
def test_force_memory_fixes_the_elimination_modes(memory, mode):
    """``force_memory("transform")`` and ``("device")`` reach the layout
    through ``memory_mode()``; at hgp_34_n1600's H, which fits every mode,
    each is taken as fixed; the per-column route has no transform mode and
    raises rather than taking another."""
    m, n = _h("hgp_34_n1600").shape
    with _kernels.force_memory(memory):
        assert _kernels.memory_mode() == memory
        fixed = _kernels.memory_mode()
    assert _kernels.memory_mode() == "auto"
    fcap = 0 if mode == "percol" else 10
    if mode == "percol" and memory == "transform":
        with pytest.raises(ValueError, match="no transform mode"):
            tod.elim_layout(256, m, n, fcap, mode, SMS, memory=fixed)
        return
    lay = tod.elim_layout(256, m, n, fcap, mode, SMS, memory=fixed)
    assert lay.memory == memory
    assert lay.smem_bytes == (tod.elim_transform_bytes(m, n, 4)
                              if memory == "transform"
                              else tod.elim_state_bytes(m))


def test_force_memory_transform_is_no_min_sum_mode():
    """"transform" stays out of MEMORY_MODES (the min-sum kernels' kMem):
    a min-sum layout asked for it raises."""
    assert "transform" not in _kernels.MEMORY_MODES
    assert _kernels.ELIM_MEMORY_MODES == ("shared", "device", "transform")
    with pytest.raises(ValueError, match="min-sum memory"):
        bk.minsum_layout(256, 768, 1600, 7, 4, False, SMS, memory="transform")


def test_elim_modes_can_be_fixed():
    m, n = _h("hgp_34_n1600").shape
    lay = tod.elim_layout(256, m, n, 10, "skip", SMS, memory="device")
    assert lay.memory == "device" and lay.smem_bytes == tod.elim_state_bytes(m)
    assert lay.scratch_bytes == tod.elim_smem_bytes(m, n) - lay.smem_bytes
    with pytest.raises(ValueError, match="memory"):
        tod.elim_layout(256, m, n, 10, "skip", SMS, memory="global")


def test_elim_refuses_only_what_its_state_cannot_hold():
    m = 30000  # the pivots alone (8 bytes a row) exceed a block
    assert tod.elim_state_bytes(m) > tod.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        tod.elim_layout(1, m, m + 1, 0, "skip", SMS, memory="auto")


@pytest.mark.parametrize("mode,fcap", [("skip", 10), ("full", 10),
                                       ("percol", 0)])
@pytest.mark.parametrize("sector", ["hx", "hz"])
@pytest.mark.parametrize("code", CODES)
def test_elim_keeps_every_shipped_layout(code, sector, mode, fcap):
    m, n = _h(code, sector).shape
    for B in (128, 256, 512, 2048):
        lay = tod.elim_layout(B, m, n, fcap, mode, SMS, memory="auto")
        assert lay == tod.elim_layout(B, m, n, fcap, mode, SMS)
        assert lay.memory == "shared" and lay.scratch_bytes == 0
        assert lay.smem_bytes == tod.elim_smem_bytes(m, n)


def test_elim_keeps_the_smaller_extended_matrices_in_shared_memory():
    for code in ("hgp_34_n225", "hgp_34_n625", "hgp_34_n1225"):
        m, n = _ext(_h(code)).shape
        assert tod.elim_layout(256, m, n, 10, "skip", SMS,
                               memory="auto").memory == "shared"


# ---------------------------------------------------------- min-sum kernels

@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("B", [1, 256, 4096])
def test_minsum_routes_the_three_copy_stack(bf16, B):
    """The layout takes the check-state mode with its 16-bit planes staged
    (122,112 B of planes and LLRs, 65,280 B of records and totals a shot);
    the device-memory mode, fixed, keeps its layout."""
    m, n, rw, cw = _shape(("hgp_34_n1600", 3))
    assert (m, n, rw, cw) == (2304, 7104, 8, 4)
    need = bk.minsum_smem_bytes(1, m, n, rw, cw, bf16)
    assert need > bk.SMEM_LIMIT  # ~300 KB per shot
    with pytest.raises(ValueError, match="exceed"):
        bk.minsum_layout(B, m, n, rw, cw, bf16, SMS)
    lay = bk.minsum_layout(B, m, n, rw, cw, bf16, SMS, memory="auto")
    assert (lay.memory, lay.planes, lay.lanes, lay.smem_bytes,
            lay.lane_bytes) == ("checks", "staged16", 1, 122_112 + 65_280, 0)
    assert lay.grid == min(B, SMS)
    lay = bk.minsum_layout(B, m, n, rw, cw, bf16, SMS, memory="device")
    fixed = bk.minsum_smem_bytes(0, m, n, rw, cw, bf16)
    assert lay.memory == "device"          # the 16-bit planes stay staged
    assert lay.smem_bytes == fixed <= bk.SMEM_LIMIT
    assert lay.lane_bytes == need - fixed
    assert 1 <= lay.lanes <= bk.MINSUM_MAX_LANES
    assert lay.threads <= bk.MINSUM_MAX_THREADS
    assert 1 <= lay.grid <= SMS * lay.resident
    assert lay.lanes * lay.grid >= B or lay.grid == SMS * lay.resident


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_minsum_takes_32_bit_planes_past_65535_edges(bf16):
    """Eleven copies: the check-state mode's records and totals (16 * 8448
    + 4 * 26,048 = 239,360 B) exceed a block, so the layout takes the
    device-memory mode with 32-bit planes; a wider graph whose records fit
    takes the check-state mode with 32-bit planes."""
    m, n, rw, cw = _shape(("hgp_34_n1600", 11))
    assert m * rw == 67584 >= bk.PAD16 and not bk.planes16(m, n, rw)
    assert bk.minsum_checks_bytes(1, m, n, rw, cw, "global32") == 239_360
    assert bk.checks_planes(m, n, rw, cw) is None
    lay = bk.minsum_layout(2000, 2000, 8000, 33, 30, bf16, SMS, memory="auto")
    assert (lay.memory, lay.planes, lay.smem_bytes) == (
        "checks", "global32", 16 * 2000 + 2000 + 4 * 8000)
    lay = bk.minsum_layout(256, m, n, rw, cw, bf16, SMS, memory="auto")
    assert lay.memory == "device_planes"
    assert lay.smem_bytes == 0
    assert lay.lane_bytes == (bk.minsum_smem_bytes(1, m, n, rw, cw, bf16)
                              - bk.minsum_smem_bytes(0, m, n, rw, cw, bf16))


def test_minsum_takes_device_planes_when_16_bit_planes_do_not_fit():
    """Seven copies: the 16-bit planes do not fit a block, so the layout
    takes the check-state mode with them read from device memory (records
    and totals 16 * 5376 + 4 * 16,576 = 152,320 B); fixed, the
    device-memory mode with 32-bit planes keeps its layout."""
    m, n, rw, cw = _shape(("hgp_34_n1600", 7))
    assert bk.planes16(m, n, rw)
    assert bk.minsum_smem_bytes(0, m, n, rw, cw, True) > bk.SMEM_LIMIT
    lay = bk.minsum_layout(64, m, n, rw, cw, True, SMS, memory="auto")
    assert (lay.memory, lay.planes, lay.smem_bytes) == ("checks", "global16",
                                                        152_320)
    lay = bk.minsum_layout(64, m, n, rw, cw, True, SMS,
                           memory="device_planes")
    assert lay.memory == "device_planes" and lay.smem_bytes == 0


@pytest.mark.parametrize("memory", ["shared", "device", "device_planes",
                                    "checks"])
def test_minsum_modes_can_be_fixed(memory):
    m, n = _h("hgp_34_n1600").shape
    lay = bk.minsum_layout(4096, m, n, 7, 4, True, SMS, memory=memory)
    fixed = bk.minsum_smem_bytes(0, m, n, 7, 4, True)
    assert lay.memory == memory
    assert lay.smem_bytes == {"shared": bk.minsum_smem_bytes(
        lay.lanes, m, n, 7, 4, True), "device": fixed,
        "device_planes": 0, "checks": bk.minsum_checks_bytes(
            lay.lanes, m, n, 7, 4, "staged16")}[memory]
    with pytest.raises(ValueError, match="memory"):
        bk.minsum_layout(4096, m, n, 7, 4, True, SMS, memory="global")


def test_force_memory_fixes_one_vocabulary_and_restores():
    """The wrappers read ``memory_mode()``: "auto" (the layouts' choice)
    unless ``force_memory`` fixes one of MEMORY_MODES; the elimination has
    no graph planes and no check records, so its layout refuses
    "device_planes" and "checks"."""
    assert _kernels.memory_mode() == "auto"
    with _kernels.force_memory("device"):
        assert _kernels.memory_mode() == "device"
        with _kernels.force_memory("device_planes"):
            assert _kernels.memory_mode() == "device_planes"
            with _kernels.force_memory("checks"):
                assert _kernels.memory_mode() == "checks"
            assert _kernels.memory_mode() == "device_planes"
        assert _kernels.memory_mode() == "device"
    assert _kernels.memory_mode() == "auto"
    with pytest.raises(ValueError, match="memory mode"):
        with _kernels.force_memory("auto"):
            pass
    m, n = _h("hgp_34_n1600").shape  # fits either mode
    for memory in _kernels.MEMORY_MODES[:2]:
        assert tod.elim_layout(256, m, n, 10, "skip", SMS,
                               memory=memory).memory == memory
    for memory in ("device_planes", "checks"):
        with pytest.raises(ValueError, match="memory"):
            tod.elim_layout(256, m, n, 10, "skip", SMS, memory=memory)


def test_32_bit_planes_hold_the_16_bit_planes_values():
    """Same entries, padding -1 instead of 0xFFFF; the slot plane is the
    same; the cache keeps the two widths apart."""
    g = tbp.graph_to(tbp.build_tanner_graph_host(_ext(_h("hgp_34_n225"))),
                     "cpu")
    narrow, wide = bk.minsum_planes(g), bk.minsum_planes(g, wide=True)
    for a, b in zip(narrow[:2], wide[:2]):
        a = a.numpy().view(np.uint16).astype(np.int64)
        assert b.dtype == torch.int32
        assert np.array_equal(np.where(a == bk.PAD16, -1, a), b.numpy())
    assert torch.equal(narrow.slot, wide.slot)
    assert bk._planes_of(g, wide=True) is bk._planes_of(g, wide=True)
    assert bk._planes_of(g, wide=True).chk.dtype == torch.int32
    assert bk._planes_of(g).chk.dtype == torch.int16


@pytest.mark.parametrize("wide", [False, True], ids=["16-bit", "32-bit"])
def test_planes_and_columns_of_an_extended_matrix(wide):
    """[H|I] mixes H's weight-3 and weight-4 columns with weight-1 ones:
    the planes list each variable's edges in the Tanner graph's order
    (padding past a column's weight), a head's planes in ascending edge
    order, and the elimination's column packing holds each column's
    rows."""
    h = _ext(_h("hgp_34_n225"))
    m, n = h.shape
    g = tbp.graph_to(tbp.build_tanner_graph_host(h), "cpu")
    pad = -1 if wide else bk.PAD16
    pl = bk.minsum_planes(g, wide=wide)
    as_int = (lambda t: t.numpy().astype(np.int64)) if wide else \
        (lambda t: t.numpy().view(np.uint16).astype(np.int64))
    chk, edge = as_int(pl.chk), as_int(pl.edge)
    mask, vmask = g.chk_mask.numpy(), g.var_mask.numpy()
    assert np.array_equal(chk.T, np.where(mask, g.chk_nbr.numpy(), pad))
    want = np.where(vmask, g.var_nbr_slot.numpy() * m + g.var_nbr.numpy(), pad)
    assert np.array_equal(edge.T, want)
    assert set(vmask.sum(axis=1).tolist()) == {1, 3, 4}
    head = bk.build_sparse_head(tbp.build_tanner_graph_host(h), "cpu")
    hedge = as_int(bk.minsum_planes(head, wide=wide).edge).T
    for j in range(n):
        live = hedge[j][hedge[j] != pad]
        assert list(live) == sorted(live) and len(live) == vmask[j].sum()
    cols = tod.col_pack(torch.from_numpy(h))
    bits = (cols.numpy().astype(np.int64)[:, :, None]
            >> np.arange(32)) & 1
    assert np.array_equal(bits.reshape(n, -1)[:, :m], h.T)


def test_32_bit_planes_number_what_16_bits_cannot():
    g = tbp.graph_to(tbp.build_tanner_graph_host(
        _matrix(("hgp_34_n1600", 11))), "cpu")
    with pytest.raises(ValueError, match="16 bits"):
        bk.minsum_planes(g)
    wide = bk.minsum_planes(g, wide=True)
    assert int(wide.chk.max()) == g.var_nbr.shape[0] - 1
    assert int(wide.edge.max()) >= bk.PAD16


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("sector", ["hx", "hz"])
@pytest.mark.parametrize("code", CODES)
def test_minsum_keeps_every_shipped_layout(code, sector, bf16):
    for h in (_h(code, sector), _ext(_h(code, sector))):
        g = tbp.build_tanner_graph_host(h)
        (m, rw), (n, cw) = g.chk_nbr.shape, g.var_nbr.shape
        for B in (1, 7, 256, 1024, 4096):
            lay = bk.minsum_layout(B, m, n, rw, cw, bf16, SMS,
                                   memory="auto")
            assert lay == bk.minsum_layout(B, m, n, rw, cw, bf16, SMS)
            assert lay.memory == "shared" and lay.lane_bytes == 0


# ------------------------------------------------------------------ fused v2

def _fused_spec(code):
    llr = tbp.llr_from_probs(np.full(code.N, 0.02), "cpu")
    return gk.build_fused_decode_spec(code.hx, code.hz, code.lx, code.lz,
                                      [0.01] * 3, llr, llr, "cpu")


# six copies of hgp_34_n625 (n = 3750): one fused shot needs ~271 KB
REFUSED = ("hgp_34_n625", 6)


def test_fused_decode_feasible_refuses_what_the_fused_layout_refuses():
    spec = _fused_spec(_code(*REFUSED))
    with pytest.raises(ValueError, match="shared memory"):
        gk.fused_layout(4096, *gk._fused_shape(spec), SMS)
    for quantize in (None, "int8"):
        assert not gk.fused_decode_feasible(spec, 4096, quantize=quantize)


@pytest.mark.parametrize("code", CODES)
def test_fused_decode_feasible_follows_the_layouts(code):
    spec = _fused_spec(_code(code))
    shape = gk._fused_shape(spec)
    n, mx, mz, rwz, rwx = spec.statics
    for B in (32, 256, 4096):
        gk.fused_layout(B, *shape, SMS)  # the bf16 kernel takes every one
        assert gk.fused_decode_feasible(spec, B)
        int8_fits = (gk.fused_int8_smem_bytes(
            n, mx, rwz, mz, rwx, gk.fused_int8_staged(n, mx, rwz, mz, rwx))
            + gk._INT8_FUSED_STATIC <= bk.SMEM_LIMIT)
        assert gk.fused_decode_feasible(spec, B, quantize="int8") == int8_fits
    assert gk.fused_decode_feasible(_fused_spec(_code("hgp_34_n625")), 4096,
                                    quantize="int8")
    assert not gk.fused_decode_feasible(spec, 33)  # no tile divides it


def test_fused_v2_stays_v2_on_the_cpu():
    """The CPU runs the plain version at any size: no fallback there."""
    code = _code(*REFUSED)
    probs = np.full(code.N, 0.02)
    dx = BPDecoder(code.hz, probs, 10, device="cpu")
    dz = BPDecoder(code.hx, probs, 10, device="cpu")
    before = CodeSimulator_DataError.fused_fallbacks
    sim = CodeSimulator_DataError(code=code, decoder_x=dx, decoder_z=dz,
                                  pauli_error_probs=[0.01] * 3,
                                  batch_size=32, fused_sampler="v2",
                                  device="cpu")
    assert sim._fused_sampler == "v2"
    assert CodeSimulator_DataError.fused_fallbacks == before


# ------------------------------------------------------- on the card (cuda)

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _synd(h, B, p, seed):
    rng = np.random.default_rng(seed)
    err = (rng.random((B, h.shape[1])) < p).astype(np.uint8)
    return torch.from_numpy((err @ h.T % 2).astype(np.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("full,percol", [(False, False), (True, False),
                                         (False, True)])
def test_elim_device_memory_mode_matches_plain(cuda, full, percol):
    h = _ext(_h("hgp_34_n1600"))
    m, n = h.shape
    plan = tod.build_osd_plan(h, np.full(n, 0.03), device=cuda)
    post = torch.randn((64, n), generator=torch.Generator().manual_seed(3))
    perm = torch.sort(post.to(cuda), dim=1, stable=True).indices
    synd = _synd(h, 64, 0.02, 4).to(cuda, torch.int32).t().contiguous()
    counter = tod.osd_elim_percol if percol else tod.osd_elim
    attr = "full_device_launches" if full else "device_launches"
    before = getattr(counter, attr)
    if percol:
        run = lambda: tod.osd_elim_percol(plan.packed, perm, synd, n=n,  # noqa: E731
                                          r_star=plan.rank)
    else:
        run = lambda: tod.osd_elim(plan.packed, perm, synd, n=n,  # noqa: E731
                                   r_star=plan.rank, fcap=10, full=full)
    # the blocked routes take the transform mode here: fix kGlobal
    with _kernels.force_memory("device"):
        k = run()
    assert getattr(counter, attr) == before + 1
    with _kernels.force_plain():
        p = run()
    for a, b in zip(k, p):
        assert torch.equal(a, b)


def _elim_case(cuda, h, B, seed):
    """The rows, permutation (posteriors drawn from normals), syndromes of
    p = 0.02 errors and rank of B shots of ``h`` on the card."""
    n = h.shape[1]
    plan = tod.build_osd_plan(h, np.full(n, 0.03), device=cuda)
    post = torch.randn((B, n), generator=torch.Generator().manual_seed(seed))
    perm = torch.sort(post.to(cuda), dim=1, stable=True).indices
    synd = _synd(h, B, 0.02, seed).to(cuda, torch.int32).t().contiguous()
    return plan.packed, perm, synd, plan.rank


def _transform_matches_plain(cuda, h, B, seed, fcap, full):
    """One osd_elim launch on B shots of ``h``: counted as a transform
    launch (and no device-memory one), every output equal to the plain
    version's."""
    rows, perm, synd, rank = _elim_case(cuda, h, B, seed)
    n = h.shape[1]
    fcap = min(fcap, n - rank)
    prefix = "full_" if full else ""
    before = (getattr(tod.osd_elim, prefix + "transform_launches"),
              getattr(tod.osd_elim, prefix + "device_launches"))
    run = lambda: tod.osd_elim(rows, perm, synd, n=n, r_star=rank,  # noqa: E731
                               fcap=fcap, full=full)
    k = run()
    torch.cuda.synchronize()
    assert (getattr(tod.osd_elim, prefix + "transform_launches"),
            getattr(tod.osd_elim, prefix + "device_launches")) == \
        (before[0] + 1, before[1])
    with _kernels.force_plain():
        p = run()
    assert len(k) == len(p) == (6 if full else 5)
    for a, b in zip(k, p):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("full,fcap", [(False, 0), (False, 10), (True, 0),
                                       (True, 10)])
@pytest.mark.parametrize("B", [256, 2048])
def test_elim_transform_mode_matches_plain(cuda, B, full, fcap):
    """The layout's own pick at [H|I] of hgp_34_n1600 (phase 30's decoder
    1 launches 2048 shots), bit for bit."""
    h = _ext(_h("hgp_34_n1600"))
    lay = tod.card_elim_layout(cuda, B, *h.shape, fcap,
                               "full" if full else "skip")
    assert lay.memory == "transform" and lay.resident >= 1
    _transform_matches_plain(cuda, h, B, 7, fcap, full)


def _edge_h(case):
    """n625's H (300 x 625); [H|I] of n225's H (m 108, not a multiple of
    32); hgp(ring_code(5), ring_code(5)) (m 25, rank below m)."""
    if case == "n625":
        return _h("hgp_34_n625")
    if case == "odd_m":
        return _ext(_h("hgp_34_n225"))
    return np.asarray(hgp(ring_code(5), ring_code(5)).hx, dtype=np.uint8)


@pytest.mark.cuda
@pytest.mark.parametrize("full,fcap", [(False, 0), (False, 10), (True, 10),
                                       (False, 32)])
@pytest.mark.parametrize("case", ["n625", "odd_m", "rank_deficient"])
def test_elim_transform_mode_forced_matches_plain(cuda, case, full, fcap):
    """``force_memory("transform")`` at shapes shared memory holds: m not a
    multiple of 32, r* < m, fcap 0, 10 and 32, 256 shots and one."""
    h = _edge_h(case)
    if case == "rank_deficient":
        assert tod.build_osd_plan(h, np.full(h.shape[1], 0.03),
                                  device="cpu").rank < h.shape[0]
    with _kernels.force_memory("transform"):
        for B in (256, 1):
            _transform_matches_plain(cuda, h, B, 11, fcap, full)


@pytest.mark.cuda
def test_elim_transform_mode_zero_syndromes_match_plain(cuda):
    h = _ext(_h("hgp_34_n1600"))
    rows, perm, _, rank = _elim_case(cuda, h, 64, 5)
    synd = torch.zeros((h.shape[0], 64), dtype=torch.int32, device=cuda)
    for full in (False, True):
        run = lambda: tod.osd_elim(rows, perm, synd, n=h.shape[1],  # noqa: E731
                                   r_star=rank, fcap=10, full=full)
        k = run()
        with _kernels.force_plain():
            p = run()
        for a, b in zip(k, p):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("copies,memory", [(3, "device"),
                                           (11, "device_planes")])
def test_minsum_device_memory_modes_match_plain(cuda, copies, memory):
    """The device-memory modes, which the layout now takes only where not
    even the check-state mode fits, fixed by force_memory."""
    h = _matrix(("hgp_34_n1600", copies))
    graph = tbp.build_tanner_graph(h, cuda)
    synd = _synd(h, 96, 0.02, copies).to(cuda)
    llr = tbp.llr_from_probs(np.full(h.shape[1], 0.02), cuda)
    m, n = h.shape
    lay = bk.card_minsum_layout(cuda, 96, m, n, *graph.chk_nbr.shape[1:],
                                graph.var_nbr.shape[1], False, memory=memory)
    assert lay.memory == memory
    counts = (bk.bp_minsum.device_launches,
              bk.bp_minsum.device_planes_launches)
    with _kernels.force_memory(memory):
        k = bk.bp_minsum(graph, synd, llr, max_iter=20)
    assert (bk.bp_minsum.device_launches,
            bk.bp_minsum.device_planes_launches) == \
        (counts[0] + (memory == "device"), counts[1] + (memory != "device"))
    with _kernels.force_plain():
        p = bk.bp_minsum(graph, synd, llr, max_iter=20)
    for a, b in zip(k, p):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_bf16_head_device_memory_mode_matches_plain(cuda):
    h = _matrix(("hgp_34_n1600", 3))
    head = bk.build_sparse_head(tbp.build_tanner_graph_host(h), cuda)
    synd = _synd(h, 64, 0.02, 5).to(cuda)
    llr = tbp.llr_from_probs(np.full(h.shape[1], 0.02), cuda)
    before = bk.bp_head_bf16.device_launches
    with _kernels.force_memory("device"):
        k = bk.bp_head_bf16(head, synd, llr, head_iters=12)
    assert bk.bp_head_bf16.device_launches == before + 1
    with _kernels.force_plain():
        p = bk.bp_head_bf16(head, synd, llr, head_iters=12)
    for a, b in zip(k, p):
        assert torch.equal(a, b)


def _wide_random(m=2000, n=8000, rw=33, seed=6):
    """A random H whose rows all have weight ``rw``: 66,000 edges at the
    defaults, past what 16 bits number, with check records that fit."""
    rng = np.random.default_rng(seed)
    h = np.zeros((m, n), np.uint8)
    for i in range(m):
        h[i, rng.choice(n, rw, replace=False)] = 1
    return h


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("copies,planes", [(3, "staged16"), (7, "global16"),
                                           (0, "global32")])
def test_minsum_check_state_mode_matches_plain(cuda, copies, planes, bf16):
    """The layout's own pick past shared memory: the check-state mode, its
    planes staged (three copies of [H|I]), read from device memory (seven)
    and 32-bit (a random 2000 x 8000 matrix of row weight 33: 66,000
    edges)."""
    h = _matrix(("hgp_34_n1600", copies)) if copies else _wide_random()
    g = tbp.build_tanner_graph_host(h)
    synd = _synd(h, 96, 0.02, copies).to(cuda)
    llr = tbp.llr_from_probs(np.full(h.shape[1], 0.02), cuda)
    (m, rw), (n, cw) = g.chk_nbr.shape, g.var_nbr.shape
    lay = bk.card_minsum_layout(cuda, 96, m, n, rw, cw, bf16)
    assert (lay.memory, lay.planes) == ("checks", planes)
    if bf16:
        head = bk.build_sparse_head(g, cuda)
        run, counter = (lambda: bk.bp_head_bf16(head, synd, llr,
                                                head_iters=20)), bk.bp_head_bf16
    else:
        graph = tbp.graph_to(g, cuda)
        run, counter = (lambda: bk.bp_minsum(graph, synd, llr,
                                             max_iter=20)), bk.bp_minsum
    before = (counter.checks_launches, counter.device_launches,
              counter.device_planes_launches)
    k = run()
    assert (counter.checks_launches, counter.device_launches,
            counter.device_planes_launches) == (before[0] + 1, *before[1:])
    with _kernels.force_plain():
        p = run()
    for a, b in zip(k, p):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_infeasible_fused_v2_runs_as_fused_v1(cuda):
    code = _code(*REFUSED)
    probs = np.full(code.N, 0.02)

    def sim(fused):
        dx = BPDecoder(code.hz, probs, 10, device=cuda)
        dz = BPDecoder(code.hx, probs, 10, device=cuda)
        return CodeSimulator_DataError(
            code=code, decoder_x=dx, decoder_z=dz,
            pauli_error_probs=[0.01] * 3, batch_size=256, seed=2,
            fused_sampler=fused, device=cuda)

    before = CodeSimulator_DataError.fused_fallbacks
    v2 = sim("v2")
    assert v2._fused_sampler is True
    assert CodeSimulator_DataError.fused_fallbacks == before + 1
    v2.WordErrorRate(512)
    v1 = sim(True)
    v1.WordErrorRate(512)
    assert (v2.last_failures, v2.min_logical_weight) == \
        (v1.last_failures, v1.min_logical_weight)

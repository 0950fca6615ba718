"""The min-sum kernels' check-state mode (csrc/bp_minsum.cu kMem 3,
``"checks"``), checked on the CPU.

Where one shot's per-edge messages do not fit a block's shared memory, the
card keeps each shot's state as one record per check (its two smallest
magnitudes, the slot of the first, its slots' signs and the sign product)
and the totals, in shared memory.  Held here: the mode's bytes and layout
at the shapes the main paths give it (``h1`` of phase 36's detector error
model, phase 33's window matrix, three copies of hgp_34_n1600's [H|I]) and
where it does not fit (eleven copies, which route to the device-memory
mode with 32-bit planes); the routing order and ``force_memory`` /
``force_planes``; and a plain PyTorch model of the per-check state, run
over ``minsum_plain``'s iterations: the c2v it rebuilds from the records
and the v2c it rebuilds from the totals are ``minsum_plain``'s per-edge
messages, and its outputs are ``minsum_plain``'s (float32) and
``minsum_dense_plain``'s (bf16), bit for bit (tolerance 0: the kernel is
built with FMA contraction off and keeps the plain versions' order).  The
kernel itself runs in tests/test_torch_minsum_wide_cuda.py and
tests/test_torch_smem_routes.py on the card."""
import numpy as np
import pytest
import torch

from qldpc_fault_tolerance_tpu_torch.ops import _kernels
from qldpc_fault_tolerance_tpu_torch.ops import bp as tbp
from qldpc_fault_tolerance_tpu_torch.ops import bp_kernel as bk

torch.set_num_threads(1)

SMS = 132  # an H100 SXM's SMs
SCALE = 0.625


# ----------------------------------------------------------------- layouts

@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("B", [1, 256, 2048])
def test_bytes_and_layout_at_h1(bf16, B):
    """h1 (900 x 9600, rw 59, cw 12): 900 records of 16 B, their bytes
    beside them (900 -> 912) and 9600 totals: 53,712 B a shot; its 16-bit
    planes (336,608 B with the LLRs) stay in device memory."""
    assert bk.minsum_checks_bytes(1, 900, 9600, 59, 12, "global16") == (
        14_400 + 912 + 38_400)
    assert bk.minsum_checks_bytes(0, 900, 9600, 59, 12, "staged16") == (
        106_208 + 230_400 + 38_400)
    assert bk.checks_planes(900, 9600, 59, 12) == "global16"
    lay = bk.minsum_layout(B, 900, 9600, 59, 12, bf16, SMS, memory="auto")
    assert (lay.memory, lay.planes, lay.lanes, lay.threads, lay.smem_bytes,
            lay.lane_bytes) == ("checks", "global16", 1, 1024, 53_712, 0)
    # two such blocks fit an SM's shared memory (the card's occupancy
    # lowers that to one: a block of 1024 threads takes its registers)
    assert lay.resident == 2 and lay.grid == min(B, 2 * SMS)


@pytest.mark.parametrize("shape,staged,lane", [
    ((2400, 7400, 9, 4), 43_200 + 59_200 + 29_600, 38_400 + 29_600),
    ((2304, 7104, 8, 4), 36_864 + 56_832 + 28_416, 36_864 + 28_416)],
    ids=["phase33_window", "n1600_three_copies"])
def test_bytes_and_layout_with_staged_planes(shape, staged, lane):
    """Phase 33's window matrix and three copies of hgp_34_n1600's [H|I]
    (rows up to 32: a record's byte lies in it): the 16-bit planes and the
    LLRs staged beside one shot's records and totals."""
    m, n, rw, cw = shape
    assert bk.minsum_checks_bytes(0, m, n, rw, cw) == staged
    assert bk.minsum_checks_bytes(1, m, n, rw, cw) == staged + lane
    assert bk.minsum_smem_bytes(1, m, n, rw, cw, False) > bk.SMEM_LIMIT
    for bf16 in (False, True):
        lay = bk.minsum_layout(2048, m, n, rw, cw, bf16, SMS, memory="auto")
        assert (lay.memory, lay.planes, lay.lanes, lay.smem_bytes) == (
            "checks", "staged16", 1, staged + lane)
    # per-shot LLRs are not staged
    assert bk.minsum_checks_bytes(1, m, n, rw, cw, llr_shared=False) == (
        staged - 4 * n + lane)


def test_eleven_copies_route_to_the_device_memory_mode():
    """Eleven copies of hgp_34_n1600's [H|I] (8448 x 26,048, 67,584
    edges): 16 bits cannot number them and their records and totals
    (239,360 B) exceed a block, so the layout takes the device-memory mode
    with 32-bit planes; forcing the check-state mode raises before any
    launch."""
    m, n, rw, cw = 8448, 26_048, 8, 4
    assert not bk.planes16(m, n, rw)
    assert bk.minsum_checks_bytes(1, m, n, rw, cw, "global32") == 239_360
    assert bk.checks_planes(m, n, rw, cw) is None
    lay = bk.minsum_layout(256, m, n, rw, cw, False, SMS, memory="auto")
    assert (lay.memory, lay.planes, lay.smem_bytes) == ("device_planes",
                                                        "global32", 0)
    with pytest.raises(ValueError, match="check records"):
        bk.minsum_layout(256, m, n, rw, cw, False, SMS, memory="checks")


def test_a_graph_too_large_for_the_records_takes_the_device_mode():
    """12,000 checks of row weight 2: the records and totals (240,000 B)
    exceed a block, the 16-bit planes (144,000 B with the LLRs) fit it, so
    the layout takes the device-memory mode with the planes staged."""
    m, n, rw, cw = 12_000, 12_000, 2, 2
    assert bk.minsum_checks_bytes(1, m, n, rw, cw, "global16") == 240_000
    lay = bk.minsum_layout(256, m, n, rw, cw, False, SMS, memory="auto")
    assert lay.memory == "device" and lay.smem_bytes == 144_000


def test_32_bit_planes_where_the_records_fit():
    """A graph that 16 bits cannot number (66,000 edges) whose records fit:
    the check-state mode with 32-bit planes; 16-bit forms are refused."""
    lay = bk.minsum_layout(512, 2000, 8000, 33, 30, False, SMS, memory="auto")
    assert (lay.memory, lay.planes, lay.smem_bytes) == (
        "checks", "global32", 16 * 2000 + 2000 + 4 * 8000)
    for planes in ("staged16", "global16"):
        with pytest.raises(ValueError, match="16 bits|exceed"):
            bk.minsum_layout(512, 2000, 8000, 33, 30, False, SMS,
                             memory="checks", planes=planes)


def test_routing_order():
    """shared, then checks, then device, then device_planes."""
    def pick(m, n, rw, cw):
        return bk.minsum_layout(256, m, n, rw, cw, False, SMS,
                                memory="auto").memory
    assert pick(300, 625, 7, 4) == "shared"
    assert pick(2304, 7104, 8, 4) == "checks"
    assert pick(12_000, 12_000, 2, 2) == "device"
    assert pick(8448, 26_048, 8, 4) == "device_planes"
    # a column heavier than a byte numbers leaves the check-state mode
    assert bk.checks_planes(2304, 7104, 8, bk.CHECKS_MAX_CW + 1) is None


@pytest.mark.parametrize("memory", _kernels.MEMORY_MODES)
def test_force_memory_fixes_each_mode(memory):
    """The wrappers pass ``memory_mode()`` and ``planes_form()`` to the
    layout: each mode can be fixed at a shape all take, and each plane form
    of the check-state mode."""
    m, n, rw, cw = 768, 2368, 8, 4  # [H|I] of hgp_34_n1600
    with _kernels.force_memory(memory):
        assert _kernels.memory_mode() == memory
        lay = bk.minsum_layout(512, m, n, rw, cw, False, SMS,
                               memory=_kernels.memory_mode(),
                               planes=_kernels.planes_form())
    assert lay.memory == memory
    assert _kernels.memory_mode() == "auto"
    if memory == "checks":
        for form in _kernels.PLANE_FORMS:
            with _kernels.force_planes(form):
                lay = bk.minsum_layout(512, m, n, rw, cw, False, SMS,
                                       memory=memory,
                                       planes=_kernels.planes_form())
            assert (lay.memory, lay.planes) == ("checks", form)
            assert lay.smem_bytes == bk.minsum_checks_bytes(
                lay.lanes, m, n, rw, cw, form)
        assert _kernels.planes_form() is None
    with pytest.raises(ValueError, match="plane form"):
        with _kernels.force_planes("shared"):
            pass


def test_lens_stop_each_walk_at_its_last_live_entry():
    """MinsumPlanes.lens: each check's and each variable's list length up
    to its last live entry (a list padded inside keeps its padding in the
    walk)."""
    h = _random_h(40, 160, 9, 1)
    g = tbp.graph_to(tbp.build_tanner_graph_host(h), "cpu")
    pl = bk.minsum_planes(g)
    m, n = h.shape
    assert pl.lens.dtype == torch.uint8 and pl.lens.shape == (m + n,)
    assert torch.equal(pl.lens[:m].long(), torch.from_numpy(h.sum(1)).long())
    assert torch.equal(pl.lens[m:].long(), torch.from_numpy(h.sum(0)).long())
    # the slot-ordered lists of a graph (bk.slot_ordered_graph) pad before
    # their live entries: the walk spans the whole list
    o = bk.minsum_planes(tbp.graph_to(bk.slot_ordered_graph(g), "cpu"))
    edge = o.edge.numpy().view(np.uint16).astype(np.int64).T
    last = np.array([max([t + 1 for t in range(edge.shape[1])
                          if edge[j, t] != bk.PAD16], default=0)
                     for j in range(n)])
    assert np.array_equal(o.lens[m:].numpy(), last)


# -------------------------------------------------- the per-check state model

def _random_h(m, n, rw, seed):
    """A random H with row weights up to ``rw`` (row 0 exactly ``rw``),
    every column covered."""
    rng = np.random.default_rng(seed)
    h = np.zeros((m, n), np.uint8)
    for i in range(m):
        w = rw if i == 0 else int(rng.integers(rw // 2, rw + 1))
        h[i, rng.choice(n, w, replace=False)] = 1
    for j in np.nonzero(h.sum(0) == 0)[0]:
        h[rng.integers(1, m), j] = 1
    return h


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _top2(vals, live, synd):
    """minsum_body.cuh check_top2 over each check's slots in order: the two
    smallest magnitudes, the first's slot, each slot's sign and the sign
    product with the syndrome's: the record of every check and shot."""
    big = torch.tensor(bk.BIG, dtype=torch.float32)
    min1 = big.expand(synd.shape).clone()
    min2 = min1.clone()
    amin = torch.zeros(synd.shape, dtype=torch.int64)
    neg = synd.clone()
    negs = torch.zeros(vals.shape, dtype=torch.bool)
    for s in range(vals.shape[0]):
        lv = live[s][:, None]
        mag = torch.where(lv, vals[s].abs(), big)
        negs[s] = lv & (vals[s] < 0)
        neg ^= negs[s]
        new1, new2 = mag < min1, mag < min2
        min2 = torch.where(new1, min1, torch.where(new2, mag, min2))
        amin = torch.where(new1, s, amin)
        min1 = torch.where(new1, mag, min1)
    return min1, min2, amin, negs, neg


def _c2v(rec, live, scale):
    """minsum_body.cuh check_c2v of every live slot, from the records."""
    min1, min2, amin, negs, neg = rec
    big = torch.tensor(bk.BIG, dtype=torch.float32)
    scale_t = torch.tensor(scale, dtype=torch.float32)
    out = []
    for s in range(live.shape[0]):
        r = scale_t * torch.minimum(torch.where(amin == s, min2, min1), big)
        r = torch.where(neg != negs[s], -r, r)
        out.append(torch.where(live[s][:, None], r, 0.0))
    return torch.stack(out)


def _records_decode(chk, var, lens, synd, llr0, max_iter, scale, bf16):
    """The check-state mode's loop in plain PyTorch: between passes only the
    records and the totals are kept.  Each iteration rebuilds the c2v from
    the records (the variable pass, walking each variable's list up to its
    length, and one padded term more in float32) and the v2c from the
    totals less the records' c2v (the check pass).  ``chk`` (rw, m) and
    ``var`` (cw, n) are the planes' lists (-1 pads), ``lens`` theirs.
    Returns the messages of each iteration and batch-last outputs frozen at
    each shot's first convergence."""
    rw, m = chk.shape
    cw, n = var.shape
    B = synd.shape[0]
    live = chk >= 0
    sb = synd.t().bool()
    store = _bf16 if bf16 else (lambda x: x)
    gather = _bf16 if bf16 else (lambda x: x)
    L = llr0[:, None].expand(n, B)
    v_of = chk.clamp(min=0)
    var_len = lens[m:].long()
    terms = var_len if bf16 else torch.clamp(var_len + 1, max=cw)
    rec = _top2(store(L[v_of]), live, sb)
    trace = []
    err = torch.zeros((n, B), dtype=torch.uint8)
    post = L.clone()
    iters = torch.full((B,), max_iter, dtype=torch.int32)
    done = torch.zeros(B, dtype=torch.bool)
    for it in range(1, max_iter + 1):
        c2v = _c2v(rec, live, scale).reshape(rw * m, B)
        if bf16:  # var_total's slot runs, bf16-rounded terms
            total, part = L.clone(), torch.zeros((n, B))
            run = torch.full((n,), -1, dtype=torch.int64)
            for t in range(cw):
                e = var[t]
                lv = (e >= 0) & (t < terms)
                slot = torch.where(lv, e // m, -1)
                c = _bf16(c2v[e.clamp(min=0)])
                same = lv & (slot == run)
                fresh = lv & ~same
                total = torch.where((fresh & (run >= 0))[:, None],
                                    total + part, total)
                part = torch.where(same[:, None], part + c,
                                   torch.where(fresh[:, None], c, part))
                run = torch.where(fresh, slot, run)
            total = torch.where((run >= 0)[:, None], total + part, total)
        else:     # var_total in list order; the walk stops at `terms`
            acc = None
            for t in range(cw):
                e = var[t]
                c = torch.where((e >= 0)[:, None], c2v[e.clamp(min=0)], 0.0)
                acc = c if t == 0 else torch.where(
                    (t < terms)[:, None], acc + c, acc)
            total = L + acc
        t_g = gather(total)
        v2c = torch.where(live[..., None], store(
            t_g[v_of] - c2v.reshape(rw, m, B)), 0.0)
        trace.append((c2v.reshape(rw, m, B), v2c))
        par = sb.clone()
        for s in range(rw):
            par ^= live[s][:, None] & (t_g[v_of[s]] < 0)
        match = ~par.any(dim=0)
        newly = match & ~done
        keep = done[None, :]
        err = torch.where(keep, err, (total < 0).to(torch.uint8))
        post = torch.where(keep, post, total)
        iters = torch.where(newly, it, iters)
        done = done | match
        rec = _top2(v2c, live, sb)
    return trace, (err, done, post, iters)


def _lists(g, head, bf16):
    """The planes' lists as int64 with -1 pads, and their lengths."""
    pl = bk.minsum_planes(head if bf16 else g)
    chk, var = (torch.from_numpy(t.numpy().view(np.uint16).astype(np.int64))
                for t in pl[:2])
    pad = bk.PAD16
    return (torch.where(chk == pad, -1, chk), torch.where(var == pad, -1, var),
            pl.lens)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("rw", [7, 40, 59, 64])
def test_records_reproduce_the_plain_versions(rw, bf16):
    m, n, B, iters = 40, 200, 64, 12
    h = _random_h(m, n, rw, rw)
    rng = np.random.default_rng(rw + 100)
    err = (rng.random((B, n)) < 0.03).astype(np.uint8)
    synd = torch.from_numpy((err @ h.T % 2).astype(np.uint8))
    p = np.full(n, 0.03)
    p[:3] = 0.5  # LLRs of exactly 0: signed zeros in the sums
    llr0 = tbp.llr_from_probs(p, "cpu")
    host = tbp.build_tanner_graph_host(h)
    g = tbp.graph_to(host, "cpu")
    head = bk.build_sparse_head(host, "cpu")
    chk, var, lens = _lists(g, head, bf16)
    trace, got = _records_decode(chk, var, lens, synd, llr0, iters, SCALE,
                                 bf16)
    if bf16:
        want = bk.minsum_dense_plain(head, synd.t().contiguous(), llr0,
                                     head_iters=iters, scale=SCALE,
                                     early_stop=False)
    else:
        seen = []

        def check_update(v2c, synd_sign, graph):
            c2v = bk.check_update_minsum(v2c, synd_sign, graph, SCALE)
            seen.append((v2c, c2v))
            return c2v

        want = bk.bp_loop(g, synd.t().contiguous(), llr0[:, None], iters,
                          check_update)
        # minsum_plain's messages are (m, rw, B): iteration k's c2v is the
        # check update's output, its v2c the next update's input
        slots = torch.from_numpy(host.chk_mask).t()[..., None]
        assert len(seen) >= 2
        for k in range(len(seen)):
            c2v = torch.where(slots, seen[k][1].permute(1, 0, 2), 0.0)
            assert torch.equal(trace[k][0].view(torch.int32),
                               c2v.view(torch.int32)), k
            if k + 1 < len(seen):
                v2c = torch.where(slots, seen[k + 1][0].permute(1, 0, 2), 0.0)
                assert torch.equal(trace[k][1].view(torch.int32),
                                   v2c.view(torch.int32)), k
    for name, a, b in zip(("error", "converged", "posterior", "iterations"),
                          got, want):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b.to(a.dtype)), name
    assert 0 < int(got[1].sum()) < B  # some shots converge, some do not

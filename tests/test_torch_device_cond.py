"""``utils/device.py device_cond`` (the port's ``lax.cond``) and the tier
ladders built on it, on the CPU.

On the card a capture turns every ``device_cond`` into two conditional
nodes; a node's body must give the same shapes and dtypes whichever branch
runs, and selecting between the branches must give the eager result.  The
both-branches hook (``device._both_branches``) checks exactly that here:
each tier of the BP ladder (``bp_decode_two_phase``: the compacted tail,
the 4x tier, the deepened head, the full decode) and of the OSD ladder
(``decode_device`` ``"bposd_dev"``: none, B/16, B/4, the full batch, and
the B < 64 gate) runs under the hook, eagerly, and in the JAX package on
the same numpy-seeded syndromes.  Tolerance: none — the port's float32
decode and its OSD are the JAX package's twins on the CPU.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qldpc_fault_tolerance_tpu import decoders as jdec
from qldpc_fault_tolerance_tpu.ops import bp as jbp
from qldpc_fault_tolerance_tpu_torch.codes import hgp, load_code, ring_code
from qldpc_fault_tolerance_tpu_torch.decoders import (
    BPOSD_Decoder,
    decode_device,
    osd_compaction_tiers,
)
from qldpc_fault_tolerance_tpu_torch.ops import bp as tbp
from qldpc_fault_tolerance_tpu_torch.utils import device as tdevice
from qldpc_fault_tolerance_tpu_torch.utils.device import device_cond, host_value

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pair(x):
    return (x * 2, x.sum())


def test_eager_choice_reads_a_tensor_pred_once():
    x = torch.arange(5.0)
    reads = device_cond.host_reads
    assert torch.equal(device_cond(True, lambda: x + 1, lambda: x - 1), x + 1)
    assert device_cond.host_reads == reads
    out = device_cond(torch.tensor(False), lambda: x + 1, lambda: x - 1)
    assert torch.equal(out, x - 1) and device_cond.host_reads == reads + 1


@pytest.mark.parametrize("a", [False, True])
@pytest.mark.parametrize("b", [0, 3, 7])
def test_nested_conds_and_the_both_branches_hook(a, b):
    """Three deep, each path: the hook's selection equals the eager
    result, with pytrees of tensors as outputs."""
    x = torch.arange(8, dtype=torch.float32)

    def run(flag, level):
        def inner():
            return device_cond(level <= 2, lambda: _pair(x + level),
                               lambda: device_cond(level <= 5,
                                                   lambda: _pair(x - level),
                                                   lambda: _pair(x * level)))
        return device_cond(flag, inner, lambda: _pair(-x))

    want = run(a, b)
    with tdevice._both_branches():
        got = run(torch.tensor(a), torch.tensor(b))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_both_branches_hook_rejects_unlike_branches():
    x = torch.arange(4)
    with tdevice._both_branches():
        with pytest.raises(ValueError):
            device_cond(torch.tensor(True), lambda: x, lambda: x[:3])
        with pytest.raises(ValueError):
            device_cond(torch.tensor(True), lambda: x, lambda: x.float())
        with pytest.raises(ValueError):
            device_cond(torch.tensor(True), lambda: (x,), lambda: (x, x))


def test_host_value_reads_once_eagerly_and_never_under_the_hook():
    class Owner:
        host_reads = 0

    t = torch.tensor(7, dtype=torch.int32)
    assert host_value(t, Owner) == 7 and Owner.host_reads == 1
    with tdevice._both_branches():
        assert host_value(t, Owner) is t and Owner.host_reads == 1


def _bp_case(p, seed=3, B=96):
    code = load_code(os.path.join(REPO, "codes_lib_tpu", "hgp_34_n225.npz"))
    h = code.hx
    rng = np.random.default_rng(seed)
    err = (rng.random((B, h.shape[1])) < p).astype(np.uint8)
    synd = (err @ h.T % 2).astype(np.uint8)
    return h, synd, np.full(h.shape[1], p)


def _bp_tier(graph, synd, llr, b, tail, max_iter):
    """Which tier of the ladder a decode takes, from the heads' straggler
    counts (the JAX package's rule)."""
    tiers = [tail] + ([4 * tail] if 4 * tail < b else [])
    bad = int((~tbp.bp_decode(graph, synd, llr, max_iter=3,
                              device="cpu").converged).sum())
    if bad <= tiers[0]:
        return "tail"
    if bad <= tiers[-1]:
        return "4x"
    head2 = tbp.two_phase_head2_iters(3, max_iter)
    bad2 = int((~tbp.bp_decode(graph, synd, llr, max_iter=head2,
                               device="cpu").converged).sum())
    return "deepened" if bad2 <= tiers[-1] else "full"


BP_CASES = [(0.01, 4), (0.02, 8), (0.05, 16), (0.05, 4)]


@pytest.mark.parametrize("p,tail", BP_CASES)
def test_bp_ladder_hook_equals_eager_and_jax(p, tail):
    h, synd, probs = _bp_case(p)
    graph = tbp.build_tanner_graph(h, "cpu")
    llr = tbp.llr_from_probs(probs, "cpu")
    synd_t = torch.from_numpy(synd)

    def port():
        return tbp.bp_decode_two_phase(graph, synd_t, llr, max_iter=50,
                                       tail_capacity=tail, device="cpu")

    eager = port()
    reads = tbp.bp_decode_two_phase.host_reads
    with tdevice._both_branches():
        both = port()
    assert tbp.bp_decode_two_phase.host_reads == reads
    ref = jbp.bp_decode_two_phase(jbp.build_tanner_graph(h), jnp.asarray(synd),
                                  jbp.llr_from_probs(probs), max_iter=50,
                                  tail_capacity=tail)
    for name, a, b, j in zip(eager._fields, both, eager, ref):
        assert a.dtype == b.dtype and torch.equal(a, b), name
        assert np.array_equal(a.numpy(), np.asarray(j)), name


def test_bp_cases_cover_every_tier():
    seen = set()
    for p, tail in BP_CASES:
        h, synd, probs = _bp_case(p)
        seen.add(_bp_tier(tbp.build_tanner_graph(h, "cpu"),
                          torch.from_numpy(synd),
                          tbp.llr_from_probs(probs, "cpu"), 96, tail, 50))
    assert seen == {"tail", "4x", "deepened", "full"}


def _osd_case(p, B, seed):
    code = hgp(ring_code(5), ring_code(5))
    rng = np.random.default_rng(seed)
    err = (rng.random((B, code.N)) < p).astype(np.uint8)
    return code.hx, (err @ code.hx.T % 2).astype(np.uint8), code.N


def _osd_tier(dec, synd):
    B = synd.shape[0]
    _, aux = decode_device(dec.device_static[1], dec.device_state,
                           torch.from_numpy(synd))
    bad = int((~aux["converged"]).sum())
    if B < 64:
        return "small" if bad else "small none"
    for cap, name in zip(osd_compaction_tiers(B), ("B/16", "B/4")):
        if bad == 0:
            return "none"
        if bad <= cap:
            return name
    return "full"


OSD_CASES = [(0.0, 2048), (0.006, 2048), (0.03, 2048), (0.08, 2048),
             (0.05, 40)]


@pytest.mark.parametrize("p,B", OSD_CASES)
def test_osd_ladder_hook_equals_eager_and_jax(p, B):
    h, synd, n = _osd_case(p, B, seed=int(p * 1000) + B)
    probs = np.full(n, 0.05)
    dec = BPOSD_Decoder(h, probs, 8, osd_order=4, device="cpu")
    synd_t = torch.from_numpy(synd)
    eager, _ = decode_device(dec.device_static, dec.device_state, synd_t)
    reads = decode_device.host_reads
    with tdevice._both_branches():
        both, _ = decode_device(dec.device_static, dec.device_state, synd_t)
    assert decode_device.host_reads == reads
    assert torch.equal(both, eager)
    ref = np.asarray(jdec.BPOSD_Decoder(h, probs, 8, osd_order=4)
                     .decode_batch(synd))
    assert np.array_equal(eager.numpy(), ref)


def test_osd_cases_cover_every_tier():
    seen = set()
    for p, B in OSD_CASES:
        h, synd, n = _osd_case(p, B, seed=int(p * 1000) + B)
        dec = BPOSD_Decoder(h, np.full(n, 0.05), 8, osd_order=4,
                            device="cpu")
        seen.add(_osd_tier(dec, synd))
    assert seen == {"none", "B/16", "B/4", "full", "small"}

"""Port bf16 BP head (``ops/bp_kernel.py`` ``bp_head_bf16``, the JAX
package's ``_minsum_plane_loop`` behind its v2 and v1 heads) on the CPU,
where it runs its plain version ``minsum_dense_plain``, against the JAX
package; and the decoders' head rule and program names against JAX's.

Tolerances: none against the JAX v1 kernel ``bp_head_pallas`` run in
interpret mode — every output bit-exact, for either port head type.
Against the JAX v2 kernel ``bp_head_sparse`` (interpret mode and its XLA
twin) hard decisions, converged flags and iterations are bit-exact, and so
is every posterior of a converged shot; a posterior of a shot that never
converged may differ only where one of that shot's slot scatter-sums (the
float32 sum of up to cw bf16 messages onto one variable) was inexact in the
port's ascending-check order, since the JAX v2 paths add those terms in
another order.  The two-phase decode with a v2 head is bit-exact against
JAX's with its v2 head in interpret mode."""
import os
import types

import numpy as np
import pytest
import torch

import jax

from qldpc_fault_tolerance_tpu import decoders as jdec
from qldpc_fault_tolerance_tpu.codes import hgp as jhgp
from qldpc_fault_tolerance_tpu.codes import rep_code as jrep_code
from qldpc_fault_tolerance_tpu.codes import ring_code as jring_code
from qldpc_fault_tolerance_tpu.decoders import bp_decoders as jbd
from qldpc_fault_tolerance_tpu.ops import bp as jbp
from qldpc_fault_tolerance_tpu.ops import bp_pallas
from qldpc_fault_tolerance_tpu_torch.codes import load_code
from qldpc_fault_tolerance_tpu_torch.decoders import (
    BPDecoder,
    decode_device,
    kernel_variant,
)
from qldpc_fault_tolerance_tpu_torch.decoders import bp_decoders as tbd
from qldpc_fault_tolerance_tpu_torch.ops import bp as tbp
from qldpc_fault_tolerance_tpu_torch.ops import bp_kernel as bk

# one intra-op thread: the suite runs several pytest workers on few cores,
# and an oversubscribed torch thread pool stalls small ops
torch.set_num_threads(1)

CODES = ("rep45", "ring44", "hgp_34_n225")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _h(name):
    if name == "rep45":
        return jhgp(jrep_code(4), jrep_code(5)).hx
    if name == "ring44":
        return jhgp(jring_code(4), jring_code(4)).hx
    return load_code(os.path.join(REPO, "codes_lib_tpu", f"{name}.npz")).hx


def _syndromes(h, B, p, seed):
    rng = np.random.default_rng(seed)
    err = (rng.random((B, h.shape[1])) < p).astype(np.uint8)
    return (err @ h.T % 2).astype(np.uint8)


def _assert_bitexact(jax_res, port_res):
    for name, a, b in zip(("error", "converged", "posterior", "iterations"),
                          jax_res, port_res):
        a, b = np.asarray(a), b.numpy()
        if name == "posterior":
            assert np.array_equal(a.view(np.int32), b.view(np.int32)), name
        else:
            assert np.array_equal(a.astype(b.dtype), b), name


@pytest.fixture(scope="module", params=CODES)
def run(request):
    """256 shots at p=0.05, 50 iterations: the port's bf16 head over each
    head type (the SparseHeadGraph run records the shots whose
    rank-ordered scatter-sums rounded), and the JAX v1 kernel, v2 kernel
    (interpret mode) and v2 XLA twin on the same inputs."""
    h = _h(request.param)
    jg = jbp.build_tanner_graph_host(h)
    tg = tbp.build_tanner_graph_host(h)
    llr = np.array(jbp.llr_from_probs(np.full(h.shape[1], 0.05)))
    synd = _syndromes(h, 256, 0.05, 3)
    args = (torch.from_numpy(synd), torch.from_numpy(llr))
    rounded = torch.zeros(256, dtype=torch.bool)
    add = bk._add_rank

    def recording_add(part, prod):
        out = add(part, prod)
        rounded.logical_or_((part.double() + prod.double() != out.double())
                            .any(dim=0))
        return out

    bk._add_rank = recording_add
    try:
        sparse = bk.bp_head_bf16(bk.build_sparse_head(tg, "cpu"), *args,
                                 head_iters=50)
    finally:
        bk._add_rank = add
    dense = bk.bp_head_bf16(bk.build_pallas_head(tg, "cpu"), *args,
                            head_iters=50, early_stop=True)
    jsg = bp_pallas.build_sparse_head(jg)
    kw = dict(head_iters=50, block_b=256)
    return types.SimpleNamespace(
        sparse=sparse, dense=dense, rounded=rounded.numpy(),
        v1=bp_pallas.bp_head_pallas(bp_pallas.build_pallas_head(jg), synd,
                                    llr, interpret=True, **kw),
        v2=bp_pallas.bp_head_sparse(jsg, synd, llr, interpret=True, **kw),
        twin=bp_pallas.bp_head_sparse(jsg, synd, llr, backend="xla", **kw))


def test_bf16_head_bitexact_vs_v1_interpret(run):
    """Either port head type gives the JAX v1 kernel's every output bit."""
    _assert_bitexact(run.v1, run.sparse)
    _assert_bitexact(run.v1, run.dense)


@pytest.mark.parametrize("ref", ["v2", "twin"])
def test_bf16_head_vs_sparse_head(run, ref):
    """Hard outputs bit-exact; posteriors bit-exact on converged shots and
    elsewhere differing only on a shot whose scatter-sum rounded."""
    jres, got = getattr(run, ref), run.sparse
    for i in (0, 1, 3):
        assert np.array_equal(np.asarray(jres[i]).astype(got[i].numpy().dtype),
                              got[i].numpy())
    differ = (np.asarray(jres[2]).view(np.int32)
              != got[2].numpy().view(np.int32)).any(axis=1)
    conv = got[1].numpy()
    assert not (differ & conv).any()
    assert not (differ & ~run.rounded).any(), (
        f"shots {np.nonzero(differ & ~run.rounded)[0].tolist()} differ "
        f"without an inexact scatter-sum")


def test_bf16_head_early_stop_and_zero_iterations():
    """Early exit changes no output (outputs freeze at convergence); zero
    iterations give the channel's decision; bad arguments raise."""
    h = _h("ring44")
    sg = bk.build_sparse_head(tbp.build_tanner_graph_host(h), "cpu")
    llr = tbp.llr_from_probs(np.full(h.shape[1], 0.04), "cpu")
    synd = torch.from_numpy(_syndromes(h, 100, 0.04, 8))
    a = bk.bp_head_bf16(sg, synd, llr, head_iters=30)
    b = bk.bp_head_bf16(sg, synd, llr, head_iters=30, early_stop=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    err, conv, post, iters = bk.bp_head_bf16(sg, synd, llr, head_iters=0)
    assert not err.any() and not conv.any() and not iters.any()
    assert torch.equal(post, llr.expand(100, -1))
    with pytest.raises(ValueError, match="head_iters"):
        bk.bp_head_bf16(sg, synd, llr, head_iters=-1)
    with pytest.raises(ValueError, match="checks"):
        bk.bp_head_bf16(sg, synd[:, 1:], llr, head_iters=3)


@pytest.mark.parametrize("code,max_iter,p", [("rep45", 20, 0.05),
                                             ("hgp_34_n225", 50, 0.06)])
def test_v2_two_phase_decode_vs_jax(monkeypatch, code, max_iter, p):
    """The two-phase decode with a SparseHeadGraph head (head, compacted
    tail with early exit, deepened head at p=0.06) against JAX's
    bp_decode_two_phase with its v2 head.  JAX's v2 head runs its kernel
    only on a TPU, so the test runs it in interpret mode (bp_head_sparse
    wrapped here, nothing in the JAX package changes); the same shots
    through a CUDA-rule decoder state give the same outputs."""
    h = _h(code)
    llr = np.array(jbp.llr_from_probs(np.full(h.shape[1], p)))
    synd = _syndromes(h, 512, p, 9)
    sparse = bp_pallas.bp_head_sparse

    def interpret(*args, **kw):
        return sparse(*args, **dict(kw, interpret=True))

    monkeypatch.setattr(bp_pallas, "bp_head_sparse", interpret)
    jsg = bp_pallas.build_sparse_head(jbp.build_tanner_graph_host(h))
    ref = jbp.bp_decode_two_phase(jbp.build_tanner_graph(h), synd, llr,
                                  max_iter=max_iter, pallas_head=jsg)
    tg = tbp.build_tanner_graph_host(h)
    head = bk.build_sparse_head(tg, "cpu")
    reads = tbp.bp_decode_two_phase.host_reads
    got = tbp.bp_decode_two_phase(tbp.graph_to(tg, "cpu"),
                                  torch.from_numpy(synd),
                                  torch.from_numpy(llr), max_iter=max_iter,
                                  head=head, device="cpu")
    _assert_bitexact(ref, got)
    if code == "hgp_34_n225":  # the deepened head ran: two straggler reads
        assert tbp.bp_decode_two_phase.host_reads == reads + 2
    dec = BPDecoder(h, np.full(h.shape[1], p), max_iter, device="cpu")
    assert dec.device_static[5] == "none"  # the CPU decodes in float32
    static = dec.device_static[:5] + ("v2",)
    err, aux = decode_device(static, dict(dec.device_state, pallas=head),
                             torch.from_numpy(synd))
    _assert_bitexact(ref, (err, aux["converged"], aux["posterior_llr"],
                           aux["iterations"]))
    assert jax.default_backend() == "cpu"


def _on_the_accelerator(monkeypatch):
    """JAX's head rule and program names as on its TPU, the port's as on
    the card: the JAX package reads its backend through module attributes,
    patched here; the port's heads build on the CPU in place of the card."""
    monkeypatch.setattr(jbd, "jax", types.SimpleNamespace(
        default_backend=lambda: "tpu"))
    monkeypatch.setattr(bp_pallas, "v2_mosaic_supported",
                        lambda quantize=None: True)
    monkeypatch.setattr(bp_pallas, "sparse_serves_pallas", lambda: True)
    for name in ("build_sparse_head", "build_pallas_head"):
        build = getattr(bk, name)
        monkeypatch.setattr(bk, name, lambda g, device, b=build: b(g, "cpu"))


HEAD_TYPES = {"v2": bk.SparseHeadGraph, "v1": bk.PallasHeadGraph,
              "v2_int8": bk.SparseHeadGraph, "none": type(None)}


@pytest.mark.parametrize("kw", [{}, {"bp_kernel": "v2"}, {"bp_kernel": "v1"},
                                {"bp_kernel": "xla"}, {"quantize": "int8"},
                                {"bp_method": "product_sum"}])
def test_make_head_device_rule_vs_jax(monkeypatch, kw):
    """On the CPU the port picks what JAX picks off its TPU; on the card
    what JAX picks on its TPU: tag and head type for every tag."""
    code = jhgp(jring_code(4), jring_code(4))
    h = code.hx
    graph = tbp.build_tanner_graph_host(h)
    method = kw.get("bp_method", "minimum_sum")
    args = (method, graph, kw.get("quantize"), kw.get("bp_kernel"))
    jargs = (method, jbp.build_tanner_graph_host(h), kw.get("quantize"),
             kw.get("bp_kernel"))
    for on_card in (False, True):
        if on_card:
            _on_the_accelerator(monkeypatch)
        jhead, jtag = jbd._maybe_pallas_head(*jargs)
        head, tag = tbd._make_head(*args, device="cuda" if on_card else "cpu")
        assert tag == jtag, (kw, on_card)
        assert isinstance(head, HEAD_TYPES[tag])
        assert type(head).__name__ == type(jhead).__name__


@pytest.mark.parametrize("kw", [{}, {"bp_kernel": "v1"}, {"bp_kernel": "xla"},
                                {"quantize": "int8"}])
def test_kernel_variant_names_vs_jax(monkeypatch, kw):
    """kernel_variant gives JAX's name for every tag, batch gate and the
    bposd_dev wrapper, with both packages on their accelerator; on the CPU
    every port decode is a plain version (xla_twin)."""
    code = jhgp(jring_code(4), jring_code(4))
    probs = np.full(code.N, 0.05)
    cpu = BPDecoder(code.hx, probs, 20, device="cpu", **kw)
    assert cpu.kernel_variant == "xla_twin"
    _on_the_accelerator(monkeypatch)
    jd = jdec.BPDecoder(code.hx, probs, 20, **kw)
    tag = tbd._make_head(cpu.bp_method, tbp.build_tanner_graph_host(code.hx),
                         cpu.quantize, kw.get("bp_kernel"), "cuda")
    static = cpu.device_static[:5] + (tag[1],)
    assert static == jd.device_static
    card = dict(cpu.device_state, pallas=tag[0],
                llr0=types.SimpleNamespace(is_cuda=True, dim=lambda: 1))
    for b in (None, 32, 128, 256, 320, 512, 1024):
        want = jbd.kernel_variant(jd.device_static, jd.device_state, b)
        assert kernel_variant(static, card, b) == want, (kw, b)
        bposd = ("bposd_dev", static, 1, 1, 0, "pallas", "osd_e")
        assert kernel_variant(bposd, card, b) == want
    assert kernel_variant(static, card) == {
        "v2": "sparse_gather", "v1": "dense_onehot",
        "v2_int8": "sparse_int8", "none": "xla_twin"}[tag[1]]

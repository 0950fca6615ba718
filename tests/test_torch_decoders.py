"""Port decoders/bp_decoders.py: factories, decode API and the JAX-state
bridge ``state_from_jax``.

Tolerance: none — the state bridge must reproduce the port's own build
tensor for tensor, and decoding with either state must give identical
results."""
import numpy as np
import pytest
import torch

import jax

from qldpc_fault_tolerance_tpu import decoders as jdec
from qldpc_fault_tolerance_tpu.ops import bp as jax_bp
from qldpc_fault_tolerance_tpu.ops import bp_pallas as jax_bp_pallas
from qldpc_fault_tolerance_tpu_torch.codes import hgp, rep_code, ring_code
from qldpc_fault_tolerance_tpu_torch.decoders import (
    BP_Decoder_Class,
    BPDecoder,
    BPOSD_Decoder,
    BPOSD_Decoder_Class,
    decode_device,
    kernel_variant,
    state_from_jax,
)
from qldpc_fault_tolerance_tpu_torch.decoders import bp_decoders
from qldpc_fault_tolerance_tpu_torch.ops import bp
from qldpc_fault_tolerance_tpu_torch.ops import bp_kernel as bk

# one intra-op thread: the suite runs several pytest workers on few cores,
# and an oversubscribed torch thread pool stalls small ops
torch.set_num_threads(1)


def _syndromes(h, B, p, seed):
    rng = np.random.default_rng(seed)
    err = (rng.random((B, h.shape[1])) < p).astype(np.uint8)
    return (err @ h.T % 2).astype(np.uint8)


def _same_tensors(a, b, what):
    assert a.dtype == b.dtype and torch.equal(a, b), what


@pytest.mark.parametrize("kind", ["bp", "bposd", "bp_int8", "bp_v1"])
def test_state_from_jax_round_trip(kind):
    """Every state field, the BP head included: None for the float32
    decoders, a SparseHeadGraph for int8, a PallasHeadGraph for v1 (JAX
    builds its v1 head only on a TPU, and the port only on the card, so the
    test puts one in both states and decodes with the "v1" tag)."""
    code = hgp(ring_code(4), ring_code(4))
    h = code.hx
    probs = np.full(code.N, 0.05)
    if kind == "bposd":
        jd = jdec.BPOSD_Decoder(h, probs, 20, osd_order=4)
        td = BPOSD_Decoder(h, probs, 20, osd_order=4, device="cpu")
    else:
        quantize = "int8" if kind == "bp_int8" else None
        kernel = "v1" if kind == "bp_v1" else None
        jd = jdec.BPDecoder(h, probs, 20, quantize=quantize)
        td = BPDecoder(h, probs, 20, quantize=quantize, bp_kernel=kernel,
                       device="cpu")
    jstate = dict(jd.device_state)
    own = td.device_state
    static = td.device_static
    if kind == "bp_v1":
        jstate["pallas"] = jax_bp_pallas.build_pallas_head(
            jax_bp.build_tanner_graph_host(h))
        own = dict(own, pallas=bk.build_pallas_head(
            jax_bp.build_tanner_graph_host(h), "cpu"))
        static = static[:5] + ("v1",)
    np_state = jax.tree_util.tree_map(np.asarray, jstate)
    bridged = state_from_jax(np_state, device="cpu")
    assert set(bridged) == set(own)
    for key in own:
        if key in ("graph", "pallas"):
            assert (bridged[key] is None) == (own[key] is None), key
            if own[key] is None:
                continue
            assert type(bridged[key]) is type(own[key])
            for name, x, y in zip(own[key]._fields, bridged[key], own[key]):
                _same_tensors(x, y, f"{key}.{name}")
        else:
            _same_tensors(bridged[key], own[key], key)
    synd = torch.from_numpy(_syndromes(h, 256, 0.06, 1))
    a, aux_a = decode_device(static, bridged, synd)
    b, aux_b = decode_device(static, own, synd)
    assert torch.equal(a, b)
    for k in aux_a:
        assert torch.equal(aux_a[k], aux_b[k])


def test_factories_match_jax_parameters():
    code = hgp(rep_code(3), rep_code(3))
    params = {"h": code.hx, "p_data": 0.02}
    args = (5, "min_sum", 0.75)
    jbp, tbp = (jdec.BP_Decoder_Class(*args).GetDecoder(params),
                BP_Decoder_Class(*args, device="cpu").GetDecoder(params))
    assert (jbp.max_iter, jbp.bp_method, jbp.ms_scaling_factor) == (
        tbp.max_iter, tbp.bp_method, tbp.ms_scaling_factor)
    assert np.array_equal(jbp.channel_probs, tbp.channel_probs)
    ext = {"h": np.concatenate([code.hx, np.eye(code.hx.shape[0], dtype=np.uint8)], 1),
           "p_data": 0.02, "p_syndrome": 0.01}
    jo = jdec.BPOSD_Decoder_Class(*args, "osd_e", 6).GetDecoder(ext)
    to = BPOSD_Decoder_Class(*args, "osd_e", 6, device="cpu").GetDecoder(ext)
    assert (jo.max_iter, jo.osd_order) == (to.max_iter, to.osd_order)
    assert np.array_equal(jo.channel_probs, to.channel_probs)
    with pytest.raises(KeyError):
        BP_Decoder_Class(*args, device="cpu").GetDecoder({"h": code.hx})


@pytest.mark.parametrize("cls", [BPDecoder, BPOSD_Decoder])
def test_decode_single_matches_batch_and_satisfies_syndrome(cls):
    code = hgp(ring_code(3), ring_code(3))
    dec = cls(code.hx, np.full(code.N, 0.05), 20, device="cpu")
    synd = _syndromes(code.hx, 70, 0.05, 2)
    batch = dec.decode_batch(synd)
    assert batch.shape == (70, code.N) and batch.dtype == np.uint8
    assert np.array_equal(dec.decode(synd[5]), batch[5])
    if cls is BPOSD_Decoder:  # OSD always lands on the syndrome
        assert np.array_equal(batch.astype(np.int64) @ code.hx.T % 2, synd)


def test_bposd_tiers_give_identical_shots():
    """The compacted OSD tiers (B/16, B/4) and the full batch give each shot
    the same correction: decode the same shots in batches that take each
    tier and compare with single-shot decodes."""
    code = hgp(ring_code(5), ring_code(5))
    dec = BPOSD_Decoder(code.hx, np.full(code.N, 0.08), 8, osd_order=4,
                        device="cpu")
    synd = _syndromes(code.hx, 2048, 0.06, 3)
    reads = decode_device.host_reads
    whole = dec.decode_batch(synd)
    assert decode_device.host_reads == reads + 1
    small = np.concatenate([dec.decode_batch(synd[i:i + 256])
                            for i in range(0, 2048, 256)])
    tiny = np.concatenate([dec.decode_batch(synd[i:i + 32])
                           for i in range(0, 2048, 32)])
    assert np.array_equal(whole, small) and np.array_equal(whole, tiny)


def test_bposd_static_slots_and_unknown_method_raises(monkeypatch):
    """The JAX package's 7-slot static; OSD-CS is a device method now, an
    unknown method or elimination route still raises."""
    code = hgp(ring_code(3), ring_code(3))
    probs = np.full(code.N, 0.05)
    cs = BPOSD_Decoder(code.hx, probs, 10, osd_method="osd_cs", osd_order=4,
                       device="cpu")
    j = jdec.BPOSD_Decoder(code.hx, probs, 10, osd_method="osd_cs", osd_order=4)
    assert cs.device_static[0] == "bposd_dev" and len(cs.device_static) == 7
    # the nested BP static is the JAX package's 6 slots, its head tag "none"
    # on the CPU as JAX's off its TPU
    assert len(cs.device_static[1]) == len(j.device_static[1]) == 6
    assert cs.device_static[1][:5] == j.device_static[1][:5]
    assert cs.device_static[1][5] == j.device_static[1][5] == "none"
    assert cs.device_static[2:] == j.device_static[2:]
    assert cs.device_static[2:] == (code.N, cs.device_static[3], 4, "pallas",
                                    "osd_cs")
    made = BPOSD_Decoder_Class(10, "minimum_sum", 0.625, "osd_cs", 4,
                               device="cpu").GetDecoder({"h": code.hx,
                                                         "p_data": 0.05})
    assert made.device_static[4:] == (4, "pallas", "osd_cs")
    e0 = BPOSD_Decoder(code.hx, probs, 10, osd_method="osd_0", device="cpu")
    assert e0.device_static[4:] == (0, "pallas", "osd_e")
    monkeypatch.setenv("QLDPC_OSD_ELIM", "pallas_percol")
    assert BPOSD_Decoder(code.hx, probs, 10, device="cpu").device_static[5] \
        == "pallas_percol"
    monkeypatch.setenv("QLDPC_OSD_ELIM", "twin")
    with pytest.raises(ValueError, match="route"):
        BPOSD_Decoder(code.hx, probs, 10, device="cpu")
    monkeypatch.delenv("QLDPC_OSD_ELIM")
    with pytest.raises(NotImplementedError):
        BPOSD_Decoder(code.hx, probs, 10, osd_method="osd_xyz", device="cpu")
    with pytest.raises(ValueError, match="OSD_CS_MAX_ORDER"):
        BPOSD_Decoder(code.hx, probs, 10, osd_method="osd_cs", osd_order=21,
                      device="cpu")


def test_head_tags_and_kernel_variant(monkeypatch):
    """bp_kernel / QLDPC_BP_KERNEL and quantize pick the head and its tag by
    the device: on the CPU only int8 builds a head, as the JAX package off
    its TPU.  kernel_variant gives JAX's names: xla_twin for every float32
    and every plain decode, the head's name for an engaged head on the card
    (a stand-in CUDA state here)."""
    import types

    code = hgp(ring_code(4), ring_code(4))
    probs = np.full(code.N, 0.05)

    def make(**kw):
        return BPDecoder(code.hx, probs, 20, device="cpu", **kw)

    cases = {(): ("none", type(None), "xla_twin"),
             (("bp_kernel", "v2"),): ("none", type(None), "xla_twin"),
             (("bp_kernel", "xla"),): ("none", type(None), "xla_twin"),
             (("bp_kernel", "v1"),): ("none", type(None), "xla_twin"),
             (("quantize", "int8"),): ("v2_int8", bk.SparseHeadGraph,
                                       "sparse_int8"),
             (("bp_method", "product_sum"),): ("none", type(None), "xla_twin")}
    for kw, (tag, head_type, on_card) in cases.items():
        dec = make(**dict(kw))
        assert dec.device_static[5] == tag, kw
        assert isinstance(dec.device_state["pallas"], head_type), kw
        assert dec.kernel_variant == "xla_twin", kw
        card = dict(dec.device_state,
                    llr0=types.SimpleNamespace(is_cuda=True, dim=lambda: 1))
        assert kernel_variant(dec.device_static, card) == on_card, kw
        if head_type is not type(None):
            # a batch the head's gate refuses runs float32 min-sum
            assert kernel_variant(dec.device_static, card, 320) == "xla_twin"
            assert kernel_variant(dec.device_static, card, 512) == on_card
            bposd = ("bposd_dev", dec.device_static, 1, 1, 0, "pallas", "osd_e")
            assert kernel_variant(bposd, card, 512) == on_card
    graph = bp.build_tanner_graph_host(code.hx)
    monkeypatch.setattr(bk, "build_pallas_head",
                        lambda g, device, b=bk.build_pallas_head: b(g, "cpu"))
    monkeypatch.setenv("QLDPC_BP_KERNEL", "v1")
    assert make().device_static[5] == "none"
    assert bp_decoders._make_head("minimum_sum", graph,
                                  device="cuda")[1] == "v1"
    monkeypatch.setenv("QLDPC_BP_KERNEL", "v3")
    with pytest.raises(ValueError, match="QLDPC_BP_KERNEL"):
        make()
    with pytest.raises(ValueError, match="QLDPC_BP_KERNEL"):
        make(bp_kernel="dense")

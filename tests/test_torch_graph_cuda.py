"""The captured megabatch on the card: a CUDA-graph replay against the eager
path on the same batches.

These tests need an NVIDIA GPU (the graph's conditional nodes and the
kernels have no CPU mode) and skip without one; run them on a machine with
a card: ``python -m pytest tests/test_torch_graph_cuda.py --noconftest``.
Each engine path runs once through its captured graph (under
``torch.cuda.set_sync_debug_mode("error")``, one host read per megabatch)
and once through ``_kernels.force_eager()``; failures and minimum weight
agree exactly, and so do the kernels' launch counts, which under the graph
count only the branches that ran.
"""
import os

import numpy as np
import pytest
import torch

from qldpc_fault_tolerance_tpu_torch.codes import load_code
from qldpc_fault_tolerance_tpu_torch.decoders import (
    BP_Decoder_Class,
    BPDecoder,
    BPOSD_Decoder,
    BPOSD_Decoder_Class,
    decode_device,
)
from qldpc_fault_tolerance_tpu_torch.ops import _kernels
from qldpc_fault_tolerance_tpu_torch.ops import bp as tbp
from qldpc_fault_tolerance_tpu_torch.ops import bp_kernel as bk
from qldpc_fault_tolerance_tpu_torch.ops import gf2_kernel as gk
from qldpc_fault_tolerance_tpu_torch.ops import osd_cs_device as tcs
from qldpc_fault_tolerance_tpu_torch.ops import osd_device as tod
from qldpc_fault_tolerance_tpu_torch.parallel.shots import check_syncs
from qldpc_fault_tolerance_tpu_torch.sim import (
    CodeSimulator_DataError,
    CodeSimulator_Phenon,
)
from qldpc_fault_tolerance_tpu_torch.utils.device import device_cond, graph_capture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.cuda
KEY = (3, 20261017)
COUNTERS = [(bk.bp_minsum, "launches"), (bk.bp_head_bf16, "launches"),
            (bk.bp_head_int8, "launches"), (tod.osd_elim, "launches"),
            (tod.osd_elim, "full_launches"), (tcs.cs_sweep_rows, "launches"),
            (gk.sample_syndrome, "launches"),
            (gk.residual_check_stats, "launches"),
            (gk.fused_decode_stats, "launches"),
            (gk.fused_decode_stats, "int8_launches")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: conditional nodes and the CUDA "
                    "kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def code():
    return load_code(os.path.join(REPO, "codes_lib_tpu", "hgp_34_n625.npz"))


def _data_sim(code, dev, kind, p, batch, **kw):
    probs = np.full(code.N, 2 * p / 3)
    dec = {"bp": lambda h: BPDecoder(h, probs, 50, device=dev),
           "int8": lambda h: BPDecoder(h, probs, 50, quantize="int8",
                                       device=dev),
           "osd_e": lambda h: BPOSD_Decoder(h, probs, 50, osd_method="osd_e",
                                            osd_order=10, device=dev),
           "osd_cs": lambda h: BPOSD_Decoder(h, probs, 50,
                                             osd_method="osd_cs",
                                             osd_order=10, device=dev)}[kind]
    return CodeSimulator_DataError(
        code=code, decoder_x=dec(code.hz), decoder_z=dec(code.hx),
        pauli_error_probs=[p / 3] * 3, batch_size=batch, scan_chunk=2,
        device=dev, **kw)


def _phenom_sim(code, dev, p, batch):
    ext = [np.hstack([h, np.eye(h.shape[0], dtype=np.uint8)])
           for h in (code.hz, code.hx)]
    c1 = BP_Decoder_Class(30, "minimum_sum", 0.625, device=dev)
    c2 = BPOSD_Decoder_Class(10, "minimum_sum", 0.625, "osd_e", 10,
                             device=dev)
    d1 = [c1.GetDecoder({"h": h, "p_data": p, "p_syndrome": p}) for h in ext]
    d2 = [c2.GetDecoder({"h": h, "p_data": p}) for h in (code.hz, code.hx)]
    return CodeSimulator_Phenon(
        code=code, decoder1_x=d1[0], decoder1_z=d1[1], decoder2_x=d2[0],
        decoder2_z=d2[1], pauli_error_probs=[p / 2] * 3, q=p,
        batch_size=batch, scan_chunk=2, device=dev)


def _counts():
    _kernels.fold_launch_counts("cuda", _kernels.launch_counts("cuda").tolist())
    return [getattr(fn, attr) for fn, attr in COUNTERS]


def _run(make, run, eager: bool):
    """(failures, min weight, launch counts, host reads) of one run."""
    sim = make()
    before = _counts()
    reads = (decode_device.host_reads, tbp.bp_decode_two_phase.host_reads)
    if eager:
        with _kernels.force_eager():
            run(sim)
    else:
        with check_syncs():
            run(sim)
    grown = [b - a for a, b in zip(before, _counts())]
    read = (decode_device.host_reads - reads[0],
            tbp.bp_decode_two_phase.host_reads - reads[1])
    return (sim.last_failures, sim.min_logical_weight), grown, read, sim


CASES = {
    "bp": (lambda c, d: _data_sim(c, d, "bp", 0.03, 512), 4),
    "bposd_e": (lambda c, d: _data_sim(c, d, "osd_e", 0.05, 512), 4),
    "bposd_cs": (lambda c, d: _data_sim(c, d, "osd_cs", 0.05, 512), 4),
    "fused_v1": (lambda c, d: _data_sim(c, d, "bp", 0.03, 512,
                                        fused_sampler=True), 4),
    "fused_v2": (lambda c, d: _data_sim(c, d, "bp", 0.03, 512,
                                        fused_sampler="v2"), 4),
    "fused_v2_int8": (lambda c, d: _data_sim(c, d, "int8", 0.03, 512,
                                             fused_sampler="v2"), 4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_data_engine_graph_equals_eager(cuda, code, case):
    make, n_batches = CASES[case]

    def run(sim):
        sim.WordErrorRate(n_batches * sim.batch_size, key=KEY)

    got, counts, reads, sim = _run(lambda: make(code, cuda), run, False)
    want, eager_counts, _, _ = _run(lambda: make(code, cuda), run, True)
    assert got == want
    assert counts == eager_counts and sum(counts) > 0
    assert reads == (0, 0)
    assert sim.last_host_reads == sim.last_megabatches == n_batches // 2
    assert sim.last_graph["nodes"] > 0


def test_phenom_graph_equals_eager(cuda, code):
    def run(sim):
        sim.WordErrorRate(3, 4 * sim.batch_size, key=KEY)

    got, counts, reads, sim = _run(lambda: _phenom_sim(code, cuda, 0.02, 512),
                                   run, False)
    want, eager_counts, _, _ = _run(
        lambda: _phenom_sim(code, cuda, 0.02, 512), run, True)
    assert got == want and counts == eager_counts and reads == (0, 0)
    assert sim.last_host_reads == sim.last_megabatches == 2


def test_target_failures_stops_where_the_eager_loop_stops(cuda, code):
    def run(sim):
        sim.WordErrorRate(32 * sim.batch_size, key=KEY, target_failures=20)

    got = _run(lambda: _data_sim(code, cuda, "bp", 0.03, 256), run, False)[3]
    want = _run(lambda: _data_sim(code, cuda, "bp", 0.03, 256), run, True)[3]
    assert (got.last_failures, got.last_shots) == (want.last_failures,
                                                   want.last_shots)
    assert got.last_shots < 32 * 256


def test_graph_counts_only_the_branches_that_ran(cuda, code):
    """At p = 0 every shot converges in the head: the OSD and the
    full-batch decode never run, though the graph holds them."""
    def run(sim):
        sim.WordErrorRate(2 * sim.batch_size, key=KEY)

    _, counts, _, sim = _run(lambda: _data_sim(code, cuda, "osd_e", 0.0, 512),
                             run, False)
    named = dict(zip([f"{fn.__name__}.{a}" for fn, a in COUNTERS], counts))
    assert sim.last_failures == 0
    assert named["bp_head_bf16.launches"] > 0
    assert named["osd_elim.launches"] == named["bp_minsum.launches"] == 0


def test_nested_device_cond_replays_every_path(cuda):
    x = torch.arange(16, device=cuda, dtype=torch.float32)
    flag = torch.zeros((), dtype=torch.bool, device=cuda)
    level = torch.zeros((), dtype=torch.int32, device=cuda)

    def body():
        idx = torch.nonzero_static(x > level.float(), size=4,
                                   fill_value=16).flatten()
        ext = torch.cat([x, x.new_zeros(1)])
        ext[idx] = ext[idx] * -1.0
        return device_cond(level <= 3, lambda: (ext[:16] * 2, idx),
                           lambda: (ext[:16] * 3, idx + 1))

    def other():
        return x + 100, torch.zeros(4, dtype=torch.int64, device=cuda)

    stream = torch.cuda.Stream(cuda)
    graph = torch.cuda.CUDAGraph()
    with graph_capture(graph, cuda, stream):
        out = device_cond(flag, body, other)
    for f in (False, True):
        for lv in (2, 5):
            flag.fill_(f)
            level.fill_(lv)
            graph.replay()
            want = device_cond(flag, body, other)
            assert all(torch.equal(a, b) for a, b in zip(out, want))

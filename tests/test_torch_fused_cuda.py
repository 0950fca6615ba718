"""The fused sweep path and the weighted runs on the card: each fused
bucket replays one captured graph, its cells equal to the serial runs' and
to the same bucket run eagerly.

These tests need an NVIDIA GPU (the captured graph's conditional nodes and
the kernels have no CPU mode) and skip without one; run them on a machine
with a card: ``python -m pytest tests/test_torch_fused_cuda.py
--noconftest``.  Buckets of hgp_34_n225 at 256 shots a batch (the bf16 head
engages), BP and BPOSD-E; every replay under
``torch.cuda.set_sync_debug_mode("error")`` (``check_syncs``).
"""
import os

import numpy as np
import pytest
import torch

from qldpc_fault_tolerance_tpu_torch import rare
from qldpc_fault_tolerance_tpu_torch.codes import load_code
from qldpc_fault_tolerance_tpu_torch.decoders import (
    BP_Decoder_Class,
    BPOSD_Decoder_Class,
)
from qldpc_fault_tolerance_tpu_torch.ops import _kernels
from qldpc_fault_tolerance_tpu_torch.ops import bp_kernel as bk
from qldpc_fault_tolerance_tpu_torch.parallel.shots import check_syncs
from qldpc_fault_tolerance_tpu_torch.sim import CodeSimulator_DataError
from qldpc_fault_tolerance_tpu_torch.sim import common as simc
from qldpc_fault_tolerance_tpu_torch.sweep import CodeFamily

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.cuda
P_LIST = [0.03, 0.05, 0.07]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: conditional nodes and the CUDA "
                    "kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _code():
    return load_code(os.path.join(REPO, "codes_lib_tpu", "hgp_34_n225.npz"))


def _family(dev, osd):
    dec2 = (BPOSD_Decoder_Class(10, "minimum_sum", 0.625, "osd_e", 6,
                                device=dev) if osd
            else BP_Decoder_Class(5, "minimum_sum", 0.625, device=dev))
    return CodeFamily([_code()], BP_Decoder_Class(5, "minimum_sum", 0.625,
                                                  device=dev),
                      dec2, batch_size=256, seed=19, device=dev)


@pytest.mark.parametrize("osd", [False, True])
def test_fused_bucket_replays_one_graph_equal_to_serial_and_eager(cuda,
                                                                  osd):
    fam = _family(cuda, osd)
    bucket = [(i, 0, fam.code_list[0], p) for i, p in enumerate(P_LIST)]
    prog = fam._data_bucket_program(bucket, "Total", 256 * 8)
    head0 = bk.bp_head_bf16.launches
    with check_syncs():
        got = simc.fused_cell_finish(simc.fused_cell_launch(prog)[0])
    _kernels.fold_launch_counts(cuda, _kernels.launch_counts(cuda).tolist())
    assert bk.bp_head_bf16.launches > head0
    assert len(prog.driver._graphs) == 1 and prog.driver.host_reads == 1
    prog.release()
    with _kernels.force_eager():
        eager = simc.fused_cell_finish(simc.fused_cell_launch(
            fam._data_bucket_program(bucket, "Total", 256 * 8))[0])
    for a, b in zip(got, eager):
        np.testing.assert_array_equal(a, b)
    for i, p in enumerate(P_LIST):
        sim = fam._data_sim(fam.code_list[0], p, "Total")
        with check_syncs():
            sim.WordErrorRate(256 * 8)
        assert (sim.last_failures, sim.last_shots,
                sim.min_logical_weight) == tuple(int(x[i]) for x in got)


def test_fused_grid_equals_the_serial_grid(cuda):
    serial = _family(cuda, True).EvalWER("data", "Total", P_LIST, 256 * 4,
                                         if_plot=False, fused=False)
    with check_syncs():
        fused = _family(cuda, True).EvalWER("data", "Total", P_LIST,
                                            256 * 4, if_plot=False)
    np.testing.assert_array_equal(fused, serial)


def test_adaptive_plan_replays_the_same_graph(cuda):
    fam = _family(cuda, False)
    # the p = 0.08 cell reaches its target in the first megabatch, the
    # p = 0.003 cell (a few failures a megabatch) takes its lane for the
    # rest of its budget
    bucket = [(i, 0, fam.code_list[0], p) for i, p in enumerate(
        [0.003, 0.08])]
    prog = fam._data_bucket_program(bucket, "Total", 256 * 32)
    with check_syncs():
        failures, shots, _ = simc.fused_cell_adaptive(
            prog, target_failures=40)[:3]
    assert len(prog.driver._graphs) == 1
    assert prog.driver.host_reads == prog.driver.megabatches
    assert prog.reallocated_batches > 0
    for i, p in enumerate([0.003, 0.08]):
        sim = fam._data_sim(fam.code_list[0], p, "Total")
        sim.WordErrorRate(int(shots[i]), key=prog.key)
        assert (sim.last_failures, sim.last_shots) == (failures[i], shots[i])


def test_weighted_zero_tilt_and_fused_rungs(cuda):
    fam = _family(cuda, False)
    code = fam.code_list[0]
    sim = fam._data_sim(code, 0.05, "Total")
    with check_syncs():
        sim.WeightedWordErrorRate(256 * 8, key=(5, 6))
    ws = sim.last_weighted
    with check_syncs():
        sim.WordErrorRate(256 * 8, key=(5, 6))
    assert (ws.failures, ws.shots) == (sim.last_failures, sim.last_shots)
    assert ws.s1 == ws.failures and ws.w1 == ws.shots
    cls = BP_Decoder_Class(5, "minimum_sum", 0.625, device=cuda)
    with check_syncs():
        points = rare.eval_rare_grid(code, cls, [0.01, 0.02], 256 * 8,
                                     q_total=[0.03, 0.05], batch_size=256,
                                     seed=3, device=cuda)
    for p, q, pt in zip([0.01, 0.02], [0.03, 0.05], points):
        serial = CodeSimulator_DataError(
            code=code, decoder_x=cls.GetDecoder({"h": code.hz, "p_data": p}),
            decoder_z=cls.GetDecoder({"h": code.hx, "p_data": p}),
            pauli_error_probs=[p / 2] * 3, batch_size=256, seed=3,
            device=cuda)
        serial.WeightedWordErrorRate(
            256 * 8, tilt_probs=rare.tilt_channel(serial.channel_probs, q))
        a, b = serial.last_weighted, pt["stats"]
        assert (a.failures, a.shots) == (b.failures, b.shots)
        np.testing.assert_allclose([b.s1, b.s2, b.w1, b.w2],
                                   [a.s1, a.s2, a.w1, a.w2], rtol=1e-6)

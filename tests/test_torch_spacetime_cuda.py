"""The phenomenological space-time engine and the circuit-level engine on
the card: one captured megabatch against the eager path, and the card's
Pauli-frame sampler against the CPU's.

These tests need an NVIDIA GPU (conditional nodes and the CUDA kernels have
no CPU mode) and skip without one; run them on a machine with a card:
``python -m pytest tests/test_torch_spacetime_cuda.py --noconftest``.
Each engine runs one megabatch through its captured graph (under
``torch.cuda.set_sync_debug_mode("error")``: one host read per megabatch,
no tier read) and once through ``_kernels.force_eager()``; failures, min
weight and the kernels' launch counts agree exactly.  The card's
``FrameSampler`` fed the CPU's uniforms gives the CPU sampler's detectors
and observables bit for bit.
"""
import os

import numpy as np
import pytest
import torch

from qldpc_fault_tolerance_tpu_torch.circuits import FrameSampler
from qldpc_fault_tolerance_tpu_torch.codes import load_code
from qldpc_fault_tolerance_tpu_torch.decoders import (
    BP_Decoder_Class,
    BPOSD_Decoder_Class,
    ST_BP_Decoder_Class,
    decode_device,
)
from qldpc_fault_tolerance_tpu_torch.ops import _kernels
from qldpc_fault_tolerance_tpu_torch.ops import bp as tbp
from qldpc_fault_tolerance_tpu_torch.ops import bp_kernel as bk
from qldpc_fault_tolerance_tpu_torch.ops import osd_device as tod
from qldpc_fault_tolerance_tpu_torch.parallel.shots import check_syncs
from qldpc_fault_tolerance_tpu_torch.sim import (
    CodeSimulator_Circuit,
    CodeSimulator_Phenon_SpaceTime,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CODE = os.path.join(REPO, "codes_lib_tpu", "hgp_34_n225.npz")
pytestmark = pytest.mark.cuda
KEY = (5, 20261017)
COUNTERS = [(bk.bp_minsum, "launches"), (bk.bp_head_bf16, "launches"),
            (tod.osd_elim, "launches")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: conditional nodes and the CUDA "
                    "kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _ext(h):
    return np.hstack([h, np.eye(h.shape[0], dtype=np.uint8)])


def _st_sim(dev, eval_p=0.01, num_rep=3, batch=512):
    code = load_code(CODE)
    c1 = ST_BP_Decoder_Class(30, "minimum_sum", 0.625, device=dev)
    c2 = BPOSD_Decoder_Class(10, "minimum_sum", 0.625, "osd_e", 10,
                             device=dev)
    d1 = [c1.GetDecoder({"h": h, "p_data": eval_p, "p_syndrome": eval_p,
                         "num_rep": num_rep}) for h in (code.hz, code.hx)]
    d2 = [c2.GetDecoder({"h": h, "p_data": eval_p})
          for h in (code.hz, code.hx)]
    return CodeSimulator_Phenon_SpaceTime(
        code=code, decoder1_x=d1[0], decoder1_z=d1[1], decoder2_x=d2[0],
        decoder2_z=d2[1], pauli_error_probs=[eval_p / 2] * 3, q=eval_p,
        num_rep=num_rep, batch_size=batch, scan_chunk=2, device=dev)


def _circuit_sim(dev, p=0.004, batch=512):
    code = load_code(CODE)
    d1 = BP_Decoder_Class(30, "minimum_sum", 0.625, device=dev).GetDecoder(
        {"h": _ext(code.hx), "p_data": p, "p_syndrome": p})
    d2 = BPOSD_Decoder_Class(10, "minimum_sum", 0.625, "osd_e", 10,
                             device=dev).GetDecoder({"h": code.hx,
                                                     "p_data": p})
    return CodeSimulator_Circuit(
        code=code, decoder1_z=d1, decoder2_z=d2, p=p, num_cycles=4,
        error_params={"p_i": 0, "p_state_p": 0, "p_m": 0, "p_CX": p,
                      "p_idling_gate": 0},
        batch_size=batch, scan_chunk=2, device=dev)


def _counts():
    _kernels.fold_launch_counts("cuda", _kernels.launch_counts("cuda").tolist())
    return [getattr(fn, attr) for fn, attr in COUNTERS]


def _run(make, run, eager: bool):
    """(failures, min weight), launch counts, tier reads and the simulator
    of one run."""
    sim = make()
    before = _counts()
    reads = (decode_device.host_reads, tbp.bp_decode_two_phase.host_reads)
    with (_kernels.force_eager() if eager else check_syncs()):
        run(sim)
    grown = [b - a for a, b in zip(before, _counts())]
    read = (decode_device.host_reads - reads[0],
            tbp.bp_decode_two_phase.host_reads - reads[1])
    return (sim.last_failures, sim.min_logical_weight), grown, read, sim


CASES = {
    "phenom_spacetime": (_st_sim, lambda s: s.WordErrorRate(
        7, 2 * s.batch_size, key=KEY)),
    "circuit": (_circuit_sim, lambda s: s.WordErrorRate(2 * s.batch_size,
                                                        key=KEY)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_graph_equals_eager(cuda, case):
    make, run = CASES[case]
    got, counts, reads, sim = _run(lambda: make(cuda), run, False)
    want, eager_counts, _, _ = _run(lambda: make(cuda), run, True)
    assert got == want and got[0] > 0
    assert counts == eager_counts and counts[2] > 0 and sum(counts[:2]) > 0
    assert reads == (0, 0)
    assert sim.last_host_reads == sim.last_megabatches == 1
    assert sim.last_graph["nodes"] > 0


def test_zero_noise_on_the_card(cuda):
    st, circ = _st_sim(cuda, eval_p=0.0), _circuit_sim(cuda, p=0.0)
    with check_syncs():
        st.WordErrorRate(7, 2 * st.batch_size, key=KEY)
        circ.WordErrorRate(2 * circ.batch_size, key=KEY)
    assert (st.last_failures, circ.last_failures) == (0, 0)


def test_card_sampler_equals_cpu_sampler_on_fed_uniforms(cuda):
    sim = _circuit_sim(cuda, p=0.01)
    sim._generate_circuit()
    planes = {}
    gen = torch.Generator().manual_seed(11)

    def cpu_uniform(si, it, nid, shape):
        planes[si, it, nid] = torch.rand(shape, generator=gen)
        return planes[si, it, nid]

    want = FrameSampler(sim.circuit, device="cpu").sample_with(cpu_uniform,
                                                               300)
    got = sim._sampler.sample_with(
        lambda si, it, nid, shape: planes[si, it, nid].to(cuda), 300)
    assert got[0].is_cuda and len(planes) > 10
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    assert 0 < int(want[0].sum())

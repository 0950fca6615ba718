"""The shot mesh on the card: mesh runs equal their one-device replays.

These tests need an NVIDIA GPU and skip without one; the two-card tests
skip on a machine with one card.  Run them on a machine with a card:
``python -m pytest tests/test_torch_mesh_cuda.py --noconftest``.

  * A 2-entry mesh on ``cuda:0`` (two replicas, two captured graphs on one
    card) equals its ``degrade_mesh()`` replay bit for bit in failures and
    min weight: the data engine through the bf16 head, the phenom and the
    circuit engines, and a fused data bucket; every replay under
    ``check_syncs``.
  * On two cards or more: ``shot_mesh()`` over every card equals its
    replay on card 0, and a replica's decode on ``cuda:1`` launches
    nothing on ``cuda:0``'s stream (its kernels are guarded to their
    tensors' device).
"""
import os

import numpy as np
import pytest
import torch

from qldpc_fault_tolerance_tpu_torch.codes import load_code
from qldpc_fault_tolerance_tpu_torch.decoders import BPDecoder, decode_device
from qldpc_fault_tolerance_tpu_torch.parallel.shots import (
    check_syncs,
    shot_mesh,
)
from qldpc_fault_tolerance_tpu_torch.sim import (
    CodeSimulator_Circuit,
    CodeSimulator_DataError,
    CodeSimulator_Phenon,
)
from qldpc_fault_tolerance_tpu_torch.sim.common import replicate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.cuda
P = 0.03


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: conditional nodes and the CUDA "
                    "kernels have no CPU mode")


@pytest.fixture
def two_cards(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")


def _code():
    return load_code(os.path.join(REPO, "codes_lib_tpu", "hgp_34_n225.npz"))


def _data(code, mesh):
    def dec(h):
        return BPDecoder(h, np.full(code.N, P), 50, device="cuda")
    return CodeSimulator_DataError(
        code=code, decoder_x=dec(code.hz), decoder_z=dec(code.hx),
        pauli_error_probs=[P / 2] * 3, batch_size=256, scan_chunk=4,
        seed=3, device="cuda", mesh=mesh)


def _phenom(code, mesh):
    m = code.hx.shape[0]

    def ext(h):
        return np.hstack([h, np.eye(m, dtype=np.uint8)])

    pr = np.full(code.N + m, P)
    return CodeSimulator_Phenon(
        code=code, decoder1_x=BPDecoder(ext(code.hz), pr, 20, device="cuda"),
        decoder1_z=BPDecoder(ext(code.hx), pr, 20, device="cuda"),
        decoder2_x=BPDecoder(code.hz, np.full(code.N, P), 20, device="cuda"),
        decoder2_z=BPDecoder(code.hx, np.full(code.N, P), 20, device="cuda"),
        pauli_error_probs=[P / 3] * 3, q=P, batch_size=256, scan_chunk=2,
        device="cuda", mesh=mesh)


def _circuit(code, mesh):
    m = code.hx.shape[0]
    ext = np.hstack([code.hx, np.eye(m, dtype=np.uint8)])
    ep = {"p_i": 0, "p_state_p": 0, "p_m": 0, "p_CX": 0.002,
          "p_idling_gate": 0}
    sim = CodeSimulator_Circuit(
        code=code, decoder1_z=BPDecoder(ext, np.full(code.N + m, 0.004), 20,
                                        device="cuda"),
        decoder2_z=BPDecoder(code.hx, np.full(code.N, 0.004), 20,
                             device="cuda"),
        p=0.002, num_cycles=3, error_params=ep, batch_size=256, scan_chunk=2,
        device="cuda", mesh=mesh)
    sim._generate_circuit()
    return sim


ENGINES = {"data": (_data, ()), "phenom": (_phenom, (3,)),
           "circuit": (_circuit, ())}


def _mesh_and_replay(engine, mesh, shots):
    build, args = ENGINES[engine]
    code = _code()
    sim = build(code, mesh)
    with check_syncs():
        sim.WordErrorRate(*args, shots, key=(0, 5))
    replay = build(code, mesh)
    replay.degrade_mesh()
    with check_syncs():
        replay.WordErrorRate(*args, shots, key=(0, 5))
    return sim, replay


@pytest.mark.parametrize("engine", list(ENGINES))
def test_two_entry_mesh_on_one_card_equals_its_replay(cuda, engine):
    mesh = shot_mesh(["cuda:0", "cuda:0"])
    sim, replay = _mesh_and_replay(engine, mesh, 4 * 256 * 2)
    assert (sim.last_failures, sim.last_shots, sim.min_logical_weight) == (
        replay.last_failures, replay.last_shots, replay.min_logical_weight)
    assert sim.last_shots == 4 * 256 * 2
    assert [r["host_reads"] for r in sim.last_mesh] == [
        sim.last_megabatches] * 2
    assert all(r["graph"] is not None for r in sim.last_mesh)
    if engine == "data":
        assert sim.last_failures > 0


def test_fused_bucket_on_a_two_entry_mesh_equals_its_replay(cuda):
    from qldpc_fault_tolerance_tpu_torch.sim import common as simc

    code = _code()
    mesh = shot_mesh(["cuda:0", "cuda:0"])

    def prog():
        sims = [_data(code, None) for _ in range(2)]
        sims[1] = CodeSimulator_DataError(
            code=code, decoder_x=sims[0].decoder_x,
            decoder_z=sims[0].decoder_z, pauli_error_probs=[0.02] * 3,
            batch_size=256, scan_chunk=4, seed=3, device="cuda")
        return CodeSimulator_DataError.fused_cells_program(sims, 4096,
                                                           mesh=mesh)

    a, b = prog(), prog()
    b.driver.degrade_mesh()
    with check_syncs():
        want = simc.fused_cell_finish(simc.fused_cell_launch(a)[0])
        got = simc.fused_cell_finish(simc.fused_cell_launch(b)[0])
    for w, g in zip(want, got):
        assert np.array_equal(w, g)
    assert (want[1] == a.n_batches * 256 * 2).all()
    assert len(a.driver._graphs) == 2 and len(b.driver._graphs) == 1


def test_mesh_over_every_card_equals_its_replay(two_cards):
    mesh = shot_mesh()
    sim, replay = _mesh_and_replay("data", mesh, 4 * 256 * mesh.size)
    assert (sim.last_failures, sim.min_logical_weight) == (
        replay.last_failures, replay.min_logical_weight)
    assert [r["device"] for r in sim.last_mesh] == [
        str(d) for d in mesh.devices]


def test_a_replica_on_card_one_leaves_card_zero_idle(two_cards):
    code = _code()
    dec = BPDecoder(code.hx, np.full(code.N, P), 50, device="cuda:0")
    rep = replicate(dec, "cuda:1")
    assert rep is not dec and rep.llr0.device == torch.device("cuda:1")
    assert dec.llr0.device == torch.device("cuda:0")
    gen = torch.Generator(device="cuda:1")
    gen.manual_seed(1)
    synd = (torch.rand((256, code.hx.shape[0]), generator=gen,
                       device="cuda:1") < 0.05).to(torch.uint8)
    want, _ = decode_device(dec.device_static, dec.device_state,
                            synd.to("cuda:0"))
    torch.cuda.synchronize(0)
    with torch.cuda.device(0):
        torch.cuda._sleep(2_000_000_000)  # about a second on card 0
        got, _ = decode_device(rep.device_static, rep.device_state, synd)
        torch.cuda.synchronize(1)
        # card 0 still sleeps: nothing of the decode waited behind it
        assert not torch.cuda.current_stream(0).query()
    assert torch.equal(got.cpu(), want.cpu())
    torch.cuda.synchronize(0)

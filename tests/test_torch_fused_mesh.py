"""The fused sweep path and the sweeps on a shot mesh, on the CPU.

  * A fused bucket on a logical mesh of 8 (``["cpu"] * 8``) runs every
    lane-batch on every device: its shots scale by the mesh size (JAX
    ``tests/test_fused_sweep.py`` ``test_fused_mesh_shards_shot_axis``).
  * A fused bucket's counts and min weights on a mesh of 2 equal its
    ``degrade_mesh()`` replay (every slot's keys in turn on one device),
    data, phenl and the weighted rungs (their float moments to float32
    rounding: the replay sums them in another order); each fused mesh cell
    equals its engine's serial mesh run seed for seed, fixed budget,
    streamed and adaptive.
  * ``CodeFamily(mesh=)`` and ``CodeFamily_SpaceTime(mesh=)`` grids give
    the same cells serial and ``fused="auto"``; ``eval_rare_grid(mesh=)``
    runs, and the estimators refuse a mesh engine.
Small codes: hgp(rep_code(3), rep_code(3)), batches of 64.
"""
import numpy as np
import pytest
import torch

from qldpc_fault_tolerance_tpu_torch import decoders as tdec
from qldpc_fault_tolerance_tpu_torch import sweep as tsweep
from qldpc_fault_tolerance_tpu_torch.codes import hgp, rep_code
from qldpc_fault_tolerance_tpu_torch.parallel import (
    MeshCellFusedDriver,
    shot_mesh,
)
from qldpc_fault_tolerance_tpu_torch.rare import eval_rare_grid, tilted_wer
from qldpc_fault_tolerance_tpu_torch.sim import (
    CodeSimulator_DataError,
    CodeSimulator_Phenon,
)
from qldpc_fault_tolerance_tpu_torch.sim import common as simc
from qldpc_fault_tolerance_tpu_torch.utils import telemetry

torch.set_num_threads(1)

CODE = hgp(rep_code(3), rep_code(3))
MESH2 = shot_mesh(["cpu"] * 2)
PS = (0.03, 0.08)


def _data(p, mesh=None, seed=0):
    def dec(h):
        return tdec.BPDecoder(h, np.full(CODE.N, p), 6, device="cpu")
    return CodeSimulator_DataError(
        code=CODE, decoder_x=dec(CODE.hz), decoder_z=dec(CODE.hx),
        pauli_error_probs=[p / 2] * 3, batch_size=64, seed=seed,
        scan_chunk=2, device="cpu", mesh=mesh)


def _phenl(p, mesh=None):
    m = CODE.hx.shape[0]

    def ext(h):
        return np.hstack([h, np.eye(m, dtype=np.uint8)])

    pr = np.full(CODE.N + m, p)
    return CodeSimulator_Phenon(
        code=CODE, decoder1_x=tdec.BPDecoder(ext(CODE.hz), pr, 5,
                                             device="cpu"),
        decoder1_z=tdec.BPDecoder(ext(CODE.hx), pr, 5, device="cpu"),
        decoder2_x=tdec.BPDecoder(CODE.hz, np.full(CODE.N, p), 5,
                                  device="cpu"),
        decoder2_z=tdec.BPDecoder(CODE.hx, np.full(CODE.N, p), 5,
                                  device="cpu"),
        pauli_error_probs=[p / 3] * 3, q=p, batch_size=64, scan_chunk=2,
        device="cpu", mesh=mesh)


def _run(prog):
    return simc.fused_cell_finish(simc.fused_cell_launch(prog)[0])


def test_fused_mesh_shards_shot_axis():
    mesh = shot_mesh(["cpu"] * 8)
    prog = CodeSimulator_DataError.fused_cells_program(
        [_data(p) for p in PS], 128, mesh=mesh)
    assert isinstance(prog.driver, MeshCellFusedDriver)
    f, sh, _ = _run(prog)
    # every lane-batch runs on all devices: shots scale by the mesh size
    assert (sh == prog.n_batches * 64 * mesh.size).all()
    assert (f >= 0).all() and (f <= sh).all()
    assert prog.driver.host_reads == mesh.size


def _programs(kind, weighted=False):
    if kind == "phenl":
        make = (lambda: CodeSimulator_Phenon.fused_cells_program(
            [_phenl(p) for p in PS], 512, 3, mesh=MESH2))
    elif weighted:
        make = (lambda: CodeSimulator_DataError.weighted_cells_program(
            [_data(p) for p in PS], [[0.03] * 3, [0.05] * 3], 512,
            mesh=MESH2))
    else:
        make = (lambda: CodeSimulator_DataError.fused_cells_program(
            [_data(p) for p in PS], 512, mesh=MESH2))
    return make(), make()


@pytest.mark.parametrize("kind,weighted", [("data", False),
                                           ("phenl", False),
                                           ("data", True)],
                         ids=["data", "phenl", "weighted"])
def test_fused_mesh_counts_equal_their_degraded_replay(kind, weighted):
    mesh_prog, replay_prog = _programs(kind, weighted)
    telemetry.reset()
    telemetry.enable()
    try:
        replay_prog.driver.degrade_mesh()
        replay_prog.driver.degrade_mesh()  # idempotent
        snap = telemetry.snapshot()
    finally:
        telemetry.disable()
    assert snap["mesh.replans"]["value"] == 1
    assert len(replay_prog.driver.subs) == 1
    assert replay_prog.driver.subs[0].slots == (0, 1)
    if weighted:
        want = simc.fused_cell_stream(mesh_prog)
        got = simc.fused_cell_stream(replay_prog)
    else:
        want, got = _run(mesh_prog), _run(replay_prog)
    for w, g in zip(want[:3], got[:3]):
        assert np.array_equal(w, g)
    assert (want[1] == mesh_prog.n_batches * 64 * 2).all()
    assert want[0].sum() > 0
    for w, g in zip(want[3:], got[3:]):  # weighted moments
        np.testing.assert_allclose(g, w, rtol=2e-6)


def test_fused_mesh_cells_equal_serial_mesh_runs():
    """Fixed budget, streamed (one read a megabatch) and adaptive."""
    prog = CodeSimulator_DataError.fused_cells_program(
        [_data(p) for p in PS], 512, mesh=MESH2)
    fixed = _run(prog)
    streamed = simc.fused_cell_stream(
        CodeSimulator_DataError.fused_cells_program(
            [_data(p) for p in PS], 512, mesh=MESH2))
    for c, p in enumerate(PS):
        sim = _data(p, mesh=MESH2)
        sim.WordErrorRate(512)
        assert (fixed[0][c], fixed[1][c], fixed[2][c]) == (
            sim.last_failures, sim.last_shots, sim.min_logical_weight)
        assert (streamed[0][c], streamed[1][c]) == (fixed[0][c],
                                                    fixed[1][c])
    adaptive = simc.fused_cell_adaptive(
        CodeSimulator_DataError.fused_cells_program(
            [_data(p) for p in PS], 2048, mesh=MESH2), target_failures=5)
    assert (adaptive[0] >= 5).all() and (adaptive[1] % 128 == 0).all()
    assert (adaptive[1] <= 2048).all()


def _family(cls, mesh, codes=(CODE,)):
    kw = dict(batch_size=64, seed=2, device="cpu", mesh=mesh)
    if cls is tsweep.CodeFamily_SpaceTime:
        dec1 = tdec.ST_BP_Decoder_Class(10, "minimum_sum", 0.625,
                                        device="cpu")
    else:
        dec1 = tdec.BP_Decoder_Class(4, "minimum_sum", 0.625, device="cpu")
    return cls(list(codes), dec1,
               tdec.BP_Decoder_Class(4, "minimum_sum", 0.625, device="cpu"),
               **kw)


@pytest.mark.parametrize("noise", ["data", "phenl"])
def test_code_family_grid_on_a_mesh_serial_equals_fused(noise):
    kw = dict(if_plot=False, num_cycles=2)
    serial = _family(tsweep.CodeFamily, MESH2).EvalWER(
        noise, "Total", list(PS), 256, fused=False, **kw)
    fused = _family(tsweep.CodeFamily, MESH2).EvalWER(
        noise, "Total", list(PS), 256, **kw)
    np.testing.assert_array_equal(serial, fused)
    assert (serial > 0).all()


def test_code_family_spacetime_grid_on_a_mesh_serial_equals_fused():
    fam = _family(tsweep.CodeFamily_SpaceTime, MESH2)
    serial, _ = fam.EvalWER("data", "Total", list(PS), 256,
                            if_plot=False, fused=False)
    fused, _ = _family(tsweep.CodeFamily_SpaceTime, MESH2).EvalWER(
        "data", "Total", list(PS), 256, if_plot=False)
    np.testing.assert_array_equal(serial[0], fused[0])


def test_rare_grid_runs_on_a_mesh_and_estimators_refuse_it():
    pts = eval_rare_grid(
        CODE, tdec.BP_Decoder_Class(6, "minimum_sum", 0.625, device="cpu"),
        [0.04, 0.02], 256, q_total=0.1, batch_size=64, device="cpu",
        mesh=MESH2)
    assert [pt["stats"].shots for pt in pts] == [256, 256]
    assert all(pt["stats"].failures > 0 for pt in pts)
    with pytest.raises(ValueError, match="no mesh"):
        tilted_wer(_data(0.03, mesh=MESH2), 128, q_total=0.1)

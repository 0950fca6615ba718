"""The port's cell-fused sweep path (``sweep/fused.py``, the engines'
``fused_cells_program`` and ``parallel.shots.CellFusedDriver``) on the CPU.

  * Port against port, exact: a fused cell equals its serial cell seed for
    seed (failures, shots and min weight): data packed and dense with mixed
    logical types in one bucket, phenl, a BPOSD-E bucket, the space-time
    data branch; adaptive reallocation counts each cell's serial batches
    and counts the batches it reallocated; a fused bucket killed mid-run
    resumes to the unbroken grid, and fused and serial checkpoint cells
    interchange; an unfusable bucket runs serially and is counted.
  * Port against the JAX package (same numpy inputs): ``plan_lanes``
    outputs identical; ``GetDecoderState`` the full build's state; the
    fused grids within 4 binomial sigma of the JAX package's fused grids
    (the PRNG streams differ).
Small codes: hgp(rep_code(3), rep_code(3)) and hgp(ring_code(3),
ring_code(3)), batches of 64-128.
"""
import numpy as np
import pytest
import torch

from qldpc_fault_tolerance_tpu import codes as jcodes
from qldpc_fault_tolerance_tpu import decoders as jdec
from qldpc_fault_tolerance_tpu import sweep as jsweep
from qldpc_fault_tolerance_tpu.sim import common as jsimc
from qldpc_fault_tolerance_tpu_torch import decoders as tdec
from qldpc_fault_tolerance_tpu_torch import sweep as tsweep
from qldpc_fault_tolerance_tpu_torch.codes import hgp, rep_code, ring_code
from qldpc_fault_tolerance_tpu_torch.parallel.shots import (
    cell_fused_driver,
    shot_mesh,
)
from qldpc_fault_tolerance_tpu_torch.sim import (
    CodeSimulator_DataError,
    CodeSimulator_Phenon,
)
from qldpc_fault_tolerance_tpu_torch.sim import common as simc
from qldpc_fault_tolerance_tpu_torch.sweep.fused import eval_cells_fused
from qldpc_fault_tolerance_tpu_torch.utils import checkpoint as tckpt
from qldpc_fault_tolerance_tpu_torch.utils import diagnostics, telemetry

torch.set_num_threads(1)

CODES = [hgp(rep_code(3), rep_code(3)), hgp(ring_code(3), ring_code(3))]


def _family(codes, seed=1, batch=64, osd=False, st=False):
    kw = dict(batch_size=batch, seed=seed, device="cpu")
    dec2 = (tdec.BPOSD_Decoder_Class(5, "minimum_sum", 0.625, "osd_e", 4,
                                     device="cpu") if osd
            else tdec.BP_Decoder_Class(3, "minimum_sum", 0.625,
                                       device="cpu"))
    if st:
        return tsweep.CodeFamily_SpaceTime(
            codes, tdec.ST_BP_Decoder_Class(10, "minimum_sum", 0.625,
                                            device="cpu"), dec2, **kw)
    return tsweep.CodeFamily(
        codes, tdec.BP_Decoder_Class(4, "minimum_sum", 0.625, device="cpu"),
        dec2, **kw)


def _data_sim(p, lt="Total", packed=True, osd=False, seed=0):
    code = CODES[0]
    if osd:
        def dec(h):
            return tdec.BPOSD_Decoder(h, np.full(code.N, p), 6,
                                      osd_method="osd_e", osd_order=4,
                                      device="cpu")
    else:
        def dec(h):
            return tdec.BPDecoder(h, np.full(code.N, p), 6, device="cpu")
    return CodeSimulator_DataError(
        code=code, decoder_x=dec(code.hz), decoder_z=dec(code.hx),
        pauli_error_probs=[p / 2] * 3, eval_logical_type=lt, batch_size=64,
        seed=seed, scan_chunk=2, packed=packed, device="cpu")


def _serial(sim, shots, key=None):
    sim.WordErrorRate(shots, key=key)
    return sim.last_failures, sim.last_shots, sim.min_logical_weight


# ------------------------------------------------------- fused == serial

@pytest.mark.parametrize("osd", [False, True])
@pytest.mark.parametrize("packed", [True, False])
def test_fused_program_cells_equal_serial_cells(packed, osd):
    """One bucket of three p and three logical types (packed or dense, BP
    or BPOSD-E): every cell's (failures, shots, min weight) is its serial
    run's, seed for seed."""
    cells = [(0.03, "X"), (0.06, "Z"), (0.09, "Total")]
    prog = CodeSimulator_DataError.fused_cells_program(
        [_data_sim(p, lt, packed, osd) for p, lt in cells], 384)
    pending, n_run = simc.fused_cell_launch(prog)
    failures, shots, min_w = simc.fused_cell_finish(pending)
    assert n_run == 6 and list(shots) == [384] * 3
    for i, (p, lt) in enumerate(cells):
        assert _serial(_data_sim(p, lt, packed, osd), 384) == (
            failures[i], shots[i], min_w[i])
    assert failures.sum() > 0


@pytest.mark.parametrize("noise", ["data", "phenl"])
def test_fused_grid_equals_serial_grid(noise):
    kw = dict(num_cycles=3) if noise == "phenl" else {}
    serial = _family(CODES).EvalWER(noise, "Total", [0.02, 0.05, 0.08], 256,
                                    if_plot=False, fused=False, **kw)
    telemetry.reset()
    telemetry.enable()
    try:
        fused = _family(CODES).EvalWER(noise, "Total", [0.02, 0.05, 0.08],
                                       256, if_plot=False, **kw)
        snap = telemetry.snapshot()
    finally:
        telemetry.disable()
    np.testing.assert_array_equal(fused, serial)
    assert snap["sweep.fused_cells"]["value"] == 6
    assert snap["sweep.fused_buckets"]["value"] == 2
    assert "sweep.fused_fallback_cells" not in snap
    runs = eval_cells_fused.buckets
    assert [r["cells"] for r in runs] == [3, 3]
    assert all(r["megabatches"] == 1 and r["host_reads"] == 1
               for r in runs)


def test_phenl_program_mixed_types_equal_serial():
    code = CODES[0]

    def sim(p, lt):
        d1 = [tdec.BPDecoder(np.hstack([h, np.eye(h.shape[0],
                                                   dtype=np.uint8)]),
                             np.full(h.shape[0] + code.N, p), 4,
                             device="cpu") for h in (code.hz, code.hx)]
        d2 = [tdec.BPDecoder(h, np.full(code.N, p), 6, device="cpu")
              for h in (code.hz, code.hx)]
        return CodeSimulator_Phenon(
            code=code, decoder1_x=d1[0], decoder1_z=d1[1], decoder2_x=d2[0],
            decoder2_z=d2[1], pauli_error_probs=[p / 3] * 3, q=p,
            eval_logical_type=lt, batch_size=64, seed=3, scan_chunk=2,
            device="cpu")

    cells = [(0.02, "X"), (0.04, "Total")]
    prog = CodeSimulator_Phenon.fused_cells_program(
        [sim(p, lt) for p, lt in cells], 256, 3)
    failures, shots, min_w = simc.fused_cell_finish(
        simc.fused_cell_launch(prog)[0])
    for i, (p, lt) in enumerate(cells):
        s = sim(p, lt)
        s.WordErrorRate(3, 256)
        assert (s.last_failures, s.last_shots, s.min_logical_weight) == (
            failures[i], shots[i], min_w[i])


def test_bposd_bucket_fuses_and_equals_serial():
    serial = _family(CODES[:1], osd=True).EvalWER(
        "data", "Total", [0.06, 0.1], 256, if_plot=False, fused=False)
    telemetry.reset()
    telemetry.enable()
    try:
        fused = _family(CODES[:1], osd=True).EvalWER(
            "data", "Total", [0.06, 0.1], 256, if_plot=False)
        snap = telemetry.snapshot()
    finally:
        telemetry.disable()
    np.testing.assert_array_equal(fused, serial)
    assert snap.get("sweep.fused_fallback_cells", {}).get("value", 0) == 0
    assert snap["sweep.fused_cells"]["value"] == 2


def test_spacetime_data_branch_fuses_and_equals_serial():
    serial = _family(CODES[:1], osd=True, st=True).EvalWER(
        "data", "Total", [0.03, 0.06], 256, if_plot=False, fused=False)
    telemetry.reset()
    telemetry.enable()
    try:
        fused = _family(CODES[:1], osd=True, st=True).EvalWER(
            "data", "Total", [0.03, 0.06], 256, if_plot=False)
        snap = telemetry.snapshot()
    finally:
        telemetry.disable()
    np.testing.assert_array_equal(fused[0][0], serial[0][0])
    assert snap["sweep.fused_cells"]["value"] == 2


# ----------------------------------------------- adaptive reallocation

def test_adaptive_reallocation_counts_serial_batches_and_reallocates():
    """Cells stop at their target; the converged cell's lane serves the
    other, and every cell's failures over the shots it ran are a serial
    run's over the same shots (same key)."""
    prog = CodeSimulator_DataError.fused_cells_program(
        [_data_sim(0.02), _data_sim(0.12)], 64 * 40)
    telemetry.reset()
    telemetry.enable()
    try:
        failures, shots, min_w = simc.fused_cell_adaptive(
            prog, target_failures=15)[:3]
        snap = telemetry.snapshot()
    finally:
        telemetry.disable()
    assert prog.reallocated_batches > 0
    assert snap["sweep.reallocated_shots"]["value"] == \
        prog.reallocated_batches * 64
    assert snap["driver.early_stops"]["value"] >= 1
    for i, p in enumerate((0.02, 0.12)):
        assert failures[i] >= 15
        sim = _data_sim(p)
        sim.WordErrorRate(int(shots[i]), key=prog.key)
        assert (sim.last_failures, sim.last_shots) == (failures[i], shots[i])


def test_eval_wer_target_failures_runs_the_adaptive_bucket():
    wer = _family(CODES).EvalWER("data", "Total", [0.02, 0.08], 64 * 32,
                                 if_plot=False, target_failures=10)
    assert wer.shape == (2, 2) and (wer > 0).all()
    runs = eval_cells_fused.buckets
    assert all(r["host_reads"] == r["megabatches"] for r in runs)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_lanes_equals_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        n_cells = int(rng.integers(1, 9))
        k = int(rng.integers(1, 5))
        budget = k * int(rng.integers(1, 12))
        cursors = k * rng.integers(0, budget // k + 1, n_cells)
        undecided = [c for c in range(n_cells)
                     if cursors[c] < budget and rng.random() < 0.7]
        want = jsimc.plan_lanes(cursors, undecided, n_cells, k, budget)
        got = simc.plan_lanes(cursors, undecided, n_cells, k, budget)
        for a, b in zip(want[:5], got[:5]):
            np.testing.assert_array_equal(a, b)
        assert want[5] == got[5]


# ------------------------------------------------------ resume / records

class _Killed(Exception):
    pass


def test_fused_bucket_killed_mid_run_resumes_to_the_unbroken_grid(
        tmp_path, monkeypatch):
    p_list = [0.05, 0.08]
    samples = 64 * 8 * 4  # 4 megabatches of 8 batches a cell
    fam_kw = dict(batch=64)
    clean = _family(CODES[:1], **fam_kw).EvalWER(
        "data", "Total", p_list, samples, if_plot=False)
    path = str(tmp_path / "sweep.jsonl")
    real = tckpt.CellProgress.save_cells
    saves = []

    def dying(self, *a, **k):
        real(self, *a, **k)
        saves.append(k.get("batches_done"))
        if len(saves) == 2:
            raise _Killed

    monkeypatch.setattr(tckpt.CellProgress, "save_cells", dying)
    with pytest.raises(_Killed):
        _family(CODES[:1], **fam_kw).EvalWER(
            "data", "Total", p_list, samples, if_plot=False,
            checkpoint=tckpt.SweepCheckpoint(path))
    monkeypatch.setattr(tckpt.CellProgress, "save_cells", real)
    ck = tckpt.SweepCheckpoint(path)
    assert len(ck) == 0  # the kill landed inside the bucket
    resumed = _family(CODES[:1], **fam_kw).EvalWER(
        "data", "Total", p_list, samples, if_plot=False, checkpoint=ck)
    np.testing.assert_array_equal(resumed, clean)
    (run,) = eval_cells_fused.buckets
    assert run["megabatches"] == 2  # it resumed after two of four


def test_fused_and_serial_checkpoint_cells_interchange(tmp_path,
                                                       monkeypatch):
    path = str(tmp_path / "sweep.jsonl")
    p_list = [0.04, 0.07]
    fused = _family(CODES[:1]).EvalWER(
        "data", "Total", p_list, 256, if_plot=False,
        checkpoint=tckpt.SweepCheckpoint(path))
    runs = []
    real = CodeSimulator_DataError.WordErrorRate
    monkeypatch.setattr(CodeSimulator_DataError, "WordErrorRate",
                        lambda self, *a, **k: runs.append(1) or real(
                            self, *a, **k))
    serial = _family(CODES[:1]).EvalWER(
        "data", "Total", p_list, 256, if_plot=False, fused=False,
        checkpoint=tckpt.SweepCheckpoint(path))
    assert runs == []  # every cell came from the fused run's records
    np.testing.assert_array_equal(fused, serial)
    # and the other way round
    path2 = str(tmp_path / "serial.jsonl")
    _family(CODES[:1]).EvalWER("data", "Total", p_list, 256, if_plot=False,
                               fused=False,
                               checkpoint=tckpt.SweepCheckpoint(path2))
    again = _family(CODES[:1]).EvalWER(
        "data", "Total", p_list, 256, if_plot=False,
        checkpoint=tckpt.SweepCheckpoint(path2))
    assert eval_cells_fused.buckets == []
    np.testing.assert_array_equal(again, serial)


def test_unfusable_bucket_falls_back_serially_and_is_counted(monkeypatch):
    def unfusable(self, *a, **k):
        raise ValueError("this bucket cannot fuse")

    serial = _family(CODES[:1]).EvalWER("data", "Total", [0.03, 0.06], 256,
                                        if_plot=False, fused=False)
    monkeypatch.setattr(tsweep.CodeFamily, "_data_bucket_program", unfusable)
    telemetry.reset()
    telemetry.enable()
    try:
        fused = _family(CODES[:1]).EvalWER("data", "Total", [0.03, 0.06],
                                           256, if_plot=False)
        snap = telemetry.snapshot()
    finally:
        telemetry.disable()
    np.testing.assert_array_equal(fused, serial)
    assert snap["sweep.fused_fallback_cells"]["value"] == 2


def test_programs_refuse_what_cannot_fuse():
    a, b = _data_sim(0.03), _data_sim(0.05, seed=9)
    with pytest.raises(ValueError, match="split them"):
        CodeSimulator_DataError.fused_cells_program([a, b], 128)
    code = CODES[0]
    fused = [CodeSimulator_DataError(
        code=code, decoder_x=a.decoder_x, decoder_z=a.decoder_z,
        batch_size=64, fused_sampler=True, device="cpu")] * 2
    with pytest.raises(ValueError, match="fused sampler"):
        CodeSimulator_DataError.fused_cells_program(fused, 128)
    with pytest.raises(TypeError, match="mesh"):
        cell_fused_driver(lambda *a: a, 2, 64, 1, min_init=9, device="cpu",
                          mesh=object())
    driver = cell_fused_driver(lambda *a: a, 2, 64, 1, min_init=9,
                               device="cpu", mesh=shot_mesh(["cpu"] * 2))
    assert [sub.slots for sub in driver.subs] == [(0,), (1,)]


def test_fused_cells_reach_the_run_ledger(tmp_path):
    wer = _family(CODES[:1]).EvalWER("data", "Total", [0.05, 0.08], 256,
                                     if_plot=False, ledger=str(tmp_path))
    (rec,) = diagnostics.load_ledger(str(tmp_path))
    assert [c["shots"] for c in rec["cells"]] == [256, 256]
    for c, w in zip(rec["cells"], wer[0]):
        assert c["failures"] / c["shots"] == w


# ------------------------------------------------ the light state path

def test_stack_from_overrides_equals_generic_stacking():
    sims = [_data_sim(p, osd=True) for p in (0.02, 0.05, 0.08)]
    states = [s._cell_state() for s in sims]
    g_stacked, g_spec, g_axes = simc.stack_cell_states(states)
    o_stacked, o_spec, o_axes = simc.stack_from_overrides(states[0], {
        ("probs",): torch.stack([s["probs"] for s in states]),
        **{(d, leaf): torch.stack([s[d][leaf] for s in states])
           for d in ("dx", "dz") for leaf in simc.CELL_LEAVES}})
    assert o_spec == g_spec and o_axes == g_axes and sum(
        a == 0 for a in g_axes) == 5
    for a, b in zip(torch.utils._pytree.tree_leaves(o_stacked),
                    torch.utils._pytree.tree_leaves(g_stacked)):
        assert a is b or torch.equal(a, b)
    assert all(simc.states_share_but_llr(states[0]["dx"], s["dx"])
               for s in states)
    with pytest.raises(KeyError):
        simc.stack_from_overrides(states[0], {("nope",): torch.zeros(3)})
    lane = simc.gather_lane_states(g_stacked, g_spec, g_axes,
                                   torch.tensor([1]))
    assert torch.equal(lane["dx"]["llr0"], states[1]["dx"]["llr0"])
    # shared leaves pass through as the same tensors
    assert all(a is b for a, b in zip(lane["dx"]["graph"],
                                      states[0]["dx"]["graph"]))


@pytest.mark.parametrize("kind", ["bp", "bposd", "firstmin"])
@pytest.mark.parametrize("ext", [False, True])
def test_get_decoder_state_equals_the_full_build(kind, ext):
    code = CODES[1]
    h = code.hz
    params = {"h": h, "p_data": 0.03}
    if ext:
        params = {"h": np.hstack([h, np.eye(h.shape[0], dtype=np.uint8)]),
                  "p_data": 0.02, "p_syndrome": 0.01}
    port, jax = {
        "bp": (tdec.BP_Decoder_Class(4, "minimum_sum", 0.625, device="cpu"),
               jdec.BP_Decoder_Class(4, "minimum_sum", 0.625)),
        "bposd": (tdec.BPOSD_Decoder_Class(4, "minimum_sum", 0.625, "osd_e",
                                           4, device="cpu"),
                  jdec.BPOSD_Decoder_Class(4, "minimum_sum", 0.625, "osd_e",
                                           4)),
        "firstmin": (tdec.FirstMinBP_Decoder_Class(4, "minimum_sum", 0.625,
                                                   device="cpu"),
                     jdec.FirstMinBP_Decoder_Class(4, "minimum_sum", 0.625)),
    }[kind]
    dec = port.GetDecoder(dict(params))
    static, state = port.GetDecoderState(dict(params))
    assert static == dec.device_static
    assert set(state) == set(dec.device_state)
    for key, value in dec.device_state.items():
        if isinstance(value, torch.Tensor):
            assert torch.equal(state[key], value), key
        elif kind != "firstmin":
            assert state[key] is value, key  # the per-H memo's object
    # the JAX package's state on the same numpy inputs: the same priors
    # (and OSD costs), the same loop parameters
    j_static, j_state = jax.GetDecoderState(dict(params))
    np.testing.assert_array_equal(state["llr0"].numpy(),
                                  np.asarray(j_state["llr0"]))
    if kind == "bposd":
        np.testing.assert_array_equal(state["osd_cost"].numpy(),
                                      np.asarray(j_state["osd_cost"]))
        assert static[2:5] == j_static[2:5]
        static, j_static = static[1], j_static[1]
    assert static[:5] == j_static[:5]


# ------------------------------------------------------- against JAX

def _ledger_cells(path):
    (rec,) = diagnostics.load_ledger(str(path))
    return {(c["cell"]["code"], round(c["cell"]["p"], 12)): c
            for c in rec["cells"]}


@pytest.mark.parametrize("noise,kw", [
    ("data", dict(eval_p_list=[0.03, 0.08], num_samples=2048)),
    ("phenl", dict(eval_p_list=[0.02, 0.04], num_samples=1024,
                   num_cycles=3)),
])
def test_fused_grid_within_4_sigma_of_jax_fused_grid(tmp_path, noise, kw):
    jfam = jsweep.CodeFamily(
        [jcodes.hgp(jcodes.rep_code(3), jcodes.rep_code(3)),
         jcodes.hgp(jcodes.ring_code(3), jcodes.ring_code(3))],
        jdec.BP_Decoder_Class(4, "minimum_sum", 0.625),
        jdec.BP_Decoder_Class(3, "minimum_sum", 0.625), batch_size=128,
        seed=41)
    jfam.EvalWER(noise, "Total", if_plot=False, ledger=str(tmp_path / "j"),
                 **kw)
    _family(CODES, seed=41, batch=128).EvalWER(
        noise, "Total", if_plot=False, ledger=str(tmp_path / "t"), **kw)
    want, got = _ledger_cells(tmp_path / "j"), _ledger_cells(tmp_path / "t")
    assert set(want) == set(got)
    for key in want:
        a, b = want[key], got[key]
        n1, n2 = a["shots"], b["shots"]
        pooled = (a["failures"] + b["failures"]) / (n1 + n2)
        sigma = np.sqrt(pooled * (1 - pooled) * (1 / n1 + 1 / n2))
        assert abs(a["failures"] / n1 - b["failures"] / n2) <= 4 * sigma, (
            key, a["failures"], n1, b["failures"], n2)
    assert sum(c["failures"] for c in got.values()) > 0

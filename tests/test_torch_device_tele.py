"""The port's device telemetry vector and run record against the JAX
package, on the CPU.

  * ``device_tele_vec`` equals the JAX package's int32 for int32 on
    numpy-made ``converged`` / ``iterations`` for BP, BPOSD-E and OSD-CS
    statics at batch sizes below, at and above the compaction tiers.
    Tolerance: none.
  * The fused counter-PRNG engines (v1 and v2) publish the JAX engines'
    counters seed for seed on hgp_34_n225 (``bp.shots``, ``bp.converged``,
    the ``bp.iterations`` histogram and its sum).  Tolerance: none.
  * Telemetry on and off give bit-equal failures and min weight on the
    data engine's paths (dense, packed, BPOSD-E, OSD-CS, fused v1 and
    v2), the phenom engine, the fused sweep, the weighted run and the shot
    mesh; with it on, each publishes a vector whose shots are the decodes'
    and ends in one ``wer_run`` and one ``heartbeat`` event.
  * A resumed run's counters equal the unbroken run's; a wrapped iteration
    sum falls back to the bucket estimate.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qldpc_fault_tolerance_tpu.codes import load_code as jload_code
from qldpc_fault_tolerance_tpu.decoders import BPDecoder as JBPDecoder
from qldpc_fault_tolerance_tpu.sim import data_error as jde
from qldpc_fault_tolerance_tpu.utils import telemetry as jtele
from qldpc_fault_tolerance_tpu_torch.codes import hgp, load_code, rep_code
from qldpc_fault_tolerance_tpu_torch.decoders import (
    BP_Decoder_Class,
    BPDecoder,
    BPOSD_Decoder,
    BPOSD_Decoder_Class,
)
from qldpc_fault_tolerance_tpu_torch.parallel import shot_mesh
from qldpc_fault_tolerance_tpu_torch.sim import (
    CodeSimulator_DataError,
    CodeSimulator_Phenon,
)
from qldpc_fault_tolerance_tpu_torch.sweep import CodeFamily
from qldpc_fault_tolerance_tpu_torch.utils import telemetry as tele
from qldpc_fault_tolerance_tpu_torch.utils.checkpoint import (
    CellProgress,
    SweepCheckpoint,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N225 = os.path.join(REPO, "codes_lib_tpu", "hgp_34_n225.npz")
CODE = hgp(rep_code(3), rep_code(3))


@pytest.fixture(autouse=True)
def _telemetry_off():
    tele.disable()
    tele.reset()
    jtele.disable()
    jtele.reset()
    yield
    tele.disable()
    tele.reset()
    jtele.disable()
    jtele.reset()


def _statics():
    code = load_code(N225)
    probs = np.full(code.N, 0.03)
    bp = BPDecoder(code.hx, probs, 20, device="cpu").device_static
    osd_e = BPOSD_Decoder(code.hx, probs, 20, osd_method="osd_e",
                          osd_order=10, device="cpu").device_static
    osd_cs = BPOSD_Decoder(code.hx, probs, 20, osd_method="osd_cs",
                           osd_order=10, device="cpu").device_static
    return {"bp": bp, "bposd_e": osd_e, "osd_cs": osd_cs}


@pytest.mark.parametrize("kind", ["bp", "bposd_e", "osd_cs", "mixed"])
@pytest.mark.parametrize("batch,conv_rate", [(64, 0.8), (2048, 0.97),
                                             (2048, 0.6), (4096, 1.0)])
def test_device_tele_vec_equals_jax(kind, batch, conv_rate):
    statics = _statics()
    rng = np.random.default_rng(batch + int(conv_rate * 100))
    names = (["bp", "bposd_e", "osd_cs"] if kind == "mixed" else [kind, kind])
    pairs_j, pairs_t = [], []
    for name in names:
        conv = rng.random(batch) < conv_rate
        iters = rng.integers(0, 90, batch).astype(np.int32)
        pairs_j.append((statics[name], {"converged": jnp.asarray(conv),
                                        "iterations": jnp.asarray(iters)}))
        pairs_t.append((statics[name], {"converged": torch.from_numpy(conv),
                                        "iterations": torch.from_numpy(
                                            iters)}))
    want = np.asarray(jtele.device_tele_vec(pairs_j))
    got = tele.device_tele_vec(pairs_t)
    assert got.dtype == torch.int32 and got.shape == (tele.TELE_LEN,)
    assert np.array_equal(got.numpy(), want)
    assert tele.TELE_LEN == jtele.TELE_LEN


def test_device_tele_vec_without_aux_is_zero():
    got = tele.device_tele_vec([(("firstmin", 5, 0.9), {"final_weight": 3})],
                               device="cpu")
    assert got.dtype == torch.int32 and not got.any()


def test_wrapped_iteration_sum_falls_back_to_the_bucket_estimate():
    counts = np.zeros(len(tele.ITER_BUCKETS) + 1, np.int64)
    counts[2], counts[-1] = 7, 2
    vec = np.zeros(tele.TELE_LEN, np.int64)
    vec[tele.TELE_BP_SHOTS] = vec[tele.TELE_BP_CONVERGED] = 9
    vec[tele.TELE_ITER_HIST0:tele.TELE_ITER_HIST0 + len(counts)] = counts
    vec[tele.TELE_ITER_SUM] = -5  # the int32 slot wrapped
    tele.enable()
    tele.publish_device_tele(vec)
    hist = tele.snapshot()["bp.iterations"]
    want = tele._approx_iter_sum(counts)
    assert want == jtele._approx_iter_sum(counts) and want > 0
    assert hist["sum"] == want and hist["count"] == 9


def _counters():
    snap = tele.snapshot()
    out = {k: snap[k]["value"] for k in ("bp.shots", "bp.converged")
           if k in snap}
    if "bp.iterations" in snap:
        out["hist"] = snap["bp.iterations"]["counts"]
        out["sum"] = snap["bp.iterations"]["sum"]
    return out


def _jax_counters():
    snap = jtele.snapshot()
    out = {k: snap[k]["value"] for k in ("bp.shots", "bp.converged")
           if k in snap}
    if "bp.iterations" in snap:
        out["hist"] = snap["bp.iterations"]["counts"]
        out["sum"] = snap["bp.iterations"]["sum"]
    return out


@pytest.mark.parametrize("fused", [True, "v2"])
def test_fused_engine_counters_equal_jax_seed_for_seed(fused):
    p, batch, iters = 0.05, 64, 12
    jcode, code = jload_code(N225), load_code(N225)
    probs = np.full(code.N, p)
    jsim = jde.CodeSimulator_DataError(
        code=jcode, decoder_x=JBPDecoder(jcode.hz, probs, iters),
        decoder_z=JBPDecoder(jcode.hx, probs, iters),
        pauli_error_probs=[p / 3] * 3, batch_size=batch, seed=0,
        scan_chunk=2, fused_sampler=fused)
    sim = CodeSimulator_DataError(
        code=code, decoder_x=BPDecoder(code.hz, probs, iters, device="cpu"),
        decoder_z=BPDecoder(code.hx, probs, iters, device="cpu"),
        pauli_error_probs=[p / 3] * 3, batch_size=batch, seed=0,
        scan_chunk=2, fused_sampler=fused, device="cpu")
    jtele.enable()
    tele.enable()
    wer_j, _ = jsim.WordErrorRate(4 * batch, key=jax.random.PRNGKey(3))
    wer_t, _ = sim.WordErrorRate(4 * batch, key=(0, 3))
    assert wer_t == wer_j
    want, got = _jax_counters(), _counters()
    assert got["bp.shots"] == 2 * 4 * batch
    assert got == want


def _data_sim(kind, batch=64, mesh=None, code=CODE):
    p = 0.06
    probs = np.full(code.N, p)
    if kind in ("bposd_e", "osd_cs"):
        decs = [BPOSD_Decoder(h, probs, 8, osd_method=kind.replace(
            "bposd_", "osd_"), osd_order=4, device="cpu")
            for h in (code.hz, code.hx)]
    else:
        decs = [BPDecoder(h, probs, 8, device="cpu")
                for h in (code.hz, code.hx)]
    fused = {"v1": True, "v2": "v2"}.get(kind, False)
    return CodeSimulator_DataError(
        code=code, decoder_x=decs[0], decoder_z=decs[1],
        pauli_error_probs=[p / 3] * 3, batch_size=batch, seed=5,
        scan_chunk=2, fused_sampler=fused, packed=kind != "dense",
        device="cpu", mesh=mesh)


def _phenom_sim():
    code, p = CODE, 0.03
    ext = [np.hstack([h, np.eye(h.shape[0], dtype=np.uint8)])
           for h in (code.hz, code.hx)]
    d1 = [BPDecoder(h, np.full(h.shape[1], p), 6, device="cpu") for h in ext]
    d2 = [BPOSD_Decoder(h, np.full(code.N, p), 6, osd_order=3, device="cpu")
          for h in (code.hz, code.hx)]
    return CodeSimulator_Phenon(
        code=code, decoder1_x=d1[0], decoder1_z=d1[1], decoder2_x=d2[0],
        decoder2_z=d2[1], pauli_error_probs=[p / 3] * 3, q=p,
        batch_size=64, scan_chunk=2, device="cpu")


def _run_with_events(fn):
    """``fn()`` with telemetry on and a memory sink: (result, records)."""
    sink = tele.MemorySink()
    tele.enable()
    tele.add_sink(sink)
    try:
        out = fn()
    finally:
        tele.remove_sink(sink)
        tele.disable()
    return out, sink.records


@pytest.mark.parametrize("kind", ["packed", "dense", "bposd_e", "osd_cs",
                                  "v1", "v2", "mesh"])
def test_data_engine_on_off_bit_equal(kind):
    mesh = shot_mesh(["cpu"] * 2) if kind == "mesh" else None
    sims = [_data_sim("packed" if kind == "mesh" else kind, mesh=mesh)
            for _ in range(2)]
    off = sims[0].WordErrorRate(512, key=(0, 9))
    on, records = _run_with_events(
        lambda: sims[1].WordErrorRate(512, key=(0, 9)))
    assert on == off
    assert sims[1].min_logical_weight == sims[0].min_logical_weight
    snap = tele.snapshot()
    assert snap["bp.shots"]["value"] == 2 * sims[1].last_shots
    assert snap["sim.runs"]["value"] == 1
    kinds = [r["kind"] for r in records]
    assert kinds.count("wer_run") == 1 and kinds.count("heartbeat") == 1
    (run,) = [r for r in records if r["kind"] == "wer_run"]
    assert run["engine"] == "data" and run["failures"] == \
        sims[1].last_failures
    assert not tele.validate_event(run)
    if kind in ("bposd_e", "osd_cs"):
        osd = snap["osd.device_shots"]["value"]
        assert osd == snap["bp.shots"]["value"] - snap["bp.converged"]["value"]
        assert run["osd_backend"] == ("device_cs" if kind == "osd_cs"
                                      else "device")
        tiers = sum(snap.get(f"osd.tier_{t}", {"value": 0})["value"]
                    for t in ("none", "compacted", "full"))
        assert tiers == 2 * sims[1].last_shots // 64
    if kind == "osd_cs":
        assert snap["osd.cs_candidates"]["value"] > 0


def test_phenom_on_off_bit_equal_counts_decoder_two():
    sims = [_phenom_sim() for _ in range(2)]
    off = sims[0].WordErrorRate(3, 256, key=(0, 4))
    on, records = _run_with_events(
        lambda: sims[1].WordErrorRate(3, 256, key=(0, 4)))
    assert on == off and sims[1].last_failures == sims[0].last_failures
    snap = tele.snapshot()
    # the final round's decoder 2 of each sector, as in the JAX package
    assert snap["bp.shots"]["value"] == 2 * sims[1].last_shots
    (hb,) = [r for r in records if r["kind"] == "heartbeat"]
    assert hb["engine"] == "phenl" and "stages" in hb["waterfall"]


def test_weighted_run_on_off_bit_equal():
    sims = [_data_sim("packed") for _ in range(2)]
    tilt = [0.03] * 3
    off = sims[0].WeightedWordErrorRate(256, tilt_probs=tilt, key=(0, 2))
    on, records = _run_with_events(lambda: sims[1].WeightedWordErrorRate(
        256, tilt_probs=tilt, key=(0, 2)))
    assert on == off
    assert sims[1].last_weighted == sims[0].last_weighted
    assert tele.snapshot()["bp.shots"]["value"] == 2 * 256
    (run,) = [r for r in records if r["kind"] == "wer_run"]
    assert "ess" in run and "log_weight_sum" in run


def test_fused_sweep_on_off_bit_equal():
    def grid():
        fam = CodeFamily([CODE], BP_Decoder_Class(6, "minimum_sum", 0.625,
                                                  device="cpu"),
                         BPOSD_Decoder_Class(6, "minimum_sum", 0.625, "osd_e",
                                             3, device="cpu"),
                         batch_size=64, seed=1, device="cpu")
        return fam.EvalWER("data", "Total", [0.03, 0.06, 0.09], 256,
                           if_plot=False, fused=True)

    off = grid()
    on, records = _run_with_events(grid)
    assert np.array_equal(np.asarray(on), np.asarray(off))
    snap = tele.snapshot()
    # every lane-batch of both sectors: 3 cells x 256 shots x 2
    assert snap["bp.shots"]["value"] == 3 * 256 * 2
    runs = [r for r in records if r["kind"] == "wer_run"]
    assert len(runs) == 3 and all(r["engine"] == "data" for r in runs)
    assert all(r.get("waterfall") for r in records
               if r["kind"] == "heartbeat")


class _Stop(Exception):
    pass


def test_resumed_run_counters_equal_unbroken_run(tmp_path):
    unbroken = _data_sim("packed")
    tele.enable()
    unbroken.WordErrorRate(8 * 64, key=(0, 11))
    want = _counters()
    tele.reset()

    class Stopping(CellProgress):
        def save(self, *args, **kwargs):
            super().save(*args, **kwargs)
            if self._saves == 2:
                raise _Stop

    ck = SweepCheckpoint(str(tmp_path / "sweep.jsonl"))
    key = {"code": "rep3", "noise": "data", "p": 0.06}
    sim = _data_sim("packed")
    with pytest.raises(_Stop):
        sim.WordErrorRate(8 * 64, key=(0, 11),
                          progress=Stopping(ck, key))
    assert SweepCheckpoint(ck.path).get_progress(key)["tele"]
    tele.reset()
    sim = _data_sim("packed")
    sim.WordErrorRate(8 * 64, key=(0, 11),
                      progress=CellProgress(SweepCheckpoint(ck.path), key))
    assert sim.last_failures == unbroken.last_failures
    assert _counters() == want

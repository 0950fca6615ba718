"""The port's ``utils/profiling.py`` on the CPU, mirroring the JAX
package's ``tests/test_profiling.py``: the waterfall scope's stages sum to
the wall and record nothing when closed; a deep-timed run's device, sync
and gap stages sum to its wall; every engine's run ends in a heartbeat
with a waterfall; WER is bit-exact with profiling on and off;
``probe_max_block`` treats a failed try as data; ``parse_trace`` sums a
synthetic ``torch.profiler`` Chrome trace per kernel; the card's gates,
peaks and the derived rates.  Timing stages are compared with the slack
of their 6-decimal rounding; counts exactly.
"""
import gzip
import json
import time

import numpy as np
import pytest
import torch

from qldpc_fault_tolerance_tpu_torch.codes import hgp, rep_code
from qldpc_fault_tolerance_tpu_torch.decoders import (
    BPDecoder,
    ST_BP_Decoder_Circuit,
    ST_BP_Decoder_syndrome,
)
from qldpc_fault_tolerance_tpu_torch.sim import (
    CodeSimulator_Circuit,
    CodeSimulator_Circuit_SpaceTime,
    CodeSimulator_DataError,
    CodeSimulator_Phenon,
    CodeSimulator_Phenon_SpaceTime,
)
from qldpc_fault_tolerance_tpu_torch.utils import profiling, telemetry

torch.set_num_threads(1)

CODE = hgp(rep_code(3), rep_code(3))


@pytest.fixture(autouse=True)
def _clean():
    profiling.disable()
    profiling.reset_costs()
    telemetry.disable()
    telemetry.reset()
    yield
    profiling.disable()
    profiling.reset_costs()
    telemetry.disable()
    telemetry.reset()


def _data_sim(p=0.03, seed=0):
    probs = np.full(CODE.N, p)
    return CodeSimulator_DataError(
        code=CODE, decoder_x=BPDecoder(CODE.hz, probs, 6, device="cpu"),
        decoder_z=BPDecoder(CODE.hx, probs, 6, device="cpu"),
        pauli_error_probs=[p / 3] * 3, batch_size=32, seed=seed,
        scan_chunk=2, device="cpu")


def test_engine_scope_accounting_sums():
    profiling.enable()
    with profiling.engine_scope("unit") as acct:
        assert acct is not None
        profiling.record_dispatch(0.25)
        profiling.record_dispatch(0.05)
        profiling.record_host_sync(0.2)
        wf = acct.waterfall(wall_s=1.0)
    stages = wf["stages"]
    assert stages["dispatch_launch_s"] == pytest.approx(0.30)
    assert stages["host_sync_s"] == pytest.approx(0.2)
    assert stages["host_gap_s"] == pytest.approx(0.5)
    assert wf["dispatch_gap_fraction"] == pytest.approx(0.5)
    assert wf["n_dispatches"] == 2 and wf["n_syncs"] == 1
    assert sum(stages.values()) == pytest.approx(1.0)
    # no open scope: records are dropped, no heartbeat
    profiling.record_dispatch(99.0)
    assert profiling.run_heartbeat() is None


def test_engine_scope_inactive_when_disabled():
    with profiling.engine_scope("unit") as acct:
        assert acct is None
    assert profiling.timed_dispatch(lambda: 7) == 7
    telemetry.enable()  # heartbeats need the scope: telemetry alone opens it
    with profiling.engine_scope("unit") as acct:
        assert acct is not None


def test_deep_timed_run_waterfall_sums_to_wall():
    sim = _data_sim()
    sim.WordErrorRate(128, key=(0, 1))
    profiling.enable()
    with profiling.deep_timing(), profiling.engine_scope("unit") as acct:
        t0 = time.perf_counter()
        sim.WordErrorRate(128, key=(0, 1))
        wf = acct.waterfall(time.perf_counter() - t0)
    st = wf["stages"]
    assert wf["deep_timed"] and st["device_s"] > 0
    assert wf["n_dispatches"] == sim.last_dispatches == 2
    assert wf["n_syncs"] == sim.last_host_reads == 2
    assert (st["device_s"] + st["host_sync_s"] + st["host_gap_s"]
            == pytest.approx(wf["wall_s"], abs=5e-6))
    assert 0 <= wf["dispatch_gap_fraction"] <= 1


def _engines():
    code, p = CODE, 0.03
    m = code.hx.shape[0]
    ep = {"p_i": 0, "p_state_p": 0, "p_m": 0, "p_CX": 0.004,
          "p_idling_gate": 0}

    def bp(h, it=6):
        return BPDecoder(h, np.full(h.shape[1], p), it, device="cpu")

    def run_data():
        _data_sim().WordErrorRate(64, key=(0, 0))

    def run_phenom():
        ext = [np.hstack([h, np.eye(h.shape[0], dtype=np.uint8)])
               for h in (code.hz, code.hx)]
        CodeSimulator_Phenon(
            code=code, decoder1_x=bp(ext[0]), decoder1_z=bp(ext[1]),
            decoder2_x=bp(code.hz), decoder2_z=bp(code.hx),
            pauli_error_probs=[p / 3] * 3, q=p, batch_size=32,
            device="cpu").WordErrorRate(2, 32)

    def run_circuit():
        hx_ext = np.hstack([code.hx, np.eye(m, dtype=np.uint8)])
        CodeSimulator_Circuit(
            code=code, decoder1_z=bp(hx_ext), decoder2_z=bp(code.hx),
            p=0.004, num_cycles=2, error_params=ep, batch_size=32, seed=7,
            device="cpu").WordErrorRate(32, key=(0, 2))

    def run_circuit_st():
        sim = CodeSimulator_Circuit_SpaceTime(
            code=code, p=0.004, num_cycles=5, num_rep=2, error_params=ep,
            batch_size=32, seed=0, device="cpu")
        sim._generate_circuit()
        sim._generate_circuit_graph()
        g = sim.circuit_graph
        sim.decoder1_z = ST_BP_Decoder_Circuit(g["h1"], g["channel_ps1"], 6,
                                               device="cpu")
        sim.decoder2_z = ST_BP_Decoder_Circuit(g["h2"], g["channel_ps2"], 6,
                                               device="cpu")
        sim.WordErrorRate(32, key=(0, 3))

    def run_phenom_st():
        CodeSimulator_Phenon_SpaceTime(
            code=code,
            decoder1_x=ST_BP_Decoder_syndrome(code.hz, p_data=p, p_synd=p,
                                              max_iter=6, num_rep=2,
                                              device="cpu"),
            decoder1_z=ST_BP_Decoder_syndrome(code.hx, p_data=p, p_synd=p,
                                              max_iter=6, num_rep=2,
                                              device="cpu"),
            decoder2_x=bp(code.hz), decoder2_z=bp(code.hx),
            pauli_error_probs=[p / 3] * 3, q=p, num_rep=2, batch_size=32,
            device="cpu").WordErrorRate(2, 32, key=(0, 4))

    return {"data": run_data, "phenl": run_phenom, "circuit": run_circuit,
            "circuit_st": run_circuit_st, "phenl_st": run_phenom_st}


@pytest.mark.parametrize("engine", ["data", "phenl", "circuit", "circuit_st",
                                    "phenl_st"])
def test_heartbeat_event_every_engine(engine):
    run = _engines()[engine]
    sink = telemetry.MemorySink()
    telemetry.enable()
    telemetry.add_sink(sink)
    try:
        run()
    finally:
        telemetry.remove_sink(sink)
        telemetry.disable()
    hbs = [r for r in sink.records
           if r["kind"] == "heartbeat" and r["engine"] == engine]
    runs = [r for r in sink.records
            if r["kind"] == "wer_run" and r["engine"] == engine]
    assert len(hbs) == 1 and len(runs) == 1, sink.records
    wf = hbs[0]["waterfall"]
    assert wf["dispatch_gap_fraction"] is not None
    assert sum(wf["stages"].values()) == pytest.approx(wf["wall_s"],
                                                       abs=5e-6)
    assert runs[0]["kernel_variant"] == "xla_twin"
    assert runs[0]["osd_backend"] == "none"
    for rec in (hbs[0], runs[0]):
        assert not telemetry.validate_event(rec), rec
    assert telemetry.snapshot()["sim.runs"]["value"] == 1


def test_wer_bitexact_profiling_on_vs_off():
    sims = [_data_sim(seed=4) for _ in range(2)]
    off = sims[0].WordErrorRate(256, key=(0, 5))
    with profiling.profile_session():
        on = sims[1].WordErrorRate(256, key=(0, 5))
    assert on == off
    assert sims[1].min_logical_weight == sims[0].min_logical_weight


def test_probe_max_block_failures_are_data():
    def try_launch(block):
        if block > 256:
            raise RuntimeError(f"block {block} does not fit")
        return block % 128 == 0

    best, attempts = profiling.probe_max_block(try_launch,
                                               [1024, 512, 384, 256, 128])
    assert best == 256
    assert [(b, ok) for b, ok, _ in attempts] == [
        (1024, False), (512, False), (384, False), (256, True)]
    assert "does not fit" in attempts[0][2]
    assert profiling.probe_max_block(lambda b: False, [4, 2]) == (
        0, [(4, False, None), (2, False, None)])


@pytest.mark.parametrize("compressed", [False, True])
def test_parse_trace_sums_kernels(tmp_path, compressed):
    events = [
        {"ph": "M", "name": "process_name", "pid": 0,
         "args": {"name": "python"}},
        {"ph": "X", "cat": "kernel", "name": "bp_minsum_kernel", "pid": 0,
         "tid": 7, "ts": 0, "dur": 120.0},
        {"ph": "X", "cat": "kernel", "name": "bp_minsum_kernel", "pid": 0,
         "tid": 7, "ts": 200, "dur": 80.0},
        {"ph": "X", "cat": "Kernel", "name": "osd_elim_kernel", "pid": 0,
         "tid": 7, "ts": 400, "dur": 50.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "pid": 0,
         "tid": 7, "ts": 500, "dur": 10.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
         "pid": 1, "tid": 1, "ts": 0, "dur": 15.0},
        {"ph": "i", "name": "marker", "ts": 3},
    ]
    path = tmp_path / ("trace.json.gz" if compressed else "trace.json")
    data = json.dumps({"traceEvents": events})
    if compressed:
        with gzip.open(path, "wt") as fh:
            fh.write(data)
    else:
        path.write_text(data)
    (tmp_path / "broken.json").write_text("{not json")
    for target in (str(path), str(tmp_path)):
        out = profiling.parse_trace(target)
        assert out["kernels"] == {"bp_minsum_kernel": pytest.approx(200e-6),
                                  "osd_elim_kernel": pytest.approx(50e-6)}
        assert out["device_s"] == pytest.approx(260e-6)
        assert out["host_s"] == pytest.approx(15e-6)
        assert out["events"]["cudaGraphLaunch"] == pytest.approx(15e-6)
    assert profiling.parse_trace(str(tmp_path))["files"] == 1


def test_smem_gates_and_the_unmeasured_note():
    gates = profiling.smem_gates(4096, 300, 625, 7, 4)
    assert not gates["measured"]
    assert set(gates["kernels"]) == {"bp_minsum", "bp_minsum_bf16",
                                     "osd_elim", "osd_elim_full"}
    for lay in gates["kernels"].values():
        assert lay["smem_bytes"] > 0 and lay["threads"] > 0
        assert lay["memory"] in ("shared", "device", "device_planes",
                                 "checks", "transform")
    telemetry.enable()
    sink = telemetry.MemorySink()
    telemetry.add_sink(sink)
    try:
        fired = [profiling.note_unmeasured_gates(gates) for _ in range(2)]
    finally:
        telemetry.remove_sink(sink)
    assert fired in ([True, False], [False, False])  # once a process
    if fired[0]:
        (ev,) = [r for r in sink.records if r["kind"] == "unmeasured_gates"]
        assert ev["gates"] == sorted(gates["kernels"])
    assert not profiling.note_unmeasured_gates(dict(gates, measured=True))


def test_peaks_costs_and_utilization():
    peaks = profiling.device_peaks()
    assert peaks["hbm_bytes_per_s"] == 3.35e12
    assert peaks["flops_per_s"] == 67e12
    cost = profiling.capture_jit_cost(
        "unit", {"nodes": 12, "pool_bytes": 4096, "warmup_s": 0.5,
                 "capture_s": 0.25, "instantiate_s": 0.25},
        [("bp_minsum", 1e9, 2e6), ("osd_elim", None, None)])
    assert (cost.nodes, cost.launches, cost.costed_launches) == (12, 2, 1)
    assert profiling.program_costs()["unit"]["capture_s"] == 1.0
    util = profiling.derive_utilization("unit", 1000, 1e6)
    assert util["bytes_per_shot"] == 2e3 and util["ops_per_shot"] == 1e6
    assert util["hbm_util"] == pytest.approx(1e6 * 2e3 / 3.35e12)
    assert profiling.derive_utilization("missing", 10, 1.0) == {}


def test_timing_helpers_on_the_cpu():
    secs, out = profiling.timeit_block(lambda x: x + 1, 2, reps=3)
    assert out == 3 and secs >= 0
    stages = profiling.measure_stages([("a", lambda: 1), ("b", lambda: 2)],
                                      reps=2)
    assert set(stages) == {"a", "b"}
    assert profiling.per_call_seconds(lambda: None, lo=1, hi=3,
                                      trials=1) < 1.0

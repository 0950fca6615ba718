"""The port's sweep monitor (``utils/diagnostics.py`` ``SweepMonitor``)
against the JAX package's: each of the five detectors fed the same inputs
in both packages fires with the same fields; the sink protocol, the
fused-bucket plumbing (``drain_degrade_rungs``, ``report_ladder_anomaly``,
``record_cell(rungs=)``), ``notify_degrade`` from the resilience ladder
with telemetry off, ``publish_cell_progress``; and on a real fused sweep
of the port: a bucket whose rung was stepped by injected faults is one
anomaly naming all its cells, each labelled, with its rates equal to the
monitor-off run, and the buckets publish ``cell_progress`` events (plain
and weighted).  Tolerance: exact."""
import numpy as np
import pytest

from qldpc_fault_tolerance_tpu.utils import diagnostics as jdiag
from qldpc_fault_tolerance_tpu.utils import telemetry as jtele
from qldpc_fault_tolerance_tpu_torch.codes import hgp, rep_code
from qldpc_fault_tolerance_tpu_torch.decoders import BP_Decoder_Class
from qldpc_fault_tolerance_tpu_torch.sweep import CodeFamily
from qldpc_fault_tolerance_tpu_torch.utils import diagnostics as tdiag
from qldpc_fault_tolerance_tpu_torch.utils import (
    faultinject,
    resilience,
)
from qldpc_fault_tolerance_tpu_torch.utils import telemetry as ttele

BOTH = ((jdiag, jtele), (tdiag, ttele))


@pytest.fixture(autouse=True)
def _clean_state():
    taken = dict(resilience.DegradationLadder.taken)
    for diag, tele in BOTH:
        tele.disable()
        tele.reset()
        diag.auto()
    yield
    for diag, tele in BOTH:
        diag.auto()
        tele.disable()
        tele.reset()
    resilience.DegradationLadder.taken.clear()
    resilience.DegradationLadder.taken.update(taken)


def _cell_key(p, code="hgp_rep3"):
    return {"code": code, "noise": "data", "type": "Total", "cycles": 1,
            "p": p}


def _both(feed):
    """``feed(diag, tele)`` in each package; its anomalies (and cells)."""
    return [feed(diag, tele) for diag, tele in BOTH]


def test_non_monotone_wer_same_fields():
    def feed(diag, tele):
        mon = diag.SweepMonitor()
        mon.note_cell(_cell_key(0.02), 0.1, diag.ci_fields(100, 1000))
        mon.note_cell(_cell_key(0.04), 0.01, diag.ci_fields(10, 1000))
        mon.note_cell(_cell_key(0.06), 0.011, diag.ci_fields(11, 1000))
        mon.finalize()
        return mon.anomalies

    jax_out, port_out = _both(feed)
    assert [a["anomaly"] for a in port_out] == ["non_monotone_wer"]
    assert port_out == jax_out


@pytest.mark.parametrize("shots,converged,last_bucket", [
    (1000, 200, True),     # stalled, and the iterations moved to the top
    (1000, 950, False),    # healthy: nothing
    (50, 10, True),        # below min_shots: nothing
])
def test_bp_detectors_same_fields(shots, converged, last_bucket):
    def feed(diag, tele):
        tele.enable()
        mon = diag.SweepMonitor(min_shots=100)
        nb = len(tele.ITER_BUCKETS) + 1
        hist = tele.histogram("bp.iterations", tele.ITER_BUCKETS)
        tele.count("bp.shots", 1000)
        tele.count("bp.converged", 950)
        hist.merge_counts([950] + [0] * (nb - 1), 950.0, 950)
        mon.note_cell(_cell_key(0.01), 0.01, None)
        tele.count("bp.shots", shots)
        tele.count("bp.converged", converged)
        counts = [0] * nb
        counts[-1 if last_bucket else 0] = converged
        hist.merge_counts(counts, 64.0 * converged, converged)
        mon.note_cell(_cell_key(0.02), 0.2, None)
        return mon.anomalies

    jax_out, port_out = _both(feed)
    assert port_out == jax_out
    kinds = [a["anomaly"] for a in port_out]
    if shots >= 100 and converged < shots // 2:
        assert kinds == ["stalled_convergence", "bp_iteration_drift"]
        assert port_out[0]["converged_fraction"] == 0.2
    else:
        assert kinds == []


def test_ladder_and_substrate_through_the_sink_protocol():
    def feed(diag, tele):
        tele.enable()
        mon = diag.SweepMonitor()
        tele.add_sink(mon)
        try:
            tele.event("degrade", rung="packed->dense")
            mon.note_cell(_cell_key(0.02), 0.01, diag.ci_fields(10, 1000))
            mon.note_cell(_cell_key(0.04), 0.02, diag.ci_fields(20, 1000))
        finally:
            tele.remove_sink(mon)
        mon.finalize()
        assert mon.drain_rungs() == []
        mon.close()
        return mon.anomalies, mon.cells

    (j_an, j_cells), (t_an, t_cells) = _both(feed)
    assert [a["anomaly"] for a in t_an] == ["ladder_degrade",
                                            "substrate_mismatch"]
    assert t_an[0]["cell"]["p"] == 0.02
    assert t_an[0]["rungs"] == ["packed->dense"]
    assert t_an == j_an
    assert t_cells == j_cells
    assert t_cells[0]["substrate"] == "packed->dense"
    assert "substrate" not in t_cells[1]


def test_fused_bucket_plumbing_same_fields():
    def feed(diag, tele):
        diag.enable()
        with diag.sweep_run({"grid": "fused"}) as run:
            diag.notify_degrade("packed->dense")
            rungs = diag.drain_degrade_rungs()
            assert rungs == ["packed->dense"]
            assert diag.drain_degrade_rungs() == []
            cells = [_cell_key(0.02), _cell_key(0.04)]
            diag.report_ladder_anomaly(cells, rungs)
            for ck, f in zip(cells, (10, 20)):
                diag.record_cell(ck, f / 1000, diag.ci_fields(f, 1000),
                                 rungs=rungs)
            mon = run.monitor
        return mon.anomalies, mon.cells

    (j_an, j_cells), (t_an, t_cells) = _both(feed)
    assert [a["anomaly"] for a in t_an] == ["ladder_degrade"]
    assert len(t_an[0]["cells"]) == 2
    assert all(c["substrate"] == "packed->dense" for c in t_cells)
    assert (t_an, t_cells) == (j_an, j_cells)


def test_outside_a_run_the_plumbing_is_a_no_op():
    for diag, _ in BOTH:
        diag.notify_degrade("packed->dense")
        assert diag.drain_degrade_rungs() == []
        diag.report_ladder_anomaly([_cell_key(0.02)], ["packed->dense"])
        diag.record_cell(_cell_key(0.02), 0.1, None, rungs=["x"])


def test_publish_cell_progress_same_event():
    def feed(diag, tele):
        tele.enable()
        sink = tele.MemorySink()
        tele.add_sink(sink)
        try:
            diag.publish_cell_progress(
                "data", [_cell_key(0.02), _cell_key(0.04, code=None)],
                [10, 0], [1000, 500])
            diag.publish_cell_progress("phenl", [0.01, 0.03], [5, 7],
                                       [100, 100])
        finally:
            tele.remove_sink(sink)
        gauges = {k: v["value"] for k, v in tele.snapshot().items()
                  if k.startswith("cell.")}
        events = [{k: v for k, v in r.items() if k not in ("ts", "seq",
                                                           "pid", "host")}
                  for r in sink.records if r["kind"] == "cell_progress"]
        return events, gauges

    jax_out, port_out = _both(feed)
    assert len(port_out[0]) == 2
    assert port_out == jax_out
    assert not ttele.validate_event(dict(port_out[0][0], kind="cell_progress",
                                         ts=0.0))


def test_resilience_step_notifies_with_telemetry_off():
    assert not ttele.enabled()
    with tdiag.sweep_run({"grid": 1}) as run:
        assert run is None
    tdiag.enable()
    with tdiag.sweep_run({"grid": 1}) as run:
        resilience.DegradationLadder([("packed->dense", lambda: None)]).step()
        tdiag.record_cell(_cell_key(0.02), 0.01, tdiag.ci_fields(10, 1000))
    assert [a["anomaly"] for a in run.monitor.anomalies] == ["ladder_degrade"]


def _family(codes=None, batch=128):
    codes = codes or [hgp(rep_code(3), rep_code(3)),
                      hgp(rep_code(4), rep_code(4))]
    return CodeFamily(codes, BP_Decoder_Class(6, "minimum_sum", 0.625,
                                              device="cpu"),
                      BP_Decoder_Class(6, "minimum_sum", 0.625, device="cpu"),
                      batch_size=batch, seed=3, device="cpu")


def test_fused_bucket_rung_is_one_anomaly_naming_every_cell(tmp_path):
    p_list = [0.02, 0.05, 0.08]
    clean = _family().EvalWER("data", "Total", p_list, 256, if_plot=False)
    plan = faultinject.FaultPlan([faultinject.Fault(
        site="fused_cells_launch", kind="raise", after=1, count=2)])
    pol = resilience.RetryPolicy(max_attempts=4, base_delay=0.0, jitter=0.0,
                                 degrade_after=2, reset_caches=False)
    ttele.enable()
    sink = ttele.MemorySink()
    ttele.add_sink(sink)
    try:
        with resilience.policy_override(pol), plan.active():
            faulted = _family().EvalWER("data", "Total", p_list, 256,
                                        if_plot=False,
                                        ledger=str(tmp_path))
    finally:
        ttele.remove_sink(sink)
    assert np.array_equal(faulted, clean)
    (rec,) = tdiag.load_ledger(str(tmp_path))
    kinds = sorted(a["anomaly"] for a in rec["anomalies"])
    assert kinds == ["ladder_degrade", "substrate_mismatch"]
    ladder = next(a for a in rec["anomalies"]
                  if a["anomaly"] == "ladder_degrade")
    second = [c["cell"] for c in rec["cells"][len(p_list):]]
    assert ladder["cells"] == second and ladder["rungs"] == ["packed->dense"]
    assert [c.get("substrate") for c in rec["cells"]] == \
        [None] * len(p_list) + ["packed->dense"] * len(p_list)
    progress = [r for r in sink.records if r["kind"] == "cell_progress"]
    assert len(progress) == 2
    assert [len(r["cells"]) for r in progress] == [3, 3]
    assert all(not ttele.validate_event(r) for r in sink.records)


def test_streaming_and_weighted_buckets_publish_progress(tmp_path):
    from qldpc_fault_tolerance_tpu_torch.rare import eval_rare_grid
    from qldpc_fault_tolerance_tpu_torch.utils.checkpoint import \
        SweepCheckpoint

    ttele.enable()
    sink = ttele.MemorySink()
    ttele.add_sink(sink)
    try:
        _family(batch=64).EvalWER(
            "data", "Total", [0.03, 0.06], 256, if_plot=False,
            checkpoint=SweepCheckpoint(str(tmp_path / "ck.jsonl")))
        streamed = [r for r in sink.records if r["kind"] == "cell_progress"]
        del sink.records[:]
        eval_rare_grid(hgp(rep_code(3), rep_code(3)),
                       BP_Decoder_Class(6, "minimum_sum", 0.625,
                                        device="cpu"),
                       [0.04, 0.02], 128, q_total=0.1, batch_size=64,
                       device="cpu")
        weighted = [r for r in sink.records if r["kind"] == "cell_progress"]
    finally:
        ttele.remove_sink(sink)
    # one event a megabatch read: 4 batches of 64 in megabatches of 4
    assert len(streamed) >= 2 and all(len(r["cells"]) == 2
                                      for r in streamed)
    assert weighted and all("ess" in r for r in weighted)
    assert all(not ttele.validate_event(r) for r in streamed + weighted)

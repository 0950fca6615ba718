"""The port's resilience layer on the engines, against the JAX package's
(``tests/test_resilience.py``), on the CPU.

  * Transient faults (injected at ``megabatch_dispatch``, ``wer.phenl``,
    a drain stall under the watchdog) retry to the fault-free run's
    failures and min weight bit for bit in the data and phenom engines;
    a deterministic fault fails fast, an exhausted budget re-raises.
  * The degradation ladder steps the JAX package's rungs that stay on the
    card's kernels, in its order (``fused_v2->fused_pallas``,
    ``packed->dense``); ``packed->dense`` equals the fault-free packed run
    bit for bit, ``fused_v2->fused_pallas`` the fault-free fused v1 run;
    a fault that outlives the rungs raises (a persistent OOM too).
  * ``mesh_device_loss`` at ``mesh_dispatch`` on ``["cpu"] * 2`` steps
    ``mesh_replan`` once and equals the uninterrupted mesh run and the
    JAX package's replanned mesh run.
  * A deterministic fault (a failed kernel build, a failed
    ``check_launch``, a sticky CUDA error) raises through the ladder and
    the mesh path without stepping a rung.

Tolerance: every comparison is exact (the counts are integers drawn from
the same key streams).
"""
import time

import numpy as np
import pytest
import torch

import jax

from qldpc_fault_tolerance_tpu import parallel as jpar
from qldpc_fault_tolerance_tpu.decoders import BPDecoder as JBPDecoder
from qldpc_fault_tolerance_tpu.sim import data_error as jde
from qldpc_fault_tolerance_tpu.utils import faultinject as jfi
from qldpc_fault_tolerance_tpu_torch.codes import hgp, rep_code
from qldpc_fault_tolerance_tpu_torch.decoders import BPDecoder
from qldpc_fault_tolerance_tpu_torch.parallel import shot_mesh
from qldpc_fault_tolerance_tpu_torch.sim import (
    CodeSimulator_DataError,
    CodeSimulator_Phenon,
)
from qldpc_fault_tolerance_tpu_torch.sim import common
from qldpc_fault_tolerance_tpu_torch.utils import (
    faultinject,
    resilience,
    telemetry,
)

torch.set_num_threads(1)

CODE = hgp(rep_code(3), rep_code(3))


@pytest.fixture(autouse=True)
def _clean():
    faultinject.deactivate()
    resilience.DegradationLadder.taken.clear()
    yield
    faultinject.deactivate()


def fast_policy(**kw):
    kw.setdefault("max_attempts", 4)
    kw.setdefault("base_delay", 0.0)
    kw.setdefault("jitter", 0.0)
    kw.setdefault("reset_caches", False)
    return resilience.RetryPolicy(**kw)


def data_sim(**kw):
    p = kw.pop("p", 0.05)
    dec = lambda h: BPDecoder(h, np.full(CODE.N, p), 6,  # noqa: E731
                              device="cpu")
    kw.setdefault("batch_size", 64)
    kw.setdefault("scan_chunk", 2)
    return CodeSimulator_DataError(
        code=CODE, decoder_x=dec(CODE.hz), decoder_z=dec(CODE.hx),
        pauli_error_probs=[p / 3] * 3, seed=0, device="cpu", **kw)


def phenom_sim(**kw):
    p = kw.pop("p", 0.04)
    ext = np.hstack([CODE.hx, np.eye(CODE.hx.shape[0], dtype=np.uint8)])
    extz = np.hstack([CODE.hz, np.eye(CODE.hz.shape[0], dtype=np.uint8)])
    d1 = lambda h: BPDecoder(h, np.full(h.shape[1], p), 4,  # noqa: E731
                             device="cpu")
    d2 = lambda h: BPDecoder(h, np.full(CODE.N, p), 6,  # noqa: E731
                             device="cpu")
    kw.setdefault("batch_size", 64)
    kw.setdefault("scan_chunk", 2)
    return CodeSimulator_Phenon(
        code=CODE, decoder1_x=d1(extz), decoder1_z=d1(ext),
        decoder2_x=d2(CODE.hz), decoder2_z=d2(CODE.hx),
        pauli_error_probs=[p / 3] * 3, q=p, seed=0, device="cpu", **kw)


def _run(sim, key, shots=64 * 8, **kw):
    wer = sim.WordErrorRate(shots, key=key, **kw)
    return wer, sim.last_failures, sim.min_logical_weight


# ---------------------------------------------------------------------------
# classification on the card's error classes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("exc, kind", [
    (faultinject.InjectedFault("boom"), "transient"),
    (resilience.WatchdogTimeout("hung"), "transient"),
    (resilience.MeshDeviceLoss("lost"), "resource"),
    (torch.cuda.OutOfMemoryError("CUDA out of memory"), "resource"),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     "deterministic"),
    (RuntimeError("bp_minsum_launch launch failed with CUDA error 700"),
     "deterministic"),
    (RuntimeError("nvcc failed for csrc/bp_minsum.cu:\nerror"),
     "deterministic"),
    (faultinject.InjectedDeterministicFault("bug"), "deterministic"),
])
def test_classify_error_on_card_errors(exc, kind):
    assert resilience.classify_error(exc) == kind


# ---------------------------------------------------------------------------
# transient faults retry bit for bit; deterministic ones fail fast
# ---------------------------------------------------------------------------
def test_transient_fault_mid_megabatch_retries_bitexact_data():
    key = (0, 11)
    clean = _run(data_sim(), key)
    plan = faultinject.FaultPlan([faultinject.Fault(
        site="megabatch_dispatch", kind="raise", after=1)])
    with resilience.policy_override(fast_policy()), plan.active():
        with telemetry.session(reset_metrics=True) as reg:
            faulted = _run(data_sim(), key)
            snap = reg.snapshot()
    assert faulted == clean
    assert snap["faultinject.injected"]["value"] == 1
    assert snap["resilience.retries"]["value"] == 1


def test_transient_fault_retries_bitexact_phenom():
    key = (0, 12)
    clean = phenom_sim().WordErrorRate(3, 64 * 4, key=key)
    plan = faultinject.FaultPlan([faultinject.Fault(site="wer.phenl",
                                                    kind="raise")])
    with resilience.policy_override(fast_policy()), plan.active():
        with telemetry.session(reset_metrics=True) as reg:
            faulted = phenom_sim().WordErrorRate(3, 64 * 4, key=key)
            snap = reg.snapshot()
    assert faulted == clean
    assert snap["resilience.retries"]["value"] == 1


def test_deterministic_fault_fails_fast():
    plan = faultinject.FaultPlan([faultinject.Fault(
        site="megabatch_dispatch", kind="deterministic", count=99)])
    pol = fast_policy(max_attempts=5, base_delay=30.0)
    t0 = time.perf_counter()
    with resilience.policy_override(pol), plan.active():
        with telemetry.session(reset_metrics=True) as reg:
            with pytest.raises(faultinject.InjectedDeterministicFault):
                data_sim().WordErrorRate(64 * 4, key=(0, 0))
            snap = reg.snapshot()
    assert time.perf_counter() - t0 < 10.0
    assert plan.hits("megabatch_dispatch") == 1
    assert snap["resilience.deterministic_failures"]["value"] >= 1
    assert "resilience.retries" not in snap
    assert not resilience.DegradationLadder.taken


def test_retry_budget_exhaustion_reraises():
    plan = faultinject.FaultPlan([faultinject.Fault(site="wer.data",
                                                    kind="raise", count=99)])
    with resilience.policy_override(fast_policy(max_attempts=2)):
        with plan.active():
            with telemetry.session(reset_metrics=True) as reg:
                with pytest.raises(faultinject.InjectedFault):
                    data_sim().WordErrorRate(64 * 2, key=(0, 1))
                snap = reg.snapshot()
    assert snap["resilience.exhausted"]["value"] >= 1


def test_watchdog_fires_on_stalled_drain_and_run_completes():
    key = (0, 13)
    clean = _run(data_sim(p=0.2), key, target_failures=10 ** 9)
    plan = faultinject.FaultPlan([faultinject.Fault(
        site="megabatch_drain", kind="stall", stall_s=2.0)])
    with resilience.policy_override(fast_policy(watchdog_s=0.2)), \
            plan.active():
        with telemetry.session(reset_metrics=True) as reg:
            faulted = _run(data_sim(p=0.2), key, target_failures=10 ** 9)
            snap = reg.snapshot()
    assert faulted == clean
    assert snap["resilience.watchdog_fires"]["value"] >= 1
    assert snap["resilience.retries"]["value"] >= 1


def test_combined_kill_plus_stall_plan_bitexact_both_engines():
    pol = fast_policy(max_attempts=4, watchdog_s=0.2)

    def make_plan():
        return faultinject.FaultPlan([
            faultinject.Fault(site="megabatch_dispatch", kind="raise",
                              after=1),
            faultinject.Fault(site="megabatch_drain", kind="stall",
                              stall_s=2.0)])

    key = (0, 41)
    clean_d = _run(data_sim(), key)
    with resilience.policy_override(pol), make_plan().active():
        with telemetry.session(reset_metrics=True) as reg:
            faulted_d = _run(data_sim(), key)
            snap_d = reg.snapshot()
    assert faulted_d == clean_d
    assert snap_d["faultinject.injected"]["value"] == 2
    assert snap_d["resilience.retries"]["value"] >= 2
    assert snap_d["resilience.watchdog_fires"]["value"] >= 1
    clean_p = phenom_sim().WordErrorRate(3, 64 * 8, key=key)
    with resilience.policy_override(pol), make_plan().active():
        faulted_p = phenom_sim().WordErrorRate(3, 64 * 8, key=key)
    assert faulted_p == clean_p


# ---------------------------------------------------------------------------
# the degradation ladder
# ---------------------------------------------------------------------------
def test_degradation_ladder_steps_packed_to_dense_bitexact():
    key = (0, 31)
    clean = _run(data_sim(), key, shots=64 * 4)
    plan = faultinject.FaultPlan([faultinject.Fault(site="wer.data",
                                                    kind="raise", count=2)])
    pol = fast_policy(max_attempts=4, degrade_after=1)
    with resilience.policy_override(pol), plan.active():
        with telemetry.session(reset_metrics=True) as reg:
            sim = data_sim()
            degraded = _run(sim, key, shots=64 * 4)
            snap = reg.snapshot()
    assert degraded == clean
    assert sim._packed is False
    assert snap["resilience.degrades"]["value"] >= 1
    assert resilience.DegradationLadder.taken["packed->dense"] == 1


@pytest.mark.parametrize("make, rungs", [
    (data_sim, ["packed->dense"]),
    (phenom_sim, ["packed->dense"]),
    (lambda: data_sim(fused_sampler=True), []),
    (lambda: data_sim(fused_sampler="v2", batch_size=64),
     ["fused_v2->fused_pallas"]),
])
def test_degradation_ladder_order(make, rungs):
    """The JAX package's rungs that stay on the card's kernels, in its
    order; its ``fused_pallas->fused_xla``, ``fused->packed`` and
    ``device->cpu`` rungs have no counterpart, so the ladder ends here."""
    sim = make()
    assert [sim._degrade_once() for _ in rungs] == rungs
    assert sim._degrade_once() is None


def test_fused_ladder_bitexact_rungs_and_their_engines():
    """The fused v2 engine's one rung: ``fused_v2->fused_pallas`` equals
    the fused v1 engine's fault-free run bit for bit; a fault that then
    outlives the retries finds the ladder exhausted and raises, with no
    further rung."""
    key = (0, 7)
    ref = _run(data_sim(fused_sampler=True), key, shots=64 * 4)
    sim = data_sim(fused_sampler="v2")
    pol = fast_policy(max_attempts=2, degrade_after=1)

    def faulted(count):
        plan = faultinject.FaultPlan([faultinject.Fault(
            site="wer.data", kind="raise", count=count)])
        with resilience.policy_override(pol), plan.active():
            return _run(sim, key, shots=64 * 4)

    assert faulted(1)[:2] == ref[:2]
    assert resilience.DegradationLadder.taken == {
        "fused_v2->fused_pallas": 1}
    with pytest.raises(faultinject.InjectedFault):
        faulted(2)
    assert resilience.DegradationLadder.taken == {
        "fused_v2->fused_pallas": 1}
    assert sim._fused_sampler is True


@pytest.mark.parametrize("make, rungs", [
    (data_sim, {"packed->dense": 1}),
    (lambda: data_sim(fused_sampler="v2"), {"fused_v2->fused_pallas": 1}),
])
def test_persistent_oom_walks_the_kernel_rungs_then_raises(monkeypatch,
                                                           make, rungs):
    """A persistent OOM (a resource fault) steps one rung an attempt, and
    once the ladder is exhausted it raises: no rung leaves the card's
    kernels, so the run never ends on a plain version or the CPU."""
    sim = make()
    calls = {"n": 0}

    def oom(*_a, **_k):
        calls["n"] += 1
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(sim, "_driver", oom)
    with resilience.policy_override(fast_policy(max_attempts=3)):
        with pytest.raises(torch.cuda.OutOfMemoryError):
            sim.WordErrorRate(256, key=(0, 1))
    assert resilience.DegradationLadder.taken == rungs
    assert calls["n"] == 2


# ---------------------------------------------------------------------------
# the mesh_replan rung
# ---------------------------------------------------------------------------
def _mesh_data(fused="v2"):
    p = 0.05
    dec = lambda h: BPDecoder(h, np.full(CODE.N, p), 10,  # noqa: E731
                              device="cpu")
    return CodeSimulator_DataError(
        code=CODE, decoder_x=dec(CODE.hz), decoder_z=dec(CODE.hx),
        pauli_error_probs=[p / 3] * 3, batch_size=64, seed=0,
        fused_sampler=fused, device="cpu", mesh=shot_mesh(["cpu"] * 2))


def test_mesh_device_loss_replans_once_equal_to_uninterrupted_and_jax():
    key = 12
    clean = _mesh_data()
    clean.WordErrorRate(2048, key=(0, key))
    plan = faultinject.FaultPlan([faultinject.Fault(
        site="mesh_dispatch", kind="mesh_device_loss", after=1)])
    sim = _mesh_data()
    with telemetry.session(reset_metrics=True) as reg:
        with plan.active():
            sim.WordErrorRate(2048, key=(0, key))
        snap = reg.snapshot()
    assert sim._mesh_lost
    assert snap["mesh.replans"]["value"] == 1
    assert resilience.DegradationLadder.taken == {"mesh_replan": 1}
    assert (sim.last_failures, sim.last_shots, sim.min_logical_weight) == \
        (clean.last_failures, clean.last_shots, clean.min_logical_weight)
    assert sim.last_failures > 0
    # the next run goes straight to the replay runner
    sim.WordErrorRate(2048, key=(0, key))
    assert sim.last_failures == clean.last_failures
    assert resilience.DegradationLadder.taken == {"mesh_replan": 1}
    # the JAX package's replanned mesh run of the same key
    jsim = jde.CodeSimulator_DataError(
        code=CODE, decoder_x=JBPDecoder(CODE.hz, np.full(CODE.N, 0.05), 10),
        decoder_z=JBPDecoder(CODE.hx, np.full(CODE.N, 0.05), 10),
        pauli_error_probs=[0.05 / 3] * 3, batch_size=64, seed=0,
        fused_sampler="v2", mesh=jpar.shot_mesh(jax.devices()[:2]))
    jplan = jfi.FaultPlan([jfi.Fault(site="mesh_dispatch",
                                     kind="mesh_device_loss", after=1)])
    with jplan.active():
        jwer, _ = jsim.WordErrorRate(2048, key=jax.random.PRNGKey(key))
    assert jsim._mesh_lost
    assert round(jwer * 2048) == sim.last_failures
    assert jsim.min_logical_weight == sim.min_logical_weight


@pytest.mark.parametrize("error", [
    RuntimeError("bp_minsum_launch launch failed with CUDA error 700"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    RuntimeError("nvcc failed for csrc/fused_decode.cu:\nerror"),
])
def test_deterministic_faults_raise_through_ladder_and_mesh(monkeypatch,
                                                            error):
    """A failed kernel build, a failed launch check and a sticky CUDA
    error are deterministic: the engine's run and the mesh run raise them
    with no rung stepped and no replan."""
    calls = {"n": 0}

    def broken(*_a, **_k):
        calls["n"] += 1
        raise error

    pol = fast_policy(max_attempts=4, degrade_after=1)
    sim = data_sim()
    monkeypatch.setattr(sim, "_driver", broken)
    with resilience.policy_override(pol):
        with pytest.raises(RuntimeError, match=str(error).split(":")[0]):
            sim.WordErrorRate(256, key=(0, 1))
    assert calls["n"] == 1 and sim._packed
    mesh_sim = _mesh_data(fused=False)
    monkeypatch.setattr(common, "mesh_replica",
                        lambda *_a, **_k: broken())
    with resilience.policy_override(pol):
        with pytest.raises(RuntimeError):
            mesh_sim.WordErrorRate(256, key=(0, 1))
    assert not mesh_sim.__dict__.get("_mesh_lost")
    assert not resilience.DegradationLadder.taken

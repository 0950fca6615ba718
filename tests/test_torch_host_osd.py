"""The port's host OSD (``_native/osd.cpp``, ``decoders/osd.py``) and the
``device_osd`` switch of its BPOSD decoders against the JAX package, on
the CPU.

  * The g++ build lands in ``build/torch_native/`` (never next to the
    source, never the JAX package's library); a failed build raises.
  * The C++ OSD equals ``_osd_numpy`` and the JAX package's
    ``osd_decode_batch`` bit for bit on the same float64 inputs (OSD-0,
    OSD-E, OSD-CS).
  * ``BPOSD_Decoder(device_osd=False)`` equals JAX's host-OSD decoder bit
    for bit on the same syndromes.  ``device_osd`` is a plain bool, the
    one way to choose the host (no environment variable), and a fault of
    the device decode raises, transient or deterministic: no rung moves a
    device decoder's OSD to the host.
  * The data and phenom engines refuse host-OSD decoders (as JAX's do);
    the circuit, circuit space-time and phenom space-time engines run them
    through the host-assisted loop: within 4 combined binomial sigma of
    the JAX package's windowed path, and their device-OSD run on the same
    draws within 2 shots (float32 against float64 costs may break a tie
    otherwise), a drain fault retried bit for bit.
"""
import os

import numpy as np
import pytest
import torch

import jax

import qldpc_fault_tolerance_tpu.decoders as jdec
import qldpc_fault_tolerance_tpu.sim.circuit as jsc
import qldpc_fault_tolerance_tpu.sim.circuit_spacetime as jcst
from qldpc_fault_tolerance_tpu.codes import hgp as jhgp
from qldpc_fault_tolerance_tpu.codes import rep_code as jrep
from qldpc_fault_tolerance_tpu.decoders import osd as josd
from qldpc_fault_tolerance_tpu_torch import _native
from qldpc_fault_tolerance_tpu_torch import decoders as tdec
from qldpc_fault_tolerance_tpu_torch.codes import gf2, hgp, rep_code
from qldpc_fault_tolerance_tpu_torch.decoders import BPOSD_Decoder
from qldpc_fault_tolerance_tpu_torch.decoders import osd as tosd
from qldpc_fault_tolerance_tpu_torch.sim import (
    CodeSimulator_Circuit,
    CodeSimulator_Circuit_SpaceTime,
    CodeSimulator_DataError,
    CodeSimulator_Phenon,
    CodeSimulator_Phenon_SpaceTime,
)
from qldpc_fault_tolerance_tpu_torch.utils import faultinject, resilience

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CODE = hgp(rep_code(3), rep_code(3))
CODE5 = hgp(rep_code(5), rep_code(5))


@pytest.fixture(autouse=True)
def _clean():
    faultinject.deactivate()
    yield
    faultinject.deactivate()


def _inputs(h, B, seed):
    rng = np.random.default_rng(seed)
    e = (rng.random((B, h.shape[1])) < 0.1).astype(np.uint8)
    synd = (e @ h.T % 2).astype(np.uint8)
    llrs = rng.normal(1.0, 2.0, size=(B, h.shape[1]))
    probs = rng.uniform(0.01, 0.2, size=h.shape[1])
    return synd, llrs, probs


def test_native_build_lands_in_the_build_tree_and_loads():
    path = _native.library_path()
    assert path.parent == _native.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "torch_native")
    assert _native.SOURCE.parent != path.parent
    lib = _native.load_native()
    assert path.exists() and lib is _native.load_native()
    for h in (CODE.hx, CODE5.hz, np.ones((3, 4), np.uint8)):
        assert _native.gf2_rank(h) == gf2.rank(h)


def test_failed_native_build_raises(monkeypatch, tmp_path):
    bad = tmp_path / "osd.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(_native, "SOURCE", bad)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(_native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        _native.load_native()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tosd.osd_decode_batch(CODE.hx, np.zeros((1, CODE.hx.shape[0])),
                              np.zeros((1, CODE.N)), np.full(CODE.N, 0.1))


@pytest.mark.parametrize("method, order", [("osd0", 0), ("osd_e", 4),
                                           ("osd_e", 6), ("osd_cs", 5)])
@pytest.mark.parametrize("code", [CODE, CODE5], ids=["rep3", "rep5"])
def test_cpp_equals_numpy_and_jax_bit_for_bit(method, order, code):
    h = code.hx
    synd, llrs, probs = _inputs(h, 48, seed=order + len(method))
    got = tosd.osd_decode_batch(h, synd, llrs, probs, osd_method=method,
                                osd_order=order)
    plain = tosd._osd_numpy(gf2.to_gf2(h), synd, llrs,
                            tosd._channel_cost(probs), tosd.METHODS[method],
                            order)
    want = josd.osd_decode_batch(h, synd, llrs, probs, osd_method=method,
                                 osd_order=order)
    assert np.array_equal(got, plain) and np.array_equal(got, want)
    assert np.array_equal(got @ gf2.to_gf2(h).T % 2, synd)


def _bposd(h, p, **kw):
    return BPOSD_Decoder(h, np.full(h.shape[1], p), 6, osd_order=6,
                         device="cpu", **kw)


def test_host_osd_decoder_equals_jax_host_decoder():
    h, p = CODE5.hx, 0.08
    rng = np.random.default_rng(3)
    e = (rng.random((128, h.shape[1])) < p).astype(np.uint8)
    synd = (e @ h.T % 2).astype(np.uint8)
    dec = _bposd(h, p, device_osd=False)
    assert dec.needs_host_postprocess and dec.device_static[0] == "bp"
    jd = jdec.BPOSD_Decoder(h, np.full(h.shape[1], p), 6, osd_order=6,
                            device_osd=False)
    got = dec.decode_batch(synd)
    assert np.array_equal(got, jd.decode_batch(synd))
    assert np.array_equal(got @ h.T % 2, synd)
    assert np.array_equal(got, _bposd(h, p).decode_batch(synd))


def test_device_osd_switch_and_env(monkeypatch):
    """``device_osd`` is the argument alone: True by default, False for the
    host; ``QLDPC_DEVICE_OSD`` (JAX's switch) changes nothing here, and a
    value that is not a bool raises."""
    h = CODE.hx
    monkeypatch.setenv("QLDPC_DEVICE_OSD", "0")
    assert _bposd(h, 0.05).device_osd is True
    assert _bposd(h, 0.05, device_osd=False).device_osd is False
    with pytest.raises(TypeError, match="device_osd"):
        _bposd(h, 0.05, device_osd="auto")
    cls = tdec.BPOSD_Decoder_Class(10, "minimum_sum", 0.625, "osd_e", 4,
                                   device="cpu", device_osd=False)
    assert cls.GetDecoder({"h": h, "p_data": 0.05}).needs_host_postprocess
    with pytest.raises(ValueError, match="host-OSD"):
        cls.GetDecoderState({"h": h, "p_data": 0.05})
    dev_cls = tdec.BPOSD_Decoder_Class(10, "minimum_sum", 0.625, "osd_e", 4,
                                       device="cpu")
    assert not dev_cls.GetDecoder({"h": h,
                                   "p_data": 0.05}).needs_host_postprocess
    st = tdec.ST_BPOSD_Decoder_Circuit_Class(10, "minimum_sum", 0.625,
                                             "osd_e", 4, device="cpu",
                                             device_osd=False)
    d = st.GetDecoder({"h": h, "code_h": h,
                       "channel_probs": np.full(h.shape[1], 0.05)})
    assert isinstance(d, tdec.ST_BPOSD_Decoder_Circuit)
    assert d.needs_host_postprocess


@pytest.mark.parametrize("error", [
    resilience.TransientFault("injected device-OSD fault"),
    torch.cuda.OutOfMemoryError("CUDA out of memory"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    RuntimeError("osd_elim_launch launch failed with CUDA error 719"),
    RuntimeError("nvcc failed for csrc/osd_elim.cu:\nerror"),
])
def test_device_osd_fault_raises_and_never_steps_to_host(error):
    """A device-OSD decoder's fault, transient, resource or deterministic
    (a failed kernel build, a failed launch check, a sticky CUDA error),
    raises from ``decode_batch``: the host OSD runs only where the caller
    chose it, and its answer equals the device OSD's on a healthy decode."""
    h, p = CODE5.hx, 0.08
    rng = np.random.default_rng(4)
    e = (rng.random((64, h.shape[1])) < p).astype(np.uint8)
    synd = (e @ h.T % 2).astype(np.uint8)
    dec = _bposd(h, p)
    assert np.array_equal(dec.decode_batch(synd),
                          _bposd(h, p, device_osd=False).decode_batch(synd))
    shots0 = tosd.osd_postprocess.shots

    def broken(_s):
        raise error

    dec.decode_batch_device = broken
    with pytest.raises(type(error)):
        dec.decode_batch(synd)
    assert tosd.osd_postprocess.shots == shots0


def test_data_and_phenom_engines_refuse_host_decoders():
    p = 0.05
    dx, dz = (_bposd(h, p, device_osd=False) for h in (CODE.hz, CODE.hx))
    sim = CodeSimulator_DataError(code=CODE, decoder_x=dx, decoder_z=dz,
                                  pauli_error_probs=[p / 3] * 3,
                                  batch_size=64, device="cpu")
    with pytest.raises(ValueError, match="host-OSD"):
        sim.WordErrorRate(64)
    ext = lambda h: np.hstack([h, np.eye(h.shape[0], dtype=np.uint8)])  # noqa
    d1 = [tdec.BPDecoder(ext(h), np.full(CODE.N + h.shape[0], p), 4,
                         device="cpu") for h in (CODE.hz, CODE.hx)]
    ph = CodeSimulator_Phenon(code=CODE, decoder1_x=d1[0], decoder1_z=d1[1],
                              decoder2_x=dx, decoder2_z=dz,
                              pauli_error_probs=[p / 3] * 3, q=p,
                              batch_size=64, device="cpu")
    with pytest.raises(ValueError, match="host-OSD"):
        ph.WordErrorRate(2, 64)


def _band(f_t, f_j, n_t, n_j):
    sigma = np.sqrt(f_t * (1 - f_t) / n_t + f_j * (1 - f_j) / n_j)
    assert abs(f_t - f_j) <= 4 * sigma, (f_t, f_j, sigma)


def _ep(p):
    return {"p_i": 0.0, "p_state_p": 0.0, "p_m": 0.0, "p_CX": p,
            "p_idling_gate": 0.0}


def _circuit_pair(device_osd, p=0.01, cycles=4):
    ext = np.hstack([CODE.hx, np.eye(CODE.hx.shape[0], dtype=np.uint8)])
    d1 = tdec.BP_Decoder_Class(30, "minimum_sum", 0.625,
                               device="cpu").GetDecoder(
        {"h": ext, "p_data": p, "p_syndrome": p})
    d2 = tdec.BPOSD_Decoder_Class(10, "minimum_sum", 0.625, "osd_e", 10,
                                  device="cpu", device_osd=device_osd
                                  ).GetDecoder({"h": CODE.hx, "p_data": p})
    return CodeSimulator_Circuit(code=hgp(rep_code(3), rep_code(3)),
                                 decoder1_z=d1, decoder2_z=d2, p=p,
                                 num_cycles=cycles, error_params=_ep(p),
                                 batch_size=256, device="cpu")


def test_circuit_host_osd_within_binomial_of_jax_windowed_path():
    shots = 2048
    host = _circuit_pair(False)
    host.WordErrorRate(shots, key=(0, 9))
    dev = _circuit_pair(True)
    dev.WordErrorRate(shots, key=(0, 9))
    assert abs(host.last_failures - dev.last_failures) <= 2
    assert host.last_shots == shots and host.last_failures > 0
    jc = jhgp(jrep(3), jrep(3))
    ext = np.hstack([jc.hx, np.eye(jc.hx.shape[0], dtype=np.uint8)])
    j1 = jdec.BP_Decoder_Class(30, "minimum_sum", 0.625).GetDecoder(
        {"h": ext, "p_data": 0.01, "p_syndrome": 0.01})
    j2 = jdec.BPOSD_Decoder_Class(10, "minimum_sum", 0.625, "osd_e",
                                  10).GetDecoder({"h": jc.hx, "p_data": 0.01})
    j2.device_osd = False
    js = jsc.CodeSimulator_Circuit(code=jc, decoder1_z=j1, decoder2_z=j2,
                                   p=0.01, num_cycles=4,
                                   error_params=_ep(0.01), batch_size=256)
    count, total = js._count_failures(shots, key=jax.random.PRNGKey(9))
    _band(host.last_failures / shots, count / total, shots, total)


def test_circuit_host_path_drain_fault_retries_bit_for_bit():
    clean = _circuit_pair(False)
    clean.WordErrorRate(768, key=(0, 4))
    plan = faultinject.FaultPlan([
        faultinject.Fault(site="windowed_drain", kind="raise", after=1),
        faultinject.Fault(site="windowed_launch", kind="raise", after=2)])
    pol = resilience.RetryPolicy(max_attempts=3, base_delay=0.0, jitter=0.0,
                                 reset_caches=False)
    sim = _circuit_pair(False)
    with resilience.policy_override(pol), plan.active():
        sim.WordErrorRate(768, key=(0, 4))
    assert plan.hits("windowed_drain") >= 2
    assert sim.last_failures == clean.last_failures


def test_circuit_spacetime_host_osd_within_binomial_of_jax():
    p, shots = 0.01, 1024
    ts = CodeSimulator_Circuit_SpaceTime(
        code=hgp(rep_code(3), rep_code(3)), p=p, num_cycles=7, num_rep=3,
        error_params=_ep(p), batch_size=128, device="cpu")
    js = jcst.CodeSimulator_Circuit_SpaceTime(
        code=jhgp(jrep(3), jrep(3)), p=p, num_cycles=7, num_rep=3,
        error_params=_ep(p), batch_size=128)
    for s in (ts, js):
        s._generate_circuit()
        s._generate_circuit_graph()

    def decoders(pkg, g, code_h, osd_kw=(), **kw):
        d1 = pkg.ST_BP_Decoder_Circuit_Class(1, "minimum_sum", 0.625,
                                             **kw).GetDecoder(
            {"h": g["h1"], "code_h": code_h, "channel_probs": g["channel_ps1"]})
        d2 = pkg.ST_BPOSD_Decoder_Circuit_Class(
            1, "minimum_sum", 0.625, "osd_e", 10, **kw, **dict(osd_kw)
        ).GetDecoder({"h": g["h2"], "code_h": code_h,
                      "channel_probs": g["channel_ps2"]})
        return d1, d2

    ts.decoder1_z, ts.decoder2_z = decoders(
        tdec, ts.circuit_graph, ts.eval_code.hx,
        osd_kw={"device_osd": False}, device="cpu")
    assert ts.decoder2_z.needs_host_postprocess
    ts.WordErrorRate(shots, key=(0, 2))
    host_failures = ts.last_failures
    ts.decoder2_z = decoders(tdec, ts.circuit_graph, ts.eval_code.hx,
                             device="cpu")[1]
    ts.WordErrorRate(shots, key=(0, 2))
    assert abs(host_failures - ts.last_failures) <= 2
    js.decoder1_z, js.decoder2_z = decoders(jdec, js.circuit_graph,
                                            js.eval_code.hx)
    js.decoder2_z.device_osd = False
    count, total = js._count_failures(shots, key=jax.random.PRNGKey(2))
    _band(host_failures / shots, count / total, shots, total)


def test_phenom_spacetime_host_osd_equals_its_device_run_on_same_draws():
    p = 0.02
    st = tdec.ST_BP_Decoder_Class(30, "minimum_sum", 0.625, device="cpu")
    d1 = [st.GetDecoder({"h": h, "p_data": p, "p_syndrome": p, "num_rep": 3})
          for h in (CODE.hz, CODE.hx)]

    def run(device_osd):
        c2 = tdec.BPOSD_Decoder_Class(10, "minimum_sum", 0.625, "osd_e", 10,
                                      device="cpu", device_osd=device_osd)
        d2 = [c2.GetDecoder({"h": h, "p_data": p})
              for h in (CODE.hz, CODE.hx)]
        sim = CodeSimulator_Phenon_SpaceTime(
            code=CODE, decoder1_x=d1[0], decoder1_z=d1[1], decoder2_x=d2[0],
            decoder2_z=d2[1], pauli_error_probs=[p / 3] * 3, q=p, num_rep=3,
            batch_size=128, device="cpu")
        sim.WordErrorRate(7, 1024, key=(0, 6))
        return sim.last_failures, sim.last_shots

    host, dev = run(False), run(True)
    assert host[1] == dev[1] == 1024 and host[0] > 0
    assert abs(host[0] - dev[0]) <= 2

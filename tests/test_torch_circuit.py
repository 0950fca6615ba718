"""The port's circuit layer (``circuits/``) and circuit-level engine
(``sim/circuit.py``) against the JAX package, on the CPU.

  * ``build_memory_circuit`` text equal to JAX's (plain and space-time
    layouts, ``final_ancilla_compare`` both ways); ``compile_circuit``'s
    segments and ops, the three schedulers (``coloration_hk`` needs
    networkx, present here) and the ``error_plugin`` rewrites equal.
  * ``detector_error_model`` text and the fault hypergraphs equal on a d3
    surface circuit.
  * Gate propagation (CX, CZ, H, R) on random frames equal to JAX's
    ``_apply_gate``, exactly.
  * ``FrameSampler`` detectors and observables equal to JAX's
    ``FrameSampler.sample(key, shots)`` bit for bit, fed JAX's own uniforms
    through the sampler's seam (``sample_with``), on circuits that hold
    every op kind.
  * The per-round decode on given detectors: failure count equal to JAX's
    ``_batch_count_given``.
  * Engine WER within 4 combined binomial sigma of JAX's
    ``CodeSimulator_Circuit`` (the two draw from different generators) on
    d3 surface and an hgp_34_n225 cell.
  * The ``"X"`` in-place swap, p = 0 gives no failure, reproducibility,
    ``run_batch`` / ``_single_run``, and no card raises.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import qldpc_fault_tolerance_tpu.circuits as jcirc
import qldpc_fault_tolerance_tpu.decoders as jdec
import qldpc_fault_tolerance_tpu.sim.circuit as jsc
from qldpc_fault_tolerance_tpu.circuits import sampler as jsampler
from qldpc_fault_tolerance_tpu.circuits.lowering import \
    compile_circuit as jax_compile
from qldpc_fault_tolerance_tpu.codes import hgp as jhgp
from qldpc_fault_tolerance_tpu.codes import load_code as jload
from qldpc_fault_tolerance_tpu.codes import rep_code as jrep
from qldpc_fault_tolerance_tpu_torch import circuits as tcirc
from qldpc_fault_tolerance_tpu_torch import decoders as tdec
from qldpc_fault_tolerance_tpu_torch.circuits import sampler as tsampler
from qldpc_fault_tolerance_tpu_torch.circuits.lowering import compile_circuit
from qldpc_fault_tolerance_tpu_torch.codes import hgp, load_code, rep_code
from qldpc_fault_tolerance_tpu_torch.sim import (
    CodeSimulator_Circuit,
    build_memory_circuit,
)
from qldpc_fault_tolerance_tpu_torch.sim.common import wer_per_cycle

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _code(pkg, name):
    """A fresh code object (the "X" swap mutates it) of either package."""
    if name == "surface_d3":
        return (hgp(rep_code(3), rep_code(3)) if pkg == "torch"
                else jhgp(jrep(3), jrep(3)))
    path = os.path.join(REPO, "codes_lib_tpu", f"{name}.npz")
    return load_code(path) if pkg == "torch" else jload(path)


def _error_params(p_cx, rest=0.0):
    return {"p_i": rest, "p_state_p": rest, "p_m": rest, "p_CX": p_cx,
            "p_idling_gate": rest}


LAYOUTS = {
    "plain": dict(num_cycles=4),
    "plain_no_compare": dict(num_cycles=3, final_ancilla_compare=False),
    "spacetime": dict(num_cycles=5, spacetime=True, num_rep=2, num_rounds=2),
    "spacetime_compare": dict(num_cycles=5, spacetime=True, num_rep=3,
                              num_rounds=1, final_ancilla_compare=True),
}


def _circuits(layout, rest=0.01, name="surface_d3"):
    """The same memory circuit built by both packages."""
    kw = dict(LAYOUTS[layout])
    num_cycles = kw.pop("num_cycles")
    tc, jc = _code("torch", name), _code("jax", name)
    ep = _error_params(0.02, rest)
    t = build_memory_circuit(tc, num_cycles, ep,
                             tcirc.ColorationCircuit(tc.hx),
                             tcirc.ColorationCircuit(tc.hz), **kw)
    j = jsc.build_memory_circuit(jc, num_cycles, ep,
                                 jcirc.ColorationCircuit(jc.hx),
                                 jcirc.ColorationCircuit(jc.hz), **kw)
    return t, j


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_memory_circuit_text_matches_jax(layout):
    t, j = _circuits(layout)
    assert str(t) == str(j)
    assert (t.num_qubits, t.num_measurements, t.num_detectors,
            t.num_observables) == (j.num_qubits, j.num_measurements,
                                   j.num_detectors, j.num_observables)
    # the text round-trips through the port's parser
    assert str(tcirc.Circuit(str(j))) == str(j)


def _op_fields(op):
    return (op.kind, None if op.a is None else op.a.tolist(),
            None if op.b is None else op.b.tolist(), op.p, op.basis,
            None if op.rec is None else op.rec.tolist(), op.reset_after,
            op.collapse, op.fx, op.fz, op.noise_id)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_compiled_segments_and_ops_match_jax(layout):
    t, j = _circuits(layout)
    tc, jc = compile_circuit(t), jax_compile(j)
    assert (tc.num_qubits, tc.num_measurements, tc.num_detectors,
            tc.num_observables) == (jc.num_qubits, jc.num_measurements,
                                    jc.num_detectors, jc.num_observables)
    assert tc.det_cols == jc.det_cols and tc.obs_cols == jc.obs_cols
    assert tc.coord_events == jc.coord_events
    assert tc.structure_key() == jc.structure_key()
    assert len(tc.segments) == len(jc.segments)
    for ts, js in zip(tc.segments, jc.segments):
        assert (ts.kind, ts.repeat_count, ts.meas_per_iter,
                ts.rec_offset) == (js.kind, js.repeat_count,
                                   js.meas_per_iter, js.rec_offset)
        assert [_op_fields(o) for o in ts.ops] == [_op_fields(o)
                                                   for o in js.ops]


@pytest.mark.parametrize("name", ["surface_d3", "hgp_34_n225"])
@pytest.mark.parametrize("scheduler", ["ColorationCircuit",
                                       "ColorationCircuitHK", "RandomCircuit"])
def test_schedulers_match_jax(name, scheduler):
    tc, jc = _code("torch", name), _code("jax", name)
    for th, jh in ((tc.hx, jc.hx), (tc.hz, jc.hz)):
        got = getattr(tcirc, scheduler)(th)
        assert got == getattr(jcirc, scheduler)(jh) and got
        if scheduler != "ColorationCircuitHK":  # HK pads irregular graphs
            tcirc.validate_schedule(th, got,
                                    require_disjoint_qubits=scheduler
                                    != "RandomCircuit")


def test_error_plugin_rewrites_match_jax():
    base = ("R 0 1 2 3\nCX 0 1 2 3\nCZ 1 2\nM 0 1\nMR 2 3\n"
            "REPEAT 2 {\n    CX 1 0\n    MR 0\n}")
    t, j = tcirc.Circuit(base), jcirc.Circuit(base)
    rewrites = [
        ("AddCXError", ("DEPOLARIZE2(0.01)",)),
        ("AddCZError", ("DEPOLARIZE2(0.02)",)),
        ("AddMeasurementError", (0.003,)),
        ("AddResetError", (0.004,)),
        ("AddIdlingError", ("DEPOLARIZE1(0.005)", [1, 3])),
        ("AddIdlingError", ("DEPOLARIZE1(0.005)", [])),
        ("AddSingleQubitErrorBeforeRound", ("X_ERROR(0.006)", [0, 2])),
    ]
    for name, args in rewrites:
        got = str(getattr(tcirc, name)(t, *args))
        assert got == str(getattr(jcirc, name)(j, *args)), name
        assert got != base or not args[-1], name


def test_detector_error_model_matches_jax():
    t, j = _circuits("spacetime", rest=0.005)
    td, jd = tcirc.detector_error_model(t), jcirc.detector_error_model(j)
    assert str(td) == str(jd) and len(td.errors) > 10
    assert str(t.detector_error_model()) == str(td)
    text = str(jd)
    for got, want in zip(
            tcirc.GenFaultHyperGraph(text, num_rounds=2, num_rep=2,
                                     num_logicals=1),
            jcirc.GenFaultHyperGraph(text, num_rounds=2, num_rep=2,
                                     num_logicals=1)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert np.array_equal(np.asarray(a), np.asarray(b))
    m = _code("torch", "surface_d3").hx.shape[0]
    assert np.array_equal(
        tcirc.GenCorrecHyperGraph(text, 2, 2, m, 1),
        jcirc.GenCorrecHyperGraph(text, 2, 2, m, 1))


# gate ops with fused pairs: one control driving several targets (later
# rounds of _pairmap), CZ pairs, H and R
GATES = ("CX 0 5 1 6 2 7\nCX 0 8\nCX 3 9 4 10\nTICK\nCZ 1 7 2 8 3 6\n"
         "H 0 4 9\nR 2 10\nCX 9 0 9 1 9 2\nM 0")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gate_propagation_on_random_frames_matches_jax(seed):
    tc, jc = compile_circuit(tcirc.Circuit(GATES)), jax_compile(
        jcirc.Circuit(GATES))
    nq = tc.num_qubits
    rng = np.random.default_rng(seed)
    x = (rng.random((64, nq)) < 0.5).astype(np.uint8)
    z = (rng.random((64, nq)) < 0.5).astype(np.uint8)
    tx, tz = torch.from_numpy(x), torch.from_numpy(z)
    jx, jz = jnp.asarray(x), jnp.asarray(z)
    kinds = set()
    for top, jop in zip((o for s in tc.segments for o in s.ops),
                        (o for s in jc.segments for o in s.ops)):
        if top.kind not in ("cx", "cz", "h", "reset"):
            continue
        kinds.add(top.kind)
        tx, tz = tsampler._gate(tsampler._Plan(top, nq, "cpu"), tx, tz)
        jx, jz = jsampler._apply_gate(jop, jx, jz)
        assert np.array_equal(tx.numpy(), np.asarray(jx)), top.kind
        assert np.array_equal(tz.numpy(), np.asarray(jz)), top.kind
    assert kinds == {"cx", "cz", "h", "reset"}
    # a fused op with several rounds was exercised
    assert any(len(tsampler._pairmap(tuple(o.a.tolist()), tuple(
        o.b.tolist()), nq)) > 1 for s in tc.segments for o in s.ops
        if o.kind == "cx")


# every op kind: R, RX, H, CX, CZ, M, MR, MX, X/Y/Z_ERROR, DEPOLARIZE1/2,
# and a REPEAT block
ALL_OPS = """R 0 1 2 3
RX 4 5
H 0
DEPOLARIZE1(0.2) 0 1 2 3 4 5
CX 0 1 2 3
DEPOLARIZE2(0.3) 0 1 2 3
CZ 4 5
X_ERROR(0.1) 1
Y_ERROR(0.15) 2
Z_ERROR(0.25) 4
REPEAT 3 {
    CX 0 2 1 3
    DEPOLARIZE2(0.1) 0 2 1 3
    M 2
    MR 3
    MX 5
    DETECTOR rec[-3]
    DETECTOR rec[-2] rec[-5]
    DETECTOR rec[-1]
}
H 1
M 0 1 4
DETECTOR rec[-1] rec[-2]
DETECTOR rec[-3] rec[-4] rec[-6]
OBSERVABLE_INCLUDE(0) rec[-3]
OBSERVABLE_INCLUDE(1) rec[-1] rec[-2]"""


# fused measurements whose record columns are not contiguous (M 0 and M 2
# merge past the MX between them)
SPLIT_RECORD = """R 0 1 2 3
X_ERROR(0.3) 0 1 2 3
Z_ERROR(0.4) 1
M 0
MX 1
M 2
DETECTOR rec[-1] rec[-3]
DETECTOR rec[-2]
OBSERVABLE_INCLUDE(0) rec[-3]"""
TEXT_CIRCUITS = {"all_ops": ALL_OPS, "split_record": SPLIT_RECORD}


def _jax_uniform(key):
    """The seam fed with the JAX sampler's own uniforms."""
    def uniform(si, it, nid, shape):
        k = jax.random.fold_in(key, si)
        if it is not None:
            k = jax.random.fold_in(k, it)
        k = jax.random.fold_in(k, nid)
        return torch.from_numpy(np.array(jax.random.uniform(k, shape)))
    return uniform


@pytest.mark.parametrize("circuit", ["all_ops", "split_record", "plain",
                                     "spacetime"])
def test_frame_sampler_matches_jax_bit_for_bit(circuit):
    if circuit in TEXT_CIRCUITS:
        text = TEXT_CIRCUITS[circuit]
        t, j = tcirc.Circuit(text), jcirc.Circuit(text)
    else:
        t, j = _circuits(circuit, rest=0.02)
    key, shots = jax.random.PRNGKey(len(circuit)), 200
    jd, jo = jcirc.FrameSampler(j).sample(key, shots)
    ts = tcirc.FrameSampler(t, device="cpu")
    td, to = ts.sample_with(_jax_uniform(key), shots)
    assert td.dtype == torch.uint8 and td.shape == (shots, ts.num_detectors)
    assert to.shape == (shots, ts.num_observables)
    assert np.array_equal(td.numpy(), np.asarray(jd))
    assert np.array_equal(to.numpy(), np.asarray(jo))
    assert 0 < float(td.float().mean()) < 1
    if circuit == "split_record":
        assert any(p.rec is not None for _, plans in ts._segments
                   for p in plans if p.op.kind == "measure")


def test_frame_sampler_generator_path():
    t = tcirc.Circuit(ALL_OPS)
    s = tcirc.FrameSampler(t, device="cpu")
    a = s.sample(7, 500)
    b = s.sample((0, 7), 500)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert not torch.equal(a[0], s.sample(8, 500)[0])
    both = s.sample_np(7, 500, append_observables=True)
    assert both.shape == (500, s.num_detectors + s.num_observables)
    assert np.array_equal(both[:, :s.num_detectors], a[0].numpy())
    assert np.array_equal(s.sample_np(7, 500), a[0].numpy())
    # one uniform plane per noise op and per collapsing measurement
    drawn = []
    s.sample_with(lambda si, it, nid, shape: drawn.append((si, it, nid))
                  or torch.rand(shape), 4)
    randoms = sum(o.is_random for seg in s.compiled.segments for o in seg.ops
                  for _ in range(seg.repeat_count))
    assert len(drawn) == randoms and s.num_noise_ops == 6


def _decoders(pkg, code, p, **kw):
    ext = np.hstack([code.hx, np.eye(code.hx.shape[0], dtype=np.uint8)])
    d1 = pkg.BP_Decoder_Class(30, "minimum_sum", 0.625, **kw).GetDecoder(
        {"h": ext, "p_data": p, "p_syndrome": p})
    d2 = pkg.BPOSD_Decoder_Class(10, "minimum_sum", 0.625, "osd_e", 10,
                                 **kw).GetDecoder({"h": code.hx, "p_data": p})
    return d1, d2


def _sims(name, p, num_cycles, batch, **kw):
    """The port's and JAX's engines on the same cell (the JAX family's
    _circuit_wer cell: CX-only depolarizing noise, coloration schedule)."""
    tc, jc = _code("torch", name), _code("jax", name)
    t1, t2 = _decoders(tdec, tc, p, device="cpu")
    j1, j2 = _decoders(jdec, jc, p)
    ts = CodeSimulator_Circuit(code=tc, decoder1_z=t1, decoder2_z=t2, p=p,
                               num_cycles=num_cycles,
                               error_params=_error_params(p),
                               batch_size=batch, device="cpu", **kw)
    js = jsc.CodeSimulator_Circuit(code=jc, decoder1_z=j1, decoder2_z=j2,
                                   p=p, num_cycles=num_cycles,
                                   error_params=_error_params(p),
                                   batch_size=batch, **kw)
    return ts, js


@pytest.mark.parametrize("name,p,cycles", [("surface_d3", 0.02, 4),
                                           ("hgp_34_n225", 0.004, 3)])
def test_per_round_decode_on_given_detectors_matches_jax(name, p, cycles):
    B = 256
    ts, js = _sims(name, p, cycles, B)
    js._generate_circuit()
    ts._ensure_circuit()
    assert str(ts.circuit) == str(js.circuit)
    dets, obs = js._sampler.sample(jax.random.PRNGKey(5), B)
    want = int(jsc._batch_count_given(js._cfg(B), js._dev_state, dets, obs))
    assert 0 < want < B
    assert int(ts._count_given(np.asarray(dets), np.asarray(obs))) == want


def _failure_fraction_band(f_t, f_j, shots_t, shots_j):
    sigma = np.sqrt(f_t * (1 - f_t) / shots_t + f_j * (1 - f_j) / shots_j)
    assert abs(f_t - f_j) <= 4 * sigma, (f_t, f_j, sigma)


@pytest.mark.parametrize("name,p,cycles,shots", [
    ("surface_d3", 0.01, 4, 2048), ("hgp_34_n225", 0.004, 3, 768)])
def test_engine_wer_matches_jax_engine(name, p, cycles, shots):
    ts, js = _sims(name, p, cycles, 256, seed=3)
    wer, eb = ts.WordErrorRate(shots)
    assert ts.last_shots == shots and 0 < wer < 1 and eb > 0
    assert (wer, eb) == wer_per_cycle(ts.last_failures, shots, ts.K, cycles)
    assert ts.last_host_reads == ts.last_megabatches == -(-shots // 1024)
    count, total = js._count_failures(shots)
    assert total == shots and 0.02 < count / total < 0.98
    _failure_fraction_band(ts.last_failures / shots, count / total, shots,
                           total)


def test_x_swap_quirk_zero_noise_and_run_batch():
    tc = _code("torch", "surface_d3")
    hx, lx = tc.hx.copy(), tc.lx.copy()
    ext = np.hstack([tc.hz, np.eye(tc.hz.shape[0], dtype=np.uint8)])
    dx1 = tdec.BP_Decoder_Class(30, "minimum_sum", 0.625,
                                device="cpu").GetDecoder(
        {"h": ext, "p_data": 0.01, "p_syndrome": 0.01})
    dx2 = tdec.BPOSD_Decoder_Class(10, "minimum_sum", 0.625, "osd_e", 10,
                                   device="cpu").GetDecoder(
        {"h": tc.hz, "p_data": 0.01})
    sim = CodeSimulator_Circuit(code=tc, decoder1_x=dx1, decoder2_x=dx2,
                                pz=0.0, num_cycles=3,
                                error_params=_error_params(0.0),
                                eval_logical_type="X", batch_size=64,
                                device="cpu")
    # the shared code object is swapped in place; the X decoders are taken
    assert np.array_equal(tc.hz, hx) and np.array_equal(tc.lz, lx)
    assert sim.decoder1_z is dx1 and sim.decoder2_z is dx2
    assert sim.pz == sim.synd_prob == 0.0
    wer, eb = sim.WordErrorRate(128)
    assert (sim.last_failures, wer) == (0, 0.0)
    assert sim.min_logical_weight == sim.N
    flags = sim.run_batch((1, 2))
    assert flags.shape == (64,) and not flags.any()
    assert sim._single_run() == 0


def test_runs_are_reproducible_and_run_batch_is_batch_zero():
    ts, _ = _sims("surface_d3", 0.03, 3, 64, seed=4)
    key = (9, 1)
    a = ts.WordErrorRate(64, key=key)
    flags = ts.run_batch(key)
    assert int(flags.sum()) == ts.last_failures > 0
    assert ts.WordErrorRate(64, key=key) == a
    assert ts.run_batch(key, batch_size=5).shape == (5,)
    before = ts._base_key
    assert ts._single_run() in (0, 1) and ts._base_key != before
    with pytest.raises(ValueError, match="circuit_type"):
        _sims("surface_d3", 0.03, 3, 64, circuit_type="bogus")


def test_entry_points_raise_without_card_or_cpu_request(monkeypatch):
    tc = _code("torch", "surface_d3")
    t1, t2 = _decoders(tdec, tc, 0.01, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CodeSimulator_Circuit(code=tc, decoder1_z=t1, decoder2_z=t2, p=0.01,
                              num_cycles=3, error_params=_error_params(0.01))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcirc.FrameSampler(tcirc.Circuit(ALL_OPS))

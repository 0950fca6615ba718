"""The port's circuit-level space-time engine (``sim/circuit_spacetime.py``)
and its decoders against the JAX package, on the CPU.

  * The main and fault circuits, the detector error model's decoding
    graphs (``h1``, ``L1``, ``channel_ps1``, ``h2``, ``L2``,
    ``channel_ps2``) and ``h1_space_cor`` equal JAX's bit for bit, and the
    port's sampler fed JAX's uniforms gives JAX's detectors, on the d3
    surface code and hgp_34_n225.
  * Given JAX's detectors, the window scan's carry, final syndrome, final
    correction and per-shot flags equal JAX's ``_windows_decode`` /
    ``_check``.  Tolerance: bit-exact, except for shots where a window or
    final decode's float32 posterior has |LLR| < 1e-3 in JAX's (the
    near-tie bound of tests/test_torch_bp.py: summation order may flip a
    hard decision there), at most 1% of the shots, counted and listed in
    the assertion message; none has been seen.
  * The decoder factories' quirks (``max_iter`` from ``code_h``'s width;
    ``int`` in the BP class, unrounded in the BPOSD class) and statics.
  * The p_CX = 0 sampler and the noiseless sampler draw all-zero detectors;
    the noiseless anchor fails no shot.
  * Engine WER within 4 combined binomial sigma of JAX's engine (the two
    draw from different generators).
  * ``WordErrorRate_TargetFailure``, ``run_batch`` / ``_single_run``, the
    ``"X"`` swap, the ``pz`` alias and the empty-DEM ``ValueError``.
"""
import functools
import os

import numpy as np
import pytest
import torch

import jax

import qldpc_fault_tolerance_tpu.decoders as jdec
import qldpc_fault_tolerance_tpu.sim.circuit_spacetime as jcst
from qldpc_fault_tolerance_tpu.codes import hgp as jhgp
from qldpc_fault_tolerance_tpu.codes import load_code as jload
from qldpc_fault_tolerance_tpu.codes import rep_code as jrep
from qldpc_fault_tolerance_tpu.decoders.bp_decoders import \
    decode_device as jax_decode_device
from qldpc_fault_tolerance_tpu_torch import decoders as tdec
from qldpc_fault_tolerance_tpu_torch.codes import hgp, load_code, rep_code
from qldpc_fault_tolerance_tpu_torch.sim import CodeSimulator_Circuit_SpaceTime
from qldpc_fault_tolerance_tpu_torch.sim.common import wer_per_cycle

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the near-tie bound of tests/test_torch_bp.py
TIE = 1e-3
# (p_CX, num_cycles, num_rep, max_iter ratio) of each code's cell; at n225
# a window decode runs n / 10 iterations at most, which keeps it short
CELLS = {"surface_d3": (0.01, 7, 3, 1), "hgp_34_n225": (0.004, 7, 3, 10)}


def _code(pkg, name):
    """A fresh code object (the "X" swap mutates it) of either package."""
    if name == "surface_d3":
        return (hgp(rep_code(3), rep_code(3)) if pkg == "torch"
                else jhgp(jrep(3), jrep(3)))
    path = os.path.join(REPO, "codes_lib_tpu", f"{name}.npz")
    return load_code(path) if pkg == "torch" else jload(path)


def _ep(p_cx):
    return {"p_i": 0.0, "p_state_p": 0.0, "p_m": 0.0, "p_CX": p_cx,
            "p_idling_gate": 0.0}


def _decoders(pkg, g, code_h, ratio, **kw):
    """SpaceTimeDecodingDemo's decoders: BP on h1, BP + OSD-E 10 on h2."""
    d1 = pkg.ST_BP_Decoder_Circuit_Class(ratio, "minimum_sum", 0.625,
                                         **kw).GetDecoder(
        {"h": g["h1"], "code_h": code_h, "channel_probs": g["channel_ps1"]})
    d2 = pkg.ST_BPOSD_Decoder_Circuit_Class(ratio, "minimum_sum", 0.625,
                                            "osd_e", 10, **kw).GetDecoder(
        {"h": g["h2"], "code_h": code_h, "channel_probs": g["channel_ps2"]})
    return d1, d2


@functools.lru_cache(maxsize=None)
def _pair(name, seed=0):
    """The port's and JAX's engines on one cell, graphs built, decoders
    assigned after construction as the demo does."""
    p, cycles, num_rep, ratio = CELLS[name]
    tc, jc = _code("torch", name), _code("jax", name)
    ts = CodeSimulator_Circuit_SpaceTime(
        code=tc, p=p, num_cycles=cycles, num_rep=num_rep, error_params=_ep(p),
        batch_size=128, seed=seed, device="cpu")
    js = jcst.CodeSimulator_Circuit_SpaceTime(
        code=jc, p=p, num_cycles=cycles, num_rep=num_rep, error_params=_ep(p),
        batch_size=128, seed=seed)
    for s in (ts, js):
        s._generate_circuit()
        s._generate_circuit_graph()
    ts.decoder1_z, ts.decoder2_z = _decoders(tdec, ts.circuit_graph, tc.hx,
                                             ratio, device="cpu")
    js.decoder1_z, js.decoder2_z = _decoders(jdec, js.circuit_graph, jc.hx,
                                             ratio)
    return ts, js


def _jax_uniform(key):
    """The sampler's seam fed with the JAX sampler's own uniforms."""
    def uniform(si, it, nid, shape):
        k = jax.random.fold_in(key, si)
        if it is not None:
            k = jax.random.fold_in(k, it)
        k = jax.random.fold_in(k, nid)
        return torch.from_numpy(np.array(jax.random.uniform(k, shape)))
    return uniform


@pytest.mark.parametrize("name", sorted(CELLS))
def test_circuits_and_decoding_graphs_match_jax(name):
    ts, js = _pair(name)
    assert str(ts.circuit) == str(js.circuit)
    assert str(ts.fault_circuit) == str(js.fault_circuit)
    assert ts.num_rounds == js.num_rounds == 2
    for k in ("h1", "L1", "h2", "L2"):
        a, b = ts.circuit_graph[k], js.circuit_graph[k]
        assert a.shape == b.shape and np.array_equal(a, b), k
    for k in ("channel_ps1", "channel_ps2"):
        assert ts.circuit_graph[k] == js.circuit_graph[k], k
    assert np.array_equal(ts.h1_space_cor, js.h1_space_cor)
    h1, h2 = ts.circuit_graph["h1"], ts.circuit_graph["h2"]
    m = ts.num_checks
    assert h1.shape[0] == ts.num_rep * m and h2.shape[0] == m
    assert ts.h1_space_cor.shape == (m, h1.shape[1])
    if name == "hgp_34_n225":  # the wide rows the min-sum kernels must take
        assert (int(h1.sum(1).max()), int(h2.sum(1).max())) == (61, 42)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_detectors_match_jax_bit_for_bit(name):
    ts, js = _pair(name)
    key, shots = jax.random.PRNGKey(3), 96
    jd, jo = js.detector_sampler.sample(key, shots)
    td, to = ts.detector_sampler.sample_with(_jax_uniform(key), shots)
    assert td.shape == (shots, ts.num_cycles * ts.num_checks)
    assert np.array_equal(td.numpy(), np.asarray(jd))
    assert np.array_equal(to.numpy(), np.asarray(jo))
    assert td.any()


def _jax_near_ties(js, dets):
    """Per shot: whether any of JAX's window or final decodes left a
    posterior with |LLR| < TIE (JAX's window scan, composed window by
    window from its ``_window_commit`` so the posteriors can be read)."""
    state, B, m = js._dev_state, dets.shape[0], js.num_checks
    hist = dets.reshape(B, js.num_cycles, m)
    carry = (jax.numpy.zeros((B, m), jax.numpy.uint8),
             jax.numpy.zeros((B, js.num_logicals), jax.numpy.uint8))
    tie = np.zeros(B, bool)
    d1, d2 = js.decoder1_z, js.decoder2_z
    for j in range(js.num_rounds):
        syn = hist[:, j * js.num_rep:(j + 1) * js.num_rep].reshape(B, -1)
        syn = syn.at[:, :m].set(syn[:, :m] ^ carry[0])
        _, aux = jax_decode_device(d1.device_static, state["d1"], syn)
        tie |= (np.abs(np.asarray(aux["posterior_llr"])) < TIE).any(axis=1)
        carry, _ = jcst._window_commit(state, m, d1.device_static, carry,
                                       hist[:, j * js.num_rep:(j + 1)
                                            * js.num_rep].reshape(B, -1))
    _, aux = jax_decode_device(d2.device_static, state["d2"],
                               hist[:, -1] ^ carry[0])
    tie |= (np.abs(np.asarray(aux["posterior_llr"])) < TIE).any(axis=1)
    return tie


@pytest.mark.parametrize("name", sorted(CELLS))
def test_window_scan_on_given_detectors_matches_jax(name):
    ts, js = _pair(name)
    key, B = jax.random.PRNGKey(11), 128
    cfg, state = js._cfg(B), js._dev_state
    want = jcst._windows_decode(cfg, state, key)
    dets, obs = cfg[6]._sample_impl(key, state["probs"], B)
    assert np.array_equal(np.asarray(obs), np.asarray(want[0]))
    want_flags = np.asarray(jcst._check(state, *want[:4]))
    decoded = ts._decode_given(np.asarray(dets))
    got = [t.numpy() for t in decoded]
    got_flags = ts._check(torch.from_numpy(np.array(obs, np.uint8)),
                          *decoded).numpy()
    differ = np.zeros(B, bool)
    for a, b in zip(got, want[1:4]):
        differ |= (a != np.asarray(b)).any(axis=1)
    differ |= got_flags != want_flags
    listed = np.flatnonzero(differ).tolist()
    if listed:
        ties = _jax_near_ties(js, dets)
        assert ties[differ].all() and differ.mean() <= 0.01, (
            f"shots {listed} differ; near-ties among them "
            f"{np.flatnonzero(differ & ties).tolist()}")
    assert 0 < want_flags.sum() < B or name == "hgp_34_n225"


def test_decoder_factories_keep_the_reference_quirks():
    ts, js = _pair("surface_d3")
    g, code_h = ts.circuit_graph, ts.eval_code.hx
    params = {"h": g["h1"], "code_h": code_h,
              "channel_probs": g["channel_ps1"]}
    for ratio in (1, 2.5, 7):
        tb = tdec.ST_BP_Decoder_Circuit_Class(
            ratio, "minimum_sum", 0.625, device="cpu").GetDecoder(params)
        jb = jdec.ST_BP_Decoder_Circuit_Class(
            ratio, "minimum_sum", 0.625).GetDecoder(params)
        assert isinstance(tb, tdec.ST_BP_Decoder_Circuit)
        assert tb.device_static == jb.device_static
        # the code's width, not the fault matrix's, over the ratio
        assert tb.max_iter == max(1, int(code_h.shape[1] / ratio))
        to = tdec.ST_BPOSD_Decoder_Circuit_Class(
            ratio, "minimum_sum", 0.625, "osd_e", 4,
            device="cpu").GetDecoder(params)
        jo = jdec.ST_BPOSD_Decoder_Circuit_Class(
            ratio, "minimum_sum", 0.625, "osd_e", 4).GetDecoder(params)
        assert isinstance(to, tdec.ST_BPOSD_Decoder_Circuit)
        assert to.device_static[1] == jo.device_static[1]
        assert to.device_static[0] == "bposd_dev"
        assert np.array_equal(to.channel_probs, np.asarray(
            g["channel_ps1"], np.float64))
    with pytest.raises(KeyError, match="code_h"):
        tdec.ST_BP_Decoder_Circuit_Class(1, "minimum_sum", 0.625,
                                         device="cpu").GetDecoder(
            {"h": g["h1"], "channel_probs": g["channel_ps1"]})


def test_zero_noise_samplers_draw_no_detector():
    tc = _code("torch", "surface_d3")
    s = CodeSimulator_Circuit_SpaceTime(code=tc, p=0.0, num_cycles=7,
                                        num_rep=3, error_params=_ep(0.0),
                                        batch_size=64, device="cpu")
    s._generate_circuit()
    dets, obs = s.detector_sampler.sample(5, 256)
    assert dets.shape == (256, 7 * s.num_checks)
    assert not dets.any() and not obs.any()
    ts, _ = _pair("surface_d3")
    quiet = ts.detector_sampler.without_noise()
    assert quiet.num_noise_ops == ts.detector_sampler.num_noise_ops
    dets, obs = quiet.sample(5, 256)
    assert not dets.any() and not obs.any()
    assert ts.detector_sampler.sample(5, 256)[0].any()


def test_noiseless_anchor_fails_no_shot():
    ts, _ = _pair("surface_d3")
    noisy = ts.detector_sampler
    ts.detector_sampler = noisy.without_noise()
    try:
        wer, eb = ts.WordErrorRate(256, key=(0, 9))
        assert (ts.last_failures, ts.last_shots, wer) == (0, 256, 0.0)
        assert not ts.run_batch((1, 2), 64).any()
    finally:
        ts.detector_sampler = noisy


def _band(f_t, f_j, shots_t, shots_j):
    sigma = np.sqrt(f_t * (1 - f_t) / shots_t + f_j * (1 - f_j) / shots_j)
    assert abs(f_t - f_j) <= 4 * sigma, (f_t, f_j, sigma)


def test_engine_wer_matches_jax_engine():
    ts, js = _pair("surface_d3", seed=4)
    shots = 1024
    wer, eb = ts.WordErrorRate(shots)
    assert ts.last_shots == shots and 0 < wer < 1 and eb > 0
    assert (wer, eb) == wer_per_cycle(ts.last_failures, shots, ts.K,
                                      ts.num_cycles)
    assert ts.last_host_reads == ts.last_megabatches == 2
    count, total = js._count_failures(shots)
    assert total == shots and 0.02 < count / total < 0.98
    _band(ts.last_failures / shots, count / total, shots, total)


def test_target_failure_run_batch_and_single_run():
    ts, _ = _pair("surface_d3")
    wer, total = ts.WordErrorRate_TargetFailure(5, 64, 40, key=(0, 3))
    assert total % 64 == 0 and 64 <= total <= 40 * 64
    assert ts.last_failures >= 5 or total == 40 * 64
    assert wer == wer_per_cycle(ts.last_failures, total, ts.K,
                                ts.num_cycles)[0]
    # reproducible from its key
    assert ts.WordErrorRate_TargetFailure(5, 64, 40, key=(0, 3)) == (wer,
                                                                     total)
    flags = ts.run_batch((1, 2), 64)
    assert flags.shape == (64,) and flags.dtype == bool
    assert np.array_equal(flags, ts.run_batch((1, 2), 64))
    assert ts._single_run() in (0, 1)


def test_x_swap_and_pz_alias():
    tc = _code("torch", "surface_d3")
    hx, lx = tc.hx.copy(), tc.lx.copy()
    sim = CodeSimulator_Circuit_SpaceTime(code=tc, pz=0.01, num_cycles=4,
                                          num_rep=3, error_params=_ep(0.01),
                                          eval_logical_type="X",
                                          device="cpu")
    # the shared code object is swapped in place
    assert np.array_equal(tc.hz, hx) and np.array_equal(tc.lz, lx)
    assert sim.pz == sim.synd_prob == 0.01 and sim.num_rounds == 1
    sim._generate_circuit()
    sim._generate_circuit_graph()
    g = sim.circuit_graph
    jc = _code("jax", "surface_d3")
    js = jcst.CodeSimulator_Circuit_SpaceTime(
        code=jc, pz=0.01, num_cycles=4, num_rep=3, error_params=_ep(0.01),
        eval_logical_type="X")
    js._generate_circuit()
    js._generate_circuit_graph()
    assert str(sim.circuit) == str(js.circuit)
    assert np.array_equal(g["h1"], js.circuit_graph["h1"])
    d1, d2 = _decoders(tdec, g, tc.hx, 1, device="cpu")
    x = CodeSimulator_Circuit_SpaceTime(code=tc, decoder1_x=d1, decoder2_x=d2,
                                        p=0.01, num_cycles=4, num_rep=3,
                                        error_params=_ep(0.01),
                                        eval_logical_type="X", device="cpu")
    assert x.decoder1_z is d1 and x.decoder2_z is d2
    # swapped back: a second "X" construction un-swaps
    assert not np.array_equal(tc.hz, hx) or np.array_equal(hx, tc.hx)


def test_empty_dem_raises_and_missing_decoders_raise():
    tc = _code("torch", "surface_d3")
    sim = CodeSimulator_Circuit_SpaceTime(code=tc, p=0.0, num_cycles=4,
                                          num_rep=3, error_params=_ep(0.0),
                                          device="cpu")
    with pytest.raises(ValueError, match="no fault mechanisms"):
        sim._generate_circuit_graph()
    noisy = CodeSimulator_Circuit_SpaceTime(code=tc, p=0.01, num_cycles=4,
                                            num_rep=3, error_params=_ep(0.01),
                                            device="cpu")
    with pytest.raises(ValueError, match="decoder1_z"):
        noisy.WordErrorRate(64)
    with pytest.raises(ValueError, match="num_cycles - 1"):
        CodeSimulator_Circuit_SpaceTime(code=tc, p=0.01, num_cycles=5,
                                        num_rep=3, error_params=_ep(0.01),
                                        device="cpu")

"""The port's streaming space-time drivers (``sim/stream_spacetime.py``)
against its batch engines and the JAX package's drivers, on the CPU.

  * ``st_round_counts`` / ``st_window_count`` re-exported, equal to JAX's.
  * Phenom streaming is bit-exact with the batch engine inside the port:
    after k steps the carry equals k windows of the engine's own pipeline
    on the same stream, and ``finalize`` equals ``run_batch(key, k + 1)``,
    for ``CodeSimulator_Phenon_SpaceTime`` (packed and dense) and
    ``CodeSimulator_Phenon`` (a window of one round).
  * Circuit streaming equals the port's batch window scan and JAX's
    ``CircuitStreamDriver`` on the same windows (JAX's detectors), bit for
    bit: carry, logical correction, final syndrome and final correction.
  * Each step under ``device_cond``'s both-branches hook (the contract a
    captured step needs) gives the eager step's carry.
  * A window of the wrong shape raises.
"""
import numpy as np
import pytest
import torch

import jax

import qldpc_fault_tolerance_tpu.decoders as jdec
import qldpc_fault_tolerance_tpu.sim as jsim
from qldpc_fault_tolerance_tpu.codes import hgp as jhgp
from qldpc_fault_tolerance_tpu.codes import rep_code as jrep
from qldpc_fault_tolerance_tpu_torch import decoders as tdec
from qldpc_fault_tolerance_tpu_torch.codes import hgp, rep_code
from qldpc_fault_tolerance_tpu_torch.ops.prng import key_words
from qldpc_fault_tolerance_tpu_torch.parallel.shots import batch_generator
from qldpc_fault_tolerance_tpu_torch.sim import (
    CircuitStreamDriver,
    CodeSimulator_Circuit_SpaceTime,
    CodeSimulator_Phenon,
    CodeSimulator_Phenon_SpaceTime,
    PhenomStreamDriver,
    st_round_counts,
    st_window_count,
)
from qldpc_fault_tolerance_tpu_torch.utils import device as tdevice

torch.set_num_threads(1)

CODE = hgp(rep_code(3), rep_code(3), name="hgp_rep3")


def test_window_count_helpers_match_jax():
    for cycles, rep in ((1, 2), (2, 2), (3, 2), (7, 3), (8, 3), (13, 3)):
        assert st_round_counts(cycles, rep) == jsim.st_round_counts(cycles,
                                                                    rep)
    for cycles, rep in ((7, 3), (201, 200), (13, 3)):
        assert st_window_count(cycles, rep) == jsim.st_window_count(cycles,
                                                                    rep)
    for cycles, rep in ((8, 3), (202, 200), (0, 2)):
        with pytest.raises(ValueError):
            st_window_count(cycles, rep)


def _phenom_sim(kind, packed=True, B=64, p=0.03):
    h_ext = {name: np.hstack([h, np.eye(h.shape[0], dtype=np.uint8)])
             for name, h in (("hx", CODE.hx), ("hz", CODE.hz))}
    d2 = [tdec.BPOSD_Decoder(h, np.full(CODE.N, p), 12, osd_order=4,
                             device="cpu") for h in (CODE.hz, CODE.hx)]
    if kind == "spacetime":
        d1 = [tdec.ST_BP_Decoder_syndrome(h, p, p, 12, num_rep=3,
                                          device="cpu")
              for h in (CODE.hz, CODE.hx)]
        return CodeSimulator_Phenon_SpaceTime(
            code=CODE, decoder1_x=d1[0], decoder1_z=d1[1], decoder2_x=d2[0],
            decoder2_z=d2[1], pauli_error_probs=[p / 3] * 3, q=p, num_rep=3,
            batch_size=B, device="cpu")
    probs = np.concatenate([np.full(CODE.N, p), np.full(CODE.hx.shape[0], p)])
    d1 = [tdec.BPDecoder(h_ext[s], probs, 12, device="cpu")
          for s in ("hz", "hx")]
    return CodeSimulator_Phenon(
        code=CODE, decoder1_x=d1[0], decoder1_z=d1[1], decoder2_x=d2[0],
        decoder2_z=d2[1], pauli_error_probs=[p / 3] * 3, q=p, batch_size=B,
        packed=packed, device="cpu")


@pytest.mark.parametrize("kind,packed", [("spacetime", True),
                                         ("spacetime", False),
                                         ("phenom", True)])
def test_phenom_stream_carry_and_finalize_match_batch(kind, packed):
    sim = _phenom_sim(kind, packed)
    if kind == "spacetime" and not packed:
        sim._packed = False
    B = sim.batch_size
    drv = PhenomStreamDriver(sim)
    rep = 3 if kind == "spacetime" else 1
    for num_rounds in (1, 2, 4):
        key = (5, num_rounds)
        drv.reset(key)
        # the batch engine's own windows on the same stream
        gen = batch_generator(key_words(key), 0, "cpu")
        draw = sim._draws(gen, B)
        ref = sim._zeros(B)
        for _ in range(num_rounds - 1):
            ref, _ = sim._window(draw, *ref, B)
            drv.step()
        for got, want in zip(drv.carry, ref):
            assert torch.equal(got, want)
        assert drv.committed_cycles == (num_rounds - 1) * rep
        flags = drv.finalize()
        assert np.array_equal(flags, sim.run_batch(key, num_rounds))
    assert flags.any()


def test_phenom_stream_step_under_both_branches_matches_eager():
    sim = _phenom_sim("spacetime")
    a = PhenomStreamDriver(sim).reset((1, 1))
    b = PhenomStreamDriver(sim).reset((1, 1))
    for _ in range(3):
        a.step()
        with tdevice._both_branches():
            b.step()
    for x, y in zip(a.carry, b.carry):
        assert torch.equal(x, y)
    assert np.array_equal(a.finalize(), b.finalize())


def _circuit_sims(batch_size=16, p_cx=0.004):
    """The port's and JAX's engines (7 cycles, windows of 3) with JAX's
    stream test's decoders, graphs built."""
    ep = {"p_i": 0.0, "p_state_p": 0.0, "p_m": 0.0, "p_CX": p_cx,
          "p_idling_gate": 0.0}
    out = []
    for pkg, code, extra in (
            (tdec, CODE, dict(device="cpu")),
            (jdec, jhgp(jrep(3), jrep(3), name="hgp_rep3"), {})):
        cls = (CodeSimulator_Circuit_SpaceTime if pkg is tdec
               else jsim.CodeSimulator_Circuit_SpaceTime)
        sim = cls(code=code, p=p_cx, num_cycles=7, num_rep=3,
                  error_params=ep, eval_logical_type="Z",
                  batch_size=batch_size, seed=11, **extra)
        sim._generate_circuit()
        sim._generate_circuit_graph()
        g = sim.circuit_graph
        ps1 = np.clip(np.asarray(g["channel_ps1"], float), 1e-9, 0.49)
        ps2 = np.clip(np.asarray(g["channel_ps2"], float), 1e-9, 0.49)
        sim.decoder1_z = pkg.ST_BP_Decoder_Circuit(g["h1"], ps1, max_iter=12,
                                                   **extra)
        sim.decoder2_z = pkg.ST_BPOSD_Decoder_Circuit(g["h2"], ps2,
                                                      max_iter=12,
                                                      osd_order=4, **extra)
        out.append(sim)
    return out


def test_circuit_stream_matches_batch_scan_and_jax_driver():
    ts, js = _circuit_sims()
    bs, m = 16, ts.num_checks
    key = jax.random.PRNGKey(7)
    dets, _ = js._cfg(bs)[6]._sample_impl(key, js._dev_state["probs"], bs)
    hist = np.asarray(dets).reshape(bs, ts.num_cycles, m)
    windows = hist[:, :ts.num_rounds * ts.num_rep].reshape(
        bs, ts.num_rounds, ts.num_rep * m)
    tdrv = CircuitStreamDriver(ts, batch_size=bs)
    jdrv = jsim.CircuitStreamDriver(js, batch_size=bs)
    for j in range(ts.num_rounds):
        tcor = tdrv.step(torch.from_numpy(windows[:, j].copy()))
        jcor = jdrv.step(windows[:, j])
        assert np.array_equal(tcor.numpy(), np.asarray(jcor))
        for a, b in zip(tdrv.carry, jdrv.carry):
            assert np.array_equal(a.numpy(), np.asarray(b))
    got = tdrv.finalize(hist[:, -1])
    want = jdrv.finalize(hist[:, -1])
    batch = ts._decode_given(np.asarray(dets))
    for a, b, c in zip(got, want[:3], batch):
        assert np.array_equal(a.numpy(), np.asarray(b))
        assert torch.equal(a, c)
    assert tdrv.committed_cycles == ts.num_rounds * ts.num_rep
    assert tdrv.carry[0].any()
    # a host array feeds a step too; reset clears the carry
    tdrv.reset()
    assert not any(c.any() for c in tdrv.carry)
    tdrv.step(windows[:, 0])
    with tdevice._both_branches():
        both = CircuitStreamDriver(ts, batch_size=bs)
        both.step(windows[:, 0])
    for a, b in zip(tdrv.carry, both.carry):
        assert torch.equal(a, b)


def test_circuit_stream_rejects_bad_window_shape():
    ts, _ = _circuit_sims(batch_size=8)
    drv = CircuitStreamDriver(ts, batch_size=8)
    with pytest.raises(ValueError, match="window shape"):
        drv.step(np.zeros((8, 7), np.uint8))
    with pytest.raises(ValueError, match="window shape"):
        drv.step(torch.zeros((4, 3 * ts.num_checks), dtype=torch.uint8))

"""The port's code-capacity WER slice against the JAX engine, on the CPU.

  * Numpy errors through both packages' packed pipelines (syndrome SpMV,
    decode of both sectors, packed residual checks): equal failure count
    and min logical weight.  Tolerance: none expected; OSD solutions may
    differ only on float32 cost ties, which change no failure here.
  * ``CodeSimulator_DataError(device="cpu")`` against the JAX engine at
    hgp_34_n225 with equal shots: failure fractions within 4 combined
    binomial sigma (the two draw from different generators).
  * p=0 gives zero failures; with no card and no ``device="cpu"`` every
    entry point raises.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import qldpc_fault_tolerance_tpu.decoders as jdec
import qldpc_fault_tolerance_tpu.sim.data_error as jde
from qldpc_fault_tolerance_tpu.decoders.bp_decoders import \
    decode_device as jax_decode_device
from qldpc_fault_tolerance_tpu.ops import gf2_packed as jgp
from qldpc_fault_tolerance_tpu.ops.linalg import ParityOp
from qldpc_fault_tolerance_tpu_torch import decoders as tdec
from qldpc_fault_tolerance_tpu_torch.codes import load_code
from qldpc_fault_tolerance_tpu_torch.noise import depolarizing_xz
from qldpc_fault_tolerance_tpu_torch.ops import bp as tbp
from qldpc_fault_tolerance_tpu_torch.ops import gf2_packed as tgp
from qldpc_fault_tolerance_tpu_torch.ops import osd_device as tod
from qldpc_fault_tolerance_tpu_torch.parallel import batch_generator
from qldpc_fault_tolerance_tpu_torch.sim import CodeSimulator_DataError

# one intra-op thread: the suite runs several pytest workers on few cores,
# and an oversubscribed torch thread pool stalls small ops
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def code():
    return load_code(os.path.join(REPO, "codes_lib_tpu", "hgp_34_n225.npz"))


def _decoders(pkg, kind, code, p, max_iter=30, **kw):
    probs = np.full(code.N, 2 * p / 3)
    cls = {"bp": pkg.BPDecoder, "bposd": pkg.BPOSD_Decoder}[kind]
    return cls(code.hz, probs, max_iter, **kw), cls(code.hx, probs, max_iter, **kw)


def _sim(code, kind, p, seed=5, batch_size=1024):
    dx, dz = _decoders(tdec, kind, code, p, device="cpu")
    return CodeSimulator_DataError(code=code, decoder_x=dx, decoder_z=dz,
                                   pauli_error_probs=[p / 3] * 3, seed=seed,
                                   batch_size=batch_size, device="cpu")


@pytest.mark.parametrize("kind,p", [("bp", 0.03), ("bposd", 0.05)])
def test_numpy_errors_through_both_packed_pipelines(code, kind, p):
    B, n = 512, code.N
    u = np.random.default_rng(11).random((B, n))
    ex = ((u >= p / 3) & (u < p)).astype(np.uint8)          # X or Y
    ez = ((u < p / 3) | ((u >= 2 * p / 3) & (u < p))).astype(np.uint8)
    jdx, jdz = _decoders(jdec, kind, code, p)
    hx_par, hz_par = ParityOp(code.hx), ParityOp(code.hz)
    ex_p, ez_p = jgp.pack_shots(ex), jgp.pack_shots(ez)
    synd_z = jgp.unpack_shots(
        jgp.packed_parity_apply(hx_par.nbr, hx_par.mask, ez_p), B)
    synd_x = jgp.unpack_shots(
        jgp.packed_parity_apply(hz_par.nbr, hz_par.mask, ex_p), B)
    cor_z, _ = jax_decode_device(jdz.device_static, jdz.device_state, synd_z)
    cor_x, _ = jax_decode_device(jdx.device_static, jdx.device_state, synd_x)
    jcnt, jmin = jgp.packed_residual_stats(
        ex_p ^ jgp.pack_shots(cor_x), ez_p ^ jgp.pack_shots(cor_z),
        (hz_par.nbr, hz_par.mask), (hx_par.nbr, hx_par.mask),
        jnp.asarray(code.lz.T), jnp.asarray(code.lx.T), "Total", B, n)

    sim = _sim(code, kind, p, batch_size=B)
    tcnt, tmin = sim._packed_stats(tgp.pack_shots(torch.from_numpy(ex)),
                                   tgp.pack_shots(torch.from_numpy(ez)))
    assert int(jcnt) > 0
    assert (int(tcnt), int(tmin)) == (int(jcnt), int(jmin))


@pytest.mark.parametrize("kind,p,shots", [("bp", 0.03, 4096),
                                          ("bposd", 0.05, 2048)])
def test_wer_matches_jax_engine(code, kind, p, shots):
    sim = _sim(code, kind, p)
    wer, eb = sim.WordErrorRate(shots)
    assert sim.last_shots == shots and 0 < wer < 1 and eb > 0
    jdx, jdz = _decoders(jdec, kind, code, p)
    jsim = jde.CodeSimulator_DataError(
        code=code, decoder_x=jdx, decoder_z=jdz,
        pauli_error_probs=[p / 3] * 3, seed=5, batch_size=1024)
    jwer, _ = jsim.WordErrorRate(shots)
    # WER = 1 - (1 - f)^(1/K): invert to the failure fractions
    f_j = 1.0 - (1.0 - jwer) ** code.K
    f_t = sim.last_failures / shots
    assert abs(f_t - (1.0 - (1.0 - wer) ** code.K)) < 1e-9
    sigma = np.sqrt((f_t * (1 - f_t) + f_j * (1 - f_j)) / shots)
    assert abs(f_t - f_j) <= 4 * sigma, (f_t, f_j, sigma)


@pytest.mark.parametrize("kind", ["bp", "bposd"])
def test_zero_noise_gives_zero_failures(code, kind):
    sim = _sim(code, kind, 0.0, batch_size=256)
    wer, eb = sim.WordErrorRate(512)
    assert (sim.last_failures, wer, eb) == (0, 0.0, 0.0)
    assert sim.last_shots == 512 and sim.min_logical_weight == code.N


def test_runs_are_reproducible_and_target_failures_stops_early(code):
    a, b = _sim(code, "bp", 0.05, batch_size=128), _sim(code, "bp", 0.05,
                                                         batch_size=128)
    assert a.WordErrorRate(512) == b.WordErrorRate(512)
    assert a.last_failures == b.last_failures > 0
    c = CodeSimulator_DataError(code=code, decoder_x=a.decoder_x,
                                decoder_z=a.decoder_z,
                                pauli_error_probs=[0.05 / 3] * 3, seed=5,
                                batch_size=128, scan_chunk=1, device="cpu")
    c.WordErrorRate(8192, target_failures=1)
    assert c.last_failures >= 1 and c.last_shots < 8192
    assert c.last_megabatches == c.last_shots // 128


def test_depolarizing_sampler_statistics():
    gen = batch_generator(3, 0, "cpu")
    ex, ez = depolarizing_xz(gen, (4000, 50), (0.02, 0.03, 0.05))
    x_only = (ex & (1 - ez)).float().mean()
    y = (ex & ez).float().mean()
    z_only = (ez & (1 - ex)).float().mean()
    for got, want in ((x_only, 0.02), (y, 0.03), (z_only, 0.05)):
        assert abs(float(got) - want) < 4 * np.sqrt(want / 200000)
    again = depolarizing_xz(batch_generator(3, 0, "cpu"), (4000, 50),
                            (0.02, 0.03, 0.05))
    other = depolarizing_xz(batch_generator(3, 1, "cpu"), (4000, 50),
                            (0.02, 0.03, 0.05))
    assert torch.equal(again[0], ex) and not torch.equal(other[0], ex)


@pytest.mark.parametrize("entry", ["ParityOp", "lane_mask", "counter_draws",
                                   "osd_cs_decode_values"])
def test_more_entry_points_default_to_the_card(code, monkeypatch, entry):
    """These default to ``device="cuda"`` too: with no card they raise
    unless the caller asks for the CPU."""
    from qldpc_fault_tolerance_tpu_torch.ops import gf2_kernel as gk
    from qldpc_fault_tolerance_tpu_torch.ops import linalg as tla
    from qldpc_fault_tolerance_tpu_torch.ops import osd_cs_device as tcs

    plan = tod.build_osd_plan(code.hx, np.full(code.N, 0.01), device="cpu")
    synd = np.zeros((2, code.hx.shape[0]), np.uint8)
    call = {"ParityOp": lambda **kw: tla.ParityOp(code.hx, **kw),
            "lane_mask": lambda **kw: tgp.lane_mask(40, **kw),
            "counter_draws": lambda **kw: gk.counter_draws(1, 2, 4, 5, **kw),
            "osd_cs_decode_values": lambda **kw: tcs.osd_cs_decode_values(
                (code.N, plan.rank, 4, 64), plan.packed, plan.cost, synd,
                np.zeros((2, code.N)), **kw)}[entry]
    assert call(device="cpu") is not None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


def test_entry_points_raise_without_card_or_cpu_request(code, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    probs = np.full(code.N, 0.01)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdec.BPDecoder(code.hx, probs, 10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdec.BPOSD_Decoder(code.hx, probs, 10)
    graph = tbp.build_tanner_graph(code.hx, "cpu")
    synd = np.zeros((2, code.hx.shape[0]), np.uint8)
    with pytest.raises(RuntimeError):
        tbp.bp_decode(graph, synd, probs, max_iter=5)
    with pytest.raises(RuntimeError):
        tbp.bp_decode_two_phase(graph, synd, probs, max_iter=5)
    plan = tod.build_osd_plan(code.hx, probs, device="cpu")
    with pytest.raises(RuntimeError):
        tod.osd_decode_values((code.N, plan.rank, 4, 256), plan.packed,
                              plan.cost, synd, np.zeros((2, code.N)))
    dx, dz = _decoders(tdec, "bp", code, 0.01, device="cpu")
    with pytest.raises(RuntimeError):
        CodeSimulator_DataError(code=code, decoder_x=dx, decoder_z=dz)

"""The port's phenomenological engine (``sim/phenom.py``) and its pieces
against the JAX package, on the CPU.

  * Injected numpy errors, 5 rounds (4 noisy, 1 final): the JAX engine's
    module functions (``_ext_syndromes``, ``decode_device``,
    ``_bare_syndromes``, ``_check_stats``) round by round against the
    port's engine (``_stats_from_errors``), packed and dense, for BP/BP,
    BP/BPOSD (OSD-E and OSD-CS) and FirstMin/BPOSD decoder pairs:
    (failure count, min weight) equal.  Tolerance: none, but for OSD-CS's
    float32 tie contract (tests/test_torch_osd_cs.py): at hgp_34_n225 two
    final-round shots (X shot 233, Z shot 174; round 5 of 5) have two
    solutions of equal weight and equal cost (a uniform channel: a cost
    is a weight), and the two packages' OSD-CS sweeps, which sum their
    planes in different orders, pick different ones; one of them changes
    the count by one.  The test names them, checks that each is such a tie
    (syndrome-consistent, cost within 1e-4) and allows the count to differ
    by at most their number.
  * ``first_min_bp_decode`` and ``wer_per_cycle`` (both branches) equal
    JAX's.
  * Engine WER within 4 combined binomial sigma of the JAX engine's (the
    two draw from different generators): the toric d5 band cell of
    tests/test_parity_regression.py (eval_p 0.016, 15 rounds) and one
    hgp_34_n225 cell.
  * Zero noise, reproducibility, early stop, ``run_batch`` /
    ``_single_run``, packed == dense, and the card default (no card and no
    ``device="cpu"``: the engine and the FirstMin decoder raise).
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import qldpc_fault_tolerance_tpu.decoders as jdec
import qldpc_fault_tolerance_tpu.sim.phenom as jph
from qldpc_fault_tolerance_tpu.decoders.bp_decoders import \
    decode_device as jax_decode_device
from qldpc_fault_tolerance_tpu.ops import bp as jbp
from qldpc_fault_tolerance_tpu.ops import gf2_packed as jgp
from qldpc_fault_tolerance_tpu.sim.common import wer_per_cycle as jax_wer_per_cycle
from qldpc_fault_tolerance_tpu_torch import decoders as tdec
from qldpc_fault_tolerance_tpu_torch.codes import hgp, load_code, ring_code
from qldpc_fault_tolerance_tpu_torch.noise import bit_flips, bit_flips_packed
from qldpc_fault_tolerance_tpu_torch.ops import bp as tbp
from qldpc_fault_tolerance_tpu_torch.ops import gf2_packed as tgp
from qldpc_fault_tolerance_tpu_torch.parallel import batch_generator
from qldpc_fault_tolerance_tpu_torch.sim import (
    CodeSimulator_DataError,
    CodeSimulator_Phenon,
)
from qldpc_fault_tolerance_tpu_torch.sim.common import wer_per_cycle

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CODES = {}


def _code(name):
    if name not in _CODES:
        _CODES[name] = (load_code(os.path.join(REPO, "codes_lib_tpu",
                                               f"{name}.npz"))
                        if name.startswith("hgp_34")
                        else hgp(ring_code(5), ring_code(5), name="toric_d5"))
    return _CODES[name]


def _ext(h):
    return np.hstack([h, np.eye(h.shape[0], dtype=np.uint8)])


# decoder pairs: (decoder 1 class args, decoder 2 class args), as the
# sweeps build them (qldpc_fault_tolerance_tpu/sweep/family.py _phenl_sim)
PAIRS = {
    "bp/bp": (("bp", 30, 0.625), ("bp", 10, 0.625)),
    "bp/bposd_e": (("bp", 30, 0.625), ("bposd", 10, 0.625, "osd_e", 10)),
    "bp/bposd_cs": (("bp", 30, 0.625), ("bposd", 10, 0.625, "osd_cs", 4)),
    "firstmin/bposd_e": (("firstmin", 5, 0.9), ("bposd", 10, 0.625, "osd_e", 10)),
}


def _factory(pkg, spec, **kw):
    kind, ratio, msf, *osd = spec
    if kind == "bp":
        return pkg.BP_Decoder_Class(ratio, "minimum_sum", msf, **kw)
    if kind == "firstmin":
        return pkg.FirstMinBP_Decoder_Class(ratio, "minimum_sum", msf, **kw)
    return pkg.BPOSD_Decoder_Class(ratio, "minimum_sum", msf, *osd, **kw)


def _decoders(pkg, pair, code, eval_p, q=None, **kw):
    """(d1x, d1z, d2x, d2z) of ``pair`` at ``eval_p`` (p = 3/2 eval_p,
    q = eval_p unless given), as ``_phenl_sim`` builds them."""
    q = eval_p if q is None else q
    p_data = eval_p  # (3/2 eval_p) * 2/3
    c1, c2 = (_factory(pkg, spec, **kw) for spec in PAIRS[pair])
    return (c1.GetDecoder({"h": _ext(code.hz), "p_data": p_data,
                           "p_syndrome": q}),
            c1.GetDecoder({"h": _ext(code.hx), "p_data": p_data,
                           "p_syndrome": q}),
            c2.GetDecoder({"h": code.hz, "p_data": p_data}),
            c2.GetDecoder({"h": code.hx, "p_data": p_data}))


def _sim(pkg_sim, decs, code, eval_p, q=None, **kw):
    q = eval_p if q is None else q
    d1x, d1z, d2x, d2z = decs
    p = 1.5 * eval_p
    return pkg_sim(code=code, decoder1_x=d1x, decoder1_z=d1z, decoder2_x=d2x,
                   decoder2_z=d2z, pauli_error_probs=[p / 3] * 3, q=q, **kw)


def _port_sim(pair, code, eval_p, q=None, **kw):
    kw.setdefault("device", "cpu")
    return _sim(CodeSimulator_Phenon,
                _decoders(tdec, pair, code, eval_p, q, device="cpu"), code,
                eval_p, q, **kw)


def _errors(code, B, eval_p, rounds, seed):
    """Numpy depolarizing data errors (p = 3/2 eval_p) and syndrome flips
    (q = eval_p): ``rounds - 1`` noisy rounds and the final one."""
    rng = np.random.default_rng(seed)
    p, n = 1.5 * eval_p, code.N

    def data():
        u = rng.random((B, n))
        ex = ((u >= p / 3) & (u < p)).astype(np.uint8)            # X or Y
        ez = ((u < p / 3) | ((u >= 2 * p / 3) & (u < p))).astype(np.uint8)
        return ex, ez

    noisy = [(*data(),
              (rng.random((B, code.hz.shape[0])) < eval_p).astype(np.uint8),
              (rng.random((B, code.hx.shape[0])) < eval_p).astype(np.uint8))
             for _ in range(rounds - 1)]
    return noisy, data()


def _jax_rounds(jsim, noisy, final, B, last=None):
    """The JAX engine's functions round by round on given errors; the final
    round's syndromes and corrections go into ``last`` when given."""
    cfg, state, n = jsim._cfg(B), jsim._dev_state, jsim.N
    data_x = jnp.zeros((B, n), jnp.uint8)
    data_z = jnp.zeros((B, n), jnp.uint8)
    for ex, ez, sx, sz in noisy:
        cur_x = jnp.concatenate([jnp.asarray(ex) ^ data_x, jnp.asarray(sx)], 1)
        cur_z = jnp.concatenate([jnp.asarray(ez) ^ data_z, jnp.asarray(sz)], 1)
        synd_x, synd_z = jph._ext_syndromes(cfg, state, cur_x, cur_z)
        dz, _ = jax_decode_device(cfg[4], state["d1z"], synd_z)
        dx, _ = jax_decode_device(cfg[3], state["d1x"], synd_x)
        data_x, data_z = (cur_x ^ dx)[:, :n], (cur_z ^ dz)[:, :n]
    cur_x = data_x ^ jnp.asarray(final[0])
    cur_z = data_z ^ jnp.asarray(final[1])
    synd_x, synd_z = jph._bare_syndromes(cfg, state, cur_x, cur_z)
    dz, _ = jax_decode_device(cfg[6], state["d2z"], synd_z)
    dx, _ = jax_decode_device(cfg[5], state["d2x"], synd_x)
    if last is not None:
        last.update(x=(np.asarray(synd_x), np.asarray(dx)),
                    z=(np.asarray(synd_z), np.asarray(dz)))
    cnt, min_w = jph._check_stats(cfg, state, cur_x, cur_z, dx, dz)
    return int(cnt), int(min_w)


# OSD-CS cost ties in the final round (sector: shots), by code
CS_TIES = {"hgp_34_n225": {"x": [233], "z": [174]}, "toric_d5": {}}


def _check_ties(sim, last, code, ties):
    """The port's decoder 2 on the JAX final round's syndromes differs from
    JAX's corrections exactly at the named shots, and each is a cost tie."""
    for sector, h in (("x", code.hz), ("z", code.hx)):
        synd, want = last[sector]
        dec = getattr(sim, f"decoder2_{sector}")
        got = dec.decode_batch(np.array(synd))
        differ = np.nonzero((got != want).any(axis=1))[0].tolist()
        assert differ == ties.get(sector, []), (sector, differ)
        cost = np.log((1 - dec.channel_probs) / dec.channel_probs)
        for s in differ:
            assert np.array_equal(got[s] @ h.T % 2, synd[s])
            assert abs(float(cost @ got[s]) - float(cost @ want[s])) < 1e-4


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "dense"])
@pytest.mark.parametrize("pair", list(PAIRS))
@pytest.mark.parametrize("name,eval_p", [("hgp_34_n225", 0.02),
                                         ("toric_d5", 0.03)])
def test_injected_errors_through_both_engines(name, eval_p, pair, packed):
    code, B, rounds = _code(name), 256, 5
    noisy, final = _errors(code, B, eval_p, rounds, seed=len(pair) + B)
    jsim = _sim(jph.CodeSimulator_Phenon,
                _decoders(jdec, pair, code, eval_p), code, eval_p,
                batch_size=B, packed=packed)
    last = {}
    want = _jax_rounds(jsim, noisy, final, B, last)
    sim = _port_sim(pair, code, eval_p, batch_size=B, packed=packed)
    cnt, min_w = sim._stats_from_errors(noisy, final)
    assert want[0] > 0
    ties = CS_TIES[name] if pair.endswith("cs") else {}
    _check_ties(sim, last, code, ties)
    n_ties = sum(map(len, ties.values()))
    assert int(min_w) == want[1]
    assert abs(int(cnt) - want[0]) <= n_ties
    if not n_ties:
        assert int(cnt) == want[0]


def test_first_min_bp_decode_matches_jax():
    code = _code("hgp_34_n225")
    h = _ext(code.hx)
    rng = np.random.default_rng(7)
    err = (rng.random((300, h.shape[1])) < 0.03).astype(np.uint8)
    synd = (err @ h.T % 2).astype(np.uint8)
    probs = np.concatenate([np.full(code.N, 0.02), np.full(h.shape[0], 0.01)])
    jcorr, jw = jbp.first_min_bp_decode(
        jbp.build_tanner_graph(h), jnp.asarray(synd),
        jbp.llr_from_probs(probs), max_restarts=12, ms_scaling_factor=0.9)
    corr, w = tbp.first_min_bp_decode(
        tbp.build_tanner_graph(h, "cpu"), synd,
        tbp.llr_from_probs(probs, "cpu"), max_restarts=12,
        ms_scaling_factor=0.9, device="cpu")
    assert corr.dtype == torch.uint8 and w.dtype == torch.int32
    assert np.array_equal(corr.numpy(), np.asarray(jcorr))
    assert np.array_equal(w.numpy(), np.asarray(jw))
    # some shots stop early, some reach a zero syndrome
    assert 0 < int((w == 0).sum()) < 300


def test_firstmin_decoder_and_state_from_jax():
    code = _code("toric_d5")
    params = {"h": _ext(code.hx), "p_data": 0.02, "p_syndrome": 0.02}
    jd = jdec.FirstMinBP_Decoder_Class(5, "minimum_sum", 0.9).GetDecoder(params)
    td = tdec.FirstMinBP_Decoder_Class(5, "minimum_sum", 0.9,
                                       device="cpu").GetDecoder(params)
    assert td.device_static == jd.device_static
    assert td.kernel_variant == "xla_twin"
    rng = np.random.default_rng(3)
    synd = (rng.random((64, params["h"].shape[0])) < 0.1).astype(np.uint8)
    want, jaux = jd.decode_batch_device(jnp.asarray(synd))
    got = td.decode_batch(synd)
    assert np.array_equal(got, np.asarray(want))
    state = tdec.state_from_jax(
        {k: (v._replace(**{f: np.asarray(x) for f, x in v._asdict().items()})
             if hasattr(v, "_asdict") else np.asarray(v))
         for k, v in jd.device_state.items()}, device="cpu")
    assert state["pallas"] is None
    corr, aux = tdec.decode_device(jd.device_static, state,
                                   torch.from_numpy(synd))
    assert np.array_equal(corr.numpy(), np.asarray(want))
    assert np.array_equal(aux["final_weight"].numpy(),
                          np.asarray(jaux["final_weight"]))


@pytest.mark.parametrize("count,shots,K,cycles", [
    (0, 1000, 4, 5), (37, 4096, 17, 9), (200, 1000, 3, 6),   # P <= 1/2
    (900, 1000, 1, 5), (999, 1000, 2, 8), (700, 1000, 1, 4),  # P > 1/2
])
def test_wer_per_cycle_matches_jax(count, shots, K, cycles):
    got = wer_per_cycle(count, shots, K, cycles)
    want = jax_wer_per_cycle(count, shots, K, cycles)
    per_qubit = 1.0 - (1 - count / shots) ** (1 / K)
    assert (per_qubit > 0.5) == (count >= 700)
    assert got == want


def test_packed_residual_stats_excludes_stab_failed_z_weights():
    code = _code("hgp_34_n225")
    rng = np.random.default_rng(5)
    B = 200
    res_x = (rng.random((B, code.N)) < 0.02).astype(np.uint8)
    res_z = (rng.random((B, code.N)) < 0.02).astype(np.uint8)
    res_z[:40] = code.lz[0]  # logical Z failures that pass the stabilizers
    from qldpc_fault_tolerance_tpu.ops.linalg import ParityOp as JParity
    from qldpc_fault_tolerance_tpu_torch.ops.linalg import ParityOp

    jpar = [JParity(h) for h in (code.hz, code.hx)]
    tpar = [ParityOp(h, "cpu") for h in (code.hz, code.hx)]
    for flag in (False, True):
        want = jgp.packed_residual_stats(
            jgp.pack_shots(res_x), jgp.pack_shots(res_z),
            *[(p.nbr, p.mask) for p in jpar], jnp.asarray(code.lz.T),
            jnp.asarray(code.lx.T), "Total", B, code.N,
            z_weight_excludes_stab=flag)
        got = tgp.packed_residual_stats(
            tgp.pack_shots(torch.from_numpy(res_x)),
            tgp.pack_shots(torch.from_numpy(res_z)),
            *[(p.nbr, p.mask) for p in tpar], torch.from_numpy(code.lz.T),
            torch.from_numpy(code.lx.T), "Total", B, code.N,
            z_weight_excludes_stab=flag)
        assert tuple(map(int, got)) == tuple(map(int, want))


def test_bit_flips_packed_packs_the_same_draws():
    a = bit_flips(batch_generator(4, 0, "cpu"), (70, 33), 0.2)
    b = bit_flips_packed(batch_generator(4, 0, "cpu"), (70, 33), 0.2)
    assert b.shape == (3, 33) and torch.equal(tgp.unpack_shots(b, 70), a)


def _failure_fraction_band(f_t, f_j, shots_t, shots_j):
    sigma = np.sqrt(f_t * (1 - f_t) / shots_t + f_j * (1 - f_j) / shots_j)
    assert abs(f_t - f_j) <= 4 * sigma, (f_t, f_j, sigma)


@pytest.mark.parametrize("name,pair,eval_p,q,rounds,shots", [
    # tests/test_parity_regression.py's toric d5 band cell (q = 0, as there)
    ("toric_d5", "bp/bposd_e", 0.016, 0.0, 15, 2048),
    ("hgp_34_n225", "bp/bposd_e", 0.02, 0.02, 5, 1024),
])
def test_engine_wer_matches_jax_engine(name, pair, eval_p, q, rounds, shots):
    code = _code(name)
    sim = _port_sim(pair, code, eval_p, q, seed=11, batch_size=1024)
    wer, eb = sim.WordErrorRate(rounds, shots)
    assert sim.last_shots == shots and 0 < wer < 1 and eb > 0
    jsim = _sim(jph.CodeSimulator_Phenon, _decoders(jdec, pair, code, eval_p, q),
                code, eval_p, q, seed=11, batch_size=1024)
    count, total = jsim._count_failures(rounds, shots)
    assert total == shots
    # the reported WER is wer_per_cycle of the run's count
    assert (wer, eb) == wer_per_cycle(sim.last_failures, shots, code.K, rounds)
    _failure_fraction_band(sim.last_failures / shots, count / total, shots,
                           total)


def test_zero_noise_gives_zero_failures():
    code = _code("toric_d5")
    sim = _port_sim("bp/bposd_e", code, 0.0, batch_size=128)
    wer, eb = sim.WordErrorRate(4, 256)
    assert (sim.last_failures, wer) == (0, 0.0)
    assert sim.last_shots == 256 and sim.min_logical_weight == code.N


def test_packed_and_dense_engines_agree_seed_for_seed():
    code = _code("toric_d5")
    runs = []
    for packed in (True, False):
        sim = _port_sim("firstmin/bposd_e", code, 0.03, seed=4,
                        batch_size=100, packed=packed)
        sim.WordErrorRate(4, 300)
        runs.append((sim.last_failures, sim.min_logical_weight))
    assert runs[0] == runs[1] and runs[0][0] > 0


def test_runs_are_reproducible_and_target_failures_stops_early():
    code = _code("toric_d5")
    a = _port_sim("bp/bp", code, 0.04, seed=2, batch_size=64)
    b = _port_sim("bp/bp", code, 0.04, seed=2, batch_size=64)
    assert a.WordErrorRate(3, 256) == b.WordErrorRate(3, 256)
    assert a.last_failures == b.last_failures > 0
    c = _port_sim("bp/bp", code, 0.04, seed=2, batch_size=64, scan_chunk=1)
    c.WordErrorRate(3, 64 * 40, target_failures=1)
    assert 1 <= c.last_failures and c.last_shots < 64 * 40
    assert c.last_megabatches == c.last_shots // 64
    p, e = c.WordErrorProbability(3, 128)
    assert 0 < p < 1 and e > 0


def test_run_batch_and_single_run():
    code = _code("toric_d5")
    sim = _port_sim("bp/bposd_e", code, 0.04, seed=9, batch_size=96)
    key = (3, 17)
    flags = sim.run_batch(key, 4)
    assert flags.shape == (96,) and flags.dtype == bool
    # the run's batch 0 with the same key: the same shots
    sim.WordErrorRate(4, 96, key=key)
    assert int(flags.sum()) == sim.last_failures > 0
    assert sim.run_batch(key, 4, batch_size=10).shape == (10,)
    before = sim._base_key
    assert sim._single_run(4) in (0, 1)
    assert sim._base_key != before


def test_data_engine_packed_dense_run_batch_and_single_run():
    code = _code("hgp_34_n225")
    probs = np.full(code.N, 0.03)
    dx = tdec.BPDecoder(code.hz, probs, 20, device="cpu")
    dz = tdec.BPDecoder(code.hx, probs, 20, device="cpu")
    runs = []
    for packed in (True, False):
        sim = CodeSimulator_DataError(
            code=code, decoder_x=dx, decoder_z=dz, pauli_error_probs=[0.015] * 3,
            seed=6, batch_size=128, packed=packed, device="cpu")
        sim.WordErrorRate(256, key=(1, 2))
        runs.append((sim.last_failures, sim.min_logical_weight))
    assert runs[0] == runs[1] and runs[0][0] > 0
    sim.WordErrorRate(128, key=(5, 6))
    flags = sim.run_batch((5, 6))
    assert flags.shape == (128,) and int(flags.sum()) == sim.last_failures
    assert sim._single_run() in (0, 1)


def test_entry_points_raise_without_card_or_cpu_request(monkeypatch):
    code = _code("toric_d5")
    decs = _decoders(tdec, "firstmin/bposd_e", code, 0.01, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdec.FirstMinBPDecoder(_ext(code.hx), 0.01, 5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdec.FirstMinBP_Decoder_Class(5, "minimum_sum", 0.9).GetDecoder(
            {"h": code.hx, "p_data": 0.01})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _sim(CodeSimulator_Phenon, decs, code, 0.01)
    assert _sim(CodeSimulator_Phenon, decs, code, 0.01,
                device="cpu").device.type == "cpu"

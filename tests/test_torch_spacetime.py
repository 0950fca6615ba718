"""The port's phenomenological space-time engine
(``sim/phenom_spacetime.py``) and its decoder pieces against the JAX
package, on the CPU.

  * ``GetSpaceTimeCheckMat``, ``st_round_counts`` / ``st_window_count``
    (their errors too) equal JAX's.
  * ``ST_BP_Decoder_Class``: the reference's quirks (syndrome prior p_data
    with 'p_syndrome' present, else 0; max_iter n / ratio, truncated), the
    static equal to JAX's, the state equal to ``state_from_jax`` of the JAX
    decoder's, and ``kernel_variant`` of the ``"st_syndrome"`` kind.
  * ``ST_BP_Decoder_syndrome.decode_batch`` equal to JAX's on random
    detector histories, num_rep 1-3.  Tolerance: none (float32 min-sum in
    both, the same order of operations; no near-tie shot was found).
  * Injected numpy errors through both engines: the JAX engine's
    ``_window_commit``, ``decode_device`` and ``_check`` composed window
    by window against the port's ``_stats_from_errors``, packed and dense:
    (failure count, min weight) equal.
  * Engine WER within 4 combined binomial sigma of the JAX engine's (the
    two draw from different generators) on a surface-code cell and an
    hgp_34_n225 cell.
  * Zero noise, reproducibility, ``run_batch`` / ``_single_run``, and the
    card default (no card and no ``device="cpu"``: the engine's decoders
    raise).
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import qldpc_fault_tolerance_tpu.decoders as jdec
import qldpc_fault_tolerance_tpu.sim.phenom_spacetime as jst
from qldpc_fault_tolerance_tpu.decoders.bp_decoders import \
    decode_device as jax_decode_device
from qldpc_fault_tolerance_tpu.decoders.bp_decoders import \
    kernel_variant as jax_kernel_variant
from qldpc_fault_tolerance_tpu.ops.linalg import gf2_matmul as jax_gf2_matmul
from qldpc_fault_tolerance_tpu.sim.common import \
    st_round_counts as jax_st_round_counts
from qldpc_fault_tolerance_tpu.sim.common import \
    st_window_count as jax_st_window_count
from qldpc_fault_tolerance_tpu_torch import decoders as tdec
from qldpc_fault_tolerance_tpu_torch.codes import hgp, load_code, rep_code
from qldpc_fault_tolerance_tpu_torch.ops import bp as tbp
from qldpc_fault_tolerance_tpu_torch.sim import CodeSimulator_Phenon_SpaceTime
from qldpc_fault_tolerance_tpu_torch.sim.common import (
    st_round_counts,
    st_window_count,
    wer_per_cycle,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CODES = {}


def _code(name):
    if name not in _CODES:
        _CODES[name] = (load_code(os.path.join(REPO, "codes_lib_tpu",
                                               f"{name}.npz"))
                        if name.startswith("hgp_34")
                        else hgp(rep_code(5), rep_code(5), name="surface_d5"))
    return _CODES[name]


def _np_state(state):
    """A JAX decoder state as numpy leaves (``state_from_jax``'s input)."""
    return {k: (v._replace(**{f: np.asarray(x) for f, x in v._asdict().items()})
                if hasattr(v, "_asdict") else
                (v if v is None else np.asarray(v)))
            for k, v in state.items()}


@pytest.mark.parametrize("shape,t0,seed", [((4, 7), 1, 0), ((4, 7), 3, 1),
                                           ((6, 9), 2, 2), ((5, 5), 4, 3)])
def test_space_time_check_matrix_matches_jax(shape, t0, seed):
    h = (np.random.default_rng(seed).random(shape) < 0.4).astype(np.uint8)
    got = tdec.GetSpaceTimeCheckMat(h, t0)
    want = jdec.GetSpaceTimeCheckMat(h, t0)
    m, n = shape
    assert got.dtype == np.uint8 and got.shape == (t0 * m, t0 * (n + m))
    assert np.array_equal(got, want)
    if t0 > 1:  # [0 | I] below the diagonal
        assert np.array_equal(got[m:2 * m, n:n + m], np.eye(m, dtype=np.uint8))
        assert not got[m:2 * m, :n].any()


def _outcome(fn, *args):
    try:
        return fn(*args)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("num_rep", [0, 1, 2, 3, 5, 101])
def test_st_round_and_window_counts_match_jax(num_rep):
    for cycles in (-1, 0, 1, 2, 3, 4, 7, 13, 17, 202, 203):
        for fn, jfn in ((st_round_counts, jax_st_round_counts),
                        (st_window_count, jax_st_window_count)):
            assert _outcome(fn, cycles, num_rep) == _outcome(
                jfn, cycles, num_rep), (fn.__name__, cycles, num_rep)
    assert st_round_counts(13, 3) == (5, 13)
    assert st_window_count(17, 8) == 2
    with pytest.raises(ValueError, match="multiple of num_rep"):
        st_window_count(14, 3)


@pytest.mark.parametrize("with_synd", [True, False],
                         ids=["p_syndrome", "no_p_syndrome"])
def test_st_decoder_class_quirks_and_state(with_synd):
    code = _code("hgp_34_n225")
    params = {"h": code.hx, "p_data": 0.02, "num_rep": 3}
    if with_synd:
        params["p_syndrome"] = 0.5  # ignored: the prior is p_data
    jd = jdec.ST_BP_Decoder_Class(7, "minimum_sum", 0.625).GetDecoder(params)
    td = tdec.ST_BP_Decoder_Class(7, "minimum_sum", 0.625,
                                  device="cpu").GetDecoder(params)
    assert td.device_static == jd.device_static
    m, n = code.hx.shape
    assert td.device_static[:4] == ("st_syndrome", 3, m, n)
    assert td._bp.max_iter == int(n / 7)
    probs = td._bp.channel_probs.reshape(3, n + m)
    assert (probs[:, :n] == 0.02).all()
    assert (probs[:, n:] == (0.02 if with_synd else 0.0)).all()
    # the 0 prior is clipped, as the JAX package's llr_from_probs clips it
    assert np.isfinite(td.device_state["llr0"].numpy()).all()
    state = tdec.state_from_jax(_np_state(jd.device_state), device="cpu")
    for k in tbp.TannerGraph._fields:
        assert torch.equal(getattr(state["graph"], k),
                           getattr(td.device_state["graph"], k)), k
    assert torch.equal(state["llr0"], td.device_state["llr0"])
    assert state["pallas"] is None and td.device_state["pallas"] is None
    with pytest.raises(KeyError, match="num_rep"):
        tdec.ST_BP_Decoder_Class(7, "minimum_sum", 0.625,
                                 device="cpu").GetDecoder(
            {"h": code.hx, "p_data": 0.02})


def test_st_kernel_variant_resolves_to_the_inner_decode():
    code = _code("surface_d5")
    params = {"h": code.hx, "p_data": 0.02, "p_syndrome": 0.02, "num_rep": 2}
    jd = jdec.ST_BP_Decoder_Class(5, "minimum_sum", 0.625).GetDecoder(params)
    td = tdec.ST_BP_Decoder_Class(5, "minimum_sum", 0.625,
                                  device="cpu").GetDecoder(params)
    for bs in (None, 64, 512):
        got = tdec.kernel_variant(td.device_static, td.device_state, bs)
        assert got == tdec.kernel_variant(td.device_static[4],
                                          td.device_state, bs)
        assert got == jax_kernel_variant(jd.device_static, jd.device_state,
                                         bs) == "xla_twin"
    assert td.kernel_variant == "xla_twin"


@pytest.mark.parametrize("num_rep", [1, 2, 3])
def test_st_decode_batch_matches_jax(num_rep):
    code = _code("hgp_34_n225")
    params = {"h": code.hz, "p_data": 0.02, "p_syndrome": 0.02,
              "num_rep": num_rep}
    jd = jdec.ST_BP_Decoder_Class(30, "minimum_sum", 0.625).GetDecoder(params)
    td = tdec.ST_BP_Decoder_Class(30, "minimum_sum", 0.625,
                                  device="cpu").GetDecoder(params)
    rng = np.random.default_rng(num_rep)
    B, m = 300, code.hz.shape[0]
    # histories of a real window: [H|I] syndromes of accumulating errors
    st_h = tdec.GetSpaceTimeCheckMat(code.hz, num_rep)
    err = (rng.random((B, st_h.shape[1])) < 0.02).astype(np.uint8)
    hist = (err @ st_h.T % 2).astype(np.uint8).reshape(B, num_rep, m)
    got = td.decode_batch(hist)
    want = jd.decode_batch(hist)
    assert got.shape == (B, code.N) and got.dtype == np.uint8
    assert np.array_equal(got, want)
    assert np.array_equal(td.decode(hist[0]), want[0])
    _, aux = td.decode_batch_device(torch.from_numpy(hist))
    assert 0 < int(aux["converged"].sum()) < B


# decoder pairs: (decoder 2 class args), decoder 1 always the space-time
# BP class (N/30, min-sum 0.625) as the JAX sweeps build a cell
# (qldpc_fault_tolerance_tpu/sweep/family_spacetime.py _phenl_wer)
DEC2 = {"bp": ("bp", 10, 0.625),
        "bposd_e": ("bposd", 10, 0.625, "osd_e", 10)}


def _decoders(pkg, code, eval_p, num_rep, dec2, **kw):
    kind, ratio, msf, *osd = DEC2[dec2]
    c1 = pkg.ST_BP_Decoder_Class(30, "minimum_sum", 0.625, **kw)
    c2 = (pkg.BP_Decoder_Class(ratio, "minimum_sum", msf, **kw)
          if kind == "bp" else
          pkg.BPOSD_Decoder_Class(ratio, "minimum_sum", msf, *osd, **kw))
    d1 = [c1.GetDecoder({"h": h, "p_data": eval_p, "p_syndrome": eval_p,
                         "num_rep": num_rep}) for h in (code.hz, code.hx)]
    d2 = [c2.GetDecoder({"h": h, "p_data": eval_p})
          for h in (code.hz, code.hx)]
    return {"decoder1_x": d1[0], "decoder1_z": d1[1], "decoder2_x": d2[0],
            "decoder2_z": d2[1]}


def _sim(pkg_sim, decs, eval_p, num_rep, code, **kw):
    return pkg_sim(code=code, pauli_error_probs=[eval_p / 2] * 3, q=eval_p,
                   num_rep=num_rep, **decs, **kw)


def _port_sim(code, eval_p, num_rep, dec2="bposd_e", **kw):
    kw.setdefault("device", "cpu")
    return _sim(CodeSimulator_Phenon_SpaceTime,
                _decoders(tdec, code, eval_p, num_rep, dec2, device="cpu"),
                eval_p, num_rep, code, **kw)


def _errors(code, B, eval_p, subs, seed):
    """Numpy depolarizing data errors (p = 3/2 eval_p) and syndrome flips
    (q = eval_p) of ``subs`` sub-rounds, and the final round's."""
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
             for _ in range(subs)]
    return noisy, data()


def _jax_windows(jsim, subs, final, B):
    """The JAX engine's functions window by window on given errors: the
    sub-rounds' [H|I] syndromes, ``_window_commit``, the final round's
    ``decode_device`` and ``_check``."""
    cfg, state, n, r = jsim._cfg(B), jsim._dev_state, jsim.N, jsim.num_rep
    data_x = jnp.zeros((B, n), jnp.uint8)
    data_z = jnp.zeros((B, n), jnp.uint8)
    for w in range(len(subs) // r):
        hist_z, hist_x = [], []
        for ex, ez, sx, sz in subs[w * r:(w + 1) * r]:
            data_x, data_z = data_x ^ ex, data_z ^ ez
            cur_x = jnp.concatenate([data_x, jnp.asarray(sx)], 1)
            cur_z = jnp.concatenate([data_z, jnp.asarray(sz)], 1)
            hist_z.append(jax_gf2_matmul(cur_z, state["hx_ext_t"]))
            hist_x.append(jax_gf2_matmul(cur_x, state["hz_ext_t"]))
        (data_x, data_z), _ = jst._window_commit(
            cfg, state, (data_x, data_z), jnp.stack(hist_z, 1),
            jnp.stack(hist_x, 1))
    cur_x = data_x ^ jnp.asarray(final[0])
    cur_z = data_z ^ jnp.asarray(final[1])
    dz, _ = jax_decode_device(cfg[7], state["d2z"],
                              jax_gf2_matmul(cur_z, state["hx_t"]))
    dx, _ = jax_decode_device(cfg[6], state["d2x"],
                              jax_gf2_matmul(cur_x, state["hz_t"]))
    fail, min_w = jst._check(cfg, state, cur_x, cur_z, dx, dz)
    return int(fail.sum()), int(min_w)


@pytest.mark.parametrize("eval_type", ["Total", "Z"])
@pytest.mark.parametrize("dec2", sorted(DEC2))
@pytest.mark.parametrize("name,eval_p,num_rep,windows", [
    ("hgp_34_n225", 0.01, 3, 2), ("hgp_34_n225", 0.015, 1, 3),
    ("surface_d5", 0.03, 2, 2)])
def test_injected_errors_through_both_engines(name, eval_p, num_rep, windows,
                                              dec2, eval_type):
    code, B = _code(name), 256
    subs, final = _errors(code, B, eval_p, windows * num_rep,
                          seed=num_rep + windows)
    jsim = _sim(jst.CodeSimulator_Phenon_SpaceTime,
                _decoders(jdec, code, eval_p, num_rep, dec2), eval_p,
                num_rep, code, batch_size=B, eval_logical_type=eval_type)
    want = _jax_windows(jsim, subs, final, B)
    assert want[0] > 0
    sim = _port_sim(code, eval_p, num_rep, dec2, batch_size=B,
                    eval_logical_type=eval_type)
    got = [tuple(map(int, sim._stats_from_errors(subs, final)))]
    sim._packed = False  # the dense planes: bit for bit the packed ones
    got.append(tuple(map(int, sim._stats_from_errors(subs, final))))
    assert got == [want, want]
    if num_rep > 1:
        with pytest.raises(ValueError, match="windows"):
            sim._stats_from_errors(subs[:-1], final)


def _failure_fraction_band(f_t, f_j, shots_t, shots_j):
    sigma = np.sqrt(f_t * (1 - f_t) / shots_t + f_j * (1 - f_j) / shots_j)
    assert abs(f_t - f_j) <= 4 * sigma, (f_t, f_j, sigma)


@pytest.mark.parametrize("name,eval_p,num_rep,cycles,shots", [
    ("surface_d5", 0.02, 3, 7, 2048),
    ("hgp_34_n225", 0.01, 3, 7, 1024),
])
def test_engine_wer_matches_jax_engine(name, eval_p, num_rep, cycles, shots):
    code = _code(name)
    sim = _port_sim(code, eval_p, num_rep, seed=11, batch_size=512)
    wer, eb = sim.WordErrorRate(cycles, shots)
    rounds, total_cycles = st_round_counts(cycles, num_rep)
    assert sim.last_shots == shots and 0 < wer < 1 and eb > 0
    assert (wer, eb) == wer_per_cycle(sim.last_failures, shots, code.K,
                                      total_cycles)
    jsim = _sim(jst.CodeSimulator_Phenon_SpaceTime,
                _decoders(jdec, code, eval_p, num_rep, "bposd_e"), eval_p,
                num_rep, code, seed=11, batch_size=512)
    _, count, total = jsim._word_error_rate(cycles, shots)
    assert total == shots
    _failure_fraction_band(sim.last_failures / shots, count / total, shots,
                           total)


def test_zero_noise_gives_zero_failures():
    code = _code("surface_d5")
    sim = _port_sim(code, 0.0, 2, batch_size=128)
    wer, eb = sim.WordErrorRate(5, 256)
    assert (sim.last_failures, wer) == (0, 0.0)
    assert sim.last_shots == 256 and sim.min_logical_weight == code.N


def test_runs_are_reproducible_run_batch_and_single_run():
    code = _code("surface_d5")
    a = _port_sim(code, 0.04, 2, "bp", seed=2, batch_size=64)
    b = _port_sim(code, 0.04, 2, "bp", seed=2, batch_size=64)
    assert a.WordErrorRate(5, 256) == b.WordErrorRate(5, 256)
    assert a.last_failures == b.last_failures > 0
    assert a.last_megabatches == 1 and a.last_host_reads == 1
    key = (3, 17)
    flags = a.run_batch(key, 3)
    assert flags.shape == (64,) and flags.dtype == bool
    # the run's batch 0 with the same key: the same shots
    a.WordErrorRate(5, 64, key=key)
    assert int(flags.sum()) == a.last_failures > 0
    assert a.run_batch(key, 3, batch_size=10).shape == (10,)
    before = a._base_key
    assert a._single_run(3) in (0, 1)
    assert a._base_key != before
    assert not hasattr(a, "WordErrorProbability")


def test_entry_points_raise_without_card_or_cpu_request(monkeypatch):
    code = _code("surface_d5")
    decs = _decoders(tdec, code, 0.01, 2, "bp", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdec.ST_BP_Decoder_Class(30, "minimum_sum", 0.625).GetDecoder(
            {"h": code.hx, "p_data": 0.01, "num_rep": 2})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _sim(CodeSimulator_Phenon_SpaceTime, decs, 0.01, 2, code)

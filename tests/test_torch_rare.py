"""The port's rare-event estimation (``rare/``, the tilted and stratum
samplers, ``WeightedWordErrorRate``, the weighted fused cells) on the CPU.

  * Port against port, exact: the tilted samplers at zero tilt draw the
    direct samplers' planes with a log weight of exactly 0; zero-tilt
    ``WeightedWordErrorRate`` equals ``WordErrorRate`` (data packed and
    dense, phenom); weighted fused cells equal the serial weighted runs
    (integer counts exact, weight moments to 1e-6 relative); a killed
    weighted stream resumes seed for seed.
  * Port against the JAX package (same numpy inputs): ``WeightedStats``,
    the weighted WER transforms, the ESS intervals, the ``tilt.py``
    functions and ``fit_rare_distance`` to 1e-12; ``stratum_log_weight`` in
    float64 to 1e-12 of the binomial formula and in float32 within eight
    float32 roundings of its largest term of the JAX package's float32;
    tilted WER estimates within 4 reported sigma of the JAX package's (the
    PRNG streams differ).
Small code: hgp(rep_code(3), rep_code(3)), batches of 64-256.
"""
import math

import numpy as np
import pytest
import torch

from qldpc_fault_tolerance_tpu import codes as jcodes
from qldpc_fault_tolerance_tpu import decoders as jdec
from qldpc_fault_tolerance_tpu import rare as jrare
from qldpc_fault_tolerance_tpu import sim as jsim
from qldpc_fault_tolerance_tpu.noise import samplers as jsamplers
from qldpc_fault_tolerance_tpu.sim import common as jsimc
from qldpc_fault_tolerance_tpu.utils import diagnostics as jdiag
from qldpc_fault_tolerance_tpu_torch import rare
from qldpc_fault_tolerance_tpu_torch.codes import hgp, rep_code
from qldpc_fault_tolerance_tpu_torch.decoders import BP_Decoder_Class, BPDecoder
from qldpc_fault_tolerance_tpu_torch.noise import (
    bit_flips,
    bit_flips_tilted,
    bit_flips_tilted_packed,
    depolarizing_xz,
    depolarizing_xz_stratum,
    depolarizing_xz_tilted,
    depolarizing_xz_tilted_packed,
    fixed_weight_flips,
    stratum_log_weight,
)
from qldpc_fault_tolerance_tpu_torch.ops.gf2_packed import pack_shots
from qldpc_fault_tolerance_tpu_torch.parallel.shots import batch_generator
from qldpc_fault_tolerance_tpu_torch.sim import (
    CodeSimulator_DataError,
    CodeSimulator_Phenon,
)
from qldpc_fault_tolerance_tpu_torch.sim import common as simc
from qldpc_fault_tolerance_tpu_torch.utils import diagnostics, telemetry
from qldpc_fault_tolerance_tpu_torch.utils.checkpoint import (
    CellProgress,
    SweepCheckpoint,
)

torch.set_num_threads(1)

CODE = hgp(rep_code(3), rep_code(3), name="rep3hgp")


def data_sim(p=0.05, seed=0, **kw):
    def dec(h):
        return BPDecoder(h, np.full(CODE.N, p), 6, device="cpu")

    kw.setdefault("batch_size", 64)
    kw.setdefault("scan_chunk", 2)
    return CodeSimulator_DataError(
        code=CODE, decoder_x=dec(CODE.hz), decoder_z=dec(CODE.hx),
        pauli_error_probs=[p / 3] * 3, seed=seed, device="cpu", **kw)


def phenom_sim(p=0.04, seed=0, **kw):
    def d1(h):
        ext = np.hstack([h, np.eye(h.shape[0], dtype=np.uint8)])
        return BPDecoder(ext, np.full(ext.shape[1], p), 4, device="cpu")

    def d2(h):
        return BPDecoder(h, np.full(CODE.N, p), 6, device="cpu")

    kw.setdefault("batch_size", 64)
    kw.setdefault("scan_chunk", 2)
    return CodeSimulator_Phenon(
        code=CODE, decoder1_x=d1(CODE.hz), decoder1_z=d1(CODE.hx),
        decoder2_x=d2(CODE.hz), decoder2_z=d2(CODE.hx),
        pauli_error_probs=[p / 3] * 3, q=p, seed=seed, device="cpu", **kw)


def _gen(seed):
    return batch_generator(seed, 0, "cpu")


# ---------------------------------------------------------------- samplers

def test_tilted_depolarizing_zero_tilt_is_the_direct_sampler():
    probs = [0.02, 0.01, 0.03]
    ex0, ez0 = depolarizing_xz(_gen(3), (32, CODE.N), probs)
    ex1, ez1, lw = depolarizing_xz_tilted(_gen(3), (32, CODE.N), probs,
                                          probs)
    assert torch.equal(ex0, ex1) and torch.equal(ez0, ez1)
    assert bool((lw == 0.0).all())  # exactly


def test_tilted_bit_flips_zero_tilt_is_the_direct_sampler():
    f0 = bit_flips(_gen(4), (16, 40), 0.03)
    f1, lw = bit_flips_tilted(_gen(4), (16, 40), 0.03, 0.03)
    assert torch.equal(f0, f1) and bool((lw == 0.0).all())


def test_tilted_log_weight_is_the_sum_of_site_ratios():
    probs, tilt = [0.01, 0.005, 0.02], [0.04, 0.02, 0.08]
    ex, ez, lw = depolarizing_xz_tilted(_gen(5), (64, CODE.N), probs, tilt)
    ex, ez = ex.numpy(), ez.numpy()
    (px, py, pz), (qx, qy, qz) = probs, tilt
    terms = np.where(
        (ex == 1) & (ez == 1), math.log(py) - math.log(qy),
        np.where(ex == 1, math.log(px) - math.log(qx),
                 np.where(ez == 1, math.log(pz) - math.log(qz),
                          math.log1p(-sum(probs)) - math.log1p(-sum(tilt)))))
    np.testing.assert_allclose(lw.numpy(), terms.sum(axis=1), rtol=1e-5,
                               atol=1e-5)


def test_tilted_packed_forms_match_the_dense_ones():
    probs, tilt = [0.02] * 3, [0.06] * 3
    ex, ez, lw = depolarizing_xz_tilted(_gen(6), (64, CODE.N), probs, tilt)
    exp, ezp, lwp = depolarizing_xz_tilted_packed(_gen(6), (64, CODE.N),
                                                  probs, tilt)
    assert torch.equal(exp, pack_shots(ex)) and torch.equal(
        ezp, pack_shots(ez)) and torch.equal(lw, lwp)
    f, lwd = bit_flips_tilted(_gen(7), (64, 40), 0.03, 0.09)
    fp, lwf = bit_flips_tilted_packed(_gen(7), (64, 40), 0.03, 0.09)
    assert torch.equal(fp, pack_shots(f)) and torch.equal(lwf, lwd)


@pytest.mark.parametrize("k", [1, 3, 7])
def test_fixed_weight_and_stratum_samples_have_their_weight(k):
    flips = fixed_weight_flips(_gen(k), (128, 20), k)
    assert bool((flips.sum(dim=1) == k).all())
    ex, ez, lw = depolarizing_xz_stratum(_gen(k), (256, CODE.N),
                                         [0.02, 0.01, 0.03], k)
    assert bool(((ex.bool() | ez.bool()).sum(dim=1) == k).all())
    assert bool((lw == lw[0]).all())


@pytest.mark.parametrize("n,k,p", [(25, 4, 0.03), (625, 12, 0.001),
                                   (13, 1, 0.2)])
def test_stratum_log_weight_in_float64_and_against_jax(n, k, p):
    exact = (math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1)
             + k * math.log(p) + (n - k) * math.log1p(-p))
    assert abs(float(stratum_log_weight(n, k, p, dtype=torch.float64))
               - exact) <= 1e-12 * max(1.0, abs(exact))
    # float32, as the JAX package computes it: both within a few float32
    # roundings of the largest term (lgamma(n + 1)) of each other
    want = float(jsamplers.stratum_log_weight(n, k, p))
    scale = math.lgamma(n + 1) + k * abs(math.log(p)) + 1.0
    np.testing.assert_allclose(float(stratum_log_weight(n, k, p)), want,
                               rtol=0, atol=8 * 2.0 ** -24 * scale)


# ------------------------------------------------- statistics against JAX

_STATS = [dict(failures=37, shots=4096, s1=3.25, s2=0.71, w1=4100.5,
               w2=4350.25, min_w=3),
          dict(failures=0, shots=100, s1=0.0, s2=0.0, w1=100.0, w2=100.0),
          dict(failures=5, shots=100, s1=0.05, s2=0.01, w1=100.0, w2=101.0)]


def _close(a, b):
    if a is None or b is None:
        assert a is b
    elif isinstance(a, dict):
        assert set(a) == set(b)
        for key in a:
            _close(a[key], b[key])
    elif isinstance(a, (tuple, list)):
        for x, y in zip(a, b):
            _close(x, y)
    else:
        np.testing.assert_allclose(float(b), float(a), rtol=1e-12,
                                   atol=1e-15)


@pytest.mark.parametrize("fields", _STATS)
def test_weighted_stats_equal_jax(fields):
    want, got = jsimc.WeightedStats(**fields), simc.WeightedStats(**fields)
    for name in ("rate", "variance", "rse", "ess", "log_weight_sum"):
        _close(getattr(want, name), getattr(got, name))
    _close(want.ci_fields(), got.ci_fields())
    _close(want.event_fields(0.1), got.event_fields(0.1))
    for K, cycles in ((1, 5), (2, 3)):
        _close(jsimc.wer_single_shot_weighted(want, K),
               simc.wer_single_shot_weighted(got, K))
        _close(jsimc.wer_per_cycle_weighted(want, K, cycles),
               simc.wer_per_cycle_weighted(got, K, cycles))
    other = dict(_STATS[2])
    m1 = want.merge(jsimc.WeightedStats(**other))
    m2 = got.merge(simc.WeightedStats(**other))
    _close([m1.failures, m1.shots, m1.s1, m1.s2, m1.w1, m1.w2],
           [m2.failures, m2.shots, m2.s1, m2.s2, m2.w1, m2.w2])


@pytest.mark.parametrize("f,n", [(0, 100), (1, 100), (17, 1000),
                                 (350, 4096)])
def test_ess_intervals_equal_jax_and_wilson_in_the_uniform_limit(f, n):
    _close(jdiag.ess_interval(float(f), float(f), n),
           diagnostics.ess_interval(float(f), float(f), n))
    _close(diagnostics.wilson_interval(f, n),
           diagnostics.ess_interval(float(f), float(f), n))
    _close(jdiag.weighted_ci_fields(f, f * 0.9, f * 1.3, n * 1.1, n * 1.2,
                                    n),
           diagnostics.weighted_ci_fields(f, f * 0.9, f * 1.3, n * 1.1,
                                          n * 1.2, n))
    assert diagnostics.effective_sample_size(10.0, 100.0) == 1.0


def test_tilt_functions_equal_jax():
    for args in ((0.001,), (0.001, 100, 10.0), (0.2, 100, 2.0),
                 (0.001, 4, 8.0), (0.01, None, None, 3.0, 0.1)):
        _close(jrare.auto_tilt(*args), rare.auto_tilt(*args))
    _close(jrare.tilt_channel([0.01, 0.02, 0.03], 0.12),
           rare.tilt_channel([0.01, 0.02, 0.03], 0.12))
    points_j, points_t = [], []
    for fields, p in zip(_STATS, (0.002, 0.001, 0.004)):
        for stats_cls, out in ((jsimc.WeightedStats, points_j),
                               (simc.WeightedStats, points_t)):
            ws = stats_cls(**fields)
            out.append(jrare.weighted_fit_point(p, ws, 2, tilt=0.05)
                       if out is points_j
                       else rare.weighted_fit_point(p, ws, 2, tilt=0.05))
        _close(jrare.variance_reduction(jsimc.WeightedStats(**fields)),
               rare.variance_reduction(simc.WeightedStats(**fields)))
    _close(points_j, points_t)
    _close(jrare.rare_fit_points(points_j), rare.rare_fit_points(points_t))
    with pytest.raises(ValueError):
        rare.tilt_channel([0.0, 0.0, 0.0], 0.1)


def test_fit_rare_distance_equals_jax():
    A, d = 30.0, 4.0
    fits = []
    for rare_pkg, stats_cls in ((jrare, jsimc.WeightedStats),
                                (rare, simc.WeightedStats)):
        points = []
        for p in (0.001, 0.002, 0.004, 0.008):
            pl = A * p ** (d / 2)
            s1 = pl * 100000
            ws = stats_cls(failures=max(int(pl * 200000), 10), shots=100000,
                           s1=s1, s2=s1 * 2e-3, w1=1e5, w2=1.1e5)
            points.append(rare_pkg.weighted_fit_point(p, ws, 1, tilt=0.05))
        fits.append(rare_pkg.fit_rare_distance(points))
    assert fits[1]["converged"]
    assert fits[1]["d_eff"] == pytest.approx(d, rel=0.05)
    _close(fits[0]["d_eff"], fits[1]["d_eff"])


# ----------------------------------------------- engines: zero tilt, exact

@pytest.mark.parametrize("packed", [True, False])
def test_data_zero_tilt_equals_word_error_rate(packed):
    direct = data_sim(packed=packed)
    wer = direct.WordErrorRate(64 * 8)
    sim = data_sim(packed=packed)
    weighted = sim.WeightedWordErrorRate(64 * 8)
    ws = sim.last_weighted
    assert weighted[0] == wer[0]
    assert (ws.failures, ws.shots, ws.min_w) == (
        direct.last_failures, direct.last_shots, direct.min_logical_weight)
    assert ws.s1 == ws.s2 == ws.failures and ws.w1 == ws.w2 == ws.shots


@pytest.mark.parametrize("packed", [True, False])
def test_phenom_zero_tilt_equals_word_error_rate(packed):
    direct = phenom_sim(packed=packed)
    wer = direct.WordErrorRate(3, 64 * 4)
    sim = phenom_sim(packed=packed)
    weighted = sim.WeightedWordErrorRate(3, 64 * 4)
    ws = sim.last_weighted
    assert weighted[0] == wer[0]
    assert (ws.failures, ws.min_w) == (direct.last_failures,
                                       direct.min_logical_weight)
    assert ws.s1 == ws.failures and ws.w1 == ws.shots


def test_tilt_support_is_validated():
    sim = data_sim(p=0.03)
    with pytest.raises(ValueError, match="support"):
        sim.WeightedWordErrorRate(64, tilt_probs=[0.0, 0.02, 0.02])
    with pytest.raises(ValueError, match="sub-probability"):
        sim.WeightedWordErrorRate(64, tilt_probs=[0.5, 0.4, 0.2])
    with pytest.raises(ValueError, match="components"):
        sim.WeightedWordErrorRate(64, tilt_probs=[0.1, 0.1])
    ps = phenom_sim(p=0.03)
    with pytest.raises(ValueError, match="support"):
        ps.WeightedWordErrorRate(2, 64, tilt_probs=[0.0, 0.02, 0.02])
    with pytest.raises(ValueError, match="tilt_q"):
        ps.WeightedWordErrorRate(2, 64, tilt_q=0.0)
    with pytest.raises(ValueError, match="support"):
        rare.eval_weighted_cells([data_sim(p=0.03)], [[0.0, 0.02, 0.02]], 64)


class _Stop(Exception):
    pass


def test_weighted_stream_killed_resumes_seed_for_seed(tmp_path):
    key = (0, 31)
    shots = 64 * 16  # 8 megabatches of 2 batches
    tilt = rare.tilt_channel([0.05 / 3] * 3, 0.12)
    clean = data_sim()
    want = clean.WeightedWordErrorRate(shots, tilt_probs=tilt, key=key)

    class Stopping(CellProgress):
        def save(self, *a, **k):
            super().save(*a, **k)
            if self._saves == 3:
                raise _Stop

    path = str(tmp_path / "cells.jsonl")
    cell_key = {"code": "rep3hgp", "noise": "data-w", "p": 0.05}
    with pytest.raises(_Stop):
        data_sim().WeightedWordErrorRate(
            shots, tilt_probs=tilt, key=key,
            progress=Stopping(SweepCheckpoint(path), cell_key))
    state = SweepCheckpoint(path).get_progress(cell_key)
    assert state["batches_done"] == 6
    assert set(state["weighted"]) == {"s1", "s2", "w1", "w2"}
    sim = data_sim()
    got = sim.WeightedWordErrorRate(
        shots, tilt_probs=tilt, key=key,
        progress=CellProgress(SweepCheckpoint(path), cell_key))
    a, b = clean.last_weighted, sim.last_weighted
    assert got == want
    assert (a.failures, a.shots, a.s1, a.s2, a.w1, a.w2) == (
        b.failures, b.shots, b.s1, b.s2, b.w1, b.w2)


# ----------------------------------------------- weighted fused cells

def _rungs(ps, seed=17):
    return [data_sim(p, seed=seed) for p in ps]


def test_weighted_fused_cells_equal_serial_weighted_runs():
    ps = [0.05, 0.03]
    tilts = [rare.tilt_channel([p / 3] * 3, 0.1) for p in ps]
    cells = rare.eval_weighted_cells(_rungs(ps), tilts, 64 * 4)
    for p, tilt, cell in zip(ps, tilts, cells):
        serial = _rungs([p])[0]
        serial.WeightedWordErrorRate(64 * 4, tilt_probs=tilt)
        sw, fw = serial.last_weighted, cell["stats"]
        assert (fw.failures, fw.shots, fw.min_w) == (sw.failures, sw.shots,
                                                      sw.min_w)
        np.testing.assert_allclose([fw.s1, fw.s2, fw.w1, fw.w2],
                                   [sw.s1, sw.s2, sw.w1, sw.w2], rtol=1e-6)


def test_weighted_fused_zero_tilt_collapses_to_the_direct_counts():
    ps = [0.06, 0.04]
    cells = rare.eval_weighted_cells(_rungs(ps), [[p / 3] * 3 for p in ps],
                                     64 * 4)
    for p, cell in zip(ps, cells):
        ws = cell["stats"]
        direct = _rungs([p])[0]
        direct.WordErrorRate(64 * 4)
        assert ws.failures == direct.last_failures
        assert ws.s1 == ws.failures and ws.w1 == ws.shots


def test_weighted_adaptive_donates_lanes():
    ps = [0.08, 0.05]
    tilts = [rare.tilt_channel([p / 3] * 3, 0.12) for p in ps]
    telemetry.reset()
    telemetry.enable()
    try:
        cells = rare.eval_weighted_cells(_rungs(ps), tilts, 64 * 64,
                                         target_rse=0.25, min_failures=5)
        snap = telemetry.snapshot()
    finally:
        telemetry.disable()
    for cell in cells:
        ws = cell["stats"]
        assert ws.failures >= 5
        assert (ws.rse is not None and ws.rse <= 0.25) or \
            ws.shots == 64 * 64
    assert snap["driver.early_stops"]["value"] >= 1


def test_weighted_fused_checkpoint_resumes_past_the_end(tmp_path):
    ps = [0.05, 0.03]
    tilts = [rare.tilt_channel([p / 3] * 3, 0.1) for p in ps]
    path = str(tmp_path / "rare.jsonl")
    first = rare.eval_weighted_cells(_rungs(ps), tilts, 64 * 4,
                                     checkpoint=SweepCheckpoint(path))
    second = rare.eval_weighted_cells(_rungs(ps), tilts, 64 * 4,
                                      checkpoint=SweepCheckpoint(path))
    for a, b in zip(first, second):
        assert a["wer"] == b["wer"]
        sa, sb = a["stats"], b["stats"]
        assert (sa.failures, sa.s1, sa.w2) == (sb.failures, sb.s1, sb.w2)


def test_eval_rare_grid_factory_entry():
    p_list = [0.04, 0.02]
    points = rare.eval_rare_grid(
        CODE, BP_Decoder_Class(6, "minimum_sum", 0.625, device="cpu"),
        p_list, 64 * 4, d_eff=3.0, batch_size=64, seed=13, device="cpu")
    assert [pt["p"] for pt in points] == p_list
    for pt in points:
        assert pt["stats"].shots == 64 * 4
        assert pt["tilt"] >= 0.04 * 1.5
        assert pt["ess"] > 0


def test_tilted_wer_returns_a_fit_point():
    pt = rare.tilted_wer(data_sim(p=0.05, seed=8), 256, q_total=0.1)
    assert set(pt) >= {"p", "wer", "wer_eb", "sigma", "ess", "tilt"}
    assert pt["p"] == pytest.approx(0.05) and pt["tilt"] == 0.1


def test_stratified_masses_and_rows():
    res = rare.stratified_wer(data_sim(p=0.06, seed=3), range(2, 6), 128)
    assert 0.0 <= res["rate"] <= 1.0
    assert abs(res["covered_mass"] + res["head_mass"] + res["tail_mass"]
               - 1.0) < 1e-9
    assert res["head_mass"] > 0.5 and res["tail_mass"] < 0.2
    assert [r["stratum"] for r in res["strata"]] == [2, 3, 4, 5]
    for row in res["strata"]:
        k = row["stratum"]
        pmf = math.exp(math.lgamma(CODE.N + 1) - math.lgamma(k + 1)
                       - math.lgamma(CODE.N - k + 1) + k * math.log(0.06)
                       + (CODE.N - k) * math.log1p(-0.06))
        assert abs(row["weight"] - pmf) < 1e-12
        assert row["shots"] == 128


# ------------------------------------------------ estimates against JAX

def _jax_data_sim(p, seed):
    code = jcodes.hgp(jcodes.rep_code(3), jcodes.rep_code(3))

    def dec(h):
        return jdec.BPDecoder(h, np.full(code.N, p), max_iter=6)

    return jsim.CodeSimulator_DataError(
        code=code, decoder_x=dec(code.hz), decoder_z=dec(code.hx),
        pauli_error_probs=[p / 3] * 3, seed=seed, batch_size=256)


@pytest.mark.parametrize("p,q", [(0.05, 0.1), (0.02, 0.09)])
def test_tilted_wer_within_4_sigma_of_jax(p, q):
    tilt = rare.tilt_channel([p / 3] * 3, q)
    js = _jax_data_sim(p, 2)
    js.WeightedWordErrorRate(4096, tilt_probs=tilt)
    ts = data_sim(p, seed=2, batch_size=256)
    ts.WeightedWordErrorRate(4096, tilt_probs=tilt)
    a, b = js.last_weighted, ts.last_weighted
    assert b.failures > 20
    sigma = math.sqrt(a.variance + b.variance)
    assert abs(a.rate - b.rate) <= 4 * sigma, (a, b)

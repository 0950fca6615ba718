"""The port's sweep layer (``sweep/``) against the JAX package, on the CPU.

  * The fits (``sweep/fits.py``, host numpy and scipy in both packages)
    equal the JAX package's on the same arrays to 1e-12, bootstrap seeded.
  * Each ``CodeFamily`` / ``CodeFamily_SpaceTime`` cell equals the port
    engine's ``WordErrorRate`` run on its own with the family's seed,
    exactly.
  * The grids (data, phenl and circuit, the space-time phenl branch and the
    adaptive pruning case of the JAX package's tests/test_sweep.py) match
    the JAX package's within 4 binomial sigma of each cell's failure rate,
    the counts read from both packages' run ledgers (the PRNG streams
    differ); the pruned p lists are equal.
  * ``fused=True``, ``fused="auto"`` (the fused cell path) and
    ``fused=False`` (the serial loop) give equal grids.
Small codes: hgp(rep_code(3), rep_code(3)) and hgp(ring_code(3),
ring_code(3)), as the JAX package's tests/test_sweep.py uses.
"""
import sys

import numpy as np
import pytest
import torch

from qldpc_fault_tolerance_tpu import codes as jcodes
from qldpc_fault_tolerance_tpu import decoders as jdec
from qldpc_fault_tolerance_tpu import sweep as jsweep
from qldpc_fault_tolerance_tpu.sweep import fits as jfits
from qldpc_fault_tolerance_tpu_torch import decoders as tdec
from qldpc_fault_tolerance_tpu_torch import sweep as tsweep
from qldpc_fault_tolerance_tpu_torch.codes import hgp, rep_code, ring_code
from qldpc_fault_tolerance_tpu_torch.sim import (
    CodeSimulator_Circuit,
    CodeSimulator_DataError,
    CodeSimulator_Phenon,
    CodeSimulator_Phenon_SpaceTime,
)
from qldpc_fault_tolerance_tpu_torch.sweep import fits as tfits
from qldpc_fault_tolerance_tpu_torch.utils import diagnostics

torch.set_num_threads(1)

EP = {"p_i": 0, "p_state_p": 0, "p_m": 0, "p_CX": 1, "p_idling_gate": 0}


# ------------------------------------------------------------------ fits

def _close(a, b, path="report"):
    """Equal structure; floats within 1e-12 relative."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple, np.ndarray)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=0, err_msg=path)
    else:
        assert a == b, path


def _grid(seed=0, num_codes=3):
    """A threshold-shaped family grid with multiplicative noise."""
    rng = np.random.default_rng(seed)
    pc, A = 0.05, 0.3
    p = 10 ** np.linspace(np.log10(pc * 0.4), np.log10(pc * 0.8), 6)
    pl = np.array([A * (p / pc) ** (d / 2) for d in (3, 5, 7)[:num_codes]])
    return p, pl * rng.uniform(0.8, 1.25, pl.shape)


@pytest.mark.parametrize("sigma", [False, True])
@pytest.mark.parametrize("bootstrap", [0, 40])
def test_threshold_fit_report_equals_jax(bootstrap, sigma):
    p, pl = _grid(bootstrap + sigma)
    sig = 0.1 * pl if sigma else None
    want = jfits.threshold_fit_report(p, pl, sigma=sig, bootstrap=bootstrap)
    got = tfits.threshold_fit_report(p, pl, sigma=sig, bootstrap=bootstrap)
    _close(want, got)
    assert ("pc_ci" in got) == bool(bootstrap)


@pytest.mark.parametrize("bootstrap", [0, 40])
def test_distance_fit_report_equals_jax(bootstrap):
    p, pl = _grid(7)
    for i in range(3):
        _close(jfits.fit_distance_report(p, pl[i], bootstrap=bootstrap,
                                         code_index=i),
               tfits.fit_distance_report(p, pl[i], bootstrap=bootstrap,
                                         code_index=i))


@pytest.mark.parametrize("name", ["DistanceEst", "ThresholdEst_extrapolation"])
def test_estimators_equal_jax(name):
    p, pl = _grid(3)
    kw = {"verbose": False} if name == "ThresholdEst_extrapolation" else {}
    _close(getattr(jsweep, name)(p, pl, **kw), getattr(tsweep, name)(p, pl,
                                                                      **kw))


def test_sustainable_threshold_equals_jax():
    cycles = np.array([5, 10, 15, 20, 25, 30])
    rng = np.random.default_rng(2)
    th = jfits.FitSusThreshold(cycles, 0.02, 0.06, 0.3) * rng.uniform(
        0.97, 1.03, cycles.shape)
    _close(float(jsweep.SustainableThresholdEst(cycles, th)),
           float(tsweep.SustainableThresholdEst(cycles, th)))


@pytest.mark.parametrize("name,args", [
    ("FitDistance", ((0.01, 0.02), 0.3, 5.0)),
    ("EmpericalFit", (((0.01, 0.02), (3.0, 5.0)), 0.05, 0.3)),
    ("FitSusThreshold", ((5.0, 10.0), 0.02, 0.06, 0.3)),
    ("CriticalExponentFit", (((0.01, 0.02), (3.0, 5.0)), 0.05, 1.2, 0.1,
                             0.2, 0.3)),
])
def test_fit_models_equal_jax(name, args):
    arr = [tuple(np.asarray(a, float) for a in x) if isinstance(x, tuple)
           and isinstance(x[0], tuple) else np.asarray(x, float)
           if isinstance(x, tuple) else x for x in args]
    _close(list(getattr(jsweep, name)(*arr)), list(getattr(tsweep, name)(*arr)))


def test_fit_reports_reach_the_sweep_run():
    p, pl = _grid(1)
    with diagnostics.sweep_run({"driver": "test"}, ledger=None) as run:
        assert run is None  # no ledger, diagnostics off: a no-op scope
    diagnostics.enable()
    try:
        with diagnostics.sweep_run({"driver": "test"}) as run:
            tfits.threshold_fit_report(p, pl, bootstrap=5)
        assert [f["fit"] for f in run.fits] == ["distance"] * 3 + [
            "threshold"]
    finally:
        diagnostics.auto()


# ------------------------------------------------------ cells == engines

def _codes(pkg):
    return [pkg.hgp(pkg.rep_code(3), pkg.rep_code(3)),
            pkg.hgp(pkg.ring_code(3), pkg.ring_code(3))]


class _Port:
    hgp, rep_code, ring_code = staticmethod(hgp), staticmethod(rep_code), \
        staticmethod(ring_code)


def _port_family(codes, seed, batch=128, st=False):
    kw = dict(batch_size=batch, seed=seed, device="cpu")
    if st:
        return tsweep.CodeFamily_SpaceTime(
            codes, tdec.ST_BP_Decoder_Class(10, "minimum_sum", 0.625,
                                            device="cpu"),
            tdec.BPOSD_Decoder_Class(5, "minimum_sum", 0.625, "osd_e", 4,
                                     device="cpu"), **kw)
    return tsweep.CodeFamily(
        codes, tdec.BP_Decoder_Class(3, "minimum_sum", 0.625, device="cpu"),
        tdec.BPOSD_Decoder_Class(5, "minimum_sum", 0.625, "osd_e", 4,
                                 device="cpu"), **kw)


def test_data_cells_equal_the_engine():
    codes = _codes(_Port)
    fam = _port_family(codes, 21)
    p_list = [0.03, 0.08]
    wer = fam.EvalWER("data", "Total", p_list, 512, if_plot=False)
    for i, code in enumerate(codes):
        for j, p in enumerate(p_list):
            sim = CodeSimulator_DataError(
                code=code,
                decoder_x=fam.decoder2_class.GetDecoder({"h": code.hz,
                                                         "p_data": p}),
                decoder_z=fam.decoder2_class.GetDecoder({"h": code.hx,
                                                         "p_data": p}),
                pauli_error_probs=[p / 2] * 3, batch_size=128, seed=21,
                device="cpu")
            assert wer[i, j] == sim.WordErrorRate(512)[0]
    assert (wer > 0).all()


def test_phenl_cell_equals_the_engine():
    code = _codes(_Port)[1]
    fam = _port_family([code], 22)
    wer = fam.EvalWER("phenl", "Z", [0.02], 256, num_cycles=3, if_plot=False)
    sim = fam._phenl_sim(code, 0.02, "Z")
    assert wer[0, 0] == sim.WordErrorRate(3, 256)[0]
    assert isinstance(sim, CodeSimulator_Phenon)


def test_circuit_cell_equals_the_engine():
    code = _codes(_Port)[0]
    fam = _port_family([code], 23)
    wer = fam.EvalWER("circuit", "Z", [0.01], 256, num_cycles=3,
                      circuit_error_params=EP, if_plot=False)
    ext = lambda h: np.hstack([h, np.eye(h.shape[0], dtype=np.uint8)])  # noqa: E731
    g = fam.decoder1_class.GetDecoder
    sim = CodeSimulator_Circuit(
        code=code, decoder1_z=g({"h": ext(code.hx), "p_data": 0.01,
                                 "p_syndrome": 0.01}),
        decoder1_x=g({"h": ext(code.hz), "p_data": 0.01, "p_syndrome": 0.01}),
        decoder2_z=fam.decoder2_class.GetDecoder({"h": code.hx,
                                                  "p_data": 0.01}),
        decoder2_x=fam.decoder2_class.GetDecoder({"h": code.hz,
                                                  "p_data": 0.01}),
        p=0.01, num_cycles=3, error_params={k: v * 0.01 for k, v in EP.items()},
        eval_logical_type="Z", rand_scheduling_seed=1, batch_size=128,
        seed=23, device="cpu")
    sim._generate_circuit()
    assert wer[0, 0] == sim.WordErrorRate(256)[0]


def test_spacetime_phenl_cell_equals_the_engine():
    code = _codes(_Port)[0]
    fam = _port_family([code], 24, st=True)
    wer, p_used = fam.EvalWER("phenl", "Total", [0.01], 256, num_cycles=7,
                              num_rep=3, if_plot=False)
    d1, d2 = fam.decoder1_class.GetDecoder, fam.decoder2_class.GetDecoder
    sim = CodeSimulator_Phenon_SpaceTime(
        code=code,
        decoder1_x=d1({"h": code.hz, "p_data": 0.01, "p_syndrome": 0.01,
                       "num_rep": 3}),
        decoder1_z=d1({"h": code.hx, "p_data": 0.01, "p_syndrome": 0.01,
                       "num_rep": 3}),
        decoder2_x=d2({"h": code.hz, "p_data": 0.01}),
        decoder2_z=d2({"h": code.hx, "p_data": 0.01}),
        pauli_error_probs=[0.005] * 3, q=0.01, num_rep=3, batch_size=128,
        seed=24, device="cpu")
    assert wer[0][0] == sim.WordErrorRate(7, 256)[0]
    assert list(p_used[0]) == [0.01]


# ------------------------------------------------------ grids vs the JAX

def _ledger_cells(path):
    (rec,) = diagnostics.load_ledger(str(path))
    return {(c["cell"]["code"], round(c["cell"]["p"], 12)): c
            for c in rec["cells"]}


def _within_4_sigma(want, got):
    assert set(want) == set(got)
    for key in want:
        a, b = want[key], got[key]
        n1, n2 = a["shots"], b["shots"]
        pooled = (a["failures"] + b["failures"]) / (n1 + n2)
        sigma = np.sqrt(pooled * (1 - pooled) * (1 / n1 + 1 / n2))
        diff = abs(a["failures"] / n1 - b["failures"] / n2)
        assert diff <= 4 * sigma, (key, a["failures"], n1, b["failures"], n2)


def _jax_family(codes, seed, batch=128, st=False):
    kw = dict(batch_size=batch, seed=seed)
    if st:
        return jsweep.CodeFamily_SpaceTime(
            codes, jdec.ST_BP_Decoder_Class(10, "minimum_sum", 0.625),
            jdec.BPOSD_Decoder_Class(5, "minimum_sum", 0.625, "osd_e", 4),
            **kw)
    return jsweep.CodeFamily(
        codes, jdec.BP_Decoder_Class(3, "minimum_sum", 0.625),
        jdec.BPOSD_Decoder_Class(5, "minimum_sum", 0.625, "osd_e", 4), **kw)


@pytest.mark.parametrize("noise,kw", [
    ("data", dict(eval_p_list=[0.03, 0.08], num_samples=1024)),
    ("phenl", dict(eval_p_list=[0.02], num_samples=512, num_cycles=3)),
    ("circuit", dict(eval_p_list=[0.01], num_samples=512, num_cycles=3,
                     circuit_error_params=EP)),
])
def test_grid_matches_jax_within_4_sigma(tmp_path, noise, kw):
    ltype = "Z" if noise == "circuit" else "Total"
    jwer = _jax_family(_codes(jcodes), 31).EvalWER(
        noise, ltype, if_plot=False, fused=False,
        ledger=str(tmp_path / "jax"), **kw)
    twer = _port_family(_codes(_Port), 31).EvalWER(
        noise, ltype, if_plot=False, ledger=str(tmp_path / "port"), **kw)
    assert jwer.shape == twer.shape == (2, len(kw["eval_p_list"]))
    want, got = _ledger_cells(tmp_path / "jax"), _ledger_cells(
        tmp_path / "port")
    _within_4_sigma(want, got)
    assert sum(c["failures"] for c in got.values()) > 0


def test_spacetime_phenl_grid_matches_jax_within_4_sigma(tmp_path):
    kw = dict(eval_p_list=[0.01, 0.02], num_samples=512, num_cycles=7,
              num_rep=3, if_plot=False)
    jwer, jp = _jax_family(_codes(jcodes)[:1], 32, st=True).EvalWER(
        "phenl", "Total", ledger=str(tmp_path / "jax"), **kw)
    twer, tp = _port_family(_codes(_Port)[:1], 32, st=True).EvalWER(
        "phenl", "Total", ledger=str(tmp_path / "port"), **kw)
    assert [list(x) for x in jp] == [list(x) for x in tp]
    _within_4_sigma(_ledger_cells(tmp_path / "jax"),
                    _ledger_cells(tmp_path / "port"))


def test_spacetime_adaptive_pruning_matches_jax(tmp_path):
    """The JAX package's tests/test_sweep.py adaptive case: the predictor
    prunes p = 0.001 in both packages; the kept cell within 4 sigma."""
    adaptive = {"WEREst": lambda N, p: p, "min_wer": 0.005}
    kw = dict(eval_p_list=[0.001, 0.01], num_samples=256, num_cycles=7,
              num_rep=3, circuit_error_params=EP, if_plot=False,
              if_adaptive=True, adaptive_params=adaptive)
    jfam = jsweep.CodeFamily_SpaceTime(
        [jcodes.hgp(jcodes.rep_code(3), jcodes.rep_code(3))],
        jdec.ST_BP_Decoder_Circuit_Class(1, "minimum_sum", 0.625),
        jdec.ST_BPOSD_Decoder_Circuit_Class(1, "minimum_sum", 0.625, "osd_e",
                                            4), batch_size=64, seed=5)
    tfam = tsweep.CodeFamily_SpaceTime(
        [hgp(rep_code(3), rep_code(3))],
        tdec.ST_BP_Decoder_Circuit_Class(1, "minimum_sum", 0.625,
                                         device="cpu"),
        tdec.ST_BPOSD_Decoder_Circuit_Class(1, "minimum_sum", 0.625, "osd_e",
                                            4, device="cpu"),
        batch_size=64, seed=5, device="cpu")
    jwer, jp = jfam.EvalWER("circuit", "Z", ledger=str(tmp_path / "jax"),
                            **kw)
    twer, tp = tfam.EvalWER("circuit", "Z", ledger=str(tmp_path / "port"),
                            **kw)
    assert list(jp[0]) == list(tp[0]) == [0.01]
    assert twer[0].shape == (1,)
    _within_4_sigma(_ledger_cells(tmp_path / "jax"),
                    _ledger_cells(tmp_path / "port"))


def test_threshold_runs_the_grid_and_the_fit(tmp_path):
    fam = _port_family(_codes(_Port), 33)
    pc = fam.EvalThreshold("data", "Total", "extrapolation", 0.12, 512,
                           ledger=str(tmp_path))
    (rec,) = diagnostics.load_ledger(str(tmp_path))
    assert len(rec["cells"]) == 12 and rec["complete"]
    fit = [f for f in rec["fits"] if f["fit"] == "threshold"][0]
    assert fit["p_c"] == pc and len(fit["pc_ci"]) == 2
    assert rec["config"]["driver"] == "CodeFamily.EvalThreshold"


# -------------------------------------------------------------- options

@pytest.mark.parametrize("st", [False, True])
def test_fused_true_raises_and_auto_is_the_serial_loop(st):
    """fused=True, fused="auto" (both the fused cell path now) and
    fused=False (the serial loop) give equal grids, bit for bit."""
    fam = _port_family(_codes(_Port)[:1], 34, st=st)
    grids = [fam.EvalWER("data", "Total", [0.05, 0.08], 256, if_plot=False,
                         fused=fused) for fused in (True, "auto", False)]
    for g in grids[1:]:
        np.testing.assert_array_equal(np.asarray(g[0], float),
                                      np.asarray(grids[0][0], float))


def test_plot_without_matplotlib_raises_a_clear_error(monkeypatch):
    fam = _port_family(_codes(_Port)[:1], 35)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    with pytest.raises(ImportError, match="if_plot=True needs matplotlib"):
        fam.EvalWER("data", "Total", [0.05], 128, if_plot=True)


def test_circuit_x_keeps_the_swap_warning_and_total_sums_two_runs():
    code = _codes(_Port)[0]
    fam = _port_family([code], 36)
    with pytest.warns(UserWarning, match="swaps hx<->hz"):
        fam.EvalWER("circuit", "X", [0.01], 128, num_cycles=3,
                    circuit_error_params=EP, if_plot=False)
    calls = []
    real = CodeSimulator_Circuit.WordErrorRate

    def spy(self, *a, **k):
        out = real(self, *a, **k)
        calls.append(out[0])
        return out

    try:
        CodeSimulator_Circuit.WordErrorRate = spy
        wer = fam.EvalWER("circuit", "Total", [0.01], 128, num_cycles=3,
                          circuit_error_params=EP, if_plot=False)
    finally:
        CodeSimulator_Circuit.WordErrorRate = real
    assert len(calls) == 2 and wer[0, 0] == calls[0] + calls[1]


def test_a_grid_across_processes_is_round_robin_in_a_group(monkeypatch):
    from qldpc_fault_tolerance_tpu_torch.parallel import grid

    assert grid.process_cell_owner(3).all()
    monkeypatch.setattr(grid, "world_size", lambda: 2)
    for me, want in ((0, [True, False, True]), (1, [False, True, False])):
        monkeypatch.setattr(grid, "rank", lambda me=me: me)
        assert grid.process_cell_owner(3).tolist() == want


def test_cells_reach_telemetry_sinks_with_their_intervals(tmp_path):
    from qldpc_fault_tolerance_tpu_torch.utils import telemetry

    fam = _port_family(_codes(_Port)[:1], 37)
    sink = telemetry.MemorySink()
    path = tmp_path / "events.jsonl"
    with telemetry.session(str(path)):
        telemetry.add_sink(sink)
        try:
            wer = fam.EvalWER("data", "Total", [0.05, 0.1], 256,
                              if_plot=False)
        finally:
            telemetry.remove_sink(sink)
        assert telemetry.snapshot()["sweep.cells"]["value"] == 2
    cells = [r for r in sink.records if r["kind"] == "cell_done"]
    assert [c["wer"] for c in cells] == list(wer[0])
    for c in cells:
        assert c["shots"] == 256 and c["ci_low"] <= c["rate"] <= c["ci_high"]
    assert not telemetry.enabled()
    kinds = [line.split('"kind": "')[1].split('"')[0]
             for line in path.read_text().splitlines()]
    assert kinds[:2] == ["telemetry_enabled", "process_info"]
    assert kinds.count("cell_done") == 2 and kinds[-1] == "snapshot"



@pytest.mark.parametrize("noise", ["data", "phenl"])
def test_each_cell_releases_its_engine_graphs(monkeypatch, noise):
    """A cell's engine drops its megabatch drivers (and on the card their
    captured graphs) when the cell ends, so a grid holds one at a time."""
    cls = CodeSimulator_DataError if noise == "data" else CodeSimulator_Phenon
    seen = []
    real = cls.WordErrorRate

    def spy(self, *a, **k):
        out = real(self, *a, **k)
        assert self._drivers  # the run built its driver
        seen.append(self)
        return out

    monkeypatch.setattr(cls, "WordErrorRate", spy)
    _port_family(_codes(_Port)[:1], 38).EvalWER(
        noise, "Total", [0.03, 0.06], 128, num_cycles=3, if_plot=False,
        fused=False)
    assert len(seen) == 2 and all(s._drivers == {} for s in seen)

"""Threshold / distance / sustainability fits (host-side scipy).

Same estimators as the reference (src/Simulators.py:675-741, duplicated at
src/Simulators_SpaceTime.py:1080-1146): per-code power-law fits
``pl = A p^{d/2}`` give effective distances; a joint fit of
``pl = A (p/pc)^{d/2}`` over the family extrapolates the crossing point
``p_c``; thresholds vs cycle count fit the saturation model
``p_th(N) = p_sus (1 - (1 - p0/p_sus) e^{-gamma N})``.

Statistical observability (utils.diagnostics): every fit emits a structured
``fit_report`` telemetry event — parameters, parameter standard errors,
(weighted) residual statistics, goodness-of-fit, and bootstrap-over-cells
confidence intervals on ``p_c`` / ``d_eff`` — instead of being a bare
return value; a curve_fit that hits scipy's max-iteration failure
("Optimal parameters not found … maxfev") emits ``converged: false``
BEFORE re-raising, so failed fits are machine-visible.  The report layer is
free when diagnostics are off (bootstrap resampling only runs when active;
events are no-ops when telemetry is disabled) and never changes the legacy
return values.

The JAX package's module (numpy and scipy only), kept as the port's own
copy over the port's ``utils.diagnostics`` / ``utils.telemetry``.
"""
from __future__ import annotations

import contextlib
import math
import warnings

import numpy as np
from scipy.optimize import curve_fit

__all__ = [
    "CriticalExponentFit",
    "EmpericalFit",
    "FitDistance",
    "DistanceEst",
    "ThresholdEst_extrapolation",
    "FitSusThreshold",
    "SustainableThresholdEst",
    "fit_distance_report",
    "threshold_fit_report",
    "BOOTSTRAP_DEFAULT",
]

# bootstrap replicates when diagnostics are active and the caller didn't
# choose (each replicate is one host-side curve_fit on tens of points)
BOOTSTRAP_DEFAULT = 200


def CriticalExponentFit(xdata_tuple, pc, nu, A, B, C):
    """Quadratic critical-scaling ansatz (src/Simulators.py:675-679; defined
    by the reference but unused on its main paths)."""
    p, d = xdata_tuple
    x = (p - pc) * d ** (1 / nu)
    return A + B * x + C * x**2


def EmpericalFit(xdata_tuple, pc, A):
    """pl = A (p/pc)^{d/2} (src/Simulators.py:681-684)."""
    p, d = xdata_tuple
    return A * (p / pc) ** (d / 2)


def FitDistance(p, A, d):
    """pl = A p^{d/2} (src/Simulators.py:686-688)."""
    return A * p ** (d / 2)


# ---------------------------------------------------------------------------
# Fit diagnostics core
# ---------------------------------------------------------------------------
def _jsonf(x):
    """float for JSON: non-finite -> None (a torn NaN in the event stream
    helps nobody)."""
    x = float(x)
    return x if math.isfinite(x) else None


def _emit_fit_report(report: dict) -> None:
    from ..utils import diagnostics, telemetry

    telemetry.count("fits.reports")
    if not report.get("converged", False):
        telemetry.count("fits.failed")
    telemetry.event("fit_report", **report)
    diagnostics.note_fit(report)


@contextlib.contextmanager
def _quiet_bootstrap():
    """Bootstrap replicates legitimately hit singular-covariance resamples
    (duplicated cells); scipy's OptimizeWarning per replicate is noise —
    the report's bootstrap_failed count is the honest signal."""
    from scipy.optimize import OptimizeWarning

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", OptimizeWarning)
        yield


def _resolve_bootstrap(bootstrap) -> int:
    if bootstrap is not None:
        return max(0, int(bootstrap))
    from ..utils import diagnostics

    return BOOTSTRAP_DEFAULT if diagnostics.active() else 0


def _fit_diag(model, x, y, p0, *, fit_kind: str, sigma=None, context=None,
              **curve_fit_kw):
    """curve_fit + residual / goodness diagnostics.

    Returns ``(popt, pcov, stderr, diag)`` where ``diag`` is the common
    fit_report block: convergence, covariance health, n/dof, R², and
    (sigma-weighted when error bars are given) residual statistics.  The
    scipy max-iteration failure path emits a ``converged: false``
    fit_report before re-raising."""
    context = dict(context or {})
    try:
        popt, pcov = curve_fit(model, x, y, p0=p0, sigma=sigma,
                               **curve_fit_kw)
    except RuntimeError as e:
        # scipy's "Optimal parameters not found: … maxfev" path — the
        # failed fit must be machine-visible, not just a raised line
        _emit_fit_report({"fit": fit_kind, "converged": False,
                          "error": str(e), **context})
        raise
    y = np.asarray(y, float)
    yhat = np.asarray(model(x, *popt), float)
    resid = y - yhat
    wresid = resid / np.asarray(sigma, float) if sigma is not None else resid
    n = int(resid.size)
    k = int(len(popt))
    dof = max(n - k, 1)
    ss_res = float((resid**2).sum())
    ss_tot = float(((y - y.mean()) ** 2).sum())
    pcov = np.asarray(pcov, float)
    cov_ok = bool(np.isfinite(pcov).all())
    stderr = (np.sqrt(np.clip(np.diag(pcov), 0.0, np.inf)) if cov_ok
              else np.full(k, np.nan))
    diag = {
        "fit": fit_kind, "converged": True, "covariance_ok": cov_ok,
        "n_points": n, "dof": dof,
        "r2": _jsonf(1.0 - ss_res / ss_tot) if ss_tot > 0 else None,
        "residual_rms": _jsonf(np.sqrt((wresid**2).mean())),
        "residual_max": _jsonf(np.abs(wresid).max()),
        **context,
    }
    if sigma is not None:
        diag["chi2"] = _jsonf((wresid**2).sum())
    return popt, pcov, stderr, diag


def fit_distance_report(sweep_p_list, sweep_pl_list, sigma=None,
                        bootstrap=None, code_index=None,
                        **curve_fit_kw) -> dict:
    """One code's effective-distance fit with full diagnostics.

    ``sigma``: optional per-point WER error bars (weights the residual
    stats and chi²).  ``bootstrap``: resampling replicates for the
    ``d_ci`` percentile interval — the cells (p-points) resample with
    replacement and the fit reruns per replicate; None = BOOTSTRAP_DEFAULT
    when diagnostics are active, 0 otherwise (deterministic rng, seed 0).
    Emits (and returns) the ``fit_report``; the legacy estimator value is
    ``report["d_eff"]``."""
    p = np.asarray(sweep_p_list, float)
    pl = np.asarray(sweep_pl_list, float) + 1e-10
    ctx = {} if code_index is None else {"code_index": int(code_index)}
    popt, _pcov, stderr, diag = _fit_diag(
        FitDistance, p, pl, (0.01, 3), fit_kind="distance", sigma=sigma,
        context=ctx, **curve_fit_kw)
    A, d = popt
    report = {
        **diag,
        "d_eff": float(d),
        "params": {"A": float(A), "d_eff": float(d)},
        "stderr": {"A": _jsonf(stderr[0]), "d_eff": _jsonf(stderr[1])},
    }
    nb = _resolve_bootstrap(bootstrap)
    if nb:
        rng = np.random.default_rng(0)
        sig = None if sigma is None else np.asarray(sigma, float)
        ds, failed = [], 0
        with _quiet_bootstrap():
            for _ in range(nb):
                idx = rng.integers(0, p.size, p.size)
                try:
                    # replicates refit the SAME estimator as the point
                    # estimate — sigma weighting included
                    bo, _ = curve_fit(
                        FitDistance, p[idx], pl[idx], p0=(0.01, 3),
                        sigma=None if sig is None else sig[idx],
                        **curve_fit_kw)
                    ds.append(float(bo[1]))
                except RuntimeError:
                    failed += 1
        if ds:
            report["d_ci"] = [float(np.percentile(ds, 2.5)),
                              float(np.percentile(ds, 97.5))]
        report["bootstrap"] = nb
        report["bootstrap_failed"] = failed
    _emit_fit_report(report)
    return report


def threshold_fit_report(sweep_p_list, sweep_pl_total_list, sigma=None,
                         bootstrap=None, **curve_fit_kw) -> dict:
    """The family threshold fit with full diagnostics.

    Per-code distances come from ``fit_distance_report`` (each emitting its
    own report), then the joint ``pl = A (p/pc)^{d/2}`` fit runs over every
    (code, p) cell.  The bootstrap resamples the joint-fit CELLS with
    replacement (per-code d fixed at the point estimate — the resample
    targets the crossing-point uncertainty, not the slope refit) and
    reports the 95% percentile ``pc_ci``.  Returns the emitted report;
    the legacy estimator value is ``report["p_c"]``."""
    sweep_p_list = list(np.asarray(sweep_p_list, float))
    pl_arr = np.asarray(sweep_pl_total_list, float)
    num_code, num_p = pl_arr.shape
    sigma_arr = None if sigma is None else \
        np.asarray(sigma, float).reshape(num_code, num_p)
    # the per-code distance fits ride the same report path with the same
    # caller choices (sigma rows, bootstrap count) forwarded
    d_per_code = [
        fit_distance_report(
            sweep_p_list, pl_arr[i], code_index=i,
            sigma=None if sigma_arr is None else sigma_arr[i],
            bootstrap=bootstrap)["d_eff"]
        for i in range(num_code)
    ]

    ps = np.tile(sweep_p_list, num_code)
    ds = np.repeat(d_per_code, num_p)
    fit_X = np.vstack([ps, ds])
    fit_Z = pl_arr.reshape(num_p * num_code)
    sig = None
    if sigma_arr is not None:
        sig = sigma_arr.reshape(num_p * num_code)
    popt, _pcov, stderr, diag = _fit_diag(
        EmpericalFit, fit_X, fit_Z, (0.04, 0.1), fit_kind="threshold",
        sigma=sig, **curve_fit_kw)
    p_c, A = popt
    report = {
        **diag,
        "p_c": float(p_c),
        "params": {"p_c": float(p_c), "A": float(A)},
        "d_per_code": [float(d) for d in d_per_code],
        "stderr": {"p_c": _jsonf(stderr[0]), "A": _jsonf(stderr[1])},
    }
    nb = _resolve_bootstrap(bootstrap)
    if nb:
        rng = np.random.default_rng(0)
        pcs, failed = [], 0
        n_cells = fit_Z.size
        with _quiet_bootstrap():
            for _ in range(nb):
                idx = rng.integers(0, n_cells, n_cells)
                try:
                    # same estimator as the point fit: sigma-weighted when
                    # error bars were given
                    bo, _ = curve_fit(EmpericalFit,
                                      (fit_X[0][idx], fit_X[1][idx]),
                                      fit_Z[idx], p0=(0.04, 0.1),
                                      sigma=None if sig is None
                                      else sig[idx],
                                      **curve_fit_kw)
                    pcs.append(float(bo[0]))
                except RuntimeError:
                    failed += 1
        if pcs:
            report["pc_ci"] = [float(np.percentile(pcs, 2.5)),
                               float(np.percentile(pcs, 97.5))]
        report["bootstrap"] = nb
        report["bootstrap_failed"] = failed
    _emit_fit_report(report)
    return report


# ---------------------------------------------------------------------------
# Reference estimator surface (return values unchanged)
# ---------------------------------------------------------------------------
def DistanceEst(sweep_p_list, sweep_pl_total_list, if_plot=False):
    """Per-code effective distance from the low-p slope
    (src/Simulators.py:690-699).  Each code's fit emits a ``fit_report``
    (see fit_distance_report); the return value is the reference's bare
    d-list."""
    del if_plot
    return [
        fit_distance_report(sweep_p_list, sweep_pl_list,
                            code_index=i)["d_eff"]
        for i, sweep_pl_list in enumerate(np.asarray(sweep_pl_total_list,
                                                     float))
    ]


def ThresholdEst_extrapolation(sweep_p_list, sweep_pl_total_list,
                               if_plot=False, verbose=True):
    """Joint family fit of pl = A (p/pc)^{d/2} with per-code d from
    DistanceEst; returns p_c (src/Simulators.py:701-741).  The full
    diagnostics (bootstrap CI on p_c included when diagnostics are active)
    ride the emitted ``fit_report`` (threshold_fit_report)."""
    report = threshold_fit_report(sweep_p_list, sweep_pl_total_list)
    p_c = report["p_c"]
    A = report["params"]["A"]

    if if_plot:
        import matplotlib.pyplot as plt

        sweep_p_list = list(np.asarray(sweep_p_list, float))
        pl_arr = np.asarray(sweep_pl_total_list, float)
        plt.figure()
        for i, d in enumerate(report["d_per_code"]):
            fitted = [EmpericalFit((p, d), p_c, A) for p in sweep_p_list]
            plt.plot(sweep_p_list, fitted, "-", c=f"C{i}")
            plt.plot(sweep_p_list, pl_arr[i], "D", c=f"C{i}")
        plt.xscale("log")
        plt.yscale("log")
        plt.xlabel("p")
        plt.ylabel("WER")
    if verbose:
        from ..utils.observability import get_logger, log_record

        # the legacy verbose path logs through the registered fit_report
        # vocabulary (EVENT_SCHEMAS) — "threshold_fit" was schema drift
        log_record(get_logger(), "fit_report", fit="legacy_threshold",
                   converged=True, p_c=float(p_c), A=float(A))
    return p_c


def FitSusThreshold(N, p_sus, p_0, gamma):
    """Sustainable-threshold saturation model (src/Simulators.py:936-938)."""
    return p_sus * (1 - (1 - p_0 / p_sus) * np.exp(-gamma * N))


def SustainableThresholdEst(num_cycles_list, threshold_list, if_plot=False):
    """Fit p_sus from thresholds at increasing cycle counts
    (src/Simulators.py:940-948); emits a ``fit_report`` with parameter
    standard errors (too few points for a meaningful bootstrap)."""
    popt, _pcov, stderr, diag = _fit_diag(
        FitSusThreshold, np.asarray(num_cycles_list, float),
        np.asarray(threshold_list, float), (0.01, 0.05, 0.05),
        fit_kind="sustainable_threshold")
    report = {
        **diag,
        "p_sus": float(popt[0]),
        "params": {"p_sus": float(popt[0]), "p_0": float(popt[1]),
                   "gamma": float(popt[2])},
        "stderr": {"p_sus": _jsonf(stderr[0]), "p_0": _jsonf(stderr[1]),
                   "gamma": _jsonf(stderr[2])},
    }
    _emit_fit_report(report)
    if if_plot:
        import matplotlib.pyplot as plt

        plt.figure()
        plt.plot(num_cycles_list, threshold_list, "D")
        plt.plot(num_cycles_list,
                 FitSusThreshold(np.asarray(num_cycles_list, float), *popt),
                 "-")
    return popt[0]

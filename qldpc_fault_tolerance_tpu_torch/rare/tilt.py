"""Tilt selection and weighted-point helpers for the rare-event estimator
(the port's copy of the JAX package's jax-free ``rare/tilt.py``).

The importance-sampling tilt trades proposal aggressiveness against weight
degeneracy: a tilt ``q`` too close to the physical ``p`` leaves the failure
set unsampled (direct-MC variance), one too far concentrates all weight in a
few shots (ESS collapse).  The heuristics here encode the standard
exponential-tilting compromise for decoding failures: aim the proposal's
mean error weight ``n·q`` at the typical weight of a MINIMAL failing
configuration, ~``d_eff/2`` flips (half the effective distance — the
decoder's ball radius), and never exceed a cap where the proposal stops
resembling the channel at all.
"""
from __future__ import annotations

import math

__all__ = [
    "tilt_channel",
    "auto_tilt",
    "variance_reduction",
    "weighted_fit_point",
    "rare_fit_points",
]


def tilt_channel(pauli_error_probs, q_total: float):
    """Scale a ``[px, py, pz]`` triple to TOTAL error rate ``q_total``
    preserving the X/Y/Z ratios — the tilted proposal stays inside the
    channel family, so the per-site weight depends only on whether a site
    errored, not on which Pauli it drew (keeps weight variance minimal
    for a given total tilt)."""
    probs = [float(p) for p in pauli_error_probs]
    total = sum(probs)
    if total <= 0:
        raise ValueError("cannot tilt a zero-rate channel")
    if not 0.0 < q_total < 1.0:
        raise ValueError(f"tilt total must be in (0, 1), got {q_total}")
    return [p * q_total / total for p in probs]


def auto_tilt(p_total: float, n: int | None = None,
              d_eff: float | None = None, factor: float = 4.0,
              cap: float = 0.25) -> float:
    """Total tilt rate for a sub-threshold cell at physical rate
    ``p_total``.

    With a distance estimate (``d_eff``, from a near-threshold
    ``fit_distance_report``) and the block length ``n``, the tilt aims the
    proposal's mean error weight ``n·q`` at ``d_eff/2`` errors — the
    weight scale of minimal failing configurations.  Without one, the
    fallback is a fixed multiplicative boost ``factor·p``.  Both clamp to
    ``[p_total, cap]``: tilting below the channel would INFLATE variance,
    and beyond ``cap`` the proposal no longer resembles the channel
    (weight degeneracy, ESS collapse)."""
    if not 0.0 < p_total < 1.0:
        raise ValueError(f"p_total must be in (0, 1), got {p_total}")
    if d_eff is not None and n:
        q = max(d_eff / 2.0, 1.0) / float(n)
    else:
        q = factor * p_total
    return min(max(q, p_total), cap)


def variance_reduction(stats, shots: int | None = None) -> float | None:
    """Variance-reduction factor of a weighted run vs direct Monte-Carlo at
    EQUAL shot budget: ``Var_direct / Var_weighted`` with the direct
    variance ``r(1-r)/shots`` evaluated at the weighted rate estimate
    (the standard equal-budget comparison — direct MC at a deep cell often
    observes zero failures, so its own empirical variance is undefined).
    None when the weighted run saw no failures (no estimate to compare)."""
    n = int(shots if shots is not None else stats.shots)
    r = stats.rate
    var_w = stats.variance
    if r <= 0 or var_w <= 0 or n <= 0:
        return None
    return (r * (1.0 - r) / n) / var_w


def weighted_fit_point(p: float, stats, K: int, tilt=None) -> dict:
    """One rare-event cell as a sigma-weighted fit input: the weighted WER
    estimate with its delta-method error bar — the ``sigma`` column
    ``sweep.fits.fit_distance_report`` weights residuals by."""
    from ..sim.common import wer_single_shot_weighted

    wer, wer_eb = wer_single_shot_weighted(stats, K)
    rate = stats.rate
    # delta-method sigma on WER: d wer/d rate = (1-rate)^{1/K-1}/K
    deriv = ((1.0 - rate) ** (1.0 / K - 1.0)) / K if rate < 1.0 else 1.0 / K
    sigma = math.sqrt(stats.variance) * deriv
    return {"p": float(p), "wer": float(wer), "wer_eb": float(wer_eb),
            "sigma": float(sigma) if sigma > 0 else None,
            "ess": stats.ess, "rse": stats.rse,
            "tilt": None if tilt is None else float(tilt)}


def rare_fit_points(points: list[dict]):
    """``(p_list, wer_list, sigma_list)`` from ``weighted_fit_point``
    records, ready for ``fit_distance_report(p, wer, sigma=sigma)``.
    Cells without a defined sigma (zero failures) are dropped — an
    unweightable point would otherwise dominate a weighted fit."""
    kept = [pt for pt in points if pt.get("sigma")]
    return ([pt["p"] for pt in kept], [pt["wer"] for pt in kept],
            [pt["sigma"] for pt in kept])

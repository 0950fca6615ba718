"""Rare-event estimators of one cell: the tilted-channel convenience entry
and the fixed-weight stratum (subset) estimator (the JAX package's
``rare/estimator.py``).

  * **tilted**: every shot from a boosted channel, reweighted
    (``WeightedWordErrorRate``); best when the failure set is diffuse in
    weight.
  * **stratified**: condition on the exact error weight ``k``, measure each
    stratum's failure rate ``r_k`` and combine with the binomial masses
    ``P(W=k)`` on the host: ``sum_k P(W=k) r_k``.  Within a stratum every
    shot has the same weight, so each estimate is a plain binomial count;
    the uncovered tail mass ``P(W > k_max)`` is reported as the truncation
    bound.
"""
from __future__ import annotations

import math

import torch

from .tilt import auto_tilt, tilt_channel, weighted_fit_point

__all__ = ["tilted_wer", "stratified_wer"]


def tilted_wer(sim, num_samples: int, q_total: float | None = None,
               d_eff: float | None = None, p: float | None = None,
               key=None, progress=None, target_rse=None) -> dict:
    """One importance-sampled WER cell on a data engine, as its
    sigma-weighted fit point (``rare.tilt.weighted_fit_point``).
    ``q_total`` defaults to ``auto_tilt`` of the channel's total rate (and
    ``d_eff`` when known); ``p`` is the fit axis's value (by default the
    channel's total rate)."""
    p_total = float(sum(float(x) for x in sim.channel_probs))
    if q_total is None:
        q_total = auto_tilt(p_total, n=sim.N, d_eff=d_eff)
    tilt = tilt_channel(sim.channel_probs, q_total)
    sim.WeightedWordErrorRate(num_samples, tilt_probs=tilt, key=key,
                              progress=progress, target_rse=target_rse)
    return weighted_fit_point(p_total if p is None else p,
                              sim.last_weighted, sim.K, tilt=q_total)


def _log_binom_pmf(n: int, k: int, p: float) -> float:
    return (math.lgamma(n + 1) - math.lgamma(k + 1)
            - math.lgamma(n - k + 1)
            + k * math.log(p) + (n - k) * math.log1p(-p))


def _stratum_stats(sim):
    """One fixed-weight batch of stratum ``k`` through the data engine's
    dense decode and checks -> (failure count, min weight)."""
    from ..noise import depolarizing_xz_stratum
    from ..ops.linalg import gf2_matmul
    from ..sim.common import dense_check_flags, select_failures

    def stats(generator, k):
        ex, ez, _ = depolarizing_xz_stratum(
            generator, (sim.batch_size, sim.N), sim.channel_probs, k)
        cor_x, cor_z = sim._decode(gf2_matmul(ex, sim._hz_t),
                                   gf2_matmul(ez, sim._hx_t))
        x_fail, z_fail, min_w = dense_check_flags(
            ex ^ cor_x, ez ^ cor_z, sim._hz_t, sim._hx_t, sim._lz_t,
            sim._lx_t, sim.N)
        fail = select_failures(x_fail, z_fail, sim.eval_logical_type)
        return fail.sum(dtype=torch.int32), min_w

    return stats


def stratified_wer(sim, strata, samples_per_stratum: int,
                   key=None) -> dict:
    """Fixed-weight subset estimator on a data engine.

    ``strata``: the error weights ``k`` to measure.  Each stratum runs
    ``samples_per_stratum`` shots of exactly-weight-``k`` errors through
    the engine's decode and checks (its own stream, ``fold_in(key, k)``)
    and emits one ``rare_stratum`` telemetry event.

    Returns ``{rate, variance, wer, wer_eb, strata: [...], covered_mass,
    head_mass, tail_mass, stats}``: ``rate = sum P(W=k) r_k`` over the
    covered strata, ``variance`` its stratified variance, ``tail_mass``
    the ``P(W > k_max)`` truncation bound, ``head_mass`` the ``P(W <
    k_min)`` mass the caller skipped (not an error when those strata are
    correctable), and ``stats`` a ``WeightedStats`` view of the run."""
    from ..ops.prng import fold_in, key_words, split_key
    from ..parallel.shots import GeneratorInput, count_min_driver
    from ..sim.common import (
        ShotBatcher,
        WeightedStats,
        refuse_mesh,
        wer_single_shot_weighted,
    )
    from ..utils import telemetry

    refuse_mesh(sim, "stratified estimation")
    if sim._fused_sampler:
        raise ValueError(
            "stratified estimation runs the default sampler's stream, not "
            "the fused sampler's")
    strata = sorted({int(k) for k in strata})
    if not strata or strata[0] < 1:
        raise ValueError("strata must be positive error weights")
    if key is None:
        sim._base_key, key = split_key(sim._base_key)
    p_total = float(sum(float(x) for x in sim.channel_probs))
    n = sim.N
    batcher = ShotBatcher(samples_per_stratum, sim.batch_size)
    chunk = min(batcher.num_batches, sim._scan_chunk)
    n_batches = -(-batcher.num_batches // chunk) * chunk
    driver = count_min_driver(_stratum_stats(sim), n, sim.device, chunk,
                              GeneratorInput(sim.device))
    rows = []
    rate = var = covered = 0.0
    failures_total = shots_total = 0
    for k in strata:
        carry, _ = driver.run(key_words(fold_in(key, k)), n_batches, k)
        failures, min_w = driver.read(carry)
        sim.min_logical_weight = min(sim.min_logical_weight, int(min_w))
        shots = n_batches * sim.batch_size
        pmf = math.exp(_log_binom_pmf(n, k, p_total))
        r_k = failures / shots
        contribution = pmf * r_k
        rate += contribution
        var += pmf * pmf * r_k * (1.0 - r_k) / shots
        covered += pmf
        failures_total += failures
        shots_total += shots
        rows.append({"stratum": k, "shots": shots, "failures": failures,
                     "weight": pmf, "rate": r_k,
                     "contribution": contribution})
        telemetry.event("rare_stratum", stratum=k, shots=shots,
                        failures=failures, weight=pmf, rate=r_k,
                        contribution=contribution)
        telemetry.count("rare.strata")
    driver._graphs.clear()
    # the WeightedStats view: per-shot weight pmf * N_total / n_k
    s2 = w1 = w2 = 0.0
    for row in rows:
        w_shot = row["weight"] * shots_total / row["shots"]
        s2 += w_shot * w_shot * row["failures"]
        w1 += w_shot * row["shots"]
        w2 += w_shot * w_shot * row["shots"]
    stats = WeightedStats(failures=failures_total, shots=shots_total,
                          s1=rate * shots_total, s2=s2, w1=w1, w2=w2)
    # only the mass above k_max bounds a truncation error (r_k <= 1); the
    # head below k_min is the correctable shell the caller skipped
    head_mass = sum(math.exp(_log_binom_pmf(n, k, p_total))
                    for k in range(strata[0]))
    tail_mass = max(1.0 - covered - head_mass, 0.0)
    wer, wer_eb = wer_single_shot_weighted(stats, sim.K)
    return {"rate": rate, "variance": var, "wer": wer, "wer_eb": wer_eb,
            "strata": rows, "covered_mass": covered,
            "head_mass": head_mass, "tail_mass": tail_mass, "stats": stats}


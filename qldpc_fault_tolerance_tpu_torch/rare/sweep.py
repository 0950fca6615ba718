"""Weighted fused sweep execution: every rung of a rare-event grid in one
program, converged rungs handing their lanes to the uncertain ones (the
JAX package's ``rare/sweep.py``).

Each rung is an importance-sampled cell with its own tilt; the rungs share
the cell axis of a ``CellFusedDriver(weighted=True)`` program
(``sim/data_error.weighted_cells_program``), so one megabatch advances the
whole ladder and one host read drains every rung's weight moments.  The
adaptive loop reuses the fused lane planner (``sim.common.plan_lanes``)
with the weighted test: a rung whose relative standard error reached
``target_rse`` stops taking lanes.  Per-cell cursors, weight moments
included, persist through the checkpoint, so a killed grid resumes seed
for seed.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "weighted_cell_stream",
    "weighted_cell_adaptive",
    "eval_weighted_cells",
    "eval_rare_grid",
    "fit_rare_distance",
]


def _stats(host, c):
    from ..sim.common import WeightedStats

    failures, shots, min_w, s1, s2, w1, w2 = host[:7]
    return WeightedStats(failures=int(failures[c]), shots=int(shots[c]),
                         s1=float(s1[c]), s2=float(s2[c]), w1=float(w1[c]),
                         w2=float(w2[c]), min_w=int(min_w[c]))


def weighted_cell_stream(prog, *, progress=None):
    """Fixed-budget weighted fused run with per-cell progress persistence.
    Returns the host carry ``(failures, shots, min_w, s1, s2, w1, w2)``."""
    from ..sim.common import fused_cell_stream

    return fused_cell_stream(prog, progress=progress)


def weighted_cell_adaptive(prog, *, target_rse: float,
                           min_failures: int = 10, progress=None):
    """Adaptive lane reallocation over a weighted fused bucket: one host
    read a megabatch for the whole ladder; rungs whose weighted relative
    standard error reached ``target_rse`` (with at least ``min_failures``
    raw failures: an rse from one lucky shot is noise) stop, and their
    lanes go to the undecided rungs.  Each rung keeps its serial stream.
    Returns the host carry."""
    from ..sim.common import fused_cell_adaptive

    def converged(host, c):
        if host[0][c] < min_failures:
            return False
        rse = _stats(host, c).rse
        return rse is not None and rse <= target_rse

    return fused_cell_adaptive(
        prog, converged=converged, progress=progress,
        mode={"adaptive": round(float(target_rse), 12)})


def eval_weighted_cells(sims, tilts, num_samples: int, *,
                        target_rse: float | None = None,
                        min_failures: int = 10, checkpoint=None,
                        progress_every: int = 1, cell_keys=None,
                        mesh=None) -> list[dict]:
    """Run a rare-event rung ladder as one weighted fused bucket.

    ``sims``: same-shape data engines, one per rung (one seed and K);
    ``tilts``: the rungs' (3,) tilt triples (``rare.tilt.tilt_channel``; a
    rung tilted to its own channel runs the zero tilt).  With
    ``target_rse`` converged rungs' lanes go to the undecided ones;
    otherwise every rung runs the fixed budget.  ``checkpoint``: a
    ``utils.checkpoint.SweepCheckpoint`` for per-cell cursors.  ``mesh``
    (a ``parallel.shots.ShotMesh``) shards the bucket's lane-batches over
    its devices, the budget divided by its size.  Returns one
    dict per rung, ``{index, p, tilt, wer, wer_eb, sigma, ess, rse,
    stats}``, ready for ``fit_rare_distance``.  Each rung's run is
    recorded (``sim.common.record_wer_run``, in one
    ``utils.profiling.engine_scope("wer.rare")``)."""
    from ..utils import profiling

    with profiling.engine_scope("wer.rare"):
        return _eval_weighted_cells(sims, tilts, num_samples, target_rse,
                                    min_failures, checkpoint, progress_every,
                                    cell_keys, mesh)


def _eval_weighted_cells(sims, tilts, num_samples, target_rse, min_failures,
                         checkpoint, progress_every, cell_keys, mesh):
    from ..sim.common import record_wer_run
    from ..sim.data_error import weighted_cells_program
    from ..utils import diagnostics, telemetry
    from ..utils.checkpoint import CellProgress
    from .tilt import weighted_fit_point

    prog = weighted_cells_program(sims, tilts, num_samples, mesh=mesh)
    if cell_keys is not None:
        prog.cell_keys = list(cell_keys)
    progress = None
    if checkpoint is not None and progress_every:
        head = dict(prog.cell_keys[0]) if prog.cell_keys else {
            "engine": "data-w"}
        head["rare_cells"] = [list(t) for t in prog.cell_tags]
        progress = CellProgress(checkpoint, head, every=progress_every)
    try:
        if target_rse is not None:
            host = weighted_cell_adaptive(
                prog, target_rse=float(target_rse),
                min_failures=min_failures, progress=progress)
        else:
            host = weighted_cell_stream(prog, progress=progress)
    finally:
        prog.release()
    results = []
    for i, sim in enumerate(sims):
        ws = _stats(host, i)
        sim.last_weighted = ws
        sim.min_logical_weight = min(sim.min_logical_weight, ws.min_w)
        p_total = float(sum(float(x) for x in sim.channel_probs))
        q_total = float(sum(float(t) for t in tilts[i]))
        # the fit axis: the cell key's p (the direct grids' eval_p) when
        # given, else the channel's total rate
        p_axis = p_total
        if prog.cell_keys is not None and "p" in prog.cell_keys[i]:
            p_axis = float(prog.cell_keys[i]["p"])
        point = weighted_fit_point(p_axis, ws, sim.K, tilt=q_total)
        point["index"] = i
        point["stats"] = ws
        ci = record_wer_run("data", ws.failures, ws.shots, point["wer"],
                            weighted=ws, tilt=q_total)
        cell_key = (prog.cell_keys[i] if prog.cell_keys
                    else {"p": p_total, "code": getattr(sim.code, "name",
                                                        "?"),
                          "noise": "data", "type": sim.eval_logical_type})
        # a dict merge: the CI block and event_fields both carry "ess"
        telemetry.event("cell_done", **{**cell_key, "wer": point["wer"],
                                        **ci, **ws.event_fields(q_total)})
        diagnostics.record_cell(cell_key, point["wer"], ci or None)
        telemetry.count("sweep.cells")
        telemetry.count("rare.cells")
        results.append(point)
    return results


def eval_rare_grid(code, decoder_class, p_list, num_samples: int, *,
                   eval_logical_type: str = "Total", d_eff=None,
                   q_total=None, batch_size: int = 512, seed: int = 0,
                   target_rse: float | None = None, checkpoint=None,
                   device="cuda", **cells_kw) -> list[dict]:
    """The sweep layer's rare-event grid: ``CodeFamily.EvalWER``'s data
    conventions (``decoder_class`` a ``DecoderClass``; ``eval_p`` maps to
    the channel ``[p/2] * 3`` as ``CodeFamily._data_sim`` maps it), one
    engine a rung, each rung's tilt from ``auto_tilt`` (``d_eff`` aims it
    at the failure shell) or ``q_total`` (a scalar or one per rung), the
    ladder run as one weighted fused bucket (``eval_weighted_cells``).
    ``device`` is the engines' (the card unless the caller asks for the
    CPU; the decoder class carries its own); ``cells_kw`` go to
    ``eval_weighted_cells`` (``mesh`` among them).  Returns the fit
    points."""
    from ..sim.data_error import CodeSimulator_DataError
    from .tilt import auto_tilt, tilt_channel

    p_list = [float(p) for p in p_list]
    sims, tilts, cell_keys = [], [], []
    for i, eval_p in enumerate(p_list):
        p = eval_p * 3 / 2
        sims.append(CodeSimulator_DataError(
            code=code,
            decoder_x=decoder_class.GetDecoder({"h": code.hz,
                                                "p_data": eval_p}),
            decoder_z=decoder_class.GetDecoder({"h": code.hx,
                                                "p_data": eval_p}),
            pauli_error_probs=[p / 3, p / 3, p / 3],
            eval_logical_type=eval_logical_type, batch_size=batch_size,
            seed=seed, device=device))
        probs = sims[-1].channel_probs
        p_total = float(sum(float(x) for x in probs))
        if q_total is None:
            q = auto_tilt(p_total, n=code.N, d_eff=d_eff)
        elif np.ndim(q_total):
            q = float(q_total[i])
        else:
            q = float(q_total)
        tilts.append(tilt_channel(probs, q))
        cell_keys.append({"code": getattr(code, "name", None) or "?",
                          "noise": "data", "type": eval_logical_type,
                          "p": eval_p})
    return eval_weighted_cells(sims, tilts, num_samples,
                               target_rse=target_rse, checkpoint=checkpoint,
                               cell_keys=cell_keys, **cells_kw)


def fit_rare_distance(points: list[dict], **curve_fit_kw) -> dict:
    """Sigma-weighted effective-distance fit of rare-event points: each
    cell enters ``sweep.fits.fit_distance_report`` with its delta-method
    WER sigma."""
    from ..sweep.fits import fit_distance_report
    from .tilt import rare_fit_points

    p, wer, sigma = rare_fit_points(points)
    if len(p) < 2:
        raise ValueError(
            "need at least two rare-event points with defined sigma for a "
            "distance fit")
    return fit_distance_report(p, wer, sigma=sigma, **curve_fit_kw)

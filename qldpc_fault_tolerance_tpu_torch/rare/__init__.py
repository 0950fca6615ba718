"""Rare-event estimation: importance sampling for deep sub-threshold WER
(the JAX package's ``rare/``).

Direct Monte-Carlo cannot reach the points an effective-distance fit
needs: at p far below threshold a WER of 1e-10 takes ~1e12 shots.  These
estimators draw errors from TILTED channels (``noise.samplers``
``*_tilted``) or fixed-weight strata, carry the per-shot log importance
weight through the engines' device pipelines, and fold weighted failure
counts and second moments on the device, one host read a megabatch.

Entry points, bottom to top:

  * ``sim.*.WeightedWordErrorRate``: one importance-sampled cell on the
    data or phenom engine;
  * ``tilted_wer`` / ``stratified_wer``: single-cell conveniences
    returning sigma-weighted fit points;
  * ``eval_weighted_cells``: a ladder of rungs as one fused program
    (``parallel.shots.CellFusedDriver(weighted=True)``, per-cell tilts),
    converged rungs' lanes going to the uncertain ones, with per-cell
    checkpoint cursors; ``eval_rare_grid`` builds it from a decoder
    factory with ``CodeFamily.EvalWER``'s conventions;
  * ``fit_rare_distance``: the sigma-weighted distance fit of the points.

The zero tilt (tilt == channel) is bit-exact with the direct engines seed
for seed.
"""
from .estimator import stratified_wer, tilted_wer
from .sweep import (
    eval_rare_grid,
    eval_weighted_cells,
    fit_rare_distance,
    weighted_cell_adaptive,
    weighted_cell_stream,
)
from .tilt import (
    auto_tilt,
    rare_fit_points,
    tilt_channel,
    variance_reduction,
    weighted_fit_point,
)

__all__ = [
    "auto_tilt",
    "eval_rare_grid",
    "eval_weighted_cells",
    "fit_rare_distance",
    "rare_fit_points",
    "stratified_wer",
    "tilt_channel",
    "tilted_wer",
    "variance_reduction",
    "weighted_cell_adaptive",
    "weighted_cell_stream",
    "weighted_fit_point",
]

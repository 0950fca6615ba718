"""Reference ``src/QuantumExanderCodesGene.py`` API, backed by codes/codegen.

The reference's graph functions operate on networkx graphs; the native layer
works on check matrices directly, so the graph-typed helpers here accept and
return check matrices (the notebooks only thread them between these same
functions and ``TannerGraphToCheckMat``, which is therefore the identity).
"""
import numpy as np

from ..codes import (
    GeneRandGraphsLargeGirthFinal,
    GetClassicalCodeParams,
    QuantumExpanderFromCheckMat,
    hgp,
    improve_girth,
    random_biregular_tanner,
    tanner_girth,
)
from ..codes.loaders import save_object
from ._paths import load_object_compat as load_object

__all__ = [
    "Girth", "QuantumExpanderFromCheckMat", "save_object", "load_object",
    "TannerGraphToCheckMat", "GetClassicalCodeParams", "RandomaGraphs",
    "GeneRandGraphsLargeGirth", "RandSwapEdges1",
    "GeneRandGraphsLargeGirthFinal", "hgp",
]


def Girth(H):
    """Exact Tanner girth (reference src/QuantumExanderCodesGene.py:26-28)."""
    return tanner_girth(H)


def TannerGraphToCheckMat(H):
    """Identity under the check-matrix representation
    (reference src/QuantumExanderCodesGene.py:44-63)."""
    return np.asarray(H)


def RandomaGraphs(n0, Delta_c, Delta_v):
    """Random simple biregular Tanner graph as a check matrix
    (reference src/QuantumExanderCodesGene.py:181-233)."""
    return random_biregular_tanner(n0, Delta_c, Delta_v)


def RandSwapEdges1(H, max_iter, target_girth):
    """Girth-raising swaps; returns (H, success)
    (reference src/QuantumExanderCodesGene.py:268-310)."""
    return improve_girth(H, target_girth, max_iter=max_iter)


def GeneRandGraphsLargeGirth(n0, Delta_c, Delta_v, min_girth, min_distance,
                             num, max_iter):
    """Rejection-sample biregular codes with girth and distance floors
    (reference src/QuantumExanderCodesGene.py:235-251)."""
    from ..codes import classical_code_distance

    out = []
    for _ in range(int(max_iter)):
        if len(out) >= num:
            break
        H = random_biregular_tanner(n0, Delta_c, Delta_v)
        if tanner_girth(H) >= min_girth and \
                classical_code_distance(H) >= min_distance:
            out.append(H)
    if len(out) < num:
        # non-convergence is a signal, not stdout noise: warn + count it
        import warnings

        from ..utils import telemetry

        telemetry.count("codegen.max_iter_reached")
        warnings.warn(
            f"GeneRandGraphsLargeGirth: max_iter={max_iter} reached with "
            f"{len(out)}/{num} codes", stacklevel=2)
    return out

from . import gf2
from .css import CssCode, css_logicals
from .codegen import (
    GeneRandGraphsLargeGirthFinal,
    GetClassicalCodeParams,
    QuantumExpanderFromCheckMat,
    improve_girth,
    min_cycle_edges,
    random_biregular_tanner,
    tanner_girth,
)
from .hgp import hgp, rep_code, ring_code, classical_code_distance
from .loaders import (
    load_code,
    load_mat_pair,
    load_npy_pair,
    load_object,
    load_pickle_code,
    save_code,
    save_object,
)

__all__ = [
    "gf2",
    "GeneRandGraphsLargeGirthFinal",
    "GetClassicalCodeParams",
    "QuantumExpanderFromCheckMat",
    "improve_girth",
    "min_cycle_edges",
    "random_biregular_tanner",
    "tanner_girth",
    "CssCode",
    "css_logicals",
    "hgp",
    "rep_code",
    "ring_code",
    "classical_code_distance",
    "load_code",
    "load_mat_pair",
    "load_npy_pair",
    "load_object",
    "load_pickle_code",
    "save_code",
    "save_object",
]

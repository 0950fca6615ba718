"""Reference ``src/par2gen.py`` API, backed by utils/par2gen."""
from ..utils.par2gen import (
    GtoH,
    GtoP,
    HtoG,
    HtoP,
    LinearBlockCode,
    arrayToString,
    d,
    intToArray,
    matrixMultiplicationEquations,
    nCr,
    w,
)

__all__ = [
    "HtoG", "GtoH", "GtoP", "HtoP", "matrixMultiplicationEquations",
    "w", "d", "intToArray", "arrayToString", "nCr", "LinearBlockCode",
]

from . import gf2
from .css import CssCode, css_logicals
from .hgp import hgp, rep_code, ring_code
from .loaders import load_code

__all__ = [
    "gf2",
    "CssCode",
    "css_logicals",
    "hgp",
    "rep_code",
    "ring_code",
    "load_code",
]

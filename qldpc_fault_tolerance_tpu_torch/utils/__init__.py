from . import par2gen
from .device import resolve_device
from .par2gen import GtoH, GtoP, HtoG, HtoP, LinearBlockCode

__all__ = ["resolve_device", "par2gen", "HtoG", "GtoH", "HtoP", "GtoP",
           "LinearBlockCode"]

"""Native (C++) host code: OSD post-processing and GF(2) rank.

``osd.cpp`` is the port's own copy of the JAX package's host OSD.  It is
built with ``g++`` at first use into ``build/torch_native/`` at the root of
the checkout (never next to the source), keyed on a hash of the flags and
the source, and loaded with ``ctypes``.  A failed build raises: the host
OSD has no silent numpy stand-in (``decoders.osd._osd_numpy`` is its plain
version and test oracle, called by name).  Nothing here runs when the
module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["SOURCE", "BUILD_DIR", "library_path", "load_native", "gf2_rank"]

SOURCE = Path(__file__).resolve().parent / "osd.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    """Where the library of this source and these flags is built."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libqldpc_native_{h.hexdigest()[:16]}.so"


def _build(target: Path) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the host OSD needs it on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    res = subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed for _native/osd.cpp:\n"
                           f"{res.stderr[-2000:]}")
    os.replace(tmp, target)


def load_native() -> ctypes.CDLL:
    """The loaded host library, built on first use; raises if it cannot be
    built or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        target = library_path()
        if not target.exists():
            _build(target)
        lib = ctypes.CDLL(str(target))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        dp = ctypes.POINTER(ctypes.c_double)
        lib.qldpc_osd_decode_batch.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int,       # H, m, n
            u8p, dp, ctypes.c_int,                 # syndromes, llrs, batch
            dp, ctypes.c_int, ctypes.c_int,        # cost, method, order
            ctypes.c_int, u8p,                     # nthreads, out
        ]
        lib.qldpc_osd_decode_batch.restype = ctypes.c_int
        lib.qldpc_gf2_rank.argtypes = [u8p, ctypes.c_int, ctypes.c_int]
        lib.qldpc_gf2_rank.restype = ctypes.c_int
        _lib = lib
        return lib


def gf2_rank(h) -> int:
    """GF(2) rank of a {0,1} matrix, in C++."""
    import numpy as np

    h = np.ascontiguousarray(np.asarray(h, np.uint8) & 1)
    m, n = h.shape
    return int(load_native().qldpc_gf2_rank(
        h.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), m, n))

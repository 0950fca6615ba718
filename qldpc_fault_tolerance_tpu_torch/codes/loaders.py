"""Loaders for the code assets: the repo's ``codes_lib_tpu/*.npz`` and the
reference's ``codes_lib/`` (pickled bposd.hgp objects, ``.mat`` Hx/Hz
pairs, ``.npy`` matrices).  The pickles name bposd classes;
``load_pickle_code`` unpickles them without bposd installed by shimming the
class lookup and then rebuilding a CssCode from the stored arrays.

A pickle may also name a class of the JAX package (a ``CssCode`` saved
there).  The unpickler never resolves a module under ``jax``, ``jaxlib`` or
``qldpc_fault_tolerance_tpu``: such a class is shimmed like a bposd one, so
loading it imports nothing of JAX.
"""
from __future__ import annotations

import os
import pickle

import numpy as np

from . import gf2
from .css import CssCode

__all__ = [
    "load_pickle_code",
    "load_mat_pair",
    "load_npy_pair",
    "save_code",
    "load_code",
    "load_object",
    "save_object",
]

# top-level packages a pickle may name but the port never imports
_FOREIGN = frozenset({"jax", "jaxlib", "qldpc_fault_tolerance_tpu"})


def _is_foreign(module: str) -> bool:
    return module.split(".")[0] in _FOREIGN


class _Shim:
    """Absorbs the state of any unpicklable class instance."""

    def __init__(self, *a, **k):
        pass


class _PermissiveUnpickler(pickle.Unpickler):
    """Shims unresolvable classes, classes of a foreign package (JAX's, or
    one a foreign compat layer registered under a reference name), and
    classes the compat layer stubs with *functions* (bposd.hgp.hgp): NEWOBJ
    needs a type.  Stub packages are recognized by the ``__qldpc_stub__``
    marker ``compat.install()`` sets on them; everything else resolvable
    passes through untouched (numpy's ``_reconstruct`` is a function
    legitimately used via REDUCE and must not be shimmed)."""

    @staticmethod
    def _is_stub_module(module: str) -> bool:
        import sys as _sys

        top = _sys.modules.get(module.split(".")[0])
        return bool(getattr(top, "__qldpc_stub__", False))

    def find_class(self, module, name):
        obj = None
        if not _is_foreign(module):
            try:
                obj = super().find_class(module, name)
            except Exception:
                obj = None
        if obj is not None and _is_foreign(getattr(obj, "__module__", None) or ""):
            obj = None
        if obj is not None and (
            isinstance(obj, type) or not self._is_stub_module(module)
        ):
            return obj
        return type(name, (_Shim,), {"__module__": module})


def load_object(filename: str):
    """Reference-compatible load_object, tolerant of missing third-party
    modules inside the pickle."""
    with open(filename, "rb") as f:
        return _PermissiveUnpickler(f).load()


def save_object(obj, filename: str) -> None:
    """Reference-compatible save_object."""
    with open(filename, "wb") as f:
        pickle.dump(obj, f, pickle.HIGHEST_PROTOCOL)


def load_pickle_code(path: str) -> CssCode:
    """Load a pickled code object (e.g. codes_lib/hgp_34_n225.pkl) into a CssCode."""
    obj = load_object(path)
    d = obj if isinstance(obj, dict) else obj.__dict__
    kwargs = {}
    for key in ("hx", "hz", "lx", "lz"):
        v = d.get(key)
        if v is None:
            continue
        if hasattr(v, "toarray"):
            v = v.toarray()
        kwargs[key] = gf2.to_gf2(v)
    code = CssCode(name=os.path.splitext(os.path.basename(path))[0], **kwargs)
    if "D" in d and d["D"] is not None:
        try:
            code.D = int(d["D"])
        except (TypeError, ValueError):
            pass
    return code


def _mat_matrix(path: str) -> np.ndarray:
    from scipy.io import loadmat

    data = loadmat(path)
    keys = [k for k in data if not k.startswith("__")]
    if len(keys) != 1:
        raise ValueError(f"expected one matrix in {path}, found keys {keys}")
    m = data[keys[0]]
    if hasattr(m, "toarray"):
        m = m.toarray()
    return gf2.to_gf2(m)


def load_mat_pair(hx_path: str, hz_path: str | None = None, name: str = "") -> CssCode:
    """Load an Hx/Hz ``.mat`` pair (GB codes A1-A4, LP codes)."""
    if hz_path is None:
        if "_hx" not in hx_path:
            raise ValueError("cannot infer hz path")
        hz_path = hx_path.replace("_hx", "_hz")
    hx = _mat_matrix(hx_path)
    hz = _mat_matrix(hz_path)
    if not name:
        name = os.path.basename(hx_path).replace("_hx.mat", "")
    return CssCode(hx=hx, hz=hz, name=name)


def load_npy_pair(hx_path: str, hz_path: str | None = None, name: str = "") -> CssCode:
    """Load an Hx/Hz ``.npy`` pair (tanner_code1)."""
    if hz_path is None:
        hz_path = hx_path.replace("_hx", "_hz")
    hx = gf2.to_gf2(np.load(hx_path))
    hz = gf2.to_gf2(np.load(hz_path))
    if not name:
        name = os.path.basename(hx_path).replace("_hx.npy", "")
    return CssCode(hx=hx, hz=hz, name=name)


def save_code(code: CssCode, path: str) -> None:
    """Persist a CssCode as .npz (the native format; avoids pickle fragility)."""
    np.savez_compressed(
        path,
        hx=code.hx,
        hz=code.hz,
        lx=code.lx,
        lz=code.lz,
        name=np.array(code.name),
        D=np.array(-1 if code.D is None else code.D),
    )


def load_code(path: str) -> CssCode:
    """Load a CssCode: dispatches on extension (.npz/.pkl/.mat/.npy)."""
    path = str(path)
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as data:
            code = CssCode(
                hx=data["hx"], hz=data["hz"], lx=data["lx"], lz=data["lz"],
                name=str(data["name"]),
            )
            d = int(data["D"])
        code.D = None if d < 0 else d
        return code
    if path.endswith(".pkl"):
        return load_pickle_code(path)
    if path.endswith(".mat"):
        return load_mat_pair(path)
    if path.endswith(".npy"):
        return load_npy_pair(path)
    raise ValueError(f"unknown code format: {path}")

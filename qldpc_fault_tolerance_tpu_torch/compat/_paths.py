"""Author-machine path redirection for notebook parity.

The reference notebooks hard-code absolute paths from the author's laptop
(``/Users/qian/Box Sync/.../codes_lib/hgp_34_n625_q1.pkl`` etc., Single-Shot
ckpt cell 8) — they would fail on any other machine even with the original
packages installed.  ``load_object_compat`` keeps those cells runnable:

  * a path that exists is loaded as-is;
  * otherwise the basename is looked up in the reference ``codes_lib/``
    (``QLDPC_REF_CODES_LIB``, default ``/root/reference/codes_lib``);
  * otherwise, for the hgp_34 family members, the regenerated code of the
    same [[N,K]] from the repo's ``codes_lib_tpu/`` is substituted (exact
    for n225, which is rebuilt from the reference seed) — the substitution
    is reported once per file so a run's provenance is visible.
"""
from __future__ import annotations

import os
import re
import warnings

from ..codes.loaders import load_code, load_object

_REFERENCE_CODES_LIB = os.environ.get("QLDPC_REF_CODES_LIB",
                                      "/root/reference/codes_lib")
_REPO_CODES_LIB = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "codes_lib_tpu",
)
_warned: set[str] = set()


def load_object_compat(filename: str):
    if os.path.exists(filename):
        return load_object(filename)
    base = os.path.basename(filename)
    ref = os.path.join(_REFERENCE_CODES_LIB, base)
    if os.path.exists(ref):
        return load_object(ref)
    m = re.match(r"hgp_34_(n\d+)", base)
    if m:
        npz = os.path.join(_REPO_CODES_LIB, f"hgp_34_{m.group(1)}.npz")
        if os.path.exists(npz):
            if base not in _warned:
                _warned.add(base)
                warnings.warn(
                    f"{base} is absent from the reference codes_lib; "
                    f"substituting the regenerated family member {npz} "
                    "(same [[N,K]], recorded seed)",
                    stacklevel=2,
                )
            return load_code(npz)
    raise FileNotFoundError(filename)

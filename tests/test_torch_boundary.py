"""Import boundary of the PyTorch port: no module of
qldpc_fault_tolerance_tpu_torch/, and not chip_smoke.py, imports jax or
anything of the JAX package qldpc_fault_tolerance_tpu."""
import ast
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "qldpc_fault_tolerance_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "qldpc_fault_tolerance_tpu")


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_modules(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def _forbidden(name):
    top = name.split(".")[0]
    return top in FORBIDDEN


def test_port_has_sources():
    assert len(_sources()) > 10


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_scanner_catches_forbidden_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import jax.numpy as jnp\n"
                   "from qldpc_fault_tolerance_tpu.codes import gf2\n"
                   "import importlib\nimportlib.import_module('jax')\n"
                   "from qldpc_fault_tolerance_tpu_torch.ops import bp\n")
    found = [m for m in _imported_modules(str(src)) if _forbidden(m)]
    assert found == ["jax.numpy", "qldpc_fault_tolerance_tpu.codes", "jax"]


def test_every_kernel_source_is_scanned_and_built():
    """Every module of the port is scanned above (the BP head family in
    ops/bp_kernel.py included), and every CUDA source under csrc/ is one
    the build compiles, with a plain C interface (no PyTorch or JAX
    headers)."""
    from qldpc_fault_tolerance_tpu_torch.ops import _kernels

    scanned = {os.path.relpath(p, PORT) for p in _sources()}
    assert {os.path.join("ops", "bp_kernel.py"), os.path.join("ops", "bp.py"),
            os.path.join("decoders", "bp_decoders.py")} <= scanned
    csrc = os.path.join(PORT, "csrc")
    cu = sorted(f[:-3] for f in os.listdir(csrc) if f.endswith(".cu"))
    assert cu == sorted(_kernels.SOURCES)
    assert {"bp_int8", "bp_minsum"} <= set(cu) and "bp_dense" not in cu
    for name in os.listdir(csrc):
        text = open(os.path.join(csrc, name), encoding="utf-8").read()
        for header in re.findall(r"#\s*include\s*<([^>]+)>", text):
            assert header.split("/")[0] not in ("torch", "ATen", "c10",
                                                "pybind11"), (name, header)

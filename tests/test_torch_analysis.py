"""The port's lint (``qldpc_fault_tolerance_tpu_torch.analysis``), rule R007:
clean on the tree; each of its four failures planted on a copy of the
checkout (the port package and ``chip_smoke.py``) in ``tmp_path`` and
reported at its file:line; a suppression masks a finding and an unused one
is R000; the command line exits 0 on the tree and 1 on a drift.
"""
import os
import shutil
import subprocess
import sys

import pytest

from qldpc_fault_tolerance_tpu_torch.analysis import (
    KERNEL_CONTRACTS,
    KernelContractRule,
    analyze_repo,
    repo_root,
)
from qldpc_fault_tolerance_tpu_torch.analysis.rules_kernels import (
    launch_symbols,
)

PKG = "qldpc_fault_tolerance_tpu_torch"
REPO = repo_root()


def lint(root):
    """R007 alone on the checkout at ``root``, through the lint's one
    entry point."""
    return analyze_repo(base=root, rules=[KernelContractRule()])


def _copy(tmp_path):
    shutil.copytree(os.path.join(REPO, PKG), tmp_path / PKG,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    return tmp_path


def _edit(path, old, new, count=1):
    text = path.read_text()
    assert text.count(old) >= count, old
    path.write_text(text.replace(old, new, count))


def _line_of(path, needle):
    for i, line in enumerate(path.read_text().splitlines(), 1):
        if needle in line:
            return i
    raise AssertionError(needle)


def test_r007_is_clean_on_the_tree():
    result = lint(REPO)
    assert result.findings == [], [f.render() for f in result.findings]
    assert result.rules == ["R007"] and result.files > 50


def test_every_extern_launch_is_registered():
    csrc = os.path.join(REPO, PKG, "csrc")
    launches = set()
    for fn in os.listdir(csrc):
        if fn.endswith(".cu"):
            with open(os.path.join(csrc, fn)) as fh:
                launches |= {(fn[:-3], s) for s, _ in launch_symbols(
                    fh.read())}
    assert launches == {(c.source, c.launch) for c in KERNEL_CONTRACTS}
    assert len(launches) == 13


def test_wrapper_off_its_plain_version_is_reported(tmp_path):
    root = _copy(tmp_path)
    mod = root / PKG / "ops" / "osd_cs_device.py"
    _edit(mod, "        return cs_sweep_plain(dplane, xflat, base, w=w, "
               "pat_chunk=pat_chunk)",
          "        return _private_sweep(dplane, xflat, base, w, pat_chunk)")
    mod.write_text(mod.read_text() + "\n\ndef _private_sweep(*args):\n"
                   "    return args\n")
    (f,) = lint(str(root)).findings
    assert (f.file, f.line, f.rule) == (
        f"{PKG}/ops/osd_cs_device.py", _line_of(mod, "def cs_sweep("),
        "R007")
    assert "cs_sweep_plain" in f.message


def test_wrapper_off_its_library_is_reported(tmp_path):
    root = _copy(tmp_path)
    mod = root / PKG / "ops" / "bp_kernel.py"
    _edit(mod, '_kernels.library("bp_int8").bp_int8_launch',
          "getattr(object(), 'bp_int8_launch')")
    (f,) = lint(str(root)).findings
    assert f.file == f"{PKG}/ops/bp_kernel.py"
    assert f.line == _line_of(mod, "def bp_head_int8(")
    assert 'library("bp_int8")' in f.message


def test_launch_symbol_missing_from_its_source_is_reported(tmp_path):
    root = _copy(tmp_path)
    cu = root / PKG / "csrc" / "gf2_residual.cu"
    _edit(cu, "gf2_residual_launch(", "gf2_residual_run(")
    (f,) = lint(str(root)).findings
    assert (f.file, f.line) == (f"{PKG}/csrc/gf2_residual.cu", 1)
    assert "gf2_residual_launch" in f.message


def test_unregistered_launch_is_reported(tmp_path):
    root = _copy(tmp_path)
    cu = root / PKG / "csrc" / "cs_sweep.cu"
    cu.write_text(cu.read_text() + '\nextern "C" int cs_extra_launch(int x) '
                  "{ return x; }\n")
    (f,) = lint(str(root)).findings
    assert (f.file, f.line) == (f"{PKG}/csrc/cs_sweep.cu",
                                _line_of(cu, "cs_extra_launch"))
    assert "cs_extra_launch" in f.message


def test_plain_version_missing_from_chip_smoke_is_reported(tmp_path):
    root = _copy(tmp_path)
    smoke = root / "chip_smoke.py"
    smoke.write_text(smoke.read_text().replace("cs_sweep_rows_plain",
                                               "cs_rows_reference"))
    (f,) = lint(str(root)).findings
    assert (f.file, f.line) == ("chip_smoke.py", 1)
    assert "cs_sweep_rows_plain" in f.message


def test_suppression_masks_and_unused_suppression_is_r000(tmp_path):
    root = _copy(tmp_path)
    mod = root / PKG / "ops" / "osd_cs_device.py"
    _edit(mod, "        return cs_sweep_plain(dplane, xflat, base, w=w, "
               "pat_chunk=pat_chunk)",
          "        return (dplane, xflat, base)")
    _edit(mod, "def cs_sweep(",
          "# qldpc: ignore[R007]\ndef cs_sweep(")
    result = lint(str(root))
    assert result.findings == [] and result.suppressed == 1
    # the same comment on a line with no finding
    _edit(mod, "# qldpc: ignore[R007]\ndef cs_sweep(", "def cs_sweep(")
    _edit(mod, "        return (dplane, xflat, base)",
          "        return cs_sweep_plain(dplane, xflat, base, w=w, "
          "pat_chunk=pat_chunk)")
    sig = ("def cs_planes(rows_piv, signed_piv, cost_free, free_perm, "
           "n: int, w: int):")
    _edit(mod, sig, sig + "  # qldpc: ignore[R007]")
    (f,) = lint(str(root)).findings
    assert (f.rule, f.line) == ("R000", _line_of(mod, "def cs_planes("))


@pytest.mark.parametrize("drift", [False, True])
def test_command_line_exit_code(tmp_path, drift):
    root = REPO
    if drift:
        root = str(_copy(tmp_path))
        _edit(tmp_path / PKG / "csrc" / "bp_int8.cu", "bp_int8_launch(",
              "bp_int8_go(")
    proc = subprocess.run(
        [sys.executable, "-m", f"{PKG}.analysis", "--root", root, "--json"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == (1 if drift else 0), proc.stdout + proc.stderr
    assert ('"rule": "R007"' in proc.stdout) == drift

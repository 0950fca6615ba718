"""The port's lint baseline (``analysis/core.py`` ``Baseline`` /
``BaselineEntry``, ``analysis/baseline.json``): the round trip against the
JAX package's format (each package reads the other's file), budgets that
absorb findings and stale entries, ``analyze_repo``'s JAX signature
(``paths``, ``rules``, ``baseline_path``, ``base``) on a copy of the
checkout with a planted finding, and the command line's ``--baseline``,
``--no-baseline`` and ``--update-baseline``."""
import json
import os
import shutil
import subprocess
import sys

from qldpc_fault_tolerance_tpu.analysis.core import Baseline as JBaseline
from qldpc_fault_tolerance_tpu.analysis.core import \
    BaselineEntry as JBaselineEntry
from qldpc_fault_tolerance_tpu.analysis.core import Finding as JFinding
from qldpc_fault_tolerance_tpu_torch.analysis import (
    BarePrintRule,
    Baseline,
    BaselineEntry,
    Finding,
    KernelContractRule,
    analyze_repo,
    default_baseline_path,
    repo_root,
)

PKG = "qldpc_fault_tolerance_tpu_torch"
REPO = repo_root()


def test_shipped_baseline_is_empty_and_the_tree_clean():
    with open(default_baseline_path()) as fh:
        assert json.load(fh) == {"entries": [], "version": 1}
    result = analyze_repo()
    assert result.findings == [] and result.baselined == 0
    assert result.stale_baseline == []


def test_round_trip_in_both_formats(tmp_path):
    entries = [("a/b.py", "R101", 2, "why"), ("a/a.py", "R006", 1, "")]
    ours, theirs = tmp_path / "port.json", tmp_path / "jax.json"
    Baseline([BaselineEntry(*e) for e in entries]).save(str(ours))
    JBaseline([JBaselineEntry(*e) for e in entries]).save(str(theirs))
    assert ours.read_text() == theirs.read_text()
    for path in (ours, theirs):
        loaded = Baseline.load(str(path))
        assert [e.to_dict() for e in loaded.entries] == [
            JBaselineEntry(*e).to_dict()
            for e in sorted(entries, key=lambda e: (e[0], e[1]))]
        assert loaded.entry_for("a/b.py", "R101").count == 2
        assert loaded.entry_for("a/b.py", "R102") is None
    assert Baseline.load(str(tmp_path / "none.json")).entries == []


def test_from_findings_keeps_surviving_reasons():
    prev = Baseline([BaselineEntry("x.py", "R101", 5, "kept reason")])
    found = [Finding("x.py", 3, "R101", "m"), Finding("x.py", 9, "R101", "m"),
             Finding("y.py", 1, "R102", "m")]
    jprev = JBaseline([JBaselineEntry("x.py", "R101", 5, "kept reason")])
    jfound = [JFinding(f.file, f.line, f.rule, f.message) for f in found]
    new = Baseline.from_findings(found, previous=prev)
    assert [e.to_dict() for e in new.entries] == [
        e.to_dict() for e in JBaseline.from_findings(jfound,
                                                     previous=jprev).entries]
    assert new.entry_for("x.py", "R101").reason == "kept reason"
    assert new.entry_for("y.py", "R102").count == 1


def _copy_with_print(tmp_path):
    shutil.copytree(os.path.join(REPO, PKG), tmp_path / PKG,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    mod = tmp_path / PKG / "utils" / "timeseries.py"
    mod.write_text(mod.read_text() + "\n\ndef _shout():\n    print('x')\n")
    return f"{PKG}/utils/timeseries.py"


def test_analyze_repo_applies_a_jax_format_baseline(tmp_path):
    rel = _copy_with_print(tmp_path)
    root = str(tmp_path)
    (f,) = analyze_repo(base=root).findings
    assert (f.file, f.rule) == (rel, "R101")
    jax_baseline = tmp_path / "baseline.json"
    JBaseline([JBaselineEntry(rel, "R101", 1, "a planted print"),
               JBaselineEntry(f"{PKG}/ops/bp.py", "R102", 1, "stale")]
              ).save(str(jax_baseline))
    result = analyze_repo(base=root, baseline_path=str(jax_baseline))
    assert result.findings == [] and result.baselined == 1
    assert [(e.file, e.rule) for e in result.stale_baseline] == [
        (f"{PKG}/ops/bp.py", "R102")]
    # only R007 ran: the R101 budget is neither used nor stale
    r007 = analyze_repo(base=root, rules=[KernelContractRule()],
                        baseline_path=str(jax_baseline))
    assert r007.rules == ["R007"] and r007.findings == []
    assert r007.stale_baseline == []
    # paths narrow the run, relative to base
    one = analyze_repo([f"{PKG}/utils"], base=root, rules=[BarePrintRule()])
    assert [g.file for g in one.findings] == [rel]
    assert one.files < analyze_repo(base=root).files


def _cli(*args, cwd):
    return subprocess.run(
        [sys.executable, "-m", f"{PKG}.analysis", *args], cwd=cwd,
        capture_output=True, text=True, timeout=120)


def test_command_line_baseline_options(tmp_path):
    rel = _copy_with_print(tmp_path)
    root = str(tmp_path)
    path = str(tmp_path / "b.json")
    proc = _cli("--root", root, "--baseline", path, cwd=REPO)
    assert proc.returncode == 1 and rel in proc.stdout
    proc = _cli("--root", root, "--baseline", path, "--update-baseline",
                cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert [e.to_dict() for e in JBaseline.load(path).entries] == [
        {"file": rel, "rule": "R101", "count": 1,
         "reason": "unreviewed (added by --update-baseline)"}]
    proc = _cli("--root", root, "--baseline", path, "--json", cwd=REPO)
    assert proc.returncode == 0, proc.stdout
    doc = json.loads(proc.stdout)
    assert doc["baselined"] == 1 and doc["findings"] == []
    proc = _cli("--root", root, "--baseline", path, "--no-baseline",
                cwd=REPO)
    assert proc.returncode == 1
    assert _cli("--root", root, "nowhere", cwd=REPO).returncode == 2

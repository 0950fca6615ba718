"""The port's lint: ``python -m qldpc_fault_tolerance_tpu_torch.analysis``.

Rules, in id order:

==== =====================================================================
R000 engine-owned: unused suppression comment / unparsable file
R005 event-kind / frozen-schema drift against ``utils/telemetry.py``
     (``rules_runtime.py``)
R006 unlocked write to module-level mutable state in ``serve/`` and
     ``utils/`` (``rules_runtime.py``)
R007 kernel/twin contract drift: each hand-written kernel's wrapper still
     reaches its plain version and its launch, every ``extern "C"`` launch
     in ``csrc/`` is registered, and ``chip_smoke.py`` names every plain
     version (``rules_kernels.py``)
R008 faultinject site not registered in ``SITES`` / not unique / never
     planted (``rules_runtime.py``)
R009 CUDA graph captured outside ``parallel/shots.py`` ``_capture_graph``
     and ``utils/device.py`` ``graph_capture`` (``rules_runtime.py``)
R101 bare print() in library code (``rules_style.py``)
R102 bare sleep / ad-hoc retry loop outside ``utils/resilience.py``
     (``rules_style.py``)
==== =====================================================================

``# qldpc: ignore[R006]`` (several ids comma-separated) suppresses a
finding on its line; an unused suppression is R000.  The JAX package's
jit, tracer, PRNG-key and donation rules (R001-R004) have no counterpart
here: the port has no traced code.
"""
from __future__ import annotations

from .core import (
    AnalysisContext,
    AnalysisResult,
    Finding,
    Rule,
    SourceModule,
    collect_modules,
    package_root,
    repo_root,
    run_analysis,
)
from .rules_kernels import KERNEL_CONTRACTS, KernelContract, KernelContractRule
from .rules_runtime import (CaptureSiteRule, FaultSiteRule,
                            LockDisciplineRule, SchemaDriftRule)
from .rules_style import BarePrintRule, BareSleepRule

__all__ = ["AnalysisContext", "AnalysisResult", "Finding", "Rule",
           "SourceModule", "collect_modules", "package_root", "repo_root",
           "run_analysis", "KERNEL_CONTRACTS", "KernelContract",
           "KernelContractRule", "SchemaDriftRule", "LockDisciplineRule",
           "FaultSiteRule", "CaptureSiteRule", "BarePrintRule",
           "BareSleepRule", "analyze_repo", "default_rules", "lint"]


def default_rules() -> list:
    """The shipped rule set, in id order, instantiated fresh per call."""
    return [
        SchemaDriftRule(),
        LockDisciplineRule(),
        KernelContractRule(),
        FaultSiteRule(),
        CaptureSiteRule(),
        BarePrintRule(),
        BareSleepRule(),
    ]


def _modules(root: str):
    import os

    return collect_modules(
        [os.path.join(root, "qldpc_fault_tolerance_tpu_torch")], root)


def analyze_repo(root: str | None = None, rules=None) -> AnalysisResult:
    """Lint the port package under ``root`` (the repo root by default) with
    every rule (``default_rules()``), as the command line does."""
    root = root or repo_root()
    return run_analysis(_modules(root), rules or default_rules(), root)


def lint(root: str | None = None, rules=None) -> AnalysisResult:
    """Lint the port package under ``root`` with ``rules``, by default the
    kernel-contract rule R007 alone; ``analyze_repo`` runs every rule."""
    root = root or repo_root()
    return run_analysis(_modules(root), rules or [KernelContractRule()], root)

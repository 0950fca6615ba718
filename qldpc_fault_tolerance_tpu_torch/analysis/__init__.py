"""The port's lint: ``python -m qldpc_fault_tolerance_tpu_torch.analysis``.

One rule so far, R007 (``rules_kernels.py``): each hand-written kernel's
wrapper still reaches its plain version and its launch, every ``extern
"C"`` launch in ``csrc/`` is registered, and ``chip_smoke.py`` names every
plain version.  ``# qldpc: ignore[R007]`` suppresses a finding on its
line; an unused suppression is R000.  The JAX package's Python rules that
the port has not taken yet (R005 event-schema drift, R006 unlocked module
state, R008 fault-injection sites, R009 cache bypass) are listed in
ROADMAP.md.
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

__all__ = ["AnalysisContext", "AnalysisResult", "Finding", "Rule",
           "SourceModule", "collect_modules", "package_root", "repo_root",
           "run_analysis", "KERNEL_CONTRACTS", "KernelContract",
           "KernelContractRule", "default_rules", "lint"]


def default_rules() -> list:
    return [KernelContractRule()]


def lint(root: str | None = None, rules=None) -> AnalysisResult:
    """Lint the port package under ``root`` (the repo root by default)."""
    import os

    root = root or repo_root()
    modules = collect_modules(
        [os.path.join(root, "qldpc_fault_tolerance_tpu_torch")], root)
    return run_analysis(modules, rules or default_rules(), root)

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
finding on its line; an unused suppression is R000.  Findings within the
budgets of ``analysis/baseline.json`` (``Baseline``, the JAX package's
format; empty while the tree is clean) fail nothing.  The JAX package's
jit, tracer, PRNG-key and donation rules (R001-R004) have no counterpart
here: the port has no traced code.
"""
from __future__ import annotations

import os

from .core import (
    AnalysisContext,
    AnalysisResult,
    Baseline,
    BaselineEntry,
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

__all__ = ["AnalysisContext", "AnalysisResult", "Baseline", "BaselineEntry",
           "Finding", "Rule", "SourceModule", "collect_modules",
           "package_root", "repo_root", "run_analysis", "KERNEL_CONTRACTS",
           "KernelContract", "KernelContractRule", "SchemaDriftRule",
           "LockDisciplineRule", "FaultSiteRule", "CaptureSiteRule",
           "BarePrintRule", "BareSleepRule", "analyze_repo", "default_rules",
           "default_baseline_path", "DEFAULT_TARGETS"]


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


# what the lint parses by default, relative to the checkout's root
DEFAULT_TARGETS = ("qldpc_fault_tolerance_tpu_torch",)


def default_baseline_path() -> str:
    return os.path.join(package_root(), "analysis", "baseline.json")


def analyze_repo(paths=None, *, rules=None, baseline_path=None,
                 base=None) -> AnalysisResult:
    """The lint's one entry point, with the JAX package's signature: parse
    ``paths`` (by default ``DEFAULT_TARGETS``; relative to ``base``, the
    checkout's root, by default this one) and run ``rules`` (by default
    every rule, ``default_rules()``; ``[KernelContractRule()]`` runs R007
    alone) against the baseline at ``baseline_path`` (by default
    ``default_baseline_path()``)."""
    base = base or repo_root()
    modules = collect_modules(list(paths or DEFAULT_TARGETS), base)
    baseline = Baseline.load(baseline_path or default_baseline_path())
    return run_analysis(modules, rules if rules is not None
                        else default_rules(), base, baseline)

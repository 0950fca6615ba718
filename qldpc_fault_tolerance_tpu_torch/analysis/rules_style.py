"""R101 (bare print) and R102 (bare sleep / ad-hoc retry loops): the JAX
package's style rules, here over the port package.

The AST versions are sharper than a grep: prints in docstrings or strings
cannot false-positive, and aliased imports (``import time as t``) cannot
false-negative.  Both rules take the package prefix and their exemptions
as arguments, so the same rules lint another checkout or package.
"""
from __future__ import annotations

import ast
import re
from typing import Iterable

from .callgraph import module_imports, module_nodes
from .core import Finding, Rule, SourceModule

__all__ = ["BarePrintRule", "BareSleepRule"]

_PKG = "qldpc_fault_tolerance_tpu_torch/"


class BarePrintRule(Rule):
    """Library code must log/warn/count, never print.  utils/par2gen.py is
    the teaching module (its prints ARE the product), as is its
    reference-name shim; the analyzer CLI's stdout is likewise its
    product."""

    id = "R101"
    title = "bare print() in library code"

    DEFAULT_EXEMPT = (
        _PKG + "utils/par2gen.py",
        _PKG + "compat/par2gen.py",
        _PKG + "analysis/__main__.py",
    )

    def __init__(self, exempt: tuple = DEFAULT_EXEMPT,
                 package_prefix: str = _PKG):
        self.exempt = exempt
        self.package_prefix = package_prefix

    def applies(self, rel: str) -> bool:
        return rel.startswith(self.package_prefix) and rel not in self.exempt

    def check(self, module: SourceModule, ctx) -> Iterable[Finding]:
        for node in module_nodes(module, ctx):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Name) and \
                    node.func.id == "print":
                yield Finding(
                    module.rel, node.lineno, self.id,
                    "bare print() in library code — use "
                    "utils.observability logging or utils.telemetry "
                    "counters", node.col_offset)


class BareSleepRule(Rule):
    """All backoff/retry machinery lives in utils/resilience.py so retry
    behavior and counters stay identical across sweeps, serving and user
    code.  Flags ``time.sleep`` and ``for <attempt-ish> in range(...)``
    loops anywhere else in the package (and in ``scripts``, the named
    scripts outside it)."""

    id = "R102"
    title = "bare sleep / ad-hoc retry loop outside utils/resilience.py"

    DEFAULT_EXEMPT = (_PKG + "utils/resilience.py",)
    _RETRY_NAME = re.compile(r"^_?(n_)?(attempt|attempts|retry|retries)$")

    def __init__(self, exempt: tuple = DEFAULT_EXEMPT, scripts: tuple = (),
                 package_prefix: str = _PKG):
        self.exempt = exempt
        self.scripts = scripts
        self.package_prefix = package_prefix

    def applies(self, rel: str) -> bool:
        if rel in self.exempt:
            return False
        return rel.startswith(self.package_prefix) or rel in self.scripts

    def check(self, module: SourceModule, ctx) -> Iterable[Finding]:
        imp = module_imports(module, ctx)
        for node in module_nodes(module, ctx):
            if isinstance(node, ast.Call):
                if (imp.chain_root_module(node.func) == "time"
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "sleep") or \
                        (isinstance(node.func, ast.Name)
                         and imp.from_time.get(node.func.id) == "sleep"):
                    yield Finding(
                        module.rel, node.lineno, self.id,
                        "bare time.sleep() — use resilience.sleep_for / "
                        "RetryPolicy so backoff stays observable and "
                        "fault-injectable", node.col_offset)
            elif isinstance(node, ast.For) and \
                    isinstance(node.target, ast.Name) and \
                    self._RETRY_NAME.match(node.target.id) and \
                    isinstance(node.iter, ast.Call) and \
                    isinstance(node.iter.func, ast.Name) and \
                    node.iter.func.id == "range":
                yield Finding(
                    module.rel, node.lineno, self.id,
                    f"ad-hoc retry loop `for {node.target.id} in "
                    f"range(...)` — use resilience.RetryPolicy so "
                    f"attempts emit retry events", node.col_offset)

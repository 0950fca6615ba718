"""Symbols reachable across the port's intra-package imports.

``symbol_table`` maps each parsed module to its top-level definitions and
its resolved ``from .x import y`` imports; ``reachable_symbols`` walks the
names a function references, transitively across those imports, so a rule
can ask whether a kernel wrapper still reaches its plain version and its
launch.
"""
from __future__ import annotations

import ast
from typing import Iterable

__all__ = ["dotted", "ModuleImports", "ModuleSymbols", "module_imports",
           "module_nodes", "symbol_table", "reachable_symbols"]


def dotted(node: ast.AST) -> list[str] | None:
    """A Name/Attribute chain as parts: ``a.b.c`` -> ``["a", "b", "c"]``;
    None for anything else."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return None


def module_nodes(module, ctx) -> list:
    """Flat node list of the module AST, walked once and shared by every
    rule that scans whole files."""
    return ctx.cache(("nodes", module.rel),
                     lambda: list(ast.walk(module.tree)))


class ModuleImports:
    """The names one module binds to the ``time`` module
    (``import time as t``) and to its functions (``from time import
    sleep``), module- and function-level imports folded together."""

    def __init__(self, tree: ast.Module):
        self.time: set[str] = set()
        self.from_time: dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "time":
                        self.time.add(a.asname or a.name)
            elif isinstance(node, ast.ImportFrom) and node.module == "time":
                for a in node.names:
                    self.from_time[a.asname or a.name] = a.name

    def chain_root_module(self, func: ast.AST) -> str | None:
        """``"time"`` when a call target's root name is bound to the time
        module, else None."""
        chain = dotted(func)
        return "time" if chain and chain[0] in self.time else None


def module_imports(module, ctx) -> ModuleImports:
    return ctx.cache(("imports", module.rel),
                     lambda: ModuleImports(module.tree))


def _module_rel_for(parts: list[str], by_rel: dict) -> str | None:
    as_file = "/".join(parts) + ".py"
    if as_file in by_rel:
        return as_file
    as_pkg = "/".join(parts) + "/__init__.py"
    return as_pkg if as_pkg in by_rel else None


class ModuleSymbols:
    """A module's top-level definitions and its import map: local name ->
    ``(target module rel, original name)``, or ``"*module*"`` for a
    submodule imported by name."""

    def __init__(self, rel: str, tree: ast.Module, by_rel: dict):
        self.rel = rel
        self.defs: dict[str, ast.AST] = {
            node.name: node for node in tree.body
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef))}
        self.import_map: dict[str, tuple[str, str]] = {}
        pkg = rel.split("/")[:-1]
        for node in ast.walk(tree):
            if not isinstance(node, ast.ImportFrom):
                continue
            base = pkg[:len(pkg) - (node.level - 1)] if node.level else []
            mod = base + (node.module.split(".") if node.module else [])
            target = _module_rel_for(mod, by_rel)
            for a in node.names:
                name = a.asname or a.name
                sub = _module_rel_for(mod + [a.name], by_rel)
                if sub is not None:
                    self.import_map[name] = (sub, "*module*")
                elif target is not None:
                    self.import_map[name] = (target, a.name)


def symbol_table(ctx) -> dict:
    """rel -> ``ModuleSymbols`` of every parsed module (cached)."""
    return ctx.cache("symbol_table", lambda: {
        m.rel: ModuleSymbols(m.rel, m.tree, ctx.by_rel)
        for m in ctx.modules})


def _referenced(node: ast.AST) -> Iterable[tuple[str, str | None]]:
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load):
            yield n.id, None
        elif isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name):
            yield n.value.id, n.attr


def reachable_symbols(ctx, rel: str, func: str) -> set[tuple[str, str]]:
    """``(module rel, name)`` of every top-level definition ``func`` in
    ``rel`` references, transitively, itself included."""
    table = symbol_table(ctx)
    seen: set[tuple[str, str]] = set()
    work = [(rel, func)]
    while work:
        cur = work.pop()
        if cur in seen:
            continue
        mod = table.get(cur[0])
        node = mod.defs.get(cur[1]) if mod else None
        if node is None:
            continue
        seen.add(cur)
        for name, attr in _referenced(node):
            if name in mod.defs and name != cur[1]:
                work.append((cur[0], name))
            elif name in mod.import_map:
                target, orig = mod.import_map[name]
                if orig == "*module*":
                    if attr is not None:
                        work.append((target, attr))
                else:
                    work.append((target, orig))
    return seen

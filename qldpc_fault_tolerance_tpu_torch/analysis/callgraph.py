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

__all__ = ["dotted", "ModuleSymbols", "symbol_table", "reachable_symbols"]


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

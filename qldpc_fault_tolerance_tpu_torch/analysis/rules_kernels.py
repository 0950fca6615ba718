"""R007: the port's kernel/twin contract registry.

Every hand-written kernel of the port has a wrapper that launches it on a
CUDA tensor and runs its plain PyTorch version on a CPU tensor (or under
``ops._kernels.force_plain()``); the tests hold the plain versions against
the JAX package, and ``chip_smoke.py`` holds every kernel against its
plain version on the card.  That chain holds only while each wrapper
still reaches both halves.  ``KERNEL_CONTRACTS`` declares, for every
``extern "C"`` launch in ``csrc/``: the wrapper's module and name, the
source that ``ops._kernels.library`` builds, the launch symbol and the
plain version.  The rule reports, with file:line:

  * a registered wrapper that no longer reaches (across the package's
    imports) its plain version, a ``library("<source>")`` call and its
    launch symbol;
  * a launch symbol no longer defined in ``csrc/<source>.cu``;
  * an ``extern "C"`` launch symbol in ``csrc/`` that no contract names;
  * a plain version that ``chip_smoke.py`` does not name.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Iterable, NamedTuple

from .callgraph import dotted, reachable_symbols, symbol_table
from .core import Finding, Rule, SourceModule

__all__ = ["KernelContract", "KERNEL_CONTRACTS", "KernelContractRule",
           "launch_symbols"]

PKG = "qldpc_fault_tolerance_tpu_torch"


class KernelContract(NamedTuple):
    name: str       # the kernel's name in chip_smoke.py's kernels line
    module: str     # the wrapper's module, relative to the repo root
    wrapper: str    # the function that launches the kernel on the card
    source: str     # csrc/<source>.cu, ops._kernels.library(source)
    launch: str     # its extern "C" launch symbol
    plain: str      # the plain PyTorch version the wrapper runs otherwise


_OPS = PKG + "/ops/"

#: Every launch of the port's kernels, every mode (PERF.md's kernel table).
KERNEL_CONTRACTS = (
    KernelContract("bp_minsum", _OPS + "bp_kernel.py", "bp_minsum",
                   "bp_minsum", "bp_minsum_launch", "minsum_plain"),
    KernelContract("bp_minsum_sectors", _OPS + "bp_kernel.py", "bp_minsum",
                   "bp_minsum", "bp_minsum_sectors_launch", "minsum_plain"),
    KernelContract("bp_minsum_bf16", _OPS + "bp_kernel.py", "bp_head_bf16",
                   "bp_minsum", "bp_minsum_bf16_launch",
                   "minsum_dense_plain"),
    KernelContract("bp_int8", _OPS + "bp_kernel.py", "bp_head_int8",
                   "bp_int8", "bp_int8_launch", "minsum_int8_plain"),
    KernelContract("gf2_sample", _OPS + "gf2_kernel.py", "sample_syndrome",
                   "gf2_sample", "gf2_sample_launch",
                   "sample_syndrome_plain"),
    KernelContract("gf2_residual", _OPS + "gf2_kernel.py",
                   "residual_check_stats", "gf2_residual",
                   "gf2_residual_launch", "residual_check_plain"),
    KernelContract("fused_decode", _OPS + "gf2_kernel.py",
                   "fused_decode_stats", "fused_decode",
                   "fused_decode_launch", "fused_decode_plain"),
    KernelContract("fused_decode_int8", _OPS + "gf2_kernel.py",
                   "fused_decode_stats", "fused_decode_int8",
                   "fused_decode_int8_launch", "fused_decode_plain"),
    KernelContract("osd_elim", _OPS + "osd_device.py", "osd_elim",
                   "osd_elim", "osd_elim_launch", "eliminate_plain"),
    KernelContract("osd_elim_full", _OPS + "osd_device.py", "osd_elim",
                   "osd_elim", "osd_elim_full_launch", "eliminate_plain"),
    KernelContract("osd_elim_percol", _OPS + "osd_device.py",
                   "osd_elim_percol", "osd_elim", "osd_elim_percol_launch",
                   "eliminate_percol_plain"),
    KernelContract("cs_sweep", _OPS + "osd_cs_device.py", "cs_sweep",
                   "cs_sweep", "cs_sweep_launch", "cs_sweep_plain"),
    KernelContract("cs_sweep_rows", _OPS + "osd_cs_device.py",
                   "cs_sweep_rows", "cs_sweep", "cs_sweep_rows_launch",
                   "cs_sweep_rows_plain"),
)

_EXTERN = re.compile(r'extern\s+"C"\s+[^;{(]*?\b(\w+)\s*\(')


def launch_symbols(text: str) -> list[tuple[str, int]]:
    """``(symbol, line)`` of every ``extern "C"`` function named
    ``*_launch`` in a CUDA source."""
    out = []
    for m in _EXTERN.finditer(text):
        if m.group(1).endswith("_launch"):
            out.append((m.group(1), text.count("\n", 0, m.start(1)) + 1))
    return out


def _reach(ctx, rel: str, func: str) -> dict:
    """What ``func`` reaches: the names of the definitions, whether one of
    them calls ``library(...)``, the string constants passed first to a
    call, and the attribute names and strings they hold."""
    table = symbol_table(ctx)
    names, first_args, words = set(), set(), set()
    calls_library = False
    for mod_rel, name in reachable_symbols(ctx, rel, func):
        names.add(name)
        node = table[mod_rel].defs[name]
        for n in ast.walk(node):
            if isinstance(n, ast.Call):
                chain = dotted(n.func)
                if chain and chain[-1] == "library":
                    calls_library = True
                if n.args and isinstance(n.args[0], ast.Constant) \
                        and isinstance(n.args[0].value, str):
                    first_args.add(n.args[0].value)
            elif isinstance(n, ast.Attribute):
                words.add(n.attr)
            elif isinstance(n, ast.Constant) and isinstance(n.value, str):
                words.add(n.value)
    return {"names": names, "library": calls_library,
            "sources": first_args, "words": words}


class KernelContractRule(Rule):
    """Each registered wrapper still reaches its plain version and its
    launch; every launch in ``csrc/`` is registered; ``chip_smoke.py``
    names every plain version."""

    id = "R007"
    title = "kernel/twin contract drift"

    def __init__(self, contracts: tuple = KERNEL_CONTRACTS):
        self.contracts = contracts

    def applies(self, rel: str) -> bool:
        return any(c.module == rel for c in self.contracts)

    def check(self, module: SourceModule, ctx) -> Iterable[Finding]:
        mod = symbol_table(ctx).get(module.rel)
        for c in self.contracts:
            if c.module != module.rel:
                continue
            node = mod.defs.get(c.wrapper)
            if node is None:
                yield Finding(module.rel, 1, self.id,
                              f"contract {c.name!r}: wrapper {c.wrapper}() "
                              f"no longer exists; update KERNEL_CONTRACTS "
                              f"in analysis/rules_kernels.py or restore it")
                continue
            reach = _reach(ctx, module.rel, c.wrapper)
            missing = []
            if c.plain not in reach["names"]:
                missing.append(f"its plain version {c.plain}()")
            if not reach["library"] or c.source not in reach["sources"]:
                missing.append(f'_kernels.library("{c.source}")')
            if c.launch not in reach["words"]:
                missing.append(f"the launch symbol {c.launch}")
            if missing:
                yield Finding(module.rel, node.lineno, self.id,
                              f"contract {c.name!r}: wrapper {c.wrapper}() "
                              f"no longer reaches {' and '.join(missing)}",
                              node.col_offset)

    def finish(self, ctx) -> Iterable[Finding]:
        csrc = os.path.join(ctx.root, PKG, "csrc")
        if not os.path.isdir(csrc):
            return
        defined: dict[str, list] = {}
        for fn in sorted(os.listdir(csrc)):
            if fn.endswith(".cu"):
                with open(os.path.join(csrc, fn), encoding="utf-8") as fh:
                    defined[fn[:-3]] = launch_symbols(fh.read())
        registered = {(c.source, c.launch) for c in self.contracts}
        for c in self.contracts:
            if c.launch not in {s for s, _ in defined.get(c.source, ())}:
                yield Finding(f"{PKG}/csrc/{c.source}.cu", 1, self.id,
                              f"contract {c.name!r}: launch symbol "
                              f"{c.launch} is not defined in "
                              f"csrc/{c.source}.cu")
        for source, symbols in defined.items():
            for sym, line in symbols:
                if (source, sym) not in registered:
                    yield Finding(f"{PKG}/csrc/{source}.cu", line, self.id,
                                  f'extern "C" launch {sym} belongs to no '
                                  f"kernel contract: register it in "
                                  f"KERNEL_CONTRACTS with its wrapper and "
                                  f"plain version")
        smoke = os.path.join(ctx.root, "chip_smoke.py")
        text = ""
        if os.path.exists(smoke):
            with open(smoke, encoding="utf-8") as fh:
                text = fh.read()
        for plain in dict.fromkeys(c.plain for c in self.contracts):
            if not re.search(rf"\b{re.escape(plain)}\b", text):
                yield Finding("chip_smoke.py", 1, self.id,
                              f"plain version {plain}() is not named in "
                              f"chip_smoke.py, which holds every kernel "
                              f"against its plain version on the card")

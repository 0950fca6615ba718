#!/usr/bin/env python3
"""Compare the machine code (SASS) of the port's CUDA kernels between two
checkouts, kernel by kernel, on a machine with the CUDA toolkit.

  python3 scripts/sass_diff.py --parent DIR osd_elim bp_minsum fused_decode
  python3 scripts/sass_diff.py --parent DIR --diff gf2_sample

Each named ``csrc/<name>.cu`` of this checkout and of the one under DIR is
compiled to a cubin with the port's build flags (``ops/_kernels.py``
``NVCC_FLAGS``), disassembled with ``cuobjdump -sass`` and demangled with
``cu++filt``; a kernel is matched to the parent's of the same name and
template arguments, less a trailing template flag of ``false`` or ``0``
that this checkout added (a memory mode whose first value is the parent's
code), and the two instruction lists are compared with their addresses
and encodings removed.  Prints one line per kernel (IDENTICAL, DIFFERS or
new) and exits 1 if a kernel the parent has differs or is missing; with
``--diff``, a kernel that differs is followed by the unified diff of its
instruction lists.
``scripts/ab_osd_elim.py --sass`` and ``scripts/ab_minsum_body.py --sass``
run it on their sources.
"""
from __future__ import annotations

import argparse
import difflib
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
_INSN = re.compile(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;")
_FUNC = re.compile(r"\s*Function : (\S+)")


def kernels_sass(root: Path, name: str) -> dict:
    """{demangled kernel name: [instructions]} of ``csrc/<name>.cu`` under
    ``root``, built with this checkout's flags."""
    sys.path.insert(0, str(ROOT))
    from qldpc_fault_tolerance_tpu_torch.ops import _kernels

    nvcc = Path(_kernels._nvcc())
    flags = [f for f in _kernels.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        cubin = Path(tmp) / f"{name}.cubin"
        src = root / "qldpc_fault_tolerance_tpu_torch" / "csrc" / f"{name}.cu"
        subprocess.run([str(nvcc), *flags, "-cubin", "-o", str(cubin),
                        str(src)], check=True, timeout=900)
        text = subprocess.run([str(nvcc.parent / "cuobjdump"), "-sass",
                               str(cubin)], capture_output=True, text=True,
                              check=True, timeout=300).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = _FUNC.match(line)
        if m:
            name_d = subprocess.run([str(nvcc.parent / "cu++filt"), m.group(1)],
                                    capture_output=True, text=True,
                                    timeout=60).stdout.strip()
            cur = funcs.setdefault(name_d, [])
            continue
        m = _INSN.match(line)
        if m and cur is not None:
            cur.append(m.group(1))
    return funcs


def _key(kernel: str) -> str:
    """A kernel's name and template arguments, without its return type,
    namespace, parameter list and casts of its template values, and
    without its trailing ``false`` / ``0`` template flags (on both sides,
    so a flag added after one whose value is 0 still pairs, and a kernel
    that gained its first flag pairs with the parent's plain one)."""
    name = re.sub(r"^void\s+", "", kernel)
    name = re.sub(r"\((int|bool|unsigned int)\)", "",
                  name.replace("<unnamed>::", "")
                  .replace("(anonymous namespace)::", ""))
    head = re.sub(r"(,\s*(false|0))+>$", ">", name.split("(")[0].strip())
    # a flag added to a kernel that had no template arguments
    return re.sub(r"<\s*(false|0)\s*>$", "", head).replace(" ", "")


def compare(parent: Path, names, show_diff: bool = False) -> bool:
    """Print the comparison of every kernel of ``names``; True when each of
    the parent's kernels has this checkout's counterpart, instruction for
    instruction."""
    same = True
    for name in names:
        old, new = kernels_sass(parent, name), kernels_sass(ROOT, name)
        by_key = {_key(k): v for k, v in new.items()}
        matched = set()
        for kernel, insns in old.items():
            got = by_key.get(_key(kernel))
            if got is None:
                print(f"{name}: {kernel}: missing in this checkout")
                same = False
                continue
            matched.add(_key(kernel))
            verdict = "IDENTICAL" if got == insns else "DIFFERS"
            same &= got == insns
            print(f"{name}: {_key(kernel)}: {verdict} ({len(insns)} / "
                  f"{len(got)} instructions)")
            if show_diff and got != insns:
                for line in difflib.unified_diff(insns, got, "parent", "this",
                                                 n=1, lineterm=""):
                    print(f"    {line}")
        for kernel in new:
            if _key(kernel) not in matched:
                print(f"{name}: {_key(kernel)}: new ({len(new[kernel])} "
                      f"instructions)")
    return same


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, help="the other checkout's root")
    ap.add_argument("--diff", action="store_true",
                    help="print the instruction diff of a kernel that differs")
    ap.add_argument("names", nargs="+", help="csrc sources, without .cu")
    args = ap.parse_args()
    return 0 if compare(Path(args.parent).resolve(), args.names,
                        args.diff) else 1


if __name__ == "__main__":
    sys.exit(main())

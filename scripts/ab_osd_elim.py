#!/usr/bin/env python3
"""Time the GF(2) elimination kernel of two checkouts of the PyTorch port, in
turns, on one NVIDIA GPU: ``csrc/osd_elim.cu`` in its three modes (kernel 2
``osd_elim`` at fcap 10, B7 ``osd_elim(full=True)`` at fcap 0 and 10, B10
``osd_elim_percol``) on hgp_34_n625, n1225 and n1600 and on [H|I] of
hgp_34_n1600 (``n1600ext``, 768 x 2368: past shared memory, where the
blocked modes take the transform mode and a checkout without it
``kGlobal``), at 128, 256, 512 and 2048 shots.

  python3 scripts/ab_osd_elim.py --parent DIR
  python3 scripts/ab_osd_elim.py --parent DIR --memory device
  python3 scripts/ab_osd_elim.py --parent DIR --sass
  python3 scripts/ab_osd_elim.py --layout

DIR holds another checkout's ``qldpc_fault_tolerance_tpu_torch/`` and
``codes_lib_tpu/hgp_34_n{625,1225,1600}.npz`` (for example the parent
commit's, from ``git archive``).  Each side runs in its own process, which
builds that checkout's kernels into its own ``build/``; the order is
parent, change, change, parent.  The shots are BP failures as chip_smoke.py
phase 4 draws them: hx's syndromes of p=0.05 errors (its seed) that 50
iterations of kernel 1 leave unconverged, permuted by their posteriors; a
batch of B shots is the first B of them, so the smaller batches are
slices of the 2048.  Per run it prints one JSON line with, for every code,
batch and mode, the wrapper's time per call between CUDA events (median
of three rounds of ten calls; ``..._ms``), the profiler device time of
every kernel ``_permute_and_pack`` launches for that batch
(``pack_..._ms``: the (W, m, B) matrix a checkout whose kernel reads
packed rows needs first), a digest of the outputs, the layout (its memory
mode among its fields), and
``nvcc -Xptxas -v`` of ``osd_elim.cu``.  Every output is checked bit for
bit against the plain version (``_kernels.force_plain()``) on the 2048
shots, and the digests must agree between the sides.  ``--memory MODE``
fixes every launch's memory mode (``_kernels.force_memory``) on each side
that has the mode, and leaves a side without it (the parent has no
``"transform"``) to its layout's pick.  Each run also gives
chip_smoke.py phases 6, 16 and 17's failures and min weight (BP-50 + OSD-E
and OSD-CS of order 10, p=0.05, 8 batches of 2048, and OSD-E on the
per-column route), which must not depend on the side.  The last line is a
summary with the median of each side.  ``--layout`` times this checkout
alone at each number of threads per shot (``elim_layout``'s ``threads``).
``--sass`` compares instead the machine code of ``osd_elim.cu`` with DIR's,
kernel by kernel (``scripts/sass_diff.py``: a kernel whose instructions are
the parent's runs the parent's code), and exits 1 if one of the parent's
kernels differs.
"""
from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEED = 20261016  # chip_smoke.py's
# hx of the shipped codes, and [H|I] of n1600's hx (phase 30's decoder 1)
CODES = ("n625", "n1225", "n1600", "n1600ext")
BATCHES = (128, 256, 512, 2048)
LAYOUT_THREADS = (128, 256, 512, 640, 1024)


def ptxas_report(root: Path) -> list:
    """The lines of ``nvcc -Xptxas -v`` about the kernels of csrc/osd_elim.cu
    (the port's build flags, output discarded)."""
    from qldpc_fault_tolerance_tpu_torch.ops import _kernels

    cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o",
           os.devnull, str(root / "qldpc_fault_tolerance_tpu_torch" / "csrc"
                           / "osd_elim.cu")]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    return [ln.split("ptxas info    :")[-1].strip()
            for ln in (out.stdout + out.stderr).splitlines()
            if any(k in ln for k in ("entry function", "registers", "spill"))]


def event_ms(fn, reps: int = 10, rounds: int = 3) -> float:
    """Median over ``rounds`` of the mean time per call of ``reps`` calls in
    a row, between CUDA events, after one warm-up.  Every kernel timed so
    is longer than the wrapper's host work, so the card never waits."""
    import torch

    fn()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return statistics.median(times)


def kernels_ms(fn, reps: int = 5, tries: int = 3) -> float:
    """Mean profiler device time per call of every kernel ``fn`` launches
    (its kernels' own time, without the host's gaps between launches).  A
    profiler session now and then records none of the card's kernels, so
    such a session is repeated, ``tries`` times at most."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.device_time_total for e in prof.key_averages()
                 if e.device_type.name == "CUDA")
        if us > 0:
            return us / reps / 1e3
    raise AssertionError("the profiler recorded no device time")


def failures(root: Path, name: str, dev, count: int):
    """hx of the code (with ``name`` ending in "ext", [hx|I]), and
    ``count`` BP failures: (perm (count, n) int64, syndromes (m, count)
    int32), drawn in batches of 4096 from SEED."""
    import numpy as np
    import torch

    from qldpc_fault_tolerance_tpu_torch.codes import load_code
    from qldpc_fault_tolerance_tpu_torch.ops import bp as tbp
    from qldpc_fault_tolerance_tpu_torch.ops.bp_kernel import bp_minsum

    code = name[:-3] if name.endswith("ext") else name
    hx = load_code(str(root / "codes_lib_tpu" / f"hgp_34_{code}.npz")).hx
    if name.endswith("ext"):
        hx = np.hstack([hx, np.eye(hx.shape[0], dtype=hx.dtype)])
    m, n = hx.shape
    graph = tbp.build_tanner_graph(hx, dev)
    llr0 = tbp.llr_from_probs(np.full(n, 2 * 0.05 / 3), dev)
    rng = np.random.default_rng(SEED)
    synd, post = [], []
    got = 0
    while got < count:
        err = (rng.random((4096, n)) < 2 * 0.05 / 3).astype(np.uint8)
        s = torch.from_numpy((err @ hx.T % 2).astype(np.uint8)).to(dev)
        _, conv, p, _ = bp_minsum(graph, s, llr0, max_iter=50)
        bad = torch.nonzero(~conv).flatten()
        synd.append(s[bad])
        post.append(p[bad])
        got += bad.numel()
    synd = torch.cat(synd)[:count]
    perm = torch.sort(torch.cat(post)[:count], dim=1, stable=True).indices
    return hx, perm, synd.to(torch.int32).t().contiguous()


def digest(outs) -> str:
    h = hashlib.sha256()
    for t in outs:
        h.update(t.to("cpu").contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def measure(root: Path, layout: bool, memory: str | None = None) -> dict:
    sys.path.insert(0, str(root))
    import contextlib

    from qldpc_fault_tolerance_tpu_torch.ops import _kernels

    fixed = contextlib.nullcontext()
    if memory:
        try:  # a checkout without the mode runs its layout's pick
            fixed = _kernels.force_memory(memory)
        except ValueError:
            memory = None
    with fixed:
        out = _measure(root, layout)
    out["memory"] = memory or "auto"
    return out


def _measure(root: Path, layout: bool) -> dict:
    import numpy as np
    import torch

    from qldpc_fault_tolerance_tpu_torch.ops import _kernels
    from qldpc_fault_tolerance_tpu_torch.ops import osd_device as od

    dev = torch.device("cuda", 0)
    _kernels.build_all()
    # the parent's wrappers take packed rows, this checkout's the permutation
    by_perm = "perm" in inspect.signature(od.osd_elim).parameters
    out = {"root": str(root), "card": torch.cuda.get_device_name(0),
           "entry": "perm" if by_perm else "packed"}
    for name in CODES:
        hx, perm, synd = failures(root, name, dev, max(BATCHES))
        m, n = hx.shape
        plan = od.build_osd_plan(hx, np.full(n, 0.05), device=dev)
        h01 = od._unpack_rows(plan.packed, n)
        w = min(10, n - plan.rank)
        ref = {}
        for B in sorted(BATCHES, reverse=True):
            p_b, s_b = perm[:B].contiguous(), synd[:, :B].contiguous()
            packed = od._permute_and_pack(h01, p_b)
            rows = (plan.packed, p_b) if by_perm else (packed,)
            calls = {
                "skip10": lambda: od.osd_elim(*rows, s_b, n=n, r_star=plan.rank,
                                              fcap=w),
                "full0": lambda: od.osd_elim(*rows, s_b, n=n, r_star=plan.rank,
                                             fcap=0, full=True),
                "full10": lambda: od.osd_elim(*rows, s_b, n=n, r_star=plan.rank,
                                              fcap=w, full=True),
                "percol": lambda: od.osd_elim_percol(*rows, s_b, n=n,
                                                     r_star=plan.rank)}
            out[f"pack_{B}_{name}_ms"] = kernels_ms(
                lambda: od._permute_and_pack(h01, p_b))
            for mode, fn in calls.items():
                key = f"{mode}_{B}_{name}"
                got = fn()
                if mode not in ref:  # the largest batch: against the plain
                    with _kernels.force_plain():
                        ref[mode] = fn()
                # a smaller batch is the largest's first B shots
                for a, b in zip(got, ref[mode]):
                    if not torch.equal(a, b[..., :B]):
                        raise AssertionError(f"{key} differs from its plain "
                                             f"version")
                out[f"{key}_digest"] = digest(got)
                out[f"{key}_ms"] = event_ms(fn)
                if by_perm:
                    lay = od.card_elim_layout(
                        dev, B, m, n, w if mode.endswith("10") else 0,
                        mode.rstrip("0123456789"))
                    out[f"{key}_layout"] = list(lay)
                if layout and by_perm:
                    orig = od.elim_layout
                    for threads in LAYOUT_THREADS:
                        od.elim_layout = (lambda *a, _t=threads, **k:
                                          orig(*a, **k, threads=_t))
                        try:
                            if digest(fn()) != out[f"{key}_digest"]:
                                raise AssertionError(f"{key} at {threads} "
                                                     f"threads differs")
                            out[f"{key}_t{threads}_ms"] = event_ms(fn)
                        finally:
                            od.elim_layout = orig
    if not layout:
        out.update(main_path_runs(root, dev))
    out["ptxas"] = ptxas_report(root)
    return out


def main_path_runs(root: Path, dev) -> dict:
    """chip_smoke.py phases 6, 16 and 17 (8 batches of 2048 at p=0.05, BP +
    OSD-E and OSD-CS of order 10, and OSD-E on the per-column route):
    (failures, min weight) of each."""
    import numpy as np

    from qldpc_fault_tolerance_tpu_torch.codes import load_code
    from qldpc_fault_tolerance_tpu_torch.decoders import BPOSD_Decoder
    from qldpc_fault_tolerance_tpu_torch.sim import CodeSimulator_DataError

    code = load_code(str(root / "codes_lib_tpu" / "hgp_34_n625.npz"))
    out = {}
    for tag, elim, method in (("phase6", None, "osd_e"),
                              ("phase16", None, "osd_cs"),
                              ("phase17", "pallas_percol", "osd_e")):
        probs = np.full(code.N, 2 * 0.05 / 3)
        if elim:  # the route is read when the decoders are built
            os.environ["QLDPC_OSD_ELIM"] = elim
        try:
            kw = dict(osd_method=method, osd_order=10, device=dev)
            dx = BPOSD_Decoder(code.hz, probs, 50, **kw)
            dz = BPOSD_Decoder(code.hx, probs, 50, **kw)
        finally:
            os.environ.pop("QLDPC_OSD_ELIM", None)
        sim = CodeSimulator_DataError(
            code=code, decoder_x=dx, decoder_z=dz,
            pauli_error_probs=[0.05 / 3] * 3, seed=SEED, batch_size=2048,
            scan_chunk=8, device=dev)
        sim.WordErrorRate(8 * 2048)
        out[tag] = [sim.last_failures, sim.min_logical_weight]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="the other checkout's root")
    ap.add_argument("--layout", action="store_true",
                    help="time this checkout at each number of threads per shot")
    ap.add_argument("--sass", action="store_true",
                    help="compare the kernels' machine code with --parent's")
    ap.add_argument("--memory", help="fix every launch's memory mode "
                    "(_kernels.force_memory) on each side that has it")
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.sass:
        import sass_diff

        if not args.parent:
            ap.error("--sass needs --parent")
        return 0 if sass_diff.compare(Path(args.parent).resolve(),
                                      ["osd_elim"]) else 1
    import torch

    if not torch.cuda.is_available():
        print("ab_osd_elim: no CUDA device available", file=sys.stderr)
        return 2
    if args.measure:
        print(json.dumps(measure(Path(args.measure).resolve(), args.layout,
                                 args.memory)), flush=True)
        return 0
    if not (args.parent or args.layout):
        ap.error("--parent or --layout is required")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    if args.layout:
        order = [("change", ROOT)]
    else:
        parent = Path(args.parent).resolve()
        order = [("parent", parent), ("change", ROOT), ("change", ROOT),
                 ("parent", parent)]
    runs = {side: [] for side, _ in order}
    for side, root in order:
        cmd = [sys.executable, __file__, "--measure", str(root)] + (
            ["--memory", args.memory] if args.memory else [])
        out = subprocess.run(cmd + (["--layout"] if args.layout else []),
                             capture_output=True, text=True, timeout=1500)
        if out.returncode:
            print(out.stdout + out.stderr, file=sys.stderr)
            return 1
        res = json.loads(out.stdout.strip().splitlines()[-1])
        res["side"] = side
        print(json.dumps(res), flush=True)
        runs[side].append(res)
    every = [r for rs in runs.values() for r in rs]
    for k in every[0]:
        if k.endswith("_digest") or k.startswith("phase"):
            if len({json.dumps(r[k]) for r in every}) != 1:
                print(f"ab_osd_elim: {k} differs between the sides",
                      file=sys.stderr)
                return 1
    keys = [k for k in runs["change"][0] if k.endswith("_ms")]
    print(json.dumps({"card": card, "median": {
        side: {k: statistics.median(r[k] for r in rs) for k in keys}
        for side, rs in runs.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

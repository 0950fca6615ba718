#!/usr/bin/env python3
"""Time the min-sum kernels of two checkouts of the PyTorch port, in turns,
on one NVIDIA GPU: kernel 1 (``bp_minsum``, float32 messages) and the bf16
BP head (``bp_head_bf16``) at chip_smoke.py phase 3/20's shapes and at the
main path's, on hgp_34_n625, n1225 and n1600, where one shot's messages do
not fit a block (``device_shapes``: phase 27's stack, phase 33's window
matrix, phase 36's h1), and kernel B5's bf16 mode (``fused_decode_stats``,
which runs their per-shot loop) at phase 24's shape and on the larger
codes.

  python3 scripts/ab_minsum_body.py --parent DIR
  python3 scripts/ab_minsum_body.py --parent DIR --sass
  python3 scripts/ab_minsum_body.py --sweep
  python3 scripts/ab_minsum_body.py --grid [--parent DIR]
  python3 scripts/ab_minsum_body.py --h1-lanes

DIR holds another checkout's ``qldpc_fault_tolerance_tpu_torch/`` and
``codes_lib_tpu/hgp_34_n{625,1225,1600}.npz`` (for example the parent
commit's, from ``git archive``).  Each side runs in its own process, which
builds that checkout's kernels into its own ``build/``; the order is
parent, change, change, parent.  Per run it prints one JSON line with the
kernels' layouts, ``nvcc -Xptxas -v`` of ``bp_minsum.cu`` and
``fused_decode.cu`` (registers, spills, shared memory) and the times, by
profiler device time:

  * head: hx of each code, 4096 syndromes of p=0.05 errors (phase 3's
    seed), 50 iterations, in the shared-memory mode and (``*_device_ms``)
    with the lanes in device memory (``_kernels.force_memory("device")``);
  * tail: 768 stragglers of a 3-iteration decode of those and 256 zero
    rows, 50 iterations (phase 20's tail);
  * main head / main tail: 4096 syndromes of p=0.01 errors, 3 iterations,
    then their stragglers and zero rows to 256, 50 iterations (what the
    two-phase decode of chip_smoke.py phase 5 launches 32 + 32 times);
  * B5 bf16: 4096 shots at p=0.01 and at p=0.05, 50 iterations, block_w 8
    (hgp_34_n625, phase 24's shape), and 4096 shots at p=0.01 on
    hgp_34_n1225 and n1600, with the layout;
  * the shapes past shared memory (``device_shapes``), in the mode each
    side's layout picks, their outputs' digests equal between the sides.

Every kernel output is checked bit for bit against its plain version
first.  Each run also gives chip_smoke.py phases 5, 22 and 26's (BP), 6,
16 and 17's (BP + OSD) and 25's bf16 run's (the fused v2 engine) failures
and min weight, which must not depend on the side.  The last line
is a summary with the median of each side.  ``--sweep`` times this
checkout alone with each number of shots per block at each shape, B5
bf16 included;
``--refill`` prints, on the CPU, the refill arithmetic behind PERF.md's
predictions (iterations per shot from the plain version).  ``--grid``
times kernel 1's 32-bit-plane device-memory mode on phase 36's h1 at 132,
66, 33 and 16 blocks (DIR's, with ``--parent``); ``--h1-lanes`` times this
checkout's check-state mode there at 1 and 2 shots per block and with
both planes read from device memory (16- and 32-bit).  Phase 36's h1 and window-1 detectors are built once into
``build/dem36_n625.npz`` (about two minutes of host time).  ``--sass``
compares instead the machine code of ``bp_minsum.cu`` and
``fused_decode.cu`` with DIR's, kernel by kernel (``scripts/sass_diff.py``:
a kernel whose instructions are the parent's runs the parent's code), and
exits 1 if one of the parent's kernels differs.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEED = 20261016  # chip_smoke.py's
CODES = ("n625", "n1225", "n1600")
KERNEL = "bp_minsum_kernel"
# chip_smoke.py phase 36's cell: hgp_34_n625, CX-only noise at p_CX 0.002,
# 13 cycles, windows of 3; its window matrix h1 and window 1's detectors,
# cached here (the detector error model takes ~100 s of host time)
DEM36 = ROOT / "build" / "dem36_n625.npz"
DEM36_SHOTS = 2048


def dem36() -> dict:
    """Phase 36's ``h1`` (900 x 9600), its priors and window 1's detectors
    of DEM36_SHOTS shots, drawn on the CPU by the port's FrameSampler from
    the key phase 36 draws its kernel cases from ((36, SEED)): built once
    into DEM36, read from there after."""
    import numpy as np

    if not DEM36.exists():
        sys.path.insert(0, str(ROOT))
        from qldpc_fault_tolerance_tpu_torch.codes import load_code
        from qldpc_fault_tolerance_tpu_torch.sim import \
            CodeSimulator_Circuit_SpaceTime

        code = load_code(str(ROOT / "codes_lib_tpu" / "hgp_34_n625.npz"))
        sim = CodeSimulator_Circuit_SpaceTime(
            code=code, p=0.002, num_cycles=13, num_rep=3,
            error_params={"p_i": 0, "p_state_p": 0, "p_m": 0, "p_CX": 0.002,
                          "p_idling_gate": 0},
            circuit_type="coloration", seed=SEED, batch_size=DEM36_SHOTS,
            device="cpu")
        sim._generate_circuit()
        sim._generate_circuit_graph()
        dets, _ = sim.detector_sampler.sample((36, SEED), DEM36_SHOTS)
        m = sim.num_checks
        syn1 = dets.reshape(DEM36_SHOTS, 13, m)[:, :3].reshape(
            DEM36_SHOTS, 3 * m)
        h1 = np.asarray(sim.circuit_graph["h1"], np.uint8)
        DEM36.parent.mkdir(parents=True, exist_ok=True)
        tmp = DEM36.with_name(f"{DEM36.stem}.{os.getpid()}.npz")
        np.savez_compressed(
            tmp, h1=h1, ps1=np.asarray(sim.circuit_graph["channel_ps1"]),
            syn1=syn1.numpy().astype(np.uint8))
        os.replace(tmp, DEM36)
    with np.load(DEM36) as z:
        return {k: z[k] for k in ("h1", "ps1", "syn1")}


def ptxas_report(root: Path, name: str) -> list:
    """The lines of ``nvcc -Xptxas -v`` about the kernels of csrc/<name>.cu
    (the port's build flags, output discarded)."""
    from qldpc_fault_tolerance_tpu_torch.ops import _kernels

    cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o",
           os.devnull, str(root / "qldpc_fault_tolerance_tpu_torch" / "csrc"
                           / f"{name}.cu")]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    return [ln.split("ptxas info    :")[-1].strip()
            for ln in (out.stdout + out.stderr).splitlines()
            if any(k in ln for k in ("entry function", "Function properties",
                                     "registers", "spill"))]


def device_ms(fn, reps: int, kernel: str, tries: int = 3) -> float:
    """Mean profiler device time per call of the kernels named ``kernel``.
    A profiler session now and then records the host's calls and none of
    the card's kernels (seen on the first session of a process), so a
    session without the kernel is repeated, ``tries`` times at most."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        keys = prof.key_averages()
        us = sum(e.device_time_total for e in keys if kernel in e.key)
        if us > 0:
            return us / reps / 1e3
    raise AssertionError(f"the profiler recorded no device time for {kernel}: "
                         f"{[(e.key, e.device_time_total) for e in keys]}")


def event_ms(fn, reps: int) -> float:
    """Mean time per call of ``fn`` between CUDA events, over ``reps``
    back-to-back calls after one warm-up."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def same(a, b, what):
    import torch

    for x, y in zip(a, b):
        if x.dtype == torch.float32:
            x, y = x.contiguous().view(torch.int32), y.contiguous().view(torch.int32)
        if not torch.equal(x, y):
            raise AssertionError(f"{what} differs from its plain version")


def shapes(root: Path, name: str, dev):
    """The four shapes of one code: {shape: (syndromes, llr0, iterations)}
    and the code's Tanner graph and head."""
    import numpy as np
    import torch

    from qldpc_fault_tolerance_tpu_torch.codes import load_code
    from qldpc_fault_tolerance_tpu_torch.ops import bp as tbp
    from qldpc_fault_tolerance_tpu_torch.ops import bp_kernel as bk

    hx = load_code(str(root / "codes_lib_tpu" / f"hgp_34_{name}.npz")).hx
    m, n = hx.shape
    graph = tbp.build_tanner_graph(hx, dev)
    head = bk.build_sparse_head(tbp.build_tanner_graph_host(hx), dev)
    out = {}
    for tag, p, rows in (("", 0.05, 1024), ("main_", 0.01, 256)):
        rng = np.random.default_rng(SEED)
        err = (rng.random((4096, n)) < 2 * p / 3).astype(np.uint8)
        synd = torch.from_numpy((err @ hx.T % 2).astype(np.uint8)).to(dev)
        llr0 = tbp.llr_from_probs(np.full(n, 2 * p / 3), dev)
        first = bk.bp_head_bf16(head, synd, llr0, head_iters=3)
        strag = torch.nonzero(~first[1]).flatten()[:rows - rows // 4]
        tail = torch.cat([synd[strag], synd.new_zeros((rows - strag.numel(), m))])
        out[f"{tag}head"] = (synd, llr0, 50 if not tag else 3)
        out[f"{tag}tail"] = (tail, llr0, 50)
    return graph, head, out


def b5_same(k, pl, what):
    """B5's count, min weight and every shot's flags against its plain
    version."""
    import torch

    if (int(k[0]), int(k[1])) != (int(pl[0]), int(pl[1])) or not all(
            torch.equal(a[f], b[f]) for a, b in ((k[2], pl[2]), (k[3], pl[3]))
            for f in ("converged", "iterations")):
        raise AssertionError(f"B5 bf16 {what} differs from its plain version")


def b5_layout(gk, spec, B):
    """This checkout's B5 bf16 launch: (shots per block, threads, blocks,
    resident blocks per SM, shared memory per block)."""
    if hasattr(gk, "card_fused_layout"):
        lay = gk.card_fused_layout(spec, B)
        return [lay.lanes, lay.threads, lay.grid, lay.resident, lay.smem_bytes]
    n, mx, mz, rwz, rwx = spec.statics
    lanes, smem = gk.fused_block_lanes(n, mx, rwz, mz, rwx)
    return [lanes, 1024, B // lanes, 1, smem]


def layout_of(bk, dev, synd, m, n, bf16):
    """This checkout's layout of one launch: (shots per block, threads,
    blocks, resident blocks per SM, shared memory per block)."""
    B = synd.shape[0]
    if hasattr(bk, "card_minsum_layout"):
        lay = bk.card_minsum_layout(dev, B, m, n, 7, 4, bf16)
        return [lay.lanes, lay.threads, lay.grid, lay.resident, lay.smem_bytes]
    lanes = bk.block_lanes(m, 7, n, edge_bytes=6 if bf16 else 8)
    return [lanes, 1024, -(-B // lanes), 1,
            lanes * ((6 if bf16 else 8) * m * 7 + n)]


def measure(root: Path, sweep: bool) -> dict:
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    from qldpc_fault_tolerance_tpu_torch.codes import load_code
    from qldpc_fault_tolerance_tpu_torch.ops import _kernels
    from qldpc_fault_tolerance_tpu_torch.ops import bp as tbp
    from qldpc_fault_tolerance_tpu_torch.ops import bp_kernel as bk
    from qldpc_fault_tolerance_tpu_torch.ops import gf2_kernel as gk

    dev = torch.device("cuda", 0)
    _kernels.build_all(("bp_minsum", "fused_decode"))
    out = {"root": str(root), "card": torch.cuda.get_device_name(0)}
    for name in CODES:
        graph, head, runs = shapes(root, name, dev)
        m, n = graph.chk_nbr.shape[0], graph.var_nbr.shape[0]
        for shape, (synd, llr0, iters) in runs.items():
            kernels = {
                "k1": lambda s=synd, l=llr0, it=iters: bk.bp_minsum(
                    graph, s, l, max_iter=it),
                "bf16": lambda s=synd, l=llr0, it=iters: bk.bp_head_bf16(
                    head, s, l, head_iters=it, early_stop=True)}
            for kname, fn in kernels.items():
                key = f"{kname}_{shape}_{name}"
                with _kernels.force_plain():
                    plain = fn()
                got = fn()
                same(got, plain, key)
                out[f"{key}_ms"] = device_ms(fn, 5, KERNEL)
                out[f"{key}_shot_iters"] = int(got[3].sum())
                out[f"{key}_layout"] = layout_of(bk, dev, synd, m, n,
                                                 kname == "bf16")
                if shape == "head" and not sweep:
                    # the lanes in a device scratch (kMem 1)
                    with _kernels.force_memory("device"):
                        same(fn(), plain, f"{key} device")
                        out[f"{key}_device_ms"] = device_ms(fn, 5, KERNEL)
                if sweep:
                    orig = bk.minsum_layout
                    cap = orig(synd.shape[0], m, n, 7, 4, kname == "bf16",
                               132).lanes
                    for lanes in sorted({1, 2, 4, 8, cap, 15} - {cap}):
                        try:
                            orig(1, m, n, 7, 4, kname == "bf16", 132, lanes=lanes)
                        except ValueError:
                            continue
                        bk.minsum_layout = (lambda *a, _l=lanes, **k:
                                            orig(*a, **k, lanes=_l))
                        try:
                            same(fn(), plain, f"{key} at {lanes} lanes")
                            out[f"{key}_lanes{lanes}_ms"] = device_ms(fn, 5, KERNEL)
                        finally:
                            bk.minsum_layout = orig

    # B5 bf16 at phase 24's shape, at p=0.05, and on the larger codes
    key = gk.fold_in(gk.split_key(gk.prng_key(SEED))[1], 0)
    kw = dict(eval_type="Total", max_iter_z=50, max_iter_x=50,
              ms_scaling_factor=0.625, quantize=None, block_w=8)
    for name, p in (("n625", 0.01), ("n625_p05", 0.05), ("n1225", 0.01),
                    ("n1600", 0.01)):
        code = load_code(str(root / "codes_lib_tpu"
                             / f"hgp_34_{name.split('_')[0]}.npz"))
        llr = tbp.llr_from_probs(np.full(code.N, 2 * p / 3), dev)
        spec = gk.build_fused_decode_spec(code.hx, code.hz, code.lx, code.lz,
                                          [p / 3] * 3, llr, llr, dev)

        def b5(spec=spec):
            return gk.fused_decode_stats(spec, key, 4096, **kw)

        pl = gk.fused_decode_plain(spec, key, 4096, **kw)
        b5_same(b5(), pl, name)
        out[f"b5_bf16_{name}_ms"] = device_ms(b5, 10, "fused_decode_kernel")
        out[f"b5_bf16_{name}_layout"] = b5_layout(gk, spec, 4096)
        if sweep and hasattr(gk, "fused_layout"):
            orig = gk.fused_layout
            for lanes in (1, 2, 3, 4, 6, 8, 12):
                gk.fused_layout = (lambda *a, _l=lanes, **k:
                                   orig(*a, **k, lanes=_l))
                try:
                    b5_same(b5(), pl, f"{name} at {lanes} lanes")
                    out[f"b5_bf16_{name}_lanes{lanes}_ms"] = device_ms(
                        b5, 10, "fused_decode_kernel")
                except ValueError:
                    pass  # the code does not fit so many shots per block
                finally:
                    gk.fused_layout = orig

    if not sweep:
        out.update(device_shapes(root, dev))
        out.update(main_path_runs(root, dev))
        out["ptxas"] = {name: ptxas_report(root, name)
                        for name in ("bp_minsum", "fused_decode")}
    return out


def digest(out) -> str:
    """A hash of a decode's four outputs, to compare two checkouts."""
    import hashlib

    h = hashlib.sha256()
    for t in out:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def device_shapes(root: Path, dev) -> dict:
    """The min-sum kernels where one shot's messages do not fit a block's
    shared memory, in the mode the checkout's layout picks (the parent's
    device-memory modes, this checkout's check-state mode), each output
    bit-exact with the plain version: kernel 1 and the bf16 head on three
    copies of hgp_34_n1600's [H|I] (2304 x 7104), 256 syndromes of p=0.02
    errors, 50 iterations (chip_smoke.py phase 27's); kernel 1 on phase
    33's window matrix (windows of 8 slices of hgp_34_n625's [H|I], 2400 x
    7400), 2048 syndromes drawn from the window decoder's own channel, its
    max_iter (the full decode); kernel 1 on phase 36's h1 (DEM36), 2048
    window-1 syndromes, 625 iterations.  Times between CUDA events (``_ms``;
    each call is one launch of 0.8 ms or more, so the card, not the host,
    sets the pace) and by profiler device time (``_profiler``, which for
    the check-state kernel on h1 reads far less than the events: PERF.md);
    the outputs' digests must match between the sides."""
    import numpy as np
    import torch

    from qldpc_fault_tolerance_tpu_torch.codes import load_code
    from qldpc_fault_tolerance_tpu_torch.codes.gf2 import block_diag
    from qldpc_fault_tolerance_tpu_torch.decoders import ST_BP_Decoder_Class
    from qldpc_fault_tolerance_tpu_torch.ops import _kernels
    from qldpc_fault_tolerance_tpu_torch.ops import bp as tbp
    from qldpc_fault_tolerance_tpu_torch.ops import bp_kernel as bk

    cases = {}
    h16 = load_code(str(root / "codes_lib_tpu" / "hgp_34_n1600.npz")).hx
    stack = block_diag(np.hstack([h16, np.eye(h16.shape[0], dtype=np.uint8)]),
                       3)
    rng = np.random.default_rng(SEED)
    err = (rng.random((256, stack.shape[1])) < 0.02).astype(np.uint8)
    synd = torch.from_numpy((err @ stack.T % 2).astype(np.uint8)).to(dev)
    llr = tbp.llr_from_probs(np.full(stack.shape[1], 0.02), dev)
    graph = tbp.build_tanner_graph(stack, dev)
    head = bk.build_sparse_head(tbp.build_tanner_graph_host(stack), dev)
    cases["k1_stack3"] = lambda: bk.bp_minsum(graph, synd, llr, max_iter=50)
    cases["bf16_stack3"] = lambda: bk.bp_head_bf16(head, synd, llr,
                                                   head_iters=50)
    code = load_code(str(root / "codes_lib_tpu" / "hgp_34_n625.npz"))
    dec = ST_BP_Decoder_Class(30, "minimum_sum", 0.625, device=dev).GetDecoder(
        {"h": code.hx, "p_data": 0.005, "p_syndrome": 0.005, "num_rep": 8})
    h33 = np.asarray(dec.ST_h, np.uint8)
    g33, llr33 = dec.device_state["graph"], dec.device_state["llr0"]
    it33 = dec.device_static[4][1]
    p33 = 1.0 / (1.0 + np.exp(llr33.cpu().numpy().astype(np.float64)))
    e33 = (rng.random((2048, h33.shape[1])) < p33).astype(np.uint8)
    synd33 = torch.from_numpy((e33 @ h33.T % 2).astype(np.uint8)).to(dev)
    cases["k1_window33"] = lambda: bk.bp_minsum(g33, synd33, llr33,
                                                max_iter=it33)
    d = dem36()
    g1 = tbp.build_tanner_graph(d["h1"], dev)
    llr1 = tbp.llr_from_probs(d["ps1"], dev)
    syn1 = torch.from_numpy(d["syn1"]).to(dev)
    cases["k1_h1"] = lambda: bk.bp_minsum(g1, syn1, llr1, max_iter=625)
    out = {}
    for key, fn in cases.items():
        got = fn()
        with _kernels.force_plain():
            same(got, fn(), key)
        out[f"{key}_digest"] = digest(got)
        out[f"{key}_shot_iters"] = int(got[3].sum())
        reps = 3 if key == "k1_h1" else 10
        out[f"{key}_ms"] = event_ms(fn, reps)
        out[f"{key}_profiler"] = device_ms(fn, reps, "bp_minsum")
    return out


def h1_times(root: Path = ROOT, memory: str = "device_planes",
             grids=(None,), lanes=(None,), plain: bool = False,
             reps: int = 1, planes=(None,)) -> dict:
    """The kernel 1 of the checkout at ``root`` on phase 36's ``h1``
    (DEM36's 2048 window-1 syndromes, max_iter 625, the ladder's full
    decode) in ``memory`` (fixed by ``_kernels.force_memory``), with each
    number of shots per block of ``lanes`` and each number of blocks of
    ``grids`` (None: the layout's own), between CUDA events after one
    warm-up; every run bit-exact with the first and, with ``plain``, with
    the plain version; in the check-state mode with each plane form of
    ``planes`` (None: the layout's own).  Fewer blocks tell whether a
    block's shots run faster when fewer share the card (the L2 cache, the
    memory system) or take as long (each block bound by its own
    latency)."""
    import torch

    d = dem36()
    sys.path.insert(0, str(root))
    from qldpc_fault_tolerance_tpu_torch.ops import _kernels
    from qldpc_fault_tolerance_tpu_torch.ops import bp as tbp
    from qldpc_fault_tolerance_tpu_torch.ops import bp_kernel as bk

    dev = torch.device("cuda", 0)
    graph = tbp.build_tanner_graph(d["h1"], dev)
    llr = tbp.llr_from_probs(d["ps1"], dev)
    synd = torch.from_numpy(d["syn1"]).to(dev)
    run = lambda: bk.bp_minsum(graph, synd, llr, max_iter=625)  # noqa: E731
    out = {"root": str(root), "card": torch.cuda.get_device_name(0),
           "memory": memory}
    card, layout = bk.card_minsum_layout, bk.minsum_layout
    (m, rw), (n, cw) = graph.chk_nbr.shape, graph.var_nbr.shape
    with _kernels.force_memory(memory):
        k = run()
        if plain:
            with _kernels.force_plain():
                same(k, run(), "h1")
        out["shot_iterations"] = int(k[3].sum())
        out["unconverged"] = int((~k[1]).sum())
        for lane, grid, form in ((a, b, c) for a in lanes for b in grids
                                 for c in planes):
            with contextlib.ExitStack() as stack:
                if form is not None:
                    stack.enter_context(_kernels.force_planes(form))
                if lane is not None:
                    bk.minsum_layout = (lambda *a, _l=lane, **kw: layout(
                        *a, **kw, lanes=_l))
                if grid is not None:
                    bk.card_minsum_layout = (lambda *a, _g=grid, **kw: card(
                        *a, **kw)._replace(grid=min(_g, card(*a, **kw).grid)))
                try:
                    lay = bk.card_minsum_layout(
                        dev, 2048, m, n, rw, cw, False, memory=memory,
                        **({} if form is None else {"planes": form}))
                    form = getattr(lay, "planes", "")
                    tag = f"lanes{lay.lanes}_grid{lay.grid}_{form}"
                    out[f"{tag}_layout"] = [*lay[:5], form]
                    same(run(), k, f"h1 at {tag}")
                    start = torch.cuda.Event(enable_timing=True)
                    stop = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(reps):
                        run()
                    stop.record()
                    torch.cuda.synchronize()
                    out[f"{tag}_ms"] = start.elapsed_time(stop) / reps
                finally:
                    bk.card_minsum_layout, bk.minsum_layout = card, layout
    return out


def main_path_runs(root: Path, dev) -> dict:
    """chip_smoke.py phases 5, 22 and 26 (16 batches of 4096 at p=0.01 with
    the default, v1 and float32 decoders), 6, 16 and 17 (8 batches of
    2048 at p=0.05, BP + OSD-E and OSD-CS of order 10, and OSD-E on the
    per-column route) and 25's bf16 run (the fused v2 engine, 16 batches
    of 4096 at p=0.01): (failures, min weight) of each."""
    import numpy as np

    from qldpc_fault_tolerance_tpu_torch.codes import load_code
    from qldpc_fault_tolerance_tpu_torch.decoders import BPDecoder, BPOSD_Decoder
    from qldpc_fault_tolerance_tpu_torch.sim import CodeSimulator_DataError

    code = load_code(str(root / "codes_lib_tpu" / "hgp_34_n625.npz"))
    out = {}
    for tag, cls, p, batch, n_batches, elim, kw, fused in (
            ("phase5", BPDecoder, 0.01, 4096, 16, None, {}, False),
            ("phase22", BPDecoder, 0.01, 4096, 16, None, {"bp_kernel": "v1"},
             False),
            ("phase26", BPDecoder, 0.01, 4096, 16, None, {"bp_kernel": "xla"},
             False),
            ("phase6", BPOSD_Decoder, 0.05, 2048, 8, None,
             {"osd_method": "osd_e", "osd_order": 10}, False),
            ("phase16", BPOSD_Decoder, 0.05, 2048, 8, None,
             {"osd_method": "osd_cs", "osd_order": 10}, False),
            ("phase17", BPOSD_Decoder, 0.05, 2048, 8, "pallas_percol",
             {"osd_method": "osd_e", "osd_order": 10}, False),
            ("phase25_bf16", BPDecoder, 0.01, 4096, 16, None, {}, "v2")):
        probs = np.full(code.N, 2 * p / 3)
        if elim:  # the route is read when the decoders are built
            os.environ["QLDPC_OSD_ELIM"] = elim
        try:
            dx = cls(code.hz, probs, 50, device=dev, **kw)
            dz = cls(code.hx, probs, 50, device=dev, **kw)
        finally:
            os.environ.pop("QLDPC_OSD_ELIM", None)
        sim = CodeSimulator_DataError(
            code=code, decoder_x=dx, decoder_z=dz,
            pauli_error_probs=[p / 3] * 3, seed=SEED, batch_size=batch,
            scan_chunk=8, fused_sampler=fused, device=dev)
        sim.WordErrorRate(n_batches * batch)
        out[tag] = [sim.last_failures, sim.min_logical_weight]
    return out


def refill_arithmetic() -> None:
    """On the CPU: the iterations each shot of the four shapes needs
    (``minsum_plain``), and the block-iterations per SM of the parent's
    blocks of 8 shots (4 when 8 do not fit its shared memory), which
    iterate until their slowest shot converges, against the lane-iterations
    per lane of this layout's lanes taking shots in order as theirs
    converge (greedy makespans over 132 SMs, one block per SM)."""
    import heapq

    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from qldpc_fault_tolerance_tpu_torch.ops import bp as tbp
    from qldpc_fault_tolerance_tpu_torch.ops import bp_kernel as bk

    def makespan(work, slots):
        heap = [0] * slots
        for w in work:
            heapq.heappush(heap, heapq.heappop(heap) + int(w))
        return max(heap)

    for name in CODES:
        with np.load(ROOT / "codes_lib_tpu" / f"hgp_34_{name}.npz") as z:
            hx = z["hx"].astype(np.uint8)
        m, n = hx.shape
        graph = tbp.build_tanner_graph(hx, "cpu")
        parent_lanes = 8 if 8 * (8 * m * 7 + n) <= bk.SMEM_LIMIT else 4
        for shape, p, iters, rows in (("head", 0.05, 50, 0), ("tail", 0.05, 50, 1024),
                                      ("main_head", 0.01, 3, 0),
                                      ("main_tail", 0.01, 50, 256)):
            rng = np.random.default_rng(SEED)
            err = (rng.random((4096, n)) < 2 * p / 3).astype(np.uint8)
            synd = torch.from_numpy((err @ hx.T % 2).astype(np.uint8))
            llr = tbp.llr_from_probs(np.full(n, 2 * p / 3), "cpu")
            if rows:
                first = bk.bp_minsum(graph, synd, llr, max_iter=3)
                strag = torch.nonzero(~first[1]).flatten()[:rows - rows // 4]
                synd = torch.cat([synd[strag],
                                  synd.new_zeros((rows - strag.numel(), m))])
            its = bk.bp_minsum(graph, synd, llr, max_iter=iters)[3].numpy()
            B = its.size
            blocks = np.resize(its, -(-B // parent_lanes) * parent_lanes)
            blocks[B:] = 0
            lanes = bk.minsum_layout(B, m, n, 7, 4, False, 132).lanes
            slots = min(B, 132 * lanes)
            print(json.dumps({
                "code": name, "shape": shape, "shots": B,
                "shot_iterations": int(its.sum()), "max": int(its.max()),
                "parent_block_iterations_per_sm": makespan(
                    blocks.reshape(-1, parent_lanes).max(axis=1), 132),
                "lanes_per_block": lanes,
                "lane_iterations_per_lane": makespan(its, slots),
                "even_share": round(float(its.sum()) / slots, 1)}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="the other checkout's root")
    ap.add_argument("--sweep", action="store_true",
                    help="time this checkout at each number of shots per block")
    ap.add_argument("--refill", action="store_true",
                    help="print the refill arithmetic (CPU, no card needed)")
    ap.add_argument("--sass", action="store_true",
                    help="compare the kernels' machine code with --parent's")
    ap.add_argument("--grid", action="store_true",
                    help="time kernel 1's 32-bit-plane device-memory mode "
                         "on phase 36's h1 at 132, 66, 33 and 16 blocks "
                         "(of the checkout under --parent, if given)")
    ap.add_argument("--h1-lanes", action="store_true",
                    help="time this checkout's check-state mode on phase "
                         "36's h1 at 1 and 2 shots per block and in each "
                         "plane form that reads device memory, checked "
                         "against the plain version")
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.refill:
        refill_arithmetic()
        return 0
    if args.sass:
        import sass_diff

        if not args.parent:
            ap.error("--sass needs --parent")
        return 0 if sass_diff.compare(Path(args.parent).resolve(),
                                      ["bp_minsum", "fused_decode"]) else 1
    import torch

    if not torch.cuda.is_available():
        print("ab_minsum_body: no CUDA device available", file=sys.stderr)
        return 2
    if args.measure:
        print(json.dumps(measure(Path(args.measure).resolve(), args.sweep)),
              flush=True)
        return 0
    if args.grid:
        print(json.dumps(h1_times(Path(args.parent or ROOT).resolve(),
                                  grids=(132, 66, 33, 16))), flush=True)
        return 0
    if args.h1_lanes:
        print(json.dumps(h1_times(memory="checks", lanes=(1, 2),
                                  plain=True)), flush=True)
        print(json.dumps(h1_times(memory="checks", lanes=(1,),
                                  planes=("global16", "global32"))),
              flush=True)
        return 0
    if not (args.parent or args.sweep):
        ap.error("--parent or --sweep is required")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    if args.sweep:
        order = [("change", ROOT)]
    else:
        parent = Path(args.parent).resolve()
        order = [("parent", parent), ("change", ROOT), ("change", ROOT),
                 ("parent", parent)]
    runs = {side: [] for side, _ in order}
    for side, root in order:
        cmd = [sys.executable, __file__, "--measure", str(root)]
        out = subprocess.run(cmd + (["--sweep"] if args.sweep else []),
                             capture_output=True, text=True, timeout=900)
        if out.returncode:
            print(out.stdout + out.stderr, file=sys.stderr)
            return 1
        res = json.loads(out.stdout.strip().splitlines()[-1])
        res["side"] = side
        print(json.dumps(res), flush=True)
        runs[side].append(res)
    keys = [k for k in runs["change"][0] if k.endswith("_ms")]
    digests = {k: {r[k] for rs in runs.values() for r in rs}
               for k in runs["change"][0] if k.endswith("_digest")}
    if any(len(v) != 1 for v in digests.values()):
        print(f"outputs differ between the sides: {digests}", file=sys.stderr)
        return 1
    print(json.dumps({"card": card, "median": {
        side: {k: statistics.median(r[k] for r in rs) for k in keys}
        for side, rs in runs.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

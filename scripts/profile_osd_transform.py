#!/usr/bin/env python3
"""Where a pivot step of the GF(2) elimination's transform mode spends its
cycles, on one NVIDIA GPU.

  python3 scripts/profile_osd_transform.py [--shots 256 2048] [--threads N]

Builds a copy of ``csrc/osd_elim.cu`` into ``build/profile_osd/`` with
``clock64()`` counters around the phases of ``elim_transform``'s loop (the
kernel's own source, with counters inserted at fixed lines; the script
stops if a line it needs has moved), launches it through the port's
wrapper on [H|I] of hgp_34_n1600 (768 x 2368, phase 30's decoder 1; BP
posteriors of p = 0.03 errors, fcap 0, so the free-position output is free
to carry the counters) and prints, per shot, averaged over the shots:

  w0_step    warp 0 from the loop's top to the first barrier in a step
             (reading its window, clearing, testing, publishing)
  w0_rescan  the same in a rescan (scanning T)
  w0_wait    warp 0 waiting at the first barrier
  upd        warp 1 updating T (loop top to the first barrier)
  upd_wait   warp 1 waiting at the first barrier
  gather     warp 1 gathering the next window (between the barriers)
  steps, rescans, loop (the whole loop's cycles)

each per iteration, and the kernel's time between CUDA events.  Every
output but the free positions is checked against the plain version.  The
card's name and power limit are printed first.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "qldpc_fault_tolerance_tpu_torch" / "csrc" / "osd_elim.cu"
OUT = ROOT / "build" / "profile_osd"
NAMES = ("w0_step", "w0_rescan", "w0_wait", "upd", "upd_wait", "gather",
         "steps", "rescans", "loop")

# (line of the kernel, what goes before it, what goes after it)
PROBES = (
    ("  const size_t sB = (size_t)B;\n",
     "", "  long long tp[10] = {0};\n  long long t_top = 0, t_a = 0;\n"),
    ("  for (;;) {\n    const int2 step = warp == 0 ? wk.out\n",
     "  const long long t_l0 = clock64();\n",
     ""),
    ("    if (t == kDone) break;\n",
     "", "    t_top = clock64();\n"),
    ("    // the next step published, every update of T done: warps 1.. gather\n",
     "    t_a = clock64();\n"
     "    if (warp == 0) tp[t == kRescan ? 1 : 0] += t_a - t_top;\n"
     "    if (tid == 32) tp[3] += t_a - t_top;\n",
     ""),
    ("    const int t1 = reinterpret_cast<const int2*>(nxt)->x;\n",
     "    if (warp == 0) tp[2] += clock64() - t_a;\n"
     "    if (tid == 32) tp[4] += clock64() - t_a;\n"
     "    const long long t_g = clock64();\n",
     ""),
    ("    __syncthreads();\n  }\n  if (tid == 0) {\n",
     "    if (tid == 32) tp[5] += clock64() - t_g;\n"
     "    if (tid == 0) { tp[6] += t >= 0; tp[7] += t == kRescan; }\n",
     ""),
    ("  const int n_piv = counts[0];\n",
     "", "  if (tid == 0) tp[8] = clock64() - t_l0;\n"
         "  if (tid == 0 || tid == 32) {\n"
         "    for (int k = 0; k < 9; ++k) {\n"
         "      if ((tid == 32) == (k >= 3 && k <= 5)) {\n"
         "        fpos[k * sB + b] = (int32_t)(tp[k] >> 4);\n"
         "      }\n"
         "    }\n"
         "  }\n"),
)


def instrumented_source() -> str:
    """``csrc/osd_elim.cu`` with the counters inserted in elim_transform;
    the free positions are not written (the counters take their rows)."""
    src = SRC.read_text()
    start = src.index("__device__ __forceinline__ void elim_transform(")
    end = src.index("__global__ void __launch_bounds__", start)
    body = src[start:end]
    for line, before, after in PROBES:
        if body.count(line) != 1:
            raise SystemExit(f"profile_osd_transform: the line {line!r} is "
                             f"not in elim_transform once")
        body = body.replace(line, before + line + after)
    free = "  for (int k = tid; k < n_free; k += nt) fpos[k * sB + b] = fpos_s[k];\n"
    if body.count(free) != 1:
        raise SystemExit("profile_osd_transform: the free positions' write "
                         "has moved")
    body = body.replace(free, "")
    return src[:start] + body + src[end:]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shots", type=int, nargs="+", default=[256, 2048])
    ap.add_argument("--threads", type=int, help="threads per shot "
                    "(default: the layout's)")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_osd_transform: no CUDA device available",
              file=sys.stderr)
        return 2
    from qldpc_fault_tolerance_tpu_torch.ops import _kernels
    from qldpc_fault_tolerance_tpu_torch.ops import bp as tbp
    from qldpc_fault_tolerance_tpu_torch.ops import osd_device as od
    from qldpc_fault_tolerance_tpu_torch.ops.bp_kernel import bp_minsum

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "osd_elim.cu").write_text(instrumented_source())
    lib = OUT / "libosd_elim_profile.so"
    subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", str(lib),
                    str(OUT / "osd_elim.cu")], check=True, timeout=900)
    dev = torch.device("cuda", 0)
    with np.load(ROOT / "codes_lib_tpu" / "hgp_34_n1600.npz") as z:
        h = z["hx"].astype(np.uint8)
    ext = np.hstack([h, np.eye(h.shape[0], dtype=np.uint8)])
    m, n = ext.shape
    plan = od.build_osd_plan(ext, np.full(n, 0.03), device=dev)
    graph = tbp.build_tanner_graph(ext, dev)
    if args.threads:
        layout = od.elim_layout
        od.elim_layout = lambda *a, **k: layout(*a, **k, threads=args.threads)
    for B in args.shots:
        rng = np.random.default_rng(27)
        err = (rng.random((B, n)) < 0.03).astype(np.uint8)
        synd = torch.from_numpy((err @ ext.T % 2).astype(np.uint8)).to(dev)
        post = bp_minsum(graph, synd, tbp.llr_from_probs(np.full(n, 0.03), dev),
                         max_iter=20)[2]
        perm = torch.sort(post, dim=1, stable=True).indices
        s32 = synd.to(torch.int32).t().contiguous()

        def run():
            return od.osd_elim(plan.packed, perm, s32, n=n, r_star=plan.rank,
                               fcap=0)

        with _kernels.force_plain():
            ref = run()
        _kernels._libs["osd_elim"] = ctypes.CDLL(str(lib))
        od.elim_resident.cache_clear()
        try:
            out = run()
            torch.cuda.synchronize()
            for a, b in zip(out[:4], ref[:4]):
                if not torch.equal(a, b):
                    raise AssertionError("the profiled kernel differs from "
                                         "the plain version")
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(5):
                run()
            stop.record()
            torch.cuda.synchronize()
        finally:
            _kernels._libs.pop("osd_elim")
            od.elim_resident.cache_clear()
        prof = out[4][:len(NAMES)].double() * 16  # the counters, >> 4
        lay = od.card_elim_layout(dev, B, m, n, 0, "skip")
        iters = prof[6].mean() + prof[7].mean()
        per = {k: round(float(prof[i].mean() / (prof[6].mean() if i in (0, 3)
                                               else prof[7].mean() if i == 1
                                               else iters)), 1)
               for i, k in enumerate(NAMES[:6])}
        print(f"{B} shots, {args.threads or lay.threads} threads a shot, "
              f"{lay.resident} resident per SM, "
              f"{start.elapsed_time(stop) / 5:.4f} ms (counters on); cycles "
              f"a step (w0_rescan a rescan): {per}; a shot: steps "
              f"{float(prof[6].mean()):.1f}, rescans "
              f"{float(prof[7].mean()):.1f}, loop "
              f"{float(prof[8].mean()):.0f} cycles", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

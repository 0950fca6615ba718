"""``python -m qldpc_fault_tolerance_tpu_torch.analysis [PATHS] [--root DIR]
[--json] [--baseline FILE | --no-baseline] [--update-baseline]``: lint the
port package (and its ``csrc/`` and the checkout's ``chip_smoke.py``), or
``PATHS``, with every rule against the baseline (``analysis/baseline.json``
by default).  Exit code 0 when clean, 1 on a finding, 2 on a usage error;
``--update-baseline`` rewrites the baseline from the live findings,
keeping the reasons of surviving entries and the entries of files or rules
outside the run, and exits 0."""
from __future__ import annotations

import argparse
import json
import sys

from . import (Baseline, DEFAULT_TARGETS, collect_modules,
               default_baseline_path, default_rules, repo_root, run_analysis)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m qldpc_fault_tolerance_tpu_torch.analysis")
    p.add_argument("paths", nargs="*",
                   help="files or directories to lint, relative to the "
                        "root (default: the port package)")
    p.add_argument("--root", default=None,
                   help="the checkout to lint (default: this one)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="the result as one JSON object")
    p.add_argument("--baseline", default=None,
                   help="baseline file (default: analysis/baseline.json)")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore the baseline: report every finding")
    p.add_argument("--update-baseline", action="store_true",
                   help="rewrite the baseline from the live findings")
    args = p.parse_args(argv)
    root = args.root or repo_root()
    rules = default_rules()
    baseline_path = args.baseline or default_baseline_path()
    baseline = Baseline() if args.no_baseline \
        else Baseline.load(baseline_path)
    try:
        modules = collect_modules(args.paths or list(DEFAULT_TARGETS), root)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.update_baseline:
        raw = run_analysis(modules, rules, root=root)
        analyzed = {m.rel for m in modules}
        kept = [e for e in baseline.entries if e.file not in analyzed]
        new = Baseline(Baseline.from_findings(
            raw.findings, previous=baseline).entries + kept)
        new.save(baseline_path)
        print(f"baseline updated: {len(new.entries)} entries "
              f"({len(kept)} outside this run kept) -> {baseline_path}")
        return 0
    result = run_analysis(modules, rules, baseline, root=root)
    if args.as_json:
        print(json.dumps(result.to_dict(), sort_keys=True))
    else:
        for f in result.findings:
            print(f.render())
        for e in result.stale_baseline:
            print(f"warning: stale baseline entry {e.file} [{e.rule}] "
                  f"(budget {e.count}): ratchet it down with "
                  f"--update-baseline", file=sys.stderr)
        print(f"{len(result.findings)} finding(s) in {result.files} files "
              f"({result.suppressed} suppressed, {result.baselined} "
              f"baselined; rules {result.rules})")
    return result.exit_code


if __name__ == "__main__":
    sys.exit(main())

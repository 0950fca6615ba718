"""``python -m qldpc_fault_tolerance_tpu_torch.analysis [--root DIR]
[--json]``: lint the port package (and its ``csrc/`` and the checkout's
``chip_smoke.py``), nothing else.  Exit code 0 when clean, 1 on a
finding."""
from __future__ import annotations

import argparse
import json
import sys

from . import lint, repo_root


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m qldpc_fault_tolerance_tpu_torch.analysis")
    p.add_argument("--root", default=None,
                   help="the checkout to lint (default: this one)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="the result as one JSON object")
    args = p.parse_args(argv)
    result = lint(args.root or repo_root())
    if args.as_json:
        print(json.dumps(result.to_dict(), sort_keys=True))
    else:
        for f in result.findings:
            print(f.render())
        print(f"{len(result.findings)} finding(s) in {result.files} files "
              f"({result.suppressed} suppressed; rules {result.rules})")
    return result.exit_code


if __name__ == "__main__":
    sys.exit(main())

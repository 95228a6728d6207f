"""CLI: ``python -m repro_torch.contractcheck [--strict] [paths…]``.

Exit codes: 0 clean, 1 violations, 2 internal error.  Default mode
fails on error-severity findings only; ``--strict`` fails on warnings
too.  Suppressed findings never fail a run (they are visible with
``--show-suppressed``).  The SASS layer builds the CUDA sources and
needs the CUDA toolkit (``nvcc``, ``cuobjdump``); ``--no-sass`` leaves
it out, and without it a missing tool is an internal error.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.contractcheck",
        description="DESIGN.md §9–§14 bit-exactness contract checker "
                    "for the PyTorch/CUDA port")
    ap.add_argument("paths", nargs="*",
                    help="restrict the checker to these files "
                         "(default: every scoped file)")
    ap.add_argument("--strict", action="store_true",
                    help="fail on warnings as well as errors")
    ap.add_argument("--no-sass", action="store_true",
                    help="leave out the SASS layer (no nvcc/cuobjdump)")
    ap.add_argument("--root", default=None,
                    help="repo root (default: auto-detect)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="also print suppressed findings")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule registry and exit")
    args = ap.parse_args(argv)

    from repro_torch.contractcheck import load_config, run_check
    from repro_torch.contractcheck.rules import RULES, SEV_ERROR

    if args.list_rules:
        for rule in RULES.values():
            print(f"{rule.rule_id:12s} [{rule.layer}/{rule.severity}] "
                  f"{rule.origin}: {rule.summary}")
        return 0

    try:
        cfg = load_config(args.root)
        findings = run_check(paths=args.paths or None,
                             sass=not args.no_sass, config=cfg)
    except Exception as exc:          # the CLI's boundary: exit code 2
        print(f"contractcheck: internal error: {exc!r}", file=sys.stderr)
        return 2

    live = [f for f in findings if not f.suppressed]
    shown = findings if args.show_suppressed else live
    failing = [f for f in live
               if args.strict or f.severity == SEV_ERROR]

    if args.format == "json":
        print(json.dumps([vars(f) for f in shown], indent=2))
    else:
        for f in sorted(shown, key=lambda f: (f.path, f.line, f.rule_id)):
            print(f.format())
        n_sup = sum(f.suppressed for f in findings)
        print(f"contractcheck: {len(live)} finding(s) "
              f"({len(failing)} failing, {n_sup} suppressed) across "
              f"{len(set(f.path for f in findings)) if findings else 0} "
              f"file(s)")
    return 1 if failing else 0


if __name__ == "__main__":
    sys.exit(main())

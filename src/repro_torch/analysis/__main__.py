"""CLI: ``python -m repro_torch.analysis --check <path>...``.

Exit codes: 0 -- no unsuppressed violations; 1 -- violations found;
2 -- usage error (no paths / unknown rule).
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from .registry import all_rules
from .runner import analyze_paths, split_selection


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="AST-based invariant linter for the repro_torch "
                    "port (see repro_torch/analysis/__init__.py).")
    parser.add_argument(
        "--check", nargs="+", metavar="PATH", default=None,
        help="files or directories to analyze (e.g. src)")
    parser.add_argument(
        "--select", metavar="RULES", default=None,
        help="comma-separated rule names to run (default: all)")
    parser.add_argument(
        "--show-suppressed", action="store_true",
        help="also print pragma-suppressed findings with their reasons")
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print the registered rules and exit")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in all_rules():
            print(f"{rule.name}: {rule.description}")
        return 0
    if not args.check:
        parser.print_usage(sys.stderr)
        print("error: --check PATH... is required "
              "(or --list-rules)", file=sys.stderr)
        return 2

    select = split_selection(args.select) if args.select else None
    try:
        report = analyze_paths(args.check, select=select)
    except KeyError as exc:
        print(f"error: {exc.args[0]}", file=sys.stderr)
        return 2
    print(report.format(show_suppressed=args.show_suppressed))
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())

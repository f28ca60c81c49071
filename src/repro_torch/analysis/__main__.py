"""CLI: ``python -m repro_torch.analysis [paths...]``.

Exit codes are stable for pre-commit use:

* 0 — clean (no unallowlisted violations)
* 1 — violations found
* 2 — internal error (parse failure, bad path, linter crash)

``--json PATH`` writes the JSON findings artifact;
``--fail-on-violation`` is accepted for self-documenting scripts
(violations already exit 1 either way).
"""

from __future__ import annotations

import argparse
import sys
import traceback


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static lock-order/bit-identity invariant "
                    "checker for src/repro_torch.")
    parser.add_argument(
        "paths", nargs="*",
        help="files or directories to lint (default: the whole "
             "repro_torch package)")
    parser.add_argument(
        "--json", metavar="PATH", default=None,
        help="write the JSON findings artifact")
    parser.add_argument(
        "--fail-on-violation", action="store_true",
        help="exit 1 when violations are found (the default; kept "
             "explicit for readability)")
    args = parser.parse_args(argv)

    try:
        from repro_torch.analysis import locklint, report
        findings, files = locklint.lint_paths(args.paths)
        if args.json:
            report.write_json(
                report.build_report(findings, files), args.json)
        print(report.render_console(findings, files))
    except Exception:
        traceback.print_exc()
        return 2
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""Run the port's static-analysis suite (repro_torch.analysis.lint).

CI gate: exits non-zero when any diagnostic survives suppression.

    python scripts/lint_repro_torch.py                  # the port's files
    python scripts/lint_repro_torch.py src/repro_torch/core   # a subtree
    python scripts/lint_repro_torch.py --select RA001,RA002
    python scripts/lint_repro_torch.py --list-rules

By default it lints ``src/repro_torch``, ``chip_smoke.py``, the
``examples/*_torch.py`` and ``scripts/*_torch.py`` twins and itself.
Output is ``path:line:col: RULE message`` (clickable in most editors).
When ``$GITHUB_STEP_SUMMARY`` is set, a markdown table naming each
rule + file:line is appended there so CI failures are readable from
the job summary without opening the log.
"""
import argparse
import os
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.analysis.lint import (RULE_DOCS, registered_passes,  # noqa: E402
                                       run_paths)


def default_paths() -> list[Path]:
    """The port's own files: the package, chip_smoke.py, the *_torch.py
    twins of the examples and scripts (this script among them)."""
    return ([ROOT / "src" / "repro_torch", ROOT / "chip_smoke.py"]
            + sorted((ROOT / "examples").glob("*_torch.py"))
            + sorted((ROOT / "scripts").glob("*_torch.py")))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/dirs to lint (default: the port's files)")
    ap.add_argument("--select", default=None, metavar="RULES",
                    help="comma-separated rule ids to run (default: all)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalogue and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        registered_passes()          # populate RULE_DOCS
        for rule in sorted(RULE_DOCS):
            print(f"{rule}  {RULE_DOCS[rule]}")
        return 0

    select = [r.strip().upper() for r in args.select.split(",")] \
        if args.select else None
    paths = args.paths or default_paths()
    diags, project = run_paths(paths, select=select)

    for d in diags:
        try:
            shown = Path(d.path).resolve().relative_to(ROOT)
        except ValueError:
            shown = d.path
        print(f"{shown}:{d.line}:{d.col}: {d.rule} {d.message}")

    n_files = len(project.files)
    if diags:
        counts = ", ".join(f"{r} x{n}" for r, n in
                           sorted(Counter(d.rule for d in diags).items()))
        print(f"\n{len(diags)} finding(s) in {n_files} file(s): {counts}",
              file=sys.stderr)
        _github_summary(diags)
        return 1
    print(f"lint_repro_torch: {n_files} files clean", file=sys.stderr)
    return 0


def _github_summary(diags) -> None:
    summary = os.environ.get("GITHUB_STEP_SUMMARY")
    if not summary:
        return
    with open(summary, "a") as fh:
        fh.write("## lint_repro_torch findings\n\n"
                 "| rule | location | message |\n|---|---|---|\n")
        for d in diags:
            msg = d.message.replace("|", "\\|")
            fh.write(f"| {d.rule} | `{d.path}:{d.line}` | {msg} |\n")


if __name__ == "__main__":
    raise SystemExit(main())

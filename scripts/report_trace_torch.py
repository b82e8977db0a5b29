"""Render a structured execution trace (JSONL, written by ``EventLog``)
as a human-readable report: event counters, predictive-interval
calibration (coverage / PIT / sharpness), per-phase tick-latency
breakdown with the first call split out, and the fault/retry narrative.
The PyTorch port's twin of ``scripts/report_trace.py``, on
``repro_torch.obs``; both read the same JSONL format.

Usage::

    python scripts/report_trace_torch.py traces/chipseq.jsonl
    python scripts/report_trace_torch.py traces/*.jsonl --json report.json

With ``--json`` the machine-readable ``report_dict`` of every trace is
additionally written to the given path (keyed by trace filename) — the
artifact CI uploads next to the JSONL traces.
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.obs import (load_jsonl, render_report,  # noqa: E402
                             report_dict)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("traces", nargs="+", type=Path,
                    help="EventLog JSONL trace file(s)")
    ap.add_argument("--json", type=Path, default=None,
                    help="also write machine-readable report_dict(s) here")
    ap.add_argument("--min-obs", type=int, default=20,
                    help="calibration warm-up: observations excluded "
                         "before coverage/PIT are scored (default 20)")
    args = ap.parse_args(argv)

    reports = {}
    for path in args.traces:
        events = load_jsonl(path)
        if len(args.traces) > 1:
            print(f"\n### {path} " + "#" * max(0, 58 - len(str(path))))
        print(render_report(events, min_obs=args.min_obs))
        reports[path.name] = report_dict(events, min_obs=args.min_obs)

    if args.json is not None:
        args.json.write_text(json.dumps(reports, indent=2, default=float))
        print(f"\nwrote {args.json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
